"""Int8-compressed gradient all-reduce (the JAX package's
``optim/compress.py`` in PyTorch).

Scheme (uniform-scale quantized sum, one f32 scale a tensor):

    scale = all_reduce_max(max |g|) / 127
    q     = round(g / scale)  : int8     (half to even, as ``jnp.round``)
    g'    = all_reduce_sum(q : int32) * scale

The error is at most 0.5 * scale * world_size per element.  Where the JAX
package reduces over a named mesh axis inside ``shard_map``, this reduces
over a ``torch.distributed`` process group (the default group when
``group`` is None); a world of one computes what the JAX function computes
on a one-wide axis.  The reduction over NCCL across several cards is
ROADMAP.md Queue 1 item 14b.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def quantize(x: torch.Tensor, scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale 0-d f32): ``scale`` defaults to
    max(max |x|, 1e-12) / 127 in f32."""
    xf = x.float()
    if scale is None:
        scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantized_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` with an 8-bit payload
    and one f32 scalar a tensor: an all-reduce (MAX) of the local max,
    then an all-reduce (SUM) of the int32 codes.  Raises if no process
    group is initialised."""
    if not dist.is_initialized():
        raise RuntimeError("quantized_psum: no torch.distributed process "
                           "group is initialised")
    xf = x.float()
    peak = torch.clamp(xf.abs().max(), min=1e-12)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    scale = peak / 127.0
    q, _ = quantize(xf, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.float() * scale).to(x.dtype)


def quantized_psum_tree(grads: Any, group=None) -> Any:
    """``quantized_psum`` of every tensor of a tree of nested dicts."""
    if isinstance(grads, dict):
        return {k: quantized_psum_tree(v, group) for k, v in grads.items()}
    return quantized_psum(grads, group)
