"""Basic layers: norms, RoPE, embeddings, MLPs (the JAX package's
``models/layers.py`` in PyTorch).

Parameters live in small ``nn.Module``s whose attribute names are the JAX
package's dictionary keys (``RMSNorm.scale``, ``SwiGLU.w_gate``, ...), and
weights keep its orientation: ``x @ W`` with ``W [d_in, d_out]``, so a
parameter tree carries across without transposes.  The functions take the
module as the JAX functions take the dictionary.  Parameters require
grad, so the trainer differentiates them with autograd; the serving steps
run under ``torch.inference_mode()`` and record no graph.
"""
from __future__ import annotations

import contextvars
import math
import sys

import torch
import torch.nn.functional as F
from torch import nn


def is_dtensor(x) -> bool:
    """``x`` is a DTensor.  Asked without importing
    ``torch.distributed.tensor`` (a second or more a process, paid by every
    sweep worker that imports the models): no DTensor exists before that
    module is imported, and the sharding code that makes them imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.bfloat16,
          device=None) -> nn.Parameter:
    """Normal f32 draws from ``gen`` times ``scale`` (1/sqrt(fan_in) by
    default, ``shape[0]`` being the fan-in), cast to ``dtype``.  Without a
    generator the parameter is left uninitialised, to be filled from a
    carried-over tree (``convert.lm_params_from_numpy``)."""
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return _param((x * scale).to(dtype))


def _zeros(shape, device, dtype=torch.float32) -> nn.Parameter:
    return _param(torch.zeros(shape, dtype=dtype, device=device))


def _ones(shape, device, dtype=torch.float32) -> nn.Parameter:
    return _param(torch.ones(shape, dtype=dtype, device=device))


# --- norms -------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _ones((d,), device)


def rmsnorm_init(d: int, device=None) -> RMSNorm:
    return RMSNorm(d, device)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32, cast back to ``x``'s type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p.scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _ones((d,), device)
        self.bias = _zeros((d,), device)


def layernorm_init(d: int, device=None) -> LayerNorm:
    return LayerNorm(d, device)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.scale
            + p.bias).to(x.dtype)


# --- rotary embeddings -------------------------------------------------------
def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [d/2]
    ang = positions[..., :, None].float() * freqs               # [..., s, d/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --- embedding / unembedding -------------------------------------------------
class Embedding(nn.Module):
    def __init__(self, table: nn.Parameter):
        super().__init__()
        self.table = table


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   device=None) -> Embedding:
    return Embedding(_init(gen, (vocab, d), scale=0.02, device=device))


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows of ``tokens``.  A DTensor table takes
    ``F.embedding`` (the same rows): DTensor before torch 2.13 cannot lay
    out the backward of ``table[tokens]`` (an accumulating ``index_put``)
    for batch-sharded tokens.  The lookup of a vocab-sharded table is a
    partial sum over "model" (each rank's own rows); it is reduced here."""
    if is_dtensor(p.table):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = p.table.device_mesh
        if not is_dtensor(tokens):              # replicated, as implicit
            tokens = DTensor.from_local(tokens, mesh,
                                        [Replicate()] * mesh.ndim,
                                        run_check=False)
        x = F.embedding(tokens, p.table)
        x = x.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in x.placements])
        return _ReducedGrad.apply(x)
    return p.table[tokens]


class _ReducedGrad(torch.autograd.Function):
    """The identity on a DTensor whose gradient's partial sums are reduced
    (DTensor cannot turn a partial-sum gradient into the embedding's
    masked partial one)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        return g.redistribute(g.device_mesh, [
            Replicate() if q.is_partial() else q for q in g.placements])


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied logits head: x [..., d] -> [..., vocab] (f32)."""
    return x.float() @ p.table.float().T


# --- products ----------------------------------------------------------------
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.matmul`` computes
    an f32 activation times a bf16 weight (torch's ``@`` refuses mixed
    types)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


# --- MLPs --------------------------------------------------------------------
class SwiGLU(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, d_ff: int, device=None):
        super().__init__()
        self.w_gate = _init(gen, (d, d_ff), device=device)
        self.w_up = _init(gen, (d, d_ff), device=device)
        self.w_down = _init(gen, (d_ff, d), device=device)


def swiglu_init(gen: torch.Generator, d: int, d_ff: int,
                device=None) -> SwiGLU:
    return SwiGLU(gen, d, d_ff, device)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(mm(x, p.w_gate))
    return mm(g * mm(x, p.w_up), p.w_down)


class GeluMLP(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, d_ff: int, device=None):
        super().__init__()
        self.w_up = _init(gen, (d, d_ff), device=device)
        self.b_up = _zeros((d_ff,), device)
        self.w_down = _init(gen, (d_ff, d), device=device)
        self.b_down = _zeros((d,), device)


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                  device=None) -> GeluMLP:
    return GeluMLP(gen, d, d_ff, device)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu((x @ p.w_up + p.b_up).to(x.dtype), approximate="tanh")
    return (h @ p.w_down + p.b_down).to(x.dtype)


# --- local computation on DTensors -------------------------------------------
_SPLIT = contextvars.ContextVar("local_split", default=1)


def local_split() -> int:
    """How many ranks split the local computation running now (1 outside
    one): the dry-run scales what it counts there to the global work."""
    return _SPLIT.get()


def run_split(fn, split: int):
    """``fn`` wrapped to run with ``local_split()`` = ``split``."""
    def run(*a):
        token = _SPLIT.set(split)
        try:
            return fn(*a)
        finally:
            _SPLIT.reset(token)
    return run


class _ContiguousGrad(torch.autograd.Function):
    """The identity whose gradient is made contiguous.  A local gradient
    handed back to DTensor is taken as laid out contiguously at its global
    shape; the local backward of a product can give a transposed one,
    which a later view of the DTensor gradient then refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grads(*tensors):
    """Each tensor through ``_ContiguousGrad`` where autograd records it."""
    return tuple(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor)
                 and t.requires_grad and torch.is_grad_enabled() else t
                 for t in tensors)


def local_rows(fn, args, outs, *, model_size: int, rows: bool = True):
    """``fn(*args)`` on each rank's local shards when an arg is a DTensor
    (``local_map``), else as it is.

    ``args``: (tensor or other, batch dim or None, model dim or None) a
    piece; ``outs``: (batch dim or None, model dim, "sum" or None) an
    output.  The batch is sharded as the first arg's batch dim is (on any
    mesh dim but "model"; ``rows=False`` gathers it); the model dims are
    sharded on "model" when ``model_ok`` (the caller checked they divide),
    and an output marked "sum" is then a partial sum over "model".  A
    gradient is laid out as its input, but a partial sum over the mesh dims
    its input does not split while the work does (weights over the batch,
    tensors without a model dim over "model").  ``fn`` must compute each
    batch row (and each model slice) from its own rows and slices."""
    dts = [a for a, _, _ in args if is_dtensor(a)]
    if not dts:
        return fn(*(a for a, _, _ in args))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model")
    model_ok = model_size % mesh.shape[mi] == 0
    first, b0, _ = args[0]
    batch = [i for i, p in enumerate(first.placements) if rows and i != mi
             and isinstance(p, Shard) and p.dim == b0]

    def place(bd, md, grad):
        out = []
        for i in range(len(names)):
            if i in batch:
                out.append(Shard(bd) if bd is not None else
                           Partial() if grad else Replicate())
            elif i == mi and model_ok:
                out.append(Shard(md) if isinstance(md, int) else
                           Partial() if grad or md == "sum" else Replicate())
            else:
                out.append(Replicate())
        return out

    # plain tensors take part as replicated DTensors, cut to the layout
    args = [(DTensor.from_local(a, mesh, [Replicate()] * len(names),
                                run_check=False)
             if isinstance(a, torch.Tensor) and not is_dtensor(a)
             else a, bd, md) for a, bd, md in args]
    in_pl = tuple(place(bd, md, False) if isinstance(a, torch.Tensor)
                  else None for a, bd, md in args)
    grad_pl = tuple(place(bd, md, True) if isinstance(a, torch.Tensor)
                    else None for a, bd, md in args)
    out_pl = tuple(place(bd, md, False) for bd, md in outs)
    split = 1
    for i in batch + ([mi] if model_ok else []):
        split *= mesh.shape[i]
    mapped = local_map(run_split(lambda *a: fn(*contiguous_grads(*a)),
                                 split),
                       out_placements=out_pl if len(outs) > 1
                       else out_pl[0], in_placements=in_pl,
                       in_grad_placements=grad_pl, device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(*(a for a, _, _ in args))
