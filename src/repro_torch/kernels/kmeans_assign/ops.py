"""Segment-blocked k-means assignment: wrapper, plain version and launch
counter.

Replaces the TPU kernel ``repro/kernels/kmeans_assign/kernel.py::
kmeans_assign_segmented`` (wrapper ``ops.assign_segmented``; called from
``repro/core/kmeans.py::_lloyd_segmented`` and the final assignment of
``kmeans_fit_segmented``).  The CUDA C++ kernel is
``src/repro_torch/csrc/kmeans_assign_segmented.cu``.

On the card it is bound by bytes: about 24 B a row at D = 4 (the row, its
segment id, the output), so at the main path's ~1e5 rows the launch
dominates.  One thread per row reads its block's segment id itself and
scans only that segment's K x D centres; D is not padded (the TPU wrapper
padded it to 128 lanes).  The kernel and the plain version compute the
same fp32 sums in the same order -- fused multiply-add chains in
ascending d, the arithmetic XLA's CPU backend emits for the JAX package's
assignment -- so their argmins agree row for row and with the reference.
"""
from __future__ import annotations

import torch

from ..common import SEG_BLOCK, dot_fma


def _block_segments(seg: torch.Tensor, p: int, s: int) -> torch.Tensor:
    """Each row's block segment id (``seg[row & ~7]`` clamped to S-1)."""
    bseg = torch.clamp(seg[::SEG_BLOCK], max=s - 1).to(torch.int64)
    return bseg.repeat_interleave(SEG_BLOCK)[:p]


def assign_segmented_plain(x: torch.Tensor, centers: torch.Tensor,
                           seg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x [P, D] f32, centers [S, K, D] f32,
    seg [P] int32 -> [P] int32, argmin_k (|c_k|^2 - 2 x.c_k) over the row
    block's own segment, each sum a fused multiply-add chain in ascending
    d (``common.dot_fma``)."""
    p = x.shape[0]
    cg = centers[_block_segments(seg, p, centers.shape[0])]   # [P, K, D]
    d2 = dot_fma(cg, cg) - 2.0 * dot_fma(x[:, None, :], cg)
    return torch.argmin(d2, dim=1).to(torch.int32)


def assign_segmented(x: torch.Tensor, centers: torch.Tensor,
                     seg: torch.Tensor) -> torch.Tensor:
    """x [P, D] in the flat-segmented layout (P % SEG_BLOCK == 0, each
    segment's rows padded to SEG_BLOCK multiples), centers [S, K, D], seg
    [P] int32 (pad rows carry S) -> [P] int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel (``assign_segmented.launches`` counts those launches)."""
    if x.device.type == "cpu":
        return assign_segmented_plain(x, centers, seg)
    if x.device.type != "cuda":
        raise ValueError(f"assign_segmented: unsupported device {x.device}")
    p, d = x.shape
    s, k, dc = centers.shape
    if (x.dtype != torch.float32 or centers.dtype != torch.float32
            or seg.dtype != torch.int32):
        raise ValueError("assign_segmented: expects f32 x/centers, int32 seg")
    if (dc != d or seg.shape != (p,) or p % SEG_BLOCK or p == 0 or s == 0
            or k == 0 or centers.device != x.device
            or seg.device != x.device):
        raise ValueError(f"assign_segmented: bad shapes x{tuple(x.shape)} "
                         f"centers{tuple(centers.shape)} "
                         f"seg{tuple(seg.shape)}")
    from . import kernel
    x, centers, seg = x.contiguous(), centers.contiguous(), seg.contiguous()
    out = torch.empty(p, dtype=torch.int32, device=x.device)
    kernel.launch(x, centers, seg, out)
    assign_segmented.launches += 1
    return out


assign_segmented.launches = 0
