"""K-means assignment: wrappers, plain versions and launch counters of
the two CUDA C++ kernels.

``assign_segmented`` replaces the TPU kernel
``repro/kernels/kmeans_assign/kernel.py::kmeans_assign_segmented``
(wrapper ``ops.assign_segmented``; called from
``repro/core/kmeans.py::_lloyd_segmented`` and the final assignment of
``kmeans_fit_segmented``).  Source:
``src/repro_torch/csrc/kmeans_assign_segmented.cu``.  On the card it is
bound by bytes: about 24 B a row at D = 4 (the row, its segment id, the
output), so at the main path's ~1e5 rows the launch dominates.  One
thread per row reads its block's segment id itself and scans only that
segment's K x D centres; D is not padded (the TPU wrapper padded it to
128 lanes).  Its sums are fused multiply-add chains in ascending d, the
arithmetic XLA's CPU backend emits for the JAX package's segmented
distances.

``assign`` replaces the dense TPU kernel
``repro/kernels/kmeans_assign/kernel.py::kmeans_assign`` (wrapper
``ops.assign``; called from ``repro/core/kmeans.py::kmeans_fit_masked``,
which the bucketed LERN engine vmaps over layers).  Source:
``src/repro_torch/csrc/kmeans_assign.cu``.  It takes a batch axis (the
JAX fit vmaps the Pallas call) and f32 or bf16 inputs, computed in f32.
Bound by bytes too: N x D inputs, N int32 outputs and a K x D table per
batch row, a few hundred KB at the path's largest bucket; the launch
dominates.  |c|^2 is a fused multiply-add chain over d and x.c follows
XLA's CPU matrix product (``common.dot_lanes``), so the argmins agree
with the JAX package's ``x @ centers.T`` assignment row for row.

Each kernel and its plain version compute the same fp32 sums in the same
order, so their argmins agree exactly, ties included (the first index
wins, as ``jnp.argmin``).
"""
from __future__ import annotations

import torch

from ..common import SEG_BLOCK, dot_fma, dot_lanes


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
    kernel.launch_segmented(x, centers, seg, out)
    assign_segmented.launches += 1
    return out


assign_segmented.launches = 0


def assign_plain(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the dense assignment: x [N, D] or
    [B, N, D], centers [K, D] or [B, K, D], f32 or bf16 -> [N] or [B, N]
    int32, argmin_k (|c_k|^2 - 2 x.c_k) computed in f32 (``dot_fma`` for
    |c|^2, ``dot_lanes`` for x.c), the first index on ties."""
    x, centers = x.float(), centers.float()
    c2 = dot_fma(centers, centers)                          # [..., K]
    xc = dot_lanes(x[..., :, None, :], centers[..., None, :, :])
    d2 = c2[..., None, :] - 2.0 * xc                        # [..., N, K]
    return torch.argmin(d2, dim=-1).to(torch.int32)


_DTYPES = (torch.float32, torch.bfloat16)


def assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [N, D] or [B, N, D], centers [K, D] or [B, K, D] (f32 or bf16,
    one type for both) -> [N] or [B, N] int32, the nearest centre of each
    row (first index on ties).

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel (``assign.launches`` counts those launches)."""
    if x.device.type == "cpu":
        return assign_plain(x, centers)
    if x.device.type != "cuda":
        raise ValueError(f"assign: unsupported device {x.device}")
    single = x.dim() == 2
    xb = x[None] if single else x
    cb = centers[None] if centers.dim() == 2 else centers
    if (xb.dim() != 3 or cb.dim() != 3 or xb.shape[0] != cb.shape[0]
            or xb.shape[2] != cb.shape[2] or min(*xb.shape, cb.shape[1]) == 0
            or centers.device != x.device):
        raise ValueError(f"assign: bad shapes x{tuple(x.shape)} "
                         f"centers{tuple(centers.shape)}")
    if x.dtype not in _DTYPES or centers.dtype != x.dtype:
        raise ValueError(f"assign: expects f32 or bf16 x and centers of "
                         f"one type, got {x.dtype} and {centers.dtype}")
    from . import kernel
    xb, cb = xb.contiguous(), cb.contiguous()
    out = torch.empty(xb.shape[:2], dtype=torch.int32, device=x.device)
    kernel.launch_dense(xb, cb, out)
    assign.launches += 1
    return out[0] if single else out


assign.launches = 0
