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

``fit_masked`` and ``fit_segmented`` run a whole Lloyd fit (every sweep's
assignment, sums, counts, update and empty-cluster reseed) in one launch:
the kernels ``kmeans_fit`` (in ``csrc/kmeans_assign.cu``, one block per
batch row) and ``kmeans_fit_segmented`` (in
``csrc/kmeans_assign_segmented.cu``, one block per segment, each sweeping
to its own fixed point).  They fuse the assignment step that the JAX
package runs through its Pallas kernels inside ``lax.scan`` /
``while_loop`` (``repro/core/kmeans.py``); the final assignment of a fit
stays on ``assign`` / ``assign_segmented``.  Their plain versions,
``fit_masked_plain`` and ``fit_segmented_plain``, are the port's torch
Lloyd loops; each kernel adds every sum in its plain version's order and
rounds every multiply-add as ``common.fma32`` does, so centres agree bit
for bit.  Bound by the chain of dependent adds that the sum order fixes
(a 256-row block then the block sums at D > 1; every row in order at
D = 1), not by bytes or operations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import SEG_BLOCK, dot_fma, dot_lanes, seq_sum


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


# ---------------------------------------------------------------------------
# whole Lloyd fits: the masked (bucketed engine) and the segmented fit
# ---------------------------------------------------------------------------
# XLA's CPU matrix product adds the Lloyd sums one_hot.T @ x for D > 1 in
# blocks of this many rows along N, each block from zero in row order, the
# block sums in turn (measured for N <= 2048).  For D = 1 (a matrix-vector
# product) it adds in row order when batched; unbatched (or a batch of
# one) it runs vectorized code: ``_vector_sum``.
LLOYD_SUM_BLOCK = 256
# the kernels' limits (registers and shared memory are sized by them)
FIT_MAX_D = 16
FIT_MAX_K = 16


def _halve(v: np.ndarray) -> np.ndarray:
    """Sum over axis 0 (a power of two long) by halving: lane i plus lane
    i + len/2, and again -- LLVM's reduction of a vector register."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = (v[:h] + v[h:]).astype(np.float32)
    return v[0]


def _vector_sum(v: np.ndarray) -> np.ndarray:
    """Sum over axis 0 of v [N, ...] in the order of XLA's CPU code for
    the unbatched f32 matrix-vector product in the LERN fit's
    ``_fit_layer`` (read off the compiled code and checked on its fits
    for N = 8..32768): for 512 <= N < 4096 the loop vectorizer's 4 x 8
    lanes (row n into part n // 8 % 4, lane n % 8; the parts folded as
    ((p1 + p0) + p2) + p3), otherwise from N = 64 the row-major GEMV's 8
    lanes (row n into lane n % 8); each lane adds its rows in order from
    zero, the lanes reduce by halving, and rows past the last full step
    (and all rows for N < 64) add in order."""
    n = v.shape[0]
    parts, lanes = (4, 8) if 512 <= n < 4096 else (1, 8)
    step = parts * lanes
    m = (n // step) * step if n >= 64 else 0
    if m == 0:
        return np.cumsum(v, axis=0, dtype=np.float32)[-1]
    acc = np.cumsum(v[:m].reshape((m // step, parts, lanes) + v.shape[1:]),
                    axis=0, dtype=np.float32)[-1]
    w = acc[0]
    for p in range(1, parts):
        w = (acc[p] + w).astype(np.float32)
    out = _halve(w)
    for t in range(m, n):
        out = (out + v[t]).astype(np.float32)
    return out


def _lloyd_sums(oh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``one_hot.T @ x`` per batch row -- oh [B, N, K] of 0/1, x [B, N, D]
    -> [B, K, D] -- in XLA's order: for D > 1 blocks of
    ``LLOYD_SUM_BLOCK`` rows, each added from zero in row order, the
    block sums in turn; for D = 1 all rows in order, or, for a batch of
    one, ``_vector_sum``'s order.

    The f32 sums run on the host (numpy's ``cumsum`` adds in order, in
    f32): a chain of N dependent adds is one sequential loop there."""
    b, n, k = oh.shape
    d = x.shape[-1]
    v = (oh[..., :, :, None] * x[..., :, None, :]).cpu().numpy()
    if d == 1 and b == 1:
        return torch.as_tensor(_vector_sum(v[0])[None], device=x.device)
    blk = n if d == 1 else min(n, LLOYD_SUM_BLOCK)
    nb = -(-n // blk)
    if nb * blk != n:
        v = np.concatenate([v, np.zeros((b, nb * blk - n, k, d), v.dtype)],
                           1)
    part = np.cumsum(v.reshape(b, nb, blk, k, d), axis=2,
                     dtype=np.float32)[:, :, -1]            # [B, nb, K, D]
    sums = np.cumsum(part, axis=1, dtype=np.float32)[:, -1]
    return torch.as_tensor(sums, device=x.device)


def fit_masked_plain(x: torch.Tensor, mask: torch.Tensor,
                     centers: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain PyTorch version of ``fit_masked``: ``iters`` Lloyd sweeps
    (no early exit, as the JAX package's fixed-length scan) over the
    masked points of every batch row, from ``centers``.  Each sweep takes
    the argmin of sc = |c|^2 - 2 x.c (``dot_fma``, ``dot_lanes``; the
    first index on ties), adds the Lloyd sums in ``_lloyd_sums``'s order,
    divides by the exact counts, and re-seeds an empty cluster at the
    row's farthest valid point (the largest |x|^2 + min sc, the first
    index on ties).  Returns the centres [B, K, D]."""
    k = centers.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    fmask = mask.to(x.dtype)
    x2 = dot_fma(x, x)                                      # [B, N]
    for _ in range(iters):
        c2 = dot_fma(centers, centers)                      # [B, K]
        sc = c2[:, None, :] - 2.0 * dot_lanes(x[:, :, None, :],
                                              centers[:, None, :, :])
        a = torch.argmin(sc, 2)
        oh = torch.nn.functional.one_hot(a, k).to(x.dtype) * fmask[:, :,
                                                                   None]
        counts = oh.sum(1)              # integer-valued: exact in any order
        new = _lloyd_sums(oh, x) / torch.clamp(counts, min=1.0)[:, :, None]
        far_score = torch.where(mask, x2 + sc.amin(2), -torch.inf)
        far = x[rows, torch.argmax(far_score, 1)]           # [B, D]
        centers = torch.where((counts > 0)[:, :, None], new,
                              far[:, None, :])
    return centers


def fit_masked(x: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
               iters: int) -> torch.Tensor:
    """``iters`` Lloyd sweeps of the masked fit of every batch row: x
    [B, N, D] f32, mask [B, N] bool, centers [B, K, D] f32 (the k-means++
    seeds) -> the centres [B, K, D].

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel ``kmeans_fit``, one launch for the whole fit
    (``fit_masked.launches`` counts those launches)."""
    if x.device.type == "cpu":
        return fit_masked_plain(x, mask, centers, iters)
    if x.device.type != "cuda":
        raise ValueError(f"fit_masked: unsupported device {x.device}")
    if (x.dtype != torch.float32 or centers.dtype != torch.float32
            or mask.dtype != torch.bool):
        raise ValueError(f"fit_masked: expects f32 x and centers and a bool "
                         f"mask, got {x.dtype}, {centers.dtype}, "
                         f"{mask.dtype}")
    if (x.dim() != 3 or centers.dim() != 3 or mask.shape != x.shape[:2]
            or centers.shape[0] != x.shape[0]
            or centers.shape[2] != x.shape[2] or min(x.shape) == 0
            or not 0 < centers.shape[1] <= FIT_MAX_K
            or x.shape[2] > FIT_MAX_D or x.shape[1] >= 1 << 24
            or iters < 0 or centers.device != x.device
            or mask.device != x.device):
        raise ValueError(f"fit_masked: bad shapes x{tuple(x.shape)} "
                         f"mask{tuple(mask.shape)} "
                         f"centers{tuple(centers.shape)} iters {iters}")
    from . import kernel
    x, mask, centers = x.contiguous(), mask.contiguous(), centers.contiguous()
    out = torch.empty_like(centers)
    a = torch.empty(x.shape[:2], dtype=torch.uint8, device=x.device)
    kernel.launch_fit(x, mask, centers, out, a, iters)
    fit_masked.launches += 1
    return out


fit_masked.launches = 0


def _segment_blocks(seg: torch.Tensor, n_seg: int):
    """[S, max_blocks] indices of each segment's row blocks (in order),
    padded with ``nb`` -- the index of an all-zero row appended to a
    per-block table."""
    bseg = seg[::SEG_BLOCK].to(torch.int64).cpu().numpy()
    nb = bseg.shape[0]
    real = np.flatnonzero(bseg < n_seg)
    counts = np.bincount(bseg[real], minlength=n_seg)
    starts = np.full(n_seg, nb)
    np.minimum.at(starts, bseg[real], real)
    width = max(int(counts.max(initial=0)), 1)
    j = np.arange(width)[None, :]
    idx = np.where(j < counts[:, None], starts[:, None] + j, nb)
    return torch.as_tensor(idx, device=seg.device), nb


def fit_segmented_plain(x: torch.Tensor, seg: torch.Tensor, seg_off,
                        seg_cnt, centers: torch.Tensor, iters: int):
    """The plain PyTorch version of ``fit_segmented``: segment-wise Lloyd
    sweeps from ``centers`` [S, K, D], all segments together, until every
    segment repeats its centres bitwise (a fixed point of its
    deterministic map, which further sweeps reproduce) or ``iters``
    sweeps ran.  ``seg_off`` and ``seg_cnt`` describe the layout that
    ``seg`` already fixes and are not read.  Each sweep: the argmin over
    the row's segment (``assign_segmented_plain``'s sums), each 8-row
    block's sums in row order then each segment's block sums in block
    order, exact counts, and an empty cluster re-seeded at the segment's
    farthest valid point (the largest |x|^2 + min sc, then the smallest
    position).  Returns (centers [S, K, D], sweeps [S] int32: the sweeps
    each segment ran until it repeated its centres, or all of them;
    converged [S] bool)."""
    p, f = x.shape
    n_seg, k, _ = centers.shape
    dev = x.device
    valid = seg < n_seg
    fvalid = valid.to(x.dtype)
    segc = torch.clamp(seg, max=n_seg - 1).to(torch.int64)
    x2 = dot_fma(x, x)
    nb = p // SEG_BLOCK
    bseg = seg[::SEG_BLOCK].to(torch.int64)
    blocks, _ = _segment_blocks(seg, n_seg)
    arange_p = torch.arange(p, dtype=torch.int64, device=dev)
    conv = torch.zeros(n_seg, dtype=torch.bool, device=dev)
    sweeps = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    n_iter = 0
    while n_iter < iters:
        a = assign_segmented_plain(x, centers, seg).to(torch.int64)
        cga = centers[segc, a]                              # [P, D]
        min_sc = dot_fma(cga, cga) - 2.0 * dot_fma(x, cga)
        oh = torch.nn.functional.one_hot(a, k).to(x.dtype) * fvalid[:, None]
        # two-stage segment reduction: per-block partial sums (one segment
        # per block), then each segment's blocks in order
        pw = seq_sum((oh[:, :, None] * x[:, None, :]).reshape(
            nb, SEG_BLOCK, k * f), 1)
        pc = oh.reshape(nb, SEG_BLOCK, k).sum(1)
        sums = seq_sum(torch.cat([pw, pw.new_zeros((1, k * f))])[blocks],
                       1).reshape(n_seg, k, f)
        # integer-valued, so exact in any order
        counts = torch.cat([pc, pc.new_zeros((1, k))])[blocks].sum(1)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        empty = counts == 0
        if bool(empty.any()):
            far_score = torch.where(valid, x2 + min_sc, -torch.inf)
            bmax = far_score.reshape(nb, SEG_BLOCK).amax(1)
            m = torch.full((n_seg + 1,), -torch.inf, dtype=x.dtype,
                           device=dev).scatter_reduce_(
                0, bseg, bmax, "amax")[:n_seg]
            pos = torch.where(valid & (far_score == m[segc]), arange_p, p)
            bmin = pos.reshape(nb, SEG_BLOCK).amin(1)
            fi = torch.full((n_seg + 1,), np.iinfo(np.int32).max,
                            dtype=torch.int64, device=dev).scatter_reduce_(
                0, bseg, bmin, "amin")[:n_seg]
            far = x[torch.clamp(fi, 0, p - 1)]             # [S, D]
            new = torch.where(empty[:, :, None], far[:, None, :], new)
        sweeps += (~conv).to(torch.int32)
        conv = (new == centers).reshape(n_seg, -1).all(1)
        centers = new
        n_iter += 1
        if bool(conv.all()):
            break
    return centers, sweeps, conv


def fit_segmented(x: torch.Tensor, seg: torch.Tensor, seg_off, seg_cnt,
                  centers: torch.Tensor, iters: int):
    """Every segment's Lloyd fit over the flat-segmented layout (x [P, D]
    f32, seg [P] int32 with S on pad rows, segment s's rows at
    ``seg_off[s]`` .. ``+ seg_cnt[s]``, runs padded to SEG_BLOCK
    multiples: ``core.kmeans.segment_layout``) from ``centers`` [S, K, D]
    f32, each segment until it repeats its centres or ``iters`` sweeps
    ran -> (centers [S, K, D], sweeps [S] int32, converged [S] bool).

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel ``kmeans_fit_segmented``, one launch for the whole fit
    (``fit_segmented.launches`` counts those launches)."""
    if x.device.type == "cpu":
        return fit_segmented_plain(x, seg, seg_off, seg_cnt, centers, iters)
    if x.device.type != "cuda":
        raise ValueError(f"fit_segmented: unsupported device {x.device}")
    if (x.dtype != torch.float32 or centers.dtype != torch.float32
            or seg.dtype != torch.int32):
        raise ValueError("fit_segmented: expects f32 x/centers, int32 seg")
    off = np.asarray(torch.as_tensor(seg_off).cpu(), np.int64)
    cnt = np.asarray(torch.as_tensor(seg_cnt).cpu(), np.int64)
    p = x.shape[0]
    s, k = centers.shape[:2]
    runs = -(-cnt // SEG_BLOCK) * SEG_BLOCK
    if (x.dim() != 2 or centers.dim() != 3 or centers.shape[2] != x.shape[1]
            or seg.shape != (p,) or p % SEG_BLOCK or p == 0 or s == 0
            or not 0 < k <= FIT_MAX_K or not 0 < x.shape[1] <= FIT_MAX_D
            or off.shape != (s,) or cnt.shape != (s,) or (cnt < 0).any()
            or (off % SEG_BLOCK).any() or (off < 0).any()
            or (off + runs > p).any() or iters < 0 or p >= 1 << 31
            or centers.device != x.device or seg.device != x.device):
        raise ValueError(f"fit_segmented: bad shapes x{tuple(x.shape)} "
                         f"centers{tuple(centers.shape)} "
                         f"seg{tuple(seg.shape)} seg_off{off.shape} "
                         f"seg_cnt{cnt.shape} iters {iters}")
    from . import kernel
    x, seg, centers = x.contiguous(), seg.contiguous(), centers.contiguous()
    lay = torch.as_tensor(np.stack([off, cnt]).astype(np.int32)).to(
        x.device)
    out = torch.empty_like(centers)
    sweeps = torch.empty(s, dtype=torch.int32, device=x.device)
    conv = torch.empty(s, dtype=torch.bool, device=x.device)
    a = torch.empty(p, dtype=torch.uint8, device=x.device)
    width = max(int(runs.max(initial=0)) // SEG_BLOCK, 1)
    kernel.launch_fit_segmented(x, seg, lay, centers, out, sweeps, conv, a,
                                iters, width)
    fit_segmented.launches += 1
    return out, sweeps, conv


fit_segmented.launches = 0
