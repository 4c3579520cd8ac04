"""Flat-segmented K-Means + semantic cluster annotation (paper §IV-C).

The LERN fit's default engine: every segment's (layer's RC or RI feature
set's) Lloyd fit over ONE flat ``[P, D]`` point array, with k-means++
seeding drawn from the ported threefry generator (``prng``), so the draws
are those of the JAX package given the same keys.  The assignment step
runs through the ``kmeans_assign_segmented`` kernel on the card.

Every float reduction runs in a fixed order, never through atomics, so
two runs on the card give identical centres:

* sums over D add d = 0, 1, ... in turn;
* the k-means++ inverse-CDF prefix sums replay ``jax.lax.associative_scan``
  step for step (``_assoc_scan``);
* the Lloyd centre sums add each block's 8 rows in order, then each
  segment's block sums in order (``_seq_sum``), so a segment's sums do not
  depend on where its rows sit in the array -- straggler compaction keeps
  its trajectory.

The orders are those XLA's CPU backend uses for the JAX package's fit
(measured): its distance dots are fused multiply-add chains over d
(``dot_fma``), its block reduction and sorted segment scatter-add run in
index order.  So the port's fit on the CPU is bitwise the JAX package's
on the CPU wherever XLA's code follows those rules.

Annotation (paper §IV-C):
* RC clusters: rank 1-D centers ascending -> Cold(0) Light(1) Moderate(2) Hot(3)
* RI clusters: rank centers by expected-bin index E[c] = sum_k f_k*k / sum_k f_k
  ascending -> Immediate(0) Near(1) Far(2) Remote(3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from ..kernels.common import SEG_BLOCK, dot_fma, round_up
from ..kernels.kmeans_assign import ops as _kops
from . import prng


class SegmentedKMeansResult(NamedTuple):
    centers: torch.Tensor    # [S, K, D] per-segment centroids
    assign: torch.Tensor     # [P] cluster index per flat point (pad: garbage)
    n_iter: int


def segment_layout(counts, block: int = SEG_BLOCK):
    """Host helper: pack ragged segments into the flat blocked layout.

    ``counts[i]`` points for segment i -> ``(offsets, total)`` where segment
    i's rows occupy ``[offsets[i], offsets[i] + counts[i])`` and each run is
    padded to a multiple of ``block`` (pad rows carry segment id ``n_seg``).
    """
    offsets = []
    cur = 0
    for n in counts:
        offsets.append(cur)
        cur += ((int(n) + block - 1) // block) * block
    return np.asarray(offsets, np.int32), cur


def _seq_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` adding its entries in ascending order."""
    v = v.movedim(dim, 0)
    out = v[0]
    for t in range(1, v.shape[0]):
        out = out + v[t]
    return out


def _assoc_scan(fn, elems):
    """``jax.lax.associative_scan(fn, elems)`` along axis 0, the same
    odd/even recursion step for step, so float results agree bitwise."""
    n = elems[0].shape[0]
    if n < 2:
        return list(elems)
    reduced = fn([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = _assoc_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return out


def _seg_cumsum(w: torch.Tensor, seg_off: torch.Tensor) -> torch.Tensor:
    """Per-segment prefix sums over the flat array: a scan that resets at
    the segment start positions (pad runs between segments keep
    accumulating zeros, so a segment's last row holds its total)."""
    starts = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    starts[seg_off] = True

    def comb(a, b):
        (av, af), (bv, bf) = a, b
        return [torch.where(bf, bv, av + bv), af | bf]

    return _assoc_scan(comb, [w, starts])[0]


def _seg_pick(u: torch.Tensor, w: torch.Tensor, seg: torch.Tensor,
              seg_off: torch.Tensor, seg_cnt: torch.Tensor,
              n_seg: int) -> torch.Tensor:
    """Per-segment inverse-CDF draw: ``u[s]`` in [0, 1) picks the index
    whose within-segment cumulative weight first reaches ``u * total``;
    returns flat point indices [S]."""
    cum = _seg_cumsum(w, seg_off)
    nxt = torch.cat([seg_off[1:], seg_off.new_full((1,), w.shape[0])])
    total = cum[nxt - 1]
    segc = torch.clamp(seg, max=n_seg - 1).to(torch.int64)
    below = (cum < (u * total)[segc]).to(torch.int64)
    cnt = torch.zeros(n_seg, dtype=torch.int64, device=w.device).index_add_(
        0, segc, torch.where(seg < n_seg, below, 0))
    return seg_off + torch.minimum(torch.clamp(cnt, min=0), seg_cnt - 1)


def _plus_plus_init_segmented(keys, x, seg, seg_off, seg_cnt, n_seg, k):
    """k-means++ seeding for every segment at once: per-segment keys drive
    the draw sequence -- uniform first pick, then d²-weighted inverse-CDF
    picks -- exactly as the JAX package draws it."""
    fvalid = (seg < n_seg).to(x.dtype)
    segc = torch.clamp(seg, max=n_seg - 1).to(torch.int64)
    ks = prng.split(keys, k)                                 # [S, k, 2]
    u0 = prng.uniform(ks[:, 0])
    t = torch.floor(u0 * seg_cnt.to(x.dtype)).to(torch.int64)
    centers = torch.zeros((n_seg, k, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[:, 0] = x[seg_off + t]
    # masked min-d² maintained incrementally (min is exact)
    dmin = _seq_sum((x - centers[segc, 0]) ** 2, -1)
    for i in range(1, k):
        pick = _seg_pick(prng.uniform(ks[:, i]), dmin * fvalid, seg,
                         seg_off, seg_cnt, n_seg)
        centers[:, i] = x[pick]
        dmin = torch.minimum(dmin,
                             _seq_sum((x - centers[segc, i]) ** 2, -1))
    return centers


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


def _lloyd_segmented(x: torch.Tensor, seg: torch.Tensor,
                     centers0: torch.Tensor, n_seg: int, k: int, iters: int):
    """Up to ``iters`` segment-wise Lloyd sweeps from ``centers0``, exiting
    as soon as every segment repeats its centres bitwise (a fixed point of
    the deterministic per-segment map).  Returns (centers, n_iter,
    converged [S] bool).  Empty clusters reseed at the segment's farthest
    valid point."""
    p, f = x.shape
    dev = x.device
    valid = seg < n_seg
    fvalid = valid.to(x.dtype)
    segc = torch.clamp(seg, max=n_seg - 1).to(torch.int64)
    x2 = dot_fma(x, x)
    nb = p // SEG_BLOCK
    bseg = seg[::SEG_BLOCK].to(torch.int64)
    blocks, _ = _segment_blocks(seg, n_seg)
    arange_p = torch.arange(p, dtype=torch.int64, device=dev)
    centers = centers0
    conv = torch.zeros(n_seg, dtype=torch.bool, device=dev)
    n_iter = 0
    while n_iter < iters:
        a = _kops.assign_segmented(x, centers, seg).to(torch.int64)
        # nearest-centroid score without the [P, K, D] gather the kernel
        # exists to avoid: min_k sc == sc[a] by definition
        cga = centers[segc, a]                              # [P, D]
        min_sc = dot_fma(cga, cga) - 2.0 * dot_fma(x, cga)
        oh = torch.nn.functional.one_hot(a, k).to(x.dtype) * fvalid[:, None]
        # two-stage segment reduction: per-block partial sums (one segment
        # per block), then each segment's blocks in order
        pw = _seq_sum((oh[:, :, None] * x[:, None, :]).reshape(
            nb, SEG_BLOCK, k * f), 1)
        pc = oh.reshape(nb, SEG_BLOCK, k).sum(1)
        sums = _seq_sum(torch.cat([pw, pw.new_zeros((1, k * f))])[blocks],
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
        conv = (new == centers).reshape(n_seg, -1).all(1)
        centers = new
        n_iter += 1
        if bool(conv.all()):
            break
    return centers, n_iter, conv


def kmeans_fit_segmented(x: torch.Tensor, seg: torch.Tensor,
                         seg_off: np.ndarray, seg_cnt: np.ndarray,
                         keys: torch.Tensor, n_seg: int, k: int = 4,
                         iters: int = 50, first_chunk: int = 6,
                         device="cuda") -> SegmentedKMeansResult:
    """Every segment's Lloyd fit over ONE flat ``[P, D]`` point array.

    ``seg`` holds each row's segment id (``n_seg`` marks pad rows); each
    segment's rows are contiguous starting at ``seg_off[s]`` with
    ``seg_cnt[s]`` real points, runs padded to ``SEG_BLOCK`` multiples
    (``segment_layout``).  A first ``first_chunk``-sweep pass settles most
    segments at their bitwise Lloyd fixed point; then the unconverged
    segments' rows are compacted (block-aligned, so their trajectory is
    untouched) and only those sweep on.  ``x``, ``seg`` and ``keys``
    (``[S, 2]``, ``prng`` keys) move to ``device``; the result lives
    there.  Seeding and update math mirror the JAX package's
    ``kmeans.kmeans_fit_segmented``, so the fit is assignment-equal to it
    (centres agree to FP reassociation).
    """
    dev = _device.resolve(device)
    x = torch.as_tensor(x, device=dev)
    seg = torch.as_tensor(seg, device=dev)
    keys = torch.as_tensor(keys, device=dev)
    off_t = torch.as_tensor(np.asarray(seg_off), dtype=torch.int64,
                            device=dev)
    cnt_t = torch.as_tensor(np.asarray(seg_cnt), dtype=torch.int64,
                            device=dev)
    centers0 = _plus_plus_init_segmented(keys, x, seg, off_t, cnt_t, n_seg, k)
    it1 = min(first_chunk, iters)
    centers, total, conv = _lloyd_segmented(x, seg, centers0, n_seg, k, it1)
    conv_np = conv.cpu().numpy()
    if it1 < iters and not conv_np.all():
        stragglers = np.flatnonzero(~conv_np)
        xh = x.cpu().numpy()
        counts = np.asarray(seg_cnt)[stragglers]
        sub_off, sub_total = segment_layout(counts)
        n_sub = stragglers.shape[0]
        sub_p = max(round_up(sub_total, 2048), SEG_BLOCK)
        xs = np.zeros((sub_p, xh.shape[1]), xh.dtype)
        segs = np.full(sub_p, n_sub, np.int32)
        for si, s in enumerate(stragglers):
            run = round_up(int(counts[si]), SEG_BLOCK)
            o = int(np.asarray(seg_off)[s])
            xs[sub_off[si]:sub_off[si] + run] = xh[o:o + run]
            segs[sub_off[si]:sub_off[si] + int(counts[si])] = si
        strag_t = torch.as_tensor(stragglers, device=dev)
        sub_centers, n2, _ = _lloyd_segmented(
            torch.as_tensor(xs, device=dev), torch.as_tensor(segs, device=dev),
            centers[strag_t], n_sub, k, iters - it1)
        total += n2
        centers = centers.clone()
        centers[strag_t] = sub_centers
    a = _kops.assign_segmented(x, centers, seg)
    return SegmentedKMeansResult(centers, a, total)


def annotate_rc(centers) -> np.ndarray:
    """Map RC cluster index -> semantic label 0..3 (Cold..Hot) by ascending
    center value. Returns int array label_of_cluster[K]."""
    c = np.asarray(centers).reshape(-1)
    order = np.argsort(c)
    label = np.empty_like(order)
    label[order] = np.arange(c.shape[0])
    return label


def annotate_ri(centers_denorm: np.ndarray) -> np.ndarray:
    """Map RI cluster index -> semantic label 0..3 (Immediate..Remote) by the
    expected-bin index of the de-normalized histogram center."""
    c = np.maximum(np.asarray(centers_denorm), 0.0)
    w = c / np.maximum(c.sum(axis=1, keepdims=True), 1e-9)
    score = w @ np.arange(c.shape[1])
    order = np.argsort(score)
    label = np.empty(c.shape[0], dtype=np.int64)
    label[order] = np.arange(c.shape[0])
    return label
