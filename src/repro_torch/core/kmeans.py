"""K-Means (masked and flat-segmented) + semantic cluster annotation
(paper §IV-C).

Two fits, one for each LERN fit engine, both seeded by k-means++ draws
from the ported threefry generator (``prng``), so the draws are those of
the JAX package given the same keys:

* ``kmeans_fit_masked`` / ``kmeans_fit_batched`` -- the bucketed engine's
  fit: fixed-shape and mask-aware, with a real leading batch axis (the
  JAX package vmaps the single fit).  50 fixed Lloyd sweeps, on the card
  in one launch of the ``kmeans_fit`` kernel (``kmeans_assign.ops
  .fit_masked``); the final assignment runs through the dense
  ``kmeans_assign`` kernel.
* ``kmeans_fit_segmented`` -- the default engine's fit: every segment's
  (layer's RC or RI feature set's) Lloyd fit over ONE flat ``[P, D]``
  point array, on the card in one launch of the ``kmeans_fit_segmented``
  kernel (``ops.fit_segmented``); the final assignment runs through the
  ``kmeans_assign_segmented`` kernel.

Every float reduction runs in a fixed order, never through atomics, so
two runs on the card give identical centres:

* sums over D add d = 0, 1, ... in turn;
* the k-means++ inverse-CDF prefix sums replay ``jax.lax.associative_scan``
  step for step (``_assoc_scan``);
* the Lloyd centre sums add each block's 8 rows in order, then each
  segment's block sums in order (``seq_sum``), so a segment's sums do not
  depend on where its rows sit in the array -- straggler compaction keeps
  its trajectory.

The orders are those XLA's CPU backend uses for the JAX package's fits
(measured): its distance reductions are fused multiply-add chains over d
(``dot_fma``), its block reduction and sorted segment scatter-add run in
index order.  The masked fit adds XLA's matrix-product order for
``x @ centers.T`` (``dot_lanes``) and for the Lloyd sums
``one_hot.T @ x`` (``ops._lloyd_sums``), and XLA's rewrite of ``cumsum``
(``_xla_cumsum``).  So the port's fits on the CPU are bitwise the JAX
package's on the CPU wherever XLA's code follows those rules.

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
from ..kernels.common import SEG_BLOCK, dot_fma, round_up, seq_sum
from ..kernels.kmeans_assign import ops as _kops
from . import prng


class KMeansResult(NamedTuple):
    centers: torch.Tensor    # [K, D] (in the normalized feature space)
    assign: torch.Tensor     # [N] cluster index per point
    inertia: torch.Tensor    # [] sum of squared distances (masked)
    n_iter: int


class SegmentedKMeansResult(NamedTuple):
    centers: torch.Tensor    # [S, K, D] per-segment centroids
    assign: torch.Tensor     # [P] cluster index per flat point (pad: garbage)
    n_iter: int


# ---------------------------------------------------------------------------
# masked fit (the bucketed LERN engine's k-means)
# ---------------------------------------------------------------------------
# XLA rewrites a cumsum of length N into prefix sums over rows of this
# length plus a (recursive) prefix sum of the row totals.
CUMSUM_BASE = 16


def assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center assignment via the -2 x.c + ||c||^2 expansion (the
    row-constant ||x||^2 term is dropped from the argmin), the plain
    counterpart of the JAX package's ``assign_jnp``; x [..., N, D],
    centers [..., K, D] -> [..., N] int32."""
    return _kops.assign_plain(x, centers)


def _seq_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, added in order."""
    out = w.clone()
    for t in range(1, w.shape[-1]):
        out[..., t] = out[..., t - 1] + w[..., t]
    return out


def _xla_cumsum(w: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis as XLA's CPU backend computes it
    (measured): rows of ``CUMSUM_BASE`` summed in order, plus the
    exclusive prefix of the row totals, computed the same way."""
    n = w.shape[-1]
    if n <= CUMSUM_BASE:
        return _seq_cumsum(w)
    r = -(-n // CUMSUM_BASE)
    pad = w.new_zeros(w.shape[:-1] + (r * CUMSUM_BASE - n,))
    rows = _seq_cumsum(torch.cat([w, pad], -1).reshape(
        w.shape[:-1] + (r, CUMSUM_BASE)))
    inc = _xla_cumsum(rows[..., -1])
    excl = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    return (rows + excl[..., None]).reshape(w.shape[:-1] + (-1,))[..., :n]


def _pick_masked(keys: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw from unnormalized ``weights`` [B, N] (masked
    entries 0), one per batch row: the index whose cumulative weight
    first reaches ``u * total``."""
    cum = _xla_cumsum(weights)
    u = prng.uniform(keys) * cum[:, -1]
    idx = (cum < u[:, None]).to(torch.int64).sum(1)
    return torch.clamp(idx, 0, weights.shape[1] - 1)


def _plus_plus_init_masked(keys, x, mask, k):
    """k-means++ seeding over the masked points of every batch row: the
    first center drawn uniformly from the valid points, the next ones
    with probability proportional to the masked d² weights."""
    bsz, n, d = x.shape
    rows = torch.arange(bsz, device=x.device)
    fmask = mask.to(x.dtype)
    ks = prng.split(keys, k)                                # [B, k, 2]
    n_valid = mask.to(torch.int64).sum(1)
    t = torch.floor(prng.uniform(ks[:, 0]) * n_valid.to(x.dtype)).to(
        torch.int64)
    cm = torch.cumsum(mask.to(torch.int64), 1)
    idx0 = torch.argmax((cm > t[:, None]).to(torch.uint8), 1)
    centers = torch.zeros((bsz, k, d), dtype=x.dtype, device=x.device)
    centers[:, 0] = x[rows, idx0]
    seeded = torch.arange(k, device=x.device)
    for i in range(1, k):
        diff = x[:, :, None, :] - centers[:, None, :, :]    # [B, N, k, D]
        d2 = (dot_fma(diff, diff)
              + torch.where(seeded < i, 0.0, torch.inf)).amin(2)
        centers[:, i] = x[rows, _pick_masked(ks[:, i], d2 * fmask)]
    return centers


def kmeans_fit_batched(x, mask, keys, k: int = 4, iters: int = 50,
                       use_kernel: bool = True,
                       device="cuda") -> KMeansResult:
    """The masked Lloyd fit of every batch row at once: x [B, N, D], mask
    [B, N], keys [B, 2] (``prng`` keys) -> KMeansResult with a leading B
    axis on centers, assign and inertia.  Masked-out rows of ``x`` should
    be zero; their ``assign`` entries are meaningless.

    The counterpart of the JAX package's vmapped ``kmeans_fit_batched``:
    the batch is a tensor axis of every op.  ``use_kernel`` sends the
    Lloyd sweeps through ``kmeans_assign.ops.fit_masked`` and the final
    assignment through ``ops.assign`` (the kernels on a CUDA tensor,
    their plain versions on a CPU tensor); without it both take the plain
    versions.  The inputs move to ``device``; the result lives there."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    keys = torch.as_tensor(keys, device=dev)
    centers0 = _plus_plus_init_masked(keys, x, mask, k)
    if use_kernel:
        centers = _kops.fit_masked(x, mask, centers0, iters)
        a = _kops.assign(x, centers)
    else:
        centers = _kops.fit_masked_plain(x, mask, centers0, iters)
        a = _kops.assign_plain(x, centers)
    cg = torch.gather(centers, 1, a.to(torch.int64)[:, :, None].expand(
        -1, -1, x.shape[2]))
    diff = x - cg
    inertia = (dot_fma(diff, diff) * mask.to(x.dtype)).sum(1)
    return KMeansResult(centers, a, inertia, iters)


def kmeans_fit_masked(x, mask, key, k: int = 4, iters: int = 50,
                      use_kernel: bool = True,
                      device="cuda") -> KMeansResult:
    """Lloyd iterations over the points where ``mask`` is True: x [N, D],
    mask [N], key [2] -- ``kmeans_fit_batched`` with one batch row."""
    dev = _device.resolve(device)
    res = kmeans_fit_batched(torch.as_tensor(x, device=dev)[None],
                             torch.as_tensor(mask, device=dev)[None],
                             torch.as_tensor(key, device=dev)[None], k=k,
                             iters=iters, use_kernel=use_kernel, device=dev)
    return KMeansResult(res.centers[0], res.assign[0], res.inertia[0],
                        res.n_iter)


def kmeans_fit(x, k: int = 4, iters: int = 50, seed: int = 0,
               use_kernel: bool = True, device="cuda") -> KMeansResult:
    """Unmasked convenience wrapper over ``kmeans_fit_masked``."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x, device=dev)
    return kmeans_fit_masked(
        x, torch.ones(x.shape[0], dtype=torch.bool, device=dev),
        prng.PRNGKey(seed, dev), k=k, iters=iters, use_kernel=use_kernel,
        device=dev)


def normalize(x: torch.Tensor):
    """Feature normalization for K-means (per-dim min-max): returns
    ``(normalized, lo, hi)``."""
    lo = x.amin(0)
    hi = x.amax(0)
    return (x - lo) / torch.clamp(hi - lo, min=1e-9), lo, hi


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
    dmin = seq_sum((x - centers[segc, 0]) ** 2, -1)
    for i in range(1, k):
        pick = _seg_pick(prng.uniform(ks[:, i]), dmin * fvalid, seg,
                         seg_off, seg_cnt, n_seg)
        centers[:, i] = x[pick]
        dmin = torch.minimum(dmin,
                             seq_sum((x - centers[segc, i]) ** 2, -1))
    return centers


def kmeans_fit_segmented(x: torch.Tensor, seg: torch.Tensor,
                         seg_off: np.ndarray, seg_cnt: np.ndarray,
                         keys: torch.Tensor, n_seg: int, k: int = 4,
                         iters: int = 50, first_chunk: int = 6,
                         device="cuda") -> SegmentedKMeansResult:
    """Every segment's Lloyd fit over ONE flat ``[P, D]`` point array.

    ``seg`` holds each row's segment id (``n_seg`` marks pad rows); each
    segment's rows are contiguous starting at ``seg_off[s]`` with
    ``seg_cnt[s]`` real points, runs padded to ``SEG_BLOCK`` multiples
    (``segment_layout``).  On the card one launch of the
    ``kmeans_fit_segmented`` kernel sweeps every segment to its own
    bitwise Lloyd fixed point (``ops.fit_segmented``).  On the CPU a first
    ``first_chunk``-sweep pass settles most segments; then the
    unconverged segments' rows are compacted (block-aligned, so their
    trajectory is untouched) and only those sweep on.  A segment at its
    fixed point stays there, so both schedules give the same centres and
    ``n_iter`` (the most sweeps any segment ran); ``first_chunk >=
    iters`` makes the CPU run the card's one pass.  ``x``, ``seg`` and ``keys``
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
    it1 = iters if dev.type == "cuda" else min(first_chunk, iters)
    centers, sweeps, conv = _kops.fit_segmented(x, seg, seg_off, seg_cnt,
                                                centers0, it1)
    total = int(sweeps.max())
    if it1 < iters and not bool(conv.all()):
        stragglers = np.flatnonzero(~conv.cpu().numpy())
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
        sub_centers, n2, _ = _kops.fit_segmented(
            torch.as_tensor(xs, device=dev), torch.as_tensor(segs, device=dev),
            sub_off, counts, centers[strag_t], iters - it1)
        total += int(n2.max())
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


# ---------------------------------------------------------------------------
# analysis (paper Fig. 5): host numpy, copies of the JAX package's
# ---------------------------------------------------------------------------
def silhouette_score(x: np.ndarray, assign: np.ndarray,
                     max_points: int = 2000, seed: int = 0) -> float:
    """Mean silhouette coefficient (sampled for tractability)."""
    x = np.asarray(x, dtype=np.float64)
    assign = np.asarray(assign)
    n = x.shape[0]
    if n > max_points:
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, max_points, replace=False)
    else:
        idx = np.arange(n)
    xs, as_ = x[idx], assign[idx]
    labels = np.unique(as_)
    if labels.shape[0] < 2:
        return 0.0
    d = np.sqrt(((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1))
    s = np.zeros(xs.shape[0])
    for i in range(xs.shape[0]):
        own = as_[i]
        same = (as_ == own)
        same[i] = False
        a = d[i][same].mean() if same.any() else 0.0
        b = np.inf
        for l in labels:
            if l == own:
                continue
            mask = as_ == l
            if mask.any():
                b = min(b, d[i][mask].mean())
        s[i] = 0.0 if max(a, b) == 0 else (b - a) / max(a, b)
    return float(s.mean())


def pca_2d(x: np.ndarray) -> np.ndarray:
    """2-D PCA projection (paper Fig. 5 feature-separability view)."""
    x = np.asarray(x, dtype=np.float64)
    xc = x - x.mean(0)
    cov = xc.T @ xc / max(1, x.shape[0] - 1)
    w, v = np.linalg.eigh(cov)
    return xc @ v[:, np.argsort(w)[::-1][:2]]
