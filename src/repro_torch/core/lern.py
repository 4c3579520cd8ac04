"""LERN — clustering-based learning & prediction of accelerator reuse
(paper §IV).  Pipeline:

    per-layer trace -> cache-line collapse (optionally through the L-RPT
    hash, §VI-J) -> reuse signature -> (F_RI, F_RC) features -> two
    K-means(k=4) -> semantic annotation -> per-line (RC_cluster, RI_cluster)
    lookup tables, loaded layer-by-layer into the L-RPT at runtime.

Entry points (each takes ``device=`` and defaults to the card):

* ``train_model_batched`` -- all layers of a (model x accel-config) on
  one device: the flat whole-trace feature extraction
  (``reuse.reuse_features_flat``: one composite (layer, line) sort +
  ``ri_histogram`` kernel binning), then every eligible layer's k-means
  fits through one of two engines (``FIT_ENGINE``, ``fit_engine=``):
  ``"segmented"`` (the default; ``kmeans.kmeans_fit_segmented`` over one
  flat point array, assignment through the ``kmeans_assign_segmented``
  kernel) or ``"bucketed"`` (layers padded into power-of-two capacity
  buckets, each bucket one batched ``_fit_layer``; assignment through the
  dense ``kmeans_assign`` kernel).  Only the O(k) semantic annotation
  runs on the host.
* ``train_family_batched`` -- several configs' models in one flat fit.
* ``train`` / ``train_layer`` -- the host-reference path: per-layer numpy
  features, then the same ``_fit_layer`` per layer at its own bucket
  capacity.

Lines with a single occurrence are assigned the No-Reuse cluster (-1, -1).
The model stores stacked per-layer lookup arrays (``uniq`` / ``rc_cluster``
/ ``ri_cluster`` -- [L, N] tables consumed directly by ``lrpt.pack_tables``
and ``sim.trace_clusters``); ``model.layers`` offers per-layer views.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import device as _device
from ..kernels.common import fma32
from . import kmeans as km
from . import prng
from .reuse import (NUM_RI_BINS, PAD_LINE, RI_BIN_EDGES, lines_to_device,
                    reuse_features_flat, reuse_signature_np, ri_histogram_np)
from .tracegen import Trace

# correct-bin sets per RI cluster label for the §IV-D accuracy metric:
# Immediate<->{bin0}, Near<->{bin0,bin1}, Far<->{bin1,bin2}, Remote<->{bin2,bin3}
_CORRECT_BINS = {0: (0,), 1: (0, 1), 2: (1, 2), 3: (2, 3)}

MIN_MULTI = 8  # need enough multi-occurrence lines for 4 clusters

# How the trainers run their k-means fits:
#   "bucketed"  -- layers padded into power-of-two capacity buckets, each
#                  bucket one batched ``_fit_layer`` (the oracle path: equal
#                  to the per-layer host reference ``train``).
#   "segmented" -- all layers' points in ONE flat array with a segment-id
#                  column (``kmeans.kmeans_fit_segmented``); equal cluster
#                  tables, centres to FP reassociation.
#   "auto"      -- segmented.
FIT_ENGINE = os.environ.get("REPRO_LERN_FIT", "auto")


def resolve_engine(engine: Optional[str] = None) -> str:
    """Resolve a fit-engine override (or the module default
    ``FIT_ENGINE``) to the concrete engine name."""
    e = engine or FIT_ENGINE
    if e == "auto":
        e = "segmented"
    if e not in ("bucketed", "segmented"):
        raise ValueError(f"unknown LERN fit engine {e!r} "
                         "(expected bucketed|segmented|auto)")
    return e


@contextlib.contextmanager
def fit_engine_override(engine: Optional[str]):
    """Temporarily pin the module-default fit engine (``FIT_ENGINE``) --
    how ``exp.ExecPlan.fit_engine`` reaches call sites that consult the
    default at fit time.  ``None`` is a no-op."""
    global FIT_ENGINE
    if engine is None:
        yield
        return
    resolve_engine(engine)  # validate eagerly, before any fit runs
    prev = FIT_ENGINE
    FIT_ENGINE = engine
    try:
        yield
    finally:
        FIT_ENGINE = prev


def _bucket(n: int) -> int:
    """Next power of two (>= 8): the fixed-shape padding capacity."""
    return max(8, 1 << (int(n) - 1).bit_length())


@dataclasses.dataclass
class LayerClusters:
    """Per-layer view over the trained model (analysis/tests interface)."""
    uniq: np.ndarray         # [N] unique (possibly hashed) line addresses
    rc_cluster: np.ndarray   # [N] 0..3 or -1 (No Reuse)
    ri_cluster: np.ndarray   # [N] 0..3 or -1
    rc_centers: np.ndarray   # [4] de-normalized, label-ordered (Cold..Hot)
    ri_centers: np.ndarray   # [4, 4] de-normalized, label-ordered
    features_ri: np.ndarray  # [n_multi, 4] raw histograms (Fig. 5 PCA plots)
    _sil: Optional[float] = None

    def silhouette(self) -> float:
        """RI-cluster silhouette (Fig. 5), computed lazily from the stored
        features -- keeps the O(n^2) score out of the training hot path."""
        if self._sil is None:
            labels = self.ri_cluster[self.rc_cluster >= 0]
            if labels.shape[0] != self.features_ri.shape[0] or \
                    labels.shape[0] < MIN_MULTI:
                self._sil = 0.0
            else:
                raw = self.features_ri.astype(np.float64)
                xri = raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)
                self._sil = km.silhouette_score(xri, labels)
        return self._sil


@dataclasses.dataclass
class LernModel:
    """Trained LERN predictor for one (ML model x accel config).

    The lookup tables are stacked fixed-shape host arrays (padded with
    PAD_LINE / -1) so the L-RPT loader consumes them as flat gathers."""
    uniq: np.ndarray        # [L, N] int64, per-layer sorted, PAD_LINE-padded
    rc_cluster: np.ndarray  # [L, N] int8, -1 = No Reuse / padding
    ri_cluster: np.ndarray  # [L, N] int8
    n_uniq: np.ndarray      # [L] int32
    rc_centers: np.ndarray  # [L, 4] float32, label-ordered (Cold..Hot)
    ri_centers: np.ndarray  # [L, 4, 4] float32, label-ordered
    features_ri: List[np.ndarray]  # ragged [n_multi_i, 4] (Fig. 5)
    hash_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None

    @property
    def n_layers(self) -> int:
        return self.uniq.shape[0]

    @property
    def layers(self) -> List[LayerClusters]:
        """Per-layer views (sliced to the real unique count)."""
        views = getattr(self, "_views", None)
        if views is None:
            views = [LayerClusters(
                uniq=self.uniq[li, :n], rc_cluster=self.rc_cluster[li, :n],
                ri_cluster=self.ri_cluster[li, :n],
                rc_centers=self.rc_centers[li], ri_centers=self.ri_centers[li],
                features_ri=self.features_ri[li])
                for li, n in enumerate(self.n_uniq)]
            object.__setattr__(self, "_views", views)
        return views

    @classmethod
    def from_layers(cls, layers: List[LayerClusters],
                    hash_fn: Optional[Callable] = None) -> "LernModel":
        """Stack per-layer results into the fixed-shape model tables."""
        n_tab = _bucket(max((lc.uniq.shape[0] for lc in layers), default=1))
        n_l = len(layers)
        uniq = np.full((n_l, n_tab), int(PAD_LINE), np.int64)
        rc = np.full((n_l, n_tab), -1, np.int8)
        ri = np.full((n_l, n_tab), -1, np.int8)
        n_uniq = np.zeros(n_l, np.int32)
        rc_c = np.zeros((n_l, 4), np.float32)
        ri_c = np.zeros((n_l, 4, NUM_RI_BINS), np.float32)
        for li, lc in enumerate(layers):
            n = lc.uniq.shape[0]
            uniq[li, :n] = lc.uniq
            rc[li, :n] = lc.rc_cluster
            ri[li, :n] = lc.ri_cluster
            n_uniq[li] = n
            rc_c[li] = lc.rc_centers
            ri_c[li] = lc.ri_centers
        return cls(uniq=uniq, rc_cluster=rc, ri_cluster=ri, n_uniq=n_uniq,
                   rc_centers=rc_c, ri_centers=ri_c,
                   features_ri=[lc.features_ri for lc in layers],
                   hash_fn=hash_fn)

    def replace_layers(self, layer_idxs, other: "LernModel") -> "LernModel":
        """New model with ``layer_idxs`` rows swapped in from ``other``
        (the online-LERN retrain hook updates tables in place this way)."""
        n_tab = max(self.uniq.shape[1], other.uniq.shape[1])

        def expand(a: np.ndarray, pad) -> np.ndarray:
            out = np.full((a.shape[0], n_tab), pad, a.dtype)
            out[:, :a.shape[1]] = a
            return out

        uniq = expand(self.uniq, int(PAD_LINE))
        rc = expand(self.rc_cluster, -1)
        ri = expand(self.ri_cluster, -1)
        n_uniq = self.n_uniq.copy()
        rc_c = self.rc_centers.copy()
        ri_c = self.ri_centers.copy()
        feats = list(self.features_ri)
        for li in layer_idxs:
            n = int(other.n_uniq[li])
            uniq[li], rc[li], ri[li] = int(PAD_LINE), -1, -1
            uniq[li, :n] = other.uniq[li, :n]
            rc[li, :n] = other.rc_cluster[li, :n]
            ri[li, :n] = other.ri_cluster[li, :n]
            n_uniq[li] = n
            rc_c[li] = other.rc_centers[li]
            ri_c[li] = other.ri_centers[li]
            feats[li] = other.features_ri[li]
        return LernModel(uniq=uniq, rc_cluster=rc, ri_cluster=ri,
                         n_uniq=n_uniq, rc_centers=rc_c, ri_centers=ri_c,
                         features_ri=feats, hash_fn=self.hash_fn)


# XLA's f32 log(v) on the CPU (its log1p(x) for x >= 0.414 is log(1 + x)):
# a Cephes-style polynomial whose multiply-adds LLVM fuses (read off the
# compiled code).  The constants are XLA's, as f32.
_LOG_C = (0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
          0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
          0.11676998436450958, -0.16668057441711426, 0.3333333134651184)
_LN2_LO, _LN2_HI = -0.00021219444170128554, 0.693359375  # ln 2, split
_SQRT_HALF = 0.7071067690849304


def log1p_counts(n: torch.Tensor) -> torch.Tensor:
    """``log1p`` of non-negative integer counts (int tensor) as f32, bit
    for bit what XLA's CPU ``jnp.log1p`` gives (checked for every count
    below 2**20; torch's correctly rounded ``log1p`` differs in the last
    bit for ~1 % of them).  LERN's RC features are reuse counts."""
    v = n.to(torch.float32) + 1.0
    bits = v.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0 - small.to(torch.float32)
    z = x * x
    z3 = z * x
    c = [torch.full_like(x, k) for k in _LOG_C]
    p1, p2, p3 = (fma32(x, c[i], c[i + 1]) for i in (0, 2, 4))
    q1, q2, q3 = (fma32(p, x, c[6 + i]) for i, p in enumerate((p1, p2, p3)))
    r = fma32(fma32(q1, z3, q2), z3, q3)
    y = fma32(r, z3, e * _LN2_LO)
    return fma32(e, torch.full_like(x, _LN2_HI), (x - z * 0.5) + y)


# XLA's f32 exp on the CPU (its expm1(x) for |x| > 0.5 is exp(x) - 1): a
# Cephes-style range reduction and polynomial whose multiply-adds LLVM
# fuses.  The constants are XLA's, as f32.
_EXP_CLAMP = (-87.80000305175781, 88.80000305175781)
_LOG2E = 1.4426950216293335
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)


def expm1_centres(x: torch.Tensor) -> torch.Tensor:
    """``expm1`` of f32 values above 0.5 -- de-normalized RC centres,
    which lie at or above log1p(2) -- bit for bit what XLA's CPU
    ``jnp.expm1`` gives there (checked on four million samples of
    [0.5, 20]).  Smaller values take torch's ``expm1``: XLA switches to a
    tanh form there that this does not replay."""
    xc = torch.clamp(x, *_EXP_CLAMP)
    fx = torch.clamp(torch.floor(fma32(xc, torch.full_like(xc, _LOG2E),
                                       torch.full_like(xc, 0.5))),
                     -127.0, 127.0)
    r = fma32(-fx, torch.full_like(xc, _LN2_HI), xc)
    r = fma32(-fx, torch.full_like(xc, _LN2_LO), r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = fma32(y, r, torch.full_like(r, c))
    e = fma32(y, r * r, r) + 1.0
    pow2 = ((fx.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)
    return torch.where(x.abs() > 0.5, e * pow2 - 1.0, torch.expm1(x))


# ---------------------------------------------------------------------------
# the bucketed engine: batched per-layer fits at power-of-two capacities
# ---------------------------------------------------------------------------
def _fit_layer(f_ri: torch.Tensor, f_rc: torch.Tensor, n_multi: torch.Tensor,
               keys: torch.Tensor, use_kernel: bool = True) -> Dict:
    """Fit RC + RI clusters for a batch of layers' compacted feature
    tables: ``f_ri`` [G, N, 4] / ``f_rc`` [G, N] hold each layer's
    multi-occurrence lines in its first ``n_multi[g]`` rows (uniq order),
    zero-padded to the capacity N; ``keys`` [G, 2].  The batch axis is
    the JAX package's ``vmap`` of its per-layer ``_fit_layer``.  Returns
    [G, ...] tensors: rc/ri assignments, de-normalized centres and the RC
    centres in the normalized space."""
    g, n = f_rc.shape
    dev = f_rc.device
    cmask = torch.arange(n, device=dev)[None, :] < n_multi[:, None]
    m3 = cmask[:, :, None]
    # --- RC clustering (1-D, log1p + min-max normalized) -------------------
    xrc = log1p_counts(f_rc)[:, :, None]
    lo = torch.where(m3, xrc, torch.inf).amin(1)             # [G, 1]
    hi = torch.where(m3, xrc, -torch.inf).amax(1)
    span = hi - lo
    xn = torch.where(m3, (xrc - lo[:, None]) / torch.clamp(
        span, min=1e-9)[:, None], 0.0)
    rc = km.kmeans_fit_batched(xn, cmask, prng.fold_in(keys, 0), k=4,
                               use_kernel=use_kernel, device=dev)
    # XLA contracts c * (hi - lo) + lo into one fused multiply-add
    rc_centers = expm1_centres(fma32(rc.centers, span[:, None],
                                     lo[:, None])).reshape(g, -1)
    # --- RI clustering (4-D histogram rows, L1-normalized) -----------------
    raw = f_ri.to(torch.float32)
    xri = torch.where(m3, raw / torch.clamp(raw.sum(2, keepdim=True),
                                            min=1e-9), 0.0)
    ri = km.kmeans_fit_batched(xri, cmask, prng.fold_in(keys, 1), k=4,
                               use_kernel=use_kernel, device=dev)
    # de-normalized centres: mean raw histogram of each cluster's members
    # (sums of integer counts, exact in any order)
    oh = torch.nn.functional.one_hot(ri.assign.to(torch.int64), 4).to(
        torch.float64) * m3
    cnt = oh.sum(1).to(torch.float32)
    sums = torch.einsum("gnk,gnd->gkd", oh, raw.to(torch.float64)).to(
        torch.float32)
    ri_centers = sums / torch.clamp(cnt, min=1.0)[:, :, None]
    return {"rc_assign": rc.assign, "rc_centers": rc_centers,
            "rc_centers_norm": rc.centers.reshape(g, -1),
            "ri_assign": ri.assign, "ri_centers": ri_centers}


def _fit_groups(groups, use_kernel: bool = True):
    """All layers' bucketed fits: ``groups`` is a tuple of capacity
    buckets, each a ``(f_ri [G, cap, 4], f_rc [G, cap], n_multi [G],
    keys [G, 2])`` tuple of tensors on one device; each bucket is one
    batched ``_fit_layer``."""
    return tuple(_fit_layer(f_ri, f_rc, nm, keys, use_kernel=use_kernel)
                 for f_ri, f_rc, nm, keys in groups)


def _seg_prep(f_ri: torch.Tensor, f_rc: torch.Tensor, seg: torch.Tensor,
              keys: torch.Tensor, n_seg: int) -> Dict:
    """Normalize the flat feature rows into the combined 2*n_seg-segment
    point array (RC half zero-padded to the RI feature width -- distances
    are unchanged): log1p + per-segment min-max for RC, row L1 for RI."""
    p = f_rc.shape[0]
    dev = f_rc.device
    valid = seg < n_seg
    segc = torch.clamp(seg, max=n_seg - 1).to(torch.int64)
    xrc = log1p_counts(f_rc)
    inf = torch.full((n_seg,), torch.inf, device=dev)
    lo = inf.scatter_reduce(0, segc, torch.where(valid, xrc, torch.inf),
                            "amin")
    hi = (-inf).scatter_reduce(0, segc, torch.where(valid, xrc, -torch.inf),
                               "amax")
    rng = torch.clamp(hi - lo, min=1e-9)
    xn = torch.where(valid, (xrc - lo[segc]) / rng[segc], 0.0)
    x_rc = torch.zeros((p, NUM_RI_BINS), dtype=torch.float32, device=dev)
    x_rc[:, 0] = xn
    raw = f_ri.to(torch.float32)
    x_ri = torch.where(valid[:, None],
                       raw / torch.clamp(raw.sum(1, keepdim=True), min=1e-9),
                       0.0)
    xx = torch.cat([x_rc, x_ri])
    seg2 = torch.cat([torch.where(valid, seg, 2 * n_seg),
                      torch.where(valid, seg + n_seg, 2 * n_seg)]).to(
        torch.int32)
    keys2 = torch.cat([prng.fold_in(keys, 0), prng.fold_in(keys, 1)])
    return {"xx": xx, "seg2": seg2, "keys2": keys2, "lo": lo, "hi": hi}


def _seg_post(assign2: torch.Tensor, centers2: torch.Tensor,
              f_ri: torch.Tensor, seg: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, n_seg: int) -> Dict:
    """Host-facing fit tables from the combined segmented fit result:
    de-normalized RC centers (expm1) and the mean-raw-histogram RI centers
    per (segment, cluster).  The sums are of integer counts far below
    2**24, exact in float32, so scatter-add order cannot change them."""
    p = f_ri.shape[0]
    dev = f_ri.device
    valid = seg < n_seg
    rc_centers_norm = centers2[:n_seg, :, 0]              # [S, 4]
    # XLA contracts c * (hi - lo) + lo into one fused multiply-add
    rc_centers = expm1_centres(fma32(rc_centers_norm, (hi - lo)[:, None],
                                     lo[:, None]))
    ri_assign = assign2[p:]
    raw = f_ri.to(torch.float32)
    sid = torch.where(valid, seg.to(torch.int64) * 4 + ri_assign,
                      n_seg * 4)
    fvalid = valid.to(torch.float32)
    cnt = torch.zeros(n_seg * 4 + 1, device=dev).index_add_(
        0, sid, fvalid)[:n_seg * 4].reshape(n_seg, 4)
    sums = torch.zeros((n_seg * 4 + 1, NUM_RI_BINS), device=dev).index_add_(
        0, sid, raw * fvalid[:, None])[:n_seg * 4].reshape(
        n_seg, 4, NUM_RI_BINS)
    ri_centers = sums / torch.clamp(cnt, min=1.0)[:, :, None]
    return {"rc_assign": assign2[:p], "rc_centers": rc_centers,
            "rc_centers_norm": rc_centers_norm,
            "ri_assign": ri_assign, "ri_centers": ri_centers}


def _fit_segmented(f_ri: torch.Tensor, f_rc: torch.Tensor, seg: torch.Tensor,
                   seg_off: np.ndarray, seg_cnt: np.ndarray,
                   keys: torch.Tensor, n_seg: int) -> Dict:
    """All eligible layers' RC + RI fits as one flat segmented fit: the
    RC points under ``fold_in(key, 0)``, the RI points under
    ``fold_in(key, 1)`` -- 2*n_seg segments of one
    ``kmeans.kmeans_fit_segmented`` call."""
    p = int(f_rc.shape[0])
    prep = _seg_prep(f_ri, f_rc, seg, keys, n_seg)
    off2 = np.concatenate([np.asarray(seg_off, np.int32),
                           np.asarray(seg_off, np.int32) + p])
    cnt2 = np.concatenate([np.asarray(seg_cnt, np.int32)] * 2)
    res = km.kmeans_fit_segmented(prep["xx"], prep["seg2"], off2, cnt2,
                                  prep["keys2"], n_seg=2 * n_seg, k=4,
                                  device=f_rc.device)
    out = _seg_post(res.assign.to(torch.int64), res.centers, f_ri, seg,
                    prep["lo"], prep["hi"], n_seg)
    return dict(out, n_iter=res.n_iter)


def _annotate(fit: Dict, n_multi: int) -> Dict:
    """Host-side O(k) semantic annotation of one layer's fit result."""
    label_rc = km.annotate_rc(np.asarray(fit["rc_centers_norm"]))
    centers_d = np.asarray(fit["ri_centers"])
    label_ri = km.annotate_ri(centers_d)
    return {
        "rc_label": label_rc[np.asarray(fit["rc_assign"][:n_multi])],
        "ri_label": label_ri[np.asarray(fit["ri_assign"][:n_multi])],
        "rc_centers": np.asarray(fit["rc_centers"])[np.argsort(label_rc)],
        "ri_centers": centers_d[np.argsort(label_ri)],
    }


def _fit_host_features(uniq: np.ndarray, f_ri: np.ndarray, f_rc: np.ndarray,
                       seed: int, cap: Optional[int], use_kernel: bool,
                       dev: torch.device) -> LayerClusters:
    """Cluster one layer from host-extracted integer features through
    ``_fit_layer`` (one batch row) at ``cap``-padded shape on ``dev``."""
    n = uniq.shape[0]
    rc_cluster = np.full(n, -1, dtype=np.int64)
    ri_cluster = np.full(n, -1, dtype=np.int64)
    multi = f_rc > 1  # single-occurrence lines -> No Reuse
    n_multi = int(multi.sum())

    rc_centers = np.zeros(4, np.float32)
    ri_centers = np.zeros((4, NUM_RI_BINS), np.float32)
    if n_multi >= MIN_MULTI:
        cap = cap or _bucket(n_multi)
        f_ri_c = np.zeros((1, cap, NUM_RI_BINS), np.int32)
        f_rc_c = np.zeros((1, cap), np.int32)
        f_ri_c[0, :n_multi] = f_ri[multi]
        f_rc_c[0, :n_multi] = f_rc[multi]
        fit = _fit_layer(torch.as_tensor(f_ri_c, device=dev),
                         torch.as_tensor(f_rc_c, device=dev),
                         torch.tensor([n_multi], device=dev),
                         prng.PRNGKey(seed, dev)[None],
                         use_kernel=use_kernel)
        ann = _annotate({k: v[0].cpu().numpy() for k, v in fit.items()},
                        n_multi)
        rc_cluster[multi] = ann["rc_label"]
        ri_cluster[multi] = ann["ri_label"]
        rc_centers, ri_centers = ann["rc_centers"], ann["ri_centers"]

    return LayerClusters(uniq=uniq, rc_cluster=rc_cluster,
                         ri_cluster=ri_cluster, rc_centers=rc_centers,
                         ri_centers=ri_centers,
                         features_ri=f_ri[multi] if multi.any()
                         else np.zeros((0, NUM_RI_BINS), np.int64))


def train_layer(lines: np.ndarray, seed: int = 0, cap: Optional[int] = None,
                use_kernel: bool = True, device="cuda") -> LayerClusters:
    """Host-reference LERN pipeline on one layer's line trace: numpy
    features, then ``_fit_layer`` on ``device`` padded to ``cap`` points
    (default: this layer's own power-of-two bucket, the capacity its row
    gets in the bucketed engine)."""
    dev = _device.resolve(device)
    sig = reuse_signature_np(lines)
    f_ri, f_rc = ri_histogram_np(lines, sig)
    return _fit_host_features(sig["uniq"], f_ri, f_rc, seed, cap, use_kernel,
                              dev)


def _layer_lines(trace: Trace, hash_fn: Optional[Callable]
                 ) -> List[np.ndarray]:
    out = []
    for li in range(len(trace.layer_names)):
        lines = trace.line[trace.layer == li]
        out.append(hash_fn(lines) if hash_fn is not None else lines)
    return out


def train(trace: Trace, hash_fn: Optional[Callable] = None, seed: int = 0,
          use_kernel: bool = True, device="cuda") -> LernModel:
    """Host-reference trainer: per-layer numpy features + ``_fit_layer``
    per layer at its own power-of-two capacity, the shape its row has in
    the bucketed engine.  ``hash_fn`` (paper §VI-J): train on *hashed*
    addresses so the predictor internalizes L-RPT aliasing."""
    dev = _device.resolve(device)
    layers = [train_layer(lines, seed=seed + li, use_kernel=use_kernel,
                          device=dev)
              for li, lines in enumerate(_layer_lines(trace, hash_fn))]
    return LernModel.from_layers(layers, hash_fn=hash_fn)


def _extract_flat(lines_all: np.ndarray, layer_all: np.ndarray, n_l: int,
                  dev: torch.device):
    """One ``reuse_features_flat`` extraction over the concatenated trace
    on ``dev``, then the host eligibility scan (per-layer multi-occurrence
    masks and MIN_MULTI).  Returns (uniq_f, f_ri_f, f_rc_f, n_uniq, offs,
    per_layer, elig) as host arrays."""
    m = lines_all.shape[0]
    m_pad = max(8, ((m + 4095) // 4096) * 4096)
    lines32 = np.full(m_pad, int(PAD_LINE), np.int32)
    lines32[:m] = lines_to_device(lines_all)
    layer32 = np.full(m_pad, n_l, np.int32)
    layer32[:m] = layer_all
    feats = reuse_features_flat(torch.as_tensor(lines32, device=dev),
                                torch.as_tensor(layer32, device=dev), m, n_l)
    uniq_f = feats["uniq"].cpu().numpy().astype(np.int64)
    f_ri_f = feats["f_ri"].cpu().numpy()
    f_rc_f = feats["f_rc"].cpu().numpy()
    n_uniq = feats["n_uniq"].cpu().numpy().astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(n_uniq)])
    per_layer = []  # (multi_mask, n_multi)
    elig = []
    for li in range(n_l):
        multi = f_rc_f[offs[li]:offs[li + 1]] > 1
        nm = int(multi.sum())
        per_layer.append((multi, nm))
        if nm >= MIN_MULTI:
            elig.append(li)
    return uniq_f, f_ri_f, f_rc_f, n_uniq, offs, per_layer, elig


def _fit_flat(lines_all: np.ndarray, layer_all: np.ndarray, n_l: int,
              key_seeds: List[int], dev: torch.device, use_kernel: bool,
              fit_engine: Optional[str]):
    """Shared flat-trace fit core of the batched trainers: one
    ``reuse_features_flat`` extraction over the concatenated trace
    (``layer_all`` non-decreasing, 0..n_l-1), then every eligible layer's
    k-means fits on the engine ``fit_engine`` names; ``key_seeds[li]``
    seeds layer li's draws.  Returns (uniq_f, f_ri_f, f_rc_f, n_uniq,
    offs, per_layer, layer_fits), ``layer_fits[li]`` the host-side fit
    dict ``_annotate`` consumes (absent for ineligible layers)."""
    engine = resolve_engine(fit_engine)
    uniq_f, f_ri_f, f_rc_f, n_uniq, offs, per_layer, elig = \
        _extract_flat(lines_all, layer_all, n_l, dev)
    if engine == "segmented":
        layer_fits = _fit_flat_segmented(f_ri_f, f_rc_f, offs, per_layer,
                                         elig, key_seeds, dev)
    else:
        layer_fits = _fit_flat_bucketed(f_ri_f, f_rc_f, offs, per_layer,
                                        elig, key_seeds, use_kernel, dev)
    return uniq_f, f_ri_f, f_rc_f, n_uniq, offs, per_layer, layer_fits


def _fit_flat_bucketed(f_ri_f, f_rc_f, offs, per_layer, elig, key_seeds,
                       use_kernel: bool, dev: torch.device
                       ) -> Dict[int, Dict]:
    """Oracle fit path: layers batched in power-of-two capacity buckets,
    one ``_fit_layer`` per bucket."""
    buckets: Dict[int, List[int]] = {}
    for li in elig:
        buckets.setdefault(_bucket(per_layer[li][1]), []).append(li)
    groups = []
    group_of: Dict[int, tuple] = {}
    for cap in sorted(buckets):
        members = buckets[cap]
        g_ri = np.zeros((len(members), cap, NUM_RI_BINS), np.int32)
        g_rc = np.zeros((len(members), cap), np.int32)
        g_nm = np.zeros(len(members), np.int64)
        for gi, li in enumerate(members):
            multi, nm = per_layer[li]
            sl = slice(offs[li], offs[li + 1])
            g_ri[gi, :nm] = f_ri_f[sl][multi]
            g_rc[gi, :nm] = f_rc_f[sl][multi]
            g_nm[gi] = nm
            group_of[li] = (len(groups), gi)
        keys = torch.stack([prng.PRNGKey(key_seeds[li], dev)
                            for li in members])
        groups.append((torch.as_tensor(g_ri, device=dev),
                       torch.as_tensor(g_rc, device=dev),
                       torch.as_tensor(g_nm, device=dev), keys))
    fits = _fit_groups(tuple(groups), use_kernel=use_kernel)
    fits_np = [{k: v.cpu().numpy() for k, v in f.items()} for f in fits]
    return {li: {k: v[gi] for k, v in fits_np[g].items()}
            for li, (g, gi) in group_of.items()}


def _fit_flat_segmented(f_ri_f, f_rc_f, offs, per_layer, elig, key_seeds,
                        dev: torch.device) -> Dict[int, Dict]:
    """Every eligible layer's multi-occurrence feature rows concatenated
    into ONE [P, F] array with a segment-id column (runs padded only to
    SEG_BLOCK multiples, the total to a 2048 multiple)."""
    if not elig:
        return {}
    counts = [per_layer[li][1] for li in elig]
    seg_off, total = km.segment_layout(counts)
    n_seg = len(elig)
    p = max(((total + 2047) // 2048) * 2048, km.SEG_BLOCK)
    f_ri_m = np.zeros((p, NUM_RI_BINS), np.int32)
    f_rc_m = np.zeros(p, np.int32)
    seg = np.full(p, n_seg, np.int32)
    for si, li in enumerate(elig):
        multi, nm = per_layer[li]
        sl = slice(offs[li], offs[li + 1])
        o = seg_off[si]
        f_ri_m[o:o + nm] = f_ri_f[sl][multi]
        f_rc_m[o:o + nm] = f_rc_f[sl][multi]
        seg[o:o + nm] = si
    keys = torch.stack([prng.PRNGKey(key_seeds[li], dev) for li in elig])
    fit = _fit_segmented(torch.as_tensor(f_ri_m, device=dev),
                         torch.as_tensor(f_rc_m, device=dev),
                         torch.as_tensor(seg, device=dev), seg_off,
                         np.asarray(counts, np.int32), keys, n_seg)
    fit_np = {k: v.cpu().numpy() for k, v in fit.items() if k != "n_iter"}
    out: Dict[int, Dict] = {}
    for si, li in enumerate(elig):
        nm = per_layer[li][1]
        o = seg_off[si]
        out[li] = {"rc_assign": fit_np["rc_assign"][o:o + nm],
                   "ri_assign": fit_np["ri_assign"][o:o + nm],
                   "rc_centers": fit_np["rc_centers"][si],
                   "rc_centers_norm": fit_np["rc_centers_norm"][si],
                   "ri_centers": fit_np["ri_centers"][si]}
    return out


def _assemble(flat, lo: int, hi: int,
              hash_fn: Optional[Callable]) -> LernModel:
    """Build the LernModel for layer range [lo, hi) of a flat fit."""
    uniq_f, f_ri_f, f_rc_f, n_uniq_all, offs, per_layer, layer_fits = flat
    n_l = hi - lo
    n_uniq = n_uniq_all[lo:hi]
    n_tab = _bucket(int(n_uniq.max(initial=1)))
    uniq = np.full((n_l, n_tab), int(PAD_LINE), np.int64)
    rc = np.full((n_l, n_tab), -1, np.int8)
    ri = np.full((n_l, n_tab), -1, np.int8)
    rc_c = np.zeros((n_l, 4), np.float32)
    ri_c = np.zeros((n_l, 4, NUM_RI_BINS), np.float32)
    features: List[np.ndarray] = []
    for li in range(lo, hi):
        k = li - lo
        nu = int(n_uniq_all[li])
        multi, nm = per_layer[li]
        sl = slice(offs[li], offs[li + 1])
        uniq[k, :nu] = uniq_f[sl]
        features.append(f_ri_f[sl][multi].astype(np.int64))
        if li not in layer_fits:
            continue
        ann = _annotate(layer_fits[li], nm)
        rc[k, :nu][multi] = ann["rc_label"].astype(np.int8)
        ri[k, :nu][multi] = ann["ri_label"].astype(np.int8)
        rc_c[k], ri_c[k] = ann["rc_centers"], ann["ri_centers"]
    return LernModel(uniq=uniq, rc_cluster=rc, ri_cluster=ri,
                     n_uniq=n_uniq, rc_centers=rc_c, ri_centers=ri_c,
                     features_ri=features, hash_fn=hash_fn)


def _layer_sorted(trace: Trace):
    """(lines, layer) int64 arrays with each layer contiguous; a stable
    sort by layer preserves within-layer order (exact reuse intervals)."""
    lines = np.asarray(trace.line, np.int64)
    layer = np.asarray(trace.layer, np.int64)
    if np.any(np.diff(layer) < 0):
        order = np.argsort(layer, kind="stable")
        lines, layer = lines[order], layer[order]
    return lines, layer


def train_model_batched(trace: Trace, hash_fn: Optional[Callable] = None,
                        seed: int = 0, use_kernel: bool = True,
                        fit_engine: Optional[str] = None,
                        device="cuda") -> LernModel:
    """Train the whole model's LERN tables on ``device``: one flat feature
    extraction, every eligible layer's fits on the ``fit_engine`` (default
    ``FIT_ENGINE``; layer ``li`` seeded with ``PRNGKey(seed + li)``), host
    annotation.  Equal in cluster tables to the JAX package's
    ``lern.train_model_batched`` on the same engine (centres to FP
    reassociation).  ``use_kernel`` (bucketed engine) sends the Lloyd
    assignment through the dense kernel's wrapper."""
    dev = _device.resolve(device)
    lines_all, layer_all = _layer_sorted(trace)
    if hash_fn is not None:
        lines_all = hash_fn(lines_all)
    n_l = max(len(trace.layer_names), 1)
    flat = _fit_flat(lines_all, layer_all, n_l,
                     [seed + li for li in range(n_l)], dev, use_kernel,
                     fit_engine)
    return _assemble(flat, 0, n_l, hash_fn)


def train_family_batched(traces: List[Trace],
                         hash_fn: Optional[Callable] = None, seed: int = 0,
                         use_kernel: bool = True,
                         fit_engine: Optional[str] = None,
                         device="cuda") -> List[LernModel]:
    """Train several configs' LERN models in one flat fit: the traces
    concatenated with offset layer ids into one extraction, every
    config's layers in one engine call.  Each model equals
    ``train_model_batched(traces[i], ...)`` on the same engine: per-layer
    integer features are position-exact under concatenation, bucket rows
    and segments are independent, and each layer keeps its own-config key
    ``seed + local_layer``."""
    dev = _device.resolve(device)
    n_ls = [max(len(tr.layer_names), 1) for tr in traces]
    bounds = np.concatenate([[0], np.cumsum(n_ls)]).astype(np.int64)
    lines_parts, layer_parts, seeds = [], [], []
    for ci, tr in enumerate(traces):
        lines, layer = _layer_sorted(tr)
        lines_parts.append(lines)
        layer_parts.append(layer + bounds[ci])
        seeds.extend(seed + li for li in range(n_ls[ci]))
    lines_all = (np.concatenate(lines_parts) if traces
                 else np.zeros(0, np.int64))
    layer_all = (np.concatenate(layer_parts) if traces
                 else np.zeros(0, np.int64))
    if hash_fn is not None and lines_all.size:
        lines_all = hash_fn(lines_all)
    flat = _fit_flat(lines_all, layer_all, int(bounds[-1]), seeds, dev,
                     use_kernel, fit_engine)
    return [_assemble(flat, int(bounds[ci]), int(bounds[ci + 1]), hash_fn)
            for ci in range(len(traces))]


def train_host_numpy(trace: Trace, hash_fn: Optional[Callable] = None,
                     seed: int = 0, device="cuda") -> LernModel:
    """The pre-refactor host pipeline, kept as the perf baseline (the JAX
    package's ``train_host_numpy``).

    A Python loop over layers, numpy feature extraction, two k-means fits
    per layer at that layer's *exact* point count (``kmeans.kmeans_fit`` on
    ``device``: the ``kmeans_fit`` and ``kmeans_assign`` kernels on the
    card), and the O(n^2) silhouette computed inline.  It is not
    bitwise-comparable to the batched path (the fit shapes differ), so
    parity tests use ``train`` instead."""
    dev = _device.resolve(device)
    layers = []
    for li, lines in enumerate(_layer_lines(trace, hash_fn)):
        sig = reuse_signature_np(lines)
        f_ri, f_rc = ri_histogram_np(lines, sig)
        n = sig["uniq"].shape[0]
        rc_cluster = np.full(n, -1, dtype=np.int64)
        ri_cluster = np.full(n, -1, dtype=np.int64)
        multi = f_rc > 1
        sil = 0.0
        rc_centers = np.zeros(4, np.float32)
        ri_centers = np.zeros((4, NUM_RI_BINS), np.float32)
        if int(multi.sum()) >= MIN_MULTI:
            xrc = torch.as_tensor(np.log1p(f_rc[multi]).astype(np.float32),
                                  device=dev)[:, None]
            xn, lo, hi = km.normalize(xrc)
            res = km.kmeans_fit(xn, k=4, seed=seed + li, device=dev)
            centers = res.centers.cpu().numpy()
            label_of = km.annotate_rc(centers)
            rc_cluster[multi] = label_of[res.assign.cpu().numpy()]
            denorm = centers * (hi - lo).cpu().numpy() + lo.cpu().numpy()
            rc_centers = np.expm1(denorm.reshape(-1))[np.argsort(label_of)]
            xri_raw = f_ri[multi].astype(np.float32)
            xri = xri_raw / np.maximum(xri_raw.sum(1, keepdims=True), 1e-9)
            res = km.kmeans_fit(torch.as_tensor(xri, device=dev), k=4,
                                seed=seed + li, device=dev)
            assign = res.assign.cpu().numpy()
            centers_d = np.stack([
                xri_raw[assign == c].mean(0) if (assign == c).any()
                else np.zeros(NUM_RI_BINS) for c in range(4)])
            label_ri = km.annotate_ri(centers_d)
            ri_cluster[multi] = label_ri[assign]
            ri_centers = centers_d[np.argsort(label_ri)]
            sil = km.silhouette_score(xri, assign)
        layers.append(LayerClusters(
            uniq=sig["uniq"], rc_cluster=rc_cluster, ri_cluster=ri_cluster,
            rc_centers=rc_centers, ri_centers=ri_centers,
            features_ri=f_ri[multi] if multi.any()
            else np.zeros((0, NUM_RI_BINS), np.int64), _sil=sil))
    return LernModel.from_layers(layers, hash_fn=hash_fn)


def prediction_accuracy(model: LernModel, trace: Trace) -> float:
    """§IV-D: fraction of actual reuse intervals whose bin matches the
    cluster's correct-bin set (No-Reuse lines: correct iff truly single)."""
    e0, e1, e2 = RI_BIN_EDGES
    total = 0
    correct = 0
    for li, lc in enumerate(model.layers):
        mask = trace.layer == li
        lines = trace.line[mask]
        if model.hash_fn is not None:
            lines = model.hash_fn(lines)
        sig = reuse_signature_np(lines)
        ri, inv = sig["ri"], sig["inv"]
        # map this trace's unique set onto the trained unique set
        pos = np.searchsorted(lc.uniq, sig["uniq"])
        pos = np.clip(pos, 0, max(0, lc.uniq.shape[0] - 1))
        known = (lc.uniq.shape[0] > 0) & (lc.uniq[pos] == sig["uniq"])
        ri_cl = np.where(known, lc.ri_cluster[pos], -1)[inv]
        valid = ri >= 0  # occurrences that have an actual next-reuse
        bins = np.where(ri <= e0, 0, np.where(ri <= e1, 1,
                        np.where(ri <= e2, 2, 3)))
        for lbl, ok_bins in _CORRECT_BINS.items():
            m = valid & (ri_cl == lbl)
            total += int(m.sum())
            correct += int(np.isin(bins[m], ok_bins).sum())
        # No-Reuse predictions are correct when the line truly has no reuse:
        m = (ri_cl == -1)
        total += int(m.sum())
        correct += int((ri[m] < 0).sum())
    return correct / max(1, total)


def cluster_distribution(model: LernModel, trace: Trace
                         ) -> Dict[str, np.ndarray]:
    """Fig. 6: per-layer % of memory *accesses* in each RI / RC cluster."""
    n_layers = model.n_layers
    ri_dist = np.zeros((n_layers, 5))  # Immediate..Remote, NoReuse
    rc_dist = np.zeros((n_layers, 5))  # Cold..Hot, NoReuse
    for li, lc in enumerate(model.layers):
        mask = trace.layer == li
        lines = trace.line[mask]
        if model.hash_fn is not None:
            lines = model.hash_fn(lines)
        uniq, inv, cnt = np.unique(lines, return_inverse=True,
                                   return_counts=True)
        pos = np.searchsorted(lc.uniq, uniq)
        pos = np.clip(pos, 0, max(0, lc.uniq.shape[0] - 1))
        known = (lc.uniq.shape[0] > 0) & (lc.uniq[pos] == uniq)
        ri_cl = np.where(known, lc.ri_cluster[pos], -1)[inv]
        rc_cl = np.where(known, lc.rc_cluster[pos], -1)[inv]
        for k in range(4):
            ri_dist[li, k] = (ri_cl == k).mean()
            rc_dist[li, k] = (rc_cl == k).mean()
        ri_dist[li, 4] = (ri_cl == -1).mean()
        rc_dist[li, 4] = (rc_cl == -1).mean()
    return {"ri": ri_dist, "rc": rc_dist}
