"""LERN — clustering-based learning & prediction of accelerator reuse
(paper §IV).  Pipeline:

    per-layer trace -> cache-line collapse (optionally through the L-RPT
    hash, §VI-J) -> reuse signature -> (F_RI, F_RC) features -> two
    K-means(k=4) -> semantic annotation -> per-line (RC_cluster, RI_cluster)
    lookup tables, loaded layer-by-layer into the L-RPT at runtime.

``train_model_batched`` trains all layers of a (model x accel-config) on
one device: the flat whole-trace feature extraction
(``reuse.reuse_features_flat``: one composite (layer, line) sort +
``ri_histogram`` kernel binning), then one flat-segmented k-means over
every eligible layer (``kmeans.kmeans_fit_segmented``, assignment through
the ``kmeans_assign_segmented`` kernel).  Only the O(k) semantic
annotation runs on the host.

Lines with a single occurrence are assigned the No-Reuse cluster (-1, -1).
The model stores stacked per-layer lookup arrays (``uniq`` / ``rc_cluster``
/ ``ri_cluster`` -- [L, N] tables consumed directly by ``lrpt.pack_tables``
and ``sim.trace_clusters``); ``model.layers`` offers per-layer views.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import device as _device
from . import kmeans as km
from . import prng
from .reuse import (NUM_RI_BINS, PAD_LINE, lines_to_device,
                    reuse_features_flat)
from .tracegen import Trace

MIN_MULTI = 8  # need enough multi-occurrence lines for 4 clusters


def resolve_engine(engine: Optional[str] = None) -> str:
    """The concrete k-means fit engine: the port has the flat-segmented
    one (``"segmented"``, also what ``"auto"`` means)."""
    e = engine or "auto"
    if e == "auto":
        e = "segmented"
    if e == "bucketed":
        raise NotImplementedError(
            "the bucketed LERN fit engine is not ported yet (ROADMAP.md "
            "Queue 1, 'lern rest')")
    if e != "segmented":
        raise ValueError(f"unknown LERN fit engine {e!r} "
                         "(expected segmented|auto)")
    return e


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


def _seg_prep(f_ri: torch.Tensor, f_rc: torch.Tensor, seg: torch.Tensor,
              keys: torch.Tensor, n_seg: int) -> Dict:
    """Normalize the flat feature rows into the combined 2*n_seg-segment
    point array (RC half zero-padded to the RI feature width -- distances
    are unchanged): log1p + per-segment min-max for RC, row L1 for RI."""
    p = f_rc.shape[0]
    dev = f_rc.device
    valid = seg < n_seg
    segc = torch.clamp(seg, max=n_seg - 1).to(torch.int64)
    xrc = torch.log1p(f_rc.to(torch.float32))
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
    rc_centers = torch.expm1(rc_centers_norm * (hi - lo)[:, None]
                             + lo[:, None])
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
                        seed: int = 0, device="cuda") -> LernModel:
    """Train the whole model's LERN tables on ``device``: one flat feature
    extraction, one flat-segmented k-means over every eligible layer
    (layer ``li`` seeded with ``PRNGKey(seed + li)``), host annotation.
    Assignment-equal to the JAX package's ``lern.train_model_batched``
    (same label tables; centres to FP reassociation)."""
    dev = _device.resolve(device)
    lines_all, layer_all = _layer_sorted(trace)
    if hash_fn is not None:
        lines_all = hash_fn(lines_all)
    n_l = max(len(trace.layer_names), 1)
    uniq_f, f_ri_f, f_rc_f, n_uniq, offs, per_layer, elig = \
        _extract_flat(lines_all, layer_all, n_l, dev)
    layer_fits = _fit_flat_segmented(f_ri_f, f_rc_f, offs, per_layer, elig,
                                     [seed + li for li in range(n_l)], dev)
    flat = (uniq_f, f_ri_f, f_rc_f, n_uniq, offs, per_layer, layer_fits)
    return _assemble(flat, 0, n_l, hash_fn)
