"""Reuse Interval / Reuse Count signature extraction (paper §IV-A, Table I).

Definitions (cache-line granularity):
* occurrence positions of line c_i in the trace: r_i = (m_1 < m_2 < ... < m_Ti)
* Reuse Interval at occurrence j:  RI_{i,j} = r_{i,j+1} - r_{i,j}; the last
  occurrence has RI = -1.
* Reuse Count T_i = number of occurrences of c_i (the running count at
  position m_j is j).

Two implementations: the numpy oracle (``reuse_signature_np`` +
``ri_histogram_np``, copied from the JAX package) and the torch feature
path ``reuse_features_flat`` that the LERN trainer runs on the device,
whose RI binning goes through the ``ri_histogram`` kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels.ri_histogram import ops as _hist_ops

RI_BIN_EDGES = (10, 100, 500)  # bins: [1,10], (10,100], (100,500], (500,inf)
NUM_RI_BINS = 4


def reuse_signature_np(lines: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-access RI (forward) and running RC, plus per-unique-line data.

    Returns dict with:
      ri        int64 [M]   forward reuse interval per access (-1 if last)
      rc_run    int64 [M]   running occurrence count per access (1-based)
      uniq      int64 [N]   unique line addresses (sorted)
      inv       int64 [M]   index into uniq per access
      count     int64 [N]   total reuse count T_i per unique line
    """
    lines = np.asarray(lines, dtype=np.int64)
    m = lines.shape[0]
    uniq, inv, count = np.unique(lines, return_inverse=True,
                                 return_counts=True)
    # stable sort by (line, position): positions ascending within each line
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    sorted_pos = order.astype(np.int64)
    same_next = np.empty(m, dtype=bool)
    same_next[:-1] = sorted_inv[1:] == sorted_inv[:-1]
    same_next[-1] = False
    ri_sorted = np.where(same_next,
                         np.concatenate([sorted_pos[1:], [0]]) - sorted_pos,
                         -1)
    ri = np.empty(m, dtype=np.int64)
    ri[order] = ri_sorted
    # running count: index within the line's segment (1-based)
    seg_start = np.empty(m, dtype=bool)
    seg_start[0] = True
    seg_start[1:] = sorted_inv[1:] != sorted_inv[:-1]
    seg_id = np.cumsum(seg_start) - 1
    first_of_seg = np.flatnonzero(seg_start)
    rc_sorted = np.arange(m, dtype=np.int64) - first_of_seg[seg_id] + 1
    rc_run = np.empty(m, dtype=np.int64)
    rc_run[order] = rc_sorted
    return {"ri": ri, "rc_run": rc_run, "uniq": uniq, "inv": inv,
            "count": count}


def ri_histogram_np(lines: np.ndarray, sig: Dict[str, np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-unique-line features: (F_RI [N,4] histogram, F_RC [N] counts).

    The final -1 interval of each line is excluded from the histogram, per
    Table I (c_1 RV={1,1,3,1,-1} -> F_RI={4,0,0,0})."""
    if sig is None:
        sig = reuse_signature_np(lines)
    ri, inv, n = sig["ri"], sig["inv"], sig["uniq"].shape[0]
    valid = ri >= 0
    e0, e1, e2 = RI_BIN_EDGES
    bin_idx = np.where(ri <= e0, 0, np.where(ri <= e1, 1,
                       np.where(ri <= e2, 2, 3)))
    f_ri = np.zeros((n, NUM_RI_BINS), dtype=np.int64)
    np.add.at(f_ri, (inv[valid], bin_idx[valid]), 1)
    return f_ri, sig["count"]


# ----------------------------------------------------------------------------
# torch feature path (the LERN trainer's extraction step)
# ----------------------------------------------------------------------------
# Padding sentinel for line arrays.  The device path carries lines as int32;
# host traces are int64 but their values are small element offsets (and
# L-RPT-hashed training addresses are masked to <= 18 bits), so the mapping
# is exact.  ``lines_to_device`` checks the range.  PAD_LINE sorts after
# every real line.
PAD_LINE = np.int32(np.iinfo(np.int32).max)


def lines_to_device(lines: np.ndarray) -> np.ndarray:
    """Exact int64 -> int32 narrowing for device-side feature extraction."""
    lines = np.asarray(lines, dtype=np.int64)
    if lines.size and (lines.min() < 0 or lines.max() >= int(PAD_LINE)):
        raise ValueError("line addresses out of int32 device range")
    return lines.astype(np.int32)


def ri_bin(ri: torch.Tensor) -> torch.Tensor:
    """Map a (non-negative) reuse interval to its bin index 0..3."""
    e0, e1, e2 = RI_BIN_EDGES
    return torch.where(ri <= e0, 0, torch.where(
        ri <= e1, 1, torch.where(ri <= e2, 2, 3)))


def reuse_features_flat(lines: torch.Tensor, layer: torch.Tensor,
                        n_valid: int, n_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """Whole-model reuse features in one flat pass (no per-layer padding).

    ``lines``/``layer`` are int32 [M] on one device; the first ``n_valid``
    entries are real accesses, ``layer`` non-decreasing over them (each
    layer's accesses contiguous), so per-layer reuse intervals are exactly
    the global position differences.  The trace is sorted once by the
    composite (layer, line) key -- two stable sorts -- then segment ids
    come from a cumsum and the tables from integer scatter-adds (integer
    atomics, so the result does not depend on their order).

    Returns flat per-unique tables grouped by layer (each layer's segment
    contiguous, lines ascending within it), bitwise equal to the numpy
    oracle per layer:

      uniq    int32 [M]   PAD_LINE-padded, layer-grouped unique lines
      f_ri    int32 [M,4] per-unique-line RI-bin histogram (the final -1
                          interval excluded, per Table I)
      f_rc    int32 [M]   per-unique-line reuse count
      n_uniq  int32 [n_layers] unique-line count per layer
    """
    m = lines.shape[0]
    dev = lines.device
    pad = int(PAD_LINE)
    valid = torch.arange(m, dtype=torch.int32, device=dev) < n_valid
    lx = torch.where(valid, lines, pad)
    ly = torch.where(valid, layer, n_layers)
    ord1 = torch.sort(lx, stable=True).indices
    order = ord1[torch.sort(ly[ord1], stable=True).indices]
    s_lines = lx[order]
    s_layer = ly[order]
    s_pos = order.to(torch.int32)
    real = s_lines != pad

    nxt = torch.cat([s_pos[1:], s_pos.new_zeros(1)])
    differ = (s_lines[1:] != s_lines[:-1]) | (s_layer[1:] != s_layer[:-1])
    same_next = torch.cat([~differ, differ.new_zeros(1)])
    ri_sorted = torch.where(same_next, nxt - s_pos, -1).to(torch.int32)
    bins, _ = _hist_ops.histogram(ri_sorted)

    seg_start = torch.cat([differ.new_ones(1), differ])
    sid = torch.cumsum(seg_start.to(torch.int64), 0) - 1

    counted = (real & (ri_sorted >= 0)).to(torch.int32)
    f_ri = torch.zeros((m, NUM_RI_BINS), dtype=torch.int32, device=dev)
    f_ri.index_put_((sid, torch.clamp(bins, min=0).to(torch.int64)),
                    counted, accumulate=True)
    f_rc = torch.zeros(m, dtype=torch.int32, device=dev).index_add_(
        0, sid, real.to(torch.int32))
    # every write to one segment carries the same value, so order is moot
    uniq = torch.full((m,), pad, dtype=torch.int32, device=dev).scatter_(
        0, sid, torch.where(real, s_lines, pad))
    n_uniq = torch.zeros(n_layers + 1, dtype=torch.int32,
                         device=dev).index_add_(
        0, s_layer.to(torch.int64),
        (seg_start & real).to(torch.int32))[:n_layers]
    return {"uniq": uniq, "f_ri": f_ri, "f_rc": f_rc, "n_uniq": n_uniq}
