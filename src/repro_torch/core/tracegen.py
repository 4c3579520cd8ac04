"""Systolic-array off-chip trace generator (SCALE-Sim-like).

Generates the DRAM-side (≡ shared-LLC-visible) memory access trace for a
layer sequence executed on a double-buffered systolic accelerator
(Table II/IV of the paper).  The generator reproduces the properties the
paper's analysis depends on:

* **SRAM filtering** — accesses that hit in the on-chip ifmap/filter/ofmap
  SRAMs are *not* emitted; only tile (re)loads reach the LLC.  Small SRAMs
  therefore produce repeated reloads of the same cache lines (high LLC reuse,
  Config-3/4); SRAMs that hold whole tensors produce single-pass streaming
  (low LLC reuse, Config-1/2).
* **Dataflow-dependent ordering** — OS keeps the output tile stationary and
  re-streams ifmap/filter tiles; WS keeps the filter tile stationary and
  re-streams ifmap + partial-sum read/write traffic; IS keeps the ifmap tile
  stationary.
* **Cycle stamps** — double-buffered: tile t+1 loads overlap tile t compute;
  demand rate is compute-bound per tile chain.

All layers are lowered to GEMM (im2col) form: A[M,K] x B[K,N] -> C[M,N],
fp32, 64-byte cache lines (16 elements / line).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .workloads import AccelConfig, GemmLayer, PhaseDrift

LINE_BYTES = 64
ELEM_BYTES = 4
ELEMS_PER_LINE = LINE_BYTES // ELEM_BYTES


@dataclasses.dataclass
class Trace:
    """Off-chip access trace of one input set (one frame/word/token)."""
    line: np.ndarray    # int64 [M] cache-line addresses
    write: np.ndarray   # bool  [M]
    cycle: np.ndarray   # int64 [M] issue cycle (accelerator clock)
    layer: np.ndarray   # int32 [M] layer index (for per-layer L-RPT load)
    layer_names: List[str]
    compute_cycles: int  # total compute-bound cycles for one input

    @property
    def num_accesses(self) -> int:
        return int(self.line.shape[0])


def _lines_for(base_elem: int, n_elems: int) -> np.ndarray:
    """Cache lines covering elements [base_elem, base_elem + n_elems)."""
    lo = base_elem // ELEMS_PER_LINE
    hi = (base_elem + n_elems + ELEMS_PER_LINE - 1) // ELEMS_PER_LINE
    return np.arange(lo, hi, dtype=np.int64)


def _tile_sizes(g: GemmLayer, cfg: AccelConfig) -> tuple:
    """Pick (Tm, Tk, Tn) so double-buffered tiles fit the three SRAMs."""
    half = 1024 // 2  # double buffered: half the SRAM per tile, in bytes/KB
    ifmap_b = cfg.sram_ifmap_kb * half
    filt_b = cfg.sram_filter_kb * half
    ofmap_b = cfg.sram_ofmap_kb * half
    tm = min(g.m, max(cfg.pe_rows, 1))
    tn = min(g.n, max(cfg.pe_cols, 1))
    # ofmap tile must fit: tm*tn*4 <= ofmap_b
    while tm * tn * ELEM_BYTES > ofmap_b and tm > 1:
        tm = max(1, tm // 2)
    tk = min(g.k,
             max(1, ifmap_b // (ELEM_BYTES * tm)),
             max(1, filt_b // (ELEM_BYTES * tn)))
    return tm, tk, tn


def _emit_tile(out, region_base, row0, col0, rows, cols, row_stride,
               write, layer_idx):
    """Emit line accesses for a [rows x cols] sub-block of a row-major
    matrix whose row stride is ``row_stride`` elements."""
    lines_list = []
    for r in range(row0, row0 + rows):
        start = region_base + r * row_stride + col0
        lines_list.append(_lines_for(start, cols))
    lines = np.unique(np.concatenate(lines_list))
    out["line"].append(lines)
    out["write"].append(np.full(lines.shape, write, dtype=bool))
    out["layer"].append(np.full(lines.shape, layer_idx, dtype=np.int32))
    return lines.shape[0]


def _drift_schedule(n_layers: int, drift: PhaseDrift) -> List[tuple]:
    """[(layer_idx, tile_scale), ...] for ``drift.period`` replicas.

    Replica 0 is the exact base schedule (order preserved, scale 1.0);
    every later replica accumulates ``reorder * n_layers`` adjacent swaps
    on top of the previous replica's order and draws a fresh tile-K
    jitter per layer — the drift compounds across "inputs"."""
    rng = np.random.default_rng(drift.seed)
    order = list(range(n_layers))
    sched: List[tuple] = []
    for r in range(max(1, int(drift.period))):
        if r > 0:
            for _ in range(int(round(drift.reorder * n_layers))):
                i = int(rng.integers(0, max(n_layers - 1, 1)))
                order[i], order[i + 1] = order[i + 1], order[i]
        for li in order:
            scale = (1.0 + drift.tile_jitter * float(rng.uniform(-1.0, 1.0))
                     if r > 0 and drift.tile_jitter > 0 else 1.0)
            sched.append((li, scale))
    return sched


def generate_trace(cfg: AccelConfig, clock_ratio: float = 1.0,
                   drift: PhaseDrift = None) -> Trace:
    """Generate the LLC-visible trace for one input set on ``cfg``.

    clock_ratio: accelerator-to-system clock ratio for cycle stamps.
    drift: phase-drift mode (defaults to ``cfg.drift``) — the trace covers
    ``drift.period`` replicas of the workload whose layer order and tiling
    drift replica-to-replica; layer ids stay base-schedule indices so
    per-layer L-RPT tables keep their meaning.
    """
    drift = drift if drift is not None else cfg.drift
    layers = [l.as_gemm() for l in cfg.layers()]
    out: Dict[str, list] = {"line": [], "write": [], "layer": []}
    tile_meta: List[tuple] = []  # (n_lines_in_tile, compute_cycles_of_tile)

    # Address map: chain ofmap(l) base to ifmap(l+1) base for cross-layer
    # reuse at the LLC (the paper's accelerator reads back its own outputs).
    elem_cursor = 0
    a_bases, b_bases, c_bases = [], [], []
    for li, g in enumerate(layers):
        if li == 0:
            a_bases.append(elem_cursor)
            elem_cursor += g.m * g.k
        else:
            a_bases.append(c_bases[li - 1])  # alias previous ofmap
        b_bases.append(elem_cursor)
        elem_cursor += g.k * g.n
        c_bases.append(elem_cursor)
        elem_cursor += g.m * g.n

    pe = cfg.pe_rows * cfg.pe_cols
    schedule = (_drift_schedule(len(layers), drift) if drift is not None
                else [(li, 1.0) for li in range(len(layers))])
    for li, tile_scale in schedule:
        g = layers[li]
        tm, tk, tn = _tile_sizes(g, cfg)
        if tile_scale != 1.0:
            tk = max(1, min(g.k, int(round(tk * tile_scale))))
        n_m = -(-g.m // tm)
        n_k = -(-g.k // tk)
        n_n = -(-g.n // tn)
        # systolic compute cycles per full tile (fill+drain amortized)
        tile_cycles = max(1, int((tm * tn * tk) / pe) + tm + tn)

        def a_tile(mi, ki, last_m=tm, last_k=tk):
            rows = min(tm, g.m - mi * tm)
            cols = min(tk, g.k - ki * tk)
            return _emit_tile(out, a_bases[li], mi * tm, ki * tk, rows, cols,
                              g.k, False, li)

        def b_tile(ki, ni):
            rows = min(tk, g.k - ki * tk)
            cols = min(tn, g.n - ni * tn)
            return _emit_tile(out, b_bases[li], ki * tk, ni * tn, rows, cols,
                              g.n, False, li)

        def c_tile(mi, ni, write):
            rows = min(tm, g.m - mi * tm)
            cols = min(tn, g.n - ni * tn)
            return _emit_tile(out, c_bases[li], mi * tm, ni * tn, rows, cols,
                              g.n, write, li)

        if cfg.dataflow == "OS":
            # output tile stationary: stream A,B tiles over k, write C once.
            for mi in range(n_m):
                for ni in range(n_n):
                    n_lines = 0
                    for ki in range(n_k):
                        n_lines += a_tile(mi, ki)
                        n_lines += b_tile(ki, ni)
                    n_lines += c_tile(mi, ni, write=True)
                    tile_meta.append((n_lines, tile_cycles * n_k))
        elif cfg.dataflow == "WS":
            # filter tile stationary: for each (k,n) stream A over m with
            # partial-sum read+write traffic on C when k is split.
            for ki in range(n_k):
                for ni in range(n_n):
                    for mi in range(n_m):
                        n_lines = b_tile(ki, ni) if mi == 0 else 0
                        n_lines += a_tile(mi, ki)
                        if ki > 0:
                            n_lines += c_tile(mi, ni, write=False)  # psum read
                        n_lines += c_tile(mi, ni, write=True)
                        tile_meta.append((n_lines, tile_cycles))
        elif cfg.dataflow == "IS":
            # ifmap tile stationary: for each (m,k) stream B over n.
            for mi in range(n_m):
                for ki in range(n_k):
                    for ni in range(n_n):
                        n_lines = a_tile(mi, ki) if ni == 0 else 0
                        n_lines += b_tile(ki, ni)
                        if ki > 0:
                            n_lines += c_tile(mi, ni, write=False)
                        n_lines += c_tile(mi, ni, write=True)
                        tile_meta.append((n_lines, tile_cycles))
        else:
            raise ValueError(f"unknown dataflow {cfg.dataflow}")

    line = np.concatenate(out["line"])
    write = np.concatenate(out["write"])
    layer = np.concatenate(out["layer"])

    # Cycle stamps: double-buffered — accesses of tile t are spread across
    # the compute window of tile t-1 (prefetch), bounded below by 1/line.
    cycles = np.empty(line.shape[0], dtype=np.int64)
    t = 0
    pos = 0
    for n_lines, c_cycles in tile_meta:
        if n_lines > 0:
            span = max(c_cycles, n_lines)  # cannot issue >1 line/cycle
            cycles[pos:pos + n_lines] = t + np.linspace(
                0, span - 1, n_lines, dtype=np.int64)
        t += max(c_cycles, n_lines)
        pos += n_lines
    assert pos == line.shape[0]
    cycles = (cycles * clock_ratio).astype(np.int64)
    total = int(t * clock_ratio)

    return Trace(line=line, write=write, cycle=cycles, layer=layer,
                 layer_names=[g.name for g in layers],
                 compute_cycles=total)


def trace_stats(tr: Trace) -> Dict[str, float]:
    uniq = np.unique(tr.line)
    return {
        "accesses": float(tr.num_accesses),
        "unique_lines": float(uniq.shape[0]),
        "reuse_factor": float(tr.num_accesses) / max(1, uniq.shape[0]),
        "write_frac": float(tr.write.mean()),
        "compute_cycles": float(tr.compute_cycles),
        "lines_per_cycle": float(tr.num_accesses) / max(1, tr.compute_cycles),
    }
