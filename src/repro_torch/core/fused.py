"""Device-resident fused epoch loop: a lane batch's epochs advance on the
card, K epochs a super-step, with one read by the host per super-step.

The host engine (``sim.Lane`` + ``sweep._drive_lanes``) builds each
epoch's events in numpy, sorts them into rounds and reads the stats back,
once an epoch and lane batch.  This engine stages the group's trace,
streams and per-lane tables on the device once and advances a carry that
holds the LLC state *and* the lanes' timing state (hit rates, AMAL,
per-core IPC, input progress, APM thresholds, the scheduled-DRAM bank
state) through K epochs of torch ops and one ``llc_rounds`` launch an
epoch, with nothing read back until the super-step ends.

Parity contract (tests/test_torch_fused.py), as in the JAX package:

* integer LLC stat counters are bitwise those of ``sim.drive_lane``:
  events interleave by the exact integer keys of ``sim.when_keys``, one
  stable (set, when) sort gives each event its rank in its set, i.e.
  ``llc.build_rounds``'s (round, set) coordinates, and every round is
  ``llc.round_transition`` (in the kernel or its plain loop);
* float timing is the host's numpy float64 op for op: each torch op
  rounds once, in the host's order (numpy's pairwise summation tree for
  the per-core IPC sum included), so the floats agree bitwise in
  practice; the public bar is rtol 1e-6.

Overflow contract: an epoch's round matrix has a capacity
(``max_rounds``).  A lane whose epoch needs more rounds does not commit:
its events are masked out of the round loop and its carry is kept (a
freeze), the flag is sticky for the super-step, and
``drive_lanes_fused`` re-runs the super-step from its start at twice the
capacity, up to the host engine's
largest round bucket; past that it replays the stretch on the host path
(which chunks hot sets) and goes host-sticky after two overflows in a row.
``sweep.simulate_group(engine="fused")`` routes a geometry batch here;
``sim.drive_lane`` stays the oracle.

Whole sweeps (``drive_lanes_bucketed``, behind ``sweep.run_bucketed``):
lane groups with equal ``bucket_key`` run as ONE flat lane batch of G*L
lanes -- the group-constant consts broadcast to the lanes, the trace and
stream arrays read by (group, element) gathers -- so an epoch is one
``llc_rounds`` launch for the whole bucket.  There an overflowing lane
freezes on its committed carry (the freeze above), the shared capacity
escalates, and past the cap only the offending group leaves through
``drive_lanes_fused``.  Results equal the per-group engines bitwise
(tests/test_torch_bucketed.py).  With ``devices > 1`` a bucket's groups
split into shards, one a card, as the JAX package's ``shard_map`` of the
group axis: each shard is a flat lane batch of its own, and the shards
share nothing but the round capacity (tests/test_torch_shards.py).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.common import on_card
from ..kernels.llc_rounds import ops as rounds_ops
from . import dram as dram_mod
from . import dramsched
from . import llc as llc_mod
from .sim import PF_WHEN_OFF, WHEN_BITS, Lane

# Super-step length: epochs advanced per host read.
DEFAULT_SUPERSTEP = int(os.environ.get("REPRO_FUSED_K", "32"))
# Per-set round capacity of an epoch's round matrix; drive_lanes_fused
# doubles it on overflow up to the host's largest ROUND_BUCKET, then falls
# back to the host path, which chunks arbitrarily hot sets.
DEFAULT_MAX_ROUNDS = int(os.environ.get("REPRO_FUSED_ROUNDS", "128"))
MAX_ROUNDS_CAP = llc_mod.ROUND_BUCKETS[-1]
# Occupied-column count at or below which the plain (CPU) round loop runs a
# round on those columns only (``llc.round_step``); the kernel skips the
# padding of every round on its own.  Results are the same either way.
SPARSE_CAP = int(os.environ.get("REPRO_FUSED_SPARSE_CAP", "256"))

_HUGE_KEY = 1 << 62

# The bucketed engine's pipeline: super-step N+1 is enqueued before N's
# write-back, which reads N's outputs from pinned buffers behind an event
# (off = one super-step at a time, the reference path the tests pin).
PIPELINE_DEFAULT = os.environ.get("REPRO_BUCKET_PIPELINE", "1") != "0"

# Counts since the last reset: drive_lanes_fused's super-steps committed on
# the device, capacity escalations, host stretches and their epochs; the
# bucketed engine's super-steps (one a bucket, whatever its shards),
# escalations, demoted groups and shards (summed over its calls).
_COUNTS = {"supersteps": 0, "escalations": 0, "host_stretches": 0,
           "host_epochs": 0, "bucket_supersteps": 0,
           "bucket_escalations": 0, "bucket_demotions": 0,
           "bucket_shards": 0}

# Seconds of the bucketed engine, accumulated across calls: stage_s
# (staging and the carry, host clock), dispatch_s (enqueueing super-steps,
# host clock; on the CPU the work itself), device_s (CUDA events from a
# super-step's first op to the end of its copy to the host, summed over a
# bucket's shards; 0 on the CPU)
# and writeback_s (histories and carry into the Lanes, host clock).
_PHASES = {"stage_s": 0.0, "dispatch_s": 0.0, "device_s": 0.0,
           "writeback_s": 0.0}


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def counts() -> dict:
    return dict(_COUNTS)


def reset_phase_times() -> None:
    for k in _PHASES:
        _PHASES[k] = 0.0


def phase_times() -> dict:
    return dict(_PHASES)


@dataclasses.dataclass(frozen=True)
class FusedDims:
    """Static shape info of one lane batch."""
    cfg: llc_mod.LLCConfig          # shared geometry (knobs ride as data)
    n_lanes: int
    n_cores: int
    accel_cap: int                  # accel segment slots (accel_epoch_cap)
    core_caps: Tuple[int, ...]      # per-core slots (epoch demand at ipc0)
    has_dpcp: bool                  # prefetch segment allocated at all
    n_inputs: int
    k_epochs: int
    max_rounds: int
    sparse_cap: int                 # 0 = plain rounds always full width
    record_occ: bool                # emit per-epoch occupancy counters
    sched: Optional[dramsched.SchedDims] = None   # None = fluid DRAM


class SharedConsts(NamedTuple):
    """Device constants shared by every lane of the batch: arrays, float64
    0-d tensors (so that an int64 operand promotes to float64, never to
    torch's float32 default) and plain ints.  In a bucket's flat batch
    (``gid`` set) every scalar is a per-lane tensor and the arrays carry a
    leading group axis."""
    line: torch.Tensor       # i32 [M] accel trace lines
    write: torch.Tensor      # bool [M]
    layer: torch.Tensor      # i32 [M]
    streams: torch.Tensor    # i32 [C, WMAX] core address streams
    nominal: torch.Tensor    # f64 [C] apkc/1000*et (epoch demand at ipc0)
    apkc1k: torch.Tensor     # f64 [C] apkc/1000
    ipc0: torch.Tensor       # f64 [C]
    inv_ipc0: torch.Tensor   # f64 [C] 1/ipc0
    et: torch.Tensor         # f64 [] epoch_cycles
    m_total: int
    max_epochs: int
    deadline: torch.Tensor   # f64 []
    period: torch.Tensor     # f64 []
    ma_global: torch.Tensor  # f64 []
    llc_capacity: torch.Tensor     # f64 []
    llc_capacity_int: int          # int(llc_capacity)
    s_llc: torch.Tensor      # f64 []
    w_cap_s: torch.Tensor    # f64 [] w_cap * s_llc
    w_cap_s_prio: torch.Tensor     # f64 [] w_cap * s_llc * prio_cap
    prio_cap: torch.Tensor   # f64 []
    hit_lat: torch.Tensor    # f64 [] llc_hit_lat
    dram_lat: torch.Tensor   # f64 []
    dram_rate: torch.Tensor  # f64 []
    dram_cap: torch.Tensor   # f64 [] rate * et
    dram_cap01: torch.Tensor  # f64 [] 0.1 * dram_cap
    dram_denom: torch.Tensor  # f64 [] max(rate * et, 1e-9)
    w_cap_dram: torch.Tensor        # f64 [] w_cap * dram_lat
    w_cap_dram_prio: torch.Tensor   # f64 [] (w_cap * dram_lat) * prio_cap
    w_dram25: torch.Tensor   # f64 [] 25 * dram_lat
    mlp_et: torch.Tensor     # f64 [] mlp_accel * et
    sd_timing: Tuple[Tuple[int, ...], ...]  # dramsched.timing_tuple
    #                          of each scheduled model (() = fluid DRAM)
    et_i: torch.Tensor       # i64 [L] epoch_cycles as an integer
    # a bucket's flat lane batch (``_bucket_consts``): the scalars above
    # are [L] tensors, line/write/layer/streams [G, ...]
    sd_lane: Optional[torch.Tensor] = None  # i64 [L] index into sd_timing
    gid: Optional[torch.Tensor] = None      # i64 [L] each lane's group


class LaneConsts(NamedTuple):
    """Per-lane policy data (leading lane axis)."""
    arp: torch.Tensor          # bool [L]
    flash: torch.Tensor        # bool [L]
    hydra: torch.Tensor        # bool [L]
    dpcp: torch.Tensor         # bool [L]
    accel_hint: torch.Tensor   # bool [L] LERN hints active
    accel_rand: torch.Tensor   # bool [L] AFRp hints active
    switch_point: torch.Tensor  # i64 [L] §III-C1 deadline switch (-1 = off)
    knobs: object              # llc.LaneKnobs (CPU) / packed int32 [L, 5]
    rc: torch.Tensor           # i8 [L, M] RC cluster per access
    ri: torch.Tensor           # i8 [L, M]
    cold: torch.Tensor         # f64 [L, NL] per-layer cold-cluster center
    afr: torch.Tensor          # bool [L, M] pre-drawn AFRp decisions
    writes: torch.Tensor       # bool [L, C, WMAX] pre-drawn core writes
    margin_high: torch.Tensor  # f64 [L]
    margin_low: torch.Tensor   # f64 [L]
    mr_th: torch.Tensor        # f64 [L]
    behind_th: torch.Tensor    # f64 [L] (1+alpha)*ma_global
    bands: torch.Tensor        # f64 [L, 7] [(1+b)mag, (1-b)mag .. (1-6b)mag]
    t_a: torch.Tensor          # f64 [L, 4] base T_A1..T_A4
    t_b: torch.Tensor          # f64 [L]
    delta_a: torch.Tensor      # f64 [L]
    delta_b: torch.Tensor      # f64 [L]


class FusedCarry(NamedTuple):
    """Per-lane dynamic state carried across epochs."""
    st: llc_mod.LLCState      # batched [L, ...]
    active: torch.Tensor      # bool [L]
    hr_core: torch.Tensor     # f64 [L]
    hr_accel: torch.Tensor    # f64 [L]
    amal: torch.Tensor        # f64 [L]
    ipc: torch.Tensor         # f64 [L, C]
    stream_pos: torch.Tensor  # i64 [L, C]
    pos: torch.Tensor         # i64 [L]
    input_idx: torch.Tensor   # i64 [L]
    input_start: torch.Tensor  # f64 [L]
    now: torch.Tensor         # f64 [L]
    ri_th: torch.Tensor       # i64 [L]
    rc_th: torch.Tensor       # i64 [L]
    special: torch.Tensor     # bool [L]
    cm_prev: torch.Tensor     # f64 [L]
    pf_prev: torch.Tensor     # f64 [L]
    epoch: torch.Tensor       # i64 [L]
    completions: torch.Tensor  # f64 [L, n_inputs]
    totals: torch.Tensor      # i64 [L, 7] ch cm cb ah am ab n_acc
    total_llc: torch.Tensor   # f64 [L]
    total_dram: torch.Tensor  # f64 [L]
    overflow: torch.Tensor    # bool [L] sticky round-capacity flag
    bank_row: torch.Tensor    # i64 [L, NB] open row per bank (sched)
    bank_queue: torch.Tensor  # i64 [L, NB] backlog cycles per bank
    bank_rr: torch.Tensor     # i64 [L] core-miss round-robin rotor


class StepOut(NamedTuple):
    """Per-epoch per-lane outputs (history write-back), stacked [K, L]."""
    active: torch.Tensor      # bool -- this step ran AND committed
    pos_before: torch.Tensor  # i64  -- accel window start (online-LERN)
    n_a: torch.Tensor         # i64  -- hist accel_rate
    req: torch.Tensor         # f64  -- hist requirement
    ri_th: torch.Tensor       # i64
    rc_th: torch.Tensor       # i64
    core_ipc: torch.Tensor    # f64
    amal: torch.Tensor        # f64
    occ: torch.Tensor         # i64 [.., 2] core/accel occupancy
    alive: torch.Tensor       # bool -- lane still active after this step
    ovf: torch.Tensor         # bool -- sticky round-capacity flag after it


def _np_sum_order(terms: List[torch.Tensor]) -> torch.Tensor:
    """Sum ``terms`` in numpy's pairwise-summation order for n <= 128 --
    the host computes ``np.sum(ipc * shed)`` over the cores, and this
    engine must reproduce the float64 result bitwise."""
    n = len(terms)
    if n < 8:
        s = torch.zeros_like(terms[0])
        for t in terms:
            s = s + t
        return s
    r = list(terms[:8])
    i = 8
    while i + 8 <= n:
        for j in range(8):
            r[j] = r[j] + terms[i + j]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    while i < n:
        res = res + terms[i]
        i += 1
    return res


# The JAX engine pins each division and product against XLA's rewrites
# (chained divisions) and LLVM's multiply-add contraction with a runtime
# zero.  Eager torch runs every op as one kernel that rounds once, so the
# two markers below are the plain ops; they keep the code op for op
# beside the reference's.
def _div(a, b):
    return a / b


def _mulb(a, b):
    return a * b


def _mg1(rho, s_llc):
    rho = torch.clamp(rho, max=0.98)
    return _div(rho * s_llc, torch.clamp(2.0 * (1.0 - rho), min=1e-2))


def _queue_delay(sh: SharedConsts, traffic):
    rho = torch.clamp(_div(traffic, sh.dram_denom), max=dram_mod.QUEUE_RHO_CAP)
    w = _div(_div(rho, torch.clamp(2.0 * (1.0 - rho),
                                   min=dram_mod.QUEUE_STAB_FLOOR)),
             sh.dram_rate)
    return torch.minimum(w, sh.w_dram25)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


# ---------------------------------------------------------------------------
# device round building (the on-device build_rounds)
# ---------------------------------------------------------------------------
def _pack_meta(is_accel, write, hint, prefetch, dlok, src: int):
    """torch twin of ``llc.pack_meta`` (``src`` a segment's core id)."""
    return (llc_mod.M_VALID
            | torch.where(is_accel, llc_mod.M_ACCEL, 0)
            | torch.where(write, llc_mod.M_WRITE, 0)
            | torch.where(hint, llc_mod.M_HINT, 0)
            | torch.where(prefetch, llc_mod.M_PREFETCH, 0)
            | torch.where(dlok, llc_mod.M_DLOK, 0)
            | (src << llc_mod.M_SRC_SHIFT)).to(torch.int32)


def _rows(sh: SharedConsts, a: torch.Tensor,
          idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` of a staged array, ``idx`` [L, ...] clipped into range (a
    clipped slot is always behind a validity mask).  In a bucket ``a`` has
    a leading group axis and each lane reads its own group's row: the same
    elements the group's own batch reads."""
    idx = idx.clamp(0, a.shape[-1] - 1)
    if sh.gid is None:
        return a[idx]
    return a[sh.gid.view((-1,) + (1,) * (idx.dim() - 1)), idx]


def _build_rounds_device(dims: FusedDims, sh: SharedConsts, lc: LaneConsts,
                         n_a, n_c, pos, stream_pos, ri_th, rc_th, special):
    """Build one epoch's [L, R, S] round matrices on the device.

    Reproduces the host pipeline's per-set event order exactly: a static
    segment layout (accel, optional DPCP prefetch, core 0..C-1) with
    validity masks, the shared integer interleave keys (``sim.when_keys``),
    and ONE stable sort of the composite key (set << 42 | when): set-major,
    the host's when-order inside a set, ties in segment order by
    stability.  That gives each event its rank in its set, i.e.
    ``llc.build_rounds``'s (round, set) coordinates.  The §III-C1
    deadline-switch bit is closed-form (only demand accel accesses count,
    and they are when-ordered within their segment); core and prefetch
    events carry dlok=0, which the transition never reads for them.
    Events past the ``max_rounds`` capacity are dropped and flagged.

    The JAX engine also relabels the columns by depth (``perm``) so that
    every round runs on a prefix slice; the kernel skips each round's
    padding per thread and the plain loop gathers a round's occupied
    columns (``SPARSE_CAP``), so the matrices stay in set order here.

    Returns (line_m, meta_m [L, R, S] int32, n_rounds [L] int32, ovf [L]).
    """
    dev = pos.device
    n_lanes = pos.shape[0]
    num_sets, cap_r = dims.cfg.num_sets, dims.max_rounds
    lane = torch.arange(n_lanes, device=dev)[:, None]
    ia = torch.arange(dims.accel_cap, dtype=torch.int64, device=dev)[None]
    when_a = (ia << WHEN_BITS) // n_a.clamp(min=1)[:, None]
    idx_a = (pos[:, None] + ia).clamp(0, sh.line.shape[-1] - 1)
    valid_a = ia < n_a[:, None]
    line_a = _rows(sh, sh.line, idx_a)
    write_a = _rows(sh, sh.write, idx_a)
    layer_now = _rows(sh, sh.layer, pos)
    # per-event bypass hint: LERN clusters x epoch thresholds, or AFRp
    cold_now = lc.cold[lane[:, 0], layer_now.long()]
    rc_a = lc.rc[lane, idx_a]
    ri_a = lc.ri[lane, idx_a]
    hint_lern = (ri_a > ri_th[:, None]) | (rc_a < rc_th[:, None])
    hint_lern = hint_lern | ((special & (cold_now <= 2.0))[:, None]
                             & (rc_a == 0))
    hint_a = torch.where(lc.accel_hint[:, None], hint_lern,
                         lc.accel_rand[:, None] & lc.afr[lane, idx_a])
    # the i-th demand accel access is the (i+1)-th counted by the host's
    # running cumsum, so its deadline-switch bit is i >= switch
    dlok_a = ia >= lc.switch_point[:, None]

    false_a = torch.zeros_like(valid_a)
    true_a = torch.ones_like(valid_a)
    whens, lines, metas, valids = [when_a], [line_a], [
        _pack_meta(true_a, write_a, hint_a, false_a, dlok_a, 0)], [valid_a]
    if dims.has_dpcp:
        whens.append(when_a + PF_WHEN_OFF)
        lines.append(line_a + 1)
        metas.append(_pack_meta(true_a, false_a, false_a, true_a, false_a, 0))
        valids.append(valid_a & lc.dpcp[:, None])
    wmax = sh.streams.shape[-1]
    for k, cap in enumerate(dims.core_caps):
        jk = torch.arange(cap, dtype=torch.int64, device=dev)[None]
        nk = n_c[:, k:k + 1]
        whens.append((jk << WHEN_BITS) // nk.clamp(min=1))
        idx_k = (stream_pos[:, k:k + 1] + jk).clamp(0, wmax - 1)
        lines.append(_rows(sh, sh.streams[..., k, :], idx_k))
        fk = torch.zeros_like(jk, dtype=torch.bool).expand(n_lanes, cap)
        metas.append(_pack_meta(fk, lc.writes[lane, k, idx_k], fk, fk, fk, k))
        valids.append(jk < nk)

    when = torch.cat(whens, 1)
    line = torch.cat(lines, 1)
    meta = torch.cat(metas, 1)
    valid = torch.cat(valids, 1)
    n_ev = when.shape[1]

    set_of = (line & (num_sets - 1)).to(torch.int64)
    key = torch.where(valid, (set_of << (WHEN_BITS + 1)) | when, _HUGE_KEY)
    key_s, order = torch.sort(key, dim=1, stable=True)
    seq = torch.arange(n_ev, dtype=torch.int64, device=dev)[None]
    valid_g = valid.gather(1, order)
    set_g = torch.where(valid_g, key_s >> (WHEN_BITS + 1), num_sets)
    first = torch.ones_like(valid_g)
    first[:, 1:] = set_g[:, 1:] != set_g[:, :-1]
    grp_start = torch.cummax(torch.where(first, seq, 0), dim=1).values
    rank_g = seq - grp_start
    ovf = (valid_g & (rank_g >= cap_r)).any(1)
    n_rounds = torch.clamp(
        torch.where(valid_g, rank_g, -1).amax(1) + 1, max=cap_r).to(
            torch.int32)
    keep = valid_g & (rank_g < cap_r)
    size = n_lanes * cap_r * num_sets
    flat = torch.where(keep, (lane * cap_r + rank_g) * num_sets + set_g, size)
    line_m = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    line_m.scatter_(0, flat.reshape(-1), line.gather(1, order).reshape(-1))
    meta_m = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    meta_m.scatter_(0, flat.reshape(-1), meta.gather(1, order).reshape(-1))
    shape = (n_lanes, cap_r, num_sets)
    return (line_m[:size].view(shape), meta_m[:size].view(shape), n_rounds,
            ovf)


# ---------------------------------------------------------------------------
# one fused epoch: begin half -> one round loop -> finish half
# ---------------------------------------------------------------------------
class _Begin(NamedTuple):
    """Per-lane outputs of the admission/threshold/event-build half."""
    step_active: torch.Tensor
    arrived: torch.Tensor
    accel_prio: torch.Tensor
    n_a: torch.Tensor
    n_c: torch.Tensor
    shed: torch.Tensor
    ri_th: torch.Tensor
    rc_th: torch.Tensor
    special: torch.Tensor
    req_out: torch.Tensor
    line_m: torch.Tensor      # [L, R, S] int32
    meta_m: torch.Tensor      # [L, R, S] int32
    n_rounds: torch.Tensor    # [L] int32 (0 for frozen lanes)
    ovf: torch.Tensor
    samp: Optional[torch.Tensor]   # i64 [L, NS] sched-DRAM window samples


def _begin(dims: FusedDims, sh: SharedConsts, stop_epoch: int,
           lc: LaneConsts, cy: FusedCarry) -> _Begin:
    """``Lane.begin_epoch`` for the lane batch: epoch arbitration,
    admission, APM thresholds and the on-device round build.  Integer
    results match the host's int() truncations exactly; float
    intermediates replicate the host operation order at float64."""
    # an overflowed lane freezes in place until the capacity escalates
    step_active = cy.active & (cy.epoch < stop_epoch) & ~cy.overflow
    i64 = torch.int64

    # ---- arbitration mode (begin_epoch) -------------------------------
    arrived = cy.now >= cy.input_start
    remaining = sh.m_total - cy.pos
    req = sh.ma_global
    done_rate = torch.where(
        arrived,
        _div(_f64(cy.pos),
             torch.clamp(_div(cy.now - cy.input_start, sh.et), min=1.0)),
        req)
    flash_prio = lc.flash & (done_rate < req)
    accel_prio = lc.arp | flash_prio

    # ---- accelerator admission ----------------------------------------
    can_issue = arrived & (remaining > 0)
    miss_rate_a = torch.clamp(1.0 - cy.hr_accel, min=0.05)
    dram_share = torch.where(
        accel_prio, sh.dram_cap,
        torch.maximum(sh.dram_cap - cy.cm_prev - cy.pf_prev, sh.dram_cap01))
    demand_a = torch.minimum(
        torch.minimum(remaining, _div(sh.mlp_et, torch.clamp(cy.amal, min=1.0))
                      .to(i64)),
        torch.clamp(_div(dram_share, miss_rate_a).to(i64),
                    max=dims.accel_cap))
    demand_a = torch.where(can_issue, demand_a, 0)

    # ---- core demand / LLC bandwidth shedding -------------------------
    n_c_dem = _div(sh.nominal * cy.ipc, sh.ipc0).to(i64)      # [L, C]
    core_sum = n_c_dem.sum(1)
    total_demand = demand_a + core_sum
    over_cap = _f64(total_demand) > sh.llc_capacity
    n_a_p = torch.clamp(demand_a, max=sh.llc_capacity_int)
    f_p = _div(sh.llc_capacity - _f64(n_a_p), _f64(core_sum.clamp(min=1)))
    shed_p = torch.clamp(f_p, max=1.0)
    f_f = _div(sh.llc_capacity, _f64(total_demand))
    n_a_f = (_f64(demand_a) * f_f).to(i64)
    n_a = torch.where(over_cap, torch.where(accel_prio, n_a_p, n_a_f),
                      demand_a)
    shed = torch.where(over_cap, torch.where(accel_prio, shed_p, f_f), 1.0)
    n_c = (_f64(n_c_dem) * shed[:, None]).to(i64)

    # ---- HyDRA / APM epoch decision -----------------------------------
    hcond = lc.hydra & can_issue
    rt = torch.maximum((cy.input_start + sh.deadline) - cy.now, sh.et)
    elapsed = torch.clamp(sh.deadline - rt, min=0.0)
    done = _f64(sh.m_total - remaining) * sh.et
    ma_past = torch.where(elapsed >= sh.et, _div(done, elapsed),
                          sh.ma_global)
    mr_i = 1.0 - cy.hr_core
    hc = mr_i > lc.mr_th
    behind = ma_past < lc.behind_th
    marg = torch.where(hc & behind, lc.margin_high,
                       torch.where(hc | behind, lc.margin_low, 0.0))
    eff_rt = torch.maximum(rt - _mulb(marg, sh.deadline), sh.et)
    ma_i = _div(_f64(remaining), eff_rt) * sh.et
    # Algorithm 1 threshold scaling: band index d in {6, 5..1, 0}
    bands = lc.bands
    d = torch.zeros_like(remaining)
    for k in range(1, 6):
        d = d + torch.where((ma_i > bands[:, k + 1]) & (ma_i <= bands[:, k]),
                            k, 0)
    d = torch.where(ma_i <= bands[:, 6], 6, d)
    d_f = _f64(d)
    plus = (d == 0) & (ma_i > bands[:, 0])
    t_a = torch.where(
        (d > 0)[:, None],
        torch.clamp(lc.t_a - _mulb(d_f[:, None], lc.delta_a[:, None]),
                    min=1.0),
        torch.where(plus[:, None], lc.t_a + lc.delta_a[:, None], lc.t_a))
    t_b = torch.where(d > 0, lc.t_b - _mulb(d_f, lc.delta_b), lc.t_b)
    # Fig. 9 reuse-threshold selection
    ma_hat = _div(sh.mlp_et, torch.clamp(cy.amal, min=1.0))
    c4 = ma_hat > t_a[:, 3] * ma_i
    c3 = ma_hat > t_a[:, 2] * ma_i
    c2 = ma_hat > t_a[:, 1] * ma_i
    c1 = ma_hat > t_a[:, 0] * ma_i
    cb = ma_hat > t_b * ma_i
    ri_sel = torch.where(c4, -1, torch.where(c3, 0, torch.where(
        c2, 1, torch.where(c1, 2, 3))))
    rc_sel = torch.where(c4, 4, torch.where(c3, 3, torch.where(
        c2, 2, torch.where(c1, 1, torch.where(cb, 0, -1)))))
    sp_sel = ~c4 & ~c3 & ~c2 & ~c1 & cb
    ri_th = torch.where(hcond, ri_sel, cy.ri_th)
    rc_th = torch.where(hcond, rc_sel, cy.rc_th)
    special = torch.where(hcond, sp_sel, cy.special)
    req_out = torch.where(hcond, ma_i,
                          torch.where(arrived, sh.ma_global, 0.0))

    # ---- build the epoch's round matrices -----------------------------
    line_m, meta_m, n_rounds, ovf = _build_rounds_device(
        dims, sh, lc, n_a, n_c, cy.pos, cy.stream_pos, ri_th, rc_th,
        special)
    # frozen lanes add no rounds; an overflowing lane's events stay out of
    # the round loop (it does not commit), though its count still sets the
    # batch's round count, as in the JAX engine
    n_rounds = torch.where(step_active, n_rounds, 0).to(torch.int32)
    run = (step_active & ~ovf)[:, None, None]
    line_m = torch.where(run, line_m, -1)
    meta_m = torch.where(run, meta_m, 0)

    # ---- scheduled-DRAM window samples --------------------------------
    # the indices of dramsched.sample_window on the host (n_a = 0 gives ns
    # copies of line[pos], which carries zero weight in the model)
    samp = None
    if dims.sched is not None:
        ns = dims.sched.n_samples
        si = torch.arange(ns, dtype=i64, device=n_a.device)[None]
        samp = _rows(sh, sh.line,
                     cy.pos[:, None] + (si * n_a[:, None]) // ns).to(i64)
    return _Begin(step_active=step_active, arrived=arrived,
                  accel_prio=accel_prio, n_a=n_a, n_c=n_c, shed=shed,
                  ri_th=ri_th, rc_th=rc_th, special=special,
                  req_out=req_out, line_m=line_m, meta_m=meta_m,
                  n_rounds=n_rounds, ovf=ovf, samp=samp)


def _finish(dims: FusedDims, sh: SharedConsts, lc: LaneConsts,
            cy: FusedCarry, bg: _Begin, new_st, stats, percore):
    """``Lane.finish_epoch`` for the lane batch: fluid timing update,
    totals, progress bookkeeping -- then a freeze select, so a frozen or
    overflowing step is an identity on the carry."""
    i64 = torch.int64
    accel_prio = bg.accel_prio
    n_a, shed = bg.n_a, bg.shed

    # ---- timing update (finish_epoch) ---------------------------------
    st64 = stats.to(i64)
    ch, cm, cb_ = st64[:, 0], st64[:, 1], st64[:, 2]
    ah, am, ab = st64[:, 3], st64[:, 4], st64[:, 5]
    awb, pf_fills = st64[:, 6], st64[:, 8]
    hr_core = _div(_f64(ch), _f64((ch + cm).clamp(min=1)))
    hr_accel = _div(_f64(ah), _f64((ah + am).clamp(min=1)))
    llc_units = (_f64(ch + cm + ah + am) - _mulb(0.7, _f64(cb_ + ab))
                 - _mulb(0.3, _f64(awb)))
    rho_llc = _div(llc_units, sh.llc_capacity)
    rho_a_llc = _div(_f64(ah + am), sh.llc_capacity)
    dram_traffic = cm + am + pf_fills
    # priority-arbitration branch (LLC-side waits stay fluid under the
    # scheduled backend; only the DRAM waits come from the bank model)
    w_llc_a_p = torch.minimum(_mg1(rho_a_llc, sh.s_llc), sh.w_cap_s)
    prio = torch.minimum(
        _div(1.0, torch.clamp(1.0 - rho_a_llc, min=1e-3)), sh.prio_cap)
    w_llc_c_p = torch.minimum(_mg1(rho_llc, sh.s_llc) * prio,
                              sh.w_cap_s_prio)
    w_fifo = torch.minimum(_mg1(rho_llc, sh.s_llc), sh.w_cap_s)
    w_llc_a = torch.where(accel_prio, w_llc_a_p, w_fifo)
    w_llc_c = torch.where(accel_prio, w_llc_c_p, w_fifo)
    bank_row2, bank_queue2, bank_rr2 = cy.bank_row, cy.bank_queue, cy.bank_rr
    if dims.sched is None:
        w_dram_fifo = torch.minimum(_queue_delay(sh, _f64(dram_traffic)),
                                    sh.w_cap_dram)
        rho_a_dram = torch.clamp(_div(_f64(am), sh.dram_denom), max=1.0)
        w_dram_a_p = torch.minimum(_queue_delay(sh, _f64(am)), sh.w_cap_dram)
        prio_d = torch.minimum(
            _div(1.0, torch.clamp(1.0 - rho_a_dram, min=1e-3)), sh.prio_cap)
        w_dram_c_p = torch.minimum(w_dram_fifo * prio_d, sh.w_cap_dram_prio)
        w_dram_a = torch.where(accel_prio, w_dram_a_p, w_dram_fifo)
        w_dram_c = torch.where(accel_prio, w_dram_c_p, w_dram_fifo)
    else:
        # SQUASH urgency: explicit accel priority, or a hydra lane whose
        # achievable rate falls short of this epoch's requirement (the
        # pre-update amal, the requirement just appended to history)
        ma_hat_d = _div(sh.mlp_et, torch.clamp(cy.amal, min=1.0))
        urgent = accel_prio | (lc.hydra & (ma_hat_d < bg.req_out))
        # a bucket may mix models of one geometry (FR-FCFS and SQUASH):
        # each lane takes the results of its own model's timings
        outs = [dramsched.epoch_compute(
            torch, dims.sched, timing, cy.bank_row, cy.bank_queue,
            cy.bank_rr, bg.samp, am, cm, pf_fills, urgent, cy.epoch,
            sh.et_i) for timing in sh.sd_timing]
        res = outs[0]
        for k, other in enumerate(outs[1:], 1):
            pick = sh.sd_lane == k
            res = tuple(torch.where(pick.view((-1,) + (1,) * (a.dim() - 1)),
                                    b, a) for a, b in zip(res, other))
        (num_a, den_a, num_c, den_c, bank_row2, bank_queue2,
         bank_rr2) = res
        # num/den are exact in f64 (far below 2^53), so the division is
        # bitwise the host's float(num) / float(den)
        w_dram_a = torch.minimum(_div(_f64(num_a), _f64(den_a)),
                                 sh.w_cap_dram)
        w_dram_c = torch.minimum(_div(_f64(num_c), _f64(den_c)),
                                 sh.w_cap_dram_prio)
    miss_lat_c = sh.hit_lat + w_llc_c + sh.dram_lat + w_dram_c
    miss_lat_a = sh.hit_lat + w_llc_a + sh.dram_lat + w_dram_a
    pc = percore[:, :dims.n_cores].to(i64)
    hk = _div(_f64(pc[..., 0]), _f64((pc[..., 0] + pc[..., 1]).clamp(min=1)))
    amat = (_mulb(hk, (sh.hit_lat + w_llc_c)[:, None])
            + _mulb(1 - hk, miss_lat_c[:, None]))
    stall = _div(sh.apkc1k * amat, 4.0)
    ipc = _div(1.0, sh.inv_ipc0 + stall)
    amal = torch.where(
        n_a > 0,
        _mulb(hr_accel, sh.hit_lat + w_llc_a)
        + _mulb(1 - hr_accel, miss_lat_a), cy.amal)

    # total_instr (sum * et accumulated) stays on the host: the write-back
    # adds it up from the per-epoch core_ipc outputs with the host's ops
    ipc_shed = ipc * shed[:, None]
    core_ipc_sum = _np_sum_order([ipc_shed[:, k]
                                  for k in range(dims.n_cores)])
    totals = cy.totals + torch.stack([ch, cm, cb_, ah, am, ab, n_a], 1)
    total_llc = cy.total_llc + llc_units
    total_dram = cy.total_dram + _f64(dram_traffic)

    # ---- progress bookkeeping -----------------------------------------
    now = cy.now + sh.et
    pos2 = cy.pos + n_a
    completed = (n_a > 0) & (pos2 >= sh.m_total)
    slot = torch.arange(dims.n_inputs, device=n_a.device)[None]
    completions = torch.where(
        completed[:, None] & (slot == cy.input_idx[:, None]),
        (now - cy.input_start)[:, None], cy.completions)
    input_idx = cy.input_idx + completed.to(i64)
    pos = torch.where(completed, 0, pos2)
    input_start = torch.where(
        completed, torch.maximum(cy.input_start + sh.period, now),
        cy.input_start)
    epoch = cy.epoch + 1
    active = (epoch < sh.max_epochs) & (input_idx < dims.n_inputs)

    # commit only steps that ran AND fit the round capacity: a frozen or
    # overflowing step is an identity on the carry (its events were kept
    # out of the round loop, so only the LLC tick moved), so the carry is
    # always a valid resume point
    commit = bg.step_active & ~bg.ovf
    new_st = new_st._replace(tick=torch.where(commit, new_st.tick,
                                              cy.st.tick))
    new = FusedCarry(
        st=new_st, active=active, hr_core=hr_core, hr_accel=hr_accel,
        amal=amal, ipc=ipc, stream_pos=cy.stream_pos + bg.n_c, pos=pos,
        input_idx=input_idx, input_start=input_start, now=now,
        ri_th=bg.ri_th, rc_th=bg.rc_th, special=bg.special,
        cm_prev=_f64(cm), pf_prev=_f64(pf_fills), epoch=epoch,
        completions=completions, totals=totals, total_llc=total_llc,
        total_dram=total_dram, overflow=cy.overflow,
        bank_row=bank_row2, bank_queue=bank_queue2, bank_rr=bank_rr2)
    out_cy = FusedCarry(*(
        b if name == "st" else torch.where(
            commit.view((-1,) + (1,) * (a.dim() - 1)), a, b)
        for name, a, b in zip(FusedCarry._fields, new, cy)))
    out_cy = out_cy._replace(st=new_st,
                             overflow=cy.overflow | (bg.step_active & bg.ovf))
    # per-epoch occupancy (llc.occupancy's counts on the epoch-end state)
    if dims.record_occ:
        occ_valid = new_st.tags != -1
        occ_accel = occ_valid & (new_st.owner == 1)
        occ = torch.stack([(occ_valid & ~occ_accel).sum((1, 2)),
                           occ_accel.sum((1, 2))], 1)
    else:
        occ = torch.zeros((n_a.shape[0], 2), dtype=i64, device=n_a.device)
    out = StepOut(active=commit, pos_before=cy.pos, n_a=n_a,
                  req=bg.req_out, ri_th=bg.ri_th, rc_th=bg.rc_th,
                  core_ipc=core_ipc_sum, amal=out_cy.amal, occ=occ,
                  alive=out_cy.active, ovf=out_cy.overflow)
    return out_cy, out


def _epoch_step(dims: FusedDims, sh: SharedConsts, stop_epoch: int,
                lc: LaneConsts, cy: FusedCarry):
    """One epoch of the whole lane batch: begin half, one round loop
    (``llc_rounds``: one launch on the card), finish half."""
    bg = _begin(dims, sh, stop_epoch, lc, cy)
    new_st, stats, percore = rounds_ops.rounds(
        dims.cfg, lc.knobs, cy.st, bg.line_m, bg.meta_m, bg.n_rounds,
        sparse_cap=dims.sparse_cap)
    return _finish(dims, sh, lc, cy, bg, new_st, stats, percore)


def _clone_state(st: llc_mod.LLCState) -> llc_mod.LLCState:
    return llc_mod.LLCState(*(x.clone() for x in st))


def _superstep(dims: FusedDims, sh: SharedConsts, lc: LaneConsts,
               carry: FusedCarry, stop_epoch: int):
    """K epochs of the whole lane batch, enqueued with no read by the host.
    The kernel updates the LLC state in place, so the super-step works on
    a copy: ``carry`` stays the resume point if it is re-run.
    Returns (carry, StepOut stacked [K, L])."""
    cy = carry._replace(st=_clone_state(carry.st))
    outs = []
    for _ in range(dims.k_epochs):
        cy, out = _epoch_step(dims, sh, stop_epoch, lc, cy)
        outs.append(out)
    return cy, StepOut(*(torch.stack(f) for f in zip(*outs)))


# ---------------------------------------------------------------------------
# staging: host Lane objects -> device constants / carry
# ---------------------------------------------------------------------------
def lane_supported(lane: Lane) -> bool:
    """Can this lane run through the fused engine?  The host path stays
    authoritative for the core-traffic-free calibration runs and for any
    workload whose line addresses exceed the int32 staging range."""
    i32max = np.iinfo(np.int32).max
    return (lane.core_traffic
            and lane.n_cores <= llc_mod.NUM_CORES
            and lane.m_total < i32max
            # -1 headroom: DPCP prefetches stage line + 1
            and (lane.m_total == 0
                 or int(lane.tr.line.max()) < i32max - 1)
            and all(s.size == 0 or int(s.max()) < i32max
                    for s in lane.streams))


def _i32(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.int64)
    if a.size and (a.min() < 0 or a.max() >= np.iinfo(np.int32).max):
        raise ValueError("line addresses out of int32 device range")
    return a.astype(np.int32)


class _Staged:
    """What ``drive_lanes_fused`` holds between super-steps: the static dims,
    the shared constants and the per-lane tables, on ``device`` (default:
    the lanes'; a bucket's shard stages on its card).  ``pads``
    (``bucket_pads``) sizes the arrays to a bucket's maxima so that the
    groups' arrays stack; ``stale`` marks tables that an online retrain
    swapped (the staging cache then stages afresh)."""

    def __init__(self, lanes: List[Lane], k_epochs: int, max_rounds: int,
                 pads: Optional[Tuple[int, int, int]] = None,
                 device: Optional[torch.device] = None):
        lane0 = lanes[0]
        dev = self.device = lane0.device if device is None else device
        p, dram, et = lane0.p, lane0.dram, lane0.et
        profiles = lane0.profiles
        n_cores = lane0.n_cores
        from . import cores as cores_mod
        core_caps = tuple(
            max(int(cores_mod.epoch_accesses(pr, pr.ipc0, et)), 0)
            for pr in profiles)
        num_sets = lane0.llc_cfg.num_sets
        sched = dram if isinstance(dram, dram_mod.SchedDramModel) else None
        self.dims = FusedDims(
            cfg=lane0.llc_cfg, n_lanes=len(lanes), n_cores=n_cores,
            accel_cap=int(p.accel_epoch_cap), core_caps=core_caps,
            has_dpcp=any(lane.policy.dpcp for lane in lanes),
            n_inputs=int(p.n_inputs), k_epochs=int(k_epochs),
            max_rounds=int(max_rounds),
            sparse_cap=SPARSE_CAP if num_sets > SPARSE_CAP else 0,
            record_occ=bool(p.record_occupancy),
            sched=(dramsched.sched_dims(sched)
                   if sched is not None else None))

        tr = lane0.tr
        m = tr.num_accesses
        m_pad, wmax, n_layers = pads or bucket_pads([lanes])
        streams = np.zeros((n_cores, wmax), np.int32)
        for k, s in enumerate(lane0.streams):
            streams[k, :s.shape[0]] = _i32(s)
        line = np.zeros(max(m_pad, 1), np.int32)
        line[:m] = _i32(tr.line)
        write = np.zeros(max(m_pad, 1), bool)
        write[:m] = np.asarray(tr.write, bool)
        layer = np.zeros(max(m_pad, 1), np.int32)
        layer[:m] = np.asarray(tr.layer, np.int32)
        dram_denom, w_dram25 = dram_mod.queue_delay_consts(dram, et)

        def f64(v):
            return torch.tensor(v, dtype=torch.float64, device=dev)

        self.sh = SharedConsts(
            line=torch.as_tensor(line, device=dev),
            write=torch.as_tensor(write, device=dev),
            layer=torch.as_tensor(layer, device=dev),
            streams=torch.as_tensor(streams, device=dev),
            nominal=f64([pr.apkc / 1000.0 * et for pr in profiles]),
            apkc1k=f64([pr.apkc / 1000.0 for pr in profiles]),
            ipc0=f64([pr.ipc0 for pr in profiles]),
            inv_ipc0=f64([1.0 / pr.ipc0 for pr in profiles]),
            et=f64(et), m_total=int(lane0.m_total),
            max_epochs=int(p.max_epochs),
            deadline=f64(lane0.deadline), period=f64(lane0.period),
            ma_global=f64(lane0.apm.ma_global),
            llc_capacity=f64(lane0.llc_capacity),
            llc_capacity_int=int(lane0.llc_capacity),
            s_llc=f64(lane0.s_llc), w_cap_s=f64(p.w_cap * lane0.s_llc),
            w_cap_s_prio=f64(p.w_cap * lane0.s_llc * p.prio_cap),
            prio_cap=f64(p.prio_cap), hit_lat=f64(p.llc_hit_lat),
            dram_lat=f64(dram.latency_cycles), dram_rate=f64(dram.rate),
            dram_cap=f64(lane0.dram_cap),
            dram_cap01=f64(0.1 * lane0.dram_cap),
            dram_denom=f64(dram_denom),
            w_cap_dram=f64(p.w_cap * dram.latency_cycles),
            w_cap_dram_prio=f64(p.w_cap * dram.latency_cycles * p.prio_cap),
            w_dram25=f64(w_dram25), mlp_et=f64(p.mlp_accel * et),
            sd_timing=((dramsched.timing_tuple(sched),)
                       if sched is not None else ()),
            et_i=torch.full((len(lanes),), int(p.epoch_cycles),
                            dtype=torch.int64, device=dev))
        self._wmax = wmax
        self._m = m
        self._m_pad = max(m_pad, 1)
        self._n_layers = n_layers
        self.stale = False
        self.lc = self._stage_lanes(lanes)

    def _stage_lanes(self, lanes: List[Lane]) -> LaneConsts:
        dev = self.device
        n_l, m, n_c = len(lanes), self._m, len(lanes[0].profiles)
        m_pad = self._m_pad
        rc = np.zeros((n_l, m_pad), np.int8)
        ri = np.zeros((n_l, m_pad), np.int8)
        cold = np.zeros((n_l, max(self._n_layers, 1)))
        afr = np.zeros((n_l, m_pad), bool)
        writes = np.zeros((n_l, n_c, self._wmax), bool)
        mag = lanes[0].apm.ma_global
        cols = {k: np.zeros(n_l) for k in (
            "margin_high", "margin_low", "mr_th", "behind_th", "t_b",
            "delta_a", "delta_b")}
        bands = np.zeros((n_l, 7))
        t_a = np.zeros((n_l, 4))
        switch = np.full(n_l, -1, np.int64)
        for i, lane in enumerate(lanes):
            if lane.clusters is not None:
                rc[i, :m] = lane.clusters["rc"]
                ri[i, :m] = lane.clusters["ri"]
                cc = lane.clusters["cold_center"]
                cold[i, :len(cc)] = cc
            if lane.afr_hints is not None:
                afr[i, :m] = lane.afr_hints
            for k, w in enumerate(lane.writes):
                writes[i, k, :w.shape[0]] = w
            ap = lane.apm.params
            cols["margin_high"][i] = ap.margin_high
            cols["margin_low"][i] = ap.margin_low
            cols["mr_th"][i] = ap.mr_threshold
            cols["behind_th"][i] = (1.0 + ap.alpha) * mag
            cols["t_b"][i] = ap.t_b
            cols["delta_a"][i] = ap.delta_a
            cols["delta_b"][i] = ap.delta_b
            bands[i, 0] = (1.0 + ap.beta) * mag
            for k in range(1, 7):
                bands[i, k] = (1.0 - k * ap.beta) * mag
            t_a[i] = (ap.t_a1, ap.t_a2, ap.t_a3, ap.t_a4)
            pol = lane.policy
            if pol.deadline_aware and not pol.hydra:
                switch[i] = int(pol.asth_t * mag)
        pols = [lane.policy for lane in lanes]
        knobs = llc_mod.lane_knobs([lane.llc_cfg for lane in lanes], dev)
        if dev.type == "cuda":
            knobs = rounds_ops.pack_knobs(knobs)

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        return LaneConsts(
            arp=t([p.arbitration == "arp" for p in pols]),
            flash=t([p.arbitration == "flash" for p in pols]),
            hydra=t([p.hydra for p in pols]),
            dpcp=t([p.dpcp for p in pols]),
            accel_hint=t([p.accel_mode == llc_mod.A_HINT
                          and lane.clusters is not None
                          for p, lane in zip(pols, lanes)]),
            accel_rand=t([p.accel_mode == llc_mod.A_RAND for p in pols]),
            switch_point=t(switch), knobs=knobs, rc=t(rc), ri=t(ri),
            cold=t(cold), afr=t(afr), writes=t(writes),
            margin_high=t(cols["margin_high"]),
            margin_low=t(cols["margin_low"]), mr_th=t(cols["mr_th"]),
            behind_th=t(cols["behind_th"]), bands=t(bands), t_a=t(t_a),
            t_b=t(cols["t_b"]), delta_a=t(cols["delta_a"]),
            delta_b=t(cols["delta_b"]))

    def refresh_clusters(self, lanes: List[Lane]) -> None:
        """Re-upload per-lane cluster tables (after an online retrain)."""
        self.lc = self._stage_lanes(lanes)
        self.stale = True


def bucket_pads(groups: List[List[Lane]]) -> Tuple[int, int, int]:
    """Common staging pads (trace length, stream length, layer count) of a
    bucket: every group's arrays are sized to the bucket's maxima so that
    they stack along a leading group axis."""
    return (max(g[0].tr.num_accesses for g in groups),
            max(max([s.shape[0] for s in g[0].streams] or [1])
                for g in groups),
            max(len(g[0].tr.layer_names) for g in groups))


def stage_group(lanes: List[Lane], k_epochs: int = DEFAULT_SUPERSTEP,
                max_rounds: int = DEFAULT_MAX_ROUNDS,
                pads: Optional[Tuple[int, int, int]] = None,
                device: Optional[torch.device] = None) -> _Staged:
    """One group's staged device constants (what the sweep's staging cache
    holds) on ``device`` (default: the lanes'); the time lands in the
    ``stage_s`` phase."""
    t0 = time.perf_counter()
    staged = _Staged(lanes, k_epochs, max_rounds, pads=pads, device=device)
    _PHASES["stage_s"] += time.perf_counter() - t0
    return staged


def _init_carry(lanes: List[Lane], states: llc_mod.LLCState,
                n_inputs: int) -> FusedCarry:
    """The device carry from the lanes' current host state (works mid-run:
    the overflow fallback replays a stretch on the host and resumes fused
    from whatever the lanes now hold)."""
    dev = states.tags.device
    n_l = len(lanes)
    comp = np.zeros((n_l, n_inputs))
    for i, lane in enumerate(lanes):
        comp[i, :len(lane.completions)] = lane.completions[:n_inputs]
    if lanes[0].dsched is not None:
        b_row = np.stack([lane.dsched.row for lane in lanes])
        b_queue = np.stack([lane.dsched.queue for lane in lanes])
        b_rr = np.array([lane.dsched.rr for lane in lanes], np.int64)
    else:
        b_row = np.zeros((n_l, 0), np.int64)
        b_queue = np.zeros((n_l, 0), np.int64)
        b_rr = np.zeros(n_l, np.int64)

    def t(vals, dtype=None):
        return torch.as_tensor(np.asarray(vals, dtype), device=dev)

    return FusedCarry(
        st=states,
        active=t([lane.active for lane in lanes], bool),
        hr_core=t([lane.hr_core for lane in lanes], np.float64),
        hr_accel=t([lane.hr_accel for lane in lanes], np.float64),
        amal=t([lane.amal for lane in lanes], np.float64),
        ipc=t(np.stack([np.asarray(lane.ipc, np.float64)
                        for lane in lanes])),
        stream_pos=t(np.stack([np.asarray(lane.stream_pos, np.int64)
                               for lane in lanes])),
        pos=t([lane.pos for lane in lanes], np.int64),
        input_idx=t([lane.input_idx for lane in lanes], np.int64),
        input_start=t([lane.input_start for lane in lanes], np.float64),
        now=t([lane.now for lane in lanes], np.float64),
        ri_th=t([lane.ri_th for lane in lanes], np.int64),
        rc_th=t([lane.rc_th for lane in lanes], np.int64),
        special=t([lane.special for lane in lanes], bool),
        cm_prev=t([lane.cm_prev for lane in lanes], np.float64),
        pf_prev=t([lane.pf_prev for lane in lanes], np.float64),
        epoch=t([lane.epoch for lane in lanes], np.int64),
        completions=t(comp),
        totals=t(np.stack([np.array(
            [lane.total_core_hits, lane.total_core_miss,
             lane.total_core_byp, lane.total_accel_hits,
             lane.total_accel_miss, lane.total_accel_byp,
             lane.total_accel_acc], np.int64) for lane in lanes])),
        total_llc=t([lane.total_llc for lane in lanes], np.float64),
        total_dram=t([lane.total_dram for lane in lanes], np.float64),
        overflow=torch.zeros(n_l, dtype=torch.bool, device=dev),
        bank_row=t(b_row), bank_queue=t(b_queue), bank_rr=t(b_rr))


# ---------------------------------------------------------------------------
# write-back / host fallback / drive_lanes_fused
# ---------------------------------------------------------------------------
def _numpy(tup):
    return type(tup)(*(None if x is None else x.cpu().numpy() for x in tup))


def _write_back_carry(lanes: List[Lane], c, skip) -> None:
    """Sync per-lane carry scalars (``c``: the carry as numpy) into the host
    Lane objects -- the exact fields and python/numpy types the host loop
    would have produced, so ``Lane.result()`` and any later host epochs are
    indistinguishable from a pure-host run."""
    for i, lane in enumerate(lanes):
        if skip[i]:
            continue
        lane.hr_core = float(c.hr_core[i])
        lane.hr_accel = float(c.hr_accel[i])
        lane.amal = float(c.amal[i])
        # np.array: the host loop mutates these in place if it resumes
        lane.ipc = np.array(c.ipc[i], np.float64)
        lane.stream_pos = np.array(c.stream_pos[i], np.int64)
        lane.pos = int(c.pos[i])
        lane.input_idx = int(c.input_idx[i])
        lane.input_start = float(c.input_start[i])
        lane.now = float(c.now[i])
        lane.ri_th = int(c.ri_th[i])
        lane.rc_th = int(c.rc_th[i])
        lane.special = bool(c.special[i])
        lane.cm_prev = float(c.cm_prev[i])
        lane.pf_prev = float(c.pf_prev[i])
        lane.epoch = int(c.epoch[i])
        lane.completions = [float(v) for v in
                            c.completions[i][:lane.input_idx]]
        (lane.total_core_hits, lane.total_core_miss, lane.total_core_byp,
         lane.total_accel_hits, lane.total_accel_miss, lane.total_accel_byp,
         lane.total_accel_acc) = (int(v) for v in c.totals[i])
        lane.total_llc = float(c.total_llc[i])
        lane.total_dram = float(c.total_dram[i])
        if lane.dsched is not None:
            lane.dsched.row = np.array(c.bank_row[i], np.int64)
            lane.dsched.queue = np.array(c.bank_queue[i], np.int64)
            lane.dsched.rr = int(c.bank_rr[i])


def _write_back_steps(lanes: List[Lane], y: StepOut) -> None:
    """Append one super-step's committed epochs (``y`` as numpy) to the
    lanes' histories.  Committed steps are a prefix of the super-step (a
    freeze is sticky within it), so row t is epoch t."""
    for i, lane in enumerate(lanes):
        steps = int(y.active[:, i].sum())
        h = lane.hist
        et = lane.et
        for t in range(steps):
            h["accel_rate"].append(float(y.n_a[t, i]))
            h["requirement"].append(float(y.req[t, i]))
            h["ri_th"].append(float(y.ri_th[t, i]))
            h["rc_th"].append(float(y.rc_th[t, i]))
            h["core_ipc"].append(float(y.core_ipc[t, i]))
            h["amal"].append(float(y.amal[t, i]))
            if lane.p.record_occupancy:
                lane.occ.append([int(y.occ[t, i, 0]), int(y.occ[t, i, 1])])
            # the host's total_instr accumulation, op for op
            lane.total_instr += float(y.core_ipc[t, i] * et)
            if lane._retrain_every is not None and y.n_a[t, i] > 0:
                lane._win_ranges.append(
                    (int(y.pos_before[t, i]),
                     int(y.pos_before[t, i] + y.n_a[t, i])))


def _write_back(lanes: List[Lane], carry: FusedCarry, ys: StepOut) -> None:
    """Sync an accepted super-step's results into the host Lane objects."""
    c = _numpy(carry._replace(st=None))
    y = _numpy(ys)
    _write_back_carry(lanes, c, skip=[int(y.active[:, i].sum()) == 0
                                      for i in range(len(lanes))])
    _write_back_steps(lanes, y)


def _host_stretch(lanes: List[Lane], states: llc_mod.LLCState,
                  n_epochs: Optional[int]) -> llc_mod.LLCState:
    """Advance the batch ``n_epochs`` epochs (None = to completion) on the
    host path -- per-lane event build, ``build_rounds`` chunking and the
    round loop, i.e. ``sim.drive_lane``'s loop body, against lane ``i``'s
    slice of the batched LLC states."""
    dev = states.tags.device
    e = 0
    while (n_epochs is None or e < n_epochs) and \
            any(lane.active for lane in lanes):
        for i, lane in enumerate(lanes):
            if not lane.active:
                continue
            st_i = llc_mod.lane_state(states, i)
            ev = lane.begin_epoch()
            stats = np.zeros(len(llc_mod.STAT_NAMES), np.int64)
            percore = np.zeros((llc_mod.NUM_CORES, 2), np.int64)
            if ev is not None:
                st_sum, pc_sum = 0, 0
                for lm, mm in llc_mod.build_rounds(lane.llc_cfg, *ev):
                    st_i, st_c, pc_c = llc_mod.simulate_epoch(
                        lane.llc_cfg, st_i, lm, mm, device=dev)
                    st_sum, pc_sum = st_sum + st_c, pc_sum + pc_c
                stats = stats + st_sum.cpu().numpy()
                percore = percore + pc_sum.cpu().numpy()
                for full, part in zip(states, st_i):
                    full[i].copy_(part)
            lane.finish_epoch(stats, percore, llc_state=st_i)
        e += 1
        _COUNTS["host_epochs"] += 1
    return states


def _next_stop(lanes: List[Lane], max_epochs: int) -> int:
    """First epoch the fused run must not cross: the nearest online-LERN
    retrain boundary of any lane (the refit runs on the host)."""
    stop = max_epochs
    for lane in lanes:
        r = lane._retrain_every
        if lane.active and r is not None:
            e = lane.epoch
            stop = min(stop, e + r - e % r)
    return stop


def drive_lanes_fused(lanes: List[Lane], states=None,
                      k_epochs: int = DEFAULT_SUPERSTEP,
                      max_rounds: int = DEFAULT_MAX_ROUNDS) -> None:
    """Drive a geometry-compatible batch of lanes to completion through
    the fused engine, super-step by super-step, on the device of
    ``states`` when given (a group demoted from a bucket's shard stays on
    the shard's card), else on the lanes'.

    Equal to ``sim.drive_lane`` per lane (integers bitwise, floats within
    rtol 1e-6 and in practice bitwise); a super-step that overflows the
    round capacity is re-run at twice the capacity up to
    ``MAX_ROUNDS_CAP``, then replayed on the host path, going host-sticky
    after two overflows in a row.
    """
    assert all(lane_supported(lane) for lane in lanes)
    max_epochs = int(lanes[0].p.max_epochs)
    staged = _Staged(lanes, k_epochs, max_rounds,
                     device=None if states is None else states.tags.device)
    if states is None:
        states = llc_mod.stack_states(staged.dims.cfg, len(lanes),
                                      staged.device)
    carry = _init_carry(lanes, states, staged.dims.n_inputs)
    overflows = 0
    while any(lane.active for lane in lanes):
        stop = _next_stop(lanes, max_epochs)
        epochs_before = [lane.epoch for lane in lanes]
        new_carry, ys = _superstep(staged.dims, staged.sh, staged.lc, carry,
                                   stop)
        overflowed = bool(new_carry.overflow.any())   # the one read
        if overflowed:
            # the lanes were not touched and ``carry`` is still the
            # super-step's start: escalate the capacity and re-run, then
            # past the host's largest bucket replay the stretch on the host
            # path, which chunks arbitrarily hot sets
            if staged.dims.max_rounds < MAX_ROUNDS_CAP:
                staged.dims = dataclasses.replace(
                    staged.dims, max_rounds=min(staged.dims.max_rounds * 2,
                                                MAX_ROUNDS_CAP))
                _COUNTS["escalations"] += 1
                continue
            overflows += 1
            _COUNTS["host_stretches"] += 1
            e = max((lane.epoch for lane in lanes if lane.active),
                    default=0)
            n_host = None if overflows >= 2 else min(k_epochs, stop - e)
            states = _host_stretch(lanes, carry.st, n_host)
            if not any(lane.active for lane in lanes):
                return
            staged.refresh_clusters(lanes)
            carry = _init_carry(lanes, states, staged.dims.n_inputs)
            continue
        overflows = 0
        _COUNTS["supersteps"] += 1
        _write_back(lanes, new_carry, ys)
        carry = new_carry._replace(overflow=torch.zeros_like(
            new_carry.overflow))
        # online-LERN boundaries land exactly at the super-step edge
        # (_next_stop): run the host refit and re-upload the tables
        retrained = False
        for i, lane in enumerate(lanes):
            r = lane._retrain_every
            if (r is not None and lane.epoch > epochs_before[i]
                    and lane.epoch % r == 0):
                lane._online_retrain()
                retrained = True
        if retrained:
            staged.refresh_clusters(lanes)


# ---------------------------------------------------------------------------
# whole-sweep bucketing: the lane groups of a bucket as one flat lane batch
# ---------------------------------------------------------------------------
def bucket_key(lanes: List[Lane]) -> Tuple:
    """Static-compatibility key for ``drive_lanes_bucketed``: lane groups
    may share one flat batch iff every static ``FusedDims`` field agrees --
    LLC geometry, lane count, core slot layout, accel capacity, the DPCP
    prefetch segment, input count, the occupancy record and the scheduled
    DRAM geometry.  Traces, streams, knobs, deadlines, max_epochs and the
    DRAM timings ride as data."""
    lane0 = lanes[0]
    from . import cores as cores_mod
    core_caps = tuple(
        max(int(cores_mod.epoch_accesses(pr, pr.ipc0, lane0.et)), 0)
        for pr in lane0.profiles)
    sched = (dramsched.sched_dims(lane0.dram)
             if isinstance(lane0.dram, dram_mod.SchedDramModel) else None)
    return (llc_mod.geometry_key(lane0.llc_cfg), len(lanes),
            lane0.n_cores, core_caps, int(lane0.p.accel_epoch_cap),
            any(lane.policy.dpcp for lane in lanes),
            int(lane0.p.n_inputs), bool(lane0.p.record_occupancy), sched)


# SharedConsts arrays that keep their leading group axis in a bucket (read
# by (group, element) gathers, ``_rows``); every other leaf is a group
# constant that becomes a per-lane tensor
_SH_GROUP_ARRAYS = frozenset({"line", "write", "layer", "streams"})


def _bucket_consts(shs: List[SharedConsts], n_lanes: int) -> SharedConsts:
    """The SharedConsts of a bucket's flat (G*L) lane batch: the trace and
    stream arrays stacked [G, ...], each group constant broadcast to its
    lanes by one gather, the scheduled-DRAM timings as a table of the
    distinct ones with a per-lane index."""
    dev = shs[0].line.device
    gid = torch.arange(len(shs), device=dev).repeat_interleave(n_lanes)
    out = {}
    for f in SharedConsts._fields:
        vals = [getattr(s, f) for s in shs]
        if f in ("sd_timing", "sd_lane", "gid"):
            continue
        if f in _SH_GROUP_ARRAYS:
            out[f] = torch.stack(vals)
        elif f == "et_i":
            out[f] = torch.cat(vals)
        elif isinstance(vals[0], torch.Tensor):
            out[f] = torch.stack(vals)[gid]
        else:
            out[f] = torch.tensor(vals, dtype=torch.int64, device=dev)[gid]
    timings = list(dict.fromkeys(t for s in shs for t in s.sd_timing))
    sd_lane = None
    if len(timings) > 1:
        sd_lane = torch.tensor([timings.index(s.sd_timing[0]) for s in shs],
                               device=dev)[gid]
    return SharedConsts(**out, sd_timing=tuple(timings), sd_lane=sd_lane,
                        gid=gid)


def _stack_trees(trees):
    """Concatenate same-typed NamedTuples of [L, ...] tensors (LaneConsts,
    FusedCarry, LLCState, LaneKnobs) leaf by leaf along the lane axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    return type(first)(*(_stack_trees(list(xs)) for xs in zip(*trees)))


def _superstep_bucket(dims: FusedDims, sh: SharedConsts, lc: LaneConsts,
                      carry: FusedCarry, stop: torch.Tensor):
    """K epochs of a bucket's flat lane batch, enqueued with no read by the
    host: one ``llc_rounds`` launch an epoch for all G*L lanes.  The kernel
    updates the LLC state in place -- the carry passed in is not used
    again (an overflowing lane freezes on its committed carry instead of
    rolling back).  Returns (carry, StepOut stacked [K, G*L])."""
    cy = carry
    outs = []
    for _ in range(dims.k_epochs):
        cy, out = _epoch_step(dims, sh, stop, lc, cy)
        outs.append(out)
    return cy, StepOut(*(torch.stack(f) for f in zip(*outs)))


def _fetch(ys: StepOut):
    """Enqueue the copy of a super-step's outputs to the host: on the card
    into pinned buffers, behind the super-step in stream order, with an
    event recorded after it; on the CPU the outputs are the host's.
    Returns (host StepOut, event or None)."""
    if not ys.active.is_cuda:
        return ys, None
    host = StepOut(*(torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                     .copy_(y, non_blocking=True) for y in ys))
    done = torch.cuda.Event(enable_timing=True)
    done.record()
    return host, done


def _lanes_slice(tup, lo: int, hi: int, axis: int = 0):
    return type(tup)(*(None if x is None else x[(slice(None),) * axis
                                               + (slice(lo, hi),)]
                       for x in tup))


def check_devices(devices: Optional[int], dev: torch.device) -> None:
    """Raise ``ValueError`` if ``devices`` asks for more cards than are
    visible (on the CPU any count is shards on the CPU).  The JAX package
    builds a smaller mesh instead; the port has no silent fallback."""
    if dev.type == "cuda" and devices:
        visible = torch.cuda.device_count()
        if devices > visible:
            raise ValueError(f"devices={devices}: only {visible} CUDA "
                             f"device(s) visible")


def shard_devices(n_groups: int, devices: Optional[int],
                  dev: torch.device) -> List[torch.device]:
    """The devices of a bucket of ``n_groups`` groups, one a shard.

    ``devices`` of None counts the visible cards on ``"cuda"`` and is 1 on
    the CPU (the JAX package's default: every visible device).  The
    bucket shards only when the count is above 1 and divides the groups
    (``src/repro/core/fused.py:1609-1610``), else it runs whole on ``dev``.
    On ``"cuda"`` shard i lives on ``cuda:i``; on the CPU every shard is
    the CPU (the stand-in for JAX's forced host devices)."""
    check_devices(devices, dev)
    n_dev = devices or (torch.cuda.device_count() if dev.type == "cuda"
                        else 1)
    if n_dev <= 1 or n_groups % n_dev:
        return [dev]
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n_dev)]
    return [dev] * n_dev


def drive_lanes_bucketed(groups: List[List[Lane]], states=None,
                         k_epochs: int = DEFAULT_SUPERSTEP,
                         max_rounds: int = DEFAULT_MAX_ROUNDS,
                         devices: Optional[int] = None,
                         staged: Optional[List[_Staged]] = None,
                         pipeline: Optional[bool] = None) -> None:
    """Drive lane groups of equal ``bucket_key`` to completion as flat
    lane batches: one ``llc_rounds`` launch an epoch a shard.

    ``devices`` shards the groups over cards as the JAX package's
    ``shard_map`` does (``shard_devices``): each shard takes a contiguous
    slice of the groups and runs it as one flat lane batch on its card,
    with its own staged constants, carry and stop epochs; the shards share
    nothing but the round capacity.  Every group's results equal
    ``drive_lanes_fused`` on the group alone bitwise, whatever the shards
    (tests/test_torch_bucketed.py, tests/test_torch_shards.py): each lane
    computes the same values as in its group's batch, and exactly the
    epochs ``drive_lanes_fused`` would commit are committed.  A ``devices``
    above the visible cards raises ``ValueError`` before any work.

    Progress is tracked from the super-steps' outputs alone -- one host
    read a shard and super-step, every shard's super-step enqueued before
    any is read -- and the carries stay on the cards until the run ends
    or a group demotes.  With ``pipeline`` (default
    ``REPRO_BUCKET_PIPELINE``, on) and no online-LERN lane, super-step N+1
    is enqueued before N's write-back, which reads N's outputs from pinned
    buffers behind an event on each shard's card; stream order keeps the
    carry's hand-over exact (the JAX package donates the carry instead,
    and only unsharded).

    Overflow never rolls back: an overflowing lane freezes on its committed
    carry; the shared capacity doubles first (up to ``MAX_ROUNDS_CAP``),
    then only the offending groups leave, each from its frozen carry
    through ``drive_lanes_fused`` on its shard's card (host fallback and
    all).  ``staged`` reuses staged constants (the sweep's staging cache),
    built with this bucket's ``bucket_pads`` on each group's shard
    device."""
    dev = groups[0][0].device
    _drive_shards(groups, shard_devices(len(groups), devices, dev), states,
                  k_epochs, max_rounds, staged, pipeline)


class _Shard:
    """One shard of a bucket: groups ``lo:hi`` as a flat lane batch on
    ``dev`` (constants, per-lane tables, carry)."""

    def __init__(self, dev, lo, hi, sh, lc, carry):
        self.dev, self.lo, self.hi = dev, lo, hi
        self.sh, self.lc, self.carry = sh, lc, carry


def _drive_shards(groups: List[List[Lane]], devs: List[torch.device],
                  states=None, k_epochs: int = DEFAULT_SUPERSTEP,
                  max_rounds: int = DEFAULT_MAX_ROUNDS,
                  staged: Optional[List[_Staged]] = None,
                  pipeline: Optional[bool] = None) -> None:
    """``drive_lanes_bucketed`` on the shard devices ``devs``, given
    explicitly (their count divides the groups; a device may repeat, which
    only a check of the shard machinery on one card wants)."""
    assert groups and len({bucket_key(g) for g in groups}) == 1
    for g in groups:
        assert all(lane_supported(lane) for lane in g)
    n_groups, n_l = len(groups), len(groups[0])
    assert n_groups % len(devs) == 0, (n_groups, devs)
    per = n_groups // len(devs)
    max_epochs = [int(g[0].p.max_epochs) for g in groups]
    if pipeline is None:
        pipeline = PIPELINE_DEFAULT
    if staged is None:
        pads = bucket_pads(groups)
        staged = [stage_group(g, k_epochs, max_rounds, pads=pads,
                              device=devs[i // per])
                  for i, g in enumerate(groups)]
    assert all(s.device == devs[i // per] for i, s in enumerate(staged))
    t0 = time.perf_counter()
    dims = staged[0].dims
    # bucket-mates agree on every static field but the incidental lane0
    # LLCConfig of ``cfg``: behaviour knobs ride as data, only the geometry
    # must match (mixed policy rosters chunked by max_lanes hit this)
    assert all(dataclasses.replace(s.dims, cfg=dims.cfg) == dims
               and llc_mod.geometry_key(s.dims.cfg)
               == llc_mod.geometry_key(dims.cfg) for s in staged)
    shards = []
    for k, sdev in enumerate(devs):
        lo, hi = k * per, (k + 1) * per
        if states is None:
            st = llc_mod.stack_states(dims.cfg, per * n_l, sdev)
        else:
            st = _stack_trees([llc_mod.LLCState(*(x.to(sdev) for x in s))
                               for s in states[lo:hi]])
        shards.append(_Shard(
            sdev, lo, hi, _bucket_consts([s.sh for s in staged[lo:hi]], n_l),
            _stack_trees([s.lc for s in staged[lo:hi]]),
            _init_carry([lane for g in groups[lo:hi] for lane in g], st,
                        dims.n_inputs)))
    _COUNTS["bucket_shards"] += len(shards)
    _PHASES["stage_s"] += time.perf_counter() - t0
    # enqueueing ahead needs constant stop epochs: an online-LERN boundary
    # needs a host refit (and a table upload) before the next super-step
    speculate = pipeline and not any(
        lane._retrain_every is not None for g in groups for lane in g)

    # progress tracked here, fed by the fetched outputs: the Lanes'
    # scalars are stale until the final carry write-back
    epochs = [[lane.epoch for lane in g] for g in groups]
    alive = [[lane.active for lane in g] for g in groups]
    live = [True] * n_groups       # False once demoted to drive_lanes_fused
    # lanes that reached a retrain boundary whose refit has not run yet
    # (deferred while their group has an overflow to resolve: the frozen
    # lane re-attempts its epoch under the old tables first)
    due = [set() for _ in range(n_groups)]

    def group_active(i: int) -> bool:
        return live[i] and any(alive[i])

    def next_stop(i: int) -> int:
        if not group_active(i):
            return 0
        stop = max_epochs[i]
        for j, lane in enumerate(groups[i]):
            r = lane._retrain_every
            if alive[i][j] and r is not None:
                e = epochs[i][j]
                # a due lane holds at its boundary until the refit runs
                stop = min(stop, e if j in due[i] else e + r - e % r)
        return stop

    def dispatch():
        stops = [next_stop(i) for i in range(n_groups)]
        before = [list(e) for e in epochs]
        t = time.perf_counter()
        reads = []
        for sd in shards:        # every shard enqueued before any is read
            with on_card(sd.dev):
                stop = torch.tensor(np.repeat(stops[sd.lo:sd.hi], n_l),
                                    dtype=torch.int64, device=sd.dev)
                start = None
                if sd.dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                sd.carry, ys = _superstep_bucket(dims, sd.sh, sd.lc,
                                                 sd.carry, stop)
                reads.append((sd, start) + _fetch(ys))
        _COUNTS["bucket_supersteps"] += 1
        _PHASES["dispatch_s"] += time.perf_counter() - t
        return reads, before

    inflight: list = []
    depth = 2 if speculate else 1
    overflow_pending: set = set()
    from ..exp import faults as _flt
    while True:
        # fault-injection site "bucket_overflow": force the freeze/demote
        # machinery as if every active group had overflowed at the cap
        # (checked before dispatch so it bites on workloads that finish
        # inside the first super-step); each group leaves from its
        # committed carry and finishes under drive_lanes_fused
        if any(group_active(i) for i in range(n_groups)):
            if _flt.fire("bucket_overflow", key=f"g{n_groups}") is not None:
                dims = dataclasses.replace(dims, max_rounds=MAX_ROUNDS_CAP)
                overflow_pending.update(
                    i for i in range(n_groups) if group_active(i))
        while (not overflow_pending and len(inflight) < depth
               and any(group_active(i) for i in range(n_groups))):
            inflight.append(dispatch())
            if not speculate:
                break
        if not inflight:
            if not overflow_pending:
                break
            # every super-step is written back: escalate the shared
            # capacity first (the frozen lanes re-attempt their epoch) ...
            if dims.max_rounds < MAX_ROUNDS_CAP:
                dims = dataclasses.replace(
                    dims, max_rounds=min(dims.max_rounds * 2,
                                         MAX_ROUNDS_CAP))
                for sd in shards:
                    sd.carry = sd.carry._replace(
                        overflow=torch.zeros_like(sd.carry.overflow))
                overflow_pending.clear()
                _COUNTS["bucket_escalations"] += 1
                continue
            # ... and past the cap demote only the offending groups: write
            # their carry back and hand them to drive_lanes_fused from
            # their frozen state, on their shard's card
            for sd in shards:
                gone = [i for i in sorted(overflow_pending)
                        if sd.lo <= i < sd.hi and live[i]]
                if not gone:
                    continue
                host_c = _numpy(sd.carry._replace(st=None))
                for i in gone:
                    live[i] = False
                    lo = (i - sd.lo) * n_l
                    hi = lo + n_l
                    _write_back_carry(groups[i],
                                      _lanes_slice(host_c, lo, hi),
                                      skip=[False] * n_l)
                    # a deferred refit touches only the due lane's own
                    # tables (it holds at its boundary): run it before the
                    # replay
                    for j in sorted(due[i]):
                        groups[i][j]._online_retrain()
                    due[i].clear()
                    st_i = llc_mod.LLCState(*(x[lo:hi].clone()
                                              for x in sd.carry.st))
                    _COUNTS["bucket_demotions"] += 1
                    with on_card(sd.dev):
                        drive_lanes_fused(groups[i], states=st_i,
                                          k_epochs=dims.k_epochs,
                                          max_rounds=dims.max_rounds)
                dead = torch.tensor(
                    np.repeat([not a for a in live[sd.lo:sd.hi]], n_l),
                    device=sd.dev)
                sd.carry = sd.carry._replace(active=sd.carry.active & ~dead)
            for sd in shards:
                sd.carry = sd.carry._replace(
                    overflow=torch.zeros_like(sd.carry.overflow))
            overflow_pending.clear()
            continue
        reads, before = inflight.pop(0)
        for _sd, start, _host, done in reads:
            if done is not None:
                done.synchronize()     # the one read of the shard's step
                _PHASES["device_s"] += start.elapsed_time(done) / 1e3
        t = time.perf_counter()
        for sd, _start, host, _done in reads:
            y = _numpy(host)
            for i in range(sd.lo, sd.hi):
                if not live[i]:
                    continue
                lo = (i - sd.lo) * n_l
                y_i = _lanes_slice(y, lo, lo + n_l, axis=1)
                _write_back_steps(groups[i], y_i)
                for j in range(n_l):
                    epochs[i][j] += int(y_i.active[:, j].sum())
                    alive[i][j] = bool(y_i.alive[-1, j])
                    r = groups[i][j]._retrain_every
                    if (r is not None and epochs[i][j] > before[i][j]
                            and epochs[i][j] % r == 0):
                        due[i].add(j)
                if y_i.ovf[-1].any():
                    overflow_pending.add(i)
        _PHASES["writeback_s"] += time.perf_counter() - t
        # online-LERN boundaries land at the super-step edge per group
        # (next_stop): run the refits and upload that group's tables; a
        # group with an unresolved overflow defers
        refreshed = set()
        for i in range(n_groups):
            if not live[i] or i in overflow_pending or not due[i]:
                continue
            for j in sorted(due[i]):
                groups[i][j]._online_retrain()
            due[i].clear()
            t = time.perf_counter()
            staged[i].refresh_clusters(groups[i])
            refreshed.add(i // per)
            _PHASES["stage_s"] += time.perf_counter() - t
        for k in refreshed:
            sd = shards[k]
            sd.lc = _stack_trees([s.lc for s in staged[sd.lo:sd.hi]])
    # one write-back of the carry's scalars: the histories landed super-step
    # by super-step, and demoted groups were written back at demotion
    t = time.perf_counter()
    for sd in shards:
        host_c = _numpy(sd.carry._replace(st=None))
        for i in range(sd.lo, sd.hi):
            if live[i]:
                lo = (i - sd.lo) * n_l
                _write_back_carry(groups[i],
                                  _lanes_slice(host_c, lo, lo + n_l),
                                  skip=[False] * n_l)
    _PHASES["writeback_s"] += time.perf_counter() - t
