"""Vectorized set-associative shared-LLC engine with bypass paths.

Cache content only couples accesses that map to the *same set*, so the
epoch's event stream is regrouped into "rounds" -- round r holds the r-th
access of every set -- and one dense, vectorized transition advances the
whole [S, W] state per round (gather/compare/one-hot select), instead of a
serial per-event loop.  ``simulate_epoch`` runs the rounds of one lane's
chunk and ``simulate_epoch_lanes`` those of several policy lanes (the lane
axis a dimension of every op) through ``kernels.llc_rounds``: one kernel
launch a chunk on the card, a Python loop of ``round_transition`` on the
CPU.  Exactness: per-set event order is
preserved, so hits/misses/LRU/occupancy are exact.  The only relaxation is
that global SHIP counter updates within one round are applied as a batch;
``ref_simulate`` (the serial oracle) pins the exact semantics on
one-event-per-round inputs.

Every value here is an integer, so the port's state is bitwise the JAX
package's after every epoch.  The round tick advances on every round of a
chunk, padded rounds included, exactly as the JAX scan does: LRU stores it.

Bypass semantics (paper Fig. 1 / §V-C):
* accel write request chosen for bypass  -> direct to DRAM; if the line is
  present in the LLC, the cached copy is invalidated.
* accel read: if present, served by the LLC regardless of the bypass
  decision; on a miss, a bypassed *response* is not filled.
* core read response bypass: SHIP-predicted-dead fills are not inserted.

Geometry note: the simulator runs a HW_SCALE=8 scaled memory system (1 MB
LLC standing in for the paper's 8 MB; workload footprints scaled alike).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import device as _device
from . import ship as ship_mod
from .ship import ShipParams

HW_SCALE = 8  # memory-system scale factor (sizes; rates are unscaled)

# accel bypass modes (static)
A_NONE = 0   # never bypass accelerator accesses
A_HINT = 1   # bypass iff per-event hint (LERN clusters x epoch thresholds)
A_SHIP = 2   # bypass iff SHIP-accel predicts dead
A_RAND = 3   # hint carries the pre-drawn random decision (AFRp)

# meta bitfield
M_VALID = 1 << 0
M_ACCEL = 1 << 1
M_WRITE = 1 << 2
M_HINT = 1 << 3
M_PREFETCH = 1 << 4
M_DLOK = 1 << 5      # deadline switch already passed for this event
M_SRC_SHIFT = 8      # bits 8..10: issuing core id

NUM_CORES = 8


@dataclasses.dataclass(frozen=True)
class LLCConfig:
    size_bytes: int = 8 * 1024 * 1024 // HW_SCALE
    ways: int = 16
    line_bytes: int = 64
    tag_cycles: int = 3
    data_cycles: int = 9
    # static policy knobs
    core_bypass: bool = False          # SHIP-driven core response bypass
    accel_mode: int = A_NONE
    shared_predictor: bool = False     # CAS: one SHIP table for both agents
    core_way_mask: int = 0xFFFF        # way partitioning (Fig. 18)
    accel_way_mask: int = 0xFFFF
    ship: ShipParams = ship_mod.SHIP_DEFAULT
    # SHIP sampler sets: observer sets never bypass and are the only sets
    # that train the SHCT (prevents the bypass death-spiral; standard
    # set-sampling practice for bypass-capable SHiP variants).
    sampler_shift: int = 5             # every 32nd set observes

    @property
    def num_sets(self) -> int:
        return self.size_bytes // (self.line_bytes * self.ways)

    @property
    def hit_latency(self) -> int:
        return self.tag_cycles + self.data_cycles




class LLCState(NamedTuple):
    tags: torch.Tensor      # int32 [S, W], -1 = invalid
    lru: torch.Tensor       # int32 [S, W] last-touch tick
    owner: torch.Tensor     # int32 [S, W] 0 core / 1 accel
    sig: torch.Tensor       # int32 [S, W] inserting SHIP signature
    reused: torch.Tensor    # bool  [S, W]
    tick: torch.Tensor      # int32 [] global round tick
    shct_core: torch.Tensor   # int32 [T]
    shct_accel: torch.Tensor  # int32 [T]


def init_state(cfg: LLCConfig, device="cuda") -> LLCState:
    dev = _device.resolve(device)
    s, w = cfg.num_sets, cfg.ways

    def full(v, dtype=torch.int32):
        return torch.full((s, w), v, dtype=dtype, device=dev)

    return LLCState(
        tags=full(-1), lru=full(0), owner=full(0), sig=full(0),
        reused=full(False, torch.bool),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        shct_core=ship_mod.init_table(cfg.ship, dev),
        shct_accel=ship_mod.init_table(cfg.ship, dev),
    )


STAT_NAMES = (
    "core_hits", "core_misses", "core_bypasses",
    "accel_hits", "accel_misses", "accel_bypasses",
    "accel_writes_bypassed", "evictions", "prefetch_fills", "invalidations",
)

ROUND_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _mask_to_vec(mask: int, w: int) -> np.ndarray:
    return np.array([(mask >> i) & 1 for i in range(w)], dtype=bool)


def build_rounds(cfg: LLCConfig, line: np.ndarray, meta: np.ndarray,
                 max_rounds: int = ROUND_BUCKETS[-1]):
    """Regroup an ordered event stream into round-major [R, S] matrices.

    Round r, column s = the r-th event addressed to set s (-1/0 if none).
    R is padded up to the next bucket so the jitted scan compiles once per
    bucket.  Hot sets with more than ``max_rounds`` events yield multiple
    chunks, processed sequentially (per-set order is preserved; cross-set
    interleaving is immaterial to cache content — see module docstring).

    Yields (line_m, meta_m) chunk pairs."""
    s_all = (line & (cfg.num_sets - 1)).astype(np.int64)
    order = np.argsort(s_all, kind="stable")
    ss = s_all[order]
    n = line.shape[0]
    if n == 0:
        return
    first = np.empty(n, dtype=bool)
    first[0] = True
    first[1:] = ss[1:] != ss[:-1]
    gid = np.cumsum(first) - 1
    grp_start = np.flatnonzero(first)
    rank = np.arange(n) - grp_start[gid]
    line_o = line[order].astype(np.int32)
    meta_o = meta[order].astype(np.int32)
    n_chunks = int(rank.max()) // max_rounds + 1
    for c in range(n_chunks):
        m = (rank >= c * max_rounds) & (rank < (c + 1) * max_rounds)
        rk = rank[m] - c * max_rounds
        r_needed = int(rk.max()) + 1
        r_pad = next(b for b in ROUND_BUCKETS if b >= r_needed)
        line_m = np.full((r_pad, cfg.num_sets), -1, dtype=np.int32)
        meta_m = np.zeros((r_pad, cfg.num_sets), dtype=np.int32)
        line_m[rk, ss[m]] = line_o[m]
        meta_m[rk, ss[m]] = meta_o[m]
        yield line_m, meta_m


class LaneKnobs(NamedTuple):
    """Policy knobs of one lane or of a lane batch.

    One lane (``_const_knobs``): the three mode switches as Python values
    (the round loop branches on them) and the way masks as bool [W]
    tensors.  A lane batch (``lane_knobs``): every knob a tensor with a
    leading lane axis -- modes [L, 1], way masks [L, 1, W] -- so one
    round's ops advance all lanes at once.  Geometry and the SHIP table
    shape stay static and must agree across lanes (``geometry_key``)."""
    accel_mode: object             # int | int64 [L, 1]
    core_bypass: object            # bool | bool [L, 1]
    shared_predictor: object       # bool | bool [L, 1]
    core_ways: torch.Tensor        # bool [W] | [L, 1, W]
    accel_ways: torch.Tensor       # bool [W] | [L, 1, W]


def _const_knobs(cfg: LLCConfig, device) -> LaneKnobs:
    w = cfg.ways
    return LaneKnobs(
        accel_mode=int(cfg.accel_mode), core_bypass=bool(cfg.core_bypass),
        shared_predictor=bool(cfg.shared_predictor),
        core_ways=torch.as_tensor(_mask_to_vec(cfg.core_way_mask, w),
                                  device=device),
        accel_ways=torch.as_tensor(_mask_to_vec(cfg.accel_way_mask, w),
                                   device=device))


def lane_knobs(cfgs, device="cuda") -> LaneKnobs:
    """Stack the policy knobs of several LLCConfigs along a lane axis."""
    dev = _device.resolve(device)
    w = cfgs[0].ways

    def col(vals, dtype):
        return torch.as_tensor(vals, dtype=dtype, device=dev)[:, None]

    def ways(attr):
        return torch.as_tensor(np.stack([_mask_to_vec(getattr(c, attr), w)
                                         for c in cfgs]), device=dev)[:, None]

    return LaneKnobs(
        accel_mode=col([c.accel_mode for c in cfgs], torch.int64),
        core_bypass=col([c.core_bypass for c in cfgs], torch.bool),
        shared_predictor=col([c.shared_predictor for c in cfgs], torch.bool),
        core_ways=ways("core_way_mask"), accel_ways=ways("accel_way_mask"))


def select_knobs(knobs: LaneKnobs, keep: torch.Tensor) -> LaneKnobs:
    """The lanes ``keep`` (indices) of a lane batch's knobs."""
    return LaneKnobs(*(k[keep] for k in knobs))


def geometry_key(cfg: LLCConfig) -> Tuple:
    """Lanes may share one batched epoch iff these static fields agree
    (they fix the state shapes)."""
    return (cfg.size_bytes, cfg.ways, cfg.line_bytes, cfg.ship,
            cfg.sampler_shift)


def stack_states(cfg: LLCConfig, n: int, device="cuda") -> LLCState:
    """n fresh per-lane LLC states stacked on a leading lane axis."""
    one = init_state(cfg, device)
    return LLCState(*(x.expand((n,) + x.shape).clone() for x in one))


def lane_state(states: LLCState, i: int) -> LLCState:
    """Lane ``i`` of a stacked state, as a one-lane state."""
    return LLCState(*(x[i] for x in states))


def select_states(states: LLCState, keep: torch.Tensor) -> LLCState:
    """The lanes ``keep`` (indices) of a stacked state."""
    return LLCState(*(x[keep] for x in states))


def _sampler(cfg: LLCConfig, device) -> torch.Tensor:
    """bool [S]: the SHIP observer (sampler) sets."""
    return torch.as_tensor(
        (np.arange(cfg.num_sets) & ((1 << cfg.sampler_shift) - 1)) == 0,
        device=device)


def _gather_way(a: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    return a.gather(-1, way[..., None])[..., 0]


def _table_add(table: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """``table`` [..., T] with ``vals`` added at ``idx`` (both [..., C]),
    each lane into its own table row (integer adds: order-free)."""
    t = table.shape[-1]
    if table.dim() == 1:
        return table.index_add(0, idx, vals)
    offs = torch.arange(table.shape[0], device=table.device)[:, None] * t
    return table.reshape(-1).index_add(
        0, (idx + offs).reshape(-1), vals.reshape(-1)).reshape(table.shape)


def round_transition(cfg: LLCConfig, knobs: LaneKnobs, sampler_j,
                     rows, shct, line, meta, tick):
    """THE per-round LLC transition on [..., C, W] state rows: one lane
    ([C, W]) or a lane batch ([L, C, W], knobs from ``lane_knobs``).

    ``rows`` is ``(tags, lru, owner, sig, reused)``; ``shct`` is
    ``(shct_core, shct_accel)`` ([..., T]); ``sampler_j`` is the bool
    sampler-set mask for the C rows; ``line``/``meta`` are [..., C];
    ``tick`` is the already-advanced round tick, shaped to broadcast
    against [..., C, W].  Returns ``(new_rows, new_shct, stat_masks
    [10, ..., C] bool, hits [..., C] bool, misses [..., C] bool, src
    [..., C] int64)``: the per-set events each stat and per-core counter
    counts this round."""
    tags, lru, owner, sig, reused = rows
    shct_core0, shct_accel0 = shct
    w = cfg.ways
    cmax = cfg.ship.counter_max
    imax = np.iinfo(np.int32).max
    dev = tags.device
    wr = torch.arange(w, dtype=torch.int64, device=dev)
    accel_ship = knobs.accel_mode == A_SHIP
    shared = knobs.shared_predictor

    valid = (meta & M_VALID) != 0
    is_accel = (meta & M_ACCEL) != 0
    write = (meta & M_WRITE) != 0
    hint = (meta & M_HINT) != 0
    prefetch = (meta & M_PREFETCH) != 0
    dlok = (meta & M_DLOK) != 0
    src = ((meta >> M_SRC_SHIFT) & 0x7).to(torch.int64)

    hit_vec = (tags == line[..., None]) & (tags != -1)       # [..., C, W]
    hit = hit_vec.any(-1) & valid
    way_hit = torch.argmax(hit_vec.to(torch.uint8), -1)

    sig_e = ship_mod.signature(line, cfg.ship)
    pred_dead_core = shct_core0.gather(-1, sig_e) == 0
    if isinstance(shared, torch.Tensor):
        pred_dead_accel = torch.where(
            shared, pred_dead_core, shct_accel0.gather(-1, sig_e) == 0)
        byp_accel = torch.where(accel_ship, pred_dead_accel,
                                hint & (knobs.accel_mode != A_NONE))
        byp_core = pred_dead_core & knobs.core_bypass
    else:
        pred_dead_accel = (pred_dead_core if shared
                           else shct_accel0.gather(-1, sig_e) == 0)
        if accel_ship:
            byp_accel = pred_dead_accel
        elif knobs.accel_mode == A_NONE:
            byp_accel = torch.zeros_like(hint)
        else:
            byp_accel = hint
        byp_core = (pred_dead_core if knobs.core_bypass
                    else torch.zeros_like(pred_dead_core))
    byp_accel = byp_accel & dlok
    bypass = torch.where(is_accel, byp_accel, byp_core) & valid & ~prefetch
    # SHIP-driven bypasses never apply in observer (sampler) sets;
    # LERN/random hints are unaffected (offline predictions).
    ship_driven = torch.where(is_accel, accel_ship, knobs.core_bypass)
    bypass = bypass & ~(sampler_j & ship_driven)

    # --- hit path ----------------------------------------------------
    inval = is_accel & write & bypass & hit
    served_hit = hit & ~inval
    # --- miss path -----------------------------------------------------
    do_insert = (~hit) & (~bypass) & valid
    allowed = torch.where((is_accel | prefetch)[..., None],
                          knobs.accel_ways, knobs.core_ways)
    empty = (tags == -1) & allowed
    has_empty = empty.any(-1)
    first_empty = torch.argmax(empty.to(torch.uint8), -1)
    victim_lru = torch.argmin(torch.where(allowed, lru, imax), -1)
    victim = torch.where(has_empty, first_empty, victim_lru)
    vic_tag = _gather_way(tags, victim)
    vic_reused = _gather_way(reused, victim)
    vic_sig = _gather_way(sig, victim)
    vic_owner = _gather_way(owner, victim)
    evict_valid = do_insert & ~has_empty & (vic_tag != -1)

    # --- state update (one-hot masks over ways) ------------------------
    upd_way = torch.where(served_hit, way_hit, victim)
    onehot = upd_way[..., None] == wr                        # [..., C, W]
    ins_mask = onehot & do_insert[..., None]
    inval_mask = (way_hit[..., None] == wr) & inval[..., None]
    touch_mask = onehot & (served_hit | do_insert)[..., None]

    new_tags = torch.where(inval_mask, -1,
                           torch.where(ins_mask, line[..., None], tags))
    new_lru = torch.where(touch_mask, tick, lru)
    new_owner = torch.where(ins_mask, is_accel[..., None].to(torch.int32),
                            owner)
    new_sig = torch.where(ins_mask, sig_e[..., None].to(torch.int32), sig)
    new_reused = torch.where(onehot & (served_hit & ~prefetch)[..., None],
                             True, torch.where(ins_mask, False, reused))

    # --- SHIP table updates (batched per round; integer adds) -----------
    hit_sig = _gather_way(sig, way_hit)
    hit_owner = _gather_way(owner, way_hit)
    inc = served_hit & ~prefetch & sampler_j
    dec = evict_valid & ~vic_reused & sampler_j
    upd_idx = torch.where(inc, hit_sig, vic_sig).to(torch.int64)
    delta = torch.where(inc, 1, torch.where(dec, -1, 0)).to(torch.int32)
    own_accel = torch.where(inc, hit_owner, vic_owner) == 1
    to_accel_tbl = own_accel & (~shared if isinstance(shared, torch.Tensor)
                                else not shared)
    shct_core = torch.clamp(_table_add(
        shct_core0, upd_idx, torch.where(to_accel_tbl, 0, delta)), 0, cmax)
    shct_accel = torch.clamp(_table_add(
        shct_accel0, upd_idx, torch.where(to_accel_tbl, delta, 0)), 0, cmax)

    v = valid & ~prefetch
    ca = is_accel
    core_hit = v & ~ca & served_hit
    core_miss = v & ~ca & ~hit
    masks = torch.stack([
        core_hit, core_miss, core_miss & bypass,
        v & ca & served_hit, v & ca & ~served_hit,
        v & ca & bypass & ~served_hit,
        v & ca & write & bypass, evict_valid,
        valid & prefetch & do_insert, inval,
    ])
    return ((new_tags, new_lru, new_owner, new_sig, new_reused),
            (shct_core, shct_accel), masks, core_hit, core_miss, src)


def round_step(cfg: LLCConfig, knobs: LaneKnobs, sampler_j, rows, shct,
               line, meta, tick, cols=None):
    """One round of ``round_transition`` on a lane batch's full [L, S, W]
    state (the counterpart of the JAX ``llc.round_step_fn``), or, with
    ``cols`` (int64 [C] set indices), on those columns only: their rows
    are gathered, advanced and written back.  Every other column's event
    must be padding (meta 0): a no-op, so the result is bitwise the
    full-width round's, as the JAX fused engine's prefix slices are.
    ``line``/``meta`` are [L, S]; ``tick`` broadcasts against [L, S, W].
    Returns ``round_transition``'s tuple, its per-set outputs over the
    columns it ran."""
    if cols is None:
        return round_transition(cfg, knobs, sampler_j, rows, shct, line,
                                meta, tick)
    sub = tuple(x.index_select(1, cols) for x in rows)
    new_sub, shct, masks, ch, cm, src = round_transition(
        cfg, knobs, sampler_j[cols], sub, shct, line.index_select(1, cols),
        meta.index_select(1, cols), tick)
    new_rows = tuple(x.index_copy(1, cols, y) for x, y in zip(rows, new_sub))
    return new_rows, shct, masks, ch, cm, src


def simulate_epoch(cfg: LLCConfig, state: LLCState, line_m, meta_m,
                   device="cuda"
                   ) -> Tuple[LLCState, torch.Tensor, torch.Tensor]:
    """Run one chunk of an epoch (round-major [R, S] int32 event matrices)
    through the LLC on ``device``, where ``state`` lives: R rounds of
    ``round_transition``, through ``kernels.llc_rounds`` (one kernel
    launch on the card, updating ``state`` in place; the plain loop on the
    CPU).

    Returns (state, stats[len(STAT_NAMES)] int32, percore[NUM_CORES, 2]
    (hits, misses) int32), all on the state's device.  Nothing here waits
    for the device."""
    from ..kernels.llc_rounds import ops  # deferred: ops imports this module
    dev = _device.resolve(device)
    if state.tags.device.type != dev.type:
        raise ValueError(f"LLC state is on {state.tags.device}, not {dev}")
    return ops.rounds_one(cfg, state, torch.as_tensor(line_m, device=dev),
                          torch.as_tensor(meta_m, device=dev))


def simulate_epoch_lanes(cfg: LLCConfig, knobs: LaneKnobs, states: LLCState,
                         line_b, meta_b, device="cuda"
                         ) -> Tuple[LLCState, torch.Tensor, torch.Tensor]:
    """Lane-batched epoch chunk: L policies advance through one round
    loop (one kernel launch on the card) whose every op carries the lane
    axis.

    ``cfg`` supplies the shared geometry (any lane's config: the caller
    guarantees ``geometry_key`` agreement); ``knobs`` (``lane_knobs``) and
    ``states`` (``stack_states``) carry a leading lane axis, as do the
    [L, R, S] int32 event blocks.  Rounds a lane does not use are padding
    (line -1, meta 0): no-ops for its cache content.  Returns (states,
    stats [L, len(STAT_NAMES)] int32, percore [L, NUM_CORES, 2] int32) on
    the states' device, enqueued only."""
    from ..kernels.llc_rounds import ops  # deferred: ops imports this module
    dev = _device.resolve(device)
    if states.tags.device.type != dev.type:
        raise ValueError(f"LLC states are on {states.tags.device}, "
                         f"not {dev}")
    return ops.rounds(cfg, knobs, states, torch.as_tensor(line_b, device=dev),
                      torch.as_tensor(meta_b, device=dev))


def occupancy(state: LLCState) -> Tuple[int, int]:
    """(core_lines, accel_lines) currently valid (paper Fig. 14), fetched
    from the device in one copy."""
    valid = state.tags != -1
    accel = valid & (state.owner == 1)
    counts = torch.stack([(valid & ~accel).sum(), accel.sum()]).cpu()
    return (int(counts[0]), int(counts[1]))


def pack_meta(is_accel, write, hint, prefetch, dlok, src) -> np.ndarray:
    """Build the meta bitfield for build_rounds (all inputs bool/int arrays)."""
    return (M_VALID
            | np.where(is_accel, M_ACCEL, 0)
            | np.where(write, M_WRITE, 0)
            | np.where(hint, M_HINT, 0)
            | np.where(prefetch, M_PREFETCH, 0)
            | np.where(dlok, M_DLOK, 0)
            | (np.asarray(src, np.int32) << M_SRC_SHIFT)).astype(np.int32)


# ---------------------------------------------------------------------------
# Pure-Python reference (oracle for tests) — same semantics, serial.
# events: iterable of (line, is_accel, write, hint, prefetch, valid, src)
# ---------------------------------------------------------------------------
def ref_simulate(cfg: LLCConfig, events, accel_switch_point: int = -1,
                 shct_core=None, shct_accel=None) -> Dict[str, int]:
    S, W = cfg.num_sets, cfg.ways
    tags = [[-1] * W for _ in range(S)]
    lru = [[0] * W for _ in range(S)]
    owner = [[0] * W for _ in range(S)]
    sig = [[0] * W for _ in range(S)]
    reused = [[False] * W for _ in range(S)]
    tick = 0
    cmax = cfg.ship.counter_max
    tc = [cfg.ship.init_value] * cfg.ship.entries if shct_core is None else shct_core
    ta = tc if cfg.shared_predictor else (
        [cfg.ship.init_value] * cfg.ship.entries if shct_accel is None else shct_accel)
    core_ways = _mask_to_vec(cfg.core_way_mask, W)
    accel_ways = _mask_to_vec(cfg.accel_way_mask, W)
    stats = {k: 0 for k in STAT_NAMES}
    accel_seen = 0

    for (line, is_accel, write, hint, prefetch, valid, *_src) in events:
        if not valid:
            continue
        s = line & (S - 1)
        is_sampler = (s & ((1 << cfg.sampler_shift) - 1)) == 0
        hit_way = next((i for i in range(W) if tags[s][i] == line), -1)
        hit = hit_way >= 0
        sg = int(ship_mod.signature_np(np.array([line]), cfg.ship)[0])
        if is_accel:
            accel_seen += 1
        deadline_ok = accel_seen > accel_switch_point
        if is_accel:
            if cfg.accel_mode == A_NONE:
                byp = False
            elif cfg.accel_mode in (A_HINT, A_RAND):
                byp = bool(hint)
            else:
                byp = ta[sg] == 0 and not is_sampler
            byp = byp and deadline_ok
        else:
            byp = cfg.core_bypass and tc[sg] == 0 and not is_sampler
        if prefetch:
            byp = False

        tick += 1
        inval = is_accel and write and byp and hit
        if hit and not inval:
            lru[s][hit_way] = tick
            if not prefetch:
                if is_sampler:
                    t = tc if (owner[s][hit_way] == 0 or cfg.shared_predictor) else ta
                    t[sig[s][hit_way]] = min(t[sig[s][hit_way]] + 1, cmax)
                reused[s][hit_way] = True
                if is_accel:
                    stats["accel_hits"] += 1
                else:
                    stats["core_hits"] += 1
            continue
        if inval:
            tags[s][hit_way] = -1
            stats["invalidations"] += 1
        if not prefetch:
            if is_accel:
                stats["accel_misses"] += 1
                if byp:
                    stats["accel_bypasses"] += 1
                    if write:
                        stats["accel_writes_bypassed"] += 1
            else:
                stats["core_misses"] += 1
                if byp:
                    stats["core_bypasses"] += 1
        if byp:
            continue
        allowed = accel_ways if (is_accel or prefetch) else core_ways
        empties = [i for i in range(W) if tags[s][i] == -1 and allowed[i]]
        if empties:
            v = empties[0]
        else:
            v = min((i for i in range(W) if allowed[i]), key=lambda i: lru[s][i])
            if tags[s][v] != -1:
                stats["evictions"] += 1
                if not reused[s][v] and is_sampler:
                    t = tc if (owner[s][v] == 0 or cfg.shared_predictor) else ta
                    t[sig[s][v]] = max(t[sig[s][v]] - 1, 0)
        tags[s][v] = line
        lru[s][v] = tick
        owner[s][v] = 1 if is_accel else 0
        sig[s][v] = sg
        reused[s][v] = False
        if prefetch:
            stats["prefetch_fills"] += 1
    return stats
