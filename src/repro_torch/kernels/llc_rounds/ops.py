"""The LLC round loop of an epoch chunk: wrappers, plain versions and the
launch counter.

No TPU kernel computes this: the JAX package runs the round loop as plain
JAX (``repro/core/llc.py::round_transition`` :213 under ``lax.scan`` in
``simulate_epoch(_lanes)``, and under the ``lax.while_loop`` of
``repro/core/fused.py::_run_rounds_batch`` :496).  The plain versions
below are the port's round loops (one ``llc.round_transition`` a round,
about 70 small torch ops); on the card each chunk is one launch of
``csrc/llc_rounds.cu``'s cluster kernel (one thread-block cluster a lane,
the set rows in shared memory, a way-parallel search, the SHCT tables
replicated in every CTA and their deltas posted through distributed
shared memory), bound by the chain of its R dependent rounds, not by
bytes.  If the cluster launch is refused the wrapper raises; the first
design (``kernel.launch_simple``) is on no path.

``rounds`` (a lane batch) and ``rounds_one`` (one lane) take the plain
version for CPU tensors and launch the kernel for CUDA tensors or raise;
``rounds.launches`` counts the launches of both.  On the card the state
is updated in place and returned.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import llc
from . import kernel

# the first design (kernel.launch_simple) holds a thread's per-core counts
# in 16 bits; both designs take the same range
MAX_ROUNDS = (1 << 16) // 4 - 1
MAX_SETS = 4096
_KNOBS = {}


def epoch_plain(cfg, state, line_m, meta_m):
    """One lane's chunk (round-major [R, S] int32 events) as a Python loop
    of ``llc.round_transition`` with the lane's knobs as constants.
    Returns (state, stats [10] int32, percore [8, 2] int32)."""
    dev = state.tags.device
    knobs = llc._const_knobs(cfg, dev)
    sampler_j = llc._sampler(cfg, dev)
    s = cfg.num_sets
    rows = (state.tags, state.lru, state.owner, state.sig, state.reused)
    shct = (state.shct_core, state.shct_accel)
    counts = torch.zeros((len(llc.STAT_NAMES), s), dtype=torch.int32,
                         device=dev)
    percore = torch.zeros((llc.NUM_CORES, 2), dtype=torch.int32, device=dev)
    tick = state.tick
    for r in range(line_m.shape[0]):
        tick = tick + 1
        rows, shct, masks, ch, cm, src = llc.round_transition(
            cfg, knobs, sampler_j, rows, shct, line_m[r], meta_m[r], tick)
        counts += masks
        percore.index_add_(0, src, torch.stack([ch, cm], 1).to(torch.int32))
    stats = counts.sum(1, dtype=torch.int32)
    return llc.LLCState(*rows, tick, *shct), stats, percore


def lanes_plain(cfg, knobs, states, line_b, meta_b, n_rounds=None,
                sparse_cap: int = 0):
    """A lane batch's chunk ([L, R, S] int32 events) as one Python loop of
    ``llc.round_transition`` whose every op carries the lane axis.

    With ``n_rounds`` (int32 [L]) the loop runs max(n_rounds) rounds, the
    fused engine's count; else all R.  The tick advances on every round it
    runs.  With ``sparse_cap`` a round whose occupied columns (any lane's
    valid event) number at most ``sparse_cap`` runs on those columns only
    (``llc.round_step``): the other columns' events are padding, no-ops,
    so the result is bitwise the full-width round's.  Returns (states,
    stats [L, 10] int32, percore [L, 8, 2] int32)."""
    dev = states.tags.device
    n_lanes, s = line_b.shape[0], cfg.num_sets
    n_r = line_b.shape[1]
    if n_rounds is not None:
        n_r = min(int(n_rounds.max()) if n_rounds.numel() else 0, n_r)
    sampler_j = llc._sampler(cfg, dev)
    rows = (states.tags, states.lru, states.owner, states.sig, states.reused)
    shct = (states.shct_core, states.shct_accel)
    counts = torch.zeros((len(llc.STAT_NAMES), n_lanes, s),
                         dtype=torch.int32, device=dev)
    percore = torch.zeros((n_lanes * llc.NUM_CORES, 2), dtype=torch.int32,
                          device=dev)
    core_offs = torch.arange(n_lanes, device=dev)[:, None] * llc.NUM_CORES
    tick = states.tick
    for r in range(n_r):
        tick = tick + 1
        cols = None
        if sparse_cap:
            occupied = ((meta_b[:, r] & llc.M_VALID) != 0).any(0)
            cols = occupied.nonzero()[:, 0]
            if cols.numel() > sparse_cap:
                cols = None
        rows, shct, masks, ch, cm, src = llc.round_step(
            cfg, knobs, sampler_j, rows, shct, line_b[:, r], meta_b[:, r],
            tick[:, None, None], cols)
        if cols is None:
            counts += masks
        else:
            counts.index_add_(2, cols, masks.to(torch.int32))
        percore.index_add_(0, (src + core_offs).reshape(-1),
                           torch.stack([ch, cm], -1).reshape(-1, 2).to(
                               torch.int32))
    stats = counts.sum(2, dtype=torch.int32).T
    return (llc.LLCState(*rows, tick, *shct), stats,
            percore.reshape(n_lanes, llc.NUM_CORES, 2))


def pack_knobs(knobs) -> torch.Tensor:
    """A lane batch's ``llc.LaneKnobs`` as the kernel's int32 [L, 5]
    (accel mode, core bypass, shared predictor, core and accel way masks
    as bit fields), computed on the knobs' device."""
    w = knobs.core_ways.shape[-1]
    dev = knobs.core_ways.device
    bits = torch.bitwise_left_shift(
        torch.ones(w, dtype=torch.int64, device=dev),
        torch.arange(w, dtype=torch.int64, device=dev))
    return torch.cat([
        knobs.accel_mode.to(torch.int64),
        knobs.core_bypass.to(torch.int64),
        knobs.shared_predictor.to(torch.int64),
        (knobs.core_ways.to(torch.int64) * bits).sum(-1),
        (knobs.accel_ways.to(torch.int64) * bits).sum(-1)], -1).to(
            torch.int32).contiguous()


def config_knobs(cfg, device) -> torch.Tensor:
    """One lane's knobs (from its LLCConfig) as the kernel's int32 [1, 5],
    made once per (config, device)."""
    key = (cfg, str(device))
    t = _KNOBS.get(key)
    if t is None:
        mask = (1 << cfg.ways) - 1
        vals = [int(cfg.accel_mode), int(cfg.core_bypass),
                int(cfg.shared_predictor), int(cfg.core_way_mask) & mask,
                int(cfg.accel_way_mask) & mask]
        t = _KNOBS[key] = torch.tensor(
            [[v - (1 << 32) if v >= 1 << 31 else v for v in vals]],
            dtype=torch.int32, device=device)
    return t


def _check_cuda(cfg, states, line_b, meta_b, n_rounds, knobs) -> None:
    n_lanes, r, s = line_b.shape
    want = {"line": line_b, "meta": meta_b, "tags": states.tags,
            "lru": states.lru, "owner": states.owner, "sig": states.sig,
            "tick": states.tick, "shct_core": states.shct_core,
            "shct_accel": states.shct_accel, "knobs": knobs}
    if n_rounds is not None:
        want["n_rounds"] = n_rounds
    want_dev = line_b.device
    for name, t in list(want.items()) + [("reused", states.reused)]:
        if t.device != want_dev or not t.is_contiguous():
            raise ValueError(f"llc_rounds: {name} must be contiguous on "
                             f"{want_dev}")
        if name != "reused" and t.dtype != torch.int32:
            raise ValueError(f"llc_rounds: {name} must be int32")
    if states.reused.dtype != torch.bool:
        raise ValueError("llc_rounds: reused must be bool")
    w, t = cfg.ways, cfg.ship.entries
    if (meta_b.shape != line_b.shape or s != cfg.num_sets
            or states.tags.shape != (n_lanes, s, w)
            or any(x.shape != (n_lanes, s, w) for x in (
                states.lru, states.owner, states.sig, states.reused))
            or states.tick.shape != (n_lanes,)
            or states.shct_core.shape != (n_lanes, t)
            or states.shct_accel.shape != (n_lanes, t)
            or knobs.shape != (n_lanes, 5)
            or (n_rounds is not None and n_rounds.shape != (n_lanes,))):
        raise ValueError("llc_rounds: shapes disagree with the config")
    if not (0 < w <= 32 and s <= MAX_SETS and r <= MAX_ROUNDS):
        raise ValueError(f"llc_rounds: W = {w}, S = {s}, R = {r} outside "
                         f"the kernel's range (W <= 32, S <= {MAX_SETS}, "
                         f"R <= {MAX_ROUNDS})")


def rounds(cfg, knobs, states, line_b, meta_b,
           n_rounds: Optional[torch.Tensor] = None, sparse_cap: int = 0):
    """A lane batch's epoch chunk: ``states`` (``llc.stack_states``) and the
    [L, R, S] int32 events on one device, ``knobs`` an ``llc.LaneKnobs`` of
    the batch or the kernel's packed int32 [L, 5] (``pack_knobs``).
    ``n_rounds`` (int32 [L]) runs max(n_rounds) rounds instead of R.
    Returns (states, stats [L, 10] int32, percore [L, 8, 2] int32).

    A CPU tensor takes ``lanes_plain`` (``sparse_cap`` applies there
    only); a CUDA tensor launches the kernel once, updating the state in
    place, or raises."""
    if not line_b.is_cuda:
        if line_b.device.type != "cpu":
            raise ValueError(f"llc_rounds: unsupported device "
                             f"{line_b.device}")
        return lanes_plain(cfg, knobs, states, line_b, meta_b, n_rounds,
                           sparse_cap)
    if isinstance(knobs, llc.LaneKnobs):
        knobs = pack_knobs(knobs)
    _check_cuda(cfg, states, line_b, meta_b, n_rounds, knobs)
    n_lanes = line_b.shape[0]
    stats = line_b.new_empty((n_lanes, len(llc.STAT_NAMES)))
    percore = line_b.new_empty((n_lanes, llc.NUM_CORES, 2))
    ship = cfg.ship
    kernel.launch(line_b, meta_b, knobs, n_rounds,
                  (states.tags, states.lru, states.owner, states.sig,
                   states.reused), states.tick, states.shct_core,
                  states.shct_accel, stats, percore, entries=ship.entries,
                  sampler_shift=cfg.sampler_shift,
                  region_lines=ship.region_lines,
                  counter_max=ship.counter_max)
    rounds.launches += 1
    return states, stats, percore


rounds.launches = 0


def rounds_one(cfg, state, line_m, meta_m):
    """One lane's epoch chunk: ``state`` (``llc.init_state``) and [R, S]
    int32 events on one device.  Returns (state, stats [10] int32,
    percore [8, 2] int32).  A CPU tensor takes ``epoch_plain``; a CUDA
    tensor is one launch of the kernel as a batch of one lane (counted in
    ``rounds.launches``), updating the state in place."""
    if not line_m.is_cuda:
        if line_m.device.type != "cpu":
            raise ValueError(f"llc_rounds: unsupported device "
                             f"{line_m.device}")
        return epoch_plain(cfg, state, line_m, meta_m)
    one = llc.LLCState(*(x.unsqueeze(0) if x.dim() else x.view(1)
                         for x in state))
    _, stats, percore = rounds(cfg, config_knobs(cfg, line_m.device), one,
                               line_m.unsqueeze(0), meta_m.unsqueeze(0))
    return state, stats[0], percore[0]


