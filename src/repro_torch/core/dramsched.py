"""Batched bank/rank DRAM scheduler (FR-FCFS / SQUASH-style) -- the timing
backend behind :class:`repro_torch.core.dram.SchedDramModel`.

The model is epoch-granularity but bank-accurate: each epoch the lane's
accelerator DRAM traffic is represented by ``samples`` strided line
addresses from its access window, with integer weights that partition the
epoch's miss count exactly.  Per bank the model tracks the open row and a
backlog counter (cycles of unserved service), charges row-buffer
hit / closed-row / conflict costs (tCAS / tRCD+tCAS / tRP+tRCD+tCAS),
spreads the core's misses round-robin across banks at conflict cost,
models rank-level bus contention over the epoch window, and resets the
row table every ``reset_period`` epochs.  Arbitration between the
accelerator and core streams is either shared FCFS (FR-FCFS
approximation) or SQUASH-style: when the lane is deadline-urgent the
accelerator stream is served first and the core waits behind it,
otherwise the roles flip.

Everything is int64 until two final float64 divisions (exact: the
numerators stay far below 2^53), and ``epoch_compute`` has one body for
two array modules: numpy (``xp=np``, one lane, the host oracle of
``sim.Lane``) and torch (``xp=torch``, a leading lane axis on every
array, the fused engine's carry on the card).  Only the two scatter
helpers dispatch, and both are order-free integer reductions, so the
twins agree bitwise.  The per-lane state is three arrays:

* ``row``   int64[banks]  -- open row per bank, ``-1`` = closed
* ``queue`` int64[banks]  -- backlog cycles carried into the next epoch
* ``rr``    int64 scalar  -- round-robin rotor for spreading core misses
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .dram import SchedDramModel


class SchedDims(NamedTuple):
    """Static geometry of a scheduled DRAM model (the shapes of the bank
    state).  Cycle costs and the scheduler kind are data (``timing_tuple``),
    so two models sharing a ``SchedDims`` share a fused carry layout."""
    n_banks: int
    n_ranks: int
    n_samples: int
    col_bits: int

    @property
    def bank_bits(self) -> int:
        return (self.n_banks - 1).bit_length()


def sched_dims(model: SchedDramModel) -> SchedDims:
    return SchedDims(n_banks=model.banks, n_ranks=model.ranks,
                     n_samples=model.samples, col_bits=model.col_bits)


def timing_tuple(model: SchedDramModel):
    """The model's data-side parameters, as plain ints in the order
    ``epoch_compute`` consumes them: (t_cas, t_rcd, t_rp, t_bus,
    reset_period, queue_cap, kind) with kind 0=frfcfs, 1=squash."""
    return (int(model.t_cas), int(model.t_rcd), int(model.t_rp),
            int(model.t_bus), int(model.reset_period), int(model.queue_cap),
            1 if model.scheduler == "squash" else 0)


def _arange(xp, n, like):
    if xp is np:
        return np.arange(n, dtype=np.int64)
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _take_last(a, idx):
    """``a[..., idx[..., j]]`` along the last axis (a per-lane gather)."""
    if isinstance(a, np.ndarray):
        return np.take_along_axis(a, idx, -1)
    return torch.take_along_dim(a, idx, -1)


def _lead_offsets(vals, size):
    """Flat offsets of each leading-axes row of ``vals`` into a
    [..., size] buffer, broadcast against ``vals``."""
    n = vals.numel() // vals.shape[-1]
    offs = torch.arange(n, dtype=torch.int64, device=vals.device) * size
    return offs.reshape(vals.shape[:-1] + (1,))


def _scatter_add(xp, size, idx, vals):
    """``out[..., idx[j]] += vals[..., j]`` into zeros [..., size]."""
    if xp is np:
        out = np.zeros(size, np.int64)
        np.add.at(out, idx, vals)
        return out
    out = torch.zeros(vals.shape[:-1] + (size,), dtype=torch.int64,
                      device=vals.device)
    flat = (idx + _lead_offsets(vals, size)).expand(vals.shape)
    out.view(-1).index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out


def _scatter_max(xp, size, fill, idx, vals):
    """``out[..., idx[j]] = max(out[..., idx[j]], vals[..., j])`` over a
    [..., size] buffer filled with ``fill`` (an index no value reaches
    keeps ``fill``, as ``np.maximum.at`` leaves it)."""
    if xp is np:
        out = np.full(size, fill, np.int64)
        np.maximum.at(out, idx, vals)
        return out
    out = torch.full(vals.shape[:-1] + (size,), fill, dtype=torch.int64,
                     device=vals.device)
    return out.scatter_reduce_(-1, idx.expand(vals.shape), vals, "amax",
                               include_self=True)


def epoch_compute(xp, dims: SchedDims, timing, orow, queue, rr,
                  samp, am, cm, pf, urgent, epoch, et_i):
    """One epoch of the bank/rank model.  Pure int64.

    ``xp`` is ``numpy`` (one lane: ``orow``/``queue`` int64[banks], the
    others int64 scalars or 0-d arrays, ``urgent`` a bool) or ``torch``
    (a leading lane axis: [L, banks], [L, samples] and [L] tensors).
    Inputs: ``timing`` per :func:`timing_tuple` (plain ints); ``orow`` /
    ``queue`` / ``rr`` the lane state; ``samp`` the line addresses sampled
    from the accel window; ``am``/``cm``/``pf`` accel / core / prefetch
    DRAM lines this epoch; ``urgent`` SQUASH deadline urgency; ``epoch``;
    ``et_i`` the epoch length in cycles.

    Returns ``(num_a, den_a, num_c, den_c, orow', queue', rr')`` -- the
    average extra DRAM wait per access is ``num / den`` (exact in f64).
    """
    nb, nr, ns = dims.n_banks, dims.n_ranks, dims.n_samples
    t_cas, t_rcd, t_rp, t_bus, reset_period, queue_cap, kind = timing
    if xp is np:
        orow, queue, samp = (np.asarray(a, np.int64)
                             for a in (orow, queue, samp))
        rr, am, cm, pf, epoch, et_i = (np.asarray(a, np.int64) for a in
                                       (rr, am, cm, pf, epoch, et_i))
        urgent = np.asarray(urgent, bool)
    neg1 = np.int64(-1) if xp is np else -1

    # Periodic row-table reset (counter-table decay idiom): banks start the
    # epoch closed, so the first access per bank re-pays activation.
    do_reset = (epoch % reset_period) == 0
    orow = xp.where(do_reset[..., None], neg1, orow)

    # Exact integer partition of am over the samples: w_i sums to am, and
    # every sample with w_i > 0 is "present" this epoch.
    ii = _arange(xp, ns, samp)
    w = ((ii + 1) * am[..., None]) // ns - (ii * am[..., None]) // ns
    present = w > 0

    bank = (samp >> dims.col_bits) & (nb - 1)
    srow = samp >> (dims.col_bits + dims.bank_bits)

    # Row seen by sample i = the last present earlier sample on the same
    # bank, else the bank's open row.  O(ns^2) mask instead of a sequential
    # scan -- ns is small (32) and the body stays data-parallel.
    same_bank = bank[..., :, None] == bank[..., None, :]
    before = ii[None, :] < ii[:, None]
    lastj = xp.where(same_bank & before & (w[..., None, :] > 0),
                     ii[None, :], neg1).max(-1)
    if xp is not np:
        lastj = lastj.values
    prev = xp.where(lastj >= 0, _take_last(srow, xp.clip(lastj, 0, ns - 1)),
                    _take_last(orow, bank))

    # Burst cost per sample: first line pays hit / closed / conflict, the
    # remaining w-1 lines of the burst stream at CAS rate.
    hit = (prev >= 0) & (prev == srow)
    first = xp.where(hit, t_cas,
                     xp.where(prev < 0, t_rcd + t_cas, t_rp + t_rcd + t_cas))
    cost = xp.where(present, first + (w - 1) * t_cas, 0 * w)

    a_svc = _scatter_add(xp, nb, bank, cost)       # accel service, per bank
    a_load = _scatter_add(xp, nb, bank, w)         # accel lines, per bank

    # Core misses spread round-robin (rotor ``rr``) across banks, each at
    # conflict cost -- the core's stride is opaque at this granularity, so
    # it is modeled as always closing the accelerator's rows.
    bidx = _arange(xp, nb, samp)
    c_load = (cm[..., None] // nb
              + (((bidx - rr[..., None] % nb) % nb) < cm[..., None] % nb))
    c_svc = c_load * (t_rp + t_rcd + t_cas)

    # Rank-level bus contention: lines x t_bus over the epoch window; the
    # overflow beyond the window is charged back per line on that rank.
    # Prefetch fills ride the bus but skip the bank queues (issued early).
    rank_of = bidx // (nb // nr)
    pf_r = (pf[..., None] // nr
            + (_arange(xp, nr, samp) < pf[..., None] % nr))
    r_load = _scatter_add(xp, nr, rank_of, a_load + c_load) + pf_r
    over = xp.clip(r_load * t_bus - et_i[..., None], 0, None)
    pen = (over // xp.clip(r_load, 1, None))[..., rank_of]

    # Arbitration.  FR-FCFS approximation: one shared queue per bank, the
    # average arrival waits behind the backlog plus half the epoch's
    # service.  SQUASH: the urgent stream goes first (waits behind backlog
    # + half its own service), the other waits behind all of it.
    if kind == 1:
        urg = urgent[..., None]
        wa = xp.where(urg, queue + a_svc // 2, queue + c_svc + a_svc // 2)
        wc = xp.where(urg, queue + a_svc + c_svc // 2, queue + c_svc // 2)
    else:
        wa = wc = queue + (a_svc + c_svc) // 2
    wa = wa + pen
    wc = wc + pen

    num_a = (wa * a_load).sum(-1)
    num_c = (wc * c_load).sum(-1)
    den_a = xp.clip(am, 1, None)
    den_c = xp.clip(cm, 1, None)

    # State advance: backlog carries unserved cycles (clamped), the open
    # row per bank becomes the last present sample's row, rotor rotates.
    queue2 = xp.clip(queue + a_svc + c_svc - et_i[..., None], 0, queue_cap)
    last = _scatter_max(xp, nb, -1, bank, xp.where(present, ii, neg1))
    orow2 = xp.where(last >= 0, _take_last(srow, xp.clip(last, 0, ns - 1)),
                     orow)
    rr2 = (rr + cm) % nb

    return num_a, den_a, num_c, den_c, orow2, queue2, rr2


@dataclasses.dataclass
class HostState:
    """Mutable per-lane host twin of the fused carry's bank-state block."""
    row: np.ndarray     # int64[banks], -1 = closed
    queue: np.ndarray   # int64[banks], backlog cycles
    rr: int             # round-robin rotor for core-miss spreading


def host_init(model: SchedDramModel) -> HostState:
    return HostState(row=np.full(model.banks, -1, np.int64),
                     queue=np.zeros(model.banks, np.int64), rr=0)


def sample_window(line: np.ndarray, pos: int, n_a: int, ns: int) -> np.ndarray:
    """``ns`` strided line addresses from the access window
    ``line[pos : pos + n_a]`` (host side; the fused engine gathers the same
    indices from the staged trace)."""
    si = np.arange(ns, dtype=np.int64)
    idx = pos + (si * np.int64(n_a)) // ns
    return np.asarray(line, np.int64)[idx]


def host_epoch(state: HostState, model: SchedDramModel, samp: np.ndarray,
               am: int, cm: int, pf: int, urgent: bool, epoch: int,
               et_i: int):
    """Advance ``state`` one epoch; returns the uncapped average extra
    DRAM wait ``(w_accel, w_core)`` as floats -- bitwise the fused
    engine's ``num/den`` division (both exact below 2^53)."""
    num_a, den_a, num_c, den_c, row2, queue2, rr2 = epoch_compute(
        np, sched_dims(model), timing_tuple(model),
        state.row, state.queue, np.int64(state.rr),
        np.asarray(samp, np.int64), np.int64(am), np.int64(cm),
        np.int64(pf), bool(urgent), np.int64(epoch), np.int64(et_i))
    state.row = row2
    state.queue = queue2
    state.rr = int(rr2)
    return float(num_a) / float(den_a), float(num_c) / float(den_c)
