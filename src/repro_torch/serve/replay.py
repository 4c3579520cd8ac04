"""Batched multi-tenant trace replay: thousands of concurrent sessions as
lanes of one super-step on the card (the JAX package's
``serve/replay.py``, ported; the ``core/fused.py`` idiom at the serving
layer).

Two engines replay a :class:`~repro_torch.serve.trace.SessionTrace`
through slot-limited admission and the HyDRA KV-residency scheduler:

* ``engine="host"``: a vectorized numpy step loop, the sequential oracle.
  Scheduler calls (``keep_resident`` per completion, ``epoch_update`` per
  scheduler epoch) happen inline.
* ``engine="batched"``: the same step math as torch ops on ``device``,
  one scheduler epoch (``dims.k`` steps) a super-step, every per-session
  register in the carry (slot occupancy, KV-residency bits, per-session
  ready clocks, integer latency/wait histograms), and ONE host read a
  super-step: the carry's scalars, both histograms and the epoch's
  ``[K, N]`` completion matrix come back in one transfer
  (:func:`_read`).  At each boundary the driver replays the completion
  matrix into the *real* :class:`HydraKVScheduler` in (step, session)
  order and restages the per-session (RC, RI) cluster ids whenever an
  online refit swapped the profile, so scheduler state, refit trajectory
  and thresholds are bitwise the host oracle's by construction.

Decision semantics shared by both engines (each numeric step is integer
arithmetic in int64; floats only appear in the host-side epoch signals,
computed from read integer counters with the same expressions):

1. **Arrivals/readiness**: a session is queued when its ready clock
   (arrival, or previous completion + think-time gap) has passed.
2. **Admission**: free slots are granted in deadline-urgency order
   (smallest slack first, session id as the tie-break: the SQUASH
   ordering) or FIFO (earliest-ready first); a returning session whose
   KV was evicted pays its prompt re-prefill, a resident one skips it
   and releases its parked tokens back to the pool.  Queued keys are
   unique (the session id sits in the low ``_SID_BITS`` bits) and every
   other key is ``_MAXKEY`` and masked by ``queued``, so any sort gives
   the reference's ``admit`` mask.
3. **Decode**: every occupied slot decodes one token per step.
4. **Completion**: latency is measured from the turn's ready time; a
   turn misses when latency exceeds its deadline.  Non-final turns ask
   the residency rule (paper bypass rule over staged cluster ids, or the
   keep-all / evict-all baselines) whether their KV parks in HBM,
   granted in session-id order against the token budget (a blocked
   reservation holds its place in the prefix sum: a fixed-priority
   arbiter without compaction).

Fault sites (``repro_torch.exp.faults``): ``serve_step`` fires once per
scheduler epoch in both engines; ``serve_admission`` fires per admitting
step on the host path and once per super-step dispatch on the batched
path.  ``serve.run`` degrades a faulted batched replay to the host oracle
(bitwise-identical results), mirroring the sim-side bucketed -> fused ->
host ladder.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..exp import faults
from .hydra_scheduler import HydraKVScheduler, SessionProfile
from .trace import SessionTrace

DONE = 1 << 62          # ready-clock sentinel: session finished all turns
HIST_BINS = 512         # wait/latency histograms, last bin clips
_SID_BITS = 21          # session-id tie-break bits in admission keys
_SLACK_OFF = 1 << 21
_MAXKEY = 1 << 62

_ADMISSIONS = ("urgency", "fifo")
_ENGINES = ("host", "batched")

# carry counter names (one int64 scalar each)
_COUNTERS = ("completed", "missed", "lat_sum", "dl_sum", "wait_sum",
             "admits", "reprefills", "decoded", "finished")
# the carry's scalars in the order :func:`_read` packs them
_SCALARS = _COUNTERS + ("now", "peak", "resident_tok")


def classify_sessions(profile: Optional[SessionProfile],
                      turns: np.ndarray, gap: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``SessionProfile.classify`` over whole-trace features
    (same argmin tie-breaking as the scalar path)."""
    n = turns.shape[0]
    if profile is None:
        return np.full(n, 2, np.int64), np.full(n, 1, np.int64)
    rc = np.argmin(np.abs(profile.rc_centers[None, :]
                          - turns[:, None].astype(np.float64)), axis=1)
    ri = np.argmin(np.abs(profile.ri_centers[None, :]
                          - gap[:, None].astype(np.float64)), axis=1)
    return rc.astype(np.int64), ri.astype(np.int64)


@dataclasses.dataclass
class ReplayResult:
    """Integer replay outcome (bitwise-comparable across engines)."""
    counters: Dict[str, int]
    wait_hist: np.ndarray
    lat_hist: np.ndarray
    engine: str

    def _hist_pct(self, hist: np.ndarray, pct_num: int = 99) -> float:
        total = int(hist.sum())
        if total == 0:
            return 0.0
        target = (pct_num * total + 99) // 100
        return float(np.searchsorted(np.cumsum(hist), target))

    def summary(self) -> Dict[str, float]:
        c = self.counters
        comp = max(c["completed"], 1)
        steps = max(c["steps"], 1)
        return {
            "completed_turns": float(c["completed"]),
            "finished_sessions": float(c["finished"]),
            "dmr": c["missed"] / comp,
            "p99_wait_steps": self._hist_pct(self.wait_hist),
            "p99_latency_steps": self._hist_pct(self.lat_hist),
            "mean_latency_steps": c["lat_sum"] / comp,
            "mean_wait_steps": c["wait_sum"] / max(c["admits"], 1),
            "throughput_tok_per_step": c["decoded"] / steps,
            "sessions_per_kstep": 1000.0 * c["finished"] / steps,
            "reprefills": float(c["reprefills"]),
            "peak_concurrent": float(c["peak_concurrent"]),
            "steps": float(c["steps"]),
        }


@dataclasses.dataclass(frozen=True)
class _Dims:
    """Static shape/config of one replay program."""
    n: int
    slots: int
    budget: int
    max_steps: int
    k: int              # steps per super-step == scheduler epoch length
    residency: str      # "hydra" | "keep-all" | "evict-all"
    admission: str      # "urgency" | "fifo"


def _epoch_signals(d_lat_sum: int, d_dl_sum: int, resident_tok: int,
                   budget: int) -> Dict[str, float]:
    """Scheduler epoch signals from integer per-epoch deltas: the same
    float expressions on the same ints in both engines.

    ``decoded_rate / required_rate`` plays the paper's predicted-progress
    vs requirement ratio: the deadline-budget sum of this epoch's
    completed turns over their actual latency sum.  >1 means turns are
    finishing with headroom (the scheduler can afford evicting KV and
    paying re-prefills); <1 means deadlines are being missed (keep KV
    resident: re-prefill work is what's sinking the deadlines)."""
    return {
        "decoded_rate": d_dl_sum / max(d_lat_sum, 1),
        "required_rate": 1.0,
        "hbm_pressure": resident_tok / max(budget, 1),
    }


def _init_carry(trace: SessionTrace) -> Dict:
    """The replay's starting registers (numpy; the batched engine moves
    them to its device)."""
    n = trace.n
    c = dict(now=0, ready=np.asarray(trace.arrival, np.int64),
             in_slot=np.zeros(n, bool),
             remaining=np.zeros(n, np.int64),
             turn=np.zeros(n, np.int64),
             resident=np.zeros(n, bool),
             resident_tok=0, peak=0,
             wait_hist=np.zeros(HIST_BINS, np.int64),
             lat_hist=np.zeros(HIST_BINS, np.int64))
    for k in _COUNTERS:
        c[k] = 0
    return c


def _result(carry, engine: str) -> ReplayResult:
    counters = {k: int(carry[k]) for k in _COUNTERS}
    counters["steps"] = int(carry["now"])
    counters["peak_concurrent"] = int(carry["peak"])
    counters["resident_tokens"] = int(carry["resident_tok"])
    return ReplayResult(counters=counters,
                        wait_hist=np.asarray(carry["wait_hist"]),
                        lat_hist=np.asarray(carry["lat_hist"]),
                        engine=engine)


def _feed_scheduler(sched: HydraKVScheduler, trace: SessionTrace,
                    comp: np.ndarray) -> None:
    """Replay an epoch's [K, N] completion matrix into the scheduler in
    (step, ascending session id) order: the exact call sequence the host
    oracle makes inline."""
    steps, sids = np.nonzero(comp)
    for s in sids:
        sched.keep_resident(float(trace.turns[s]), float(trace.gap[s]))


# ---------------------------------------------------------------------------
# batched engine: one scheduler epoch per super-step, torch ops on a device
# ---------------------------------------------------------------------------
def _superstep(dims: _Dims, consts: Dict[str, torch.Tensor],
               carry: Dict[str, torch.Tensor], rc_cl: torch.Tensor,
               ri_cl: torch.Tensor, ri_th: int, rc_th: int
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``dims.k`` replay steps on the carry's device -> (carry, [K, N]
    bool completion matrix).  Nothing here reads the card: every
    condition is a tensor (``live``, ``free``), every sum stays on the
    device, and the thresholds are the scheduler's Python ints (int64
    scalars), constant within a super-step."""
    sid = consts["sid"]
    arrival = consts["arrival"]
    turns = consts["turns"]
    gap = consts["gap"]
    prompt = consts["prompt"]
    decode = consts["decode"]
    deadline = consts["deadline"]
    kv = consts["kv"]
    ar = consts["arange"]
    if dims.residency == "hydra":
        keep_bit = ~((ri_cl > ri_th) | (rc_cl < rc_th))
    elif dims.residency == "keep-all":
        keep_bit = torch.ones_like(consts["arrival"], dtype=torch.bool)
    else:
        keep_bit = torch.zeros_like(consts["arrival"], dtype=torch.bool)
    c = dict(carry)
    comps = []
    for _ in range(dims.k):
        now = c["now"]
        ready = c["ready"]
        in_slot = c["in_slot"]
        resident = c["resident"]
        turn = c["turn"]
        live = (now < dims.max_steps) & (ready != DONE).any()

        # -- admission (urgency/FIFO order over the queued set) ----------
        queued = (~in_slot) & (ready <= now)
        free = dims.slots - in_slot.sum()
        wait = now - ready
        if dims.admission == "urgency":
            slack = torch.clamp(deadline - wait, -_SLACK_OFF + 1,
                                _SLACK_OFF - 1)
            keyv = ((slack + _SLACK_OFF) << _SID_BITS) | sid
        else:
            keyv = (torch.clamp(ready, 0, 1 << 40) << _SID_BITS) | sid
        keyv = keyv.masked_fill(~queued, _MAXKEY)
        order = torch.argsort(keyv)
        rank = torch.empty_like(order).scatter_(0, order, ar)
        admit = queued & (rank < free) & live

        admit_i = admit.long()
        wait_hist = c["wait_hist"].index_add(
            0, torch.clamp(wait, 0, HIST_BINS - 1), admit_i)
        wait_sum = c["wait_sum"] + (wait * admit_i).sum()
        admits = c["admits"] + admit_i.sum()
        reprefills = c["reprefills"] + (admit & (turn > 0)
                                        & (~resident)).sum()
        pays = admit & ((turn == 0) | (~resident))
        resident_tok = c["resident_tok"] - (kv * (admit & resident)).sum()
        resident = resident & (~admit)
        remaining = torch.where(admit, decode + prompt * pays,
                                c["remaining"])
        in_slot = in_slot | admit

        # -- decode (one token per occupied slot) -------------------------
        dec = in_slot & live
        dec_i = dec.long()
        decoded = c["decoded"] + dec_i.sum()
        remaining = remaining - dec_i

        # -- completion ---------------------------------------------------
        comp = dec & (remaining == 0)
        comp_i = comp.long()
        lat = now + 1 - ready
        completed = c["completed"] + comp_i.sum()
        missed = c["missed"] + (comp & (lat > deadline)).sum()
        lat_sum = c["lat_sum"] + (lat * comp_i).sum()
        dl_sum = c["dl_sum"] + (deadline * comp_i).sum()
        lat_hist = c["lat_hist"].index_add(
            0, torch.clamp(lat, 0, HIST_BINS - 1), comp_i)
        last = (turn + 1) >= turns
        want = comp & (~last) & keep_bit
        kvw = kv * want
        excl = torch.cumsum(kvw, 0) - kvw
        kept = want & ((resident_tok + excl + kv) <= dims.budget)
        resident_tok = resident_tok + (kv * kept).sum()
        resident = torch.where(comp & (~last), kept, resident)
        turn = turn + comp_i
        ready = torch.where(comp, torch.where(last, DONE, now + 1 + gap),
                            ready)
        in_slot = in_slot & (~comp)
        finished = c["finished"] + (comp & last).sum()

        concur = ((arrival <= now) & (ready != DONE)).sum()
        peak = torch.where(live, torch.maximum(c["peak"], concur), c["peak"])
        c = dict(now=now + live.long(), ready=ready, in_slot=in_slot,
                 remaining=remaining, turn=turn, resident=resident,
                 resident_tok=resident_tok, peak=peak, completed=completed,
                 missed=missed, lat_sum=lat_sum, dl_sum=dl_sum,
                 wait_sum=wait_sum, admits=admits, reprefills=reprefills,
                 decoded=decoded, finished=finished, wait_hist=wait_hist,
                 lat_hist=lat_hist)
        comps.append(comp)
    return c, torch.stack(comps)


def _read(carry: Dict[str, torch.Tensor], comp: torch.Tensor) -> Dict:
    """The super-step's one host read: the carry's scalars, a done flag,
    both histograms and the completion matrix packed as bytes on the
    device and copied in one transfer."""
    words = torch.stack([carry[k] for k in _SCALARS]
                        + [(carry["ready"] == DONE).all().long()])
    buf = torch.cat([words.view(torch.uint8),
                     carry["wait_hist"].view(torch.uint8),
                     carry["lat_hist"].view(torch.uint8),
                     comp.reshape(-1).view(torch.uint8)]).cpu().numpy()
    nw = len(_SCALARS) + 1
    ints = buf[:8 * (nw + 2 * HIST_BINS)].view(np.int64)
    out = {k: int(v) for k, v in zip(_SCALARS, ints[:nw - 1])}
    out["done"] = bool(ints[nw - 1])
    out["wait_hist"] = ints[nw:nw + HIST_BINS].copy()
    out["lat_hist"] = ints[nw + HIST_BINS:].copy()
    out["comp"] = buf[8 * (nw + 2 * HIST_BINS):].view(bool).reshape(
        comp.shape)
    return out


def _i64(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def _stage(trace: SessionTrace, dev: torch.device
           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The trace's per-session constants (int64) and the starting carry
    on ``dev``."""
    consts = {name: _i64(getattr(trace, name), dev) for name in
              ("arrival", "turns", "gap", "prompt", "decode", "deadline",
               "kv")}
    consts["sid"] = consts["arange"] = torch.arange(
        trace.n, dtype=torch.int64, device=dev)
    carry = {k: torch.as_tensor(v, device=dev)
             for k, v in _init_carry(trace).items()}
    return consts, carry


def _replay_batched(trace: SessionTrace, sched: HydraKVScheduler,
                    dims: _Dims, dev: torch.device) -> ReplayResult:
    consts, carry = _stage(trace, dev)
    rc_cl, ri_cl = classify_sessions(sched.profile, trace.turns, trace.gap)
    rc_t, ri_t = _i64(rc_cl, dev), _i64(ri_cl, dev)
    prev_lat = prev_dl = 0
    epoch = 0
    while True:
        faults.fire("serve_step", key=f"e{epoch}")
        faults.fire("serve_admission", key=f"e{epoch}")
        carry, comp = _superstep(dims, consts, carry, rc_t, ri_t,
                                 int(sched.ri_th), int(sched.rc_th))
        # ---- the one host read per super-step ----
        host = _read(carry, comp)
        _feed_scheduler(sched, trace, host["comp"])
        lat_sum, dl_sum = host["lat_sum"], host["dl_sum"]
        old_profile = sched.profile
        sched.epoch_update(**_epoch_signals(
            lat_sum - prev_lat, dl_sum - prev_dl, host["resident_tok"],
            dims.budget))
        prev_lat, prev_dl = lat_sum, dl_sum
        if sched.profile is not old_profile:
            rc_cl, ri_cl = classify_sessions(sched.profile, trace.turns,
                                             trace.gap)
            rc_t, ri_t = _i64(rc_cl, dev), _i64(ri_cl, dev)
        epoch += 1
        if host["now"] >= dims.max_steps or host["done"]:
            return _result(host, "batched")


# ---------------------------------------------------------------------------
# host oracle: the same step math, vectorized numpy, scheduler inline
# ---------------------------------------------------------------------------
def _host_step(c: Dict[str, np.ndarray], trace: SessionTrace,
               rc_cl: np.ndarray, ri_cl: np.ndarray,
               sched: HydraKVScheduler, dims: _Dims) -> None:
    now = int(c["now"])
    ready = c["ready"]
    in_slot = c["in_slot"]
    resident = c["resident"]
    turn = c["turn"]
    live = now < dims.max_steps and bool(np.any(ready != DONE))
    n = dims.n
    sid = np.arange(n, dtype=np.int64)
    arrival = trace.arrival.astype(np.int64)
    deadline = trace.deadline.astype(np.int64)
    gap = trace.gap.astype(np.int64)
    kv = trace.kv

    queued = (~in_slot) & (ready <= now)
    free = dims.slots - int(np.sum(in_slot))
    wait = now - ready
    if dims.admission == "urgency":
        slack = np.clip(deadline - wait, -_SLACK_OFF + 1, _SLACK_OFF - 1)
        keyv = ((slack + _SLACK_OFF) << _SID_BITS) | sid
    else:
        keyv = (np.clip(ready, 0, 1 << 40) << _SID_BITS) | sid
    keyv = np.where(queued, keyv, _MAXKEY)
    order = np.argsort(keyv)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    admit = queued & (rank < free) & live
    if live and bool(np.any(admit)):
        faults.fire("serve_admission", key=f"t{now}")

    np.add.at(c["wait_hist"], np.clip(wait[admit], 0, HIST_BINS - 1), 1)
    c["wait_sum"] += int(np.sum(wait[admit]))
    c["admits"] += int(np.sum(admit))
    c["reprefills"] += int(np.sum(admit & (turn > 0) & (~resident)))
    pays = admit & ((turn == 0) | (~resident))
    c["resident_tok"] -= int(np.sum(kv[admit & resident]))
    resident &= ~admit
    c["remaining"] = np.where(
        admit, trace.decode.astype(np.int64) + np.where(pays, trace.prompt,
                                                        0), c["remaining"])
    in_slot |= admit

    dec = in_slot & live
    c["decoded"] += int(np.sum(dec))
    c["remaining"] -= dec.astype(np.int64)

    comp = dec & (c["remaining"] == 0)
    lat = now + 1 - ready
    c["completed"] += int(np.sum(comp))
    c["missed"] += int(np.sum(comp & (lat > deadline)))
    c["lat_sum"] += int(np.sum(lat[comp]))
    c["dl_sum"] += int(np.sum(deadline[comp]))
    np.add.at(c["lat_hist"], np.clip(lat[comp], 0, HIST_BINS - 1), 1)
    last = (turn + 1) >= trace.turns
    for s in np.nonzero(comp)[0]:       # the oracle's inline decisions
        sched.keep_resident(float(trace.turns[s]), float(trace.gap[s]))
    if dims.residency == "hydra":
        keep_bit = ~((ri_cl > sched.ri_th) | (rc_cl < sched.rc_th))
    elif dims.residency == "keep-all":
        keep_bit = np.ones(n, bool)
    else:
        keep_bit = np.zeros(n, bool)
    want = comp & (~last) & keep_bit
    kvw = np.where(want, kv, 0)
    excl = np.cumsum(kvw) - kvw
    kept = want & ((c["resident_tok"] + excl + kv) <= dims.budget)
    c["resident_tok"] += int(np.sum(kv[kept]))
    c["resident"] = np.where(comp & (~last), kept, resident)
    c["turn"] = turn + comp.astype(np.int64)
    c["ready"] = np.where(comp, np.where(last, DONE, now + 1 + gap), ready)
    c["in_slot"] = in_slot & (~comp)
    c["finished"] += int(np.sum(comp & last))

    if live:
        concur = int(np.sum((arrival <= now) & (c["ready"] != DONE)))
        c["peak"] = max(int(c["peak"]), concur)
    c["now"] = now + int(live)


def _replay_host(trace: SessionTrace, sched: HydraKVScheduler,
                 dims: _Dims) -> ReplayResult:
    c = _init_carry(trace)
    rc_cl, ri_cl = classify_sessions(sched.profile, trace.turns, trace.gap)
    prev_lat = prev_dl = 0
    epoch = 0
    while True:
        faults.fire("serve_step", key=f"e{epoch}")
        for _ in range(dims.k):
            _host_step(c, trace, rc_cl, ri_cl, sched, dims)
        old_profile = sched.profile
        sched.epoch_update(**_epoch_signals(
            c["lat_sum"] - prev_lat, c["dl_sum"] - prev_dl,
            int(c["resident_tok"]), dims.budget))
        prev_lat, prev_dl = c["lat_sum"], c["dl_sum"]
        if sched.profile is not old_profile:
            rc_cl, ri_cl = classify_sessions(sched.profile, trace.turns,
                                             trace.gap)
        epoch += 1
        if (int(c["now"]) >= dims.max_steps
                or bool(np.all(c["ready"] == DONE))):
            return _result(c, "host")


def replay(trace: SessionTrace, sched: HydraKVScheduler, *,
           slots: int, max_steps: int, admission: str = "urgency",
           engine: str = "batched", device="cuda") -> ReplayResult:
    """Replay ``trace`` through ``sched`` with ``slots`` decode slots.

    ``engine="batched"`` runs the super-steps on ``device`` (the card
    unless the caller asks for the CPU); ``engine="host"`` is the numpy
    oracle.  The two are bitwise-identical on every counter, both
    histograms and the scheduler's own stats
    (tests/test_torch_replay.py)."""
    dev = _device.resolve(device)
    if engine not in _ENGINES:
        raise ValueError(f"unknown replay engine {engine!r} "
                         f"(expected one of {_ENGINES})")
    if admission not in _ADMISSIONS:
        raise ValueError(f"unknown admission {admission!r} "
                         f"(expected one of {_ADMISSIONS})")
    if trace.n >= (1 << _SID_BITS):
        raise ValueError(f"trace has {trace.n} sessions; the admission "
                         f"key packs ids into {_SID_BITS} bits "
                         f"(max {(1 << _SID_BITS) - 1})")
    dims = _Dims(n=trace.n, slots=int(slots),
                 budget=int(sched.token_budget),
                 max_steps=int(max_steps),
                 k=int(sched.apm.epoch_len),
                 residency=sched.knobs.residency,
                 admission=admission)
    if engine == "host":
        return _replay_host(trace, sched, dims)
    return _replay_batched(trace, sched, dims, dev)
