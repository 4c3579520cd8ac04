"""Seeded multi-tenant session-trace generator (the serve-side workload
axis; a copy of the JAX package's ``serve/trace.py``, numpy only, so the
same spec gives bitwise the same arrays in both packages).

A trace is a population of multi-turn sessions: each session arrives
once, then alternates decode turns (``decode`` tokens after a
``prompt``-token prefill) with think-time gaps, for a heavy-tailed number
of turns.  Arrivals follow a Poisson or bursty (on/off modulated)
process; turn counts, inter-turn gaps and decode lengths are log-normal
(heavy-tailed).  Sessions come from two latent reuse classes — *chatty*
(many turns, short gaps: the KV blocks worth keeping resident) and
*one-shot* (few turns, long gaps) — and :class:`MixDrift` shifts the
class mix across arrival phases with the same frozen seed-controlled
shape as ``workloads.PhaseDrift``, so an offline-fit
:class:`~repro_torch.serve.hydra_scheduler.SessionProfile` goes progressively
stale and the online-refit knob has something real to chase.

Everything is ``numpy.random.default_rng(seed)``-driven: the same
:class:`TraceSpec` always yields a bitwise-identical trace
(tests/test_torch_replay.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

_ARRIVALS = ("poisson", "bursty")

# latent reuse-class multipliers applied to the spec's base scales
_CHATTY_TURNS_X, _CHATTY_GAP_X = 3.0, 0.25
_ONESHOT_TURNS_X, _ONESHOT_GAP_X = 0.5, 2.0

_MAX_TURNS = 64
_MAX_GAP = 4096
_MAX_DECODE = 256


@dataclasses.dataclass(frozen=True)
class MixDrift:
    """Seed-controlled session-mix drift across arrival phases (the
    ``workloads.PhaseDrift`` idiom at the serving layer).

    The arrival timeline is cut into ``period`` equal phases (by arrival
    order); phase 0 keeps the spec's base chatty fraction and each later
    phase ramps it by up to ``strength`` — so the reuse mix an offline
    profile learned from early sessions drifts under it.
    """
    period: int = 4
    strength: float = 0.5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Frozen, hashable description of one generated session trace.

    sessions:      session population size.
    arrival:       "poisson" (rate arrivals/step) or "bursty" (on/off
                   phases of ``burst_period`` steps; on-rate scaled by
                   ``burst_factor``, off-rate by its inverse).
    rate:          mean session arrivals per engine step.
    turns_mean/σ:  log-normal turn-count scale (median ``turns_mean``).
    gap_mean/σ:    log-normal inter-turn think-time (engine steps).
    prompt_tokens: prefill cost (steps) a non-resident turn pays.
    decode_mean/σ: log-normal decode length per turn (steps).
    deadline_factor: per-turn deadline = factor * (prompt + decode).
    chatty_frac:   base fraction of chatty (hot-reuse) sessions.
    drift:         optional :class:`MixDrift` phase drift of that mix.
    seed:          the one RNG seed; same spec -> bitwise-same trace.
    """
    sessions: int = 512
    arrival: str = "poisson"
    rate: float = 4.0
    burst_factor: float = 4.0
    burst_period: int = 128
    turns_mean: float = 3.0
    turns_sigma: float = 0.8
    gap_mean: float = 32.0
    gap_sigma: float = 0.8
    prompt_tokens: int = 24
    decode_mean: float = 12.0
    decode_sigma: float = 0.4
    deadline_factor: float = 2.5
    chatty_frac: float = 0.5
    drift: Optional[MixDrift] = None
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in _ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r} "
                             f"(expected one of {_ARRIVALS})")
        if self.sessions < 1:
            raise ValueError("sessions must be >= 1")

    def spec_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpec":
        d = dict(d)
        if d.get("drift") is not None:
            d["drift"] = MixDrift(**d["drift"])
        return cls(**d)


@dataclasses.dataclass
class SessionTrace:
    """One generated trace: parallel int arrays, one entry per session."""
    arrival: np.ndarray    # [N] int64  first-turn ready step
    turns: np.ndarray      # [N] int32  total turns in the session
    gap: np.ndarray        # [N] int32  inter-turn think time (steps)
    prompt: np.ndarray     # [N] int32  prefill cost of a non-resident turn
    decode: np.ndarray     # [N] int32  decode steps per turn
    deadline: np.ndarray   # [N] int32  per-turn latency budget (steps)
    cls: np.ndarray        # [N] int8   latent class (1 = chatty)

    @property
    def n(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def kv(self) -> np.ndarray:
        """KV tokens a parked resident session occupies."""
        return (self.prompt + self.decode).astype(np.int64)


def _chatty_mask(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """Per-session latent class draw, with the mix ramped across arrival
    phases when ``spec.drift`` is set."""
    n = spec.sessions
    frac = np.full(n, spec.chatty_frac)
    d = spec.drift
    if d is not None and d.period > 1:
        phase = np.minimum((np.arange(n) * d.period) // max(n, 1),
                           d.period - 1)
        ramp = phase / (d.period - 1)          # 0 .. 1 across phases
        frac = np.clip(spec.chatty_frac - d.strength / 2
                       + d.strength * ramp, 0.02, 0.98)
        # drift carries its own seed (PhaseDrift idiom): the class draw
        # re-keys on it so drift variants decorrelate from the base trace
        rng = np.random.default_rng((spec.seed, 104729, d.seed))
    return rng.random(n) < frac


def _lognormal_int(rng: np.random.Generator, median: np.ndarray,
                   sigma: float, lo: int, hi: int) -> np.ndarray:
    v = np.exp(np.log(np.maximum(median, 1e-9))
               + sigma * rng.standard_normal(median.shape))
    return np.clip(np.floor(v), lo, hi).astype(np.int32)


def _arrivals(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    n = spec.sessions
    if spec.arrival == "poisson":
        steps = np.cumsum(rng.exponential(1.0 / max(spec.rate, 1e-9), n))
        return np.floor(steps).astype(np.int64)
    # bursty: per-step Poisson counts under an on/off rate square wave
    half = max(spec.burst_period // 2, 1)
    out: list = []
    t0 = 0
    while sum(len(c) for c in out) < n:
        ts = np.arange(t0, t0 + 4096)
        on = (ts % spec.burst_period) < half
        r = np.where(on, spec.rate * spec.burst_factor,
                     spec.rate / max(spec.burst_factor, 1e-9))
        counts = rng.poisson(r)
        out.append(np.repeat(ts, counts))
        t0 += 4096
    return np.concatenate(out)[:n].astype(np.int64)


def generate(spec: TraceSpec) -> SessionTrace:
    """Deterministically expand a :class:`TraceSpec` into a trace."""
    rng = np.random.default_rng(spec.seed)
    arrival = _arrivals(spec, rng)
    chatty = _chatty_mask(spec, rng)
    turns_med = np.where(chatty, spec.turns_mean * _CHATTY_TURNS_X,
                         spec.turns_mean * _ONESHOT_TURNS_X)
    gap_med = np.where(chatty, spec.gap_mean * _CHATTY_GAP_X,
                       spec.gap_mean * _ONESHOT_GAP_X)
    turns = _lognormal_int(rng, turns_med, spec.turns_sigma, 1, _MAX_TURNS)
    gap = _lognormal_int(rng, gap_med, spec.gap_sigma, 1, _MAX_GAP)
    decode = _lognormal_int(rng, np.full(spec.sessions, spec.decode_mean),
                            spec.decode_sigma, 2, _MAX_DECODE)
    prompt = np.full(spec.sessions, max(int(spec.prompt_tokens), 1),
                     np.int32)
    deadline = np.ceil(spec.deadline_factor
                       * (prompt + decode)).astype(np.int32)
    return SessionTrace(arrival=arrival, turns=turns, gap=gap,
                        prompt=prompt, decode=decode, deadline=deadline,
                        cls=chatty.astype(np.int8))


def profile_features(spec: TraceSpec, n: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A held-out (turns, gaps) draw for the offline
    ``SessionProfile.fit`` — same distributions, disjoint RNG stream, so
    the profile is trained on the *population*, not the replayed trace."""
    held = dataclasses.replace(spec, sessions=max(int(n), 8),
                               seed=spec.seed + 7919)
    t = generate(held)
    return t.turns.astype(np.float64), t.gap.astype(np.float64)
