"""SchedulerKnobs — the one frozen object that configures the serve-side
HyDRA KV-residency scheduler (a copy of the JAX package's
``serve/knobs.py``: ``exp.registry.SERVE`` holds its presets).

The pre-redesign ``HydraKVScheduler(token_budget=..., deadline_tokens=...,
retrain_period=..., ...)`` kwarg pile is consolidated here so residency
policies become a sweepable spec axis exactly like the sim-side policy
registry: named presets live in ``repro.exp.SERVE`` (the fifth
:class:`repro.exp.Registry`), and a ``(base, serve.online(R))`` tuple is
the serve-side analogue of the policy-axis ``("hydra", exp.online(R))``
transform.  Constructing the scheduler any other way raises a
``TypeError`` pointing here.

``residency`` selects the decision rule the scheduler applies to a
finished turn's KV blocks:

* ``"hydra"``     — the paper's bypass rule over (RC, RI) session reuse
  clusters and the APM deadline thresholds (Fig. 9 machinery).
* ``"keep-all"``  — never evict (the residency analogue of no-bypass).
* ``"evict-all"`` — never keep; every returning turn re-prefills (the
  bypass-everything baseline the bench_serve DMR floor is gated against).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

from ..core.apm import APMParams
from ..exp.registry import SERVE

_RESIDENCY_MODES = ("hydra", "keep-all", "evict-all")


@dataclasses.dataclass(frozen=True)
class SchedulerKnobs:
    """Frozen, hashable configuration of :class:`HydraKVScheduler`.

    token_budget:       HBM KV-block budget (tokens) parked residents
                        may occupy.
    deadline_tokens:    per-turn token-latency budget driving the APM
                        deadline machinery.
    epoch_tokens:       scheduler epoch length (tokens / engine steps).
    apm:                the paper's APM threshold parameters.
    retrain_period:     refit the session-reuse clusters every this many
                        scheduler epochs from the observed window
                        (``inf`` = offline profile only, bitwise the
                        pre-online behavior).
    min_refit_sessions: observed-window floor below which a refit is
                        skipped (a sparse window must not wipe the
                        profile's knowledge).
    residency:          "hydra" | "keep-all" | "evict-all" (see module
                        docstring).
    seed:               k-means seed for online refits.
    """
    token_budget: int = 4096
    deadline_tokens: float = 128.0
    epoch_tokens: int = 64
    apm: APMParams = APMParams()
    retrain_period: float = math.inf
    min_refit_sessions: int = 8
    residency: str = "hydra"
    seed: int = 0

    def __post_init__(self):
        if self.residency not in _RESIDENCY_MODES:
            raise ValueError(f"unknown residency {self.residency!r} "
                             f"(expected one of {_RESIDENCY_MODES})")
        if self.epoch_tokens < 1:
            raise ValueError("epoch_tokens must be >= 1")

    def spec_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["retrain_period"] = (None if math.isinf(self.retrain_period)
                               else self.retrain_period)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulerKnobs":
        d = dict(d)
        d["apm"] = APMParams(**d.get("apm", {}))
        if d.get("retrain_period") is None:
            d["retrain_period"] = math.inf
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class online:
    """Knobs transform: refit the session clusters every ``period``
    scheduler epochs — the serve-side ``exp.online(R)``."""
    period: float = 8.0
    min_sessions: int = 8

    @property
    def tag(self) -> str:
        return f"ol{self.period:g}"

    def __call__(self, k: SchedulerKnobs) -> SchedulerKnobs:
        return dataclasses.replace(k, retrain_period=float(self.period),
                                   min_refit_sessions=self.min_sessions)


KnobsLike = Union[str, SchedulerKnobs, Tuple]


def resolve_knobs(v: KnobsLike) -> SchedulerKnobs:
    """Registry name / SchedulerKnobs / ``(base, *transforms)`` tuple ->
    resolved SchedulerKnobs (mirrors ``exp.resolve_policy``)."""
    if isinstance(v, SchedulerKnobs):
        return v
    if isinstance(v, str):
        return SERVE.get(v)
    if isinstance(v, tuple) and v:
        k = resolve_knobs(v[0])
        for t in v[1:]:
            k = t(k)
        return k
    raise TypeError(f"cannot resolve scheduler knobs from {v!r}")


def knobs_name(v: KnobsLike) -> str:
    """Scalar axis label for a knobs value (ResultSet key column)."""
    if isinstance(v, str):
        return v
    if isinstance(v, SchedulerKnobs):
        return "custom" if v not in _NAMED.values() else \
            next(n for n, k in _NAMED.items() if k == v)
    if isinstance(v, tuple) and v:
        tags = [getattr(t, "tag", type(t).__name__) for t in v[1:]]
        return "-".join([knobs_name(v[0])] + tags)
    raise TypeError(f"cannot name scheduler knobs {v!r}")


# named presets (the serve registry's seed population).  ``kv-online``
# uses the same default refit period as the transform above so
# ("kv-default", online()) and "kv-online" resolve identically.
_NAMED = {
    "kv-default": SchedulerKnobs(),
    "kv-online": SchedulerKnobs(retrain_period=8.0),
    "keep-all": SchedulerKnobs(residency="keep-all"),
    "evict-all": SchedulerKnobs(residency="evict-all"),
}
for _n, _k in _NAMED.items():
    SERVE.register(_n, _k)
