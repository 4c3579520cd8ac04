"""ExecPlan -- the one object that says *how* a spec is executed.

    from repro_torch import exp
    rs = exp.run(spec, plan=exp.ExecPlan(engine="bucketed",
                                         fit_engine="bucketed"))

Fields left ``None`` resolve to the environment defaults, so
``ExecPlan()`` is always a valid plan.

Engine names (the JAX package's set):

* ``"auto"``    -- the bucketed engine when ``jobs <= 1`` (the default);
  with ``jobs > 1`` the process pool of ``sweep.map_points``, each group
  on the fused engine where it can take it, else the host loop.
* ``"host"``    -- the lane-batched per-epoch host loop
  (``sweep.simulate_group``) for each group.
* ``"fused"``   -- the device-resident super-step engine
  (``core/fused.py``) for each group.
* ``"bucketed"`` -- the whole sweep at once: groups of one static shape
  (``fused.bucket_key``) run as one flat lane batch on the card
  (``sweep.run_bucketed``).

The engines are bitwise equal on every SimResult field (tests/
test_torch_fused.py, tests/test_torch_bucketed.py), so the choice changes
speed, not results.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

from .faults import FaultPlan

_ENGINES = ("auto", "host", "fused", "bucketed")
_FIT_ENGINES = ("auto", "bucketed", "segmented")


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """How to execute a spec.  ``None`` fields resolve to env defaults.

    engine:     "auto" | "host" | "fused" | "bucketed" (default: env
                ``REPRO_ENGINE``; legacy ``REPRO_FUSED=0`` means "host";
                else "auto")
    jobs:       process-pool width of ``sweep.map_points`` (default 1;
                the bucketed engine ignores it)
    devices:    cards for the bucketed engine (default None: the one
                card; > 1 is ROADMAP.md Queue 1 item 14b and raises)
    cache:      read/write the sim disk result cache (default True)
    fit_engine: "auto" | "bucketed" | "segmented" k-means fit engine
                (default: env ``REPRO_LERN_FIT``, else "auto")
    max_lanes:  lane cap per lane-batched round loop (default
                ``sweep.MAX_LANES``)
    pipeline:   bucketed engine only: enqueue super-step N+1 before N's
                write-back (default: env ``REPRO_BUCKET_PIPELINE``, on;
                ``False`` runs one super-step at a time)
    faults:     deterministic fault-injection plan -- a
                :class:`faults.FaultPlan` or its JSON string (default:
                env ``REPRO_FAULTS``; None = no injection)
    """
    engine: Optional[str] = None
    jobs: Optional[int] = None
    devices: Optional[int] = None
    cache: Optional[bool] = None
    fit_engine: Optional[str] = None
    max_lanes: Optional[int] = None
    pipeline: Optional[bool] = None
    faults: Optional[Union[str, FaultPlan]] = None

    def __post_init__(self):
        if self.engine is not None and self.engine not in _ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} "
                             f"(expected one of {_ENGINES})")
        if self.fit_engine is not None and self.fit_engine not in _FIT_ENGINES:
            raise ValueError(f"unknown fit_engine {self.fit_engine!r} "
                             f"(expected one of {_FIT_ENGINES})")
        if self.faults is not None and not isinstance(self.faults,
                                                      (str, FaultPlan)):
            raise ValueError("faults must be a FaultPlan or its JSON "
                             f"string, got {type(self.faults).__name__}")

    def resolve(self) -> "ExecPlan":
        """Fill every ``None`` field from the environment defaults,
        returning a fully-concrete plan (``"auto"`` stays ``"auto"``, and
        ``devices`` may stay ``None``: the one card)."""
        engine = self.engine or os.environ.get("REPRO_ENGINE")
        if engine is None:
            engine = ("host" if os.environ.get("REPRO_FUSED", "1") == "0"
                      else "auto")
        if engine not in _ENGINES:  # env var can carry junk
            raise ValueError(f"unknown engine {engine!r} from REPRO_ENGINE "
                             f"(expected one of {_ENGINES})")
        fit = self.fit_engine or os.environ.get("REPRO_LERN_FIT") or "auto"
        if fit not in _FIT_ENGINES:
            raise ValueError(f"unknown fit_engine {fit!r} from "
                             f"REPRO_LERN_FIT (expected one of {_FIT_ENGINES})")
        from ..core import sweep  # deferred: exp layers above core
        # fused.PIPELINE_DEFAULT's rule, without importing the engine here
        pipeline = (os.environ.get("REPRO_BUCKET_PIPELINE", "1") != "0"
                    if self.pipeline is None else bool(self.pipeline))
        return dataclasses.replace(
            self, engine=engine,
            jobs=max(1, int(self.jobs if self.jobs is not None else 1)),
            cache=True if self.cache is None else bool(self.cache),
            fit_engine=fit,
            max_lanes=(sweep.MAX_LANES if self.max_lanes is None
                       else int(self.max_lanes)),
            pipeline=pipeline,
            faults=(self.faults if self.faults is not None
                    else os.environ.get("REPRO_FAULTS")))
