"""ExecPlan -- the one object that says *how* a spec is executed.

    from repro_torch import exp
    rs = exp.run(spec, plan=exp.ExecPlan(engine="host",
                                         fit_engine="bucketed"))

Fields left ``None`` resolve to the environment defaults, so
``ExecPlan()`` is always a valid plan.  The JAX package's ``devices`` and
``pipeline`` fields belong to its bucketed engine and come with it.

Engine names (the JAX package's set):

* ``"auto"``    -- resolves to ``"host"`` in the port until the bucketed
  whole-sweep engine lands (ROADMAP.md Queue 1 item 10b); then it moves to
  the JAX package's default, ``"bucketed"``.  The JAX package's own
  contract (tests/test_bucketed.py, tests/test_fused.py) makes its engines
  bitwise equal, so this changes speed, not results.
* ``"host"``    -- the lane-batched per-epoch host loop
  (``sweep.simulate_group``).
* ``"fused"``   -- the device-resident super-step engine
  (``core/fused.py``) for each group.
* ``"bucketed"`` -- not ported yet; a run asking for it raises
  ``NotImplementedError``.
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
                else "auto", which resolves to "host" until item 10b)
    jobs:       process-pool width (default 1; > 1 is not ported yet)
    cache:      read/write the sim disk result cache (default True)
    fit_engine: "auto" | "bucketed" | "segmented" k-means fit engine
                (default: env ``REPRO_LERN_FIT``, else "auto")
    max_lanes:  lane cap per lane-batched round loop (default
                ``sweep.MAX_LANES``)
    faults:     deterministic fault-injection plan -- a
                :class:`faults.FaultPlan` or its JSON string (default:
                env ``REPRO_FAULTS``; None = no injection)
    """
    engine: Optional[str] = None
    jobs: Optional[int] = None
    cache: Optional[bool] = None
    fit_engine: Optional[str] = None
    max_lanes: Optional[int] = None
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
        returning a fully-concrete plan (``"auto"`` becomes ``"host"``)."""
        engine = self.engine or os.environ.get("REPRO_ENGINE")
        if engine is None:
            engine = ("host" if os.environ.get("REPRO_FUSED", "1") == "0"
                      else "auto")
        if engine not in _ENGINES:  # env var can carry junk
            raise ValueError(f"unknown engine {engine!r} from REPRO_ENGINE "
                             f"(expected one of {_ENGINES})")
        if engine == "auto":
            engine = "host"
        fit = self.fit_engine or os.environ.get("REPRO_LERN_FIT") or "auto"
        if fit not in _FIT_ENGINES:
            raise ValueError(f"unknown fit_engine {fit!r} from "
                             f"REPRO_LERN_FIT (expected one of {_FIT_ENGINES})")
        from ..core import sweep  # deferred: exp layers above core
        return dataclasses.replace(
            self, engine=engine,
            jobs=max(1, int(self.jobs if self.jobs is not None else 1)),
            cache=True if self.cache is None else bool(self.cache),
            fit_engine=fit,
            max_lanes=(sweep.MAX_LANES if self.max_lanes is None
                       else int(self.max_lanes)),
            faults=(self.faults if self.faults is not None
                    else os.environ.get("REPRO_FAULTS")))
