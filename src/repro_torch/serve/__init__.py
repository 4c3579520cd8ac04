"""Multi-tenant trace-replay serving harness of the port (the JAX
package's ``repro.serve``, ported).

Public surface, mirroring ``repro_torch.exp``:

* :class:`TraceSpec` / :func:`generate`: seeded session-trace workloads
  (Poisson/bursty arrivals, heavy-tailed turns/gaps, :class:`MixDrift`).
* :class:`SchedulerKnobs` / :func:`resolve_knobs` / :class:`online`: the
  frozen configuration of :class:`HydraKVScheduler`; named presets live
  in the ``repro_torch.exp.SERVE`` registry.
* :class:`ServeSpec` / :func:`grid` / :func:`run`: declarative cells
  evaluated under an ``exp.ExecPlan`` on ``device`` (the card unless the
  caller asks for the CPU), returning a columnar ResultSet with
  **hydra-serve/v1** (de)serialization.
* :func:`replay` / :class:`ReplayResult`: the engine pair underneath (the
  batched super-step engine on the card vs. the sequential numpy host
  oracle, bitwise-identical).

The port also exports the model-executing :class:`ServeEngine` and its
:class:`Request` (``python -m repro_torch.launch.serve``), which the JAX
package keeps in ``repro.serve.engine``.
"""
from .api import (SERVE_SCHEMA, ServeSpec, from_serve_doc, grid, run,
                  to_serve_doc)
from .engine import Request, ServeEngine
from .hydra_scheduler import HydraKVScheduler, SessionProfile
from .knobs import SchedulerKnobs, knobs_name, online, resolve_knobs
from .replay import ReplayResult, classify_sessions, replay
from .trace import (MixDrift, SessionTrace, TraceSpec, generate,
                    profile_features)

__all__ = [
    "SERVE_SCHEMA", "ServeSpec", "grid", "run",
    "to_serve_doc", "from_serve_doc",
    "SchedulerKnobs", "online", "resolve_knobs", "knobs_name",
    "HydraKVScheduler", "SessionProfile",
    "TraceSpec", "MixDrift", "SessionTrace", "generate",
    "profile_features",
    "ReplayResult", "replay", "classify_sessions",
    "ServeEngine", "Request",
]
