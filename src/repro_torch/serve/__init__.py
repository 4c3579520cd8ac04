"""The serve layer of the port: ``knobs`` (the ``SchedulerKnobs`` presets
that ``exp.registry.SERVE`` holds), the HyDRA KV scheduler
(``HydraKVScheduler``, ``SessionProfile``) and the model-executing
``ServeEngine`` with its ``Request``.  The trace generator, replay and the
serve API are ROADMAP.md Queue 1 item 12."""
from .engine import Request, ServeEngine
from .hydra_scheduler import HydraKVScheduler, SessionProfile
from .knobs import SchedulerKnobs, knobs_name, online, resolve_knobs

__all__ = ["SchedulerKnobs", "online", "resolve_knobs", "knobs_name",
           "HydraKVScheduler", "SessionProfile", "ServeEngine", "Request"]
