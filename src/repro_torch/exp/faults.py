"""Deterministic fault injection + the structured run report (a copy of
the JAX package's ``exp/faults.py``, pure Python).

The sweep infrastructure recovers from worker crashes, torn/corrupt
cache entries, hung tasks and device/compile failures (docs/
resilience.md) — this module is how those failures are *produced* on
demand, deterministically, so every recovery path is exercised by tests
and CI instead of waiting for production to find it.

A :class:`FaultPlan` is a seeded list of :class:`FaultSpec` entries.
Each spec names an **injection site** (a string the instrumented code
passes to :func:`fire`), a fault *kind*, and when to trigger: skip the
first ``at`` matching arrivals, then fire up to ``max_fires`` times.
Plans travel as JSON through the ``REPRO_FAULTS`` env var (so spawn
pool workers inherit them) or programmatically via
``ExecPlan(faults=...)``; :func:`activate` normalizes a plan — filling
in the shared cross-process ``state`` marker directory that makes
``max_fires`` a *global* budget, not per-process — and exports it to
the environment for the duration.

Sites instrumented in the port (the JAX package's, all of them):

==================  =====================================================
``task``            inside ``sweep._group_task`` (inline and pool tasks)
``cache_read``      ``sim.cache_load`` — damages the entry on disk first
``cache_dump``      ``sim._atomic_dump`` — corrupt/truncate/torn writes
``stage_evict``     ``sweep._staged_for`` — drops the staging cache
``bucket``          ``sweep.simulate_bucket``, before a bucket slab runs
                    (stands for a failed slab: the card out of memory)
``fused``           ``sweep._demote_batch``, the per-group fused replay
                    (the ladder's second rung)
``bucket_overflow`` ``fused.drive_lanes_bucketed`` — forces the freeze /
                    escalate / demote machinery as if every active group
                    had overflowed at the round-capacity cap
``refit``           ``HydraKVScheduler._online_refit`` — a failed online
                    refit (the scheduler keeps its stale profile)
``serve_step``      ``serve.replay``, once per scheduler epoch on both
                    engines; ``ServeEngine`` every 16th engine step
``serve_admission`` ``serve.replay``, per admitting step on the host
                    oracle and once per super-step dispatch on the
                    batched engine; ``ServeEngine._admit``
==================  =====================================================

Kinds: ``raise`` / ``resource`` (exceptions — ``resource`` mimics an
XLA ``RESOURCE_EXHAUSTED``), ``crash`` (``os._exit`` — pool workers
only, suppressed in the parent), ``hang`` (sleep ``seconds`` — workers
only), and the caller-handled kinds ``corrupt`` / ``truncate`` /
``torn`` / ``evict`` / ``demote`` whose spec :func:`fire` returns for
the site to act on.

Every firing (and every recovery the sweep layer takes) is recorded on
the active :class:`RunReport` — the object ``exp.run`` attaches to its
ResultSet and persists incrementally as the sweep manifest
(``hydra-manifest/v1``), which ``exp.run(resume=True)`` reads to skip
finished points.  Events fired inside pool *workers* land in that
process's local buffer and ride back to the parent with the task result
(or inside ``sweep.TaskError`` on failure), where :func:`merge_events`
folds them into the parent report tagged ``origin="worker"``; only a
worker that dies outright (``crash`` kind, watchdog kill) loses its
buffer, and the parent records the observable outcome instead
(``worker_crash``, ``task_error``, ``watchdog_kill``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import tempfile
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

MANIFEST_SCHEMA = "hydra-manifest/v1"

KINDS = ("raise", "resource", "crash", "hang", "corrupt", "truncate",
         "torn", "evict", "demote")


class InjectedFault(RuntimeError):
    """An injected failure — always a legitimate ladder/retry trigger."""


class InjectedResourceExhausted(InjectedFault):
    """Mimics an XLA RESOURCE_EXHAUSTED allocation failure."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: at the ``at``-th matching arrival of
    ``site`` (skipping earlier ones), fire ``kind``, at most
    ``max_fires`` times across *all* processes sharing the plan's state
    directory.  ``match`` substring-filters the site's detail key;
    ``seconds`` is the ``hang`` duration."""
    site: str
    kind: str
    at: int = 0
    max_fires: int = 1
    match: str = ""
    seconds: float = 30.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, ordered set of faults plus the shared claim state.

    ``state`` (a directory) makes ``max_fires`` a cross-process budget:
    each firing claims an exclusive marker file, so a fault that crashes
    a pool worker does not re-fire in the respawned worker and crash-loop
    the sweep.  ``seed`` perturbs the corruption bytes the ``corrupt``
    kind writes."""
    specs: Tuple[FaultSpec, ...] = ()
    state: Optional[str] = None
    seed: int = 0

    @classmethod
    def make(cls, specs, state: Optional[str] = None,
             seed: int = 0) -> "FaultPlan":
        out = []
        for s in specs:
            out.append(s if isinstance(s, FaultSpec) else FaultSpec(**s))
        return cls(specs=tuple(out), state=state, seed=int(seed))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        if isinstance(doc, list):
            doc = {"specs": doc}
        return cls.make(doc.get("specs") or (), state=doc.get("state"),
                        seed=doc.get("seed", 0))

    def to_json(self) -> str:
        return json.dumps({"specs": [dataclasses.asdict(s)
                                     for s in self.specs],
                           "state": self.state, "seed": self.seed})

    def normalized(self) -> "FaultPlan":
        """Fill in a fresh shared state directory if none was given —
        each activation gets its own fire budget."""
        if self.state is not None or not self.specs:
            return self
        state = os.path.join(tempfile.gettempdir(),
                             f"repro-faults-{uuid.uuid4().hex[:12]}")
        os.makedirs(state, exist_ok=True)
        return dataclasses.replace(self, state=state)


def as_plan(plan: Union[None, str, FaultPlan]) -> Optional[FaultPlan]:
    """Coerce an ``ExecPlan.faults`` value (JSON string or FaultPlan)."""
    if plan is None or isinstance(plan, FaultPlan):
        return plan
    return FaultPlan.from_json(plan)


# ---------------------------------------------------------------------------
# module state: the active plan, per-process arm counters, fire claims
# ---------------------------------------------------------------------------
_PLAN: Optional[FaultPlan] = None
_ENV_SRC: Optional[str] = None
_ENV_PLAN: Optional[FaultPlan] = None
_ARMS: Dict[int, int] = {}      # spec idx -> matching arrivals seen here
_FIRES: Dict[int, int] = {}     # spec idx -> fires claimed (stateless plans)


def _active_plan() -> Optional[FaultPlan]:
    if _PLAN is not None:
        return _PLAN
    src = os.environ.get("REPRO_FAULTS")
    if not src:
        return None
    global _ENV_SRC, _ENV_PLAN
    if src != _ENV_SRC:       # workers parse the env form lazily, once
        _ENV_SRC, _ENV_PLAN = src, FaultPlan.from_json(src)
    return _ENV_PLAN


@contextlib.contextmanager
def activate(plan: Union[None, str, FaultPlan] = None):
    """Install ``plan`` (or the ``REPRO_FAULTS`` env plan) for the block.

    Normalizes the plan (shared state dir), resets this process's arm
    counters, and exports the normalized JSON to ``REPRO_FAULTS`` so
    spawn pool workers — including respawned ones — see the *same*
    cross-process fire budget.  Nested activation with ``plan=None``
    reuses the already-active plan."""
    global _PLAN
    plan = as_plan(plan)
    if plan is None:
        if _PLAN is not None:       # nested: reuse the active plan
            yield _PLAN
            return
        src = os.environ.get("REPRO_FAULTS")
        if not src:
            yield None
            return
        plan = FaultPlan.from_json(src)
    plan = plan.normalized()
    prev_plan, prev_env = _PLAN, os.environ.get("REPRO_FAULTS")
    prev_arms, prev_fires = dict(_ARMS), dict(_FIRES)
    _PLAN = plan
    _ARMS.clear()
    _FIRES.clear()
    os.environ["REPRO_FAULTS"] = plan.to_json()
    try:
        yield plan
    finally:
        _PLAN = prev_plan
        _ARMS.clear()
        _ARMS.update(prev_arms)
        _FIRES.clear()
        _FIRES.update(prev_fires)
        if prev_env is None:
            os.environ.pop("REPRO_FAULTS", None)
        else:
            os.environ["REPRO_FAULTS"] = prev_env


def _in_worker() -> bool:
    return multiprocessing.parent_process() is not None


def plan_seed() -> int:
    """Seed of the active plan (0 when none) — perturbs injected
    corruption bytes so distinct plans damage entries differently."""
    plan = _active_plan()
    return plan.seed if plan is not None else 0


def _claim(plan: FaultPlan, idx: int, spec: FaultSpec) -> bool:
    """Claim one of the spec's ``max_fires`` slots, atomically across
    processes when the plan carries a state directory."""
    if plan.state is None:
        n = _FIRES.get(idx, 0)
        if n >= spec.max_fires:
            return False
        _FIRES[idx] = n + 1
        return True
    try:
        os.makedirs(plan.state, exist_ok=True)
    except OSError:
        return False
    for k in range(spec.max_fires):
        marker = os.path.join(plan.state, f"spent-{idx}-{k}")
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        except OSError:
            return False
        os.close(fd)
        return True
    return False


def fire(site: str, key: str = "") -> Optional[FaultSpec]:
    """Arm the named injection site.  Returns None (no fault), raises
    (``raise``/``resource`` kinds), kills or stalls the process
    (``crash``/``hang``, pool workers only — suppressed and logged in
    the parent), or returns the matched spec for caller-handled kinds
    (``corrupt``/``truncate``/``torn``/``evict``/``demote``)."""
    plan = _active_plan()
    if plan is None:
        return None
    for idx, spec in enumerate(plan.specs):
        if spec.site != site:
            continue
        if spec.match and spec.match not in key:
            continue
        seen = _ARMS.get(idx, 0)
        _ARMS[idx] = seen + 1
        if seen < spec.at:
            continue
        if not _claim(plan, idx, spec):
            continue
        log_event("fault", site=site, fault=spec.kind, key=key)
        if spec.kind == "raise":
            raise InjectedFault(f"injected fault at {site} ({key})")
        if spec.kind == "resource":
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected at {site} ({key})")
        if spec.kind == "crash":
            if _in_worker():
                os._exit(137)
            log_event("fault_suppressed", site=site, fault=spec.kind,
                      reason="crash faults only fire in pool workers")
            return None
        if spec.kind == "hang":
            if _in_worker():
                time.sleep(spec.seconds)
            else:
                log_event("fault_suppressed", site=site, fault=spec.kind,
                          reason="hang faults only fire in pool workers")
            return None
        return spec
    return None


def degradable(exc: BaseException) -> bool:
    """Is this the class of failure the engine ladder may absorb by
    demoting bucket→fused→host (an injected fault, or torch's
    ``OutOfMemoryError``: the card out of memory), as opposed to an error
    that must propagate?  A failed ``nvcc`` build or a refused kernel
    launch (``kernels/*/kernel.py`` ``_check``) propagates: the port has
    no fallback from a kernel to a plain version on the card."""
    if isinstance(exc, InjectedFault):
        return True
    # by name, so that this module stays free of torch
    return any(c.__name__ == "OutOfMemoryError" for c in type(exc).__mro__)


# ---------------------------------------------------------------------------
# run report + incremental sweep manifest (hydra-manifest/v1)
# ---------------------------------------------------------------------------
class RunReport:
    """Structured record of one sweep run.

    ``points`` maps each point's cache key (the md5 basename of its sim
    cache path) to how it was satisfied — ``source`` is ``computed`` /
    ``cache`` / ``resume``, plus the engine that produced it and the
    attempt count.  ``events`` is the global fault/recovery log
    (injections, quarantines, worker crashes, watchdog kills,
    degradations, pool respawns).

    With a ``manifest`` path the report persists incrementally after
    every point/event as a ``hydra-manifest/v1`` JSON document (atomic
    rename), merging with any prior manifest at the same path — so a
    killed sweep leaves a ledger of exactly what finished, and
    ``resume=True`` seeds :attr:`resumed` from it."""

    def __init__(self, manifest: Optional[str] = None,
                 resume: bool = False):
        self.manifest_path = manifest
        self.n_points: Optional[int] = None
        self.events: List[Dict] = []
        self.points: Dict[str, Dict] = {}
        self._prior_completed: Dict[str, Dict] = {}
        self._prior_events: List[Dict] = []
        self.resumed: frozenset = frozenset()
        if manifest and os.path.exists(manifest):
            try:
                with open(manifest) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                if resume:
                    raise ValueError(
                        f"unreadable manifest {manifest!r}: {e}") from e
                doc = {}
            if isinstance(doc, dict) and doc.get("schema") == MANIFEST_SCHEMA:
                self._prior_completed = dict(doc.get("completed") or {})
                self._prior_events = list(doc.get("events") or [])
            elif resume:
                raise ValueError(
                    f"{manifest!r} is not a {MANIFEST_SCHEMA} manifest")
        if resume:
            if not manifest:
                raise ValueError("resume=True requires a manifest path")
            self.resumed = frozenset(self._prior_completed)

    def event(self, kind: str, **detail) -> None:
        self.events.append({"kind": kind, **detail})
        self.flush()

    def point_done(self, key: str, source: str, engine: Optional[str] = None,
                   attempts: int = 1, **detail) -> None:
        if source == "cache" and key in self.resumed:
            source = "resume"
        self.points[key] = {"source": source, "engine": engine,
                            "attempts": int(attempts), **detail}
        self.flush()

    def completed(self) -> Dict[str, Dict]:
        return {**self._prior_completed, **self.points}

    def summary(self) -> Dict:
        by_source: Dict[str, int] = {}
        by_engine: Dict[str, int] = {}
        for rec in self.points.values():
            by_source[rec["source"]] = by_source.get(rec["source"], 0) + 1
            eng = rec.get("engine")
            if eng:
                by_engine[eng] = by_engine.get(eng, 0) + 1
        return {"points": len(self.points), "by_source": by_source,
                "by_engine": by_engine, "n_events": len(self.events),
                "events": list(self.events)}

    def to_doc(self) -> Dict:
        return {"schema": MANIFEST_SCHEMA, "n_points": self.n_points,
                "completed": self.completed(),
                "events": self._prior_events + self.events}

    def flush(self) -> None:
        if not self.manifest_path:
            return
        tmp = (self.manifest_path
               + f".{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1)
        os.replace(tmp, self.manifest_path)


# the active report, plus a bounded fallback buffer so events fired
# outside any reporting() block (e.g. inside pool workers) don't grow
# memory unboundedly — they are observable via drain_events() in tests
_REPORT: Optional[RunReport] = None
_BUFFER: "deque[Dict]" = deque(maxlen=256)


@contextlib.contextmanager
def reporting(report: Optional[RunReport]):
    """Make ``report`` the destination of :func:`log_event` /
    :func:`point_done` for the block; ``None`` keeps the current one."""
    global _REPORT
    if report is None:
        yield _REPORT
        return
    prev = _REPORT
    _REPORT = report
    try:
        yield report
    finally:
        _REPORT = prev


def current_report() -> Optional[RunReport]:
    return _REPORT


def log_event(kind: str, **detail) -> None:
    if _REPORT is not None:
        _REPORT.event(kind, **detail)
    else:
        _BUFFER.append({"kind": kind, **detail})


def point_done(key: str, source: str, **kw) -> None:
    if _REPORT is not None:
        _REPORT.point_done(key, source, **kw)


def drain_events() -> List[Dict]:
    """Pop and return the unattached event buffer — how pool workers
    (which have no active report) hand their fault log back to the
    parent, and a test helper."""
    out = list(_BUFFER)
    _BUFFER.clear()
    return out


def merge_events(events: List[Dict], origin: str = "worker") -> None:
    """Fold another process's drained event buffer into the active
    report (or this process's buffer), tagging each with its origin."""
    for ev in events:
        ev = dict(ev)
        kind = ev.pop("kind", "event")
        ev.setdefault("origin", origin)
        log_event(kind, **ev)
