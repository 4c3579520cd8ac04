"""``serve.run(spec, plan, device=...) -> ResultSet``: the declarative
entry point for trace-replay serving experiments (the serve-side
``exp.run``; the JAX package's ``serve/api.py``, ported).

    from repro_torch import serve, exp

    specs = serve.grid(rate=[2.0, 8.0], knobs=["kv-default", "evict-all"])
    rs = serve.run(specs, plan=exp.ExecPlan(engine="auto"), device="cuda")
    for row in rs.mean_over("seed"):
        print(row["knobs"], row["rate"], row["dmr"], row["p99_wait_steps"])

Same conventions as ``exp.run``: a frozen hashable :class:`ServeSpec`
per cell, execution routed by :class:`~repro_torch.exp.plan.ExecPlan`
(``engine="host"`` forces the sequential numpy oracle; every other engine
runs the batched super-step engine on ``device`` and degrades to the
oracle on a degradable failure: an injected fault or torch's
``OutOfMemoryError``; bitwise-identical results either way), the port's
sim disk cache for cross-process dedup (envelope entries under
``<REPRO_CACHE>/torch/serve/``), ``faults.activate``/``reporting``
wrapping the whole run, and a columnar ResultSet whose rows embed their
full point spec through the versioned **hydra-serve/v1** document.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import numbers
import os
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import device as _device
from ..core import sim
from ..exp import faults
from ..exp.faults import RunReport
from ..exp.plan import ExecPlan
from ..exp.registry import SERVE
from ..exp.resultset import ResultSet
from .hydra_scheduler import HydraKVScheduler, SessionProfile
from .knobs import KnobsLike, SchedulerKnobs, knobs_name, resolve_knobs
from .replay import ReplayResult, replay
from .trace import TraceSpec, generate, profile_features

SERVE_SCHEMA = "hydra-serve/v1"

_ADMISSIONS = ("urgency", "fifo")

# ResultSet key (coordinate) columns a serve row always carries
_KEYS = ("arrival", "rate", "sessions", "knobs", "slots", "admission",
         "seed")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Frozen, hashable description of one serve-replay cell.

    trace:            the :class:`TraceSpec` workload axis.
    knobs:            residency policy: a ``repro_torch.exp.SERVE``
                      registry name, a :class:`SchedulerKnobs`, or a
                      ``(base, serve.online(R), ...)`` transform tuple.
    slots:            concurrent decode slots (admission capacity).
    max_steps:        hard step ceiling on the replay clock.
    admission:        "urgency" (deadline-slack order) or "fifo".
    profile_sessions: held-out sessions the offline
                      :class:`SessionProfile` is fit on (0 disables the
                      profile; the scheduler then uses its fixed
                      mid-cluster fallback).
    """
    trace: TraceSpec = TraceSpec()
    knobs: KnobsLike = "kv-default"
    slots: int = 64
    max_steps: int = 4096
    admission: str = "urgency"
    profile_sessions: int = 256

    def __post_init__(self):
        if self.admission not in _ADMISSIONS:
            raise ValueError(f"unknown admission {self.admission!r} "
                             f"(expected one of {_ADMISSIONS})")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        resolve_knobs(self.knobs)   # fail fast on unknown names/shapes

    def resolved_knobs(self) -> SchedulerKnobs:
        return resolve_knobs(self.knobs)

    def spec_dict(self) -> dict:
        """Self-describing dump embedded in hydra-serve/v1 rows."""
        return {
            "trace": self.trace.spec_dict(),
            "knobs": self.resolved_knobs().spec_dict(),
            "knobs_name": knobs_name(self.knobs),
            "slots": self.slots,
            "max_steps": self.max_steps,
            "admission": self.admission,
            "profile_sessions": self.profile_sessions,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        """Rebuild a spec from its :meth:`spec_dict` dump.  When the
        dumped knobs still match their registered preset the name is
        kept (so round-tripped specs stay ``==`` the originals)."""
        knobs: KnobsLike = SchedulerKnobs.from_dict(d["knobs"])
        name = d.get("knobs_name")
        if name and name in SERVE and SERVE.get(name) == knobs:
            knobs = name
        return cls(trace=TraceSpec.from_dict(d["trace"]), knobs=knobs,
                   slots=d["slots"], max_steps=d["max_steps"],
                   admission=d["admission"],
                   profile_sessions=d["profile_sessions"])


_TRACE_FIELDS = {f.name for f in dataclasses.fields(TraceSpec)}
_SPEC_FIELDS = {f.name for f in dataclasses.fields(ServeSpec)}


def grid(**axes) -> List[ServeSpec]:
    """Cross-product of serve/trace axes -> list of :class:`ServeSpec`
    (row-major in the order the axes are given, like
    ``ExperimentSpec.grid``).  Axis names may be ``ServeSpec`` fields
    (``knobs``, ``slots``, ...) or ``TraceSpec`` fields (``rate``,
    ``arrival``, ``seed``, ...); scalars are broadcast."""
    names = list(axes)
    for n in names:
        if n not in _SPEC_FIELDS and n not in _TRACE_FIELDS:
            known = sorted(_SPEC_FIELDS | _TRACE_FIELDS)
            raise KeyError(f"unknown serve axis {n!r} (known: {known})")
    values = [v if isinstance(v, (list, tuple)) else [v]
              for v in axes.values()]
    out: List[ServeSpec] = []

    def expand(i: int, acc: dict):
        if i == len(names):
            tkw = {k: v for k, v in acc.items() if k in _TRACE_FIELDS
                   and k != "trace"}
            skw = {k: v for k, v in acc.items() if k in _SPEC_FIELDS}
            base = skw.pop("trace", TraceSpec())
            out.append(ServeSpec(trace=dataclasses.replace(base, **tkw),
                                 **skw))
            return
        for v in values[i]:
            expand(i + 1, {**acc, names[i]: v})

    expand(0, {})
    return out


def _cache_key(spec: ServeSpec) -> str:
    """Engine-independent content key (both engines are bitwise equal,
    so one cache entry serves either).  ``knobs_name`` is excluded: a
    preset and an identical hand-built SchedulerKnobs are the same
    computation."""
    d = spec.spec_dict()
    d.pop("knobs_name", None)
    blob = json.dumps(d, sort_keys=True).encode()
    return hashlib.md5(blob).hexdigest()


def _build_scheduler(spec: ServeSpec, knobs: SchedulerKnobs,
                     device="cuda") -> HydraKVScheduler:
    """The cell's scheduler on ``device``: its offline profile (and every
    online refit) is fit there, through the ``kmeans_fit`` and
    ``kmeans_assign`` kernels on the card."""
    dev = _device.resolve(device)
    profile = None
    if spec.profile_sessions > 0 and knobs.residency == "hydra":
        t, g = profile_features(spec.trace, spec.profile_sessions)
        profile = SessionProfile.fit(t, g, seed=knobs.seed, device=dev)
    return HydraKVScheduler(knobs, profile=profile, device=dev)


def _evaluate(spec: ServeSpec, rp: ExecPlan, dev: torch.device
              ) -> Tuple[ReplayResult, Dict[str, float]]:
    """One cell through the engine ladder: batched, then (on a
    degradable failure) a fresh scheduler through the host oracle: the
    serve-side bucketed -> fused -> host demotion.  Anything else (a
    failed ``nvcc`` build, a refused kernel launch) propagates."""
    knobs = spec.resolved_knobs()
    trace = generate(spec.trace)
    engine = "host" if rp.engine == "host" else "batched"
    if engine == "batched":
        sched = _build_scheduler(spec, knobs, dev)
        try:
            res = replay(trace, sched, slots=spec.slots,
                         max_steps=spec.max_steps,
                         admission=spec.admission, engine="batched",
                         device=dev)
            return res, sched.stats()
        except Exception as e:
            if not faults.degradable(e):
                raise
            faults.log_event("serve_degrade", engine="batched",
                             error=str(e)[:200])
            engine = "host"
    sched = _build_scheduler(spec, knobs, dev)
    res = replay(trace, sched, slots=spec.slots, max_steps=spec.max_steps,
                 admission=spec.admission, engine="host", device=dev)
    return res, sched.stats()


def _row(spec: ServeSpec, res: ReplayResult,
         sched_stats: Dict[str, float]) -> Dict:
    t = spec.trace
    r: Dict = {"arrival": t.arrival, "rate": t.rate,
               "sessions": t.sessions, "knobs": knobs_name(spec.knobs),
               "slots": spec.slots, "admission": spec.admission,
               "seed": t.seed}
    r.update(res.summary())
    r["evict_rate"] = sched_stats["evict_rate"]
    r["refits"] = sched_stats["refits"]
    r["refit_failures"] = sched_stats["refit_failures"]
    r["engine"] = res.engine
    r["point"] = spec
    r["result"] = res
    return r


SpecLike = Union[ServeSpec, Iterable[ServeSpec]]


def run(spec: SpecLike, plan: Optional[ExecPlan] = None, *,
        manifest: Optional[str] = None, device="cuda") -> ResultSet:
    """Evaluate one or many :class:`ServeSpec` cells under ``plan`` on
    ``device`` (the card unless the caller asks for the CPU).

    Mirrors ``exp.run``: ``plan.resolve()`` fills env defaults,
    ``plan.faults`` activates deterministic fault injection for the
    whole run, identical cells are served once (in-process memo + the
    port's disk cache when ``plan.cache``), every completed cell lands in
    the :class:`RunReport` (incremental ``hydra-manifest/v1`` when
    ``manifest``/``REPRO_MANIFEST`` is set) and the report rides on the
    returned ResultSet as ``rs.run_report``."""
    dev = _device.resolve(device)
    specs = [spec] if isinstance(spec, ServeSpec) else list(spec)
    rp = (plan or ExecPlan()).resolve()
    if manifest is None:
        manifest = os.environ.get("REPRO_MANIFEST") or None
    report = RunReport(manifest=manifest)
    report.n_points = len(specs)
    records: List[Dict] = []
    memo: Dict[str, Tuple[ReplayResult, Dict]] = {}
    with faults.activate(faults.as_plan(rp.faults)), \
            faults.reporting(report):
        for sp in specs:
            ck = _cache_key(sp)
            if ck in memo:
                res, stats = memo[ck]
                src = "dedup"
            else:
                res = stats = None
                src = "computed"
                if rp.cache:
                    v = sim.cache_load(sim._cache_path("serve", ck))
                    if v is not sim.MISS:
                        try:
                            res = ReplayResult(
                                counters=dict(v["counters"]),
                                wait_hist=np.asarray(v["wait_hist"]),
                                lat_hist=np.asarray(v["lat_hist"]),
                                engine=v["engine"])
                            stats = dict(v["sched_stats"])
                            src = "cache"
                        except (KeyError, TypeError):
                            res = stats = None   # stale/foreign payload
                if res is None:
                    res, stats = _evaluate(sp, rp, dev)
                    src = "computed"
                    if rp.cache:
                        sim._atomic_dump(
                            {"counters": res.counters,
                             "wait_hist": res.wait_hist,
                             "lat_hist": res.lat_hist,
                             "engine": res.engine, "sched_stats": stats},
                            sim._cache_path("serve", ck))
                memo[ck] = (res, stats)
            faults.point_done(f"serve/{ck}", source=src,
                              engine=res.engine)
            records.append(_row(sp, res, stats))
    report.flush()
    rs = ResultSet.from_records(records, keys=_KEYS)
    rs.run_report = report
    return rs


# ---------------------------------------------------------------------------
# hydra-serve/v1 document (de)serialization
# ---------------------------------------------------------------------------
def _is_num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def to_serve_doc(rs: ResultSet, **header) -> Dict:
    """ResultSet -> versioned **hydra-serve/v1** document.  Every row
    embeds its full point spec, so rows are interpretable (and
    re-runnable via :meth:`ServeSpec.from_dict`) without the producing
    module."""
    rows = []
    for r in rs.to_rows():
        point = r.get("point")
        rows.append({
            "axes": {k: r.get(k) for k in rs.keys},
            "engine": r.get("engine"),
            "point": (point.spec_dict()
                      if hasattr(point, "spec_dict") else point),
            "metrics": {k: v for k, v in r.items()
                        if k not in rs.keys
                        and k not in ("point", "result", "engine")
                        and _is_num(v)},
        })
    doc: Dict = {"schema": SERVE_SCHEMA, "keys": list(rs.keys)}
    if rs.run_report is not None:
        doc["run_report"] = rs.run_report.summary()
    doc.update(header)
    doc["rows"] = rows
    return doc


def from_serve_doc(doc: Dict) -> ResultSet:
    """Parse a hydra-serve/v1 document back into a ResultSet (points
    rebuilt as :class:`ServeSpec`).  Rejects any other schema tag."""
    if doc.get("schema") != SERVE_SCHEMA:
        raise ValueError(f"expected schema {SERVE_SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    records = []
    for row in doc["rows"]:
        rec = dict(row["axes"])
        rec.update(row["metrics"])
        rec["engine"] = row.get("engine")
        if row.get("point") is not None:
            rec["point"] = ServeSpec.from_dict(row["point"])
        records.append(rec)
    return ResultSet.from_records(records, keys=doc["keys"])
