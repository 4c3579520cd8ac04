"""``run(spec, plan=ExecPlan(...), device=...) -> ResultSet`` -- the single
public entry point for evaluating anything on the port.

``engine="bucketed"``, and the ``"auto"`` default with ``jobs <= 1``, runs
the whole sweep at once through ``sweep.run_bucketed`` (buckets of groups
as one flat lane batch on the card).  ``host`` and ``fused`` (and
``"auto"`` with ``jobs > 1``) go through ``sweep.map_points``
(lane-batched ``simulate_group`` + disk-cache dedup, on a spawn process
pool of ``jobs`` workers when ``jobs > 1``); with the cache off, through
``simulate_group`` per (config, mix, params, dram) group in the caller.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .. import device as _device
from ..core import lern as lern_mod
from ..core import sim, sweep
from . import faults as faults_mod
from .faults import RunReport
from .plan import ExecPlan
from .resultset import ResultSet
from .spec import ExperimentSpec, Point

SpecLike = Union[ExperimentSpec, Iterable[ExperimentSpec]]


def _record(point: Point, axes: Dict, res: sim.SimResult) -> Dict:
    rec = dict(axes)
    rec.update(res.summary())
    rec["core_hit_rate"] = res.core_hit_rate
    rec["accel_hit_rate"] = res.accel_hit_rate
    rec["epochs"] = res.epochs
    rec["point"] = point
    rec["result"] = res
    return rec


def _run_points_uncached(points: Sequence[Point], rp: ExecPlan,
                         dev) -> List[sim.SimResult]:
    """Cache-off path: lane-batched ``simulate_group`` per (config, mix,
    params, dram) group, never touching the result cache (artifact
    caches for traces/LERN still apply)."""
    results: List[sim.SimResult] = [None] * len(points)  # type: ignore
    groups: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(points):
        groups.setdefault((p.config, p.mix, p.params, p.dram), []).append(i)
    for (config, mix, params, dram), idxs in groups.items():
        uniq: Dict[Point, List[int]] = {}
        for i in idxs:
            uniq.setdefault(points[i], []).append(i)
        members = list(uniq.items())
        for lo in range(0, len(members), rp.max_lanes):
            chunk = members[lo:lo + rp.max_lanes]
            rs = sweep.simulate_group(config, mix,
                                      [pt.policy for pt, _ in chunk],
                                      params, dram, engine=rp.engine,
                                      device=dev)
            for (pt, twin_idxs), res in zip(chunk, rs):
                for i in twin_idxs:
                    results[i] = res
                faults_mod.point_done(
                    sweep.point_key(pt.sweep_point().cache_path()),
                    source="computed", engine=rp.engine)
    return results


def run_points(points: Sequence[Point], plan: Optional[ExecPlan] = None,
               report: Optional[RunReport] = None,
               device="cuda") -> List[sim.SimResult]:
    """Evaluate resolved points in order on ``device``; the engine behind
    ``run``.  ``engine="bucketed"`` (and ``"auto"`` with ``jobs <= 1``)
    runs the points through ``sweep.run_bucketed``; the other plans
    through ``sweep.map_points`` with ``plan.jobs`` workers.
    ``plan.fit_engine`` pins the LERN fit engine for the run (in the pool's
    workers too), ``plan.faults`` activates a deterministic fault-injection
    plan, and ``report`` collects per-point completion records and
    fault/recovery events."""
    rp = (plan or ExecPlan()).resolve()
    bucketed = rp.engine == "bucketed" or (rp.engine == "auto"
                                           and rp.jobs <= 1)
    dev = _device.resolve(device)
    sps = [p.sweep_point() for p in points]
    with lern_mod.fit_engine_override(rp.fit_engine), \
            faults_mod.activate(faults_mod.as_plan(rp.faults)), \
            faults_mod.reporting(report):
        if bucketed:
            return sweep.run_bucketed(sps, max_lanes=rp.max_lanes,
                                      devices=rp.devices, cache=rp.cache,
                                      pipeline=rp.pipeline, report=report,
                                      device=dev)
        if rp.cache:
            return sweep.map_points(sps, jobs=rp.jobs, max_lanes=rp.max_lanes,
                                    engine=rp.engine,
                                    fit_engine=rp.fit_engine, report=report,
                                    device=dev)
        return _run_points_uncached(points, rp, dev)


def run(spec: SpecLike, plan: Optional[ExecPlan] = None, *,
        manifest: Optional[str] = None, resume: Optional[bool] = None,
        device="cuda") -> ResultSet:
    """Expand ``spec`` (one ExperimentSpec or several, concatenated) and
    evaluate every point under ``plan`` on ``device``; returns a columnar
    ResultSet whose key columns are the spec's axes and whose ``result``
    column holds the full SimResults.

    ``manifest`` (default: env ``REPRO_MANIFEST``) names an incremental
    sweep manifest (``hydra-manifest/v1``) updated after every finished
    point and fault event.  ``resume`` (default: env ``REPRO_RESUME``)
    re-opens a prior manifest and re-executes only the unfinished points;
    the completed ones load from the result cache and are recorded with
    ``source="resume"``.  It requires ``manifest`` and a cache-enabled
    plan.  The :class:`~faults.RunReport` is attached to the returned
    ResultSet as ``rs.run_report``."""
    if manifest is None:
        manifest = os.environ.get("REPRO_MANIFEST") or None
    if resume is None:
        resume = os.environ.get("REPRO_RESUME", "").lower() \
            not in ("", "0", "false")
    if resume:
        if not manifest:
            raise ValueError("resume=True requires a manifest path "
                             "(argument or REPRO_MANIFEST)")
        if not (plan or ExecPlan()).resolve().cache:
            raise ValueError("resume=True requires a cache-enabled plan "
                             "(completed points are served from the "
                             "result cache)")
    report = RunReport(manifest=manifest, resume=resume)
    specs = [spec] if isinstance(spec, ExperimentSpec) else list(spec)
    expanded: List[Tuple[Point, Dict]] = []
    keys: List[str] = []
    for s in specs:
        expanded.extend(s.expand())
        for name, _ in s.axes:
            if name not in keys:
                keys.append(name)
    report.n_points = len(expanded)
    results = run_points([pt for pt, _ in expanded], plan, report=report,
                         device=device)
    report.flush()
    records = [_record(pt, axes, res)
               for (pt, axes), res in zip(expanded, results)]
    rs = ResultSet.from_records(records, keys=keys)
    rs.run_report = report
    return rs
