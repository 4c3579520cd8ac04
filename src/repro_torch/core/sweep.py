"""Batched multi-policy sweep engine, host path.

The paper's evaluation is a cross-product -- policies x configs x mixes
x DRAM/LLC variants -- and this module batches it at two levels:

* **Within a (config, mix, params, dram) group** all requested policies
  are simulated in one pass: the trace, LERN clusters and core streams are
  loaded once (``sim.load_artifacts``), each policy advances as a
  ``sim.Lane``, and every epoch's LLC round chunks go through one
  lane-batched round loop (``llc.simulate_epoch_lanes``) instead of one
  loop per policy.  Lanes whose LLC geometry diverges are partitioned
  into geometry-compatible sub-batches.  Results equal the sequential
  ``sim.drive_lane`` bitwise.
* **Across groups, on the device** ``run_bucketed`` / ``simulate_bucket``
  bucket whole groups by the fused engine's static shape
  (``fused.bucket_key``) and drive each bucket as one flat lane batch
  (``fused.drive_lanes_bucketed``): one ``llc_rounds`` launch an epoch for
  every group of the bucket.  Results equal per-group ``simulate_group``
  bitwise (tests/test_torch_bucketed.py).  A bucket that fails degradably
  (an injected fault, the card out of memory) walks the ladder bucketed ->
  per-group fused -> host, recomputing the groups from fresh lanes.
  ``devices`` shards a bucket's groups over cards as the JAX package's
  ``shard_map`` does (``fused.shard_devices``); the results do not depend
  on it.
* **Across groups, across processes** ``map_points`` runs the groups in
  turn (``jobs <= 1``) or fans them over a spawn process pool of ``jobs``
  workers (``_run_pool``): retry with backoff, a respawn of the pool when
  a worker dies, a wall-clock watchdog (``task_timeout``), and a last
  attempt in the caller on the host engine.  Both share the front half
  with ``run_bucketed`` (``_plan_tasks``): the sim disk cache as the dedup
  layer (cached points are skipped up front, duplicate points are
  computed once, finished groups are written back with atomic renames,
  so concurrent workers never see a torn entry) and the deadline
  calibrations, one per (config, params, dram), computed first.

``engine="fused"`` drives each geometry batch through the device-resident
epoch engine (``core/fused.py``): integer stats bitwise, floats within
rtol 1e-6 of the host loop, so the engine is a speed switch.  The
bucketed engine is a plan-level engine (``exp.ExecPlan``):
``simulate_group`` and ``map_points`` reject it as an unknown engine, as
the JAX package's do.

Every entry point takes ``device=`` (default: the card) for the LLC
state and the LERN fits.  The pool's workers share the caller's device:
each opens its own CUDA context on it (the card time-slices them), and
the kernels are built in the caller before the pool starts.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
from collections import OrderedDict
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from . import llc
from . import sim
from .dram import DramModel, default_model
from .policies import Policy

# Default lane width of one lane-batched round loop.
MAX_LANES = 4
# Groups per bucketed lane batch: each group's trace and streams are staged
# apart along the group axis, so a cap bounds the staged working set.
BUCKET_GROUPS = int(os.environ.get("REPRO_BUCKET_GROUPS", "16"))
# Staged groups (``fused._Staged``) kept across ``simulate_bucket`` calls,
# least recently used first out: repeated sweeps over the same points skip
# the upload.  Entries whose tables an online-LERN retrain swapped are
# stale and stage afresh.
STAGE_CACHE_CAP = int(os.environ.get("REPRO_STAGE_CACHE", "32"))
_STAGE_CACHE: "OrderedDict[Tuple, object]" = OrderedDict()
# A failing group task is retried TASK_RETRIES times with exponential
# backoff (base RETRY_BACKOFF seconds, doubled per attempt, capped at 5 s)
# before a last attempt on the host engine (in the caller, for a pool
# task).  TASK_TIMEOUT > 0 arms a per-task wall-clock watchdog on the
# pool: overrunning workers are killed, the pool respawned, and the
# in-flight survivors re-dispatched.
TASK_RETRIES = int(os.environ.get("REPRO_TASK_RETRIES", "2"))
TASK_TIMEOUT = float(os.environ.get("REPRO_TASK_TIMEOUT", "0"))
RETRY_BACKOFF = float(os.environ.get("REPRO_RETRY_BACKOFF", "0.25"))

_ENGINES = ("auto", "host", "fused")


def _faults():
    # lazy: fault injection and run reporting live in repro_torch.exp
    from ..exp import faults
    return faults


def _check_engine(engine: str) -> None:
    """A per-group engine name; ``"bucketed"`` is a plan-level engine
    (``run_bucketed``), unknown here as in the JAX package."""
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def point_key(path: str) -> str:
    """Manifest key of one sweep point: the md5 basename of its sim
    result cache path (stable across hosts and cache roots)."""
    base = os.path.basename(path)
    return base[:-4] if base.endswith(".pkl") else base


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One cell of the evaluation cross-product."""
    config: str
    mix: str
    policy: Policy
    params: Optional[sim.SimParams] = None
    dram: DramModel = dataclasses.field(default_factory=default_model)

    def resolved_params(self) -> sim.SimParams:
        return self.params or sim.SimParams()

    def cache_path(self) -> str:
        return sim.result_cache_path(self.config, self.mix, self.policy,
                                     self.resolved_params(), self.dram)


# ---------------------------------------------------------------------------
# one-pass multi-policy group simulation
# ---------------------------------------------------------------------------
def simulate_group(config: str, mix: str, pols: Sequence[Policy],
                   params: Optional[sim.SimParams] = None,
                   dram: Optional[DramModel] = None,
                   deadline_cycles: Optional[float] = None,
                   core_traffic: bool = True, engine: str = "host",
                   device="cuda") -> List[sim.SimResult]:
    """Simulate several policies on one (config, mix) trace in one pass
    on ``device``; results in ``pols`` order, each bitwise the sequential
    ``sim.drive_lane`` of that policy alone.  ``engine`` is ``"host"``
    (the lane-batched per-epoch host loop), ``"fused"`` (the device-resident
    super-step engine, ``core/fused.py``) or ``"auto"`` (the fused engine
    for every eligible geometry batch; ``REPRO_FUSED=0`` pins it to the
    host loop).

    The default is ``"host"``, where the reference
    (``repro.core.sweep.simulate_group``) defaults to ``"auto"``: results
    are bitwise equal on either engine, and on the card the fused engine
    is the slower one (its host dispatch of ~300 small ops an epoch
    against one round-loop launch an epoch on the host engine; PERF.md
    section 5), so a group run on its own keeps the faster route.  Whole
    sweeps batch the fused engine across groups through ``run_bucketed``
    (``exp.ExecPlan``'s default with ``jobs=1``)."""
    _check_engine(engine)
    dev = _device.resolve(device)
    p = params or sim.SimParams()
    if dram is None:
        dram = default_model()
    if deadline_cycles is None:
        deadline_cycles = sim.calibrated_deadline(config, p, dram,
                                                  device=dev)
    art = sim.load_artifacts(config, mix, p, core_traffic)
    lanes = [sim.Lane(config, mix, pol, p, dram, float(deadline_cycles), art,
                      core_traffic, device=dev) for pol in pols]
    # partition into geometry-compatible sub-batches (stable order)
    batches: Dict[Tuple, List[sim.Lane]] = {}
    for lane in lanes:
        batches.setdefault(llc.geometry_key(lane.llc_cfg), []).append(lane)
    for batch in batches.values():
        if _use_fused(batch, engine):
            from . import fused
            fused.drive_lanes_fused(batch)
        else:
            _drive_lanes(batch, dev)
    return [lane.result() for lane in lanes]


def _use_fused(batch: List[sim.Lane], engine: str) -> bool:
    """Whether a geometry batch runs on the fused engine: ``"fused"``
    demands it (and raises for a batch it cannot take), ``"auto"`` takes
    it for an eligible batch unless ``REPRO_FUSED=0``, ``"host"`` never."""
    if engine == "host":
        return False
    if engine == "auto" and os.environ.get("REPRO_FUSED", "1") == "0":
        return False
    from . import fused
    eligible = all(fused.lane_supported(lane) for lane in batch)
    if engine == "fused" and not eligible:
        raise ValueError("engine='fused' requested for a lane batch "
                         "the fused engine does not support")
    return eligible


def _drive_lanes(lanes: List[sim.Lane], dev: torch.device) -> None:
    """Advance a geometry-compatible batch of lanes to completion.

    Each epoch: every active lane builds its event list on the host, the
    per-lane round chunks are padded to a common [L, R, S] block, and one
    ``simulate_epoch_lanes`` call advances all LLC states.  Padded rounds
    are invalid events (meta 0) -- no-ops for cache content, so per-lane
    results match the unpadded sequential engine exactly.  Finished lanes
    drop out; a lone survivor finishes in ``sim.drive_lane`` from its
    current LLC state.
    """
    cfg0 = lanes[0].llc_cfg
    num_sets = cfg0.num_sets
    pending = [lane for lane in lanes if lane.active]
    if not pending:
        return
    knobs = llc.lane_knobs([lane.llc_cfg for lane in pending], dev)
    states = llc.stack_states(cfg0, len(pending), dev)

    while pending:
        if len(pending) == 1:
            sim.drive_lane(pending[0], state=llc.lane_state(states, 0),
                           device=dev)
            return
        n_lanes = len(pending)
        evs = [lane.begin_epoch() for lane in pending]
        chunk_lists = [list(llc.build_rounds(cfg0, *ev))
                       if ev is not None else [] for ev in evs]
        st_sum, pc_sum = 0, 0
        n_chunks = max((len(cl) for cl in chunk_lists), default=0)
        for c in range(n_chunks):
            r_pad = max(cl[c][0].shape[0]
                        for cl in chunk_lists if len(cl) > c)
            line_b = np.full((n_lanes, r_pad, num_sets), -1, np.int32)
            meta_b = np.zeros((n_lanes, r_pad, num_sets), np.int32)
            for i, cl in enumerate(chunk_lists):
                if len(cl) > c:
                    lm, mm = cl[c]
                    line_b[i, :lm.shape[0]] = lm
                    meta_b[i, :mm.shape[0]] = mm
            states, st_b, pc_b = llc.simulate_epoch_lanes(
                cfg0, knobs, states, line_b, meta_b, device=dev)
            st_sum, pc_sum = st_sum + st_b, pc_sum + pc_b
        if n_chunks:
            stats = st_sum.cpu().numpy().astype(np.int64)
            percore = pc_sum.cpu().numpy().astype(np.int64)
        else:
            stats = np.zeros((n_lanes, len(llc.STAT_NAMES)), np.int64)
            percore = np.zeros((n_lanes, llc.NUM_CORES, 2), np.int64)
        for i, lane in enumerate(pending):
            lane_state = (llc.lane_state(states, i)
                          if lane.p.record_occupancy else None)
            lane.finish_epoch(stats[i], percore[i], llc_state=lane_state)
        # drop finished lanes so survivors stop paying for padding
        still = [i for i, lane in enumerate(pending) if lane.active]
        if len(still) < n_lanes:
            pending = [pending[i] for i in still]
            if pending:
                keep = torch.as_tensor(still, device=dev)
                knobs = llc.select_knobs(knobs, keep)
                states = llc.select_states(states, keep)


# ---------------------------------------------------------------------------
# whole sweep on the device: buckets of groups as one flat lane batch
# ---------------------------------------------------------------------------
def _artifact_digest(batch: List[sim.Lane]) -> str:
    """A digest of what a group's lanes were built from beyond their point:
    the trace and each lane's LERN tables (two synthetic traces of one
    point stage apart)."""
    h = hashlib.blake2b(digest_size=16)

    def add(a) -> None:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.reshape(-1).view(np.uint8))

    tr = batch[0].tr
    for a in (tr.line, tr.write, tr.layer):
        add(a)
    for lane in batch:
        if lane.clusters is None:
            h.update(b"-")
        else:
            for k in ("rc", "ri", "cold_center"):
                add(lane.clusters[k])
    return h.hexdigest()


def _staged_for(batch_list: List[List[sim.Lane]],
                devs: Optional[List[torch.device]] = None):
    """Staged device constants for one bucket slab, through the module
    staging cache (least recently used out past ``STAGE_CACHE_CAP``), each
    group's on its shard's device (``devs``, from ``fused.shard_devices``;
    default: one shard on the lanes' device).  The key is everything that
    fixes the staged buffers: the bucket's static shape, each group's
    point (config, mix, policy roster, params and DRAM model, deadline),
    the slab's pads, the super-step length and round capacity, the shard's
    device and the digest of the trace and LERN tables.  A cached entry
    whose tables an online-LERN retrain swapped (``stale``) stages
    afresh."""
    from . import fused
    if _faults().fire("stage_evict", key=f"{len(batch_list)}g") is not None:
        # injected eviction of the staged buffers: everything stages
        # afresh from the host copies (a cost, never a different result)
        _STAGE_CACHE.clear()
    pads = fused.bucket_pads(batch_list)
    devs = devs or [batch_list[0][0].device]
    per = len(batch_list) // len(devs)
    staged = []
    for i, batch in enumerate(batch_list):
        lane0 = batch[0]
        sdev = devs[i // per]
        key = (fused.bucket_key(batch), lane0.config, lane0.mix,
               tuple(repr(lane.policy) for lane in batch),
               _params_key(lane0.p, lane0.dram), float(lane0.deadline),
               pads, fused.DEFAULT_SUPERSTEP, fused.DEFAULT_MAX_ROUNDS,
               str(sdev), _artifact_digest(batch))
        hit = _STAGE_CACHE.get(key)
        if hit is None or hit.stale:
            hit = fused.stage_group(batch, pads=pads, device=sdev)
            _STAGE_CACHE[key] = hit
        _STAGE_CACHE.move_to_end(key)
        while len(_STAGE_CACHE) > STAGE_CACHE_CAP:
            _STAGE_CACHE.popitem(last=False)
        staged.append(hit)
    return staged


def _make_task_lanes(task, dev: torch.device) -> List[sim.Lane]:
    """Fresh lanes (one per policy) of one group task from the cached
    artifacts: cheap to rebuild, which makes demotion safe -- a failed
    bucket never patches half-advanced state, it recomputes the group."""
    config, mix, pols, params, dram, _paths = task
    p = params or sim.SimParams()
    deadline = sim.calibrated_deadline(config, p, dram, device=dev)
    art = sim.load_artifacts(config, mix, p, True)
    return [sim.Lane(config, mix, pol, p, dram, float(deadline), art, True,
                     device=dev) for pol in pols]


def _demote_batch(task, poss: List[int], dev: torch.device
                  ) -> Tuple[List[sim.Lane], str]:
    """The degrade ladder's second and third rungs: the ``poss`` lanes of
    ``task`` on the per-group fused engine, and if that fails degradably,
    on the host loop -- each from fresh lanes on ``dev`` (the card of the
    group's shard), so the results are the same whichever rung finishes
    the group."""
    flt = _faults()
    from . import fused
    config, mix = task[0], task[1]

    def fresh():
        lanes = _make_task_lanes(task, dev)
        return [lanes[j] for j in poss]

    try:
        sel = fresh()
        flt.fire("fused", key=f"{config}|{mix}")
        fused.drive_lanes_fused(sel)
        return sel, "fused"
    except Exception as e:
        if not flt.degradable(e):
            raise
        flt.log_event("degrade", ladder="fused->host",
                      task=f"{config}|{mix}", error=str(e)[:200])
        sel = fresh()
        _drive_lanes(sel, dev)
        return sel, "host"


def simulate_bucket(tasks: Sequence[Tuple], devices: Optional[int] = None,
                    pipeline: Optional[bool] = None,
                    task_keys: Optional[List[List[str]]] = None,
                    device="cuda") -> List[List[sim.SimResult]]:
    """Simulate many ``(config, mix, pols, params, dram, paths)`` group
    tasks at once on ``device``: geometry batches are bucketed by the fused
    engine's static shape (``fused.bucket_key``) and each bucket slab of
    up to ``BUCKET_GROUPS`` groups runs as one flat lane batch
    (``fused.drive_lanes_bucketed``).  Equal to per-task
    ``simulate_group`` bitwise.  Batches the fused engine cannot take run
    on the host loop; a slab that fails degradably walks the ladder
    bucketed -> per-group fused -> host from fresh lanes.  Each finished
    point is dumped to its ``paths`` entry (empty paths skip the cache)
    and, with ``task_keys``, reported done.  Staged constants ride the
    staging cache (``_staged_for``); ``devices`` and ``pipeline`` go to
    ``fused.drive_lanes_bucketed``: a slab's groups shard over ``devices``
    cards (None: every visible card on ``"cuda"``, 1 on the CPU; on the
    CPU any count is shards on the CPU), a demoted group replays on its
    shard's card, and a ``devices`` above the visible cards raises
    ``ValueError`` before any work.
    Returns per-task result lists in task order."""
    from . import fused
    dev = _device.resolve(device)
    fused.check_devices(devices, dev)
    flt = _faults()
    task_lanes: List[List[sim.Lane]] = []
    task_engines: List[set] = []
    # bucket members carry (batch, task index, lane positions), so that a
    # demoted batch can be rebuilt into its task's roster
    buckets: Dict[Tuple, List[Tuple[List[sim.Lane], int, List[int]]]] = {}
    host_batches: List[List[sim.Lane]] = []
    for ti, task in enumerate(tasks):
        lanes = _make_task_lanes(task, dev)
        task_lanes.append(lanes)
        task_engines.append(set())
        batches: Dict[Tuple, List[int]] = {}
        for j, lane in enumerate(lanes):
            batches.setdefault(llc.geometry_key(lane.llc_cfg),
                               []).append(j)
        for poss in batches.values():
            batch = [lanes[j] for j in poss]
            if all(fused.lane_supported(lane) for lane in batch):
                buckets.setdefault(fused.bucket_key(batch),
                                   []).append((batch, ti, poss))
                task_engines[ti].add("bucketed")
            else:
                host_batches.append(batch)
                task_engines[ti].add("host")
    for batch_list in buckets.values():
        for lo in range(0, len(batch_list), BUCKET_GROUPS):
            slab = batch_list[lo:lo + BUCKET_GROUPS]
            groups = [b for b, _ti, _poss in slab]
            devs = fused.shard_devices(len(groups), devices, dev)
            try:
                flt.fire("bucket", key=f"{len(groups)}g")
                fused.drive_lanes_bucketed(groups, devices=devices,
                                           staged=_staged_for(groups, devs),
                                           pipeline=pipeline)
            except Exception as e:
                if not flt.degradable(e):
                    raise
                flt.log_event("degrade", ladder="bucketed->fused",
                              groups=len(groups), error=str(e)[:200])
                per = len(groups) // len(devs)
                for g, (_batch, ti, poss) in enumerate(slab):
                    sel, rung = _demote_batch(tasks[ti], poss,
                                              devs[g // per])
                    for j, lane in zip(poss, sel):
                        task_lanes[ti][j] = lane
                    task_engines[ti].add(rung)
    for batch in host_batches:
        _drive_lanes(batch, dev)
    out: List[List[sim.SimResult]] = []
    for ti, (task, lanes) in enumerate(zip(tasks, task_lanes)):
        results = [lane.result() for lane in lanes]
        for res, path in zip(results, task[5]):
            sim._atomic_dump(res, path)
        engs = task_engines[ti]
        eng = ("host" if "host" in engs else
               "fused" if "fused" in engs else "bucketed")
        if task_keys is not None:
            for key in task_keys[ti]:
                flt.point_done(key, source="computed", engine=eng)
        out.append(results)
    return out


# ---------------------------------------------------------------------------
# cross-group orchestration (process pool + disk-cache dedup)
# ---------------------------------------------------------------------------
def _params_key(p: sim.SimParams, dram: DramModel) -> str:
    return json.dumps({"par": dataclasses.asdict(p), "d": dram.name},
                      sort_keys=True, default=str)


# the start barrier of the pool a worker belongs to (set in _worker_init)
_START = None


def _worker_init(cache_root: str, extra_configs: Optional[Dict] = None,
                 fit_engine: Optional[str] = None, device: str = "cuda",
                 threads: Optional[int] = None, start=None) -> None:
    """Spawn-pool worker set-up.  ``cache_root`` carries a programmatic
    cache override (``REPRO_CACHE`` set after the caller's import) to the
    worker's artifact and result caches; ``fit_engine`` pins the LERN fit
    engine (a worker does not see the caller's ``lern.fit_engine_override``);
    configs registered at run time in the caller are registered again
    (spawn imports ``workloads.py`` afresh).  The worker opens its own
    CUDA context on the caller's ``device`` here, takes the caller's
    intra-op thread count (``threads``) and keeps the pool's ``start``
    barrier for ``_worker_started``."""
    global _START
    _START = start
    os.environ["REPRO_CACHE"] = cache_root
    if threads is not None:
        torch.set_num_threads(threads)
    if fit_engine is not None:
        from . import lern as lern_mod
        lern_mod.FIT_ENGINE = fit_engine
    if extra_configs:
        from .workloads import CONFIGS
        for name, cfg in extra_configs.items():
            CONFIGS.setdefault(name, cfg)
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)


def _worker_started(_i: int) -> int:
    """A pool's warm-up task: returns (the worker's pid) once every worker
    of the pool has started and holds one such task."""
    _START.wait()
    return os.getpid()


def _calibrate_task(task, dev) -> float:
    config, params, dram = task
    return sim.calibrated_deadline(config, params, dram, device=dev)


def _prepare_lern(tasks, dev: torch.device) -> None:
    """Family-batched LERN training for every uncached (variant, trace
    size): one fit for a whole config family up front, so group tasks
    only read the cache (under the bucketed engine only the small traces,
    ``sim.family_cap``; the rest train inside their groups)."""
    fam: Dict[Tuple, List[str]] = {}
    for config, _mix, pols, params, _dram, _paths in tasks:
        for pol in pols:
            if pol.accel_predictor == "lern":
                key = (pol.lrpt_variant, params.subsample_target)
                configs = fam.setdefault(key, [])
                if config not in configs:
                    configs.append(config)
    for (variant, sub), configs in fam.items():
        sim.load_lern_family(configs, variant, sub, family_only=True,
                             device=dev)


def _group_task(task, engine: str, dev: torch.device) -> List[sim.SimResult]:
    """Simulate one policy group and persist each point."""
    config, mix, pols, params, dram, paths = task
    # named injection site: raise faults land here to exercise the retry
    _faults().fire("task", key=f"{config}|{mix}")
    results = simulate_group(config, mix, list(pols), params, dram,
                             engine=engine, device=dev)
    for res, path in zip(results, paths):
        sim._atomic_dump(res, path)
    return results


class TaskError(RuntimeError):
    """Picklable worker-task failure carrying the worker's buffered fault
    events (quarantines, injections) back to the caller, so that a failed
    task still adds its fault log to the RunReport."""

    def __init__(self, cause: str, msg: str, events: List[Dict]):
        super().__init__(f"{cause}: {msg}")
        self.cause = cause
        self.events = events

    def __reduce__(self):
        return (TaskError, (self.cause,
                            str(self).split(": ", 1)[-1], self.events))


def _pool_task(task, engine: str, device: str):
    """A pool worker's group task on ``device``: a worker has no active
    RunReport, so its fault events buffer locally; the buffer is drained
    and sent back with the results (or inside :class:`TaskError`), and the
    caller folds it into its report."""
    flt = _faults()
    try:
        results = _group_task(task, engine, _device.resolve(device))
    except Exception as e:
        raise TaskError(type(e).__name__, str(e)[:500],
                        flt.drain_events()) from None
    return results, flt.drain_events()


def _plan_tasks(points: Sequence[SweepPoint], max_lanes: int,
                cache: bool = True):
    """Cache reads (when ``cache``), duplicate-point dedup, grouping by
    (config, mix, params, dram) and chunking into <= ``max_lanes`` policy
    lanes.

    Returns ``(results, tasks, task_idxs, task_keys, calib, seen_paths)``
    -- ``results`` pre-filled with cache hits, ``tasks`` as ``(config,
    mix, pols, params, dram, paths)`` tuples (empty paths when ``cache`` is
    off, so the executors skip the dump), ``task_keys`` the per-task
    manifest point keys, ``calib`` the unique ``(config, params, dram)``
    deadline calibrations.  Corrupt cache entries are quarantined and the
    point recomputed (``sim.cache_load``)."""
    flt = _faults()
    results: List[Optional[sim.SimResult]] = [None] * len(points)
    seen_paths: Dict[str, List[int]] = {}
    groups: Dict[str, List[Tuple[int, SweepPoint, str]]] = {}
    for idx, pt in enumerate(points):
        path = pt.cache_path()
        if path in seen_paths:          # duplicate point: fill from twin
            seen_paths[path].append(idx)
            continue
        seen_paths[path] = [idx]
        if cache:
            v = sim.cache_load(path)
            if v is not sim.MISS:
                results[idx] = v
                flt.point_done(point_key(path), source="cache")
                continue
        key = (f"{pt.config}|{pt.mix}|"
               f"{_params_key(pt.resolved_params(), pt.dram)}")
        groups.setdefault(key, []).append((idx, pt, path))

    tasks = []
    task_idxs: List[List[int]] = []
    task_keys: List[List[str]] = []
    calib: Dict[str, Tuple] = {}
    for members in groups.values():
        first = members[0][1]
        params, dram = first.resolved_params(), first.dram
        calib.setdefault(f"{first.config}|{_params_key(params, dram)}",
                         (first.config, params, dram))
        for lo in range(0, len(members), max_lanes):
            chunk = members[lo:lo + max_lanes]
            tasks.append((first.config, first.mix,
                          tuple(pt.policy for _, pt, _ in chunk),
                          params, dram,
                          tuple(path for _, _, path in chunk) if cache
                          else ()))
            task_idxs.append([idx for idx, _, _ in chunk])
            task_keys.append([point_key(path) for _, _, path in chunk])
    return results, tasks, task_idxs, task_keys, calib, seen_paths


def _fill_twins(results, seen_paths) -> None:
    for _path, idxs in seen_paths.items():
        for idx in idxs[1:]:
            results[idx] = results[idxs[0]]


def _run_task_inline(task, engine: str, retries: int,
                     dev: torch.device) -> Tuple:
    """Resilient execution of one group task: retry with exponential
    backoff, then a final attempt on the host engine.  Returns (results,
    attempts, engine)."""
    flt = _faults()
    attempts = 0
    while True:
        attempts += 1
        eng = engine if attempts <= retries else "host"
        try:
            return _group_task(task, eng, dev), attempts, eng
        except NotImplementedError:
            raise
        except Exception as e:
            if attempts > retries:
                raise
            flt.log_event("task_retry", task=f"{task[0]}|{task[1]}",
                          attempt=attempts, error=str(e)[:200])
            time.sleep(min(RETRY_BACKOFF * 2 ** (attempts - 1), 5.0))


def _run_pool(tasks, calib, engine: str, fit_engine: Optional[str],
              jobs: int, timeout: float, retries: int,
              dev: torch.device) -> List[Tuple]:
    """Spawn-pool execution of the group tasks on ``dev`` with the whole
    recovery stack: per-task retry with backoff, ``BrokenProcessPool``
    detection with a respawn of the pool and re-dispatch of the survivors,
    a wall-clock watchdog that kills overrunning workers (``timeout`` > 0),
    and a last attempt in the caller on the host engine once a task has
    used its retries.  Every attempt runs on ``dev`` with the same kernels,
    so a kernel that fails to build or launch fails the run.  A task that
    raises ``NotImplementedError`` is not retried: it raises here.
    Returns per-task ``(results, attempts, engine)`` in task order."""
    import multiprocessing as mp
    from concurrent.futures import FIRST_COMPLETED, wait
    from concurrent.futures.process import BrokenProcessPool

    from .workloads import CONFIGS

    flt = _faults()
    if dev.type == "cuda":
        # every library once, here: workers only load them, so that no
        # nvcc runs against a watchdog clock in N workers at once
        from ..kernels import _build
        _build.build()
    # spawn, never fork: the caller may already hold a CUDA context
    ctx = mp.get_context("spawn")
    workers = min(jobs, len(tasks))
    # each task's config: runtime registrations (drift variants, ad-hoc
    # AccelConfigs) do not survive the spawn import
    extra = {t[0]: CONFIGS[t[0]] for t in tasks}
    initargs = (os.path.dirname(sim.cache_dir()), extra, fit_engine,
                str(dev), torch.get_num_threads())
    run_task = functools.partial(_pool_task, engine=engine, device=str(dev))
    calibrate = functools.partial(_calibrate_task, dev=str(dev))

    results: List[Optional[Tuple]] = [None] * len(tasks)
    attempts = [0] * len(tasks)
    pending: List[int] = list(range(len(tasks)))
    running: Dict = {}          # future -> task index
    deadlines: Dict = {}        # future -> monotonic watchdog deadline
    ex: Optional[ProcessPoolExecutor] = None

    def discard_pool(kill: bool = False) -> None:
        nonlocal ex
        if ex is None:
            return
        if kill:
            # a hung or wedged worker never drains the shutdown sentinel:
            # kill every worker, so that shutdown cannot block behind one
            for proc in list(getattr(ex, "_processes", {}).values()):
                try:
                    proc.kill()
                except Exception:
                    pass
        ex.shutdown(wait=False, cancel_futures=True)
        ex = None

    def start_pool() -> None:
        nonlocal ex
        start = ctx.Barrier(workers)
        ex = ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                 initializer=_worker_init,
                                 initargs=initargs + (start,))
        # the executor starts a spawn worker only when a task finds none
        # idle, so one warm-up task a worker, each held at the barrier
        # until all have started: every worker is up (its CUDA context
        # open) before the first group task, and the watchdog clock times
        # work, not start-up.  A pool that cannot start raises here.
        list(ex.map(_worker_started, range(workers)))

    def new_pool() -> None:
        start_pool()
        # the deadline calibrations next, one task per unique (config,
        # params, dram), before any group task; they land in the disk
        # cache, so the run after a respawn only reads them
        try:
            list(ex.map(calibrate, calib.values()))
        except Exception as e:
            flt.log_event("calibration_fallback", error=str(e)[:200])
            discard_pool(kill=True)
            for t in calib.values():
                _calibrate_task(t, dev)
            start_pool()

    def handle_failure(i: int, kind: str, err: str) -> None:
        if attempts[i] > retries:
            # the retries are spent: a last attempt in the caller, on the
            # host engine and the same device
            flt.log_event("inline_fallback",
                          task=f"{tasks[i][0]}|{tasks[i][1]}",
                          attempts=attempts[i], cause=kind)
            attempts[i] += 1
            results[i] = (_group_task(tasks[i], "host", dev), attempts[i],
                          "host")
        else:
            flt.log_event("task_retry", task=f"{tasks[i][0]}|{tasks[i][1]}",
                          attempt=attempts[i], cause=kind, error=err[:200])
            time.sleep(min(RETRY_BACKOFF * 2 ** (attempts[i] - 1), 5.0))
            pending.append(i)

    try:
        while pending or running:
            if ex is None and pending:
                new_pool()
            # one in-flight task per worker: with nothing queued in the
            # executor, a submitted future is running, so the watchdog
            # clock measures work, not queue wait
            while pending and len(running) < workers:
                i = pending.pop(0)
                attempts[i] += 1
                fut = ex.submit(run_task, tasks[i])
                running[fut] = i
                if timeout > 0:
                    deadlines[fut] = time.monotonic() + timeout
            done, _ = wait(set(running), return_when=FIRST_COMPLETED,
                           timeout=0.25 if timeout > 0 else None)
            pool_broken = False
            for fut in done:
                i = running.pop(fut)
                deadlines.pop(fut, None)
                try:
                    rs, wevents = fut.result()
                    flt.merge_events(wevents)
                    results[i] = (rs, attempts[i], engine)
                    continue
                except BrokenProcessPool as e:
                    pool_broken = True
                    kind, err = "worker_crash", str(e)
                except TaskError as e:
                    flt.merge_events(e.events)
                    if e.cause == "NotImplementedError":
                        raise NotImplementedError(
                            str(e).split(": ", 1)[-1]) from None
                    kind, err = "task_error", str(e)
                except Exception as e:
                    kind, err = "task_error", str(e)
                handle_failure(i, kind, err)
            if pool_broken:
                # a worker died mid-task and every in-flight future is
                # lost with it: respawn the pool and re-dispatch the
                # survivors without charging their retries
                flt.log_event("worker_crash", respawn=True,
                              inflight=len(running))
                for fut, i in list(running.items()):
                    attempts[i] -= 1
                    pending.append(i)
                running.clear()
                deadlines.clear()
                discard_pool(kill=True)
                continue
            now = time.monotonic()
            overdue = [fut for fut, dl in deadlines.items()
                       if dl < now and not fut.done()]
            if overdue:
                # the watchdog: the pool cannot kill one worker, so kill
                # them all, fail the overdue tasks, and re-dispatch the
                # innocent in-flight survivors without charging them
                over_idx = {running[fut] for fut in overdue}
                flt.log_event(
                    "watchdog_kill", timeout=timeout,
                    tasks=[f"{tasks[i][0]}|{tasks[i][1]}"
                           for i in sorted(over_idx)])
                discard_pool(kill=True)
                survivors = [i for fut, i in running.items()
                             if i not in over_idx]
                running.clear()
                deadlines.clear()
                for i in survivors:
                    attempts[i] -= 1
                    pending.append(i)
                for i in sorted(over_idx):
                    handle_failure(i, "watchdog", "task exceeded "
                                   f"{timeout}s wall clock")
    finally:
        discard_pool(kill=bool(running))
    return results  # every slot is a (results, attempts, engine) triple


def map_points(points: Sequence[SweepPoint], jobs: int = 1,
               max_lanes: int = MAX_LANES, engine: str = "host",
               fit_engine: Optional[str] = None,
               report=None, task_timeout: Optional[float] = None,
               retries: Optional[int] = None,
               device="cuda") -> List[sim.SimResult]:
    """Evaluate a list of sweep points on ``device``, batched and
    (optionally) in parallel, with the sim disk cache as the dedup layer.

    Cached points are loaded and skipped; duplicate points run once; the
    rest are grouped by (config, mix, params, dram) and chunked into <=
    ``max_lanes`` policy lanes.  Uncached LERN models train first,
    family-batched, in the caller.  The groups run in turn for ``jobs <=
    1`` or a single group, else on a spawn process pool of ``jobs``
    workers, each on ``device`` (``fit_engine`` pins the LERN fit engine
    inside the workers; in the caller it is the ambient one,
    ``lern.fit_engine_override``).  Every finished point is written to the
    cache atomically.  ``report`` (a ``faults.RunReport``) receives
    per-point records and every fault/recovery event, the workers' too.
    Returns results in ``points`` order.

    Execution is resilient: a failing group retries ``retries`` times
    (default ``REPRO_TASK_RETRIES``) with exponential backoff, then runs
    once more on the host engine; on the pool a dead worker respawns the
    pool and re-dispatches the in-flight survivors, and ``task_timeout``
    (default ``REPRO_TASK_TIMEOUT``, 0 = off) arms a per-task wall-clock
    watchdog.  Recovery recomputes from cached artifacts, so results stay
    bitwise equal to a fault-free run.

    ``engine`` defaults to ``"host"`` where the reference
    (``repro.core.sweep.map_points``) defaults to ``"auto"``, for the
    reason ``simulate_group`` gives: equal results, and the host engine is
    the faster one on the card."""
    _check_engine(engine)
    dev = _device.resolve(device)
    flt = _faults()
    retries = TASK_RETRIES if retries is None else retries
    timeout = TASK_TIMEOUT if task_timeout is None else task_timeout
    with flt.activate(), flt.reporting(report):
        results, tasks, task_idxs, task_keys, calib, seen_paths = \
            _plan_tasks(points, max_lanes, cache=True)
        if tasks:
            _prepare_lern(tasks, dev)
            if jobs <= 1 or len(tasks) == 1:
                task_results = [_run_task_inline(t, engine, retries, dev)
                                for t in tasks]
            else:
                task_results = _run_pool(tasks, calib, engine, fit_engine,
                                         jobs, timeout, retries, dev)
            for idxs, keys, (rs, n_att, eng) in zip(task_idxs, task_keys,
                                                    task_results):
                for idx, res in zip(idxs, rs):
                    results[idx] = res
                for key in keys:
                    flt.point_done(key, source="computed", engine=eng,
                                   attempts=n_att)
        _fill_twins(results, seen_paths)
    return results  # type: ignore[return-value]


def run_bucketed(points: Sequence[SweepPoint], max_lanes: int = MAX_LANES,
                 devices: Optional[int] = None, cache: bool = True,
                 pipeline: Optional[bool] = None, report=None,
                 device="cuda") -> List[sim.SimResult]:
    """The bucketed twin of ``map_points`` on ``device``: the same front half
    (cache reads when ``cache``, dedup, grouping, chunking), the deadline
    calibrations resolved once up front, then every uncached group at once
    through ``simulate_bucket`` -- the whole sweep on the card instead of
    group by group.  ``pipeline`` goes to the bucketed engine (None =
    ``REPRO_BUCKET_PIPELINE``); ``devices`` shards each bucket's groups
    over cards as ``simulate_bucket`` says (None: every visible card), and
    one above the visible cards raises ``ValueError`` before any work.
    ``report`` receives per-point records and fault events.  Returns
    results in ``points`` order, bitwise those of ``map_points``, whatever
    ``devices``."""
    from . import fused
    dev = _device.resolve(device)
    fused.check_devices(devices, dev)
    flt = _faults()
    with flt.activate(), flt.reporting(report):
        results, tasks, task_idxs, task_keys, calib, seen_paths = \
            _plan_tasks(points, max_lanes, cache=cache)
        if tasks:
            _prepare_lern(tasks, dev)
            # every (config, params, dram) deadline once, up front, so that
            # building a task's lanes only reads the calibration cache
            for t in calib.values():
                _calibrate_task(t, dev)
            bucket_rs = simulate_bucket(tasks, devices, pipeline,
                                        task_keys=task_keys, device=dev)
            for idxs, rs in zip(task_idxs, bucket_rs):
                for idx, res in zip(idxs, rs):
                    results[idx] = res
        _fill_twins(results, seen_paths)
    return results  # type: ignore[return-value]
