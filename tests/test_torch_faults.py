"""The port's chaos suite, held against the JAX one (tests/test_faults.py).

Every recovery of the port's execution layer -- quarantining a damaged
cache entry, respawning the process pool after a worker dies, killing a
hung worker on the watchdog, retrying a raising task -- must be bitwise
transparent: a faulted run equals the clean run.  The clean run is the JAX
package's ``sweep.map_points(jobs=1)`` on the suite's four tiny points
(``config1``, ``moti1``/``moti2`` x ``fifo-nb``/``arp-cs-as``), computed
in the ``chaos`` mode of the ``tests/test_torch_sim.py`` child; the port's
inline runs (``jobs=1``) and its spawn pool (``jobs=2``, workers on the
CPU) are held to it under every plan, and so are random fault plans over
the bucketed engine (the JAX suite's seeded stand-in for its hypothesis
property).

The JAX suite's bucketed-ladder, manifest and refit cases have their
counterparts in tests/test_torch_bucketed.py, tests/test_torch_exp.py and
tests/test_torch_serve.py.

Every test starts with a cache of its own that holds the points' trace
and calibration but no result, an empty fault buffer, staging cache and
engine counts, and sets the environment only through ``monkeypatch`` or
``faults.activate``.
"""
import dataclasses
import os
import pickle
import random
import shutil

import numpy as np
import pytest
import torch

from test_torch_sim import (  # noqa: F401 (fixture)
    CHAOS, TINY, chaos_points, run_child, torch_one_thread)

from repro_torch import exp
from repro_torch.core import fused, policies, sim, sweep
from repro_torch.exp import faults

pytestmark = pytest.mark.usefixtures("torch_one_thread")

POLS = CHAOS["policies"]
MIXES = CHAOS["mixes"]
# a tiny group task on warm artifacts takes about a second on the CPU; the
# watchdog gives it six times that, so only the hung worker is overdue
WATCHDOG_S = 6.0
_ENV = ("REPRO_FAULTS", "REPRO_ENGINE", "REPRO_FUSED", "REPRO_LERN_FIT",
        "REPRO_DRAM", "REPRO_MANIFEST", "REPRO_RESUME",
        "REPRO_BUCKET_PIPELINE")


def _points(mixes=MIXES):
    return chaos_points(sim, sweep, policies, mixes)


def _plan(*specs, **kw):
    return faults.FaultPlan.make([faults.FaultSpec(**s) for s in specs],
                                 **kw)


def _seal():
    faults.drain_events()
    sweep._STAGE_CACHE.clear()
    fused.reset_counts()
    fused.reset_phase_times()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, torch_one_thread):
    """The four points' trace and deadline calibration, computed once by
    the port; each test's cache starts from a copy of them (and no
    result), so that a test pays for its own runs only."""
    root = tmp_path_factory.mktemp("chaos_artifacts")
    with pytest.MonkeyPatch.context() as mp:
        for k in _ENV:
            mp.delenv(k, raising=False)
        mp.setenv("REPRO_CACHE", str(root))
        sweep.map_points(_points(), device="cpu")
    shutil.rmtree(root / "torch" / "sim")
    faults.drain_events()
    return root / "torch"


def _fresh_cache(monkeypatch, root, artifacts) -> None:
    """Point ``REPRO_CACHE`` at ``root``, holding the artifacts only."""
    shutil.copytree(artifacts, root / "torch")
    monkeypatch.setenv("REPRO_CACHE", str(root))


@pytest.fixture(autouse=True)
def sealed(tmp_path, monkeypatch, artifacts):
    """A result cache of the test's own (``REPRO_CACHE``, the artifacts
    copied in), the run's env vars cleared, the retry backoff restored and
    the module state emptied before and after."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    _fresh_cache(monkeypatch, tmp_path / "cache", artifacts)
    monkeypatch.setattr(sweep, "RETRY_BACKOFF", sweep.RETRY_BACKOFF)
    _seal()
    yield
    _seal()


@pytest.fixture(scope="session")
def clean_baseline(tmp_path_factory):
    """The fault-free oracle: the JAX ``map_points(jobs=1)`` on the four
    points from an empty cache, run in the reference child."""
    d = tmp_path_factory.mktemp("ref_chaos")
    out = str(d / "chaos.pkl")
    run_child("chaos", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


def _host_values(x) -> bool:
    """Only Python and numpy values: what crosses from a worker holds no
    tensor (and so nothing of a CUDA context)."""
    if isinstance(x, dict):
        return all(_host_values(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_host_values(v) for v in x)
    return x is None or isinstance(x, (bool, int, float, str, np.generic,
                                       np.ndarray))


def _assert_clean(got, want, who=""):
    assert len(got) == len(want)
    for res, ref in zip(got, want):
        assert dataclasses.asdict(res) == ref, (res.mix, res.policy, who)


# ---------------------------------------------------------------------------
# the cache envelope: checksums, quarantine, durability
# ---------------------------------------------------------------------------
def test_envelope_roundtrip_and_quarantine():
    root = sim.cache_dir()
    path = os.path.join(root, "entry.pkl")
    sim._atomic_dump({"a": 1}, path)
    assert sim.cache_load(path) == {"a": 1}
    assert sim.cache_load(os.path.join(root, "absent.pkl")) is sim.MISS
    qdir = os.path.join(root, "quarantine")

    # a bare pickle without the envelope: quarantined, reported as a miss
    legacy = os.path.join(root, "legacy.pkl")
    with open(legacy, "wb") as f:
        pickle.dump({"old": True}, f)
    assert sim.cache_load(legacy) is sim.MISS
    assert not os.path.exists(legacy)
    assert any(p.startswith("legacy.pkl.") for p in os.listdir(qdir))

    # bit rot in the payload: the crc catches it
    sim._atomic_dump([1, 2, 3], path)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    assert sim.cache_load(path) is sim.MISS
    assert not os.path.exists(path)

    # truncation
    sim._atomic_dump([4, 5, 6], path)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    assert sim.cache_load(path) is sim.MISS
    assert len(os.listdir(qdir)) == 3
    reasons = [e["reason"] for e in faults.drain_events()
               if e["kind"] == "quarantine"]
    assert reasons == ["bad_magic", "crc_mismatch", "crc_mismatch"]


def test_corrupt_cache_entry_recomputed_bitwise(clean_baseline):
    """The sweep's cache read quarantines a damaged result entry and
    recomputes the point instead of failing the sweep."""
    pts = _points()
    _assert_clean(sweep.map_points(pts, jobs=1, device="cpu"),
                  clean_baseline, "first")
    victim = pts[0].cache_path()
    with open(victim, "r+b") as f:
        f.seek(4)
        f.write(b"\x00\x00\x00\x00")
    report = faults.RunReport()
    again = sweep.map_points(pts, jobs=1, report=report, device="cpu")
    _assert_clean(again, clean_baseline, "again")
    assert any(e["kind"] == "quarantine" for e in report.events)
    recs = report.points
    assert recs[sweep.point_key(victim)]["source"] == "computed"
    assert recs[sweep.point_key(pts[2].cache_path())]["source"] == "cache"
    # the recomputed entry is committed and sound again
    assert sim.cache_load(victim) is not sim.MISS


def test_injected_cache_read_fault_recovers(clean_baseline):
    """The ``cache_read`` site damages the entry on disk, so the real
    quarantine and recompute run end to end."""
    pts = _points()
    sweep.map_points(pts, jobs=1, device="cpu")
    report = faults.RunReport()
    plan = _plan({"site": "cache_read", "kind": "truncate",
                  "match": os.path.basename(pts[1].cache_path())})
    with faults.activate(plan):
        rs = sweep.map_points(pts, jobs=1, report=report, device="cpu")
    _assert_clean(rs, clean_baseline)
    kinds = [e["kind"] for e in report.events]
    assert "fault" in kinds and "quarantine" in kinds
    assert report.points[sweep.point_key(pts[1].cache_path())]["source"] \
        == "computed"


def test_atomic_dump_torn_write_preserves_committed():
    """A kill mid-write (the temp file written and synced, the rename
    never run) leaves the committed entry whole."""
    root = sim.cache_dir()
    path = os.path.join(root, "entry.pkl")
    sim._atomic_dump({"gen": 1}, path)
    with faults.activate(_plan({"site": "cache_dump", "kind": "torn"})):
        with pytest.raises(faults.InjectedFault):
            sim._atomic_dump({"gen": 2}, path)
    assert sim.cache_load(path) == {"gen": 1}
    # the half-written temp file is there and never shadowed the entry
    assert any(p.endswith(".tmp") for p in os.listdir(root))
    # a corrupt committed write is caught by the next read, not trusted
    with faults.activate(_plan({"site": "cache_dump", "kind": "corrupt"})):
        sim._atomic_dump({"gen": 3}, path)
    assert sim.cache_load(path) is sim.MISS
    sim._atomic_dump({"gen": 4}, path)
    assert sim.cache_load(path) == {"gen": 4}


# ---------------------------------------------------------------------------
# the process pool: clean, crash, raise, hang; the inline retry
# ---------------------------------------------------------------------------
def test_pool_matches_jax_baseline(clean_baseline, tmp_path, monkeypatch,
                                   artifacts):
    """The port's inline run and its pool of two workers (two group
    tasks, one a mix) equal the JAX clean run bitwise, and what the
    workers send back holds only host values."""
    inline = sweep.map_points(_points(), jobs=1, device="cpu")
    _assert_clean(inline, clean_baseline, "inline")
    _fresh_cache(monkeypatch, tmp_path / "pool", artifacts)
    report = faults.RunReport()
    pool = sweep.map_points(_points(), jobs=2, report=report, device="cpu")
    _assert_clean(pool, clean_baseline, "pool")
    assert all(_host_values(dataclasses.asdict(r)) for r in pool)
    assert {r["source"] for r in report.points.values()} == {"computed"}
    assert {r["engine"] for r in report.points.values()} == {"host"}
    assert not report.events


def test_worker_crash_respawns_and_stays_bitwise(clean_baseline):
    plan = _plan({"site": "task", "kind": "crash"})
    report = faults.RunReport()
    with faults.activate(plan):
        rs = sweep.map_points(_points(), jobs=2, report=report,
                              device="cpu")
    _assert_clean(rs, clean_baseline)
    crashes = [e for e in report.events if e["kind"] == "worker_crash"]
    assert crashes and crashes[0]["respawn"] is True
    assert report.summary()["points"] == 4
    assert all(r["source"] == "computed" for r in report.points.values())


def test_worker_fault_events_propagate_to_parent(clean_baseline,
                                                 monkeypatch):
    """Events fired inside workers come back to the caller -- with the
    results on success (a ``cache_dump`` corruption while the worker
    commits a point), inside ``sweep.TaskError`` on failure (``task``
    raise) -- and land in its report tagged ``origin="worker"``."""
    monkeypatch.setattr(sweep, "RETRY_BACKOFF", 0.01)
    pts = _points()
    plan = _plan({"site": "task", "kind": "raise"},
                 {"site": "cache_dump", "kind": "corrupt",
                  "match": os.path.basename(pts[0].cache_path())})
    report = faults.RunReport()
    with faults.activate(plan):
        rs = sweep.map_points(pts, jobs=2, report=report, device="cpu")
    _assert_clean(rs, clean_baseline)
    wfaults = {e["site"] for e in report.events
               if e["kind"] == "fault" and e.get("origin") == "worker"}
    assert {"task", "cache_dump"} <= wfaults, report.events
    # the failed task came back as a TaskError and was retried
    assert any(e["kind"] == "task_retry" and e["cause"] == "task_error"
               for e in report.events)
    assert not any(e.get("origin") == "worker" for e in report.events
                   if e["kind"] == "task_retry")
    # the corrupted commit is quarantined on the next read, then recomputed
    again = faults.RunReport()
    _assert_clean(sweep.map_points(pts, jobs=1, report=again, device="cpu"),
                  clean_baseline, "again")
    assert again.points[sweep.point_key(pts[0].cache_path())]["source"] \
        == "computed"


def test_task_error_pickles_with_events():
    e = sweep.TaskError("ValueError", "boom: twice", [{"kind": "fault",
                                                      "site": "task"}])
    back = pickle.loads(pickle.dumps(e))
    assert isinstance(back, sweep.TaskError)
    assert back.cause == "ValueError" and str(back) == str(e)
    assert back.events == e.events


def test_task_timeout_watchdog_kills_and_retries(clean_baseline):
    plan = _plan({"site": "task", "kind": "hang", "seconds": 600.0})
    report = faults.RunReport()
    with faults.activate(plan):
        rs = sweep.map_points(_points(), jobs=2, report=report,
                              task_timeout=WATCHDOG_S, device="cpu")
    _assert_clean(rs, clean_baseline)
    kills = [e for e in report.events if e["kind"] == "watchdog_kill"]
    assert kills and kills[0]["timeout"] == WATCHDOG_S
    assert any(e["kind"] == "task_retry" and e["cause"] == "watchdog"
               for e in report.events)


def test_inline_retry_with_backoff(clean_baseline, monkeypatch):
    """``jobs=1``: a raising task retries (with backoff) and completes."""
    monkeypatch.setattr(sweep, "RETRY_BACKOFF", 0.01)
    plan = _plan({"site": "task", "kind": "raise", "max_fires": 2})
    report = faults.RunReport()
    with faults.activate(plan):
        rs = sweep.map_points(_points(), jobs=1, report=report, device="cpu")
    _assert_clean(rs, clean_baseline)
    assert any(e["kind"] == "task_retry" for e in report.events)
    assert any(r["attempts"] > 1 for r in report.points.values())


def test_pool_task_failing_every_attempt_fails_the_run(monkeypatch):
    """A task that fails on every attempt -- in the workers, then once
    more in the caller on the host engine -- fails the run and yields no
    result (as a kernel that fails to build or launch would)."""
    monkeypatch.setattr(sweep, "RETRY_BACKOFF", 0.01)
    pts = _points()
    plan = _plan({"site": "task", "kind": "raise", "max_fires": 99,
                  "match": "moti1"})
    report = faults.RunReport()
    with faults.activate(plan):
        with pytest.raises(faults.InjectedFault):
            sweep.map_points(pts, jobs=2, retries=1, report=report,
                             device="cpu")
    kinds = [e["kind"] for e in report.events]
    assert kinds.count("task_retry") == 1 and "inline_fallback" in kinds
    assert not os.path.exists(pts[0].cache_path())
    assert not any(sweep.point_key(pt.cache_path()) in report.points
                   for pt in pts[:2])


def _unported_pool_task(task, engine, device):
    """A worker task whose group raises ``NotImplementedError``."""
    raise sweep.TaskError("NotImplementedError", "devices=2: item 14", [])


def test_pool_raises_not_implemented_without_retry(monkeypatch):
    monkeypatch.setattr(sweep, "_pool_task", _unported_pool_task)
    report = faults.RunReport()
    with pytest.raises(NotImplementedError, match="item 14"):
        sweep.map_points(_points(), jobs=2, report=report, device="cpu")
    assert not [e for e in report.events
                if e["kind"] in ("task_retry", "inline_fallback")]


def test_pool_default_device_raises_before_any_work(tmp_path, monkeypatch):
    """``jobs=2`` with the default device and no CUDA raises in the
    caller before a worker starts or a cache file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sorted(tmp_path.rglob("*"))
    spawned = []
    monkeypatch.setattr(sweep, "ProcessPoolExecutor",
                        lambda *a, **kw: spawned.append(kw))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.map_points(_points(), jobs=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.run(exp.ExperimentSpec.grid(config="config1", mix=list(MIXES),
                                        policy=list(POLS),
                                        params=sim.SimParams(**TINY)),
                plan=exp.ExecPlan(engine="host", jobs=2))
    assert not spawned
    assert sorted(tmp_path.rglob("*")) == before


# ---------------------------------------------------------------------------
# the ExecPlan(faults=) field
# ---------------------------------------------------------------------------
def test_exec_plan_faults_field(clean_baseline, monkeypatch):
    monkeypatch.setattr(sweep, "RETRY_BACKOFF", 0.01)
    with pytest.raises(ValueError, match="faults"):
        exp.ExecPlan(faults=123)
    plan_json = _plan({"site": "task", "kind": "raise"}).to_json()
    spec = exp.ExperimentSpec.grid(config="config1", mix="moti1",
                                   policy=list(POLS),
                                   params=sim.SimParams(**TINY))
    rs = exp.run(spec, plan=exp.ExecPlan(engine="fused", faults=plan_json),
                 device="cpu")
    kinds = [e["kind"] for e in rs.run_report.events]
    assert "fault" in kinds and "task_retry" in kinds
    assert rs.run_report.summary()["points"] == 2
    _assert_clean(rs.results(), clean_baseline[:2])


# ---------------------------------------------------------------------------
# the fault plan's own mechanics
# ---------------------------------------------------------------------------
def test_fault_plan_json_roundtrip_and_claims():
    plan = _plan({"site": "task", "kind": "raise", "at": 1,
                  "max_fires": 2, "match": "config1"}, seed=7)
    again = faults.FaultPlan.from_json(plan.to_json())
    assert again == plan
    with pytest.raises(ValueError, match="kind"):
        faults.FaultSpec(site="task", kind="nope")
    # at / max_fires / match: skip the first arrival, fire twice, only for
    # matching keys
    with faults.activate(plan) as active:
        assert active.state is not None
        assert os.environ["REPRO_FAULTS"] == active.to_json()
        assert faults.fire("task", key="config2|m") is None  # no match
        assert faults.fire("task", key="config1|m") is None  # at: skipped
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                faults.fire("task", key="config1|m")
        assert faults.fire("task", key="config1|m") is None  # spent
        # the claims live in the shared state directory, so another
        # process (a respawned worker) finds the budget spent too
        assert sorted(os.listdir(active.state)) == ["spent-0-0",
                                                    "spent-0-1"]
    assert "REPRO_FAULTS" not in os.environ


def test_crash_and_hang_suppressed_in_parent():
    with faults.activate(_plan({"site": "task", "kind": "crash"},
                               {"site": "task", "kind": "hang"})):
        assert faults.fire("task") is None    # would os._exit in a worker
        assert faults.fire("task") is None    # would sleep in a worker
    evs = faults.drain_events()
    assert sum(e["kind"] == "fault_suppressed" for e in evs) == 2


# ---------------------------------------------------------------------------
# random fault plans never move a result
# ---------------------------------------------------------------------------
_FAULT_CHOICES = [
    ("task", "raise"), ("cache_read", "corrupt"),
    ("cache_read", "truncate"), ("cache_dump", "corrupt"),
    ("cache_dump", "truncate"), ("stage_evict", "evict"),
    ("bucket", "resource"), ("bucket", "raise"),
    ("fused", "resource"), ("bucket_overflow", "demote"),
]


@pytest.mark.parametrize("example", range(5))
def test_random_fault_plans_stay_bitwise(clean_baseline, monkeypatch,
                                         example):
    """The JAX suite's property, through its seeded fallback (no
    hypothesis database, nothing written under ``.hypothesis/``): one to
    three random faults over the bucketed engine leave the moti1 points
    equal to the clean run."""
    monkeypatch.setattr(sweep, "RETRY_BACKOFF", 0.01)
    rng = random.Random(0xC4A05 + example)
    specs = [faults.FaultSpec(site=sk[0], kind=sk[1], at=rng.randint(0, 2),
                              max_fires=rng.randint(1, 2))
             for sk in rng.sample(_FAULT_CHOICES, rng.randint(1, 3))]
    plan = faults.FaultPlan(specs=tuple(specs),
                            seed=rng.randint(0, 2**31 - 1))
    with faults.activate(plan):
        rs = sweep.run_bucketed(_points(mixes=("moti1",)),
                                report=faults.RunReport(), device="cpu")
    _assert_clean(rs, clean_baseline[:2], specs)
