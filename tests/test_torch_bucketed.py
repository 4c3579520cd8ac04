"""The port's bucketed whole-sweep engine (``fused.drive_lanes_bucketed``,
``sweep.run_bucketed``) on the CPU:

* lane groups of one ``fused.bucket_key`` run as one flat lane batch, and
  every SimResult field equals the port's per-group host and fused engines
  (``sweep.simulate_group``): mixed geometry, mixed policy rosters in one
  bucket, a single group, FR-FCFS and SQUASH in one bucket, an online-LERN
  lane;
* overflow: the shared capacity escalates, then only the offending group
  leaves through ``drive_lanes_fused`` (fluid and scheduled DRAM, whose
  bank state crosses the hand-over); the pipelined engine equals the
  one-super-step-at-a-time one;
* the staging cache re-uses a group's staged constants, stages afresh
  after an online retrain, and keeps apart two synthetic traces of one
  point;
* the four forced faults (``bucket``, ``fused``, ``bucket_overflow``,
  ``stage_evict``) leave the results equal; the card out of memory
  degrades, a failed kernel build or launch propagates;
* ``exp.run`` with ``ExecPlan(engine="bucketed")`` and with the default
  plan; ``devices`` above the visible cards raises before any work (the
  shards themselves: tests/test_torch_shards.py);
* one small sweep equals the JAX package's ``sweep.run_bucketed``, run in
  the reference child of ``tests/test_torch_sim.py`` (integers bitwise,
  floats within rtol 1e-6; in practice bitwise).

Every test starts and ends with an empty staging cache and zeroed engine
counts and phase times, and sets environment variables only through
``monkeypatch``.
"""
import dataclasses
import math
import pickle
import types

import numpy as np
import pytest
import torch

from test_torch_sim import (  # noqa: F401 (fixture)
    TINY, TINY_DEADLINE, bucket_sweep_points, run_child, torch_one_thread)

from repro_torch import exp
from repro_torch.core import cores, dram, fused, policies, sim, sweep
from repro_torch.core.tracegen import Trace
from repro_torch.exp import faults
from repro_torch.kernels.llc_rounds import ops as rounds_ops

pytestmark = pytest.mark.usefixtures("torch_one_thread")
RTOL = 1e-6
TINY_P = sim.SimParams(**TINY)
SHORTER = dataclasses.replace(TINY_P, max_epochs=25)
SMALL_LLC = dataclasses.replace(TINY_P,
                                llc_size_bytes=TINY_P.llc_size_bytes // 2)
POLS = ("fifo-nb", "arp-cs-as")
_ENV = ("REPRO_DRAM", "REPRO_ENGINE", "REPRO_FUSED", "REPRO_LERN_FIT",
        "REPRO_FAULTS", "REPRO_BUCKET_PIPELINE", "REPRO_MANIFEST",
        "REPRO_RESUME")


def _seal():
    sweep._STAGE_CACHE.clear()
    fused.reset_counts()
    fused.reset_phase_times()
    faults.drain_events()


@pytest.fixture(scope="module")
def artifact_cache(tmp_path_factory):
    """Traces, LERN tables and calibrations for the module (results never
    go through it: every run here has the result cache off or its own)."""
    return tmp_path_factory.mktemp("bucketed_artifacts")


@pytest.fixture(autouse=True)
def sealed(artifact_cache, monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("REPRO_CACHE", str(artifact_cache))
    _seal()
    yield
    _seal()


def _pols(names):
    """Policies by name; ``"base@R"`` is ``base`` with online LERN every R
    epochs."""
    out = []
    for name in names:
        base, _, period = name.partition("@")
        pol = policies.get(base)
        out.append(policies.with_online(pol, int(period)) if period else pol)
    return out


def _group(config, mix, names, p, model=dram.DDR3_1600):
    art = sim.load_artifacts(config, mix, p, True)
    return [sim.Lane(config, mix, pol, p, model, TINY_DEADLINE, art, True,
                     device="cpu") for pol in _pols(names)]


def _per_group(config, mix, names, p, model=dram.DDR3_1600):
    """The group's results on the port's host and fused engines."""
    return [sweep.simulate_group(config, mix, _pols(names), p, model,
                                 deadline_cycles=TINY_DEADLINE,
                                 engine=engine, device="cpu")
            for engine in ("host", "fused")]


def _asdicts(results):
    return [dataclasses.asdict(r) for r in results]


def _close(got, want, where):
    """Integers (and bools, strings) equal, floats within RTOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0) or \
            got == want, (where, got, want)
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------------------
# buckets: every group equal to its per-group engines
# ---------------------------------------------------------------------------
# (config, mix, policies, params, DRAM model) groups, and the bucket each
# falls in: two groups whose params differ in max_epochs only share one;
# another mix (other core slots) and a halved LLC (other geometry) key
# apart; rosters whose first lanes' LLCConfigs differ share one; one group
# alone; FR-FCFS and SQUASH of one part share one across rosters; an
# online-LERN lane (a refit every 2 epochs) beside an offline one
BUCKET_CASES = {
    "mixed_geometry": ([
        ("config1", "moti1", POLS, TINY_P, dram.DDR3_1600),
        ("config1", "moti1", POLS, SHORTER, dram.DDR3_1600),
        ("config1", "moti2", POLS, TINY_P, dram.DDR3_1600),
        ("config1", "moti1", POLS, SMALL_LLC, dram.DDR3_1600)],
        [0, 0, 1, 2]),
    "mixed_rosters": ([
        ("config1", "moti1", POLS, TINY_P, dram.DDR3_1600),
        ("config1", "moti1", ("arp-cs-as-d", "arp-al"), TINY_P,
         dram.DDR3_1600)], [0, 0]),
    "single_group": ([
        ("config1", "moti1", POLS, TINY_P, dram.DDR3_1600)], [0]),
    "sched_frfcfs_squash": ([
        ("config1", "moti1", POLS, TINY_P, dram.DDR4_2400_SQUASH),
        ("config1", "moti1", ("arp-cs-as-d", "hydra"), TINY_P,
         dram.DDR4_2400_SQUASH),
        ("config1", "moti1", POLS, TINY_P, dram.DDR4_2400_FRFCFS)],
        [0, 0, 0]),
    "online_lern": ([
        ("config1", "moti1", ("hydra@2", "fifo-nb"), TINY_P, dram.DDR3_1600),
        ("config1", "moti1", ("hydra", "hydra@3"), SHORTER,
         dram.DDR3_1600)], [0, 0]),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_bucket_equals_per_group_engines(case):
    gspecs, want_bucket = BUCKET_CASES[case]
    groups = [_group(*gs) for gs in gspecs]
    keys = [fused.bucket_key(g) for g in groups]
    # the premise: the groups fall in the buckets the case names
    assert [list(dict.fromkeys(keys)).index(k) for k in keys] == want_bucket
    if case == "mixed_rosters":
        assert groups[0][0].llc_cfg != groups[1][0].llc_cfg
    if case == "sched_frfcfs_squash":
        fluid = _group("config1", "moti1", POLS, TINY_P)
        assert fused.bucket_key(fluid) != keys[0]
    buckets = {}
    for g, k in zip(groups, keys):
        buckets.setdefault(k, []).append(g)
    for batch_list in buckets.values():
        fused.drive_lanes_bucketed(batch_list)
    counts = fused.counts()
    assert counts["bucket_supersteps"] > 0
    assert counts["supersteps"] == counts["bucket_demotions"] == 0
    for gs, g in zip(gspecs, groups):
        host, per_fused = _per_group(*gs)
        got = _asdicts(lane.result() for lane in g)
        assert got == _asdicts(host), (case, gs[1], gs[3].max_epochs)
        assert got == _asdicts(per_fused), (case, gs[1], gs[3].max_epochs)
    if case == "online_lern":
        # the premise: every online lane crossed a refit in the bucket
        online = [lane for g in groups for lane in g
                  if lane._retrain_every is not None]
        assert len(online) == 2
        assert all(lane.epoch > lane._retrain_every for lane in online)
    times = fused.phase_times()
    assert set(times) == {"stage_s", "dispatch_s", "device_s",
                          "writeback_s"}
    assert times["stage_s"] > 0 and times["dispatch_s"] > 0
    assert times["device_s"] == 0.0      # no card: the work is dispatch


# ---------------------------------------------------------------------------
# overflow: only the offending group leaves the bucket
# ---------------------------------------------------------------------------
HP = sim.SimParams(n_inputs=1, max_epochs=12, accel_epoch_cap=400,
                   subsample_target=50_000)


def _synthetic_artifacts(seed: int, n_lines: int, length: int = 2000):
    """A random accelerator trace over ``n_lines`` lines, moti2's cores."""
    rng = np.random.default_rng(seed)
    tr = Trace(line=rng.integers(0, n_lines, length).astype(np.int64),
               write=rng.random(length) < 0.3,
               cycle=np.arange(length, dtype=np.int64),
               layer=np.zeros(length, np.int32), layer_names=["l0"],
               compute_cycles=length)
    profiles = [cores.PROFILES[b] for b in cores.MIXES["moti2"]]
    est = [max(1024, cores.epoch_accesses(pr, pr.ipc0, float(HP.epoch_cycles))
               * HP.max_epochs) for pr in profiles]
    streams = [cores.generate_stream_fast(pr, est[k], k, seed=HP.seed)
               .astype(np.int64) for k, pr in enumerate(profiles)]
    return sim.Artifacts(trace=tr, profiles=profiles, est=est,
                         streams=streams)


def _synthetic_group(art, model=dram.DDR3_1600, names=POLS):
    return [sim.Lane("synthetic", "moti2", pol, HP, model, TINY_DEADLINE,
                     art, True, device="cpu") for pol in _pols(names)]


def test_bucket_of_two_traces():
    """Two groups on different traces of different lengths in one bucket:
    each lane reads its own group's trace and streams (the (group,
    element) gathers), the shorter one padded to the longer."""
    arts = [_synthetic_artifacts(7, n_lines=6000, length=2000),
            _synthetic_artifacts(8, n_lines=3000, length=1500)]
    groups = [_synthetic_group(art) for art in arts]
    assert fused.bucket_key(groups[0]) == fused.bucket_key(groups[1])
    fused.drive_lanes_bucketed(groups)
    assert fused.counts()["bucket_demotions"] == 0
    for art, group in zip(arts, groups):
        want = [sim.drive_lane(lane, device="cpu")
                for lane in _synthetic_group(art)]
        per = _synthetic_group(art)
        fused.drive_lanes_fused(per)
        got = _asdicts(lane.result() for lane in group)
        assert got == _asdicts(want)
        assert got == _asdicts(lane.result() for lane in per)


def _spy_demotions(monkeypatch):
    demoted = []
    orig = fused.drive_lanes_fused

    def spy(lanes, *a, **kw):
        demoted.append(tuple(lanes))
        return orig(lanes, *a, **kw)

    monkeypatch.setattr(fused, "drive_lanes_fused", spy)
    return demoted


@pytest.mark.parametrize("model", [dram.DDR3_1600, dram.DDR4_2400_SQUASH],
                         ids=["fluid", "sched"])
def test_overflow_demotes_the_offending_group_only(monkeypatch, model):
    """A group hammering 8 hot lines overflows the capacity (32, escalated
    to a cap of 64); its bucket-mate over 6000 lines fits and stays in the
    bucket.  The hot group leaves from its frozen carry -- with the
    scheduled model, its bank state mid-run -- and both equal the host
    oracle and the per-group fused engine."""
    monkeypatch.setattr(fused, "MAX_ROUNDS_CAP", 64)
    hot_art = _synthetic_artifacts(3, n_lines=8)
    tame_art = _synthetic_artifacts(4, n_lines=6000)
    hot, tame = _synthetic_group(hot_art, model), _synthetic_group(
        tame_art, model)
    assert fused.bucket_key(hot) == fused.bucket_key(tame)
    demoted = _spy_demotions(monkeypatch)
    fused.drive_lanes_bucketed([hot, tame], k_epochs=4, max_rounds=32)
    counts = fused.counts()
    assert demoted == [tuple(hot)], "exactly the hot group must demote"
    assert counts["bucket_escalations"] >= 1
    assert counts["bucket_demotions"] == 1
    for name, art, group in (("hot", hot_art, hot), ("tame", tame_art,
                                                      tame)):
        want_host = [sim.drive_lane(lane, device="cpu")
                     for lane in _synthetic_group(art, model)]
        per = _synthetic_group(art, model)
        fused.drive_lanes_fused(per, k_epochs=4, max_rounds=32)
        got = _asdicts(lane.result() for lane in group)
        assert got == _asdicts(want_host), name
        assert got == _asdicts(lane.result() for lane in per), name


def test_pipeline_on_equals_off(monkeypatch):
    """The pipelined engine (super-step N+1 enqueued before N's write-back)
    against one super-step at a time, over three super-steps with the hot
    group's demotion in the middle: bitwise equal, and only the pipelined
    leg enqueued ahead."""
    monkeypatch.setattr(fused, "MAX_ROUNDS_CAP", 64)
    order = []
    real_step, real_wb = fused._superstep_bucket, fused._write_back_steps
    monkeypatch.setattr(fused, "_superstep_bucket", lambda *a: (
        order.append("d"), real_step(*a))[1])
    monkeypatch.setattr(fused, "_write_back_steps", lambda *a: (
        order.append("w"), real_wb(*a))[1])
    demoted = _spy_demotions(monkeypatch)
    runs, seqs = {}, {}
    for pipeline in (False, True):
        order.clear()
        demoted.clear()
        groups = [_synthetic_group(_synthetic_artifacts(3, n_lines=8)),
                  _synthetic_group(_synthetic_artifacts(4, n_lines=6000))]
        fused.drive_lanes_bucketed(groups, k_epochs=4, max_rounds=32,
                                   devices=1, pipeline=pipeline)
        assert demoted == [tuple(groups[0])], pipeline
        runs[pipeline] = [_asdicts(lane.result() for lane in g)
                          for g in groups]
        seqs[pipeline] = "".join(order)
    assert runs[True] == runs[False]
    assert seqs[False].count("d") >= 3 and "dd" not in seqs[False]
    assert "dd" in seqs[True]


# ---------------------------------------------------------------------------
# the staging cache
# ---------------------------------------------------------------------------
def _spy_staging(monkeypatch):
    calls = []
    orig = fused.stage_group

    def spy(lanes, *a, **kw):
        calls.append(tuple(lane.policy.name for lane in lanes))
        return orig(lanes, *a, **kw)

    monkeypatch.setattr(fused, "stage_group", spy)
    return calls


def _bucket_points(mixes=("moti1",)):
    """Per mix two groups of one bucket (max_epochs 40 and 25)."""
    return [sweep.SweepPoint("config1", mix, pol, p)
            for mix in mixes for p in (TINY_P, SHORTER)
            for pol in _pols(POLS)]


def test_staging_cache_reuses_and_invalidates(monkeypatch):
    """Two passes over one bucket stage each group once; a retrain's table
    swap marks its entry stale, and only that entry stages again."""
    calls = _spy_staging(monkeypatch)
    pts = _bucket_points()
    r1 = sweep.run_bucketed(pts, cache=False, device="cpu")
    assert len(calls) == 2, calls          # one upload per group
    r2 = sweep.run_bucketed(pts, cache=False, device="cpu")
    assert len(calls) == 2, calls          # both entries re-used
    assert _asdicts(r1) == _asdicts(r2)
    assert len(sweep._STAGE_CACHE) == 2
    staged = next(iter(sweep._STAGE_CACHE.values()))
    assert not staged.stale
    # the call the bucketed engine makes after an online retrain
    staged.refresh_clusters(_group("config1", "moti1", POLS, TINY_P))
    assert staged.stale
    r3 = sweep.run_bucketed(pts, cache=False, device="cpu")
    assert len(calls) == 3, calls          # only the stale entry staged
    assert _asdicts(r3) == _asdicts(r1)


def test_staging_cache_keeps_synthetic_traces_apart(monkeypatch):
    """Two groups of one point (config, mix, roster, params, deadline) on
    different traces stage apart, and each re-uses its own entry."""
    calls = _spy_staging(monkeypatch)
    arts = [_synthetic_artifacts(s, n_lines=600) for s in (5, 6)]
    first = [sweep._staged_for([_synthetic_group(a)]) for a in arts]
    assert len(calls) == 2 and first[0][0] is not first[1][0]
    again = [sweep._staged_for([_synthetic_group(a)]) for a in arts]
    assert len(calls) == 2
    assert [s[0] for s in again] == [s[0] for s in first]
    # each group runs on its own trace through the cache
    for art in arts:
        group = _synthetic_group(art)
        fused.drive_lanes_bucketed([group],
                                   staged=sweep._staged_for([group]))
        want = [sim.drive_lane(lane, device="cpu")
                for lane in _synthetic_group(art)]
        assert _asdicts(lane.result() for lane in group) == _asdicts(want)


# ---------------------------------------------------------------------------
# faults: the degrade ladder and the forced sites
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def clean(artifact_cache):
    """The fault tests' points on the per-group host engine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CACHE", str(artifact_cache))
        return [dataclasses.asdict(r)
                for mix in ("moti1", "moti2") for p in (TINY_P, SHORTER)
                for r in sweep.simulate_group("config1", mix, _pols(POLS), p,
                                              engine="host", device="cpu")]


FAULT_CASES = {
    "bucket": ([{"site": "bucket", "kind": "resource"}],
               {"bucketed->fused"}, "fused"),
    "fused": ([{"site": "bucket", "kind": "raise", "max_fires": 2},
               {"site": "fused", "kind": "resource", "max_fires": 8}],
              {"bucketed->fused", "fused->host"}, "host"),
    "bucket_overflow": ([{"site": "bucket_overflow", "kind": "demote"}],
                        set(), "bucketed"),
    "stage_evict": ([{"site": "stage_evict", "kind": "evict"}],
                    set(), "bucketed"),
}


@pytest.mark.parametrize("site", list(FAULT_CASES))
def test_forced_faults_leave_results_equal(monkeypatch, clean, site):
    specs, ladders, engine = FAULT_CASES[site]
    monkeypatch.setattr(fused, "MAX_ROUNDS_CAP", 64)
    demoted = _spy_demotions(monkeypatch)
    if site == "stage_evict":      # a full cache, so the eviction shows
        sweep.run_bucketed(_bucket_points(("moti1", "moti2")), cache=False,
                           device="cpu")
        assert len(sweep._STAGE_CACHE) == 4
        calls = _spy_staging(monkeypatch)
    report = faults.RunReport()
    with faults.activate(faults.FaultPlan.make(specs)):
        rs = sweep.run_bucketed(_bucket_points(("moti1", "moti2")),
                                cache=False, report=report, device="cpu")
    assert _asdicts(rs) == clean
    fired = {e["site"] for e in report.events if e["kind"] == "fault"}
    assert {s["site"] for s in specs} <= fired
    assert {e["ladder"] for e in report.events
            if e["kind"] == "degrade"} == ladders
    engines = {r["engine"] for r in report.points.values()}
    assert engine in engines
    if site == "bucket_overflow":
        # every group of the first bucket left through drive_lanes_fused
        assert len(demoted) == 2 and fused.counts()["bucket_demotions"] == 2
    if site == "stage_evict":
        # the eviction emptied the full cache: both buckets staged afresh
        assert len(calls) == 4 and len(sweep._STAGE_CACHE) == 4


@pytest.mark.parametrize("error", [
    RuntimeError("nvcc failed for llc_rounds:\nerror"),
    RuntimeError("llc_rounds launch failed: cudaError 2"),
    torch.OutOfMemoryError("CUDA out of memory")],
    ids=["build", "launch", "out_of_memory"])
def test_kernel_failures_propagate_and_oom_degrades(monkeypatch, error):
    """A failed kernel build or a refused launch propagates (no fallback
    from a kernel to a plain version); the card out of memory degrades
    down the ladder and leaves the results equal."""
    pts = _bucket_points()
    # the clean run first: the calibrations and traces are then cached, so
    # the failure lands in the bucket
    want = sweep.run_bucketed(pts, cache=False, device="cpu")
    _seal()
    real = rounds_ops.rounds
    left = [1]

    def failing(*a, **kw):
        if left[0]:
            left[0] -= 1
            raise error
        return real(*a, **kw)

    monkeypatch.setattr(rounds_ops, "rounds", failing)
    report = faults.RunReport()
    if not isinstance(error, torch.OutOfMemoryError):
        assert not faults.degradable(error)
        with pytest.raises(RuntimeError, match=str(error)[:12]):
            sweep.run_bucketed(pts, cache=False, report=report,
                               device="cpu")
        assert not [e for e in report.events if e["kind"] == "degrade"]
        return
    assert faults.degradable(error)
    rs = sweep.run_bucketed(pts, cache=False, report=report, device="cpu")
    assert [e["ladder"] for e in report.events
            if e["kind"] == "degrade"] == ["bucketed->fused"]
    assert _asdicts(rs) == _asdicts(want)


# ---------------------------------------------------------------------------
# the experiment API and the device count
# ---------------------------------------------------------------------------
def _spec(mixes=("moti1", "moti2")):
    return exp.ExperimentSpec.grid(config="config1", mix=list(mixes),
                                   policy=list(POLS), params=TINY_P)


def test_exec_plan_bucketed_end_to_end(tmp_path, monkeypatch):
    """``ExecPlan(engine="bucketed")`` and the default plan (``"auto"``,
    ``jobs=1``) run through ``run_bucketed`` and give the per-group
    engines' results; the default plan's second run comes from the
    cache."""
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    calls = []
    real = sweep.run_bucketed
    monkeypatch.setattr(sweep, "run_bucketed", lambda *a, **kw: (
        calls.append(kw["cache"]), real(*a, **kw))[1])
    rows = {}
    for name, plan in (("bucketed", dict(engine="bucketed", cache=False)),
                       ("fused", dict(engine="fused", cache=False)),
                       ("host", dict(engine="host", cache=False)),
                       ("default", {})):
        rs = exp.run(_spec(), plan=exp.ExecPlan(**plan), device="cpu")
        rows[name] = [(r["mix"], r["policy"], dataclasses.asdict(
            r["result"])) for r in rs.to_rows()]
        if name == "default":
            assert rs.run_report.summary()["by_source"] == {"computed": 4}
            assert {r["engine"] for r in rs.run_report.points.values()} == \
                {"bucketed"}
    assert calls == [False, True]
    assert len(rows["host"]) == 4
    assert rows["bucketed"] == rows["fused"] == rows["host"] \
        == rows["default"]
    again = exp.run(_spec(), device="cpu")
    assert again.run_report.summary()["by_source"] == {"cache": 4}
    assert calls == [False, True, True]


@pytest.mark.parametrize("entry", ["drive_lanes_bucketed", "run_bucketed",
                                   "exp_run"])
def test_devices_beyond_one_raise(tmp_path, monkeypatch, entry):
    """``devices=2`` on a machine that shows one card (``torch.cuda``
    patched) raises a ``ValueError`` that names both counts before
    anything is staged, cached or launched: no fallback to fewer cards or
    to the CPU."""
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    lane = types.SimpleNamespace(device=torch.device("cuda"))
    calls = {
        "drive_lanes_bucketed": lambda: fused.drive_lanes_bucketed(
            [[lane]], devices=2),
        "run_bucketed": lambda: sweep.run_bucketed(
            _bucket_points(), devices=2, device="cuda"),
        "exp_run": lambda: exp.run(_spec(), plan=exp.ExecPlan(devices=2),
                                   device="cuda"),
    }
    with pytest.raises(ValueError, match="devices=2: only 1 CUDA device"):
        calls[entry]()
    assert not any(tmp_path.rglob("*"))           # nothing ran
    assert not sweep._STAGE_CACHE and not any(fused.counts().values())


# ---------------------------------------------------------------------------
# the JAX package's bucketed engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_bucketed(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_bucketed")
    out = str(d / "bucketed.pkl")
    run_child("bucketed", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


def test_sweep_matches_jax_run_bucketed(jax_bucketed):
    pts = bucket_sweep_points(sim, sweep, policies)
    got = sweep.run_bucketed(pts, cache=False, device="cpu")
    assert len(got) == len(jax_bucketed) == 12
    # the premise: groups shared buckets (two groups a mix)
    assert fused.counts()["bucket_supersteps"] > 0
    for g, want in zip(got, jax_bucketed):
        _close(dataclasses.asdict(g), want, f"{g.mix}.{g.policy}")
