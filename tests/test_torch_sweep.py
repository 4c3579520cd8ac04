"""The port's lane-batched LLC epochs and host sweep engine.

* ``llc.simulate_epoch_lanes`` equals per-lane ``llc.simulate_epoch``
  bitwise (state and counters), lanes with different policy knobs.
* ``sweep.simulate_group`` equals per-lane ``sim.drive_lane`` bitwise,
  with lanes that finish at different epochs and a geometry split, and
  equals the JAX package's ``simulate_group(engine="host")`` (run in the
  reference child of ``tests/test_torch_sim.py``) at the
  ``tests/test_sweep.py`` point.
* ``sweep.map_points``: results in point order, twins computed once,
  a second call served from the cache; it and ``simulate_group`` reject
  the plan-level ``"bucketed"`` engine; ``jobs=2`` on a single group runs
  it in the caller, as the JAX package's does (the process pool itself:
  tests/test_torch_faults.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_sim import (  # noqa: F401 (fixture)
    SWEEP_GROUPS, TINY, TINY_DEADLINE, sweep_exp_reference, torch_one_thread)

from repro_torch.core import llc, policies, sim, sweep
from repro_torch.core.dram import default_model
from repro_torch.exp import faults

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return sweep_exp_reference(tmp_path_factory)["sweep"]


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    return tmp_path


LANE_CFGS = [
    llc.LLCConfig(),
    llc.LLCConfig(accel_mode=llc.A_HINT, core_bypass=True),
    llc.LLCConfig(accel_mode=llc.A_SHIP, shared_predictor=True,
                  core_bypass=True),
    llc.LLCConfig(accel_mode=llc.A_RAND, core_way_mask=0x0FFF,
                  accel_way_mask=0xF000),
    llc.LLCConfig(accel_mode=llc.A_SHIP, accel_way_mask=0x00FF),
]


def _events(rng, cfg, n_lanes, r, hot):
    """Random [L, R, S] event blocks over few lines (hits, evictions and
    SHIP updates all happen), with some padded rounds (meta 0)."""
    s = cfg.num_sets
    line = rng.integers(0, hot, (n_lanes, r, s)).astype(np.int32) * s \
        + np.arange(s, dtype=np.int32)
    meta = llc.pack_meta(rng.random(line.shape) < 0.4,
                         rng.random(line.shape) < 0.3,
                         rng.random(line.shape) < 0.5,
                         rng.random(line.shape) < 0.1,
                         rng.random(line.shape) < 0.7,
                         rng.integers(0, 8, line.shape))
    pad = rng.random((n_lanes, r, 1)) < 0.2
    return np.where(pad, -1, line), np.where(pad, 0, meta).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_simulate_epoch_lanes_matches_per_lane(seed):
    rng = np.random.default_rng(seed)
    cfg0 = LANE_CFGS[0]
    n = len(LANE_CFGS)
    knobs = llc.lane_knobs(LANE_CFGS, "cpu")
    states = llc.stack_states(cfg0, n, "cpu")
    singles = [llc.init_state(c, "cpu") for c in LANE_CFGS]
    for r in (8, 32, 16):
        line_b, meta_b = _events(rng, cfg0, n, r, hot=24)
        states, st_b, pc_b = llc.simulate_epoch_lanes(
            cfg0, knobs, states, line_b, meta_b, device="cpu")
        for i, cfg in enumerate(LANE_CFGS):
            singles[i], st, pc = llc.simulate_epoch(
                cfg, singles[i], line_b[i], meta_b[i], device="cpu")
            assert torch.equal(st_b[i], st), (i, r)
            assert torch.equal(pc_b[i], pc), (i, r)
    for i in range(n):
        for a, b in zip(llc.lane_state(states, i), singles[i]):
            assert torch.equal(a, b), i
    # dropping lanes keeps each survivor's knobs and state
    keep = torch.tensor([1, 3])
    sub = llc.select_states(states, keep)
    assert torch.equal(sub.tags[1], states.tags[3])
    assert torch.equal(llc.select_knobs(knobs, keep).accel_ways[0],
                       knobs.accel_ways[1])


def _port_group(i):
    config, mix, names, epochs = SWEEP_GROUPS[i]
    p = sim.SimParams(**dict(TINY, max_epochs=epochs))
    pols = [policies.get(n) for n in names]
    return config, mix, pols, p


@pytest.mark.parametrize("group", range(len(SWEEP_GROUPS)))
def test_simulate_group_matches_drive_lane_and_reference(
        reference, port_cache, group):
    config, mix, pols, p = _port_group(group)
    got = sweep.simulate_group(config, mix, pols, p, default_model(),
                               deadline_cycles=TINY_DEADLINE, device="cpu")
    art = sim.load_artifacts(config, mix, p)
    for pol, res, want in zip(pols, got, reference[group]):
        seq = sim.drive_lane(sim.Lane(config, mix, pol, p, default_model(),
                                      TINY_DEADLINE, art, device="cpu"),
                             device="cpu")
        assert dataclasses.asdict(res) == dataclasses.asdict(seq), pol.name
        assert dataclasses.asdict(res) == want, pol.name
    if group == 1:      # the premise: the lanes finish at different epochs
        assert got[0].epochs != got[1].epochs
    if group == 2:      # the premise: the lanes split by geometry
        keys = {llc.geometry_key(sim.Lane(config, mix, pol, p,
                                          default_model(), TINY_DEADLINE,
                                          art, device="cpu").llc_cfg)
                for pol in pols}
        assert len(keys) == 2


def test_map_points_order_cache_and_dedup(port_cache, monkeypatch):
    config, mix, pols, p = _port_group(0)
    a, b = (sweep.SweepPoint(config, mix, pols[i], p) for i in (3, 0))
    points = [a, b, a]
    calls = []
    real = sweep.simulate_group
    monkeypatch.setattr(sweep, "simulate_group",
                        lambda *args, **kw: calls.append(
                            [q.name for q in args[2]]) or real(*args, **kw))
    report = faults.RunReport()
    got = sweep.map_points(points, report=report, device="cpu")
    assert calls == [[a.policy.name, b.policy.name]]   # twins run once
    assert got[0] is got[2]
    assert (got[0].policy, got[1].policy) == (a.policy.name, b.policy.name)
    assert {r["source"] for r in report.points.values()} == {"computed"}
    again = sweep.map_points(points, report=(rep2 := faults.RunReport()),
                             device="cpu")
    assert len(calls) == 1                            # served from the cache
    assert {r["source"] for r in rep2.points.values()} == {"cache"}
    for x, y in zip(again, got):
        assert dataclasses.asdict(x) == dataclasses.asdict(y)
    # the group's results are simulate_group's, in point order
    want = real(config, mix, [a.policy, b.policy], p, device="cpu")
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])


def test_unported_engines_raise(port_cache, monkeypatch):
    """The bucketed engine is a plan-level engine (``sweep.run_bucketed``,
    tests/test_torch_bucketed.py): ``map_points`` and ``simulate_group``
    reject it as an unknown engine, as the JAX package's do, before any
    work.  The process pool is ported (item 11): with one group task,
    ``jobs=2`` runs it in the caller, as the JAX package's ``map_points``
    does, and gives the ``jobs=1`` result."""
    config, mix, pols, p = _port_group(0)
    pt = [sweep.SweepPoint(config, mix, pols[0], p)]
    with pytest.raises(ValueError, match="unknown engine 'bucketed'"):
        sweep.map_points(pt, engine="bucketed", device="cpu")
    with pytest.raises(ValueError, match="unknown engine 'bucketed'"):
        sweep.simulate_group(config, mix, pols, p, engine="bucketed",
                             device="cpu")
    assert not any(port_cache.rglob("*.pkl"))      # nothing ran
    pools = []
    monkeypatch.setattr(sweep, "_run_pool",
                        lambda *a, **kw: pools.append(a) or [])
    (two,) = sweep.map_points(pt, jobs=2, device="cpu")
    assert not pools                               # one task: inline
    monkeypatch.setenv("REPRO_CACHE", str(port_cache / "jobs1"))
    (one,) = sweep.map_points(pt, jobs=1, device="cpu")
    assert dataclasses.asdict(two) == dataclasses.asdict(one)
