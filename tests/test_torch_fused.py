"""The port's fused epoch engine (``core/fused.py``) on the CPU:

* ``drive_lanes_fused`` equals the port's host engine (``sim.drive_lane``
  through ``sweep.simulate_group(engine="host")``) on the ``FUSED_CASES``
  groups -- fluid and scheduled DRAM, an online-LERN lane, and a forced
  overflow that takes the capacity escalation and the host stretch --
  with every SimResult field equal;
* and equals the JAX package's fused engine on the same groups, run in the
  reference child of ``tests/test_torch_sim.py`` (integers bitwise,
  floats within rtol 1e-6; in practice bitwise);
* ``simulate_group(engine="fused")`` and ``exp.run`` with
  ``ExecPlan(engine="fused")`` (cache on and off) give the host engine's
  results; the occupancy record; the lanes the engine refuses;
* fig. 17's scheduler cell through the fused engine equals its golden
  file (``golden/config1_sched.json``, the JAX package's numbers).
"""
import dataclasses
import json
import math
import os
import pickle

import pytest

from test_torch_sim import (  # noqa: F401 (fixture)
    FUSED_CASES, ROOT, TINY, TINY_DEADLINE, drive_fused_case,
    fused_case_lanes, run_child, sched_doc, torch_one_thread)

from repro_torch import exp
from repro_torch.core import dram, fused, policies, sim, sweep

pytestmark = pytest.mark.usefixtures("torch_one_thread")
RTOL = 1e-6
SCHED_GOLDEN = os.path.join(ROOT, "src", "repro_torch", "golden",
                            "config1_sched.json")
CASES = {case[0]: case for case in FUSED_CASES}


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    for k in ("REPRO_DRAM", "REPRO_ENGINE", "REPRO_FUSED", "REPRO_LERN_FIT"):
        monkeypatch.delenv(k, raising=False)
    fused.reset_counts()
    return tmp_path


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_fused")
    out = str(d / "fused.pkl")
    run_child("fused", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


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


def _port_case(case):
    lanes = fused_case_lanes(sim, policies, dram, case, device="cpu")
    return drive_fused_case(fused, lanes, case)


def _port_host(case):
    lanes = fused_case_lanes(sim, policies, dram, case, device="cpu")
    sweep._drive_lanes(lanes, lanes[0].device)
    return [lane.result() for lane in lanes]


@pytest.mark.parametrize("name", list(CASES))
def test_fused_matches_host_and_jax_fused(port_cache, jax_fused, name):
    case = CASES[name]
    got = _port_case(case)
    counts = fused.counts()
    want = _port_host(case)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w), g.policy
    for g, j in zip(got, jax_fused[name]):
        _close(dataclasses.asdict(g), j, f"{name}.{g.policy}")
    assert counts["supersteps"] > 0
    if name == "overflow":
        # capacity 8 escalates to the cap (16), then the stretch that
        # still overflows replays on the host path
        assert counts["escalations"] >= 1 and counts["host_stretches"] >= 1
        assert counts["host_epochs"] > 0
    else:
        assert counts["escalations"] == counts["host_stretches"] == 0
    if name == "online":
        assert got[1].epochs >= 20      # the online lane crossed a refit


def test_simulate_group_and_exec_plan_fused(port_cache):
    p = sim.SimParams(**TINY)
    pols = [policies.get(n) for n in ("fifo-nb", "arp-cs-as-d", "hydra")]
    host = sweep.simulate_group("config1", "moti2", pols, p,
                                deadline_cycles=TINY_DEADLINE,
                                engine="host", device="cpu")
    for engine in ("fused", "auto"):
        got = sweep.simulate_group("config1", "moti2", pols, p,
                                   deadline_cycles=TINY_DEADLINE,
                                   engine=engine, device="cpu")
        for g, w in zip(got, host):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), engine
    spec = exp.ExperimentSpec.grid(config="config1", mix="moti2",
                                   policy=["fifo-nb", "hydra"],
                                   params=dataclasses.replace(
                                       p, deadline_factor=1.0))
    rows = {}
    for plan in (dict(engine="host", cache=False), dict(engine="fused"),
                 dict(engine="fused", cache=False)):
        fused.reset_counts()
        rs = exp.run(spec, plan=exp.ExecPlan(**plan), device="cpu")
        rows[str(plan)] = [dataclasses.asdict(r) for r in rs.results()]
        assert (fused.counts()["supersteps"] > 0) == (plan["engine"] ==
                                                      "fused")
    vals = list(rows.values())
    assert vals[0] == vals[1] == vals[2]


def test_fused_occupancy_record_and_refused_lanes(port_cache, monkeypatch):
    p = sim.SimParams(**dict(TINY, record_occupancy=True))
    pols = [policies.get(n) for n in ("arp-nb", "hydra")]
    host = sweep.simulate_group("config1", "moti1", pols, p,
                                deadline_cycles=TINY_DEADLINE,
                                engine="host", device="cpu")
    got = sweep.simulate_group("config1", "moti1", pols, p,
                               deadline_cycles=TINY_DEADLINE,
                               engine="fused", device="cpu")
    assert host[0].occupancy and [r.occupancy for r in got] == \
        [r.occupancy for r in host]
    # the calibration runs carry no core traffic: the fused engine refuses
    # them ("fused" raises, "auto" keeps the host loop)
    art = sim.load_artifacts("config1", "mix1", p, False)
    lane = sim.Lane("config1", "mix1", pols[0], p, dram.DDR3_1600,
                    TINY_DEADLINE, art, False, device="cpu")
    assert not fused.lane_supported(lane)
    with pytest.raises(ValueError, match="does not support"):
        sweep._use_fused([lane], "fused")
    assert not sweep._use_fused([lane], "auto")
    monkeypatch.setenv("REPRO_FUSED", "0")
    assert not sweep._use_fused([lane], "auto")


def test_sched_cell_fused_matches_golden(port_cache):
    """fig. 17's FR-FCFS vs SQUASH cell (the golden file's, JAX package's
    numbers at the full preset) through the port's fused engine on the
    CPU; chip_smoke.py phase 10 runs both engines on the card."""
    with open(SCHED_GOLDEN) as f:
        golden = json.load(f)
    got = json.loads(json.dumps(sched_doc(exp, lambda spec, engine: exp.run(
        spec, plan=exp.ExecPlan(engine=engine, cache=False), device="cpu"),
        engines=("fused",))))
    _close(got["points"]["fused"], golden["points"]["fused"], "sched")
    assert got["dmr_delta"] == golden["dmr_delta"]
    assert golden["sched_dmr_delta"] > 0
