"""The port's experiment API against the JAX package's.

* ``ExperimentSpec.grid``/``expand`` give the JAX package's points (spec
  dicts, axis rows and cache keys), transforms and override axes
  included; ``ResultSet`` queries and the hydra-sweep/v3 round trip, and
  ``schema.validate_sweep`` on the port's sweep doc.
* ``exp.run`` records at the ``tests/test_sweep.py`` point equal the JAX
  package's ``exp.run(..., plan=ExecPlan(engine="host"))`` -- run in the
  reference child of ``tests/test_torch_sim.py`` -- on both fit engines,
  bitwise; the manifest and resume of ``RunReport``; the cache-off path
  gives the cached path's results.
* ``ExecPlan`` resolution: ``"auto"`` stays ``"auto"`` and ``run_points``
  sends it (``jobs=1``) to ``sweep.run_bucketed``; the bucketed plans run
  and give the host plan's results; ``jobs=2`` runs through the process
  pool of ``sweep.map_points`` and gives them too.
"""
import dataclasses
import json
import os

import pytest

from test_torch_sim import (  # noqa: F401 (fixture)
    CONFIG, EXP_POLICIES, MIX, TINY, exp_record, expansion, expansion_spec,
    sweep_exp_reference, torch_one_thread)

from repro_torch import exp
from repro_torch.core import sim, sweep
from repro_torch.exp import schema

pytestmark = pytest.mark.usefixtures("torch_one_thread")


_ENV = ("REPRO_CACHE", "REPRO_ENGINE", "REPRO_FUSED", "REPRO_LERN_FIT",
        "REPRO_MANIFEST", "REPRO_RESUME", "REPRO_FAULTS")


@pytest.fixture(scope="module")
def cache_root(tmp_path_factory):
    """One result cache for the module (per fit engine a directory of its
    own: sim result keys omit the engine), the run env vars cleared."""
    saved = {k: os.environ.pop(k, None) for k in _ENV}
    yield tmp_path_factory.mktemp("port_cache")
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


@pytest.fixture
def port_cache(cache_root, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(cache_root / "segmented"))
    return cache_root / "segmented"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return sweep_exp_reference(tmp_path_factory)["exp"]


def _tiny_spec():
    return exp.ExperimentSpec.grid(config=CONFIG, mix=MIX,
                                   policy=list(EXP_POLICIES),
                                   params=sim.SimParams(**TINY))


def test_spec_expansion_matches_reference(reference):
    got = expansion(exp, sweep)
    assert len(got) == len(expansion_spec(exp)) == 20
    assert got == reference["expansion"]


@pytest.mark.parametrize("fit", ["segmented", "bucketed"])
def test_run_matches_reference(reference, cache_root, monkeypatch, fit):
    monkeypatch.setenv("REPRO_CACHE", str(cache_root / fit))
    rs = exp.run(_tiny_spec(), plan=exp.ExecPlan(engine="host",
                                                 fit_engine=fit),
                 device="cpu")
    assert [exp_record(r) for r in rs.to_rows()] == reference[fit]
    assert rs.keys == ("config", "mix", "policy", "params", "dram")
    assert rs.run_report.summary()["by_source"] == {"computed": 5}


def test_resultset_and_schema(port_cache, tmp_path):
    rs = exp.run(_tiny_spec(), device="cpu")
    assert rs.column("policy") == list(EXP_POLICIES)
    hydra = rs.filter(policy="hydra").one()
    assert hydra["result"].policy == "hydra"
    assert set(rs.group_by("policy")) == {(p,) for p in EXP_POLICIES}
    mean = rs.mean_over("policy")
    assert len(mean) == 1 and mean.one()["n"] == 5
    doc = rs.to_sweep_doc(module="test")
    assert schema.validate_sweep(doc) == []
    assert schema.validate(json.loads(json.dumps(doc, default=str))) == []
    path = str(tmp_path / "sweep.json")
    rs.to_sweep_json(path)
    back = exp.ResultSet.from_sweep_json(path)
    assert back.column("ipc") == rs.column("ipc")
    assert back.keys == rs.keys
    bad = dict(doc, rows=[dict(doc["rows"][0], point={"config": "x"})])
    assert schema.validate_sweep(bad)


def test_manifest_and_resume(port_cache, tmp_path):
    manifest = str(tmp_path / "m.json")
    spec = exp.ExperimentSpec.grid(config=CONFIG, mix=MIX,
                                   policy=["fifo-nb", "arp-nb"],
                                   params=sim.SimParams(**TINY))
    first = exp.run(spec, manifest=manifest, device="cpu")
    with open(manifest) as f:
        doc = json.load(f)
    assert schema.validate_manifest(doc) == []
    assert len(doc["completed"]) == 2
    again = exp.run(spec, manifest=manifest, resume=True, device="cpu")
    assert again.run_report.summary()["by_source"] == {"resume": 2}
    fresh = exp.run(spec, plan=exp.ExecPlan(cache=False), device="cpu")
    assert fresh.run_report.summary()["by_source"] == {"computed": 2}
    for a, b, c in zip(again.results(), first.results(), fresh.results()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b) \
            == dataclasses.asdict(c)
    with pytest.raises(ValueError):
        exp.run(spec, resume=True, device="cpu")


def test_exec_plan_resolution(port_cache, monkeypatch):
    monkeypatch.delenv("REPRO_BUCKET_PIPELINE", raising=False)
    rp = exp.ExecPlan().resolve()
    assert (rp.engine, rp.jobs, rp.cache, rp.fit_engine, rp.max_lanes,
            rp.devices, rp.pipeline) == \
        ("auto", 1, True, "auto", sweep.MAX_LANES, None, True)
    # "auto" with jobs=1 runs through the bucketed engine
    calls = []
    real = sweep.run_bucketed
    monkeypatch.setattr(sweep, "run_bucketed", lambda *a, **kw: (
        calls.append(kw), real(*a, **kw))[1])
    rs = exp.run(_tiny_spec(), device="cpu")
    assert len(calls) == 1 and calls[0]["cache"] is True
    assert rs.column("policy") == list(EXP_POLICIES)
    monkeypatch.setenv("REPRO_LERN_FIT", "bucketed")
    monkeypatch.setenv("REPRO_ENGINE", "fused")
    monkeypatch.setenv("REPRO_BUCKET_PIPELINE", "0")
    rp = exp.ExecPlan().resolve()
    assert (rp.engine, rp.fit_engine, rp.pipeline) == \
        ("fused", "bucketed", False)
    assert exp.ExecPlan(engine="auto").resolve().engine == "auto"
    with pytest.raises(ValueError):
        exp.ExecPlan(engine="warp")
    with pytest.raises(ValueError):
        exp.ExecPlan(fit_engine="kd-tree")


@pytest.mark.parametrize("plan,item", [
    (dict(engine="bucketed"), "item 10"),
    (dict(engine="bucketed", cache=False), "item 10"),
    (dict(engine="bucketed", fit_engine="segmented"), "item 10"),
    (dict(jobs=2), "item 11")])
def test_unported_plans_raise(tmp_path, monkeypatch, plan, item):
    """Item 10's bucketed plans and item 11's process pool are ported:
    each plan runs (from an empty cache) and gives the host plan's
    results.  ``ExecPlan(jobs=2)`` is ``"auto"`` with ``jobs > 1``, not
    the bucketed route: ``sweep.map_points(jobs=2)`` runs the spec's two
    group tasks on two workers (on the CPU here)."""
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    calls = []
    real = sweep.map_points
    monkeypatch.setattr(sweep, "map_points", lambda *a, **kw: (
        calls.append(kw), real(*a, **kw))[1])
    rs = exp.run(_tiny_spec(), plan=exp.ExecPlan(**plan), device="cpu")
    engines = {r["engine"] for r in rs.run_report.points.values()}
    if item == "item 11":
        assert [(kw["jobs"], kw["engine"]) for kw in calls] == \
            [(2, "auto")]
        assert engines == {"auto"}
    else:
        assert not calls and engines == {"bucketed"}
    host = exp.run(_tiny_spec(), plan=exp.ExecPlan(engine="host",
                                                   cache=False),
                   device="cpu")
    assert [dataclasses.asdict(r) for r in rs.results()] == \
        [dataclasses.asdict(r) for r in host.results()]


def test_run_defaults_to_the_card(port_cache, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sorted(port_cache.rglob("*"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.run(_tiny_spec())
    assert sorted(port_cache.rglob("*")) == before  # nothing ran
