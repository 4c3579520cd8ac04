"""The port's serve replay layer against the JAX package on the CPU: the
seeded trace generator, the batched super-step engine vs the host oracle
(bitwise), micro-trace latency/miss accounting, and the frozen
ServeSpec/SchedulerKnobs API with its hydra-serve/v1 document -- the
counterparts of ``tests/test_serve.py`` -- plus the device rule, a failed
kernel build that propagates out of ``serve.run``, and the port held
bitwise to the JAX package's ``generate``, both of its ``replay`` engines
and one ``serve.run`` document.

``repro.serve`` cannot be imported in a pytest worker under the installed
JAX (it needs the ``jax.experimental.enable_x64`` alias), so the reference
runs in the ``replay`` mode of the child in ``tests/test_torch_sim.py``.
Every test starts and ends with an empty fault-event buffer, and sets
environment variables only through ``monkeypatch``.
"""
import dataclasses
import importlib
import json
import pickle

import numpy as np
import pytest
import torch

from test_torch_sim import (  # noqa: F401 (fixture)
    REPLAY_ADMISSIONS, REPLAY_KNOBS, full_grid, replay_grid, replay_record,
    replay_spec, run_child, torch_one_thread, trace_specs)

from repro_torch import exp, serve
from repro_torch.core import lern
from repro_torch.exp import faults
from repro_torch.exp import schema as schema_mod
from repro_torch.serve.api import _build_scheduler
from repro_torch.serve.hydra_scheduler import HydraKVScheduler
from repro_torch.serve.knobs import SchedulerKnobs
from repro_torch.serve.replay import ReplayResult, replay
from repro_torch.serve.trace import SessionTrace

pytestmark = pytest.mark.usefixtures("torch_one_thread")
# the module (``repro_torch.serve.replay`` the attribute is the function)
replay_mod = importlib.import_module("repro_torch.serve.replay")

TRACE = serve.TraceSpec(sessions=160, rate=1.5, turns_mean=2.0,
                        turns_sigma=0.6, gap_mean=12.0, gap_sigma=0.6,
                        prompt_tokens=8, decode_mean=6.0, decode_sigma=0.3,
                        deadline_factor=1.5,
                        drift=serve.MixDrift(period=3, strength=0.6, seed=1),
                        seed=3)
# hydra residency with a binding budget and live online refits: the
# hardest parity case (thresholds + cluster ids change mid-replay)
ONLINE = SchedulerKnobs(token_budget=768, deadline_tokens=48.0,
                        epoch_tokens=32, retrain_period=4.0,
                        min_refit_sessions=4)
_ENV = ("REPRO_ENGINE", "REPRO_FUSED", "REPRO_FAULTS", "REPRO_MANIFEST",
        "REPRO_LERN_FIT")


@pytest.fixture(autouse=True)
def _sealed(monkeypatch, tmp_path):
    """An empty fault-event buffer before and after, the port's cache in
    this test's directory, and none of the plan's environment defaults."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))
    faults.drain_events()
    yield
    faults.drain_events()


def _tiny_spec(**kw):
    kw.setdefault("trace", TRACE)
    kw.setdefault("knobs", ONLINE)
    kw.setdefault("slots", 12)
    kw.setdefault("max_steps", 512)
    kw.setdefault("profile_sessions", 64)
    return serve.ServeSpec(**kw)


def _replay_equal(a: ReplayResult, b: ReplayResult) -> bool:
    return (a.counters == b.counters
            and np.array_equal(a.wait_hist, b.wait_hist)
            and np.array_equal(a.lat_hist, b.lat_hist))


CPU = exp.ExecPlan(cache=False)


# ---------------------------------------------------------------------------
# trace generator: determinism, drift, round-trip
# ---------------------------------------------------------------------------
def test_trace_determinism_and_seed_sensitivity():
    a = serve.generate(TRACE)
    b = serve.generate(TRACE)
    for f in ("arrival", "turns", "gap", "prompt", "decode", "deadline",
              "cls"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.n == TRACE.sessions
    assert np.array_equal(a.kv, (a.prompt + a.decode).astype(np.int64))
    c = serve.generate(dataclasses.replace(TRACE, seed=TRACE.seed + 1))
    assert not np.array_equal(a.arrival, c.arrival)
    # drift ramps the chatty fraction across arrival phases
    drifted = serve.generate(dataclasses.replace(
        TRACE, sessions=3000, drift=serve.MixDrift(period=4, strength=0.8)))
    phases = np.array_split(drifted.cls, 4)
    assert phases[0].mean() < phases[-1].mean()


def test_bursty_arrivals_are_modulated():
    spec = dataclasses.replace(TRACE, arrival="bursty", sessions=2000,
                               rate=2.0, burst_factor=6.0, burst_period=64)
    t = serve.generate(spec)
    assert np.all(np.diff(t.arrival) >= 0)
    on = (t.arrival % 64) < 32
    assert on.mean() > 0.75          # most arrivals land in the on-phase
    assert np.array_equal(t.arrival, serve.generate(spec).arrival)


def test_trace_spec_roundtrip():
    assert serve.TraceSpec.from_dict(TRACE.spec_dict()) == TRACE
    plain = dataclasses.replace(TRACE, drift=None)
    assert serve.TraceSpec.from_dict(plain.spec_dict()) == plain
    with pytest.raises(ValueError, match="arrival"):
        serve.TraceSpec(arrival="nope")


def test_profile_features_are_held_out():
    t, g = serve.profile_features(TRACE, 64)
    assert t.shape == (64,) and g.shape == (64,)
    trace = serve.generate(dataclasses.replace(TRACE, sessions=64))
    assert not np.array_equal(t, trace.turns.astype(np.float64))


# ---------------------------------------------------------------------------
# batched-vs-host parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knobs,admission", [
    ("kv-default", "urgency"),
    (ONLINE, "urgency"),             # binding budget + online refits
    (ONLINE, "fifo"),
    ("keep-all", "fifo"),
    ("evict-all", "urgency"),
], ids=["kv-default-urgency", "online-urgency", "online-fifo",
        "keep-all-fifo", "evict-all-urgency"])
def test_batched_matches_host_bitwise(knobs, admission):
    spec = _tiny_spec(knobs=knobs, admission=admission)
    resolved = spec.resolved_knobs()
    trace = serve.generate(spec.trace)
    sh = _build_scheduler(spec, resolved, "cpu")
    sb = _build_scheduler(spec, resolved, "cpu")
    host = replay(trace, sh, slots=spec.slots, max_steps=spec.max_steps,
                  admission=admission, engine="host", device="cpu")
    batched = replay(trace, sb, slots=spec.slots,
                     max_steps=spec.max_steps, admission=admission,
                     engine="batched", device="cpu")
    assert host.engine == "host" and batched.engine == "batched"
    assert _replay_equal(host, batched), (host.counters, batched.counters)
    assert sh.stats() == sb.stats()
    assert host.counters["completed"] > 0
    if knobs is ONLINE:
        assert sh.refits >= 1        # the refit path really ran
    if knobs == "evict-all":
        assert host.counters["reprefills"] > 0
        assert host.counters["resident_tokens"] == 0


def test_replay_validates_inputs():
    trace = serve.generate(dataclasses.replace(TRACE, sessions=8))
    sched = HydraKVScheduler(SchedulerKnobs(), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        replay(trace, sched, slots=4, max_steps=64, engine="nope",
               device="cpu")
    with pytest.raises(ValueError, match="admission"):
        replay(trace, sched, slots=4, max_steps=64, admission="nope",
               device="cpu")


def test_superstep_reads_the_card_once(monkeypatch):
    """The batched engine reads its device once a super-step (``_read``),
    and never inside one: the super-step returns tensors only, and the
    thresholds reach it as int64 scalars."""
    spec = _tiny_spec()
    trace = serve.generate(spec.trace)
    sched = _build_scheduler(spec, spec.resolved_knobs(), "cpu")
    calls = {"superstep": 0, "read": 0}
    real_step, real_read = replay_mod._superstep, replay_mod._read

    def step(dims, consts, carry, rc, ri, ri_th, rc_th):
        calls["superstep"] += 1
        assert type(ri_th) is int and type(rc_th) is int
        c, comp = real_step(dims, consts, carry, rc, ri, ri_th, rc_th)
        assert all(isinstance(v, torch.Tensor) for v in c.values())
        assert comp.dtype == torch.bool and comp.shape == (dims.k, dims.n)
        return c, comp

    def read(carry, comp):
        calls["read"] += 1
        return real_read(carry, comp)

    monkeypatch.setattr(replay_mod, "_superstep", step)
    monkeypatch.setattr(replay_mod, "_read", read)
    res = replay(trace, sched, slots=spec.slots, max_steps=spec.max_steps,
                 engine="batched", device="cpu")
    assert calls["superstep"] == calls["read"] == sched.epochs
    assert res.counters["steps"] == spec.max_steps


# ---------------------------------------------------------------------------
# micro-trace accounting: hand-computed latency / wait / miss numbers
# ---------------------------------------------------------------------------
def _micro_trace(arrival, turns, gap, prompt, decode, deadline):
    n = len(arrival)
    return SessionTrace(
        arrival=np.asarray(arrival, np.int64),
        turns=np.asarray(turns, np.int32),
        gap=np.asarray(gap, np.int32),
        prompt=np.asarray(prompt, np.int32),
        decode=np.asarray(decode, np.int32),
        deadline=np.asarray(deadline, np.int32),
        cls=np.zeros(n, np.int8))


def _micro_sched():
    return HydraKVScheduler(SchedulerKnobs(token_budget=64, epoch_tokens=8,
                                           residency="keep-all"),
                            device="cpu")


@pytest.mark.parametrize("engine", ["host", "batched"])
def test_micro_trace_latency_and_miss_accounting(engine):
    """10 single-turn sessions, all admitted at t=0: latency is exactly
    prompt+decode=5 steps; the 3 sessions with deadline 4 miss."""
    t = _micro_trace(arrival=[0] * 10, turns=[1] * 10, gap=[1] * 10,
                     prompt=[2] * 10, decode=[3] * 10,
                     deadline=[5] * 7 + [4] * 3)
    res = replay(t, _micro_sched(), slots=16, max_steps=64, engine=engine,
                 device="cpu")
    c = res.counters
    assert c["completed"] == 10 and c["finished"] == 10
    assert c["missed"] == 3 and c["admits"] == 10
    assert c["wait_sum"] == 0 and c["lat_sum"] == 50
    assert c["decoded"] == 50 and c["steps"] == 5
    assert c["peak_concurrent"] == 10 and c["reprefills"] == 0
    s = res.summary()
    assert s["dmr"] == pytest.approx(0.3)
    assert s["p99_wait_steps"] == 0.0
    assert s["p99_latency_steps"] == 5.0
    assert s["mean_latency_steps"] == pytest.approx(5.0)
    assert s["throughput_tok_per_step"] == pytest.approx(10.0)


@pytest.mark.parametrize("engine", ["host", "batched"])
def test_micro_trace_slot_contention_wait(engine):
    """One slot, two equal-slack sessions: the session-id tie-break
    admits session 0 first; session 1 waits the full 5-step service
    time, finishing at latency 10 and missing its 5-step deadline."""
    t = _micro_trace(arrival=[0, 0], turns=[1, 1], gap=[1, 1],
                     prompt=[2, 2], decode=[3, 3], deadline=[5, 5])
    res = replay(t, _micro_sched(), slots=1, max_steps=64, engine=engine,
                 device="cpu")
    c = res.counters
    assert c["completed"] == 2 and c["missed"] == 1
    assert c["wait_sum"] == 5 and c["admits"] == 2
    assert c["lat_sum"] == 15          # 5 + 10
    s = res.summary()
    assert s["p99_wait_steps"] == 5.0
    assert s["p99_latency_steps"] == 10.0
    assert s["mean_wait_steps"] == pytest.approx(2.5)
    assert s["dmr"] == pytest.approx(0.5)


def test_p99_is_integer_exact():
    """The histogram percentile is the exact order statistic (ceil of
    the 99% rank), not an interpolation."""
    def p99(pairs):
        hist = np.zeros(512, np.int64)
        for b, n in pairs:
            hist[b] = n
        return ReplayResult(counters={}, wait_hist=hist, lat_hist=hist,
                            engine="host")._hist_pct(hist)
    assert p99([(1, 99), (7, 1)]) == 1.0     # rank 99 of 100 -> bin 1
    assert p99([(1, 100), (7, 2)]) == 7.0    # rank 101 of 102 -> bin 7
    assert p99([]) == 0.0


# ---------------------------------------------------------------------------
# ServeSpec / SchedulerKnobs: the frozen public configuration surface
# ---------------------------------------------------------------------------
def test_serve_registry_protocol():
    from repro_torch.exp.registry import REGISTRIES
    assert REGISTRIES["serve"] is exp.SERVE
    assert {"kv-default", "kv-online", "keep-all",
            "evict-all"} <= set(exp.SERVE.names())
    assert exp.SERVE.get("kv-online").retrain_period == 8.0
    assert "kv-default" in exp.SERVE
    with pytest.raises(TypeError, match="SchedulerKnobs"):
        exp.SERVE.register("junk", 42)
    with pytest.raises(KeyError, match="unknown serve"):
        exp.SERVE.get("nope")
    # transform tuples mirror the policy-axis exp.online idiom
    assert serve.resolve_knobs(("kv-default", serve.online())) \
        == serve.resolve_knobs("kv-online")
    assert serve.knobs_name(("kv-default", serve.online(4))) \
        == "kv-default-ol4"
    assert serve.knobs_name("evict-all") == "evict-all"
    with pytest.raises(TypeError, match="knobs"):
        serve.resolve_knobs(3.14)


def test_serve_spec_validation_and_grid():
    with pytest.raises(ValueError, match="admission"):
        serve.ServeSpec(admission="nope")
    with pytest.raises(ValueError, match="slots"):
        serve.ServeSpec(slots=0)
    with pytest.raises(KeyError, match="unknown serve"):
        serve.ServeSpec(knobs="not-registered")
    with pytest.raises(KeyError, match="unknown serve axis"):
        serve.grid(rate=[1.0], bogus=[1])
    specs = serve.grid(trace=TRACE, rate=[1.0, 2.0],
                       knobs=["kv-default", "evict-all"], slots=8)
    assert len(specs) == 4
    assert [s.trace.rate for s in specs] == [1.0, 1.0, 2.0, 2.0]
    assert all(s.slots == 8 for s in specs)
    assert specs[0].trace == dataclasses.replace(TRACE, rate=1.0)
    assert hash(specs[0]) == hash(serve.grid(
        trace=TRACE, rate=1.0, knobs="kv-default", slots=8)[0])


def test_serve_spec_roundtrip_preserves_equality():
    for spec in (_tiny_spec(), _tiny_spec(knobs="kv-online"),
                 _tiny_spec(knobs=("kv-default", serve.online(4)))):
        back = serve.ServeSpec.from_dict(
            json.loads(json.dumps(spec.spec_dict())))
        assert back.resolved_knobs() == spec.resolved_knobs()
        assert back.trace == spec.trace
    # registered-name specs round-trip to full equality (name preserved)
    named = _tiny_spec(knobs="kv-online")
    assert serve.ServeSpec.from_dict(named.spec_dict()) == named


# ---------------------------------------------------------------------------
# serve.run: ExecPlan routing, cache/dedup, artifact round-trip
# ---------------------------------------------------------------------------
def test_serve_run_host_plan_matches_batched():
    spec = _tiny_spec()
    rb = serve.run(spec, plan=CPU, device="cpu").one()
    rh = serve.run(spec, plan=exp.ExecPlan(engine="host", cache=False),
                   device="cpu").one()
    assert rb["engine"] == "batched" and rh["engine"] == "host"
    assert _replay_equal(rb["result"], rh["result"])
    for k in ("dmr", "p99_wait_steps", "sessions_per_kstep", "refits"):
        assert rb[k] == rh[k], k


def test_serve_run_cache_dedup_and_manifest(tmp_path):
    from repro_torch.core import sim
    manifest = str(tmp_path / "serve_manifest.json")
    spec = _tiny_spec(knobs="evict-all")
    # an identical cell twice in one run: second is served by the memo;
    # both land on one report key, so the dedup source is what remains
    rs = serve.run([spec, spec], manifest=manifest, device="cpu")
    assert len(rs) == 2
    assert [r["source"] for r in rs.run_report.points.values()] == [
        "dedup"]
    row0, row1 = rs.to_rows()
    assert _replay_equal(row0["result"], row1["result"])
    # a fresh run is served from the disk cache, bitwise
    rs2 = serve.run(spec, manifest=manifest, device="cpu")
    assert [r["source"] for r in rs2.run_report.points.values()] == [
        "cache"]
    assert _replay_equal(rs2.one()["result"], row0["result"])
    with open(manifest) as f:
        doc = json.load(f)
    assert schema_mod.validate(doc) == []
    assert all(k.startswith("serve/") for k in doc["completed"])
    # the entries live in the port's own cache namespace
    assert sim._cache_path("serve", "x").startswith(
        str(tmp_path / "cache" / "torch" / "serve"))


def test_serve_doc_roundtrip_and_schema():
    specs = serve.grid(trace=TRACE, knobs=[ONLINE, "evict-all"], slots=12,
                       max_steps=512, profile_sessions=64)
    rs = serve.run(specs, device="cpu")
    doc = json.loads(json.dumps(serve.to_serve_doc(rs, preset="test")))
    assert doc["schema"] == serve.SERVE_SCHEMA
    assert schema_mod.validate(doc) == []
    assert schema_mod.validate_serve(doc) == []
    back = serve.from_serve_doc(doc)
    assert len(back) == len(rs) and back.keys == rs.keys
    for orig, rt in zip(rs.to_rows(), back.to_rows()):
        assert rt["point"] == orig["point"]
        assert rt["dmr"] == orig["dmr"]
        assert rt["engine"] == orig["engine"]
    # the evict-all baseline misses more deadlines than the hydra rule
    by_knobs = {r["knobs"]: r for r in rs.to_rows()}
    assert by_knobs["evict-all"]["dmr"] > by_knobs["custom"]["dmr"]
    with pytest.raises(ValueError, match="schema"):
        serve.from_serve_doc({"schema": "hydra-sweep/v3", "rows": []})


# ---------------------------------------------------------------------------
# serve fault sites + the batched->host degradation ladder
# ---------------------------------------------------------------------------
def test_serve_step_fault_degrades_to_host_bitwise():
    spec = _tiny_spec()
    clean = serve.run(spec, plan=CPU, device="cpu").one()
    assert clean["engine"] == "batched"
    plan = faults.FaultPlan.make(
        [{"site": "serve_step", "kind": "resource"}]).to_json()
    rs = serve.run(spec, plan=exp.ExecPlan(cache=False, faults=plan),
                   device="cpu")
    row = rs.one()
    assert row["engine"] == "host"
    assert _replay_equal(clean["result"], row["result"])
    events = rs.run_report.events
    assert any(e["kind"] == "fault" and e["site"] == "serve_step"
               for e in events)
    assert any(e["kind"] == "serve_degrade" for e in events)


def test_serve_admission_fault_fires_on_host_path():
    spec = _tiny_spec(knobs="evict-all")
    trace = serve.generate(spec.trace)
    sched = _build_scheduler(spec, spec.resolved_knobs(), "cpu")
    plan = faults.FaultPlan.make(
        [{"site": "serve_admission", "kind": "raise"}])
    with faults.activate(plan):
        with pytest.raises(faults.InjectedFault):
            replay(trace, sched, slots=spec.slots,
                   max_steps=spec.max_steps, engine="host", device="cpu")
    evs = faults.drain_events()
    assert any(e["kind"] == "fault" and e["site"] == "serve_admission"
               for e in evs)


def test_serve_admission_fault_fires_once_a_dispatch():
    """On the batched path ``serve_admission`` fires once a super-step
    dispatch (key ``e<epoch>``); the third dispatch's fault degrades the
    cell to the host oracle, results equal."""
    spec = _tiny_spec()
    clean = serve.run(spec, plan=CPU, device="cpu").one()
    plan = faults.FaultPlan.make([{"site": "serve_admission",
                                   "kind": "resource", "at": 2}]).to_json()
    rs = serve.run(spec, plan=exp.ExecPlan(cache=False, faults=plan),
                   device="cpu")
    fired = [e for e in rs.run_report.events if e["kind"] == "fault"]
    assert [(e["site"], e["key"]) for e in fired] == [("serve_admission",
                                                       "e2")]
    assert rs.one()["engine"] == "host"
    assert _replay_equal(clean["result"], rs.one()["result"])


@pytest.mark.parametrize("error", [
    RuntimeError("nvcc failed for kmeans_assign:\nerror"),
    RuntimeError("kmeans_fit launch failed: cudaError 2"),
    torch.OutOfMemoryError("CUDA out of memory")],
    ids=["build", "launch", "out_of_memory"])
def test_kernel_failures_propagate_and_oom_degrades(monkeypatch, error):
    """A failed kernel build or a refused launch inside the batched replay
    propagates out of ``serve.run`` (no fallback, no ``serve_degrade``);
    the card out of memory demotes the cell to the host oracle and leaves
    the result equal."""
    spec = _tiny_spec()
    want = serve.run(spec, plan=CPU, device="cpu").one()
    real = replay_mod._superstep
    left = [1]

    def failing(*a, **kw):
        if left[0]:
            left[0] -= 1
            raise error
        return real(*a, **kw)

    monkeypatch.setattr(replay_mod, "_superstep", failing)
    report = faults.RunReport()
    if not isinstance(error, torch.OutOfMemoryError):
        assert not faults.degradable(error)
        with faults.reporting(report):
            with pytest.raises(RuntimeError, match=str(error)[:12]):
                serve.run(spec, plan=CPU, device="cpu")
        assert not [e for e in report.events
                    if e["kind"] == "serve_degrade"]
        return
    rs = serve.run(spec, plan=CPU, device="cpu")
    assert [e["engine"] for e in rs.run_report.events
            if e["kind"] == "serve_degrade"] == ["batched"]
    assert rs.one()["engine"] == "host"
    assert _replay_equal(rs.one()["result"], want["result"])


def test_profile_build_failure_propagates(monkeypatch):
    """A failed build of the profile fit's kernel propagates out of
    ``serve.run`` on either engine."""
    from repro_torch.kernels.kmeans_assign import ops as kops

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed for kmeans_assign:\nerror")

    monkeypatch.setattr(kops, "fit_masked", broken)
    for engine in ("auto", "host"):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            serve.run(_tiny_spec(knobs="kv-online"),
                      plan=exp.ExecPlan(engine=engine, cache=False),
                      device="cpu")


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------
def test_serve_entry_points_raise_without_cuda(monkeypatch):
    """``replay`` (either engine), ``serve.run`` (either plan), the cell's
    scheduler and ``lern.train_host_numpy`` default to the card and raise
    without one."""
    from repro_torch.core.tracegen import Trace
    spec = _tiny_spec(knobs="evict-all")
    trace = serve.generate(spec.trace)
    sched = HydraKVScheduler(SchedulerKnobs(), device="cpu")
    tr = Trace(line=np.arange(64, dtype=np.int64) % 16,
               write=np.zeros(64, bool), cycle=np.arange(64, dtype=np.int64),
               layer=np.zeros(64, np.int32), layer_names=["l0"],
               compute_cycles=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: replay(trace, sched, slots=4, max_steps=64),
        lambda: replay(trace, sched, slots=4, max_steps=64, engine="host"),
        lambda: serve.run(spec, plan=CPU),
        lambda: serve.run(spec, plan=exp.ExecPlan(engine="host",
                                                  cache=False)),
        lambda: _build_scheduler(spec, spec.resolved_knobs()),
        lambda: lern.train_host_numpy(tr),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 11's golden file
# ---------------------------------------------------------------------------
def _full_golden() -> dict:
    import os
    from test_torch_sim import ROOT
    with open(os.path.join(ROOT, "src", "repro_torch", "golden",
                           "serve_replay_full.json")) as f:
        return json.load(f)


def test_full_golden_holds_the_phase_11_grid():
    """The committed golden file holds the four cells of
    ``benchmarks/bench_serve.py``'s full grid, in ``full_grid`` order,
    with every number chip_smoke.py compares; its kv-online cells refit."""
    golden = _full_golden()
    specs = full_grid(serve)
    assert [c["spec"] for c in golden["cells"]] == [
        json.loads(json.dumps(s.spec_dict())) for s in specs]
    for spec, cell in zip(specs, golden["cells"]):
        assert cell["spec"]["trace"]["sessions"] == 6000
        assert len(cell["wait_hist"]) == len(cell["lat_hist"]) == 512
        assert set(cell) >= {"counters", "sched_stats", "summary"}
        if spec.knobs == "kv-online":
            assert cell["sched_stats"]["refits"] >= 1


@pytest.mark.parametrize("cell", range(4))
def test_host_oracle_equals_full_golden(cell):
    """At full width (6000 sessions, 128 slots, 4096 steps) the port's
    host oracle on the CPU gives the golden file's counters, histograms,
    scheduler stats and summary: what phase 11 holds the card to."""
    spec = full_grid(serve)[cell]
    want = _full_golden()["cells"][cell]
    sched = _build_scheduler(spec, spec.resolved_knobs(), "cpu")
    res = replay(serve.generate(spec.trace), sched, slots=spec.slots,
                 max_steps=spec.max_steps, admission=spec.admission,
                 engine="host", device="cpu")
    got = json.loads(json.dumps(replay_record(res, sched.stats())))
    assert got == {k: want[k] for k in got}


# ---------------------------------------------------------------------------
# the port against the JAX package (the child's ``replay`` mode)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_replay")
    out = str(d / "replay.pkl")
    run_child("replay", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ["drift", "poisson", "bursty"])
def test_generate_matches_reference(reference, name):
    """``generate`` gives bitwise the JAX package's arrays, dtypes
    included."""
    got = serve.generate(trace_specs(serve)[name])
    for f, want in reference["traces"][name].items():
        a = getattr(got, f)
        assert a.dtype == want.dtype, f
        np.testing.assert_array_equal(a, want, err_msg=f)


@pytest.mark.parametrize("engine", ["host", "batched"])
@pytest.mark.parametrize("admission", REPLAY_ADMISSIONS)
@pytest.mark.parametrize("knobs", REPLAY_KNOBS)
def test_replay_matches_reference(reference, knobs, admission, engine):
    """Each of the port's engines equals the same JAX engine on every
    counter, both histograms, the scheduler's stats and the summary
    (and so the other JAX engine too: the child's two are equal)."""
    spec = replay_spec(serve, knobs, admission)
    trace = serve.generate(spec.trace)
    sched = _build_scheduler(spec, spec.resolved_knobs(), "cpu")
    res = replay(trace, sched, slots=spec.slots, max_steps=spec.max_steps,
                 admission=admission, engine=engine, device="cpu")
    got = replay_record(res, sched.stats())
    assert got == reference["runs"][(knobs, admission, engine)]
    other = "host" if engine == "batched" else "batched"
    assert got == reference["runs"][(knobs, admission, other)]
    assert got["counters"]["completed"] > 0
    if knobs == "kv-online":
        assert got["sched_stats"]["refits"] >= 1


def test_serve_run_doc_matches_reference(reference):
    """The port's hydra-serve/v1 document of 2 rates x 2 knobs equals the
    JAX one row for row (and as a whole), and validates."""
    rs = serve.run(replay_grid(serve), plan=CPU, device="cpu")
    doc = json.loads(json.dumps(serve.to_serve_doc(rs)))
    want = reference["doc"]
    assert len(doc["rows"]) == len(want["rows"]) == 4
    for got_row, want_row in zip(doc["rows"], want["rows"]):
        assert got_row == want_row
    assert doc == want
    assert schema_mod.validate_serve(doc) == []
