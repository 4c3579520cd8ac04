"""The port's serving layer against the JAX package on the CPU:
``ServeEngine.run`` on the reduced qwen3-1.7b (stats equal, final KV caches
within the model-level tolerance), ``SessionProfile.fit`` and ``classify``
(equal), and the HyDRA scheduler under a ``refit`` fault.

``repro.serve`` cannot be imported in a pytest worker under the installed
JAX (it needs the ``jax.experimental.enable_x64`` alias), so the reference
runs in the ``serve`` mode of the child in ``tests/test_torch_sim.py``."""
import pickle

import numpy as np
import pytest
import torch

from test_torch_models import LOGIT_RTOL
from test_torch_sim import (CLASSIFY_GRID, LM_ARCH, SERVE_RUN, drive_scheduler,
                            engine_cases, profile_cases, run_child,
                            serve_requests, torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_serve")
    out = str(d / "serve.pkl")
    run_child("serve", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def reduced_params():
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    cfg = get_arch(LM_ARCH).reduced()
    return cfg, lm_params_from_numpy(lm_numpy_params(cfg, seed=0), cfg,
                                     "cpu")


@pytest.mark.parametrize("case", ["none", "hydra", "online"])
def test_engine_run_matches_reference(reference, reduced_params, case):
    """Stats equal (completed, dmr, throughput, reprefills, the scheduler's
    counts and thresholds); the KV caches the 89 decode steps left behind
    agree within the model-level tolerance; the profile equals."""
    from repro_torch import serve
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = reduced_params
    want = reference["engines"][case]
    sched = engine_cases(serve)[case](device="cpu")
    eng = ServeEngine(cfg, params, slots=SERVE_RUN["slots"],
                      s_max=SERVE_RUN["s_max"], scheduler=sched)
    stats = eng.run([Request(**r) for r in serve_requests()],
                    max_steps=SERVE_RUN["max_steps"])
    assert stats == want["stats"]
    assert eng.state.pos == want["pos"] == eng.state.kv.length
    for name in ("k", "v"):
        got = getattr(eng.state.kv, name).float().numpy()
        ref = want[name]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= LOGIT_RTOL * np.abs(ref).max()
    if want["profile"] is not None:
        np.testing.assert_array_equal(sched.profile.rc_centers,
                                      want["profile"][0])
        np.testing.assert_array_equal(sched.profile.ri_centers,
                                      want["profile"][1])


@pytest.mark.parametrize("i", range(len(profile_cases())))
def test_session_profile_matches_reference(reference, i):
    """The fitted centres (through kmeans_fit_batched and the dense
    assignment's plain version) are bitwise the JAX package's, and so is
    every classification of the grid."""
    from repro_torch.serve import SessionProfile
    turns, gaps, seed = profile_cases()[i]
    want = reference["profiles"][i]
    prof = SessionProfile.fit(turns, gaps, seed=seed, device="cpu")
    np.testing.assert_array_equal(prof.rc_centers, want["rc"])
    np.testing.assert_array_equal(prof.ri_centers, want["ri"])
    assert [prof.classify(t, g) for t, g in CLASSIFY_GRID] == \
        [tuple(c) for c in want["classify"]]


def _scheduler(device="cpu", **knobs):
    from repro_torch.serve import (HydraKVScheduler, SchedulerKnobs,
                                   SessionProfile)
    turns, gaps, _ = profile_cases()[0]
    profile = SessionProfile.fit(turns, gaps, device=device)
    return HydraKVScheduler(SchedulerKnobs(token_budget=2048,
                                           deadline_tokens=128, **knobs),
                            profile=profile, device=device)


def test_refit_fault_degrades_like_reference(reference):
    """An injected ``refit`` fault costs one refit (tests/test_faults.py:
    one failure, later boundaries refit, the profile is swapped), and the
    whole drive equals the JAX scheduler's."""
    from repro_torch.exp import faults
    sched = _scheduler(retrain_period=4)
    first = sched.profile
    plan = faults.FaultPlan.make([faults.FaultSpec(site="refit",
                                                   kind="raise")])
    with faults.activate(plan):
        drive_scheduler(sched)
    assert sched.refit_failures == 1
    assert sched.refits >= 1
    assert sched.profile is not first
    want = reference["refit_fault"]
    assert sched.stats() == want["stats"]
    np.testing.assert_array_equal(sched.profile.rc_centers, want["rc"])
    np.testing.assert_array_equal(sched.profile.ri_centers, want["ri"])
    assert any(e["kind"] == "fault" and e["site"] == "refit"
               for e in faults.drain_events())


def test_refit_failure_keeps_stale_profile(monkeypatch):
    """A refit that raises never leaves ``epoch_update``: the scheduler
    keeps serving on the stale profile and counts the failures."""
    from repro_torch.serve import SessionProfile
    sched = _scheduler(retrain_period=4)
    profile = sched.profile

    def broken_fit(*a, **kw):
        raise ValueError("degenerate window")

    monkeypatch.setattr(SessionProfile, "fit", staticmethod(broken_fit))
    drive_scheduler(sched)
    assert sched.refit_failures >= 1
    assert sched.refits == 0
    assert sched.profile is profile
    assert sched.stats()["refit_failures"] == sched.refit_failures


def test_admission_fault_site_fires():
    """The engine's ``serve_admission`` site fires before a free slot takes
    a request (exercised through the unbound ``_admit``, no weights)."""
    import types

    from repro_torch.exp import faults
    from repro_torch.serve import engine as engine_mod
    eng = types.SimpleNamespace(slots=[engine_mod._Slot()], clock=0)
    plan = faults.FaultPlan.make([faults.FaultSpec(site="serve_admission",
                                                   kind="raise")])
    with faults.activate(plan):
        with pytest.raises(faults.InjectedFault):
            engine_mod.ServeEngine._admit(eng, [object()])
    assert any(e["kind"] == "fault" and e["site"] == "serve_admission"
               for e in faults.drain_events())


def test_scheduler_rejects_keyword_constructor():
    from repro_torch.serve import HydraKVScheduler
    with pytest.raises(TypeError, match="SchedulerKnobs"):
        HydraKVScheduler(token_budget=4096, deadline_tokens=128)


def test_serve_entry_points_raise_without_cuda(monkeypatch):
    """The scheduler, the profile fit and the model's init default to the
    card and raise without one."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.serve import (HydraKVScheduler, SchedulerKnobs,
                                   SessionProfile)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    turns, gaps, _ = profile_cases()[0]
    calls = [
        lambda: SessionProfile.fit(turns, gaps),
        lambda: HydraKVScheduler(SchedulerKnobs(token_budget=1,
                                                deadline_tokens=1)),
        lambda: lm.init_params(torch.Generator(), get_arch(LM_ARCH).reduced()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_launcher_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` serves the
    launcher's requests."""
    import sys

    from repro_torch.launch import serve as launcher
    argv = sys.argv
    try:
        sys.argv = ["serve", "--device", "cpu", "--requests", "4",
                    "--max-new", "4"]
        launcher.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "'completed': 4" in out
