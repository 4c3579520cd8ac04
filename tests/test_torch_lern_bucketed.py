"""The port's bucketed LERN engine and host-reference trainers against the
JAX package, and the fit-engine selection.

Cluster tables (``uniq``, ``rc_cluster``, ``ri_cluster``, ``n_uniq``),
the integer features and the RI centres are equal, bitwise.  RC centres
equal within rtol 1e-6: the port replays XLA's log1p/expm1 and its
Lloyd-sum orders, but not every order of XLA's CPU code for a one-layer
bucket of 64-256 rows (ROADMAP.md Queue 3: config3 at 10k, layer 5, is
off by an ulp).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lern as jlern, lrpt as jlrpt
from repro_torch.core import lern as tlern, lrpt as tlrpt
from repro_torch.core import sim as tsim
from test_torch_sim import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("uniq", "rc_cluster", "ri_cluster", "n_uniq")
RC_RTOL = 1e-6


def _assert_models_equal(got, want):
    for f in TABLES:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got.features_ri) == len(want.features_ri)
    for a, b in zip(got.features_ri, want.features_ri):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.ri_centers, want.ri_centers)
    np.testing.assert_allclose(got.rc_centers, want.rc_centers, rtol=RC_RTOL,
                               atol=0)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    old = os.environ.get("REPRO_CACHE")
    os.environ["REPRO_CACHE"] = str(tmp_path_factory.mktemp("cache"))
    try:
        return {c: tsim.load_trace(c, 10_000) for c in ("config1", "config3")}
    finally:
        if old is None:
            del os.environ["REPRO_CACHE"]
        else:
            os.environ["REPRO_CACHE"] = old


@pytest.mark.parametrize("variant", ["full", "loptv3"])
def test_train_model_batched_bucketed(traces, variant):
    tr = traces["config3"]
    want = jlern.train_model_batched(tr, hash_fn=jlrpt.lrpt_train_hash(variant),
                                     fit_engine="bucketed")
    got = tlern.train_model_batched(tr, hash_fn=tlrpt.lrpt_train_hash(variant),
                                    fit_engine="bucketed", device="cpu")
    _assert_models_equal(got, want)
    np.testing.assert_array_equal(tlrpt.pack_tables(got, variant),
                                  jlrpt.pack_tables(want, variant))


def test_train_matches_reference(traces):
    tr = traces["config3"]
    _assert_models_equal(tlern.train(tr, seed=3, device="cpu"),
                         jlern.train(tr, seed=3))


@pytest.mark.parametrize("layer,cap", [(5, None), (6, 2048)])
def test_train_layer_matches_reference(traces, layer, cap):
    tr = traces["config3"]
    lines = tr.line[tr.layer == layer]
    want = jlern.train_layer(lines, seed=layer, cap=cap)
    got = tlern.train_layer(lines, seed=layer, cap=cap, device="cpu")
    for f in ("uniq", "rc_cluster", "ri_cluster", "features_ri",
              "ri_centers"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.rc_centers, want.rc_centers, rtol=RC_RTOL)


@pytest.mark.parametrize("engine", ["bucketed", "segmented"])
def test_train_family_batched(traces, engine):
    trs = [traces["config1"], traces["config3"]]
    want = jlern.train_family_batched(trs, seed=1, fit_engine=engine)
    got = tlern.train_family_batched(trs, seed=1, fit_engine=engine,
                                     device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_models_equal(g, w)
    # each family member equals its own-config model
    alone = tlern.train_model_batched(traces["config3"], seed=1,
                                      fit_engine=engine, device="cpu")
    for f in TABLES:
        np.testing.assert_array_equal(getattr(got[1], f), getattr(alone, f))


def test_accuracy_and_distribution(traces):
    tr = traces["config3"]
    want = jlern.train_model_batched(tr, fit_engine="bucketed")
    got = tlern.train_model_batched(tr, fit_engine="bucketed", device="cpu")
    acc = tlern.prediction_accuracy(got, tr)
    assert acc == jlern.prediction_accuracy(want, tr)
    assert 0.0 < acc <= 1.0
    dg = tlern.cluster_distribution(got, tr)
    dw = jlern.cluster_distribution(want, tr)
    for k in ("ri", "rc"):
        np.testing.assert_array_equal(dg[k], dw[k])


def test_fit_engine_override_and_lern_tag(monkeypatch):
    """``fit_engine_override`` pins the engine the trainers use and the
    LERN cache tag; ``None`` keeps the ambient one."""
    calls = []
    real = tlern._fit_flat_bucketed
    monkeypatch.setattr(tlern, "_fit_flat_bucketed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert tsim._lern_tag() == "v4"
    with tlern.fit_engine_override("bucketed"):
        assert tlern.resolve_engine() == "bucketed"
        assert tsim._lern_tag() == "v4-bucketed"
        assert tsim.family_cap() == tsim.FAMILY_MAX_ACCESSES
        from repro_torch.core.tracegen import Trace
        tr = Trace(line=np.arange(64) % 9, write=np.zeros(64, bool),
                   cycle=np.arange(64), layer=np.zeros(64, np.int64),
                   layer_names=["l0"], compute_cycles=64)
        tlern.train_model_batched(tr, device="cpu")
        with tlern.fit_engine_override(None):
            assert tlern.resolve_engine() == "bucketed"
    assert calls
    assert tsim._lern_tag() == "v4"
    assert tsim.family_cap() == float("inf")
    with pytest.raises(ValueError):
        with tlern.fit_engine_override("nope"):
            pass


def test_repro_lern_fit_env_is_honoured():
    """``REPRO_LERN_FIT`` sets the default engine at import, as the JAX
    package's ``lern.FIT_ENGINE`` does (checked in a fresh process)."""
    code = ("from repro_torch.core import lern, sim; "
            "print(lern.FIT_ENGINE, lern.resolve_engine(), sim._lern_tag())")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_LERN_FIT="bucketed")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["bucketed", "bucketed", "v4-bucketed"]


def test_log1p_counts_is_xla_log1p():
    """The RC features: log1p of reuse counts, bit for bit XLA's."""
    n = np.arange(0, 1 << 18, dtype=np.int64)
    want = np.asarray(jax.jit(jnp.log1p)(n.astype(np.float32)))
    np.testing.assert_array_equal(
        tlern.log1p_counts(torch.as_tensor(n)).numpy(), want)


def test_expm1_centres_is_xla_expm1():
    """De-normalized RC centres (above log1p(2)): expm1, bit for bit
    XLA's; below 0.5 torch's own."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(0.5, 20, 200_000),
                        np.log1p(np.arange(2, 5000))]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.expm1)(x))
    np.testing.assert_array_equal(
        tlern.expm1_centres(torch.as_tensor(x)).numpy(), want)
    small = torch.tensor([0.0, 0.25, -0.3])
    assert torch.equal(tlern.expm1_centres(small), torch.expm1(small))
