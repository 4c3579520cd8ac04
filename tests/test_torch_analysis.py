"""The port's LERN analysis API against the JAX package on the CPU:
``kmeans.silhouette_score`` and ``kmeans.pca_2d`` (bitwise),
``LayerClusters.silhouette`` on a JAX model carried across with
``convert.lern_model_from_numpy`` (equal), and ``lern.train_host_numpy``
(equal cluster tables and RI centres, RC centres within rtol 1e-6,
silhouettes within 1e-9).

``repro.core.kmeans`` and ``repro.core.lern`` import in-process without the
x64 alias, so the reference runs here."""
import numpy as np
import pytest
import torch

from test_torch_sim import torch_one_thread  # noqa: F401 (fixture)

from repro.core import kmeans as jkm, lern as jlern
from repro_torch.convert import lern_model_from_numpy
from repro_torch.core import kmeans as tkm, lern as tlern
from repro_torch.core import sim as tsim

pytestmark = pytest.mark.usefixtures("torch_one_thread")
# RC centres go through the Lloyd sums of the standalone fit at each
# layer's exact point count, whose order XLA picks per shape; the tables
# are equal and the centres differ in the last bit before expm1
CENTRE_RTOL = 1e-6
SIL_ATOL = 1e-9
TABLES = ("uniq", "rc_cluster", "ri_cluster", "n_uniq")
MODEL_FIELDS = TABLES + ("rc_centers", "ri_centers", "features_ri")


def _points(seed: int, n: int, d: int, k: int):
    rng = np.random.default_rng(seed)
    centres = rng.random((k, d)) * 4
    a = rng.integers(0, k, n)
    return centres[a] + rng.normal(0, 0.3, (n, d)), a


@pytest.mark.parametrize("n,d,k,max_points", [
    (300, 4, 4, 2000), (50, 2, 3, 2000), (2600, 4, 4, 2000), (40, 4, 1, 2000),
    (500, 3, 5, 200)], ids=["n300", "n50_d2", "sampled", "one_label",
                            "max_points"])
def test_silhouette_score_matches_reference(n, d, k, max_points):
    x, a = _points(n + d + k, n, d, k)
    got = tkm.silhouette_score(x, a, max_points=max_points, seed=3)
    want = jkm.silhouette_score(x, a, max_points=max_points, seed=3)
    assert got == want
    if k == 1:
        assert got == 0.0


@pytest.mark.parametrize("n,d", [(300, 4), (17, 2), (1000, 8)])
def test_pca_2d_matches_reference(n, d):
    x, _ = _points(n * d, n, d, 3)
    got = tkm.pca_2d(x)
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got, jkm.pca_2d(x))
    np.testing.assert_array_equal(tkm.pca_2d(x.astype(np.float32)),
                                  jkm.pca_2d(x.astype(np.float32)))


@pytest.fixture(scope="module")
def config3_trace(tmp_path_factory):
    import os
    old = os.environ.get("REPRO_CACHE")
    os.environ["REPRO_CACHE"] = str(tmp_path_factory.mktemp("cache"))
    try:
        return tsim.load_trace("config3", 50_000)
    finally:
        if old is None:
            del os.environ["REPRO_CACHE"]
        else:
            os.environ["REPRO_CACHE"] = old


@pytest.fixture(scope="module")
def host_models(config3_trace):
    """(port, JAX) ``train_host_numpy`` models of the config3 trace."""
    return (tlern.train_host_numpy(config3_trace, device="cpu"),
            jlern.train_host_numpy(config3_trace))


def test_layer_silhouette_on_carried_model(host_models):
    """The JAX model's tables and features carried into the port give
    each layer's silhouette exactly, lazily, and cached on the view."""
    want = host_models[1]
    model = lern_model_from_numpy(**{f: getattr(want, f)
                                     for f in MODEL_FIELDS})
    views = model.layers
    assert all(v._sil is None for v in views)
    sils = [v.silhouette() for v in views]
    assert sils == [v.silhouette() for v in want.layers]
    assert [v._sil for v in model.layers] == sils
    assert any(0.0 < s < 1.0 for s in sils)


def test_layer_silhouette_degenerate_cases():
    """Fewer multi-reuse lines than ``MIN_MULTI``, or a feature table that
    does not match the labels, scores 0.0 without clustering."""
    few = tlern.LayerClusters(
        uniq=np.arange(4), rc_cluster=np.array([0, 1, 2, 3]),
        ri_cluster=np.array([0, 1, 2, 3]), rc_centers=np.zeros(4),
        ri_centers=np.zeros((4, 4)), features_ri=np.ones((4, 4), np.int64))
    assert few.silhouette() == 0.0
    n = 2 * tlern.MIN_MULTI
    odd = tlern.LayerClusters(
        uniq=np.arange(n), rc_cluster=np.zeros(n, np.int64),
        ri_cluster=np.arange(n) % 4, rc_centers=np.zeros(4),
        ri_centers=np.zeros((4, 4)), features_ri=np.ones((n - 1, 4)))
    assert odd.silhouette() == 0.0


def test_train_host_numpy_matches_reference(host_models):
    got, want = host_models
    for f in TABLES:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(got.features_ri, want.features_ri):
        np.testing.assert_array_equal(a, b)
    # RI centres are means of integer counts in numpy: exact
    np.testing.assert_array_equal(got.ri_centers, want.ri_centers)
    np.testing.assert_allclose(got.rc_centers, want.rc_centers,
                               rtol=CENTRE_RTOL, atol=0)
    sils = [v.silhouette() for v in got.layers]
    np.testing.assert_allclose(sils, [v.silhouette() for v in want.layers],
                               rtol=0, atol=SIL_ATOL)
    assert any(s > 0 for s in sils)


def test_train_host_numpy_uses_the_fit_kernel_wrappers(config3_trace,
                                                       monkeypatch):
    """Each eligible layer runs two ``kmeans_fit`` fits through the
    masked-fit wrapper (the kernel on a CUDA tensor), one point row a
    line at the layer's exact count, on the device asked for."""
    from repro_torch.kernels.kmeans_assign import ops as kops
    seen = []
    real = kops.fit_masked

    def spy(x, mask, centers0, iters):
        seen.append((tuple(x.shape), x.device.type, bool(mask.all())))
        return real(x, mask, centers0, iters)

    monkeypatch.setattr(kops, "fit_masked", spy)
    model = tlern.train_host_numpy(config3_trace, device="cpu")
    eligible = [li for li, f in enumerate(model.features_ri)
                if f.shape[0] >= tlern.MIN_MULTI]
    assert len(seen) == 2 * len(eligible) > 0
    for li, (rc, ri) in zip(eligible, zip(seen[::2], seen[1::2])):
        n = model.features_ri[li].shape[0]
        assert rc == ((1, n, 1), "cpu", True)
        assert ri == ((1, n, 4), "cpu", True)


def test_train_host_numpy_raises_without_cuda(config3_trace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlern.train_host_numpy(config3_trace)
