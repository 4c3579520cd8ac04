"""The port's LERN fit against the JAX package: the flat-segmented
k-means (equal assignments on valid rows, centres within atol 1e-5 --
reassociation is allowed -- from the same keys) and train_model_batched
on config3 (equal cluster tables, bitwise L-RPT images)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm, lern as jlern, lrpt as jlrpt
from repro_torch.core import kmeans as tkm, lern as tlern, lrpt as tlrpt
from repro_torch.core import prng
from repro_torch.core import sim as tsim


@pytest.mark.parametrize("sizes,d,scale,seed", [
    ([40, 120, 17], 4, 1.0, 1), ([500, 3000, 77, 9], 4, 1.0, 2),
    ([13, 8, 29], 4, 3.0, 3), ([64, 2100, 350, 8, 700, 16], 4, 0.5, 4)])
def test_kmeans_fit_segmented_matches_reference(sizes, d, scale, seed):
    rng = np.random.default_rng(seed)
    off, total = jkm.segment_layout(sizes)
    total = max(((total + 2047) // 2048) * 2048, 8)
    s = len(sizes)
    x = np.zeros((total, d), np.float32)
    seg = np.full(total, s, np.int32)
    for i, n in enumerate(sizes):
        # lattice points: the exact distance ties real feature rows have
        x[off[i]:off[i] + n] = np.round(rng.random((n, d)) * 6) / 6 * scale
        seg[off[i]:off[i] + n] = i
    cnt = np.asarray(sizes, np.int32)
    want = jkm.kmeans_fit_segmented(
        jnp.asarray(x), jnp.asarray(seg), off, cnt,
        jnp.stack([jax.random.PRNGKey(i) for i in range(s)]), n_seg=s, k=4,
        use_kernel=False)
    got = tkm.kmeans_fit_segmented(
        x, seg, off, cnt, torch.stack([prng.PRNGKey(i) for i in range(s)]),
        n_seg=s, k=4, device="cpu")
    valid = seg < s
    np.testing.assert_array_equal(got.assign.numpy()[valid],
                                  np.asarray(want.assign)[valid])
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=1e-5, rtol=0)


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


@pytest.mark.parametrize("variant", ["full", "loptv3"])
def test_train_model_batched_config3(config3_trace, variant):
    hash_t = tlrpt.lrpt_train_hash(variant)
    hash_j = jlrpt.lrpt_train_hash(variant)
    want = jlern.train_model_batched(config3_trace, hash_fn=hash_j)
    got = tlern.train_model_batched(config3_trace, hash_fn=hash_t,
                                    device="cpu")
    for f in ("uniq", "rc_cluster", "ri_cluster", "n_uniq"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(got.features_ri, want.features_ri):
        np.testing.assert_array_equal(a, b)
    # RI centres are means of integer counts (exact); RC centres go
    # through log1p/expm1, which the port computes as XLA does
    np.testing.assert_array_equal(got.ri_centers, want.ri_centers)
    np.testing.assert_array_equal(got.rc_centers, want.rc_centers)
    np.testing.assert_array_equal(tlrpt.pack_tables(got, variant),
                                  jlrpt.pack_tables(want, variant))


def test_bucketed_engine_not_ported():
    """(Named when the bucketed engine was still to port; since it is,
    the test pins the engine names resolve_engine accepts.)"""
    assert tlern.resolve_engine() == tlern.resolve_engine("auto") == \
        "segmented"
    assert tlern.resolve_engine("bucketed") == "bucketed"
    with pytest.raises(ValueError):
        tlern.resolve_engine("kd-tree")
