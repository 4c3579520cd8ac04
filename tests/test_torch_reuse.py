"""The port's reuse features against the JAX package: reuse_features_flat
bitwise (uniq / f_ri / f_rc / n_uniq) on random multi-layer traces and on
config3's layer-sorted trace, and against the numpy oracle per layer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lern as jlern, reuse as jreuse
from repro_torch.core import lern as tlern, reuse as treuse
from repro_torch.core import sim as tsim


def _compare(lines: np.ndarray, layer: np.ndarray, n_layers: int,
             pad: int = 0):
    m = lines.shape[0]
    lines32 = np.full(m + pad, int(jreuse.PAD_LINE), np.int32)
    lines32[:m] = jreuse.lines_to_device(lines)
    layer32 = np.full(m + pad, n_layers, np.int32)
    layer32[:m] = layer
    want = jreuse.reuse_features_flat(jnp.asarray(lines32),
                                      jnp.asarray(layer32), jnp.int32(m),
                                      n_layers)
    got = treuse.reuse_features_flat(torch.as_tensor(lines32),
                                     torch.as_tensor(layer32), m, n_layers)
    for k in ("uniq", "f_ri", "f_rc", "n_uniq"):
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("seed,n_layers,m,pad", [
    (0, 1, 500, 0), (1, 3, 4000, 96), (2, 7, 20_000, 4096),
    (3, 12, 9000, 7)])
def test_flat_features_bitwise_random(seed, n_layers, m, pad):
    rng = np.random.default_rng(seed)
    layer = np.sort(rng.integers(0, n_layers, m))
    lines = rng.integers(0, 300 * (seed + 1), m)
    got = _compare(lines, layer, n_layers, pad)
    # and per layer against the numpy oracle (Table I semantics)
    off = np.concatenate([[0], np.cumsum(got["n_uniq"])])
    for li in range(n_layers):
        ll = lines[layer == li]
        if ll.size == 0:
            assert got["n_uniq"][li] == 0
            continue
        f_ri, f_rc = treuse.ri_histogram_np(ll)
        sl = slice(off[li], off[li + 1])
        np.testing.assert_array_equal(got["uniq"][sl],
                                      np.unique(ll).astype(np.int32))
        np.testing.assert_array_equal(got["f_ri"][sl], f_ri)
        np.testing.assert_array_equal(got["f_rc"][sl], f_rc)


def test_flat_features_bitwise_config3(tmp_path, monkeypatch):
    """config3's layer-sorted trace at subsample_target=50_000, as the
    LERN trainer hands it to the extraction (padded to 4096)."""
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    tr = tsim.load_trace("config3", 50_000)
    lines, layer = tlern._layer_sorted(tr)
    jl, jy = jlern._layer_sorted(tr)
    np.testing.assert_array_equal(lines, jl)
    np.testing.assert_array_equal(layer, jy)
    m = lines.shape[0]
    _compare(lines, layer, len(tr.layer_names), (-m) % 4096)


def test_numpy_oracle_copied():
    rng = np.random.default_rng(9)
    lines = rng.integers(0, 50, 2000)
    a, b = jreuse.reuse_signature_np(lines), treuse.reuse_signature_np(lines)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for x, y in zip(jreuse.ri_histogram_np(lines),
                    treuse.ri_histogram_np(lines)):
        np.testing.assert_array_equal(x, y)
