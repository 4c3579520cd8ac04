"""The port's threefry slice against jax.random: bitwise, for the key
operations and shapes the LERN fit draws with."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = range(64)


def _np(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_split_uniform_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    # lern: fold_in(key, 0) for RC, fold_in(key, 1) for RI
    for d in (0, 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(jk, d)))
    # kmeans: split(key, k) with k = 4 (and 6 in the kernel tests)
    for k in (4, 6):
        np.testing.assert_array_equal(prng.split(tk, k).numpy(),
                                      _np(jax.random.split(jk, k)))
    want = np.asarray(jax.random.uniform(jk, (), np.float32))
    got = prng.uniform(tk).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_batched_keys_match_vmapped_jax():
    """The batch form the segmented fit uses: fold/split/uniform over a
    [S, 2] stack of per-layer keys, as the JAX package vmaps them."""
    seeds = list(range(9))
    jkeys = jax.numpy.stack([jax.random.PRNGKey(s) for s in seeds])
    tkeys = torch.stack([prng.PRNGKey(s) for s in seeds])
    for d in (0, 1):
        jf = jax.vmap(lambda kk: jax.random.fold_in(kk, d))(jkeys)
        tf = prng.fold_in(tkeys, d)
        np.testing.assert_array_equal(tf.numpy(), _np(jf))
        js = jax.vmap(lambda kk: jax.random.split(kk, 4))(jf)
        ts = prng.split(tf, 4)
        np.testing.assert_array_equal(ts.numpy(), _np(js))
        for i in range(4):
            ju = jax.vmap(lambda kk: jax.random.uniform(kk, (), np.float32))(
                js[:, i])
            assert prng.uniform(ts[:, i]).numpy().tobytes() == \
                np.asarray(ju).tobytes()


def test_seed_outside_32_bits_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(1 << 31)
