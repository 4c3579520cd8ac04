"""The port's dense k-means assignment and masked k-means fit against the
JAX package.

* ``kmeans_assign.ops.assign_plain`` (what the dense CUDA kernel computes)
  equals the Pallas ``ops.assign`` (interpret mode) and ``ref.assign_ref``
  at the ``tests/test_kernels.py`` cases, in f32 and bf16, and per row of
  a batched call; ties keep the first index.
* ``kmeans_fit_batched`` against the vmapped JAX fit from the same keys:
  assignments equal on the valid rows, centres bitwise (up to 2048 rows
  at D = 4; the Lloyd sums of larger D = 4 buckets are not added in
  XLA's order, ROADMAP.md Queue 3).
* ``kmeans_fit_masked`` / ``kmeans_fit`` against the single JAX fit:
  assignments equal, centres within atol 1e-5 (for D = 1 the port adds
  the Lloyd sums in the order XLA's code for the LERN fit uses; the
  standalone JAX fit is compiled differently for 64..256 rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.kernels.kmeans_assign import ops as jops, ref as jref
from repro_torch.core import kmeans as tkm
from repro_torch.core import prng
from repro_torch.kernels.kmeans_assign import ops as tops
from test_torch_sim import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CENTRE_ATOL = 1e-5
KERNEL_CASES = [(64, 4, 4), (777, 4, 4), (2048, 8, 6), (100, 1, 3),
                (4096, 16, 4)]


def _separated(n, d, k, dtype, rng):
    """tests/test_kernels.py's inputs: well-separated clusters."""
    centers = jnp.asarray(rng.normal(size=(k, d)) * 10, dtype)
    x = jnp.asarray(np.asarray(centers)[rng.integers(0, k, n)]
                    + rng.normal(size=(n, d)) * 0.01, dtype)
    return x, centers


def _torch(a, dtype):
    """A jnp array (f32 or bf16) as a torch tensor of the same values."""
    t = torch.as_tensor(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("n,d,k", KERNEL_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_assign_plain_matches_pallas_and_ref(n, d, k, dtype):
    rng = np.random.default_rng(7)
    x, centers = _separated(n, d, k, dtype, rng)
    got = tops.assign_plain(_torch(x, dtype), _torch(centers, dtype))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.assign(x,
                                                                      centers)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.assign_ref(x, centers)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_assign_batched_matches_per_row(dtype):
    rng = np.random.default_rng(9)
    rows = [_separated(777, 4, 4, dtype, rng) for _ in range(3)]
    xb = torch.stack([_torch(x, dtype) for x, _ in rows])
    cb = torch.stack([_torch(c, dtype) for _, c in rows])
    got = tops.assign(xb, cb)
    assert got.shape == (3, 777)
    for i, (x, c) in enumerate(rows):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(jref.assign_ref(x, c)))


def test_assign_ties_keep_first_index():
    """Exact ties (duplicated centres, points equidistant from two
    centres) resolve to the lowest index, as jnp.argmin does."""
    centers = np.array([[1., 0., 0., 0.], [0., 1., 0., 0.],
                        [1., 0., 0., 0.], [0., 0., 1., 0.]], np.float32)
    x = np.array([[1., 0., 0., 0.], [.5, .5, 0., 0.], [0., .5, .5, 0.],
                  [0., 0., 0., 0.], [0., 1., 0., 0.]], np.float32)
    got = tops.assign(torch.as_tensor(x), torch.as_tensor(centers)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 1, 0, 1])
    np.testing.assert_array_equal(
        tkm.assign(torch.as_tensor(x), torch.as_tensor(centers)).numpy(), got)
    np.testing.assert_array_equal(
        got, np.asarray(jkm.assign_jnp(jnp.asarray(x), jnp.asarray(centers))))


def test_cpu_tensors_count_no_launches():
    x = torch.rand(64, 4)
    centers = torch.rand(4, 4)
    before = (tops.assign.launches, tops.assign_segmented.launches)
    tops.assign(x, centers)
    tops.assign_segmented(x, centers[None], torch.zeros(64,
                                                        dtype=torch.int32))
    tkm.kmeans_fit(x, iters=3, device="cpu")
    assert (tops.assign.launches, tops.assign_segmented.launches) == before


def _features(rng, b, cap, d, lattice):
    """Masked feature rows like LERN's: RI histograms L1-normalized
    (d = 4, small-integer lattice with exact distance ties) or normalized
    log counts (d = 1); ragged valid counts, zeroed masked rows."""
    x = np.zeros((b, cap, d), np.float32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        n = cap if i == 0 else max(8, cap // (i + 1) + i)
        if lattice:
            raw = rng.integers(0, 5, (n, d)).astype(np.float32)
            v = raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)
        else:
            v = np.log1p(rng.integers(2, 400, (n, d))).astype(np.float32)
            v = (v - v.min()) / max(v.max() - v.min(), 1e-9)
        x[i, :n] = v
        mask[i, :n] = True
    return x, mask


def _keys(b, base):
    keys = jnp.stack([jax.random.PRNGKey(base + i) for i in range(b)])
    return keys, torch.as_tensor(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("cap,d", [(16, 1), (64, 4), (256, 1), (512, 4),
                                   (1024, 1), (2048, 4)])
def test_kmeans_fit_batched_matches_reference(cap, d):
    rng = np.random.default_rng(cap + d)
    x, mask = _features(rng, 3, cap, d, lattice=d == 4)
    jkeys, tkeys = _keys(3, cap)
    want = jkm.kmeans_fit_batched(jnp.asarray(x), jnp.asarray(mask), jkeys,
                                  k=4, use_kernel=False)
    got = tkm.kmeans_fit_batched(x, mask, tkeys, k=4, device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(got.assign[i].numpy()[mask[i]],
                                      np.asarray(want.assign[i])[mask[i]])
    np.testing.assert_array_equal(got.centers.numpy(),
                                  np.asarray(want.centers))
    # the inertia's sum over N is not added in XLA's order
    np.testing.assert_allclose(got.inertia.numpy(),
                               np.asarray(want.inertia), rtol=1e-5)


@pytest.mark.parametrize("cap,d", [(64, 4), (512, 1), (1024, 4)])
def test_kmeans_fit_masked_matches_reference(cap, d):
    rng = np.random.default_rng(3 * cap + d)
    x, mask = _features(rng, 2, cap, d, lattice=d == 4)
    jkeys, tkeys = _keys(2, 11)
    want = jkm.kmeans_fit_masked(jnp.asarray(x[1]), jnp.asarray(mask[1]),
                                 jkeys[1], k=4, use_kernel=False)
    got = tkm.kmeans_fit_masked(x[1], mask[1], tkeys[1], k=4, device="cpu")
    np.testing.assert_array_equal(got.assign.numpy()[mask[1]],
                                  np.asarray(want.assign)[mask[1]])
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=CENTRE_ATOL, rtol=0)


def test_kmeans_fit_and_normalize_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    want = jkm.kmeans_fit(jnp.asarray(x), k=4, iters=10, seed=5,
                          use_kernel=False)
    got = tkm.kmeans_fit(x, k=4, iters=10, seed=5, device="cpu")
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=CENTRE_ATOL, rtol=0)
    jn = jkm.normalize(jnp.asarray(x))
    tn = tkm.normalize(torch.as_tensor(x))
    for a, b in zip(tn, jn):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [5, 16, 100, 4096, 40_000])
def test_xla_cumsum_matches_jnp_cumsum(n):
    """The k-means++ inverse-CDF prefix sums replay XLA's cumsum."""
    w = (np.random.default_rng(n).random((2, n)) * 3).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(w))
    np.testing.assert_array_equal(tkm._xla_cumsum(torch.as_tensor(w)).numpy(),
                                  want)


def test_plus_plus_seeding_matches_reference():
    rng = np.random.default_rng(4)
    x, mask = _features(rng, 3, 256, 4, lattice=True)
    jkeys, tkeys = _keys(3, 21)
    for i in range(3):
        want = jkm._plus_plus_init_masked(jkeys[i], jnp.asarray(x[i]),
                                          jnp.asarray(mask[i]), 4)
        got = tkm._plus_plus_init_masked(tkeys[i:i + 1],
                                         torch.as_tensor(x[i:i + 1]),
                                         torch.as_tensor(mask[i:i + 1]), 4)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_prng_split_and_fold_in_batch():
    """The fit's key handling: fold_in then split per batch row."""
    jk = jnp.stack([jax.random.PRNGKey(i) for i in (0, 7)])
    tk = torch.as_tensor(np.asarray(jk).astype(np.int64))
    want = np.stack([np.asarray(jax.random.split(jax.random.fold_in(k, 1), 4))
                     for k in jk])
    np.testing.assert_array_equal(prng.split(prng.fold_in(tk, 1), 4).numpy(),
                                  want.astype(np.int64))
