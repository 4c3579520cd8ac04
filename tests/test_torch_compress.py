"""The port's int8 gradient compression (``optim/compress.py``) against the
JAX package's on the CPU: the counterparts of ``tests/test_compress.py``
(the round-trip bound, the psum on a one-wide axis, four simulated pods, the
tree version) and ``quantize`` bitwise the JAX one on seeded inputs.

Where the JAX tests run the psum inside ``shard_map`` on a one-wide mesh
axis, these run it over a gloo process group of one on a ``FileStore``
under the test's ``tmp_path``; the fixture destroys the group, so no state
outlives a test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compress as jcompress
from repro_torch.optim import (dequantize, quantize, quantized_psum,
                               quantized_psum_tree)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one process (rank 0), destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(256, 64)), dtype=torch.float32)
    q, scale = quantize(x)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    back = dequantize(q, scale)
    assert float((back - x).abs().max()) <= 0.5 * float(scale) + 1e-7


@pytest.mark.parametrize("case", ["normal", "bf16", "zeros", "tiny",
                                  "ties", "given_scale"])
def test_quantize_is_the_jax_quantize(case):
    """Codes and scale bitwise the JAX function's: half-to-even rounding
    (``ties``: exact multiples of half a scale), the 1e-12 floor (``zeros``,
    ``tiny``), bf16 input, a scale given by the caller (clipped codes)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(33, 17)).astype(np.float32)
    scale = None
    if case == "zeros":
        x = np.zeros((5, 3), np.float32)
    elif case == "tiny":
        x = (x * 1e-14).astype(np.float32)
    elif case == "ties":
        x = (np.arange(-260, 261, dtype=np.float32) * 0.5)
    elif case == "given_scale":
        scale = np.float32(0.004)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if case == "bf16" else
              (jnp.float32, torch.float32))
    jx = jnp.asarray(x, jd)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(td)
    jq, js = jcompress.quantize(jx, None if scale is None
                                else jnp.float32(scale))
    tq, ts = quantize(tx, None if scale is None else torch.tensor(scale))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.float32(js)
    np.testing.assert_array_equal(
        dequantize(tq, ts, torch.bfloat16).float().numpy(),
        np.asarray(jcompress.dequantize(jq, js, jnp.bfloat16)
                   .astype(jnp.float32)))


@pytest.mark.usefixtures("world_of_one")
def test_quantized_psum_matches_psum():
    """A world of one: compressed == exact sum up to the quantization
    error, and bitwise the JAX psum on its one-wide axis (which is a
    quantize-dequantize round trip)."""
    x = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    out = quantized_psum(torch.as_tensor(x))
    assert out.dtype == torch.float32
    err = float((out - torch.as_tensor(x)).abs().max())
    assert err <= float(np.abs(x).max()) / 127.0 + 1e-6
    jq, js = jcompress.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jcompress.dequantize(jq, js)))


def test_quantized_psum_simulated_pods():
    """Simulate 4 pods' partial gradients: compressed sum within the
    analytic error bound of the exact sum, the codes bitwise the JAX
    ones."""
    rng = np.random.default_rng(2)
    parts = [rng.normal(size=(128,)).astype(np.float32) for _ in range(4)]
    exact = sum(parts)
    scale = max(float(np.abs(p).max()) for p in parts) / 127.0
    codes = [quantize(torch.as_tensor(p), torch.tensor(np.float32(scale)))[0]
             for p in parts]
    for p, q in zip(parts, codes):
        np.testing.assert_array_equal(q.numpy(), np.asarray(
            jcompress.quantize(jnp.asarray(p), jnp.float32(scale))[0]))
    total = sum(q.to(torch.int32) for q in codes)
    approx = total.float() * np.float32(scale)
    assert float((approx - torch.as_tensor(exact)).abs().max()) <= \
        0.5 * scale * 4 + 1e-6


@pytest.mark.usefixtures("world_of_one")
def test_tree_version():
    tree = {"a": torch.ones((8,)),
            "b": {"c": torch.full((4,), -2.0),
                  "d": torch.ones(3, 2, dtype=torch.bfloat16)}}
    out = quantized_psum_tree(tree)
    assert sorted(out) == ["a", "b"] and sorted(out["b"]) == ["c", "d"]
    np.testing.assert_allclose(out["b"]["c"].numpy(), -2.0, atol=0.02)
    assert out["b"]["d"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["a"].numpy(), 1.0, atol=0.01)


def test_quantized_psum_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        quantized_psum(torch.ones(4))
