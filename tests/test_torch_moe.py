"""The port's MoE FFN (``models/moe.py``) against the JAX package's on the
CPU: the counterparts of ``tests/test_perf_paths.py``'s dispatch tests
(the sorted route equals the one-hot route without drops, capacity drops
row-wise, decode takes the one-hot route) at the same shapes in f32 and
bf16, the router's selections and the sorted route's slots against the JAX
ones, and ``aux_load_balance_loss``.

The weights are the JAX ``moe_init``'s (``PRNGKey(0)``, bf16) copied into
the port's ``MoE``.  Bars: f32 outputs within 1e-5 of JAX's (the sums are
in another order); the two routes of the port within 1e-4 of each other
in f32, as the JAX test holds its own.  bf16 outputs within the larger of
the JAX package's own sorted-versus-einsum gap at the same inputs and one
bf16 ulp at max |out|: where k = 1 the JAX routes agree bit for bit (no
combine), a gap of 0 that another framework's bf16 products cannot meet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from test_torch_sim import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CASES = [(2, 32, 64, 8, 2), (1, 64, 32, 4, 1), (3, 16, 48, 6, 3)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _port(jp) -> tmoe.MoE:
    """The port's ``MoE`` holding a JAX ``moe_init`` tree."""
    d, e = jp["router"].shape
    shared = jp["shared"]["w_gate"].shape[1] if "shared" in jp else 0
    m = tmoe.MoE(None, d, jp["w_gate"].shape[2], e, int(bool(shared)),
                 shared, "cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            a = jp
            for key in name.split("."):
                a = a[key]
            assert tuple(p.shape) == a.shape and p.dtype == torch.bfloat16
            p.copy_(torch.tensor(np.asarray(a.astype(jnp.float32))))
    return m


def _x(shape, dtype, seed=1, scale=0.1):
    jd, td = DTYPES[dtype]
    jx = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                     jd)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(a) -> float:
    """One bf16 ulp at max |a|."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,d,e,k", CASES)
def test_sorted_dispatch_matches_einsum(b, s, d, e, k, dtype):
    """High capacity, no drops: the port's two routes agree, and each is
    JAX's within the bars of the module docstring."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), d, d * 2, e, n_shared=1,
                       shared_d_ff=d * 2)
    tp = _port(jp)
    jx, tx = _x((b, s, d), dtype)
    kw = dict(top_k=k, capacity_factor=float(e))
    js, je = jmoe.moe_ffn_sorted(jp, jx, **kw), jmoe.moe_ffn(jp, jx, **kw)
    with torch.no_grad():
        ts, te = tmoe.moe_ffn_sorted(tp, tx, **kw), tmoe.moe_ffn(tp, tx, **kw)
    assert ts.dtype == te.dtype == DTYPES[dtype][1]
    assert ts.shape == te.shape == (b, s, d)
    if dtype == "float32":
        np.testing.assert_allclose(_np(ts), _np(te), atol=1e-4)
        np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(te), _np(je), atol=1e-5, rtol=0)
    else:
        bar = max(float(np.abs(_np(js) - _np(je)).max()), _bf16_ulp(_np(js)))
        assert np.abs(_np(ts) - _np(js)).max() <= bar
        assert np.abs(_np(te) - _np(je)).max() <= bar


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("b,s,d,e,k", CASES)
def test_sorted_route_is_the_jax_route(b, s, d, e, k, capacity_factor):
    """The router's top-k selections and weights equal JAX's, and the
    sorted route's slots (``dst``; the dump row n_exp * cap for a dropped
    pair) are the stable-sort ranking of JAX's selections; at binding
    capacity the outputs still equal JAX's (the same pairs dropped)."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), d, d * 2, e, n_shared=1,
                       shared_d_ff=d * 2)
    tp = _port(jp)
    jx, tx = _x((b, s, d), "float32")
    logits = jnp.einsum("bsd,de->bse", jx, jp["router"].astype(jnp.float32))
    jw, jsel = jax.lax.top_k(logits, k)
    with torch.no_grad():
        r = tmoe.sorted_route(tp, tx, top_k=k,
                              capacity_factor=capacity_factor)
    cap = max(int(s * k * capacity_factor / e), 4)
    assert r.cap == cap
    np.testing.assert_array_equal(r.sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(r.weights.numpy(),
                               np.asarray(jax.nn.softmax(jw, -1)), atol=1e-6)
    flat = np.asarray(jsel).reshape(b, s * k)
    for row in range(b):
        order = np.argsort(flat[row], kind="stable")
        e_sorted = flat[row][order]
        rank = np.arange(s * k) - np.searchsorted(e_sorted, e_sorted)
        dst = np.where(rank < cap, e_sorted * cap + rank, e * cap)
        np.testing.assert_array_equal(r.order[row].numpy(), order)
        np.testing.assert_array_equal(r.dst[row].numpy(), dst)
        np.testing.assert_array_equal(r.src_tok[row].numpy(), order // k)
    with torch.no_grad():
        out = tmoe.moe_ffn_sorted(tp, tx, top_k=k,
                                  capacity_factor=capacity_factor)
    np.testing.assert_allclose(_np(out), _np(jmoe.moe_ffn_sorted(
        jp, jx, top_k=k, capacity_factor=capacity_factor)), atol=1e-5,
        rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sorted_dispatch_capacity_drops_rowwise(dtype):
    """At binding capacity the row-local route drops per row; outputs stay
    finite and equal JAX's (the test_perf_paths shape)."""
    jp = jmoe.moe_init(jax.random.PRNGKey(1), 32, 64, 4)
    tp = _port(jp)
    jx, tx = _x((2, 64, 32), dtype, seed=2)
    with torch.no_grad():
        out = tmoe.moe_ffn_sorted(tp, tx, top_k=2, capacity_factor=0.5)
    assert bool(torch.isfinite(out).all())
    with torch.no_grad():
        r = tmoe.sorted_route(tp, tx, top_k=2, capacity_factor=0.5)
    assert bool((r.dst == 4 * r.cap).any())          # pairs were dropped
    want = _np(jmoe.moe_ffn_sorted(jp, jx, top_k=2, capacity_factor=0.5))
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), want, atol=1e-5, rtol=0)
    else:
        gap = np.abs(want - _np(jmoe.moe_ffn(jp, jx, top_k=2,
                                             capacity_factor=8.0)))
        assert np.abs(_np(out) - want).max() <= max(_bf16_ulp(want),
                                                    gap.max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_uses_einsum_path(dtype, monkeypatch):
    """Single-token dispatch routes through the one-hot route (the sorted
    route is never called at S = 1) and equals it and JAX's."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 32, 64, 4)
    tp = _port(jp)
    jd, td = DTYPES[dtype]
    jx = jnp.ones((8, 1, 32), jd) * 0.1
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(td)

    def no_sorted(*a, **kw):
        raise AssertionError("the sorted route at S = 1")

    monkeypatch.setattr(tmoe, "moe_ffn_sorted", no_sorted)
    with torch.no_grad():
        out = tmoe.dispatch(tp, tx, top_k=2)
        ref = tmoe.moe_ffn(tp, tx, top_k=2)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6)
    want = _np(jmoe.dispatch(jp, jx, top_k=2))
    bar = 1e-5 if dtype == "float32" else _bf16_ulp(want)
    assert np.abs(_np(out) - want).max() <= bar


@pytest.mark.parametrize("impl", ["sorted", "einsum"])
def test_dispatch_takes_the_impl_route(impl, monkeypatch):
    """For S > 1 ``dispatch`` takes the route ``IMPL`` names, as the JAX
    ``dispatch`` does."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 32, 64, 4)
    tp = _port(jp)
    jx, tx = _x((2, 16, 32), "float32")
    monkeypatch.setattr(tmoe, "IMPL", impl)
    monkeypatch.setattr(jmoe, "IMPL", impl)
    calls = []
    for name in ("moe_ffn", "moe_ffn_sorted"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, fn=fn, name=name, **kw:
                            calls.append(name) or fn(*a, **kw))
    with torch.no_grad():
        out = tmoe.dispatch(tp, tx, top_k=2)
    assert calls == ["moe_ffn_sorted" if impl == "sorted" else "moe_ffn"]
    np.testing.assert_allclose(_np(out), _np(jmoe.dispatch(jp, jx, top_k=2)),
                               atol=1e-5, rtol=0)


def test_top_k_breaks_ties_toward_the_lower_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [2.0, 1.0, 2.0, 1.0, 2.0, 1.0]], np.float32)
    for k in (1, 2, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = tmoe._top_k(torch.as_tensor(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_aux_load_balance_loss_matches_jax(dtype):
    """``tests/test_models_smoke.py::test_moe_load_balance_loss``'s input
    (x of 0.1, >= 1 by Cauchy-Schwarz) and a random one, within 1e-5 of
    JAX's."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 128, 128, 4)
    tp = _port(jp)
    jd, td = DTYPES[dtype]
    for jx in (jnp.ones((2, 8, 128), jd) * 0.1,
               _x((2, 8, 128), dtype, scale=1.0)[0]):
        tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(td)
        with torch.no_grad():
            got = float(tmoe.aux_load_balance_loss(tp, tx, 2))
        want = float(jmoe.aux_load_balance_loss(jp, jx, 2))
        assert np.isfinite(got) and got >= 1.0 - 1e-6
        assert abs(got - want) <= 1e-5 * want


def test_moe_init_has_the_jax_shapes_and_scales():
    """The port's ``moe_init`` from a generator: the JAX shapes and types,
    the router at 0.02, the experts at 1/sqrt(E) (the reference's fan-in,
    ``shape[0]`` of the stacked weights), the shared SwiGLU at
    1/sqrt(fan_in)."""
    shapes = jax.eval_shape(lambda: jmoe.moe_init(
        jax.random.PRNGKey(0), 256, 512, 16, n_shared=2, shared_d_ff=1024))
    m = tmoe.moe_init(torch.Generator().manual_seed(0), 256, 512, 16, 2,
                      1024, "cpu")
    scales = {"router": 0.02, "w_gate": 0.25, "w_up": 0.25, "w_down": 0.25,
              "shared.w_gate": 1 / 16, "shared.w_up": 1 / 16,
              "shared.w_down": 1 / 32}
    names = dict(m.named_parameters())
    assert sorted(names) == sorted(scales)
    for name, p in names.items():
        want = shapes
        for key in name.split("."):
            want = want[key]
        assert tuple(p.shape) == want.shape and str(want.dtype) == "bfloat16"
        assert abs(p.float().std().item() / scales[name] - 1) < 0.03, name
