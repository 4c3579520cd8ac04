"""The port's state-space mixers (``models/ssm.py``) against the JAX
package's on the CPU: Mamba2's full-sequence forward and decode steps with
their states, RWKV6's time mix (output and final wkv state), channel mix,
initial state and decode chain, in f32 and bf16 activations.

The weights are the JAX init's (``PRNGKey(0)``, bf16 weights) copied into
the port's modules, with the constant leaves (mixes, decay bias, bonus,
``a_log``, ``d_skip``, ``dt_bias``) replaced by seeded random values in
both, so each enters the arithmetic.  Bars: the layer bars of
``tests/test_torch_models.py``, 1e-5 (f32) and 1.6e-2 (bf16, one rounding
of the output where the two frameworks round at other places) times
max(max |reference|, 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from test_torch_sim import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
D, HEADS, D_FF, D_STATE = 64, 4, 128, 16


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    assert tuple(got.shape) == want.shape
    bar = ATOL[dtype] * max(np.abs(want).max(), 1.0)
    assert np.abs(_np(got) - want).max() <= bar, np.abs(_np(got) - want).max()


def _pair(jp, module, rng, constants):
    """Random values for the ``constants`` leaves of the JAX tree, then the
    whole tree copied into ``module`` (the port's parameters)."""
    jp = dict(jp)
    for name, (lo, hi) in constants.items():
        jp[name] = jnp.asarray(rng.uniform(lo, hi, jp[name].shape),
                               jp[name].dtype)
    with torch.no_grad():
        for name, p in module.named_parameters():
            assert tuple(p.shape) == jp[name].shape
            assert str(p.dtype).split(".")[1] == str(jp[name].dtype)
            p.copy_(torch.tensor(np.asarray(jp[name].astype(jnp.float32))))
    return jp


def _x(rng, shape, dtype, scale=1.0):
    jd, td = DTYPES[dtype]
    j = jnp.asarray(rng.normal(size=shape) * scale, jd)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(td)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
MAMBA_CONSTANTS = {"a_log": (-1.0, 0.5), "d_skip": (0.5, 1.5),
                   "dt_bias": (-1.0, 1.0)}


def _mamba(seed=0):
    rng = np.random.default_rng(seed)
    tp = tssm.Mamba(None, D, HEADS, D_STATE, device="cpu")
    jp = _pair(jssm.mamba_init(jax.random.PRNGKey(0), D, HEADS, D_STATE), tp,
               rng, MAMBA_CONSTANTS)
    assert tp.dims == jp["_shape"].shape
    return jp, tp, rng


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_forward_matches_jax(dtype):
    jp, tp, rng = _mamba()
    jx, tx = _x(rng, (2, 24, D), dtype)
    with torch.no_grad():
        got = tssm.mamba_forward(tp, tx)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jssm.mamba_forward(jp, jx), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_decode_steps_match_jax(dtype):
    """Twelve decode steps from ``mamba_init_state``: each output and the
    final state (f32 ``h``, bf16 conv tail) against JAX's; the port's own
    decode chain against its full-sequence forward.  The conv tail is
    bf16, so a step convolves and gates in bf16 whatever the input's type:
    the bf16 bar holds the outputs and ``h``."""
    jp, tp, rng = _mamba(1)
    jx, tx = _x(rng, (2, 12, D), dtype)
    js = jssm.mamba_init_state(jp, 2)
    ts = tssm.mamba_init_state(tp, 2)
    for a, b in zip(ts, js):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)
    outs = []
    for t in range(12):
        jo, js = jssm.mamba_decode_step(jp, jx[:, t:t + 1], js)
        with torch.no_grad():
            to, ts = tssm.mamba_decode_step(tp, tx[:, t:t + 1], ts)
        assert to.dtype == DTYPES[dtype][1]
        _close(to, jo, "bfloat16")
        outs.append(to)
    _close(ts.h, js.h, "bfloat16")
    _close(ts.conv, js.conv, "bfloat16")
    with torch.no_grad():
        full = tssm.mamba_forward(tp, tx)
    _close(torch.cat(outs, 1), full, "bfloat16")


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
RWKV_CONSTANTS = {"mix_r": (0.1, 0.9), "mix_k": (0.1, 0.9),
                  "mix_v": (0.1, 0.9), "mix_w": (0.1, 0.9),
                  "mix_g": (0.1, 0.9), "decay_bias": (-7.0, -1.0),
                  "bonus": (-0.5, 0.5), "ln_x": (0.5, 1.5),
                  "cm_mix_k": (0.1, 0.9)}


def _rwkv(seed=0):
    rng = np.random.default_rng(seed)
    tp = tssm.RWKV(None, D, HEADS, D_FF, device="cpu")
    jp = _pair(jssm.rwkv_init(jax.random.PRNGKey(0), D, HEADS, D_FF), tp,
               rng, RWKV_CONSTANTS)
    assert tp.dims == jp["_shape"].shape
    return jp, tp, rng


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_time_mix_matches_jax(dtype):
    """Output and final wkv state from a random shift and state."""
    jp, tp, rng = _rwkv()
    jx, tx = _x(rng, (2, 20, D), dtype)
    jprev, tprev = _x(rng, (2, D), dtype)
    s0 = rng.normal(size=(2, HEADS, D // HEADS, D // HEADS)).astype(
        np.float32)
    jy, js = jssm.rwkv_time_mix(jp, jx, jprev, jnp.asarray(s0))
    with torch.no_grad():
        ty, ts = tssm.rwkv_time_mix(tp, tx, tprev, torch.as_tensor(s0))
    assert ty.dtype == DTYPES[dtype][1] and ts.dtype == torch.float32
    _close(ty, jy, dtype)
    _close(ts, js, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_channel_mix_matches_jax(dtype):
    jp, tp, rng = _rwkv(1)
    jx, tx = _x(rng, (2, 20, D), dtype)
    jprev, tprev = _x(rng, (2, D), dtype)
    with torch.no_grad():
        got = tssm.rwkv_channel_mix(tp, tx, tprev)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jssm.rwkv_channel_mix(jp, jx, jprev), dtype)


def test_rwkv_init_state_is_the_jax_state():
    jp, tp, _ = _rwkv()
    js = jssm.rwkv_init_state(jp, 3, D)
    ts = tssm.rwkv_init_state(tp, 3, D)
    assert ts._fields == js._fields
    for a, b in zip(ts, js):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert not bool(a.any())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_decode_chain_matches_jax(dtype):
    """One token at a time through both mixes, the state and shifts
    carried as ``lm.decode_step`` carries them (the shifts stored in
    bf16): each output against JAX's chain, and the port's chain against
    its full-sequence mixes from the same zero state."""
    jp, tp, rng = _rwkv(2)
    jx, tx = _x(rng, (2, 10, D), dtype)
    js = jssm.rwkv_init_state(jp, 2, D)
    ts = tssm.rwkv_init_state(tp, 2, D)
    outs = []
    for t in range(10):
        jxt, txt = jx[:, t:t + 1], tx[:, t:t + 1]
        jy, s_new = jssm.rwkv_time_mix(jp, jxt, js.x_tm.astype(jxt.dtype),
                                       js.s)
        jc = jssm.rwkv_channel_mix(jp, jy, js.x_cm.astype(jxt.dtype))
        js = jssm.RWKVState(s=s_new, x_tm=jxt[:, 0].astype(jnp.bfloat16),
                            x_cm=jy[:, 0].astype(jnp.bfloat16))
        with torch.no_grad():
            ty, t_new = tssm.rwkv_time_mix(tp, txt, ts.x_tm.to(txt.dtype),
                                           ts.s)
            tc = tssm.rwkv_channel_mix(tp, ty, ts.x_cm.to(txt.dtype))
        ts = tssm.RWKVState(s=t_new, x_tm=txt[:, 0].to(torch.bfloat16),
                            x_cm=ty[:, 0].to(torch.bfloat16))
        _close(ty, jy, dtype)
        _close(tc, jc, dtype)
        outs.append(ty)
    _close(ts.s, js.s, dtype)
    # the shifts are kept in bf16, so the chain rounds its inputs there
    zero = torch.zeros((2, D), dtype=tx.dtype)
    with torch.no_grad():
        full, s_full = tssm.rwkv_time_mix(
            tp, tx, zero, torch.zeros(2, HEADS, D // HEADS, D // HEADS))
    _close(torch.cat(outs, 1), full, "bfloat16")
    _close(ts.s, s_full, "bfloat16")


def test_rwkv_init_has_the_jax_shapes_types_and_constants():
    """The port's ``rwkv_init`` from a generator: the JAX leaves (but the
    ``_shape`` leaf, which is ``RWKV.dims``), shapes, types, constants
    and scales."""
    shapes = jax.eval_shape(lambda: jssm.rwkv_init(jax.random.PRNGKey(0),
                                                   256, 8, 512))
    m = tssm.rwkv_init(torch.Generator().manual_seed(0), 256, 8, 512, "cpu")
    names = dict(m.named_parameters())
    assert sorted(names) == sorted(k for k in shapes if k != "_shape")
    assert m.dims == shapes["_shape"].shape
    const = {"decay_bias": -6.0, "bonus": 0.0, "ln_x": 1.0}
    for name, p in names.items():
        assert tuple(p.shape) == shapes[name].shape, name
        assert str(p.dtype).split(".")[1] == str(shapes[name].dtype), name
        if "mix" in name:
            assert bool((p == 0.5).all()), name
        elif name in const:
            assert bool((p == const[name]).all()), name
        else:
            scale = {"w_decay": 0.01, "cm_wv": 512 ** -0.5}.get(name,
                                                                256 ** -0.5)
            assert abs(p.float().std().item() / scale - 1) < 0.03, name
