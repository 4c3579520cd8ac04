"""The port's dense model zoo against the JAX package on the CPU: the
layers, the three attention routes and the attention decode step on seeded
numpy inputs, ``lm.forward`` on both routes and eight ``lm.decode_step``s
on the reduced qwen3-1.7b, the converted parameter tree against
``jax.eval_shape(lm.init_params)``, and the families not ported yet.

The model-level tolerance.  The JAX package disagrees with itself in bf16:
its flash and plain routes differ by up to ``REF_GAP`` x max|logit| (measured
on the CPU: 0.0115131 on qwen3-1.7b at full width with 2 layers, B=2, S=512
-- the ``ref_gap`` of ``src/repro_torch/golden/qwen3_1_7b_w2_serve.json``;
0.008585 on the reduced config at B=2, S=256).  So the port's logits may
differ from JAX's flash route by twice the larger gap, with a floor of
2e-2 x max|logit|, and every row's argmax must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_arch as jget_arch
from repro.models import attention as jattn, layers as jL, lm as jlm
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import (_dense_layout, lm_numpy_params,
                                 lm_params_from_numpy)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as tattn, layers as tL, lm as tlm
from repro_torch.train import make_prefill_step, make_serve_step
from test_torch_sim import LM_ARCH, torch_one_thread  # noqa: F401

REF_GAP = 0.011514
LOGIT_RTOL = max(2 * REF_GAP, 2e-2)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# elementwise bars: f32 agrees to a few ulps; bf16 to one bf16 rounding of
# the output (2^-8 relative) where the two frameworks round at other places
ATOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _pair(a, dtype):
    """The same numpy values as a jnp and a torch array of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(td)


def _close(got, want, dtype, scale=1.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    bar = ATOL[dtype] * max(scale, 1.0)
    assert np.abs(got - want).max() <= bar, np.abs(got - want).max()


def _model_close(got, want):
    """The model-level tolerance on logits [..., V], and equal argmax."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    mx = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_RTOL * mx, (
        np.abs(got - want).max() / mx)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


class _P:
    """A parameter holder for the port's layer functions."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["rmsnorm", "layernorm", "rope", "embed",
                                   "unembed", "swiglu", "gelu_mlp"])
def test_layer_matches_jax(layer, dtype):
    rng = np.random.default_rng(5)
    x, tx = _pair(rng.normal(size=(2, 6, 64)), dtype)
    if layer == "rmsnorm":
        sc = rng.normal(size=64).astype(np.float32)
        _close(tL.rmsnorm(_P(scale=torch.as_tensor(sc)), tx),
               jL.rmsnorm({"scale": jnp.asarray(sc)}, x), dtype, 3)
    elif layer == "layernorm":
        sc, bi = (rng.normal(size=64).astype(np.float32) for _ in range(2))
        _close(tL.layernorm(_P(scale=torch.as_tensor(sc),
                               bias=torch.as_tensor(bi)), tx),
               jL.layernorm({"scale": jnp.asarray(sc),
                             "bias": jnp.asarray(bi)}, x), dtype, 4)
    elif layer == "rope":
        xr, txr = _pair(rng.normal(size=(2, 6, 4, 32)), dtype)
        pos = np.arange(6)[None] + np.array([[0], [100]])
        _close(tL.apply_rope(txr, torch.as_tensor(pos), 1e6),
               jL.apply_rope(xr, jnp.asarray(pos), 1e6), dtype, 3)
    elif layer == "embed":
        tab, ttab = _pair(rng.normal(size=(50, 64)) * 0.02, dtype)
        tok = rng.integers(0, 50, (2, 6))
        _close(tL.embed(_P(table=ttab), torch.as_tensor(tok)),
               jL.embed({"table": tab}, jnp.asarray(tok)), dtype)
    elif layer == "unembed":
        tab, ttab = _pair(rng.normal(size=(50, 64)) * 0.02, dtype)
        got = tL.unembed(_P(table=ttab), tx)
        assert got.dtype == torch.float32
        _close(got, jL.unembed({"table": tab}, x), "float32")
    elif layer == "swiglu":
        ws = [_pair(rng.normal(size=s) / 8, dtype)
              for s in ((64, 96), (64, 96), (96, 64))]
        _close(tL.swiglu(_P(w_gate=ws[0][1], w_up=ws[1][1], w_down=ws[2][1]),
                         tx),
               jL.swiglu({"w_gate": ws[0][0], "w_up": ws[1][0],
                          "w_down": ws[2][0]}, x), dtype, 4)
    else:
        ws = [_pair(rng.normal(size=s) / 8, dtype)
              for s in ((64, 96), (96, 64))]
        bu, bd = (rng.normal(size=n).astype(np.float32) for n in (96, 64))
        _close(tL.gelu_mlp(_P(w_up=ws[0][1], b_up=torch.as_tensor(bu),
                              w_down=ws[1][1], b_down=torch.as_tensor(bd)),
                           tx),
               jL.gelu_mlp({"w_up": ws[0][0], "b_up": jnp.asarray(bu),
                            "w_down": ws[1][0], "b_down": jnp.asarray(bd)},
                           x), dtype, 4)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(rng, dtype, b=2, sq=64, sk=64, h=4, hkv=2, d=32):
    return [_pair(rng.normal(size=s), dtype) for s in
            ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["causal", "window", "batched", "none"])
def test_sdpa_matches_jax(mask, dtype):
    rng = np.random.default_rng(6)
    (q, tq), (k, tk), (v, tv) = _qkv(rng, dtype)
    if mask == "batched":
        m = rng.random((2, 64, 64)) < 0.7
        m[:, :, 0] = True
    elif mask == "none":
        m = np.ones((64, 64), bool)
    else:
        m = np.asarray(jattn.causal_mask(64, 8 if mask == "window" else None))
        np.testing.assert_array_equal(
            tattn.causal_mask(64, 8 if mask == "window" else None).numpy(), m)
    _close(tattn._sdpa(tq, tk, tv, torch.as_tensor(m), 2),
           jattn._sdpa(q, k, v, jnp.asarray(m), 2), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal", "window", "one_chunk",
                                  "non_causal"])
def test_sdpa_chunked_matches_jax(case, dtype):
    rng = np.random.default_rng(7)
    (q, tq), (k, tk), (v, tv) = _qkv(rng, dtype, sq=128, sk=128)
    kw = {"causal": case != "non_causal", "chunk": 32,
          "window": 40 if case == "window" else None}
    if case == "one_chunk":
        kw["chunk"] = 48          # 128 % 48 != 0: one chunk of all keys
    _close(tattn._sdpa_chunked(tq, tk, tv, 2, **kw),
           jattn._sdpa_chunked(q, k, v, 2, **kw), dtype)


def _attn_params(rng, d=64, h=4, hkv=2, hd=32):
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    jp = {n: jnp.asarray(rng.normal(size=s) / np.sqrt(s[0]), jnp.bfloat16)
          for n, s in shapes.items()}
    jp["q_norm"] = jnp.asarray(1 + rng.normal(size=hd) * 0.1, jnp.float32)
    jp["k_norm"] = jnp.asarray(1 + rng.normal(size=hd) * 0.1, jnp.float32)
    tp = _P(**{n: torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16 if n.startswith("w") else torch.float32)
        for n, a in jp.items()})
    return jp, tp


@pytest.mark.parametrize("route", ["flash", "chunked", "dense"])
def test_attention_routes_match_jax(route, monkeypatch):
    """``attention`` takes the JAX package's route (flash kernel, chunked
    from CHUNKED_SEQ tokens on, dense) and agrees with it there."""
    rng = np.random.default_rng(8)
    jp, tp = _attn_params(rng)
    x, tx = _pair(rng.normal(size=(2, 128, 64)), "bfloat16")
    if route == "chunked":           # both packages switch at 64 tokens
        monkeypatch.setattr(jattn, "CHUNKED_SEQ", 64)
        monkeypatch.setattr(tattn, "CHUNKED_SEQ", 64)
    calls = []
    mha = flash_ops.mha
    monkeypatch.setattr(flash_ops, "mha",
                        lambda *a, **kw: calls.append(1) or mha(*a, **kw))
    kw = dict(n_heads=4, n_kv=2, d_head=32, rope_theta=1e6,
              use_flash=route == "flash")
    _close(tattn.attention(tp, tx, **kw), jattn.attention(jp, x, **kw),
           "bfloat16", 2)
    assert len(calls) == (route == "flash")


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_step_matches_jax(window):
    """Ten one-token steps into a 6-slot cache: past the end the slot
    sticks at s_max - 1 without a window and wraps as a ring buffer with
    one."""
    rng = np.random.default_rng(9)
    jp, tp = _attn_params(rng)
    kw = dict(n_heads=4, n_kv=2, d_head=32, window=window, rope_theta=1e6)
    s_max = 6 if window is None else window
    jc = jattn.init_cache(2, s_max, 2, 32)
    tc = tattn.init_cache(2, s_max, 2, 32)
    for _ in range(10):
        x, tx = _pair(rng.normal(size=(2, 1, 64)), "bfloat16")
        jo, jc = jattn.decode_step(jp, x, jc, **kw)
        to, tc = tattn.decode_step(tp, tx, tc, **kw)
        _close(to, jo, "bfloat16", 2)
        assert tc.length == int(jc.length)
        _close(tc.k, jc.k, "bfloat16", 4)
        _close(tc.v, jc.v, "bfloat16", 4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    """The reduced qwen3-1.7b, its numpy tree in both packages."""
    jcfg, tcfg = jget_arch(LM_ARCH).reduced(), get_arch(LM_ARCH).reduced()
    tree = lm_numpy_params(tcfg, seed=0)
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    jp = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    return jcfg, tcfg, jp, lm_params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_prefill(reduced):
    """JAX's last-token logits on both routes at B=2, S=256 (two 128-key
    blocks of the flash kernel)."""
    jcfg, _, jp, _ = reduced
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 256))
    return tok, {f: np.asarray(jax.jit(lambda p, t, f=f: jlm.forward(
        p, jcfg, {"tokens": t}, use_flash=f, last_only=True))(
            jp, jnp.asarray(tok, jnp.int32)))[:, 0] for f in (True, False)}


def test_jax_routes_gap_within_ref_gap(jax_prefill):
    """The constant is the largest gap measured: the JAX package's own
    routes stay inside it on the reduced config."""
    _, lg = jax_prefill
    assert (np.abs(lg[True] - lg[False]).max()
            <= REF_GAP * np.abs(lg[True]).max())


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_matches_jax(reduced, jax_prefill, use_flash):
    """Last-token logits of both routes (the flash kernel's plain version;
    the dense route) against JAX's flash route; the full [B, S, V] logits
    of ``forward`` against ``last_only``."""
    _, tcfg, _, tp = reduced
    tok, lg = jax_prefill
    step = make_prefill_step(tcfg, use_flash=use_flash)
    batch = {"tokens": torch.as_tensor(tok)}
    got = step(tp, batch)
    assert got.shape == (2, 1, tcfg.vocab) and got.dtype == torch.float32
    _model_close(got[:, 0], lg[True])
    with torch.inference_mode():
        full = tlm.forward(tp, tcfg, batch, use_flash=use_flash)
    assert full.shape == (2, 256, tcfg.vocab)
    # the same hidden state; the f32 unembedding of 256 rows and of one
    # may block the product differently
    torch.testing.assert_close(full[:, -1:], got, rtol=0, atol=1e-5)


def test_decode_steps_match_jax(reduced):
    """Eight ``decode_step``s from an empty state (``make_serve_step``):
    logits within the model-level tolerance with equal argmax each step;
    the caches close; positions equal."""
    jcfg, tcfg, jp, tp = reduced
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 8))
    js = jlm.init_decode_state(jp, jcfg, 2, 16)
    ts = tlm.init_decode_state(tp, tcfg, 2, 16)
    assert tuple(ts.kv.k.shape) == js.kv.k.shape
    jstep = jax.jit(lambda p, s, t: jlm.decode_step(p, jcfg, s, t))
    tstep = make_serve_step(tcfg)
    for t in range(8):
        jl, js = jstep(jp, js, jnp.asarray(tok[:, t:t + 1], jnp.int32))
        tl, ts = tstep(tp, ts, torch.as_tensor(tok[:, t:t + 1]))
        assert tl.shape == (2, 1, tcfg.vocab)
        _model_close(tl[:, 0], np.asarray(jl)[:, 0])
        assert ts.pos == int(js.pos) == ts.kv.length
    for name in ("k", "v"):
        got = getattr(ts.kv, name).float().numpy()
        want = np.asarray(getattr(js.kv, name).astype(jnp.float32))
        assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if ARCHS[a].family == "dense"))
def test_converted_tree_has_the_jax_layout(arch):
    """The numpy tree has the shapes of ``jax.eval_shape(init_params)``,
    its values are exact in their leaf's type, and the port's module holds
    them with the JAX types (the stacked axis split over the blocks)."""
    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    tree = lm_numpy_params(tcfg, seed=1)
    shapes = dict(_leaves(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))))
    got = dict(_leaves(tree))
    assert sorted(got) == sorted(shapes)
    model = lm_params_from_numpy(tree, tcfg, "cpu")
    dt = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
    for path, want in shapes.items():
        a = got[path]
        assert a.shape == want.shape, path
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(a, want.dtype).astype(jnp.float32)), a)
        head, rest = path.split("/", 1)
        if head == "layers":
            ps = [b.get_parameter(rest.replace("/", "."))
                  for b in model.layers]
            assert len(ps) == want.shape[0]
            t = torch.stack([p.float() for p in ps])
        else:
            ps = [model.get_parameter(path.replace("/", "."))]
            t = ps[0].float()
        assert all(p.dtype == dt[want.dtype] for p in ps), path
        assert all(p.requires_grad for p in ps), path
        np.testing.assert_array_equal(t.detach().numpy(), a)


def test_port_init_has_the_jax_shapes_types_and_scales():
    """``init_params`` with a seeded ``torch.Generator``: the JAX shapes
    and types, the JAX scales (0.02, 1/sqrt(fan_in), ones), the same
    weights from the same seed."""
    jcfg = dataclasses.replace(jget_arch(LM_ARCH), n_layers=2, vocab=4096)
    tcfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=2, vocab=4096)
    shapes = dict(_leaves(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))))
    model = tlm.init_params(torch.Generator().manual_seed(3), tcfg, "cpu")
    again = tlm.init_params(torch.Generator().manual_seed(3), tcfg, "cpu")
    layout = _dense_layout(tcfg)
    for path, want in shapes.items():
        head, rest = path.split("/", 1)
        ps = ([b.get_parameter(rest.replace("/", ".")) for b in model.layers]
              if head == "layers" else
              [model.get_parameter(path.replace("/", "."))])
        t = torch.stack([p.float() for p in ps]) if head == "layers" \
            else ps[0].float()
        assert tuple(t.shape) == want.shape, path
        assert str(ps[0].dtype).split(".")[1] == str(want.dtype), path
        scale = layout[path][1]
        if scale is None:
            assert bool((t == 1).all()), path
        else:
            assert abs(t.std().item() / scale - 1) < 0.02, path
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_init_refuses_a_generator_on_another_device():
    with pytest.raises(ValueError, match="generator"):
        tlm.init_params(torch.Generator(), get_arch(LM_ARCH).reduced(),
                        "meta")


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if ARCHS[a].family != "dense"))
def test_other_families_raise(arch):
    """The non-dense families: all are ported (moe and ssm, ROADMAP.md
    Queue 1 item 13c; hybrid, encdec and vlm, item 13d), and every model
    entry point runs at ``.reduced()`` on the CPU with finite outputs of
    the JAX shapes, where it raised ``NotImplementedError`` before (their
    parity is tests/test_torch_families.py and
    tests/test_torch_families_13d.py)."""
    cfg = get_arch(arch).reduced()
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tree = lm_numpy_params(cfg)
    assert all(np.isfinite(a).all() for _, a in _leaves(tree))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 8)))}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.as_tensor(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(2, cfg.prefix_len, cfg.d_model)) * 0.02).to(torch.bfloat16)
    tok = batch["tokens"]
    with torch.inference_mode():
        h = tlm.hidden(params, cfg, batch)
        state = tlm.init_decode_state(params, cfg, 2, 8)
        if cfg.family == "encdec":
            state = tlm.prime_encdec(params, cfg, batch["enc_embeds"], state)
        lg, state = tlm.decode_step(params, cfg, state, tok[:, :1])
    assert h.shape == (2, 8, cfg.d_model) and bool(h.isfinite().all())
    assert lg.shape == (2, 1, cfg.vocab) and bool(lg.isfinite().all())
    assert state.pos == 1


def test_configs_are_the_jax_configs():
    """The port's copy of ``configs`` holds the same ten archs, shapes and
    reduced configs (data only)."""
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JARCHS[name])
        assert dataclasses.asdict(ARCHS[name].reduced()) == \
            dataclasses.asdict(JARCHS[name].reduced())
        assert ARCHS[name].param_count() == JARCHS[name].param_count()
