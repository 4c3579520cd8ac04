"""The port's moe and ssm families (mixtral-8x22b, qwen2-moe-a2.7b,
rwkv6-1.6b at ``.reduced()``) against the JAX package on the CPU: the
counterparts of ``tests/test_models_smoke.py``'s forward-and-decode and
train-grad smoke tests with parity, eight decode steps, the converted
parameter tree and the port's init against ``jax.eval_shape(init_params)``,
the serve engine and the serve launcher.

Bars.  Logits: the model-level bar of ``tests/test_torch_models.py``
(``LOGIT_RTOL`` x max |logit|); the argmax must be the reference's, or a
near tie -- an entry within 2 x the bar of the reference's top, which the
elementwise bar implies (random weights give near ties: the router of the
moe family and the vocab of every family).  Loss: ``LOSS_RTOL`` of
``tests/test_torch_train.py``.  Gradients: ``GRAD_RTOL`` for rwkv6; for the
moe archs each leaf within twice the JAX package's own gap between its
dense and chunked attention routes (``MOE_GRAD_GAP``, measured on the CPU
at B=2, S=128: the router's top-k sends tokens to other experts on
last-bit differences, so the JAX package disagrees with itself by that
much; the test measures the gap again and asserts it).
"""
import ast
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn, lm as jlm
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import (_layout, lm_numpy_from_params,
                                 lm_numpy_params, lm_params_from_numpy,
                                 lm_tree_from_params)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.train import make_prefill_step, make_serve_step
from test_torch_golden import LM_GOLDEN, _chip_smoke
from test_torch_models import LOGIT_RTOL
from test_torch_sim import _jax_params, torch_one_thread  # noqa: F401
from test_torch_train import (GRAD_RTOL, LOSS_RTOL, _batch,
                              _jax_value_and_grad, _paths,
                              _port_value_and_grad)

FAMILIES = sorted(a for a in ARCHS if ARCHS[a].family in ("moe", "ssm"))
MOE_GRAD_GAP = {"mixtral-8x22b": 0.29805, "qwen2-moe-a2.7b": 0.22657}

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, port config, JAX params, port params) of the
    reduced config on one seeded numpy tree."""
    out = {}
    for arch in FAMILIES:
        jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
        tree = lm_numpy_params(tcfg, seed=0)
        out[arch] = (jcfg, tcfg, _jax_params(jcfg, tree),
                     lm_params_from_numpy(tree, tcfg, "cpu"))
    return out


def _logits_close(got, want):
    """[B, V] logits within the model-level bar; argmax the reference's or
    a near tie."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert bool(np.isfinite(got).all())
    mx = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_RTOL * mx, (
        np.abs(got - want).max() / mx)
    for row, a in enumerate(got.argmax(-1)):
        assert want[row, a] >= want[row].max() - 2 * LOGIT_RTOL * mx


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_and_decode(arch, models):
    """``test_models_smoke.py::test_smoke_forward_and_decode``: forward,
    loss and one decode step at B=2, S=16 with finite outputs of the JAX
    shapes; the logits of every position against JAX's (its flash route)."""
    jcfg, tcfg, jp, tp = models[arch]
    b, s = 2, 16
    batch = _batch(jcfg.vocab, b, s)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits = tlm.forward(tp, tcfg, tb, use_flash=True)
        loss = tlm.loss_fn(tp, tcfg, tb)
        state = tlm.init_decode_state(tp, tcfg, b, 32)
        lg, state2 = tlm.decode_step(tp, tcfg, state, tb["tokens"][:, :1])
    assert logits.shape == (b, s, tcfg.vocab) and logits.dtype == \
        torch.float32
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert lg.shape == (b, 1, tcfg.vocab) and bool(torch.isfinite(lg).all())
    assert state2.pos == 1
    want = np.asarray(jlm.forward(jp, jcfg, {"tokens": jnp.asarray(
        batch["tokens"])}, use_flash=True))
    for pos in range(s):
        _logits_close(logits[:, pos], want[:, pos])
    jloss = float(jlm.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_jax(arch, models):
    """Last-token logits of both prefill routes at B=2, S=256 against
    JAX's flash route; the full [B, S, V] forward against ``last_only``."""
    jcfg, tcfg, jp, tp = models[arch]
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 256))
    want = np.asarray(jax.jit(lambda p, t: jlm.forward(
        p, jcfg, {"tokens": t}, use_flash=True, last_only=True))(
            jp, jnp.asarray(tok, jnp.int32)))[:, 0]
    batch = {"tokens": torch.as_tensor(tok)}
    got = {f: make_prefill_step(tcfg, use_flash=f)(tp, batch)
           for f in (True, False)}
    for lg in got.values():
        assert lg.shape == (2, 1, tcfg.vocab)
        _logits_close(lg[:, 0], want)
    with torch.inference_mode():
        full = tlm.forward(tp, tcfg, batch, use_flash=True)
    torch.testing.assert_close(full[:, -1:], got[True], rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_jax(arch, models):
    """Eight ``decode_step``s from an empty state (``make_serve_step``):
    logits within the bar each step, positions equal, and the state (KV
    caches; RWKV wkv states and shifts) close to JAX's."""
    jcfg, tcfg, jp, tp = models[arch]
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 8))
    js = jlm.init_decode_state(jp, jcfg, 2, 16)
    ts = tlm.init_decode_state(tp, tcfg, 2, 16)
    def arrays(jstate, tstate):
        """The state's tensors (KV caches; RWKV states and shifts) of both,
        the JAX caches' stacked lengths and the port's int left out."""
        ja = [a for a in jax.tree.leaves(jstate.kv) if a.ndim > 1]
        ta = [a for a in tstate.kv if isinstance(a, torch.Tensor)]
        assert len(ja) == len(ta)
        return zip(ta, ja)

    for a, b in arrays(js, ts):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)
    jstep = jax.jit(lambda p, s, t: jlm.decode_step(p, jcfg, s, t))
    tstep = make_serve_step(tcfg)
    for t in range(8):
        jl, js = jstep(jp, js, jnp.asarray(tok[:, t:t + 1], jnp.int32))
        tl, ts = tstep(tp, ts, torch.as_tensor(tok[:, t:t + 1]))
        assert tl.shape == (2, 1, tcfg.vocab)
        _logits_close(tl[:, 0], np.asarray(jl)[:, 0])
        assert ts.pos == int(js.pos)
    for a, b in arrays(js, ts):
        want = np.asarray(b.astype(jnp.float32))
        assert np.abs(a.float().numpy() - want).max() <= \
            LOGIT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_grad(arch, models, monkeypatch):
    """``test_models_smoke.py::test_smoke_train_grad`` with parity:
    ``loss_fn(remat=True)`` and its gradients at B=2, S=128 against the
    JAX ``value_and_grad``, all finite and not all zero; every gradient
    has its parameter's type; JAX's ``_shape`` leaves get zero
    gradients."""
    jcfg, tcfg, jp, tp = models[arch]
    batch = _batch(jcfg.vocab)
    jl, jg = _jax_value_and_grad(jcfg, jp, batch, remat=True)
    tl, tg = _port_value_and_grad(tcfg, tp, batch, remat=True)
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    assert all(bool(torch.isfinite(g).all()) for g in tg.values())
    assert all(g.dtype == p.dtype for (_, p), g in
               zip(tlm.named_leaves(tp), tg.values()))
    assert sum(float(g.float().abs().sum()) for g in tg.values()) > 0
    if tcfg.family == "moe":
        with monkeypatch.context() as m:
            m.setattr(jattn, "CHUNKED_SEQ", 128)
            _, jg_chunked = _jax_value_and_grad(jcfg, jp, batch, remat=True)
        a, b = dict(_paths(jg)), dict(_paths(jg_chunked))
        gap = max(float(np.abs(a[k] - b[k]).max() / np.abs(a[k]).max())
                  for k in a if np.abs(a[k]).max() > 0)
        assert gap <= MOE_GRAD_GAP[arch]
        rtol = 2 * MOE_GRAD_GAP[arch]
    else:
        rtol = GRAD_RTOL
    layout = _layout(tcfg)
    for path, want in _paths(jg):
        if path.endswith("/_shape"):
            assert not want.any()
            continue
        head, rest = path.split("/", 1)
        names = ([f"layers.{i}.{rest.replace('/', '.')}"
                  for i in range(tcfg.n_layers)] if head == "layers"
                 else [path.replace("/", ".")])
        got = np.stack([tg[n].float().numpy() for n in names]) \
            if head == "layers" else tg[names[0]].float().numpy()
        assert got.shape == layout[path][0]
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        assert gap <= rtol, (path, gap)


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_tree_has_the_jax_layout(arch):
    """The numpy tree has the shapes of ``jax.eval_shape(init_params)``
    (the ``_shape`` leaves zero-filled, in their JAX type), its values are
    exact in their leaf's type, the port's module holds them with the JAX
    types, and ``lm_tree_from_params`` / ``lm_numpy_from_params`` give the
    tree back."""
    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    tree = lm_numpy_params(tcfg, seed=1)
    shapes = dict(_leaves(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))))
    got = dict(_leaves(tree))
    assert sorted(got) == sorted(shapes)
    model = lm_params_from_numpy(tree, tcfg, "cpu")
    back = dict(_leaves(lm_tree_from_params(model, tcfg)))
    again = dict(_leaves(lm_numpy_from_params(model, tcfg)))
    dt = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
    for path, want in shapes.items():
        a = got[path]
        assert a.shape == want.shape, path
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(a, want.dtype).astype(jnp.float32)), a)
        assert back[path].dtype == dt[want.dtype], path
        np.testing.assert_array_equal(back[path].float().numpy(), a)
        np.testing.assert_array_equal(again[path], a)
        if path.endswith("/_shape"):
            assert not a.any()
            continue
        head, rest = path.split("/", 1)
        ps = ([blk.get_parameter(rest.replace("/", "."))
               for blk in model.layers] if head == "layers"
              else [model.get_parameter(path.replace("/", "."))])
        assert all(p.dtype == dt[want.dtype] and p.requires_grad
                   for p in ps), path
        t = torch.stack([p.float() for p in ps]) if head == "layers" \
            else ps[0].float()
        np.testing.assert_array_equal(t.detach().numpy(), a)


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_init_has_the_jax_shapes_types_and_scales(arch):
    """``init_params`` with a seeded generator at 1 layer and a small
    vocab (the moe archs at d_model = d_ff = 1024 with their published
    heads and experts; rwkv6 at full width): the JAX shapes and types, the
    layout's scales and constants, the same weights from the same seed."""
    cut = dict(n_layers=1, vocab=4096)
    if ARCHS[arch].family == "moe":
        cut.update(d_model=1024, d_ff=1024, expert_d_ff=1024)
    jcfg = dataclasses.replace(jget_arch(arch), **cut)
    tcfg = dataclasses.replace(get_arch(arch), **cut)
    shapes = dict(_leaves(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))))
    model = tlm.init_params(torch.Generator().manual_seed(3), tcfg, "cpu")
    again = tlm.init_params(torch.Generator().manual_seed(3), tcfg, "cpu")
    layout = _layout(tcfg)
    assert sorted(layout) == sorted(shapes)
    for path, want in shapes.items():
        shape, scale = layout[path]
        assert shape == want.shape, path
        if path.endswith("/_shape"):
            continue
        head, rest = path.split("/", 1)
        ps = ([blk.get_parameter(rest.replace("/", "."))
               for blk in model.layers] if head == "layers"
              else [model.get_parameter(path.replace("/", "."))])
        t = torch.stack([p.float() for p in ps]) if head == "layers" \
            else ps[0].float()
        assert tuple(t.shape) == want.shape, path
        assert str(ps[0].dtype).split(".")[1] == str(want.dtype), path
        if scale is None:
            assert bool((t == 1).all()), path
        elif not isinstance(scale, float):
            assert bool((t == scale.value).all()), path
        elif scale == 0.0:
            assert not bool(t.any()), path
        else:
            assert abs(t.std().item() / scale - 1) < 0.03, path
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_engine_stats_are_the_jax_stats(arch, models):
    """``ServeEngine`` with the ``HydraKVScheduler`` on the launcher's
    requests (chip_smoke.py's ``run_engine``): its stats depend on
    scheduling only, so they equal the JAX engine's in the dense golden."""
    _, tcfg, _, tp = models[arch]
    with open(LM_GOLDEN) as f:
        golden = json.load(f)["serve"]
    eng = _chip_smoke().run_engine(tcfg, tp, golden, "cpu")
    assert eng["stats"] == golden["stats"]
    assert eng["stats"]["completed"] == len(golden["requests"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_runs_the_family(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch ... --device cpu``
    serves the reduced arch: every request completes."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--device",
                                      "cpu", "--requests", "6"])
    launch_serve.main()
    out = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["completed"] == 6 and out["scheduler"] is not None


def test_rwkv_decode_matches_forward():
    """``test_models_smoke.py::test_decode_matches_forward`` for rwkv6:
    token-by-token decode logits equal the full forward (teacher forcing)
    within that test's atol=0.1, rtol=0.05."""
    cfg = get_arch("rwkv6-1.6b").reduced()
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 8)))
    with torch.inference_mode():
        full = tlm.forward(params, cfg, {"tokens": toks})
        state = tlm.init_decode_state(params, cfg, 1, 8)
        outs = []
        for t in range(8):
            lg, state = tlm.decode_step(params, cfg, state, toks[:, t:t + 1])
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=0.1, rtol=0.05)
