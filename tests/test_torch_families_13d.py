"""The port's hybrid, encdec and vlm families (zamba2-2.7b, whisper-base,
paligemma-3b at ``.reduced()``) against the JAX package on the CPU: the
counterparts of ``tests/test_models_smoke.py``'s forward-and-decode and
train-grad smoke tests with parity, eight decode steps (whisper's after
``prime_encdec``), the converted parameter tree and the port's init against
``jax.eval_shape(init_params)``, the leaf order, the serve engine and the
serve launcher; for zamba2 also several groups of layers, a depth that
``attn_every`` does not divide and a decode past the window's ring.

Inputs.  Tokens and the stubbed frontends' embeddings
(``convert.lm_numpy_embeds``, bf16 in both packages) from numpy seeds, one
seeded numpy parameter tree for both.

Bars.  Logits: the model-level bar of ``tests/test_torch_models.py``
(``LOGIT_RTOL`` x max |logit|), argmax the reference's or a near tie (the
helper of ``tests/test_torch_families.py``).  Loss and gradients:
``LOSS_RTOL`` and ``GRAD_RTOL`` of ``tests/test_torch_train.py``.  The
JAX package's own routes agree here within 0.0073 (whisper, dense against
chunked), 0.0048 (zamba2) and 0.0101 (paligemma, flash against plain) x
max |logit|; the port within 0.0095 (both measured on the CPU at these
sizes).
"""
import ast
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import (_layout, lm_numpy_embeds,
                                 lm_numpy_from_params, lm_numpy_params,
                                 lm_params_from_numpy, lm_tree_from_params)
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.optim import init_opt_state
from repro_torch.train import (make_prefill_step, make_serve_step,
                               make_train_step)
from test_torch_families import _leaves, _logits_close
from test_torch_golden import GOLDEN_DIR, _chip_smoke
from test_torch_models import LOGIT_RTOL
from test_torch_sim import _jax_params, torch_one_thread  # noqa: F401
from test_torch_train import GRAD_RTOL, LOSS_RTOL, _paths

FAMILIES = sorted(a for a in ARCHS
                  if ARCHS[a].family in ("hybrid", "encdec", "vlm"))
GOLDENS = {"zamba2-2.7b": "zamba2_2_7b_w2_serve.json",
           "whisper-base": "whisper_base_serve.json",
           "paligemma-3b": "paligemma_3b_w1_serve.json"}
# B=2, and S where the vlm's 8 patch positions keep the Pallas kernel's
# shapes (at most 128 positions, or a multiple of 128)
B, S, S_PREFILL = 2, 16, {"vlm": 120}

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _pair(jcfg, tcfg, seed=0):
    tree = lm_numpy_params(tcfg, seed=seed)
    return (_jax_params(jcfg, tree), lm_params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, port config, JAX params, port params) of the
    reduced config on one seeded numpy tree."""
    out = {}
    for arch in FAMILIES:
        jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
        out[arch] = (jcfg, tcfg) + _pair(jcfg, tcfg)
    return out


def _batch(cfg, b=B, s=S, seed=0, labels=False):
    """(JAX batch, port batch): seeded tokens (and next-token labels, -1
    at the end) and the frontend embeddings in bf16."""
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    tok = tok.astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.as_tensor(tok)}
    if labels:
        lab = np.concatenate([tok[:, 1:], np.full((b, 1), -1, np.int32)], 1)
        jb["labels"], tb["labels"] = jnp.asarray(lab), torch.as_tensor(lab)
    for k, v in lm_numpy_embeds(cfg, b, seed).items():
        jb[k] = jnp.asarray(v, jnp.bfloat16)
        tb[k] = torch.as_tensor(v).to(torch.bfloat16)
    return jb, tb


def _np(a):
    """A JAX array as f32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tensors(x):
    """The tensors of a (nested) state, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def _states(jcfg, tcfg, jp, tp, jb, tb, b, s_max):
    """Fresh decode states of both packages (whisper's primed)."""
    js = jlm.init_decode_state(jp, jcfg, b, s_max)
    ts = tlm.init_decode_state(tp, tcfg, b, s_max)
    if tcfg.family == "encdec":
        js = jlm.prime_encdec(jp, jcfg, jb["enc_embeds"], js)
        with torch.inference_mode():
            ts = tlm.prime_encdec(tp, tcfg, tb["enc_embeds"], ts)
    return js, ts


def _state_arrays(js, ts):
    """The state tensors of both (caches; Mamba states; cross K/V), the
    JAX caches' stacked lengths and the port's int left out."""
    ja = [a for a in jax.tree.leaves((js.kv, js.extra)) if a.ndim > 1]
    ta = _tensors((ts.kv, ts.extra))
    assert len(ja) == len(ta)
    return list(zip(ta, ja))


def _decode(jcfg, tcfg, jp, tp, jb, tb, steps, s_max, b=B):
    """``steps`` decode steps of both from fresh states on the seeded
    tokens: the per-step logits close, positions equal; returns the final
    states."""
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (b, steps))
    js, ts = _states(jcfg, tcfg, jp, tp, jb, tb, b, s_max)
    for a, w in _state_arrays(js, ts):
        assert tuple(a.shape) == w.shape
        assert str(a.dtype).split(".")[1] == str(w.dtype)
    jstep = jax.jit(lambda p, s, t: jlm.decode_step(p, jcfg, s, t))
    tstep = make_serve_step(tcfg)
    for t in range(steps):
        jl, js = jstep(jp, js, jnp.asarray(tok[:, t:t + 1], jnp.int32))
        tl, ts = tstep(tp, ts, torch.as_tensor(tok[:, t:t + 1]))
        assert tl.shape == (b, 1, tcfg.vocab)
        _logits_close(tl[:, 0], np.asarray(jl)[:, 0])
        assert ts.pos == int(js.pos)
    return js, ts


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_and_decode(arch, models):
    """``test_models_smoke.py::test_smoke_forward_and_decode``: forward,
    loss and one decode step (whisper's after ``prime_encdec``) at B=2,
    S=16 with finite outputs of the JAX shapes; the logits of every
    position against JAX's (its flash route)."""
    jcfg, tcfg, jp, tp = models[arch]
    jb, tb = _batch(tcfg, labels=True)
    with torch.inference_mode():
        logits = tlm.forward(tp, tcfg, tb, use_flash=True)
        loss = tlm.loss_fn(tp, tcfg, tb)
        _, state = _states(jcfg, tcfg, jp, tp, jb, tb, B, 32)
        lg, state2 = tlm.decode_step(tp, tcfg, state, tb["tokens"][:, :1])
    assert logits.shape == (B, S, tcfg.vocab)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert lg.shape == (B, 1, tcfg.vocab) and bool(torch.isfinite(lg).all())
    assert state2.pos == 1
    want = np.asarray(jlm.forward(jp, jcfg, jb, use_flash=True))
    for pos in range(S):
        _logits_close(logits[:, pos], want[:, pos])
    jloss = float(jlm.loss_fn(jp, jcfg, jb))
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_jax(arch, models):
    """Last-token logits of both prefill routes at B=2 (S=256; the vlm 120
    tokens after its 8 patch positions) against JAX's flash route; the
    full [B, S, V] forward against ``last_only``."""
    jcfg, tcfg, jp, tp = models[arch]
    jb, tb = _batch(tcfg, s=S_PREFILL.get(tcfg.family, 256), seed=2)
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(
        p, jcfg, b, use_flash=True, last_only=True))(jp, jb))[:, 0]
    got = {f: make_prefill_step(tcfg, use_flash=f)(tp, tb)
           for f in (True, False)}
    for lg in got.values():
        assert lg.shape == (B, 1, tcfg.vocab)
        _logits_close(lg[:, 0], want)
    with torch.inference_mode():
        full = tlm.forward(tp, tcfg, tb, use_flash=True)
    torch.testing.assert_close(full[:, -1:], got[True], rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_jax(arch, models):
    """Eight ``decode_step``s from an empty state (whisper's primed with
    ``prime_encdec``; ``make_serve_step``): logits within the bar each
    step, positions equal, and the states (KV caches; Mamba states; the
    cross K/V) close to JAX's, with its shapes and types."""
    jcfg, tcfg, jp, tp = models[arch]
    jb, tb = _batch(tcfg)
    js, ts = _decode(jcfg, tcfg, jp, tp, jb, tb, 8, 16)
    for a, w in _state_arrays(js, ts):
        want = _np(w)
        assert np.abs(a.float().numpy() - want).max() <= \
            LOGIT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_grad(arch, models):
    """``test_models_smoke.py::test_smoke_train_grad`` with parity:
    ``loss_fn(remat=True)`` and its gradients at B=2, S=128 against the
    JAX ``value_and_grad``, all finite and not all zero, within
    ``LOSS_RTOL`` and ``GRAD_RTOL``; every gradient has its parameter's
    type; JAX's ``_shape`` leaves get zero gradients."""
    jcfg, tcfg, jp, tp = models[arch]
    jb, tb = _batch(tcfg, s=128, labels=True)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, jb, remat=True)))(jp)
    jg = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jg)
    leaves = tlm.named_leaves(tp)
    loss = tlm.loss_fn(tp, tcfg, tb, remat=True)
    grads = dict(zip([n for n, _ in leaves], torch.autograd.grad(
        loss, [p for _, p in leaves])))
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert all(g.dtype == p.dtype for (_, p), g in
               zip(leaves, grads.values()))
    assert sum(float(g.float().abs().sum()) for g in grads.values()) > 0
    layout = _layout(tcfg)
    for path, want in _paths(jg):
        if path.endswith("/_shape"):
            assert not want.any()
            continue
        got = _stacked(tcfg, path, lambda n: grads[n])
        assert got.shape == layout[path][0]
        gap = float(np.abs(got - want).max() / max(np.abs(want).max(),
                                                   1e-30))
        assert gap <= GRAD_RTOL, (path, gap)


def _stacked(cfg, path, get):
    """The leaf ``path`` of the JAX layout from the port's values
    ``get(name)``, stacked over layers where the JAX tree stacks it."""
    head, rest = path.split("/", 1)
    if head in tlm.STACKED:
        return np.stack([get(f"{head}.{i}.{rest.replace('/', '.')}")
                         .float().detach().numpy()
                         for i in range(tlm.STACKED[head](cfg))])
    return get(path.replace("/", ".")).float().detach().numpy()


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_tree_has_the_jax_layout(arch):
    """The numpy tree has the shapes of ``jax.eval_shape(init_params)``
    (the ``_shape`` leaves zero-filled), its values are exact in their
    leaf's type, the port's module holds them with the JAX types, and
    ``lm_tree_from_params`` / ``lm_numpy_from_params`` give the tree
    back."""
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
        ps = [model.get_parameter(n) for n in _names(tcfg, path)]
        assert all(p.dtype == dt[want.dtype] and p.requires_grad
                   for p in ps), path
        np.testing.assert_array_equal(
            _stacked(tcfg, path, model.get_parameter), a)


def _names(cfg, path):
    head, rest = path.split("/", 1)
    if head in tlm.STACKED:
        return [f"{head}.{i}.{rest.replace('/', '.')}"
                for i in range(tlm.STACKED[head](cfg))]
    return [path.replace("/", ".")]


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_init_has_the_jax_shapes_types_and_scales(arch):
    """``init_params`` with a seeded generator at 1 layer (whisper: 1
    encoder layer) and a small vocab, full width otherwise: the JAX shapes
    and types, the layout's scales and constants, the same weights from
    the same seed."""
    cut = dict(n_layers=1, vocab=4096)
    if ARCHS[arch].family == "encdec":
        cut["enc_layers"] = 1
    if ARCHS[arch].family == "vlm":
        cut["d_ff"] = 4096
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
        ps = [model.get_parameter(n) for n in _names(tcfg, path)]
        t = torch.as_tensor(_stacked(tcfg, path, model.get_parameter))
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
def test_named_leaves_follow_the_jax_leaf_order(arch, models):
    """``named_leaves`` gives the parameters in the order of
    ``jax.tree.leaves`` of the JAX tree (without the ``_shape`` leaves),
    each stacked leaf's layers in turn; ``jax_path`` names their paths
    (``encoder.3.attn.wq`` -> ``encoder/attn/wq``, 3;
    ``shared_attn.attn.wq`` -> ``shared_attn/attn/wq``, -1)."""
    jcfg, tcfg, jp, tp = models[arch]
    paths = [jax.tree_util.keystr(k, simple=True, separator="/")
             for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    want = []
    for path in paths:
        if not path.endswith("/_shape"):
            want += [(path, i) for i in range(len(_names(tcfg, path)))]
    got = [tlm.jax_path(n) for n, _ in tlm.named_leaves(tp)]
    assert [(p, max(i, 0)) for p, i in got] == want
    assert tlm.jax_path("encoder.3.attn.wq") == ("encoder/attn/wq", 3)
    assert tlm.jax_path("shared_attn.attn.wq") == ("shared_attn/attn/wq",
                                                   -1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_engine_stats_are_the_jax_stats(arch, models):
    """``ServeEngine`` with the ``HydraKVScheduler`` on the launcher's
    requests (chip_smoke.py's ``run_engine``; whisper unprimed, as the JAX
    engine runs it): the stats equal the JAX engine's on this reduced arch,
    recorded in the family's golden file."""
    _, tcfg, _, tp = models[arch]
    with open(os.path.join(GOLDEN_DIR, GOLDENS[arch])) as f:
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


@pytest.mark.parametrize("n_layers", [4, 5])
def test_hybrid_groups_match_jax(n_layers):
    """zamba2-2.7b reduced with ``attn_every`` = 2 at 4 layers (two groups)
    and 5 (two groups; the JAX package's slicing drops the fifth layer):
    the forward's logits at every position and eight decode steps against
    JAX's."""
    jcfg = dataclasses.replace(jget_arch("zamba2-2.7b").reduced(),
                               n_layers=n_layers)
    tcfg = dataclasses.replace(get_arch("zamba2-2.7b").reduced(),
                               n_layers=n_layers)
    assert len(tlm._groups(tcfg)) == 2
    jp, tp = _pair(jcfg, tcfg, seed=3)
    jb, tb = _batch(tcfg, seed=3)
    want = np.asarray(jlm.forward(jp, jcfg, jb))
    with torch.inference_mode():
        got = tlm.forward(tp, tcfg, tb)
    for pos in range(S):
        _logits_close(got[:, pos], want[:, pos])
    _decode(jcfg, tcfg, jp, tp, jb, tb, 8, 16)


def test_hybrid_decode_wraps_the_window_ring():
    """zamba2-2.7b reduced (window 32): 40 decode steps with s_max = 64
    keep a ring of 32 slots per group, and the logits stay the JAX
    package's past the wrap; the caches after the last step equal JAX's
    within the bar."""
    jcfg = jget_arch("zamba2-2.7b").reduced()
    tcfg = get_arch("zamba2-2.7b").reduced()
    jp, tp = _pair(jcfg, tcfg, seed=4)
    jb, tb = _batch(tcfg, b=1, seed=4)
    js, ts = _decode(jcfg, tcfg, jp, tp, jb, tb, 40, 64, b=1)
    assert ts.extra.k.shape[2] == tcfg.window == 32
    for a, w in _state_arrays(js, ts):
        want = _np(w)
        assert np.abs(a.float().numpy() - want).max() <= \
            LOGIT_RTOL * np.abs(want).max()


def test_encode_and_prime_match_jax(models):
    """whisper-base reduced: ``encode`` and the cross K/V of
    ``prime_encdec`` (bf16) against JAX's, within the bar of their
    largest value."""
    jcfg, tcfg, jp, tp = models["whisper-base"]
    jb, tb = _batch(tcfg)
    want = _np(jlm.encode(jp, jcfg, jb["enc_embeds"]))
    with torch.inference_mode():
        got = tlm.encode(tp, tcfg, tb["enc_embeds"]).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
    js, ts = _states(jcfg, tcfg, jp, tp, jb, tb, B, 8)
    for a, w in zip(ts.extra, js.extra):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == w.shape
        want = _np(w)
        assert np.abs(a.float().numpy() - want).max() <= \
            LOGIT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_and_opt_state_carry_the_family(arch, models):
    """One ``make_train_step`` step on the reduced arch (whisper's and the
    vlm's embeddings in bf16 in the batch): finite metrics, the weights
    moved; its optimizer state in the JAX layout has the shapes and types
    of the JAX ``init_opt_state`` of the JAX tree and carries back
    exactly."""
    jcfg, tcfg, jp, _ = models[arch]
    tp = lm_params_from_numpy(lm_numpy_params(tcfg, seed=5), tcfg, "cpu")
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    _, tb = _batch(tcfg, s=32, labels=True)
    step = make_train_step(tcfg, lr_warmup=1, device="cpu")
    opt = init_opt_state(tp)
    _, _, metrics = step(tp, opt, tb)
    _, opt, metrics = step(tp, opt, tb)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(p, before[n]) for n, p in
               tp.named_parameters())
    m, v, st = opt_state_to_numpy(opt, tcfg)
    want = jax.eval_shape(jinit_opt_state, jp)
    for tree, ref in ((m, want.m), (v, want.v)):
        got = dict(_leaves(tree))
        for path, a in _leaves(ref):
            assert got[path].shape == a.shape and a.dtype == jnp.float32
    assert int(st) == 2
    back = opt_state_from_numpy((m, v, st), tcfg, "cpu")
    for name, mom in opt.m.items():
        assert torch.equal(back.m[name], mom)
        assert torch.equal(back.v[name], opt.v[name])


def test_encode_refuses_embeddings_of_another_type(models):
    """f32 frame embeddings raise (the JAX encoder would promote to f32;
    the port's products take one type)."""
    _, tcfg, _, tp = models["whisper-base"]
    _, tb = _batch(tcfg)
    with pytest.raises(ValueError, match="enc_embeds"):
        tlm.encode(tp, tcfg, tb["enc_embeds"].float())
