"""The port's training path against the JAX package on the CPU: the loss and
its gradients on every dense arch at ``.reduced()`` (the counterpart of
``tests/test_models_smoke.py::test_smoke_train_grad``), the chunked
cross-entropy's edge cases, the chunked attention route's gradients,
remat, the clip, the schedule, the AdamW update, one train step, the data
pipeline and the flash route under autograd.

The training tolerance.  The JAX package disagrees with itself in bf16:
its dense and chunked attention routes (``CHUNKED_SEQ`` lowered in its
attention module) give losses that differ by up to ``LOSS_GAP`` relative
and gradients whose largest leaf gap, max |dgrad| / max |grad| over a
leaf, is ``GRAD_GAP`` (measured on the CPU at B=2, S=128 on the reduced
dense archs: loss 4.20e-5 on qwen3-1.7b and qwen3-14b, 1.31e-5 on
command-r-35b, 4.9e-6 on yi-9b; gradients 0.020089 on qwen3-1.7b and
qwen3-14b, 0.0195 on command-r-35b, 0.025635 on yi-9b; and 4.8e-6 and
0.016422 on qwen3-1.7b at full width with 2 layers, B=1, S=256 -- the
``ref_gap`` of ``src/repro_torch/golden/qwen3_1_7b_w2_train.json``).  So
the port's loss may differ from JAX's by twice the loss gap with a floor
of 1e-3 relative, and each gradient leaf by twice the gradient gap with a
floor of 2e-2 x max |grad| of the leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import DataPipeline as JPipeline
from repro.models import attention as jattn, lm as jlm
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import (_dense_layout, lm_numpy_from_params,
                                 lm_numpy_params, lm_params_from_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data import DataPipeline
from repro_torch.models import attention as tattn, lm as tlm
from repro_torch.optim import (OptState, adamw_update, clip_by_global_norm,
                               init_opt_state, lr_schedule)
from repro_torch.train import make_train_step
from test_torch_sim import LM_ARCH, _jax_params, torch_one_thread  # noqa: F401

LOSS_GAP = 4.20e-5
GRAD_GAP = 0.025635
LOSS_RTOL = max(2 * LOSS_GAP, 1e-3)
GRAD_RTOL = max(2 * GRAD_GAP, 2e-2)
DENSE = sorted(a for a in ARCHS if ARCHS[a].family == "dense")
B, S = 2, 128

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _batch(vocab, b=B, s=S, seed=0, masked=0.0):
    """Seeded tokens and next-token labels (-1 at the end, and at a
    ``masked`` share of random positions) as numpy int32."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    lab[rng.random((b, s)) < masked] = -1
    return {"tokens": tok, "labels": lab}


def _models(arch, seed=0):
    """(JAX config, port config, JAX params, port params) of ``arch``'s
    reduced config on one seeded numpy tree."""
    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    tree = lm_numpy_params(tcfg, seed=seed)
    return jcfg, tcfg, _jax_params(jcfg, tree), lm_params_from_numpy(
        tree, tcfg, "cpu")


def _jax_value_and_grad(jcfg, jp, batch, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, jb, **kw)))(jp)
    return float(loss), jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), grads)


def _port_value_and_grad(tcfg, tp, batch, **kw):
    leaves = tlm.named_leaves(tp)
    loss = tlm.loss_fn(tp, tcfg, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), {n: g for (n, _), g in zip(leaves, grads)}


def _stacked(flat, cfg):
    """A tree keyed by the port's parameter names as f32 numpy leaves of
    the JAX layout, keyed by path."""
    out = {}
    for path in _dense_layout(cfg):
        head, rest = path.split("/", 1)
        if head == "layers":
            out[path] = np.stack([flat[f"layers.{i}.{rest.replace('/', '.')}"]
                                  .float().numpy()
                                  for i in range(cfg.n_layers)])
        else:
            out[path] = flat[path.replace("/", ".")].float().numpy()
    return out


def _paths(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _grads_close(got, want, rtol=GRAD_RTOL):
    """Each leaf of ``got`` (path -> array) within ``rtol`` x max |leaf|
    of ``want`` (a JAX tree); the largest gap."""
    want = dict(_paths(want))
    assert sorted(got) == sorted(want)
    worst = 0.0
    for path, w in want.items():
        gap = float(np.abs(got[path] - w).max() / np.abs(w).max())
        assert gap <= rtol, (path, gap)
        worst = max(worst, gap)
    return worst


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (2^-7 of the power of two below it; the
    smallest normal's ulp at zero)."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.maximum(a, 2.0 ** -126)))
    return 2.0 ** (e - 7)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` under ``remat`` and its gradients on every dense arch
    against the JAX ``value_and_grad``: the loss within ``LOSS_RTOL``, each
    leaf within ``GRAD_RTOL`` x max |grad|, all finite and not all zero."""
    jcfg, tcfg, jp, tp = _models(arch)
    batch = _batch(jcfg.vocab)
    jl, jg = _jax_value_and_grad(jcfg, jp, batch, remat=True)
    tl, tg = _port_value_and_grad(tcfg, tp, batch, remat=True)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    assert all(bool(torch.isfinite(g).all()) for g in tg.values())
    assert all(g.dtype == p.dtype for (_, p), g in
               zip(tlm.named_leaves(tp), tg.values()))
    assert sum(float(g.float().abs().sum()) for g in tg.values()) > 0
    _grads_close(_stacked(tg, tcfg), jg)


@pytest.mark.parametrize("case", ["ce_chunk_below_s", "masked_labels",
                                  "not_dividing", "all_masked"])
def test_loss_fn_chunking_matches_jax(case):
    """The chunked cross-entropy: 4 chunks of 32 positions; a fifth of
    the labels -1; S=96 with ``ce_chunk=64`` (one chunk of all S); every
    label -1 (a loss of 0, the count clamped to 1).  Within ``LOSS_RTOL`` of
    JAX's; equal to the port's one-chunk loss up to f32 sums."""
    jcfg, tcfg, jp, tp = _models(LM_ARCH)
    kw = {"ce_chunk": 32}
    batch = _batch(jcfg.vocab)
    if case == "masked_labels":
        batch = _batch(jcfg.vocab, masked=0.2)
    elif case == "not_dividing":
        batch, kw = _batch(jcfg.vocab, s=96), {"ce_chunk": 64}
    elif case == "all_masked":
        batch["labels"][:] = -1
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jlm.loss_fn(jp, jcfg, jb, **kw))
    with torch.no_grad():
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        got = float(tlm.loss_fn(tp, tcfg, tb, **kw))
        whole = float(tlm.loss_fn(tp, tcfg, tb, ce_chunk=1 << 20))
    if case == "all_masked":
        assert got == want == 0.0
        return
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    assert got == pytest.approx(whole, rel=1e-6)


def test_chunked_route_grads_match_jax(monkeypatch):
    """With ``CHUNKED_SEQ`` lowered in both packages the loss trains
    through the chunked online-softmax route: the port's gradients within
    the bar of JAX's on that route, and JAX's own dense-versus-chunked gap
    inside the measured ``LOSS_GAP`` and ``GRAD_GAP``."""
    jcfg, tcfg, jp, tp = _models(LM_ARCH)
    batch = _batch(jcfg.vocab)
    jl_dense, jg_dense = _jax_value_and_grad(jcfg, jp, batch, remat=True)
    monkeypatch.setattr(jattn, "CHUNKED_SEQ", 64)
    monkeypatch.setattr(tattn, "CHUNKED_SEQ", 64)
    calls = []
    chunked = tattn._sdpa_chunked
    monkeypatch.setattr(tattn, "_sdpa_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    jl, jg = _jax_value_and_grad(jcfg, jp, batch, remat=True)
    tl, tg = _port_value_and_grad(tcfg, tp, batch, remat=True)
    # each layer once in the forward and once in its recompute
    assert len(calls) == 2 * tcfg.n_layers
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    _grads_close(_stacked(tg, tcfg), jg)
    assert abs(jl - jl_dense) <= LOSS_GAP * abs(jl_dense)
    _grads_close(dict(_paths(jg)), jg_dense, rtol=GRAD_GAP)


def test_remat_is_bitwise_no_remat():
    """Recomputing each layer and each cross-entropy chunk in the backward
    gives the same loss and the same gradients, bit for bit."""
    _, tcfg, _, tp = _models(LM_ARCH)
    batch = _batch(tcfg.vocab)
    l1, g1 = _port_value_and_grad(tcfg, tp, batch, remat=True, ce_chunk=32)
    l0, g0 = _port_value_and_grad(tcfg, tp, batch, remat=False, ce_chunk=32)
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def _grad_pair(tcfg, jcfg, seed, scale=1.0):
    """Seeded bf16 gradients in both layouts (the JAX tree and the port's
    names in the JAX leaf order)."""
    tree = lm_numpy_params(tcfg, seed=seed)
    for path, a in _paths(tree):
        a *= np.float32(scale)
    jg = _jax_params(jcfg, tree)
    tp = lm_params_from_numpy(tree, tcfg, "cpu")
    return jg, {n: p.detach().clone() for n, p in tlm.named_leaves(tp)}


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The norm within rtol 1e-5, each clipped leaf within one bf16 ulp
    (clipped at max_norm 1, left as it is at 1e3)."""
    jcfg, tcfg = jget_arch(LM_ARCH).reduced(), get_arch(LM_ARCH).reduced()
    jg, tg = _grad_pair(tcfg, jcfg, seed=3)
    jc, jn = jadamw.clip_by_global_norm(jg, max_norm)
    tc, tn = clip_by_global_norm(tg, max_norm)
    assert tn.dtype == torch.float32
    assert float(tn) == pytest.approx(float(jn), rel=1e-5)
    assert (float(jn) > max_norm) == (max_norm == 1.0)
    got = _stacked(tc, tcfg)
    for path, want in _paths(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jc)):
        assert np.all(np.abs(got[path] - want) <= _bf16_ulp(want)), path
        if max_norm > float(jn):
            np.testing.assert_array_equal(got[path],
                                          _stacked(tg, tcfg)[path])


def test_lr_schedule_matches_jax():
    peak, warmup, total = 3e-4, 20, 200
    for step in (0, 1, warmup - 1, warmup, 110, total, total + 50):
        want = float(jadamw.lr_schedule(jnp.asarray(step, jnp.int32), peak,
                                        warmup, total))
        got = lr_schedule(torch.tensor(step, dtype=torch.int32), peak,
                          warmup, total)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=1e-6, abs=0), step
    assert float(lr_schedule(torch.tensor(0, dtype=torch.int32))) == 0.0


def test_adamw_update_matches_jax():
    """One update from a state at step 3 with seeded moments: ``m`` and
    ``v`` within rtol 1e-6, the new parameters within one bf16 ulp, the
    step equal; parameters and moments are updated in place."""
    jcfg, tcfg = jget_arch(LM_ARCH).reduced(), get_arch(LM_ARCH).reduced()
    tree = lm_numpy_params(tcfg, seed=4)
    jp = _jax_params(jcfg, tree)
    tp = lm_params_from_numpy(tree, tcfg, "cpu")
    jg, tg = _grad_pair(tcfg, jcfg, seed=5, scale=0.1)
    rng = np.random.default_rng(6)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                     * 1e-3, tree)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32)
                     * 1e-5, tree)
    step = np.asarray(3, np.int32)
    jstate = jadamw.OptState(jax.tree.map(jnp.asarray, m),
                             jax.tree.map(jnp.asarray, v), jnp.asarray(step))
    tstate = opt_state_from_numpy((m, v, step), tcfg, "cpu")
    lr = 2e-3
    jp2, js2 = jadamw.adamw_update(jp, jg, jstate,
                                   lr=jnp.asarray(lr, jnp.float32))
    table = tp.embed.table
    tp2, ts2 = adamw_update(tp, tg, tstate,
                            lr=torch.tensor(lr, dtype=torch.float32))
    assert tp2 is tp and ts2 is tstate and tp.embed.table is table
    assert int(ts2.step) == int(js2.step) == 4
    assert ts2.step.dtype == torch.int32
    got = opt_state_to_numpy(ts2, tcfg)
    for name in ("m", "v"):
        for (path, g), (_, w) in zip(_paths(getattr(got, name)),
                                     _paths(getattr(js2, name))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=0, err_msg=path)
    got = dict(_paths(lm_numpy_from_params(tp2, tcfg)))
    for path, w in _paths(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jp2)):
        assert np.all(np.abs(got[path] - w) <= _bf16_ulp(w)), path


def test_init_opt_state():
    _, tcfg, _, tp = _models(LM_ARCH)
    st = init_opt_state(tp)
    assert isinstance(st, OptState) and int(st.step) == 0
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    for n, p in tp.named_parameters():
        for mom in (st.m[n], st.v[n]):
            assert mom.dtype == torch.float32 and mom.shape == p.shape
            assert not bool(mom.any())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_train_step_matches_jax():
    """``make_train_step(lr_warmup=1)`` from one state against the JAX
    step: step 0 (lr 0) leaves the parameters as they were and sets the
    moments; step 1 (lr = peak) moves them.  Each step's loss within
    ``LOSS_RTOL``, grad norm within ``GRAD_RTOL``, lr within rtol 1e-6; the
    moments within ``GRAD_RTOL`` (of max |m| and of max |v| a leaf).  After
    step 1 every leaf has moved; each parameter is within 2.001 x lr plus
    one bf16 ulp of JAX's (at t=2 an AdamW step moves a weight by at most
    1.0003 x lr besides the decay, so a sign that the gradient bar leaves
    open costs twice that), and at least 90 % of each leaf within one
    bf16 ulp (95.0-100 % measured)."""
    jcfg, tcfg, jp, tp = _models(LM_ARCH)
    kw = dict(remat=True, lr_peak=3e-3, lr_warmup=1, lr_total=10)
    jstep = jax.jit(jmake_train_step(jcfg, **kw))
    tstep = make_train_step(tcfg, device="cpu", **kw)
    js, ts = jadamw.init_opt_state(jp), init_opt_state(tp)
    before = lm_numpy_from_params(tp, tcfg)
    for i in range(2):
        batch = _batch(jcfg.vocab, seed=10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp2, ts, tm = tstep(tp, ts, batch)
        assert tp2 is tp
        assert set(tm) == {"loss", "grad_norm", "lr"}
        assert all(t.shape == () and t.dtype == torch.float32
                   for t in tm.values())
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=LOSS_RTOL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_RTOL)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
        got = opt_state_to_numpy(ts, tcfg)
        for name in ("m", "v"):
            _grads_close(dict(_paths(getattr(got, name))),
                         jax.tree.map(np.asarray, getattr(js, name)))
        if i == 0:
            assert float(tm["lr"]) == 0.0
            for path, a in _paths(lm_numpy_from_params(tp, tcfg)):
                np.testing.assert_array_equal(a, dict(_paths(before))[path])
    got = dict(_paths(lm_numpy_from_params(tp, tcfg)))
    before = dict(_paths(before))
    moved = 0
    for path, w in _paths(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jp)):
        d = np.abs(got[path] - w)
        ulp = _bf16_ulp(np.maximum(np.abs(before[path]), np.abs(w)))
        assert np.all(d <= 2.001 * kw["lr_peak"] + ulp), path
        assert (d <= ulp).mean() >= 0.9, path
        moved += int((got[path] != before[path]).any())
    assert moved == len(got)


def test_train_step_default_device_needs_cuda():
    cfg = get_arch(LM_ARCH).reduced()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg)


def test_flash_route_under_autograd_raises():
    """The flash kernel has no backward: a train step on the flash route
    raises on the CPU as on the card (its plain version would otherwise
    differentiate here and not there); without grad the route runs.  The
    JAX package fails there too: ``jax.grad`` through ``use_flash=True``
    on the CPU stops at an ``AssertionError`` in Pallas' JVP rule."""
    jcfg, tcfg, jp, tp = _models(LM_ARCH)
    batch = _batch(tcfg.vocab, s=64)
    step = make_train_step(tcfg, use_flash=True, device="cpu")
    with pytest.raises(RuntimeError, match="no backward.*item 13a"):
        step(tp, init_opt_state(tp), batch)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="no backward"):
        tlm.loss_fn(tp, tcfg, tb, use_flash=True)
    with torch.no_grad():
        assert torch.isfinite(tlm.loss_fn(tp, tcfg, tb, use_flash=True))
    with pytest.raises(AssertionError):
        jax.grad(lambda p: jlm.loss_fn(
            p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
            use_flash=True))(jp)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,vocab,seq,batch,hosts", [
    (0, 512, 64, 8, 1), (3, 512, 64, 8, 2), (7, 1000, 128, 12, 4),
    (11, 50, 16, 2, 1)])
def test_data_pipeline_is_the_jax_pipeline(seed, vocab, seq, batch, hosts):
    """Every host's batches at several steps, bitwise (tokens, labels,
    dtypes), and the bigram tables."""
    for h in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
                  host_id=h, num_hosts=hosts)
        tp, jp = DataPipeline(**kw), JPipeline(**kw)
        np.testing.assert_array_equal(tp.succ, jp.succ)
        assert tp.local_batch == jp.local_batch
        for step in (0, 1, 17, 1000):
            got, want = tp.batch(step), jp.batch(step)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


def test_reduced_depth_cut_is_the_jax_cut():
    """The trainer tests' model (``tests/test_integration.py``'s TINY) is
    the same cut in both packages."""
    j = dataclasses.replace(jget_arch(LM_ARCH).reduced(), n_layers=2)
    t = dataclasses.replace(get_arch(LM_ARCH).reduced(), n_layers=2)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
