"""The port's trainer and checkpoints against the JAX package on the CPU:
the counterparts of ``tests/test_integration.py``'s training tests (the
data pipeline, the loss going down, resume equal to a straight run, the
checkpoint's integrity and garbage collection, restore onto a device), the
checkpoint format shared by both packages, the port's ``Trainer`` against
the JAX ``Trainer`` step by step, the reference's preemption and
non-finite-loss behaviour, the background save's snapshot, the launcher,
and what is left to the multi-card layer.

The JAX ``Trainer.run`` installs SIGTERM/SIGINT handlers and leaves them;
the ``signals`` fixture puts back the ones it found.
"""
import dataclasses
import json
import os
import signal
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.configs import get_arch as jget_arch
from repro.data import DataPipeline as JPipeline
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_numpy_from_params, lm_numpy_params,
                                 lm_params_from_numpy, lm_tree_from_params,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data import DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.optim import init_opt_state
from repro_torch.train import make_train_step, trainer as ttrainer
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_sim import LM_ARCH, _jax_params, torch_one_thread  # noqa: F401
from test_torch_train import LOSS_RTOL

TINY = dataclasses.replace(get_arch(LM_ARCH).reduced(), n_layers=2)
JTINY = dataclasses.replace(jget_arch(LM_ARCH).reduced(), n_layers=2)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture
def signals():
    """Put back the SIGTERM and SIGINT handlers a trainer run replaces."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield prev
    for s, h in prev.items():
        signal.signal(s, h)


def _tcfg(d, **kw):
    return TrainerConfig(**dict(dict(ckpt_every=100, log_every=100,
                                     ckpt_dir=str(d)), **kw))


def _paths(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _state(seed=0, step=7):
    """A trainer state of TINY in the JAX layout: seeded parameters and
    seeded non-zero moments (numpy), a step count."""
    tree = lm_numpy_params(TINY, seed=seed)
    rng = np.random.default_rng(seed + 1)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     tree)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), tree)
    return tree, (m, v, np.asarray(step, np.int32))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# tests/test_integration.py's training tests
# ---------------------------------------------------------------------------
def test_data_pipeline_deterministic_and_sharded():
    p1 = DataPipeline(vocab=512, seq_len=64, global_batch=8, seed=3)
    p2 = DataPipeline(vocab=512, seq_len=64, global_batch=8, seed=3)
    np.testing.assert_array_equal(p1.batch(7)["tokens"],
                                  p2.batch(7)["tokens"])
    assert not np.array_equal(p1.batch(7)["tokens"], p1.batch(8)["tokens"])
    hosts = [DataPipeline(vocab=512, seq_len=64, global_batch=8, seed=3,
                          host_id=h, num_hosts=2) for h in range(2)]
    assert hosts[0].local_batch == 4
    assert not np.array_equal(hosts[0].batch(0)["tokens"],
                              hosts[1].batch(0)["tokens"])


def test_training_loss_decreases(tmp_path, signals):
    pipe = DataPipeline(vocab=TINY.vocab, seq_len=64, global_batch=8)
    res = Trainer(TINY, _tcfg(tmp_path / "ck", steps=30, lr_peak=3e-3,
                              lr_warmup=5), pipe, device="cpu").run()
    first = np.mean([h["loss"] for h in res["history"][:5]])
    last = np.mean([h["loss"] for h in res["history"][-5:]])
    assert last < first - 0.2, (first, last)
    assert {s: signal.getsignal(s) for s in signals} == signals


def test_checkpoint_resume_exact(tmp_path, signals):
    """Train 10 steps, checkpoint, resume 5 more == 15 straight steps: the
    reference's bar (rel 1e-4) and, on the CPU, bit for bit, the final
    checkpoints too."""
    pipe = DataPipeline(vocab=TINY.vocab, seq_len=32, global_batch=4)
    d1, d2 = tmp_path / "a", tmp_path / "b"
    straight = Trainer(TINY, _tcfg(d1, steps=15), pipe, device="cpu").run()
    Trainer(TINY, _tcfg(d2, steps=10, ckpt_every=10), pipe,
            device="cpu").run()
    resumed = Trainer(TINY, _tcfg(d2, steps=15), pipe, device="cpu").run()
    assert resumed["steps_run"] == 5
    assert resumed["final_loss"] == pytest.approx(straight["final_loss"],
                                                  rel=1e-4)
    assert resumed["final_loss"] == straight["final_loss"]
    assert [h["loss"] for h in resumed["history"]] == [
        h["loss"] for h in straight["history"][10:]]
    assert _manifest(d1, 15)["leaves"] == _manifest(d2, 15)["leaves"]


def test_checkpoint_integrity_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(10.0), "b": torch.ones((3, 3))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("step_")]) == 2  # GC keeps 2
    back = mgr.restore(tree)
    np.testing.assert_array_equal(back["w"].numpy(), np.arange(10.0))
    # corruption detection
    leaf = os.path.join(mgr._step_dir(4), "leaf_00000.bin")
    with open(leaf, "r+b") as f:
        f.seek(20)
        f.write(b"\xff")
    with pytest.raises(IOError):
        mgr.restore(tree)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_restore_onto_a_device(tmp_path):
    """The counterpart of the reference's elastic restore: leaves onto a
    device (the CPU here); a mesh (``shardings``) is item 14; the card
    without CUDA raises."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4),
            "h": torch.arange(6, dtype=torch.bfloat16)}
    mgr.save(1, tree)
    back = mgr.restore(tree, device="cpu")
    for k, t in tree.items():
        assert back[k].device.type == "cpu" and back[k].dtype == t.dtype
        assert torch.equal(back[k], t)
    with pytest.raises(NotImplementedError, match="item 14"):
        mgr.restore(tree, shardings={"w": None})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mgr.restore(tree, device="cuda")


# ---------------------------------------------------------------------------
# the checkpoint format, shared by both packages
# ---------------------------------------------------------------------------
def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX ``CheckpointManager`` checkpoint of TINY's trainer state
    restores in the port (through the port trainer's own template) to the
    tensors ``lm_params_from_numpy`` makes and the same ``OptState``."""
    tree, (m, v, step) = _state()
    jp = _jax_params(JTINY, tree)
    jopt = jadamw.OptState(jax.tree.map(jnp.asarray, m),
                           jax.tree.map(jnp.asarray, v), jnp.asarray(step))
    JManager(str(tmp_path)).save(7, {"params": jp, "opt": jopt})
    tr = Trainer(TINY, _tcfg(tmp_path), None, device="cpu")
    params, opt, start = tr.init_or_resume()
    assert start == 7
    want = lm_params_from_numpy(tree, TINY, "cpu")
    for (n, a), (n2, b) in zip(params.named_parameters(),
                               want.named_parameters()):
        assert n == n2 and a.dtype == b.dtype and torch.equal(a, b), n
    assert opt.step.dtype == torch.int32 and int(opt.step) == 7
    got = opt_state_to_numpy(opt, TINY)
    for name, ref in (("m", m), ("v", v)):
        for (p, a), (_, b) in zip(_paths(getattr(got, name)), _paths(ref)):
            np.testing.assert_array_equal(a, b, err_msg=p)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The reverse: the port trainer's checkpoint of the same state
    restores in JAX to the same arrays, and both packages write the same
    leaves (shapes, dtype strings, sha1 of the bytes) in the same order."""
    tree, ost = _state()
    params = lm_params_from_numpy(tree, TINY, "cpu")
    opt = opt_state_from_numpy(ost, TINY, "cpu")
    tr = Trainer(TINY, _tcfg(tmp_path / "port"), None, device="cpu")
    tr.ckpt.save(7, tr._state(params, opt))
    jp = _jax_params(JTINY, tree)
    jopt = jadamw.OptState(*(jax.tree.map(jnp.asarray, x) for x in ost))
    template = {"params": jp, "opt": jopt}
    back = JManager(str(tmp_path / "port")).restore(template)
    for (p, a), (_, b) in zip(_paths(back["params"]), _paths(jp)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), p)
    for i in range(2):
        for (p, a), (_, b) in zip(_paths(back["opt"][i]), _paths(ost[i])):
            np.testing.assert_array_equal(a, b, err_msg=p)
    assert back["opt"].step.dtype == np.int32 and int(back["opt"].step) == 7
    JManager(str(tmp_path / "jax")).save(7, template)
    assert _manifest(tmp_path / "port", 7)["leaves"] == \
        _manifest(tmp_path / "jax", 7)["leaves"]


def test_background_save_takes_a_copy(tmp_path):
    """``save(background=True)`` of a tree that holds the live parameters
    and moments, then an in-place train step before the writer runs: the
    checkpoint holds the state before the step."""
    params = lm_params_from_numpy(lm_numpy_params(TINY, seed=2), TINY, "cpu")
    opt = init_opt_state(params)
    tree = {"params": dict(params.named_parameters()), "opt": opt}
    before = {"params": {n: p.detach().clone()
                         for n, p in params.named_parameters()},
              "step": opt.step.clone()}
    mgr = CheckpointManager(str(tmp_path))
    gate, write = threading.Event(), mgr._write
    mgr._write = lambda *a: (gate.wait(30), write(*a))
    mgr.save(1, tree, background=True)
    step = make_train_step(TINY, lr_warmup=1, device="cpu")
    pipe = DataPipeline(vocab=TINY.vocab, seq_len=32, global_batch=2)
    for i in range(2):
        step(params, opt, pipe.batch(i))
    assert int(opt.step) == 2
    gate.set()
    mgr.wait()
    back = mgr.restore(tree)
    for n, t in before["params"].items():
        assert torch.equal(back["params"][n], t), n
        assert not torch.equal(back["params"][n], params.get_parameter(n))
    assert int(back["opt"].step) == 0
    assert not any(bool(t.any()) for t in back["opt"].m.values())


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------
def test_trainer_matches_jax_trainer(tmp_path, monkeypatch, signals):
    """Ten steps of both trainers on TINY from the same parameters (each
    package's ``init_params`` replaced by the converted tree): each step's
    loss within the training bar; the resume checkpoints restore in the
    other package."""
    tree = lm_numpy_params(TINY, seed=0)
    jp = _jax_params(JTINY, tree)
    monkeypatch.setattr(jlm, "init_params",    # a copy: the step donates
                        lambda key, cfg: jax.tree.map(jnp.array, jp))
    monkeypatch.setattr(tlm, "init_params",
                        lambda gen, cfg, device="cuda": lm_params_from_numpy(
                            tree, cfg, device))
    kw = dict(steps=10, ckpt_every=5, lr_peak=3e-3, lr_warmup=2)
    pipe = dict(vocab=TINY.vocab, seq_len=32, global_batch=4)
    jres = jtrainer.Trainer(JTINY, jtrainer.TrainerConfig(
        **dict(kw, ckpt_every=5, log_every=100,
               ckpt_dir=str(tmp_path / "jax"))), JPipeline(**pipe)).run()
    tres = Trainer(TINY, _tcfg(tmp_path / "port", **kw), DataPipeline(**pipe),
                   device="cpu").run()
    assert [h["step"] for h in tres["history"]] == list(range(10))
    assert [h["step"] for h in jres["history"]] == list(range(10))
    for t, j in zip(tres["history"], jres["history"]):
        assert t["loss"] == pytest.approx(j["loss"], rel=LOSS_RTOL), t["step"]
    assert (tres["steps_run"], tres["stragglers"]) == (jres["steps_run"], 0)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["step_00000005",
                                                 "step_00000010"]
    # the JAX run's last checkpoint resumes the port's trainer
    _, opt, start = Trainer(TINY, _tcfg(tmp_path / "jax"), None,
                            device="cpu").init_or_resume()
    assert start == int(opt.step) == 10


def test_preemption_and_nonfinite_loss_as_the_reference(tmp_path,
                                                        monkeypatch,
                                                        signals):
    """A SIGTERM during step 2 stops the loop before step 3, and the final
    save is labelled ``step + 1`` = 4, as in the JAX trainer (which holds
    the state after three steps under that label).  A non-finite loss at
    step 1 leaves the step out of the history, its update applied."""
    tree = lm_numpy_params(TINY, seed=0)
    jp = _jax_params(JTINY, tree)
    monkeypatch.setattr(jlm, "init_params",    # a copy: the step donates
                        lambda key, cfg: jax.tree.map(jnp.array, jp))
    monkeypatch.setattr(tlm, "init_params",
                        lambda gen, cfg, device="cuda": lm_params_from_numpy(
                            tree, cfg, device))

    def injecting(step_fn):
        calls = []

        def step(*a):
            out = step_fn(*a)
            calls.append(1)
            if len(calls) == 2:
                nan = out[2]["loss"] * float("nan")
                out = (out[0], out[1], dict(out[2], loss=nan))
            if len(calls) == 3:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    compile_step = jtrainer.Trainer._compile_step
    monkeypatch.setattr(jtrainer.Trainer, "_compile_step",
                        lambda self, *a: injecting(compile_step(self, *a)))
    pipe = dict(vocab=TINY.vocab, seq_len=32, global_batch=2)
    jres = jtrainer.Trainer(JTINY, jtrainer.TrainerConfig(
        steps=8, ckpt_every=100, log_every=100,
        ckpt_dir=str(tmp_path / "jax")), JPipeline(**pipe)).run()
    t = Trainer(TINY, _tcfg(tmp_path / "port", steps=8), DataPipeline(**pipe),
                device="cpu")
    t.step_fn = injecting(t.step_fn)
    tres = t.run()
    assert [h["step"] for h in tres["history"]] == \
        [h["step"] for h in jres["history"]] == [0, 2]
    assert tres["steps_run"] == jres["steps_run"] == 4
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == \
        ["step_00000004"]
    # both final checkpoints hold the state after three updates
    _, opt, start = t.init_or_resume()
    assert start == 4 and int(opt.step) == 3
    steps = [[leaf["sha1"] for leaf in _manifest(tmp_path / d, 4)["leaves"]
              if leaf["dtype"] == "int32"] for d in ("port", "jax")]
    assert steps[0] == steps[1] and len(steps[0]) == 1


# ---------------------------------------------------------------------------
# the launcher, the device rule and the multi-card layer
# ---------------------------------------------------------------------------
def test_launcher_on_the_cpu(tmp_path, monkeypatch, capsys, signals):
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--steps", "3", "--seq", "32",
        "--batch", "2", "--ckpt", str(tmp_path / "ck")])
    launch_train.main()
    out = capsys.readouterr().out
    assert "[trainer] step 0 loss" in out
    assert "done: final loss" in out and "3 steps" in out
    assert os.listdir(tmp_path / "ck") == ["step_00000003"]


def test_trainer_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TINY, _tcfg(tmp_path), None)


def test_mesh_and_shardings_are_item_14(tmp_path):
    for kw in ({"mesh": object()}, {"shardings": {}}):
        with pytest.raises(NotImplementedError, match="item 14"):
            Trainer(TINY, _tcfg(tmp_path), None, device="cpu", **kw)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 14"):
        mgr.restore({"w": torch.zeros(2)}, shardings={"w": "data"})


def test_trainer_state_is_the_jax_layout(tmp_path):
    """The checkpointed tree: ``{"opt", "params"}`` of the JAX layout with
    the parameters' types, the module's values and a copy of them."""
    tree = lm_numpy_params(TINY, seed=5)
    params = lm_params_from_numpy(tree, TINY, "cpu")
    st = Trainer(TINY, _tcfg(tmp_path), None, device="cpu")._state(
        params, init_opt_state(params))
    assert sorted(st) == ["opt", "params"]
    got = dict(_paths(st["params"]))
    assert sorted(got) == sorted(dict(_paths(tree)))
    for path, a in _paths(tree):
        assert got[path].dtype == (torch.float32 if "scale" in path
                                   or "norm" in path else torch.bfloat16)
        np.testing.assert_array_equal(got[path].float().numpy(), a)
    assert st["params"]["embed"]["table"].data_ptr() != \
        params.embed.table.data_ptr()
    assert sorted(dict(_paths(lm_numpy_from_params(params, TINY)))) == \
        sorted(got)
    assert lm_tree_from_params(params, TINY)["ln_f"]["scale"].dtype == \
        torch.float32
