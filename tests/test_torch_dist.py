"""The port's steps on DTensor parameters over a gloo world of two CPU
processes, against the port's unsharded steps and the JAX forward: the
reduced qwen3-1.7b (K/V heads sharded with the q heads) and paligemma-3b
(one K/V head, replicated; its q heads sharded), each on the meshes (1, 2)
and (2, 1) ``("data", "model")``, the latter with the dry-run's
activation constraints (batch on "data", the weights read gathered):

* ``lm.forward`` on the sharded parameters equals the unsharded forward
  and the JAX forward of the same weights within the model-level bar of
  ``tests/test_torch_models.py``, argmax equal;
* the gradients of ``lm.loss_fn`` (remat) and one ``make_train_step``
  equal the unsharded ones within ``tests/test_torch_train.py``'s bars;
* ``CheckpointManager.restore(shardings=)`` gives back the saved leaves.

The world is two processes of this file (``python tests/test_torch_dist.py
<rank> <store> <out>``) on a ``FileStore`` under ``tmp_path``; each destroys
its group before it exits.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "paligemma-3b")
MESHES = ((1, 2), (2, 1))
B, S = 2, 16


def _cfg(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch).reduced()


def _batch(cfg) -> dict:
    from repro_torch import convert
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    return dict({"tokens": tok.astype(np.int32)},
                **convert.lm_numpy_embeds(cfg, B))


def _case(rank, cfg, mesh, tree, ckpt) -> dict:
    """One arch on one mesh: logits, gradients and a train step, sharded
    and not; the restore of the unsharded leaves onto the mesh."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import convert
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.sharding import (NamedSharding, batch_specs,
                                      param_specs, shard_tree)
    from repro_torch.train import make_train_step
    from repro_torch.train.step import to_device

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    batch = to_device(_batch(cfg), torch.device("cpu"))
    batch["labels"] = batch["tokens"]
    plain = convert.lm_params_from_numpy(tree, cfg, "cpu")
    specs = param_specs(cfg, mesh, plain)
    sharded = shard_tree(convert.lm_params_from_numpy(tree, cfg, "cpu"),
                         specs, mesh)
    dbatch = shard_tree(batch, batch_specs(cfg, mesh, batch), mesh)
    out = {}
    with torch.no_grad(), implicit_replication():
        out["logits"] = full(lm.forward(sharded, cfg, dbatch)).float().numpy()
    with torch.no_grad():
        out["plain"] = lm.forward(plain, cfg, batch).float().numpy()
    grads = {}
    for name, params, b in (("sharded", sharded, dbatch),
                            ("plain", plain, batch)):
        leaves = lm.named_leaves(params)
        with implicit_replication():
            loss = lm.loss_fn(params, cfg, b, remat=True)
            gs = torch.autograd.grad(loss, [p for _, p in leaves])
        grads[name] = {n: full(g).double() for (n, _), g in zip(leaves, gs)}
    out["grad_rel"] = max(
        float((grads["sharded"][n] - g).norm() / max(float(g.norm()),
                                                      1e-30))
        for n, g in grads["plain"].items())
    metrics = {}
    for name, params, b in (("sharded", sharded, dbatch),
                            ("plain", plain, batch)):
        step = make_train_step(cfg, remat=True, lr_warmup=1, device="cpu")
        _, _, m = step(params, init_opt_state(params), b)
        metrics[name] = {k: float(full(v)) for k, v in m.items()}
    out["metrics"] = metrics
    saved = {n: p.detach().clone()
             for n, p in convert.lm_params_from_numpy(
                 tree, cfg, "cpu").named_parameters()}
    mgr = CheckpointManager(os.path.join(ckpt, f"rank{rank}"))
    mgr.save(1, saved)
    back = mgr.restore(saved, shardings={
        n: NamedSharding(mesh, specs[n]) for n in saved})
    out["restored"] = all(
        isinstance(back[n], DTensor) and back[n].dtype == t.dtype
        and torch.equal(back[n].full_tensor(), t)
        and tuple(back[n].placements) == tuple(
            sharded.get_parameter(n).placements)
        for n, t in saved.items())
    out["placements"] = {n: str(sharded.get_parameter(n).placements)
                         for n in ("layers.0.attn.wq", "layers.0.attn.wk")}
    return out


def _worker(rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import convert
    from repro_torch.models import lm, moe
    from repro_torch.sharding import NamedSharding, P
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    res = {}
    try:
        for arch in ARCHS:
            cfg = _cfg(arch)
            tree = convert.lm_numpy_params(cfg, seed=0)
            for shape in MESHES:
                mesh = init_device_mesh("cpu", shape,
                                        mesh_dim_names=("data", "model"))
                if shape[0] > 1:   # the dry-run's constraints, B % 2 == 0
                    lm.ACT_SPEC = NamedSharding(mesh, P("data", None, None))
                    lm.LOGITS_SPEC = NamedSharding(mesh,
                                                   P("data", None, "model"))
                    moe.BATCH_SPEC = NamedSharding(mesh, P("data"))
                try:
                    r = _case(rank, cfg, mesh, tree,
                              os.path.dirname(out))
                finally:
                    lm.ACT_SPEC = lm.LOGITS_SPEC = moe.BATCH_SPEC = None
                res[f"{arch}-{shape[0]}x{shape[1]}"] = r
    finally:
        dist.destroy_process_group()
    if rank == 0:
        arrays = {f"{k}/{n}": v[n] for k, v in res.items()
                  for n in ("logits", "plain")}
        np.savez(out + ".npz", **arrays)
        with open(out + ".json", "w") as f:
            json.dump({k: {n: v[n] for n in v if n not in ("logits",
                                                          "plain")}
                       for k, v in res.items()}, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as tlm, moe as tmoe  # noqa: E402
from test_torch_models import LOGIT_RTOL  # noqa: E402
from test_torch_sim import _jax_params, torch_one_thread  # noqa: E402,F401
from test_torch_train import GRAD_RTOL, LOSS_RTOL  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(autouse=True)
def constraints():
    """The activation constraints are module state; leave them unset."""
    yield
    tlm.ACT_SPEC = tlm.LOGITS_SPEC = tmoe.BATCH_SPEC = None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' run; rank 0's readings."""
    d = tmp_path_factory.mktemp("dist")
    out = str(d / "rank0")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r),
         str(d / "store"), str(d / f"rank{r}")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    with open(out + ".json") as f:
        meta = json.load(f)
    return meta, dict(np.load(out + ".npz"))


def _jax_logits(arch):
    jcfg = jget_arch(arch).reduced()
    tree = convert.lm_numpy_params(_cfg(arch), seed=0)
    b = {k: jnp.asarray(v) for k, v in _batch(_cfg(arch)).items()}
    return np.asarray(jlm.forward(_jax_params(jcfg, tree), jcfg, b),
                      np.float32)


def _model_close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= LOGIT_RTOL * scale
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dtensor_forward_is_the_unsharded_and_jax_forward(world, arch,
                                                           mesh):
    _, arrays = world
    key = f"{arch}-{mesh[0]}x{mesh[1]}"
    got = arrays[f"{key}/logits"]
    assert got.shape == (B, S, _cfg(arch).vocab)
    _model_close(got, arrays[f"{key}/plain"])
    _model_close(got, _jax_logits(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dtensor_gradients_and_train_step(world, arch, mesh):
    meta, _ = world
    r = meta[f"{arch}-{mesh[0]}x{mesh[1]}"]
    assert r["grad_rel"] <= GRAD_RTOL
    s, p = r["metrics"]["sharded"], r["metrics"]["plain"]
    assert abs(s["loss"] - p["loss"]) <= LOSS_RTOL * abs(p["loss"])
    assert abs(s["grad_norm"] - p["grad_norm"]) <= GRAD_RTOL * p["grad_norm"]
    assert s["lr"] == p["lr"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_restore_onto_the_mesh(world, arch, mesh):
    meta, _ = world
    r = meta[f"{arch}-{mesh[0]}x{mesh[1]}"]
    assert r["restored"]
    if mesh == (1, 2):   # heads on "model": wq sharded; K/V with them for
        # qwen3 (2 heads), replicated for paligemma (1 head)
        assert "Shard(dim=1)" in r["placements"]["layers.0.attn.wq"]
        kv = r["placements"]["layers.0.attn.wk"]
        assert ("Shard(dim=1)" in kv) == (arch == "qwen3-1.7b")
