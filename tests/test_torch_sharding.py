"""The port's sharding layer against the JAX package's on the CPU: the
counterparts of ``tests/test_sharding.py`` (the rules at both production
meshes leaf by leaf, the attention, GQA and vocab cases, the batch specs,
the padding bookkeeping), the decode-state specs, the abstract inputs
against ``jax.eval_shape``, the H100 roofline against the JAX formula, and
-- in a child process, since a process group is process-wide -- the
collective counter on a hand count, the dry-run's FLOPs on a hand count
and the flash route on local heads with replicated K/V, on a fake process
group (``python tests/test_torch_sharding.py <out>``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}


def _child(out: str) -> None:
    """The fake-group cases; their readings go to ``out`` as JSON."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.configs import base
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import attention
    res = {}

    # a column- then row-parallel MLP on a fake (1, 2) mesh: one all-reduce
    dryrun.start_fake_world(2)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    b, s, d, f = 2, 8, 16, 32
    x = distribute_tensor(torch.randn(b, s, d, dtype=torch.bfloat16), mesh,
                          [Replicate(), Replicate()])
    w1 = distribute_tensor(torch.randn(d, f, dtype=torch.bfloat16), mesh,
                           [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.randn(f, d, dtype=torch.bfloat16), mesh,
                           [Replicate(), Shard(0)])
    with roofline.CollectiveBytes() as coll:
        (x @ w1 @ w2).redistribute(mesh, [Replicate(), Replicate()])
    res["mlp"] = {"counts": coll.counts(), "want": b * s * d * 2}
    dist.destroy_process_group()

    # the dry-run's FLOPs on a reduced dense config at the production mesh
    cfg = dataclasses.replace(base.get_arch("qwen3-1.7b").reduced(),
                              name="qwen3-reduced")
    base.register(cfg)
    dryrun.start_fake_world(256)
    rec = {k: dryrun.run_cell("qwen3-reduced", k, verbose=False)
           for k in ("train_4k", "prefill_32k")}
    res["flops"] = {k: r["cost"]["flops"] for k, r in rec.items()}
    res["status"] = {k: r["status"] for k, r in rec.items()}
    dist.destroy_process_group()

    # the flash route on local heads, K/V replicated: H=4, n_kv=2, tp=4
    h, hkv, tp, hd = 4, 2, 4, 32
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, n, hd, generator=g) for n in (h, hkv, hkv))
    want = flash_ops.mha_plain(q, k, v, causal=True)
    worst = []
    for rank in range(tp):
        dist.init_process_group("fake", store=dryrun_store(), rank=rank,
                                world_size=tp)
        mesh = init_device_mesh("cpu", (1, tp),
                                mesh_dim_names=("data", "model"))
        dq = distribute_tensor(q, mesh, [Replicate(), Shard(2)],
                               src_data_rank=None)
        dk, dv = (distribute_tensor(t, mesh, [Replicate(), Replicate()],
                                    src_data_rank=None) for t in (k, v))
        with torch.no_grad():
            got = attention._on_local_heads(
                lambda a, b_, c: flash_ops.mha(a, b_, c, causal=True),
                dq, dk, dv, h, hkv).to_local()
        hl = h // tp
        worst.append(float((got - want[:, :, rank * hl:(rank + 1) * hl])
                           .abs().max()))
        dist.destroy_process_group()
    res["local_heads"] = worst
    with open(out, "w") as fh:
        json.dump(res, fh)


def dryrun_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _child(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding.compat import abstract_mesh as jmesh  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.sharding import (P, abstract_mesh, batch_specs,  # noqa: E402
                                  decode_state_specs, param_specs,
                                  placements, rules)
from repro_torch.train import step  # noqa: E402
from test_torch_sim import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(autouse=True)
def clear_fallbacks():
    """``rules.FALLBACKS`` is module state; leave it empty."""
    rules.FALLBACKS.clear()
    yield
    rules.FALLBACKS.clear()


def _by_path(tree) -> dict:
    """A JAX tree as {"/"-joined path: leaf} (PartitionSpec and
    ShapeDtypeStruct leaves)."""
    out = {}

    def f(path, leaf):
        keys = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        out["/".join(keys)] = leaf

    jax.tree_util.tree_map_with_path(
        f, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def _specs(arch, mesh_id):
    sizes, names = MESHES[mesh_id]
    jrules.FALLBACKS.clear()
    jspecs = _by_path(jrules.param_specs(
        JARCHS[arch], jmesh(sizes, names), jstep.abstract_params(JARCHS[arch])))
    jfall = list(jrules.FALLBACKS)
    jrules.FALLBACKS.clear()
    rules.FALLBACKS.clear()
    params = step.abstract_params(ARCHS[arch])
    specs = param_specs(ARCHS[arch], abstract_mesh(sizes, names), params)
    return params, specs, list(rules.FALLBACKS), jspecs, jfall


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_param_specs_are_the_jax_specs(arch, mesh_id):
    """``test_param_specs_divisible``: every leaf's spec is the JAX spec of
    its path with the stacked dim dropped, every sharded dim divides, and
    ``FALLBACKS`` is the reference's list (one entry a path)."""
    params, specs, fall, jspecs, jfall = _specs(arch, mesh_id)
    shape = abstract_mesh(*MESHES[mesh_id]).shape
    assert fall == jfall
    for name, p in params.named_parameters():
        path, layer = lm.jax_path(name)
        want = tuple(jspecs[path])[1:] if layer >= 0 else tuple(jspecs[path])
        assert tuple(specs[name]) == want, name
        assert len(specs[name]) <= p.dim()
        for dim, ax in zip(p.shape, specs[name]):
            axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
            assert dim % int(np.prod([shape[a] for a in axes])) == 0
    # the JAX tree's _shape leaves are no parameters here: replicated there
    extra = set(jspecs) - {lm.jax_path(n)[0] for n in specs}
    assert all(k.endswith("/_shape") and not any(jspecs[k])
               for k in extra), extra


def test_attention_tp_sharding_when_heads_divide():
    _, specs, _, _, _ = _specs("command-r-35b", "1pod")  # 64 q heads
    assert specs["layers.0.attn.wq"][-1] == "model"
    assert specs["layers.0.attn.wo"][-2] == "model"


def test_gqa_kv_replicated_when_small():
    _, specs, fall, _, _ = _specs("yi-9b", "1pod")  # kv=4 < 16
    assert specs["layers.0.attn.wk"][-1] is None
    assert any("kv heads" in f for f in fall)


def test_vocab_sharded_on_model():
    _, specs, _, _, _ = _specs("qwen3-1.7b", "1pod")  # 152064 % 16 == 0
    assert specs["embed.table"][0] == "model"


def test_batch_specs_fsdp():
    """The reference's case, then every arch and shape against the JAX
    rules on the JAX shapes."""
    mp = abstract_mesh(*MESHES["2pod"])
    b = step.input_specs("yi-9b", "train_4k")
    assert batch_specs(ARCHS["yi-9b"], mp, b)["tokens"][0] == ("pod", "data")
    b1 = {"tokens": torch.empty((1, 1), dtype=torch.int32, device="meta")}
    assert batch_specs(ARCHS["yi-9b"], mp, b1)["tokens"][0] is None
    for mesh_id, (sizes, names) in MESHES.items():
        for arch in ARCHS:
            for shape in SHAPES:
                got = batch_specs(ARCHS[arch], abstract_mesh(sizes, names),
                                  step.input_specs(arch, shape))
                want = jrules.batch_specs(JARCHS[arch], jmesh(sizes, names),
                                          jstep.input_specs(arch, shape))
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (arch, shape)


def test_padding_bookkeeping():
    q14 = ARCHS["qwen3-14b"]
    assert q14.n_heads == 48 and q14.logical_n_heads == 40
    assert q14.n_heads % 16 == 0
    wb = ARCHS["whisper-base"]
    assert wb.vocab % 128 == 0 and wb.logical_vocab == 51865


def _jax_state(arch, batch, s_max):
    cfg = JARCHS[arch]
    return jstep.abstract_decode_state(cfg, jstep.abstract_params(cfg),
                                       batch, s_max)


def _state_pairs(port, jax_state):
    """(field path, port leaf, JAX leaf) of the two decode states; the
    port's Python-int ``length`` / ``pos`` are left out."""
    out = []

    def walk(a, b, path):
        if isinstance(a, tuple) and not isinstance(a, P):
            for i, (x, y) in enumerate(zip(a, b)):
                name = a._fields[i] if hasattr(a, "_fields") else str(i)
                walk(x, y, f"{path}/{name}")
        elif a is not None and not isinstance(a, int):
            out.append((path, a, b))

    walk(port, jax_state, "")
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_state_specs_are_the_jax_specs(arch):
    for mesh_id, (sizes, names) in MESHES.items():
        for shape in ("decode_32k", "long_500k"):
            sp = SHAPES[shape]
            if not ARCHS[arch].runs(shape):
                continue
            state = step.abstract_decode_state(
                ARCHS[arch], step.abstract_params(ARCHS[arch]),
                sp.global_batch, sp.seq_len)
            jstate = _jax_state(arch, sp.global_batch, sp.seq_len)
            got = decode_state_specs(ARCHS[arch], abstract_mesh(sizes, names),
                                     state)
            want = jrules.decode_state_specs(JARCHS[arch],
                                             jmesh(sizes, names), jstate)
            pairs = _state_pairs(got, want)
            assert pairs, arch
            for path, a, b in pairs:
                assert tuple(a) == tuple(b), (arch, shape, mesh_id, path)


def _dtype(jdt) -> torch.dtype:
    return {jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.int32): torch.int32}[jnp.dtype(jdt)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_shapes_are_jax_eval_shape(arch):
    """``input_specs`` and the ``abstract_*`` shapes and types equal
    ``jax.eval_shape``'s: a stacked JAX leaf is every layer's parameter
    with the layer dim added."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for shape in SHAPES:
        got, want = step.input_specs(arch, shape), jstep.input_specs(arch,
                                                                     shape)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].is_meta and tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == _dtype(want[k].dtype)
    params = step.abstract_params(cfg)
    jparams = _by_path(jstep.abstract_params(jcfg))
    opt = step.abstract_opt_state(params)
    jopt = jstep.abstract_opt_state(jstep.abstract_params(jcfg))
    jm = _by_path(jopt.m)
    for name, p in params.named_parameters():
        path, layer = lm.jax_path(name)
        want = jparams[path]
        lead = (lm.STACKED[path.split("/")[0]](cfg),) if layer >= 0 else ()
        assert p.is_meta and lead + tuple(p.shape) == want.shape, name
        assert p.dtype == _dtype(want.dtype), name
        assert lead + tuple(opt.m[name].shape) == jm[path].shape
        assert opt.m[name].dtype == opt.v[name].dtype == torch.float32
    assert tuple(opt.step.shape) == jopt.step.shape == ()
    assert opt.step.dtype == _dtype(jopt.step.dtype)
    sp = SHAPES["decode_32k"]
    state = step.abstract_decode_state(cfg, params, sp.global_batch,
                                       sp.seq_len)
    for path, a, b in _state_pairs(state, _jax_state(arch, sp.global_batch,
                                                      sp.seq_len)):
        assert a.is_meta and tuple(a.shape) == b.shape, path
        assert a.dtype == _dtype(b.dtype), path


def test_roofline_terms_are_the_jax_formula(monkeypatch):
    """The formula of ``src/repro/launch/roofline.py`` with the H100
    constants passed in; the link rate of both production meshes is the
    inter-node one."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.IB_BW)
    for args in ((1.37e16, 1.07e14, 1.5e11, 256, True),
                 (5e12, 3e12, 0.0, 512, True),
                 (4e13, 8e10, 2e9, 256, False)):
        assert roofline.roofline_terms(*args) == \
            jroofline.roofline_terms(*args)
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    for sizes, _ in MESHES.values():
        assert roofline.collective_bw(sizes) == roofline.IB_BW
    assert roofline.collective_bw((1, 8)) == roofline.NVLINK_BW
    assert roofline.collective_bw((1, 1)) == roofline.NVLINK_BW


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mp = abstract_mesh(*MESHES["2pod"])
    assert placements(P(("pod", "data"), None, "model"), mp) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "model"), mp) == \
        [Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod")), mp)
    with pytest.raises(ValueError, match="axis sizes"):
        abstract_mesh((16, 16), ("data",))


@pytest.mark.parametrize("h,n_kv,tp", [(4, 2, 4), (16, 8, 4), (8, 1, 2),
                                       (12, 4, 4), (16, 8, 16)])
def test_local_kv_heads_are_the_global_groups(h, n_kv, tp):
    """Local q head j of rank r reads local K/V head j // (H_local /
    n_kv_local) of the cut, which is global head (r H_local + j) // (H /
    n_kv)."""
    hl = h // tp
    for rank in range(tp):
        idx = attention.local_kv_heads(h, n_kv, tp, rank)
        rep = hl // len(idx)
        assert hl % len(idx) == 0
        for j in range(hl):
            assert idx[j // rep] == (rank * hl + j) // (h // n_kv)


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharding") / "child.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def test_collective_bytes_hand_count(child):
    """A column- then row-parallel MLP on a fake (1, 2) mesh: one all-reduce
    of B x S x d bf16 and nothing else."""
    c = child["mlp"]["counts"]
    assert c["all-reduce"] == child["mlp"]["want"] and c["count"] == 1
    assert sum(v for k, v in c.items() if k not in ("all-reduce", "count")) \
        == 0


def _gemm_flops(cfg, b, s, last_only=False, train=False):
    """The products of one step by hand: per layer q/k/v/o and the SwiGLU,
    the dense route's scores and P V (both over all S x S), the unembed
    (the last position in a prefill, every chunk in training).  A train
    step with remat runs them four times (forward, recompute, two in the
    backward), but for each layer's last product, w_down: the recompute
    stops after the last tensor the backward needs (``torch.utils.
    checkpoint``'s early stop), which is w_down's input."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_ff
    t = b * s
    down = 2 * t * f * d
    layer = 2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d \
        + 2 * 2 * t * d * f + 2 * 2 * b * h * s * s * hd
    head = 2 * b * (1 if last_only else s) * d * cfg.vocab
    if train:
        return cfg.n_layers * (4 * layer + 3 * down) + 4 * head
    return cfg.n_layers * (layer + down) + head


def test_dryrun_flops_are_the_hand_count(child):
    from repro_torch.configs import get_arch
    cfg = get_arch("qwen3-1.7b").reduced()
    assert child["status"] == {"train_4k": "ok", "prefill_32k": "ok"}
    tr, pf = SHAPES["train_4k"], SHAPES["prefill_32k"]
    assert child["flops"]["train_4k"] == _gemm_flops(
        cfg, tr.global_batch, tr.seq_len, train=True)
    # prefill_32k takes the chunked route (S >= CHUNKED_SEQ): every chunk
    assert child["flops"]["prefill_32k"] == _gemm_flops(
        cfg, pf.global_batch, pf.seq_len, last_only=True)


def test_flash_on_local_heads_with_replicated_kv(child):
    """H=4, n_kv=2 on four model ranks: each rank's one q head reads its
    K/V head of the global index; its output equals the global
    ``mha_plain``'s slice."""
    assert len(child["local_heads"]) == 4
    assert max(child["local_heads"]) <= 1e-6
