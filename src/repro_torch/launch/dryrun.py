"""Multi-pod dry-run (the JAX package's ``launch/dryrun.py``): every
(architecture x input shape x mesh) cell run once on DTensor parameters
over a fake process group, nothing allocated.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        --out .cache/dryrun_torch

``main()`` (never the import) starts a process group of 256 ranks (512
with ``--multi-pod``) on ``torch.testing``'s fake backend: collectives
return at once and this process plays rank 0, the counterpart of the JAX
file's 512 placeholder CPU devices.  Each cell writes a JSON record with
the reference's keys: memory, cost, collective bytes, roofline terms on
H100 constants (``launch.roofline``), sharding fallbacks.

A cell runs the reference cell's step once with its routes (``use_flash``
off): the train step with remat, the prefill step or the serve step, on
the abstract parameters, optimizer state, batch and decode state
(``train.step``) distributed by the rules (``sharding``) under
``FakeTensorMode``, with the activation constraints set by the
reference's batch test.  What it counts:

* ``cost``: FLOPs and bytes from ``_TopLevel``, both global: counted at
  the DTensor level, and inside a local computation (attention on local
  heads, the experts, the recurrences) times the ranks that split it (the
  reference's "unrolled-lowered (global, pre-SPMD)" convention).  The FLOPs
  are ``FlopCounterMode``'s formulas, the matrix products and attention
  ops only, where XLA's count includes the elementwise ops; the
  recurrences count every time step's products, where XLA counts a while
  loop's body once.  The bytes sum each non-view op's operand and result
  bytes (the collectives are counted apart).
* ``collectives``: the result bytes on rank 0 of every functional
  collective DTensor issued (``roofline.CollectiveBytes``).
* ``memory``: ``argument_bytes`` / ``output_bytes``, the local shards of
  the step's inputs and outputs on rank 0; ``temp_bytes``, the most local
  bytes alive at once among the storages the step's ops take and give at
  the DTensor level, its inputs left out (``_TopLevel``; a collective's
  buffer inside one DTensor op is not seen); ``peak_bytes`` the two
  added.
* ``lower_s`` is the fake run's seconds; ``compile_s`` is 0: nothing is
  compiled (the port runs eagerly).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ..configs import ARCHS, SHAPES, get_arch
from ..models import layers, lm, ssm
from ..models import moe as moe_mod
from ..sharding import rules
from ..sharding.compat import mesh_shape
from ..train import step as step_mod
from . import roofline as rl
from .roofline import _nbytes
from .mesh import make_production_mesh

def _scan_formulas() -> None:
    """The recurrences' FLOPs for the counters: S time steps forward, three
    times that for the backward (the recompute and both products'
    gradients)."""
    for name, step_flops in ssm.SCAN_FLOPS.items():
        op, grad, _ = ssm._SCANS[name]
        register_flop_formula(op)(
            lambda *sh, f=step_flops, out_shape=None, **kw:
            sh[0][1] * f(sh[0], sh[5]))
        register_flop_formula(grad)(
            lambda *sh, f=step_flops, out_shape=None, **kw:
            3 * sh[0][1] * f(sh[0], sh[5]))


_scan_formulas()

CONVENTION = ("DTensor-level (global, pre-partition; local computations "
              "times their split): FlopCounterMode's GEMM/attention "
              "formulas, operand+result bytes of every non-view op")


def start_fake_world(world_size: int) -> None:
    """The default process group: ``world_size`` ranks on the fake
    backend, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class _TopLevel(TorchDispatchMode):
    """Sees every op at the DTensor level (DTensors at their global
    shapes): ``flops``, by ``FlopCounterMode``'s formulas (products and
    attention ops; the recurrences by theirs, ``models.ssm``), and
    ``bytes``, the operand + result bytes of each op that is not a view or
    a collective -- both global: a plain op of a local computation counts
    times the ranks that split it (``layers.local_split()`` in the forward;
    in the backward and the recompute the split its operands' storages
    were made with, passed on to its results); ``peak``, the most local
    bytes alive at once among the storages that the ops take and give (a
    DTensor's local shard, a plain tensor as it is), each counted from its
    first sight to its release.  Storages passed to ``known`` (the step's
    inputs) do not count."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._ids: Dict[int, bool] = {}
        self._split: Dict[int, int] = {}

    def known(self, tensors) -> None:
        for t in tensors:
            self._ids[id(_local(t).untyped_storage())] = False

    def _drop(self, key: int, n: int) -> None:
        self._ids.pop(key, None)
        self._split.pop(key, None)
        self.live -= n

    def _see(self, tensors, outs, split: int) -> None:
        for t in tensors:
            st = _local(t).untyped_storage()
            if id(st) in self._ids:
                continue
            n = st.nbytes()
            self._ids[id(st)] = True
            weakref.finalize(st, self._drop, id(st), n)
            self.live += n
        self.peak = max(self.peak, self.live)
        if split > 1:
            for t in outs:
                self._split[id(t.untyped_storage())] = split

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _flat(list(args)) + _flat(list(kwargs.values()))
        outs = _flat(out)
        split = 1
        if not any(issubclass(t, DTensor) for t in types):
            split = max([layers.local_split()] + [
                self._split.get(id(t.untyped_storage()), 1) for t in ins])
        formula = flop_registry.get(getattr(func, "_overloadpacket", None))
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out) * split
        if not getattr(func, "is_view", False) and not \
                str(func).startswith("_c10d_functional"):
            self.bytes += sum(_nbytes(t) for t in ins + outs) * split
        self._see(ins + outs, outs, split)
        return out


def _set_constraints(mesh, sp) -> None:
    """The reference's batch test: batch on the FSDP axes where the global
    batch allows, vocab on "model"."""
    fsdp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    NS, P = rules.NamedSharding, rules.P
    if sp.global_batch % (2 ** len(fsdp) * 16) == 0 or sp.global_batch >= 32:
        lm.ACT_SPEC = NS(mesh, P(fsdp, None, None))
        lm.LOGITS_SPEC = NS(mesh, P(fsdp, None, "model"))
        moe_mod.BATCH_SPEC = NS(mesh, P(fsdp))
    else:
        lm.ACT_SPEC = None
        lm.LOGITS_SPEC = NS(mesh, P(None, None, "model"))
        moe_mod.BATCH_SPEC = None


def _clear_constraints() -> None:
    lm.ACT_SPEC = None
    lm.LOGITS_SPEC = None
    moe_mod.BATCH_SPEC = None


def _run_step(cfg, arch, shape, sp, mesh):
    """Distribute the cell's inputs and run its step once under the
    counters; (memory, cost, collectives)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params_shape = step_mod.abstract_params(cfg)
        state = None
        if sp.kind == "decode":
            state = step_mod.abstract_decode_state(
                cfg, params_shape, sp.global_batch, sp.seq_len)
        pspecs = rules.param_specs(cfg, mesh, params_shape)
        params = rules.shard_tree(params_shape, pspecs, mesh)
        batch_shape = step_mod.input_specs(arch, shape)
        batch = rules.shard_tree(batch_shape, rules.batch_specs(
            cfg, mesh, batch_shape), mesh)
        if sp.kind == "train":
            opt = step_mod.abstract_opt_state(params)  # moments as params
            fn = step_mod.make_train_step(cfg, remat=True, device="cpu")
            args = (params, opt, batch)
        elif sp.kind == "prefill":
            fn = step_mod.make_prefill_step(cfg)
            args = (params, batch)
        else:
            state = rules.shard_tree(state, rules.decode_state_specs(
                cfg, mesh, state), mesh)
            fn = step_mod.make_serve_step(cfg)
            args = (params, state, batch["tokens"])
        arg_tensors = _flat(list(args))
        coll = rl.CollectiveBytes()
        top = _TopLevel()
        top.known(arg_tensors)
        with coll, top:
            out = fn(*args)
        out_tensors = _flat(out)
        arg_bytes = sum(_nbytes(_local(t)) for t in arg_tensors)
        mem = {"argument_bytes": arg_bytes,
               "output_bytes": sum(_nbytes(_local(t)) for t in out_tensors),
               "temp_bytes": top.peak,
               "peak_bytes": arg_bytes + top.peak}
        cost = {"flops": float(top.flops),
                "bytes_accessed": float(top.bytes),
                "convention": CONVENTION}
        return mem, cost, coll.counts()


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    """Run one (arch x shape) cell on the production mesh over the
    default (fake) process group; return the dry-run record."""
    cfg = get_arch(arch)
    sp = SHAPES[shape]
    if not cfg.runs(shape):
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": dict(cfg.skip_shapes)[shape]}
    rules.FALLBACKS.clear()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules.dtensor_mesh(mesh)          # made here, outside FakeTensorMode
    n_chips = mesh.size()
    t0 = time.time()
    _set_constraints(mesh, sp)
    try:
        mem, cost, coll = _run_step(cfg, arch, shape, sp, mesh)
    finally:
        _clear_constraints()
    t_lower = time.time() - t0
    coll_total = sum(v for k, v in coll.items() if k != "count")
    terms = rl.roofline_terms(cost["flops"], cost["bytes_accessed"],
                              coll_total, n_chips, cost_is_global=True,
                              link_bw=rl.collective_bw(mesh.shape))
    rec = {
        "arch": arch, "shape": shape, "kind": sp.kind,
        "mesh": mesh_shape(mesh), "chips": int(n_chips),
        "status": "ok",
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "memory": mem, "cost": cost, "collectives": coll,
        "collective_bytes": coll_total,
        "roofline": terms,
        "fallbacks": list(rules.FALLBACKS),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "chips", "status", "lower_s")}))
        print("  memory:", mem)
        print("  cost:", cost)
        print("  collectives:", coll_total, "bytes —", coll)
        print("  roofline:", terms)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=".cache/dryrun_torch")
    args = ap.parse_args()

    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    start_fake_world(512 if args.multi_pod else 256)
    os.makedirs(args.out, exist_ok=True)
    tag = "multipod" if args.multi_pod else "singlepod"
    failures = 0
    try:
        for arch, shape in cells:
            path = os.path.join(args.out, f"{arch}-{shape}-{tag}.json")
            if os.path.exists(path):
                print(f"cached: {path}")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=args.multi_pod)
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"FAIL {arch} {shape}: {e}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    finally:
        dist.destroy_process_group()
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
