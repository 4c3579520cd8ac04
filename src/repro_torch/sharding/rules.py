"""Named sharding rules: FSDP(data[,pod]) x TP(model) x EP-as-TP (the JAX
package's ``sharding/rules.py`` on DTensor terms).

Rules are path+shape driven and divisibility-guarded: a dim shards on an
axis only if it divides evenly (whole attention heads, whole experts'
hidden columns, ...), else that dim is replicated and the fallback is
recorded -- the dry-run report surfaces every fallback.

Conventions (mesh axes: ["pod",] "data", "model"):
* column-parallel projections (wq, w_gate, w_up, cm_wk, w_z/w_x ...):
    [d_model -> FSDP, out -> "model"]
* row-parallel projections (wo, w_down, cm_wv, w_out):
    [in -> "model", d_model -> FSDP]
* embedding table: [vocab -> "model", d_model -> FSDP]
* small vectors / norms / router: replicated.

The rules are evaluated on the JAX tree's leaves: a stacked leaf ``[L,
...]`` with a leading ``None``, once a JAX path, so ``FALLBACKS`` holds one
entry a path as the reference's.  A port parameter (one a layer,
``models.lm.jax_path``) takes the spec of its path with the stacked dim
dropped.  The reference's ``_shape`` leaves (ssm, hybrid) are no
parameters here; the reference gives them a replicated spec and records
no fallback for them.

A spec ``P`` is a tuple with one entry a dim: ``None``, an axis name, or
a tuple of axis names (JAX's ``PartitionSpec``).  ``placements`` turns it
into DTensor placements on a ``DeviceMesh``, ``shard_tree`` distributes a
module's parameters or a tree of tensors by it.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from .compat import AbstractMesh, mesh_shape

FALLBACKS: List[str] = []  # cleared/read by the dry-run report


class P(tuple):
    """A partition spec: ``P(("pod", "data"), None, "model")``.  A tuple
    of one axis name is that name, as ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


POD_DATA = ("pod", "data")
# DeviceMesh -> its view for DTensors (made once, outside FakeTensorMode)
_VIEWS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def dtensor_mesh(mesh):
    """The mesh DTensors live on for ``mesh`` (a ``DeviceMesh``): ``mesh``
    itself, or, when it has both "pod" and "data", its view with the two
    flattened into one dim "pod_data" (then "model").  The rules name
    "pod" and "data" only together and in that order (the FSDP axes), so
    the view loses nothing; and DTensor before torch 2.13 lays out no op
    (the embedding's ``index``, the rules built on ``dim_map``) whose
    input shards one tensor dim on two mesh dims."""
    names = mesh.mesh_dim_names
    if not all(a in names for a in POD_DATA):
        return mesh
    if mesh not in _VIEWS:
        mesh[POD_DATA]._flatten("pod_data")
        _VIEWS[mesh] = mesh[("pod_data",) + tuple(a for a in names
                                                  if a not in POD_DATA)]
    return _VIEWS[mesh]


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` (a ``P`` or a ``NamedSharding``) on
    ``mesh``: ``Shard(d)`` on every mesh dim that dim ``d`` names, in mesh
    order, ``Replicate()`` elsewhere.  On an ``AbstractMesh`` a tuple such
    as ``("pod", "data")`` is one ``Shard(d)`` on each of its dims; on a
    ``DeviceMesh`` the placements are those on ``dtensor_mesh(mesh)``, where
    ("pod", "data") is the one dim "pod_data"."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    if isinstance(mesh, AbstractMesh) or not all(a in names
                                                 for a in POD_DATA):
        return out
    pod, data = (names.index(a) for a in POD_DATA)
    if out[pod] != out[data]:
        raise ValueError(f"spec {spec}: 'pod' and 'data' apart")
    return [p for i, p in enumerate(out) if i != data]


def _size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes])) if axes else 1


def _div(n: int, mesh, *axes: str) -> bool:
    return n % _size(mesh, axes) == 0


def _fsdp_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _col(mesh, shape, name: str) -> P:
    """[in=d_model, out=tp] with stacked leading dims skipped."""
    lead = (None,) * (len(shape) - 2)
    din, dout = shape[-2], shape[-1]
    fsdp = _fsdp_axes(mesh)
    a0 = fsdp if _div(din, mesh, *fsdp) else None
    a1 = "model" if _div(dout, mesh, "model") else None
    if a1 is None:
        FALLBACKS.append(f"{name}: out dim {dout} !% model -> replicated")
    return P(*lead, a0, a1)


def _row(mesh, shape, name: str) -> P:
    lead = (None,) * (len(shape) - 2)
    din, dout = shape[-2], shape[-1]
    fsdp = _fsdp_axes(mesh)
    a0 = "model" if _div(din, mesh, "model") else None
    a1 = fsdp if _div(dout, mesh, *fsdp) else None
    if a0 is None:
        FALLBACKS.append(f"{name}: in dim {din} !% model -> replicated")
    return P(*lead, a0, a1)


def _repl(shape, name: str, why: str) -> P:
    FALLBACKS.append(f"{name}: {why}")
    return P(*(None,) * len(shape))


def _rule(cfg: ModelConfig, mesh, name: str, shape) -> P:
    """The spec of the JAX tree's leaf ``name`` (its path, ``/``-joined)
    of ``shape`` (stacked leaves with their leading layer dim)."""
    tp = mesh_shape(mesh)["model"]
    heads_ok = cfg.n_heads % tp == 0
    kv_ok = cfg.n_kv % tp == 0 if cfg.n_kv else False
    last = name.split("/")[-1]
    # --- embeddings -----------------------------------------------------
    if last == "table":
        fsdp = _fsdp_axes(mesh)
        v_ax = "model" if _div(shape[0], mesh, "model") else None
        d_ax = fsdp if _div(shape[1], mesh, *fsdp) else None
        if v_ax is None:
            FALLBACKS.append(f"{name}: vocab {shape[0]} !% model")
        return P(v_ax, d_ax)
    # --- attention -------------------------------------------------------
    if last == "wq":
        return _col(mesh, shape, name) if heads_ok else \
            _repl(shape, name, "q heads !% tp")
    if last in ("wk", "wv"):
        return _col(mesh, shape, name) if kv_ok else \
            _repl(shape, name, "kv heads < tp (GQA): replicated")
    if last == "wo":
        return _row(mesh, shape, name) if heads_ok else \
            _repl(shape, name, "q heads !% tp")
    # --- dense / shared MLP ----------------------------------------------
    if last in ("w_gate", "w_up", "cm_wk", "w_z", "w_x", "w_r",
                "w_k", "w_v", "w_g", "w_decay", "w_dt"):
        return _col(mesh, shape, name)
    if last in ("w_down", "cm_wv", "w_out", "w_o"):
        return _row(mesh, shape, name)
    if last in ("b_up",):
        lead = (None,) * (len(shape) - 1)
        return P(*lead, "model" if _div(shape[-1], mesh, "model") else None)
    if last == "conv_w":
        lead = (None,) * (len(shape) - 2)
        return P(*lead, None,
                 "model" if _div(shape[-1], mesh, "model") else None)
    if last in ("a_log", "d_skip", "dt_bias"):
        lead = (None,) * (len(shape) - 1)
        return P(*lead, "model" if _div(shape[-1], mesh, "model") else None)
    if last == "bonus":
        lead = (None,) * (len(shape) - 2)
        return P(*lead, "model" if _div(shape[-2], mesh, "model") else None,
                 None)
    # everything else (norms, router, mixes, biases): replicate
    return P(*(None,) * len(shape))


def param_specs(cfg: ModelConfig, mesh, params: nn.Module) -> Dict[str, P]:
    """{parameter name: spec} for the port's ``models.lm.LM`` (on any
    device; ``train.step.abstract_params`` gives it on ``meta``).  Each
    JAX path is ruled once, on its stacked shape, in the JAX tree's leaf
    order (``lm.named_leaves``), so ``FALLBACKS`` grows as the
    reference's; a per-layer parameter takes its path's spec without the
    stacked dim."""
    from ..models import lm
    by_path: Dict[str, P] = {}
    out: Dict[str, P] = {}
    for name, p in lm.named_leaves(params):
        path, layer = lm.jax_path(name)
        if path not in by_path:
            head = path.split("/")[0]
            shape = tuple(p.shape)
            if layer >= 0:
                shape = (lm.STACKED[head](cfg),) + shape
            by_path[path] = _rule(cfg, mesh, path, shape)
        spec = by_path[path]
        out[name] = P(*spec[1:]) if layer >= 0 else spec
    return out


def batch_specs(cfg: ModelConfig, mesh, batch_shape: Dict[str, Any],
                ) -> Dict[str, P]:
    """Input shardings: batch dim over FSDP axes (replicated if batch=1)."""
    fsdp = _fsdp_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        b = v.shape[0]
        b_ax = fsdp if _div(b, mesh, *fsdp) and b > 1 else None
        out[k] = P(b_ax, *(None,) * (len(v.shape) - 1))
    return out


def _walk(tree, fn, key: str = ""):
    """``tree`` with ``fn(key, leaf)`` at each tensor leaf: NamedTuples by
    field name, dicts by key, tuples and lists with key ""; other leaves
    (Python ints, None) stay."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), fn, f)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _walk(v, fn, str(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, fn, "") for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(key, tree)
    return None


def decode_state_specs(cfg: ModelConfig, mesh, state_shape: Any) -> Any:
    """KV caches / SSM states: batch over FSDP, heads on model where whole,
    else cache *sequence* on model (flash-decoding-style split).  The
    port's ``lm.DecodeState`` as it is: stacked caches and states, the
    Python-int ``length`` and ``pos`` without a spec (None)."""
    tp = mesh_shape(mesh)["model"]
    fsdp = _fsdp_axes(mesh)
    n_fsdp = _size(mesh, fsdp)

    def rule(last, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if last in ("k", "v") and len(shape) >= 4:
            # [L, B, S, n_kv, hd] (stacked) or [B, S, n_kv, hd]
            lead = (None,) * (len(shape) - 4)
            b, s, kv, hd = shape[-4:]
            b_ax = fsdp if b % n_fsdp == 0 and b > 1 else None
            if kv % tp == 0:
                return P(*lead, b_ax, None, "model", None)
            if s % tp == 0 and s > tp:
                return P(*lead, b_ax, "model", None, None)
            return P(*lead, b_ax, None, None, None)
        if last in ("h", "s") and len(shape) >= 4:
            # mamba [L,B,H,dh,ds], rwkv [L,B,H,dh,dh]
            lead = (None,) * (len(shape) - 4)
            b, h = shape[-4], shape[-3]
            b_ax = fsdp if b % n_fsdp == 0 and b > 1 else None
            h_ax = "model" if h % tp == 0 else None
            return P(*lead, b_ax, h_ax, None, None)
        # conv tails, token shifts, cross-kv, misc: replicated
        return P(*(None,) * len(shape))

    return _walk(state_shape, rule)


def _distribute(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    if leaf.is_meta:
        leaf = torch.empty(leaf.shape, dtype=leaf.dtype,
                           device=mesh.device_type)
    return distribute_tensor(leaf.detach(), dtensor_mesh(mesh),
                             placements(spec, mesh))


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` distributed on ``mesh`` (a ``DeviceMesh``) by ``specs``
    (``P`` or ``NamedSharding`` leaves).  A module (``specs``: {parameter
    name: spec}) has each parameter replaced in place by a DTensor
    parameter and is returned; a dict, NamedTuple, tuple or list of tensors
    (``specs`` of the same structure) is returned as DTensors, its
    non-tensor leaves as they are.  A ``meta`` leaf is made on the mesh's
    device type first, in the caller's mode: the dry-run's
    ``FakeTensorMode`` allocates nothing."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod_name, _, attr = name.rpartition(".")
            mod = tree.get_submodule(mod_name)
            setattr(mod, attr, nn.Parameter(_distribute(p, specs[name],
                                                        mesh),
                                            requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_tree(t, s, mesh)
                            for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_tree(t, s, mesh) for t, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return _distribute(tree, specs, mesh)
    return tree
