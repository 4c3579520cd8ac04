"""State carried across from the JAX package, given as numpy arrays.

The parity tests feed the port the reference's trained LERN model and
mid-run LLC state through these, so the LLC engine and the host loop are
held to the reference apart from the k-means fit.  For the model zoo,
``lm_numpy_params`` makes one seeded numpy parameter tree in the JAX
package's layout, which both packages take (the JAX functions as ``jnp``
arrays of the tree's types, the port through ``lm_params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import device as _device
from .core.lern import LernModel
from .core.llc import LLCState
from .core.lrpt import lrpt_train_hash
from .configs.base import ModelConfig


def lern_model_from_numpy(uniq: np.ndarray, rc_cluster: np.ndarray,
                          ri_cluster: np.ndarray, n_uniq: np.ndarray,
                          rc_centers: np.ndarray, ri_centers: np.ndarray,
                          features_ri: List[np.ndarray],
                          lrpt_variant: str = "full") -> LernModel:
    """The port's ``LernModel`` from the fields of a reference
    ``LernModel``.  Its training hash is rebuilt from ``lrpt_variant``
    (the reference's hash object belongs to the JAX package)."""
    return LernModel(
        uniq=np.asarray(uniq, np.int64),
        rc_cluster=np.asarray(rc_cluster, np.int8),
        ri_cluster=np.asarray(ri_cluster, np.int8),
        n_uniq=np.asarray(n_uniq, np.int32),
        rc_centers=np.asarray(rc_centers, np.float32),
        ri_centers=np.asarray(ri_centers, np.float32),
        features_ri=[np.asarray(f, np.int64) for f in features_ri],
        hash_fn=lrpt_train_hash(lrpt_variant))


def llc_state_from_numpy(tags, lru, owner, sig, reused, tick, shct_core,
                         shct_accel, device="cuda") -> LLCState:
    """The port's ``LLCState`` on ``device`` from the eight arrays of a
    reference ``LLCState``."""
    dev = _device.resolve(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return LLCState(tags=t(tags), lru=t(lru), owner=t(owner), sig=t(sig),
                    reused=t(reused, torch.bool), tick=t(tick),
                    shct_core=t(shct_core), shct_accel=t(shct_accel))


def bf16_round(a: np.ndarray) -> np.ndarray:
    """Round f32 values to the nearest bf16 (ties to even) in place, kept
    as f32 (numpy has no bf16), in chunks to bound the temporaries."""
    u = a.reshape(-1).view(np.uint32)
    step = 1 << 24
    for i in range(0, u.size, step):
        c = u[i:i + step]
        c += np.uint32(0x7FFF) + ((c >> np.uint32(16)) & np.uint32(1))
        c &= np.uint32(0xFFFF0000)
    return a


def _dense_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The dense family's parameter leaves as path -> (shape, fan-in scale
    or None for a norm scale of ones), in the JAX package's layout (layers
    stacked on axis 0)."""
    d, n, hd, f = cfg.d_model, cfg.n_layers, cfg.d_head, cfg.d_ff
    out = {"embed/table": ((cfg.vocab, d), 0.02), "ln_f/scale": ((d,), None),
           "layers/ln1/scale": ((n, d), None),
           "layers/ln2/scale": ((n, d), None)}
    for name, shape in (("wq", (d, cfg.n_heads * hd)),
                        ("wk", (d, cfg.n_kv * hd)),
                        ("wv", (d, cfg.n_kv * hd)),
                        ("wo", (cfg.n_heads * hd, d))):
        out[f"layers/attn/{name}"] = ((n,) + shape, 1 / math.sqrt(shape[0]))
    if cfg.qk_norm:
        out["layers/attn/q_norm"] = ((n, hd), None)
        out["layers/attn/k_norm"] = ((n, hd), None)
    mlp = ((("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))
           if cfg.act != "gelu" else
           (("w_up", (d, f)), ("w_down", (f, d))))
    for name, shape in mlp:
        out[f"layers/mlp/{name}"] = ((n,) + shape, 1 / math.sqrt(shape[0]))
    if cfg.act == "gelu":
        out["layers/mlp/b_up"] = ((n, f), 0.0)
        out["layers/mlp/b_down"] = ((n, d), 0.0)
    return out


def lm_numpy_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """A seeded parameter tree of the dense family in the JAX package's
    layout: nested dicts with the shapes of ``jax.eval_shape(
    lm.init_params)``, the JAX package's scales (0.02 for the table,
    1/sqrt(fan_in) for the weights, ones for the norm scales), f32 normal
    draws from ``numpy.random.default_rng(seed)`` in the order of
    ``_dense_layout``, rounded to bf16 and held as f32 arrays.  Every value
    is exact in its leaf's type (bf16 weights, f32 norm scales)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: ROADMAP.md "
            f"Queue 1 item 13")
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, scale) in _dense_layout(cfg).items():
        if scale is None:
            a = np.ones(shape, np.float32)
        elif scale == 0.0:
            a = np.zeros(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(scale)
            bf16_round(a)
        flat[path] = a
    return _nest(flat)


def lm_params_from_numpy(tree: Dict, cfg: ModelConfig, device="cuda"):
    """The port's ``models.lm.LM`` on ``device`` holding the values of
    ``tree`` (the JAX package's layout, as ``lm_numpy_params`` makes it):
    the stacked layer axis is split over the blocks, each leaf is cast to
    its parameter's type."""
    from .models import lm
    dev = _device.resolve(device)
    lm._dense_only(cfg)
    model = lm.LM(None, cfg, dev)
    with torch.no_grad():
        for name, a in _unstack(cfg, tree):
            model.get_parameter(name).copy_(a)
    return model


def _names(cfg: ModelConfig, path: str) -> List[str]:
    """The module's parameter names that hold ``path`` of the JAX layout:
    one a block for a stacked ``layers`` leaf."""
    head, rest = path.split("/", 1)
    if head != "layers":
        return [path.replace("/", ".")]
    return [f"layers.{i}.{rest.replace('/', '.')}"
            for i in range(cfg.n_layers)]


def _unstack(cfg: ModelConfig, tree: Dict):
    """(parameter name, f32 CPU tensor) for each leaf of a tree in the JAX
    layout (numpy arrays or tensors), the stacked leaves split over the
    blocks."""
    for path in _dense_layout(cfg):
        a = tree
        for key in path.split("/"):
            a = a[key]
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32)
        else:
            a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        names = _names(cfg, path)
        for i, name in enumerate(names):
            yield name, (a[i] if path.startswith("layers/") else a)


def _stack(cfg: ModelConfig, get) -> Dict[str, torch.Tensor]:
    """path -> a new CPU tensor of the JAX layout, from ``get(name)`` of
    each parameter name, the blocks stacked on axis 0."""
    flat = {}
    for path in _dense_layout(cfg):
        ts = [get(name).detach().cpu() for name in _names(cfg, path)]
        flat[path] = (torch.stack(ts) if path.startswith("layers/")
                      else ts[0].clone())
    return flat


def _nest(flat: Dict[str, object]) -> Dict:
    tree: Dict = {}
    for path, a in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = a
    return tree


def lm_tree_from_params(params, cfg: ModelConfig) -> Dict:
    """The port's module as a tree of the JAX package's layout: nested
    dicts of new CPU tensors in the parameters' types, the blocks stacked
    on axis 0."""
    from .models import lm
    lm._dense_only(cfg)
    return _nest(_stack(cfg, params.get_parameter))


def lm_numpy_from_params(params, cfg: ModelConfig) -> Dict:
    """The inverse of ``lm_params_from_numpy``: the module's values as a
    numpy tree of the JAX package's layout (f32 arrays, every value exact in
    its parameter's type, as ``lm_numpy_params`` makes them)."""
    from .models import lm
    lm._dense_only(cfg)
    return _nest({k: t.float().numpy()
                  for k, t in _stack(cfg, params.get_parameter).items()})


def opt_state_to_numpy(state, cfg: ModelConfig):
    """The port's ``optim.OptState`` (moments keyed by the module's
    parameter names) as the JAX package's: ``m`` and ``v`` as f32 numpy
    trees of its layout (blocks stacked), ``step`` a 0-d int32 array."""
    from .models import lm
    from .optim import OptState
    lm._dense_only(cfg)

    def tree(moments):
        return _nest({k: t.numpy()
                      for k, t in _stack(cfg, moments.__getitem__).items()})

    return OptState(m=tree(state.m), v=tree(state.v),
                    step=np.asarray(int(state.step), np.int32))


def opt_state_from_numpy(state, cfg: ModelConfig, device="cuda"):
    """The inverse of ``opt_state_to_numpy``: a JAX ``OptState``'s fields
    (numpy arrays or tensors in the JAX layout) as the port's ``OptState``
    on ``device``, the stacked moments split over the blocks."""
    from .models import lm
    from .optim import OptState
    dev = _device.resolve(device)
    lm._dense_only(cfg)
    m, v, step = state

    def moments(tree):
        return {name: a.to(dev, copy=True) for name, a in _unstack(cfg, tree)}

    step = torch.as_tensor(np.asarray(step), dtype=torch.int32,
                           device=dev).reshape(())
    return OptState(m=moments(m), v=moments(v), step=step)
