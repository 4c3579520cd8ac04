"""State carried across from the JAX package, given as numpy arrays.

The parity tests feed the port the reference's trained LERN model and
mid-run LLC state through these, so the LLC engine and the host loop are
held to the reference apart from the k-means fit.  For the model zoo,
``lm_numpy_params`` makes one seeded numpy parameter tree in the JAX
package's layout, which both packages take (the JAX functions as ``jnp``
arrays of the tree's types, the port through ``lm_params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
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


def _attn_leaves(prefix: str, n: tuple, cfg: ModelConfig) -> Dict:
    """An attention block's wq, wk, wv, wo (no qk norm) under ``prefix``,
    stacked ``n`` (``()`` for one block)."""
    d, hd = cfg.d_model, cfg.d_head
    out = {}
    for name, shape in (("wq", (d, cfg.n_heads * hd)),
                        ("wk", (d, cfg.n_kv * hd)),
                        ("wv", (d, cfg.n_kv * hd)),
                        ("wo", (cfg.n_heads * hd, d))):
        out[f"{prefix}{name}"] = (n + shape, 1 / math.sqrt(shape[0]))
    return out


def _dense_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The dense family's parameter leaves as path -> (shape, fan-in scale
    or None for a norm scale of ones), in the JAX package's layout (layers
    stacked on axis 0)."""
    d, n, hd, f = cfg.d_model, cfg.n_layers, cfg.d_head, cfg.d_ff
    out = {"embed/table": ((cfg.vocab, d), 0.02), "ln_f/scale": ((d,), None),
           "layers/ln1/scale": ((n, d), None),
           "layers/ln2/scale": ((n, d), None)}
    out.update(_attn_leaves("layers/attn/", (n,), cfg))
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


@dataclasses.dataclass(frozen=True)
class Fill:
    """A layout leaf of one constant, not drawn.  ``meta``: a zero-filled
    ``_shape`` leaf that the JAX code reads shapes from; the port's module
    keeps it as Python ints, not as a parameter."""
    value: float
    meta: bool = False


def _moe_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The ``moe`` family's leaves: the dense layout without the MLP, then
    the router (scale 0.02), the stacked experts and the shared SwiGLU.
    The experts take the reference's scale 1/sqrt(shape[0]) of ``[E, d,
    f]``, whose fan-in is E (``src/repro/models/moe.py:58-60``)."""
    d, n, e, f = cfg.d_model, cfg.n_layers, cfg.n_experts, cfg.expert_d_ff
    out = {k: v for k, v in _dense_layout(cfg).items()
           if not k.startswith("layers/mlp/")}
    out["layers/moe/router"] = ((n, d, e), 0.02)
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        out[f"layers/moe/{name}"] = ((n,) + shape, 1 / math.sqrt(shape[0]))
    if cfg.n_shared_experts > 0:
        sf = f * max(cfg.n_shared_experts, 1)
        for name, shape in (("w_gate", (d, sf)), ("w_up", (d, sf)),
                            ("w_down", (sf, d))):
            out[f"layers/moe/shared/{name}"] = ((n,) + shape,
                                                1 / math.sqrt(shape[0]))
    return out


def _ssm_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The ``ssm`` (RWKV6) family's leaves, in ``rwkv_init``'s draw order:
    the mixes 0.5, ``decay_bias`` -6, ``bonus`` zeros, ``ln_x`` ones and
    the zero ``_shape`` leaf [n_heads, d_head] beside the drawn weights."""
    d, n, f, nh = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.ssm_heads
    dh = d // nh
    t = "layers/tm/"
    out = {"embed/table": ((cfg.vocab, d), 0.02), "ln_f/scale": ((d,), None),
           "layers/ln1/scale": ((n, d), None),
           "layers/ln2/scale": ((n, d), None)}
    for m in "rkvwg":
        out[f"{t}mix_{m}"] = ((n, d), Fill(0.5))
    for name in ("w_r", "w_k", "w_v", "w_g"):
        out[t + name] = ((n, d, d), 1 / math.sqrt(d))
    out[t + "w_decay"] = ((n, d, d), 0.01)
    out[t + "decay_bias"] = ((n, d), Fill(-6.0))
    out[t + "bonus"] = ((n, nh, dh), 0.0)
    out[t + "w_o"] = ((n, d, d), 1 / math.sqrt(d))
    out[t + "ln_x"] = ((n, d), None)
    out[t + "cm_mix_k"] = ((n, d), Fill(0.5))
    out[t + "cm_wk"] = ((n, d, f), 1 / math.sqrt(d))
    out[t + "cm_wv"] = ((n, f, d), 1 / math.sqrt(f))
    out[t + "_shape"] = ((n, nh, dh), Fill(0.0, meta=True))
    return out


def _hybrid_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The ``hybrid`` (Zamba2) family's leaves, in the JAX ``init_params``'
    order: the table, ``ln_f``, the stacked layers (``ln1``; ``mamba_init``'s
    weights, ``conv_w`` at scale 0.5, ``a_log`` and ``dt_bias`` zeros,
    ``d_skip`` ones and the zero ``_shape`` leaf [n_heads, d_head, d_state,
    d_conv]), then the one ``shared_attn`` block (``ln1``, ``ln2``, the
    attention and its SwiGLU)."""
    d, n, f, nh, ds = (cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.ssm_heads,
                       cfg.d_state)
    di, dc = 2 * d, 4                      # mamba_init's expand and d_conv
    m = "layers/mamba/"
    out = {"embed/table": ((cfg.vocab, d), 0.02), "ln_f/scale": ((d,), None),
           "layers/ln1/scale": ((n, d), None)}
    for name, shape in (("w_z", (d, di)), ("w_x", (d, di)),
                        ("w_b", (d, ds)), ("w_c", (d, ds)),
                        ("w_dt", (d, nh))):
        out[m + name] = ((n,) + shape, 1 / math.sqrt(d))
    out[m + "conv_w"] = ((n, dc, di), 0.5)
    out[m + "a_log"] = ((n, nh), 0.0)
    out[m + "d_skip"] = ((n, nh), None)
    out[m + "dt_bias"] = ((n, nh), 0.0)
    out[m + "w_out"] = ((n, di, d), 1 / math.sqrt(di))
    out[m + "_shape"] = ((n, nh, di // nh, ds, dc), Fill(0.0, meta=True))
    out["shared_attn/ln1/scale"] = ((d,), None)
    out["shared_attn/ln2/scale"] = ((d,), None)
    out.update(_attn_leaves("shared_attn/attn/", (), cfg))
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                        ("w_down", (f, d))):
        out[f"shared_attn/mlp/{name}"] = (shape, 1 / math.sqrt(shape[0]))
    return out


def _encdec_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The ``encdec`` (whisper) family's leaves, in the JAX ``init_params``'
    order: the table, ``ln_f`` (an RMSNorm), the stacked encoder layers
    (LayerNorms ``ln1`` and ``ln2``, the attention, the GELU MLP with zero
    biases), ``ln_enc``, then the stacked decoder layers (LayerNorms
    ``ln1``, ``ln_x``, ``ln2``, ``attn``, ``xattn``, the GELU MLP)."""
    d, f = cfg.d_model, cfg.d_ff
    out = {"embed/table": ((cfg.vocab, d), 0.02), "ln_f/scale": ((d,), None)}

    def layer(head, n, norms, attns):
        for ln in norms:
            out[f"{head}/{ln}/scale"] = ((n, d), None)
            out[f"{head}/{ln}/bias"] = ((n, d), 0.0)
        for a in attns:
            out.update(_attn_leaves(f"{head}/{a}/", (n,), cfg))
        out[f"{head}/mlp/w_up"] = ((n, d, f), 1 / math.sqrt(d))
        out[f"{head}/mlp/b_up"] = ((n, f), 0.0)
        out[f"{head}/mlp/w_down"] = ((n, f, d), 1 / math.sqrt(f))
        out[f"{head}/mlp/b_down"] = ((n, d), 0.0)

    layer("encoder", cfg.enc_layers, ("ln1", "ln2"), ("attn",))
    out["ln_enc/scale"] = ((d,), None)
    out["ln_enc/bias"] = ((d,), 0.0)
    layer("layers", cfg.n_layers, ("ln1", "ln_x", "ln2"), ("attn", "xattn"))
    return out


def _layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The parameter leaves of ``cfg``'s family as path -> (shape, scale):
    a fan-in scale, None for ones, 0.0 for zeros or a ``Fill``.  The
    ``vlm`` family's leaves are the dense family's."""
    from .models import lm
    lm._ported_only(cfg)
    return {"dense": _dense_layout, "moe": _moe_layout, "ssm": _ssm_layout,
            "vlm": _dense_layout, "hybrid": _hybrid_layout,
            "encdec": _encdec_layout}[cfg.family](cfg)


def _stacked(path: str) -> bool:
    """Whether a leaf of the JAX layout is stacked over layers."""
    from .models import lm
    return path.split("/", 1)[0] in lm.STACKED


def _is_meta(spec: tuple) -> bool:
    return isinstance(spec[1], Fill) and spec[1].meta


def lm_numpy_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """A seeded parameter tree of a ported family in the JAX package's
    layout: nested dicts with the shapes of ``jax.eval_shape(
    lm.init_params)``, the JAX package's scales (0.02 for the table,
    1/sqrt(fan_in) for the weights, ones for the norm scales) and
    constants, f32 normal draws from ``numpy.random.default_rng(seed)`` in
    the order of the family's layout (``_dense_layout`` for the dense
    family), rounded to bf16 and held as f32 arrays.  Every value is exact
    in its leaf's type (bf16 weights, f32 norm scales and constants)."""
    layout = _layout(cfg)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, scale) in layout.items():
        if scale is None:
            a = np.ones(shape, np.float32)
        elif isinstance(scale, Fill):
            a = np.full(shape, scale.value, np.float32)
        elif scale == 0.0:
            a = np.zeros(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(scale)
            bf16_round(a)
        flat[path] = a
    return _nest(flat)


# the frontends that both packages stub (SigLIP for vlm, whisper's conv
# frontend for encdec): batch key, length field of the config, and the
# standard deviation of the seeded stand-in embeddings (the token table's
# 0.02 for patches, the sinusoid's scale for audio frames)
FRONTEND_EMBEDS = {"vlm": ("patch_embeds", "prefix_len", 0.02),
                   "encdec": ("enc_embeds", "enc_seq", 1.0)}


def lm_numpy_embeds(cfg: ModelConfig, batch: int, seed: int = 0) -> Dict:
    """Seeded stand-ins for a stubbed frontend's output, the batch entries
    a ``vlm`` or ``encdec`` model reads besides the tokens: {key: [batch,
    length, d_model]} as f32 normal draws from ``numpy.random.default_rng(
    (seed, 1))`` times the key's standard deviation, rounded to bf16 (the
    type both packages feed them in); {} for the other families."""
    if cfg.family not in FRONTEND_EMBEDS:
        return {}
    key, length, std = FRONTEND_EMBEDS[cfg.family]
    rng = np.random.default_rng((seed, 1))
    a = rng.standard_normal((batch, getattr(cfg, length), cfg.d_model),
                            dtype=np.float32)
    a *= np.float32(std)
    return {key: bf16_round(a)}


def lm_params_from_numpy(tree: Dict, cfg: ModelConfig, device="cuda"):
    """The port's ``models.lm.LM`` on ``device`` holding the values of
    ``tree`` (the JAX package's layout, as ``lm_numpy_params`` makes it):
    the stacked layer axis is split over the blocks, each leaf is cast to
    its parameter's type."""
    from .models import lm
    dev = _device.resolve(device)
    lm._ported_only(cfg)
    model = lm.LM(None, cfg, dev)
    with torch.no_grad():
        for name, a in _unstack(cfg, tree):
            model.get_parameter(name).copy_(a)
    return model


def _names(cfg: ModelConfig, path: str) -> List[str]:
    """The module's parameter names that hold ``path`` of the JAX layout:
    one a block for a stacked ``layers`` or ``encoder`` leaf."""
    from .models import lm
    head, rest = path.split("/", 1)
    if head not in lm.STACKED:
        return [path.replace("/", ".")]
    return [f"{head}.{i}.{rest.replace('/', '.')}"
            for i in range(lm.STACKED[head](cfg))]


def _unstack(cfg: ModelConfig, tree: Dict):
    """(parameter name, f32 CPU tensor) for each leaf of a tree in the JAX
    layout (numpy arrays or tensors), the stacked leaves split over the
    blocks."""
    for path, spec in _layout(cfg).items():
        if _is_meta(spec):
            continue
        a = tree
        for key in path.split("/"):
            a = a[key]
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32)
        else:
            a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        names = _names(cfg, path)
        for i, name in enumerate(names):
            yield name, (a[i] if _stacked(path) else a)


def _stack(cfg: ModelConfig, get) -> Dict[str, torch.Tensor]:
    """path -> a new CPU tensor of the JAX layout, from ``get(name)`` of
    each parameter name, the blocks stacked on axis 0."""
    flat = {}
    for path, spec in _layout(cfg).items():
        if _is_meta(spec):
            flat[path] = torch.zeros(spec[0], dtype=torch.float32)
            continue
        ts = [get(name).detach().cpu() for name in _names(cfg, path)]
        flat[path] = torch.stack(ts) if _stacked(path) else ts[0].clone()
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
    lm._ported_only(cfg)
    return _nest(_stack(cfg, params.get_parameter))


def lm_numpy_from_params(params, cfg: ModelConfig) -> Dict:
    """The inverse of ``lm_params_from_numpy``: the module's values as a
    numpy tree of the JAX package's layout (f32 arrays, every value exact in
    its parameter's type, as ``lm_numpy_params`` makes them)."""
    from .models import lm
    lm._ported_only(cfg)
    return _nest({k: t.float().numpy()
                  for k, t in _stack(cfg, params.get_parameter).items()})


def opt_state_to_numpy(state, cfg: ModelConfig):
    """The port's ``optim.OptState`` (moments keyed by the module's
    parameter names) as the JAX package's: ``m`` and ``v`` as f32 numpy
    trees of its layout (blocks stacked), ``step`` a 0-d int32 array."""
    from .models import lm
    from .optim import OptState
    lm._ported_only(cfg)

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
    lm._ported_only(cfg)
    m, v, step = state

    def moments(tree):
        return {name: a.to(dev, copy=True) for name, a in _unstack(cfg, tree)}

    step = torch.as_tensor(np.asarray(step), dtype=torch.int32,
                           device=dev).reshape(())
    return OptState(m=moments(m), v=moments(v), step=step)
