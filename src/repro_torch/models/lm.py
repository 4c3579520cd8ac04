"""Model assembly for the decoder-only dense family (the JAX package's
``models/lm.py`` in PyTorch).

``init_params`` builds an ``nn.Module`` whose attribute tree is the JAX
parameter tree, with the stacked layer axis split into an
``nn.ModuleList`` of blocks; ``hidden`` and ``forward`` run the layers in
a Python loop where the JAX package scans, each layer under
``torch.utils.checkpoint`` where the JAX package wraps the scan body in
``jax.checkpoint`` (``remat=True``).  ``loss_fn`` is the JAX package's
chunked cross-entropy.  Three families are ported: ``dense``, ``moe`` (the
dense block with ``models.moe.dispatch`` in the MLP's place) and ``ssm``
(RWKV6 blocks, ``models.ssm``).  The ``hybrid``, ``encdec`` and ``vlm``
families are not ported yet (ROADMAP.md Queue 1 item 13d) and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod

PORTED_FAMILIES = ("dense", "moe", "ssm")


def _ported_only(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            f"ROADMAP.md Queue 1 item 13d")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class DenseBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device)
        self.ln2 = L.rmsnorm_init(cfg.d_model, device)
        self.attn = attn_mod.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            qk_norm=cfg.qk_norm, device=device)
        if cfg.act == "gelu":
            self.mlp = L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device)
        else:
            self.mlp = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, device)


class MoEBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device)
        self.ln2 = L.rmsnorm_init(cfg.d_model, device)
        self.attn = attn_mod.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            qk_norm=cfg.qk_norm, device=device)
        self.moe = moe_mod.moe_init(
            gen, cfg.d_model, cfg.expert_d_ff, cfg.n_experts,
            cfg.n_shared_experts,
            cfg.expert_d_ff * max(cfg.n_shared_experts, 1), device)


class RWKVBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device)
        self.ln2 = L.rmsnorm_init(cfg.d_model, device)
        self.tm = ssm_mod.rwkv_init(gen, cfg.d_model, cfg.ssm_heads,
                                    cfg.d_ff, device)


BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "ssm": RWKVBlock}


class LM(nn.Module):
    """``embed`` (the tied table), ``ln_f`` and ``layers`` (one block per
    layer: ``DenseBlock``, ``MoEBlock`` or ``RWKVBlock`` by family)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.embed = L.embedding_init(gen, cfg.vocab, cfg.d_model, device)
        self.ln_f = L.rmsnorm_init(cfg.d_model, device)
        block = BLOCKS[cfg.family]
        self.layers = nn.ModuleList(block(gen, cfg, device)
                                    for _ in range(cfg.n_layers))


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``),
    drawn in the order embed, then per layer wq, wk, wv, wo and the MLP's
    (``moe``: the router and the experts; ``ssm``: the RWKV weights); the
    scales and constants are the JAX package's (0.02 for the table and the
    router, 1/sqrt(fan_in) for the rest; bf16 weights, f32 norm scales and
    mixes)."""
    _ported_only(cfg)
    dev = _device.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, "
                         f"parameters on {dev}")
    return LM(gen, cfg, dev)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def _mlp(cfg: ModelConfig, lp, y: torch.Tensor) -> torch.Tensor:
    if cfg.family == "moe":
        return moe_mod.dispatch(lp.moe, y, top_k=cfg.top_k)
    if cfg.act == "gelu":
        return L.gelu_mlp(lp.mlp, y)
    return L.swiglu(lp.mlp, y)


def _dense_block(cfg: ModelConfig, lp, x, use_flash):
    h = attn_mod.attention(
        lp.attn, L.rmsnorm(lp.ln1, x), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, d_head=cfg.d_head, window=cfg.window,
        rope_theta=cfg.rope_theta, use_flash=use_flash)
    x = x + h
    return x + _mlp(cfg, lp, L.rmsnorm(lp.ln2, x))


def _rwkv_block(cfg: ModelConfig, lp, x, use_flash):
    """One RWKV6 layer over the whole sequence from a zero state and a zero
    shift (the reference's prefill); ``use_flash`` has no say here."""
    bsz = x.shape[0]
    s0 = torch.zeros((bsz, cfg.ssm_heads, cfg.d_head, cfg.d_head),
                     dtype=torch.float32, device=x.device)
    zero = torch.zeros((bsz, cfg.d_model), dtype=x.dtype, device=x.device)
    h, _ = ssm_mod.rwkv_time_mix(lp.tm, L.rmsnorm(lp.ln1, x), zero, s0)
    x = x + h
    return x + ssm_mod.rwkv_channel_mix(lp.tm, L.rmsnorm(lp.ln2, x), zero)


def _remat(remat: bool) -> bool:
    """Recompute in the backward only where a graph is being recorded."""
    return remat and torch.is_grad_enabled()


def hidden(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
           use_flash: bool = False, remat: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] over the token positions.
    ``remat``: keep only each layer's input for the backward and recompute
    the layer there (``jax.checkpoint`` of the JAX scan body)."""
    _ported_only(cfg)
    block = _rwkv_block if cfg.family == "ssm" else _dense_block
    x = L.embed(params.embed, batch["tokens"])
    for lp in params.layers:
        if _remat(remat):
            x = checkpoint(block, cfg, lp, x, use_flash,
                           use_reentrant=False)
        else:
            x = block(cfg, lp, x, use_flash)
    return L.rmsnorm(params.ln_f, x)


def forward(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            use_flash: bool = False, remat: bool = False,
            last_only: bool = False) -> torch.Tensor:
    """f32 logits [B, S, vocab].  last_only=True (prefill): unembed only
    the final position -- never materialize [B, 32K, vocab]."""
    x = hidden(params, cfg, batch, use_flash=use_flash, remat=remat)
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params.embed, x)


def _ce_chunk(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor):
    """One sequence chunk of the cross-entropy: (sum of -log p(label) over
    the unmasked positions, their count), f32.  ``table`` is the f32 tied
    table (``L.unembed``'s product)."""
    logits = x.float() @ table.T
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1,
                       labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - lab) * mask).sum(), mask.sum()


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            ce_chunk: int = 1024, remat: bool = False, **kw) -> torch.Tensor:
    """Chunked cross-entropy (the JAX package's ``loss_fn``): sequence
    chunks of ``ce_chunk`` positions (all ``S`` when it does not divide)
    are unembedded in f32 one at a time, labels < 0 are masked, and the
    sum is divided by max(count, 1).  The table is cast to f32 once a
    call; with ``remat`` each chunk's logits are recomputed in the
    backward, so the [B, S, vocab] logits are never all alive at once."""
    x = hidden(params, cfg, batch, remat=remat, **kw)
    labels = batch["labels"]
    s = x.shape[1]
    chunk = min(ce_chunk, s)
    if s % chunk != 0:
        chunk = s
    table = params.embed.table.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], table, labels[:, c0:c0 + chunk])
        t, c = (checkpoint(_ce_chunk, *args, use_reentrant=False)
                if _remat(remat) else _ce_chunk(*args))
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def jax_path(name: str) -> Tuple[str, int]:
    """A parameter's name in the port's module as (path in the JAX tree,
    layer index or -1): ``layers.3.attn.wq`` -> (``layers/attn/wq``, 3)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:]), int(parts[1])
    return "/".join(parts), -1


def named_leaves(params: LM) -> List[Tuple[str, nn.Parameter]]:
    """The parameters in the JAX tree's leaf order (sorted keys: ``embed``,
    ``layers``, ``ln_f``; a stacked leaf's layers in turn).  The ``ssm``
    family's ``layers/tm/_shape`` leaf of the JAX tree is no parameter here
    (``RWKV.dims``)."""
    return sorted(params.named_parameters(),
                  key=lambda kv: jax_path(kv[0]))


# ---------------------------------------------------------------------------
# decode (single-token serve step with per-layer state)
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    kv: object        # dense, moe: attention.KVCache, k and v stacked over
                      # layers [L, B, S, n_kv, hd]; ssm: ssm.RWKVState,
                      # each field stacked over layers
    extra: object     # None for the ported families
    pos: int


def init_decode_state(params: LM, cfg: ModelConfig, batch: int,
                      s_max: int) -> DecodeState:
    """Empty state on the parameters' device: bf16 KV caches (dense, moe),
    zero RWKV states (ssm: f32 wkv state, bf16 shifts)."""
    _ported_only(cfg)
    dev = params.embed.table.device
    if cfg.family == "ssm":
        one = ssm_mod.rwkv_init_state(params.layers[0].tm, batch,
                                      cfg.d_model)
        st = ssm_mod.RWKVState(*(
            torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=a.dtype,
                        device=dev) for a in one))
        return DecodeState(st, None, 0)
    s_kv = min(s_max, cfg.window) if cfg.window else s_max
    shape = (cfg.n_layers, batch, s_kv, cfg.n_kv, cfg.d_head)
    kv = attn_mod.KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=dev), length=0)
    return DecodeState(kv, None, 0)


def _rwkv_decode(params: LM, x: torch.Tensor,
                 st: ssm_mod.RWKVState) -> torch.Tensor:
    """The RWKV layers of one decode step; each layer's state and shifts
    (the normed inputs, in bf16) are written into ``st`` in place."""
    for i, lp in enumerate(params.layers):
        h1 = L.rmsnorm(lp.ln1, x)
        y, s_new = ssm_mod.rwkv_time_mix(lp.tm, h1, st.x_tm[i].to(h1.dtype),
                                         st.s[i])
        x = x + y
        h2 = L.rmsnorm(lp.ln2, x)
        x = x + ssm_mod.rwkv_channel_mix(lp.tm, h2,
                                         st.x_cm[i].to(h2.dtype))
        st.s[i].copy_(s_new)
        st.x_tm[i].copy_(h1[:, 0])
        st.x_cm[i].copy_(h2[:, 0])
    return x


def decode_step(params: LM, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """tokens [B, 1] -> (logits [B, 1, vocab], new state).  The caches and
    states in ``state`` are updated in place (``attention.decode_step``;
    the RWKV states); the JAX package returns updated copies."""
    _ported_only(cfg)
    x = L.embed(params.embed, tokens)
    kv = state.kv
    if cfg.family == "ssm":
        x = _rwkv_decode(params, x, kv)
    else:
        akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
                   window=cfg.window, rope_theta=cfg.rope_theta)
        for i, lp in enumerate(params.layers):
            cache = attn_mod.KVCache(kv.k[i], kv.v[i], kv.length)
            h, _ = attn_mod.decode_step(lp.attn, L.rmsnorm(lp.ln1, x), cache,
                                        **akw)
            x = x + h
            x = x + _mlp(cfg, lp, L.rmsnorm(lp.ln2, x))
        kv = attn_mod.KVCache(kv.k, kv.v, kv.length + 1)
    x = L.rmsnorm(params.ln_f, x)
    return L.unembed(params.embed, x), DecodeState(kv, None, state.pos + 1)
