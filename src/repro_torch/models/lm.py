"""Model assembly for the decoder-only dense family (the JAX package's
``models/lm.py`` in PyTorch).

``init_params`` builds an ``nn.Module`` whose attribute tree is the JAX
parameter tree, with the stacked layer axis split into an
``nn.ModuleList`` of blocks; ``hidden`` and ``forward`` run the layers in
a Python loop where the JAX package scans.  The ``moe``, ``ssm``,
``hybrid``, ``encdec`` and ``vlm`` families are not ported yet (ROADMAP.md
Queue 1 item 13) and raise ``NotImplementedError``; the training loss
waits for the training slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from .. import device as _device
from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import layers as L


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            f"ROADMAP.md Queue 1 item 13")


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


class LM(nn.Module):
    """``embed`` (the tied table), ``ln_f`` and ``layers`` (one
    ``DenseBlock`` per layer)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.embed = L.embedding_init(gen, cfg.vocab, cfg.d_model, device)
        self.ln_f = L.rmsnorm_init(cfg.d_model, device)
        self.layers = nn.ModuleList(DenseBlock(gen, cfg, device)
                                    for _ in range(cfg.n_layers))


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``),
    drawn in the order embed, then per layer wq, wk, wv, wo and the MLP's;
    the scales are the JAX package's (0.02 for the table, 1/sqrt(fan_in)
    for the rest; bf16 weights, f32 norm scales)."""
    _dense_only(cfg)
    dev = _device.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, "
                         f"parameters on {dev}")
    return LM(gen, cfg, dev)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def _mlp(cfg: ModelConfig, lp, y: torch.Tensor) -> torch.Tensor:
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


def hidden(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
           use_flash: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] over the token positions."""
    _dense_only(cfg)
    x = L.embed(params.embed, batch["tokens"])
    for lp in params.layers:
        x = _dense_block(cfg, lp, x, use_flash)
    return L.rmsnorm(params.ln_f, x)


def forward(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            use_flash: bool = False, last_only: bool = False) -> torch.Tensor:
    """f32 logits [B, S, vocab].  last_only=True (prefill): unembed only
    the final position -- never materialize [B, 32K, vocab]."""
    x = hidden(params, cfg, batch, use_flash=use_flash)
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params.embed, x)


# ---------------------------------------------------------------------------
# decode (single-token serve step with per-layer state)
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    kv: attn_mod.KVCache   # k, v stacked over layers: [L, B, S, n_kv, hd]
    extra: object          # None for the dense family
    pos: int


def init_decode_state(params: LM, cfg: ModelConfig, batch: int,
                      s_max: int) -> DecodeState:
    """Empty bf16 caches on the parameters' device."""
    _dense_only(cfg)
    s_kv = min(s_max, cfg.window) if cfg.window else s_max
    shape = (cfg.n_layers, batch, s_kv, cfg.n_kv, cfg.d_head)
    dev = params.embed.table.device
    kv = attn_mod.KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=dev), length=0)
    return DecodeState(kv, None, 0)


def decode_step(params: LM, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """tokens [B, 1] -> (logits [B, 1, vocab], new state).  The caches in
    ``state`` are updated in place (``attention.decode_step``)."""
    _dense_only(cfg)
    x = L.embed(params.embed, tokens)
    akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
               window=cfg.window, rope_theta=cfg.rope_theta)
    kv = state.kv
    for i, lp in enumerate(params.layers):
        cache = attn_mod.KVCache(kv.k[i], kv.v[i], kv.length)
        h, _ = attn_mod.decode_step(lp.attn, L.rmsnorm(lp.ln1, x), cache,
                                    **akw)
        x = x + h
        x = x + _mlp(cfg, lp, L.rmsnorm(lp.ln2, x))
    x = L.rmsnorm(params.ln_f, x)
    new = DecodeState(attn_mod.KVCache(kv.k, kv.v, kv.length + 1), None,
                      state.pos + 1)
    return L.unembed(params.embed, x), new
