"""Model assembly for the decoder-only dense family (the JAX package's
``models/lm.py`` in PyTorch).

``init_params`` builds an ``nn.Module`` whose attribute tree is the JAX
parameter tree, with the stacked layer axis split into an
``nn.ModuleList`` of blocks; ``hidden`` and ``forward`` run the layers in
a Python loop where the JAX package scans, each layer under
``torch.utils.checkpoint`` where the JAX package wraps the scan body in
``jax.checkpoint`` (``remat=True``).  ``loss_fn`` is the JAX package's
chunked cross-entropy.  The ``moe``, ``ssm``, ``hybrid``, ``encdec`` and
``vlm`` families are not ported yet (ROADMAP.md Queue 1 item 13) and raise
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


def _remat(remat: bool) -> bool:
    """Recompute in the backward only where a graph is being recorded."""
    return remat and torch.is_grad_enabled()


def hidden(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
           use_flash: bool = False, remat: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] over the token positions.
    ``remat``: keep only each layer's input for the backward and recompute
    the layer there (``jax.checkpoint`` of the JAX scan body)."""
    _dense_only(cfg)
    x = L.embed(params.embed, batch["tokens"])
    for lp in params.layers:
        if _remat(remat):
            x = checkpoint(_dense_block, cfg, lp, x, use_flash,
                           use_reentrant=False)
        else:
            x = _dense_block(cfg, lp, x, use_flash)
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
    ``layers``, ``ln_f``; a stacked leaf's layers in turn)."""
    return sorted(params.named_parameters(),
                  key=lambda kv: jax_path(kv[0]))


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
