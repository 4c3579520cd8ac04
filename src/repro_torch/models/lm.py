"""Model assembly: decoder-only LMs (dense, moe, ssm, hybrid), the whisper
encoder-decoder and the PaliGemma-style VLM (the JAX package's
``models/lm.py`` in PyTorch).

``init_params`` builds an ``nn.Module`` whose attribute tree is the JAX
parameter tree, with each stacked layer axis split into an
``nn.ModuleList`` of blocks; ``hidden`` and ``forward`` run the layers in
a Python loop where the JAX package scans, each layer under
``torch.utils.checkpoint`` where the JAX package wraps the scan body in
``jax.checkpoint`` (``remat=True``).  ``loss_fn`` is the JAX package's
chunked cross-entropy.  The families: ``dense``; ``moe`` (the dense block
with ``models.moe.dispatch`` in the MLP's place); ``ssm`` (RWKV6 blocks,
``models.ssm``); ``vlm`` (dense blocks over the patch-embedding prefix and
the tokens); ``hybrid`` (Zamba2: groups of ``attn_every`` Mamba2 layers,
each group followed by one attention block whose parameters all groups
share); ``encdec`` (whisper: a non-causal encoder over frame embeddings,
``encode``, and decoder layers with cross-attention to it).

Every function here runs on plain tensors or on DTensor parameters (the
step factories of ``train.step`` enter ``implicit_replication()`` for the
tensors the model makes as it runs).  ``ACT_SPEC`` and ``LOGITS_SPEC`` are
the reference's activation constraints; the reference's ``SCAN_UNROLL``
(a dry-run switch to unroll its layer scans for XLA's cost analysis) has
no counterpart: the layer loop here is Python, every layer runs and is
counted.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..configs.base import ModelConfig
from ..sharding import rules as _rules
from . import attention as attn_mod
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod

PORTED_FAMILIES = ("dense", "moe", "ssm", "vlm", "hybrid", "encdec")


def _ported_only(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is none of the JAX "
            f"package's families {PORTED_FAMILIES}")


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


class MambaBlock(nn.Module):
    """A layer of the ``hybrid`` family: RMSNorm, then Mamba2."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device)
        self.mamba = ssm_mod.mamba_init(gen, cfg.d_model, cfg.ssm_heads,
                                        cfg.d_state, device=device)


class EncoderBlock(nn.Module):
    """A whisper encoder layer: LayerNorms, attention, GELU MLP."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.layernorm_init(cfg.d_model, device)
        self.ln2 = L.layernorm_init(cfg.d_model, device)
        self.attn = attn_mod.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            device=device)
        self.mlp = L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device)


class EncDecBlock(nn.Module):
    """A whisper decoder layer: self-attention, cross-attention
    (``xattn``) and a GELU MLP, each after a LayerNorm."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.layernorm_init(cfg.d_model, device)
        self.ln_x = L.layernorm_init(cfg.d_model, device)
        self.ln2 = L.layernorm_init(cfg.d_model, device)
        self.attn = attn_mod.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            device=device)
        self.xattn = attn_mod.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            device=device)
        self.mlp = L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device)


BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "ssm": RWKVBlock,
          "vlm": DenseBlock, "hybrid": MambaBlock, "encdec": EncDecBlock}
# the stacked parameter lists of the JAX tree and their depths
STACKED = {"layers": lambda cfg: cfg.n_layers,
           "encoder": lambda cfg: cfg.enc_layers}


class LM(nn.Module):
    """``embed`` (the tied table), ``ln_f`` and ``layers`` (one block per
    layer, ``BLOCKS[family]``); ``encdec`` adds ``encoder`` (one
    ``EncoderBlock`` per encoder layer) and ``ln_enc`` (a LayerNorm),
    ``hybrid`` adds ``shared_attn``, the one attention block every group
    runs (a ``DenseBlock``: the JAX package's RMSNorms, attention and
    SwiGLU, which zamba2's config gives a dense block too)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.embed = L.embedding_init(gen, cfg.vocab, cfg.d_model, device)
        self.ln_f = L.rmsnorm_init(cfg.d_model, device)
        if cfg.family == "encdec":
            self.encoder = nn.ModuleList(EncoderBlock(gen, cfg, device)
                                         for _ in range(cfg.enc_layers))
            self.ln_enc = L.layernorm_init(cfg.d_model, device)
        block = BLOCKS[cfg.family]
        self.layers = nn.ModuleList(block(gen, cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(gen, cfg, device)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``),
    drawn in the order embed, then (``encdec``) per encoder layer, then per
    layer wq, wk, wv, wo and the MLP's (``moe``: the router and the
    experts; ``ssm``: the RWKV weights; ``hybrid``: the Mamba2 weights,
    then the shared block's); the scales and constants are the JAX
    package's (0.02 for the table and the router, 0.5 for Mamba's
    ``conv_w``, 1/sqrt(fan_in) for the rest; bf16 weights, f32 norm scales,
    biases and constants)."""
    _ported_only(cfg)
    dev = _device.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, "
                         f"parameters on {dev}")
    return LM(gen, cfg, dev)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------
# Activation / logits sharding constraints: without them the residual
# stream follows whatever layout the weights' products leave it in;
# constraining it to batch-sharded makes the FSDP weights the thing that
# moves (per-layer weight all-gathers).  ``sharding.NamedSharding``s, set
# by the dry-run (``launch.dryrun``) and the sharded steps; None = no
# constraint.  Reset them where they are set (the tests' autouse fixtures).
ACT_SPEC = None      # NamedSharding for [B, S, d] activations
LOGITS_SPEC = None   # NamedSharding for [B, C, vocab] CE-chunk logits


def _wsc(x, spec):
    """``x`` redistributed to ``spec``'s placements (``with_sharding_
    constraint``); the identity on a plain tensor or a None spec."""
    if spec is None or not L.is_dtensor(x):
        return x
    return x.redistribute(_rules.dtensor_mesh(spec.mesh),
                          _rules.placements(spec, spec.mesh))


class _Gathered:
    """A module seen through ``ACT_SPEC``: each DTensor parameter read from
    it is gathered over the mesh dims that shard the activations' batch
    (its other placements kept), submodules and lists of them seen the
    same way, everything else as it is.

    GSPMD infers these per-layer weight all-gathers from the activation
    constraint (true FSDP); DTensor lays out each op from its operands as
    they come, so without them it moves the batch-sharded activations to
    the weights instead (the embedding on a vocab- and d-sharded table
    then gathers the whole batch).  A read gathers anew, as FSDP does
    again in the backward."""

    __slots__ = ("_mod", "_dims")

    def __init__(self, mod, dims):
        self._mod = mod
        self._dims = dims

    def _view(self, v):
        if isinstance(v, nn.Module):
            return _Gathered(v, self._dims)
        if L.is_dtensor(v):
            from torch.distributed.tensor import Replicate
            pl = [Replicate() if i in self._dims else p
                  for i, p in enumerate(v.placements)]
            return v.redistribute(v.device_mesh, pl)
        return v

    def __getattr__(self, name):
        return self._view(getattr(self._mod, name))

    def __getitem__(self, i):
        return self._view(self._mod[i])

    def __iter__(self):
        return (self._view(m) for m in self._mod)

    def __len__(self):
        return len(self._mod)


def _fsdp(params):
    """``params`` as the sharded steps read it: through ``_Gathered`` when
    ``ACT_SPEC`` shards the batch of DTensor parameters, else as it is."""
    if ACT_SPEC is None or isinstance(params, _Gathered) or \
            not L.is_dtensor(params.embed.table):
        return params
    dims = {i for i, p in enumerate(_rules.placements(ACT_SPEC,
                                                      ACT_SPEC.mesh))
            if p.is_shard()}
    return _Gathered(params, dims)


def _mlp(cfg: ModelConfig, lp, y: torch.Tensor) -> torch.Tensor:
    if cfg.family == "moe":
        return moe_mod.dispatch(lp.moe, y, top_k=cfg.top_k)
    if cfg.act == "gelu":
        return L.gelu_mlp(lp.mlp, y)
    return L.swiglu(lp.mlp, y)


def _dense_block(cfg: ModelConfig, lp, x, use_flash):
    """The reference constrains the block's input.  On DTensors every
    block here constrains its input and the outputs of its row-parallel
    products too (their partial sums reduced onto ``ACT_SPEC`` before the
    residual adds), which GSPMD infers and DTensor's op-by-op choice does
    not."""
    x = _wsc(x, ACT_SPEC)
    h = attn_mod.attention(
        lp.attn, L.rmsnorm(lp.ln1, x), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, d_head=cfg.d_head, window=cfg.window,
        rope_theta=cfg.rope_theta, use_flash=use_flash)
    x = x + _wsc(h, ACT_SPEC)
    return x + _wsc(_mlp(cfg, lp, L.rmsnorm(lp.ln2, x)), ACT_SPEC)


def _rwkv_block(cfg: ModelConfig, lp, x, use_flash):
    """One RWKV6 layer over the whole sequence from a zero state and a zero
    shift (the reference's prefill); ``use_flash`` has no say here."""
    x = _wsc(x, ACT_SPEC)
    bsz = x.shape[0]
    s0 = torch.zeros((bsz, cfg.ssm_heads, cfg.d_head, cfg.d_head),
                     dtype=torch.float32, device=x.device)
    zero = torch.zeros((bsz, cfg.d_model), dtype=x.dtype, device=x.device)
    h, _ = ssm_mod.rwkv_time_mix(lp.tm, L.rmsnorm(lp.ln1, x), zero, s0)
    x = x + _wsc(h, ACT_SPEC)
    return x + _wsc(ssm_mod.rwkv_channel_mix(lp.tm, L.rmsnorm(lp.ln2, x),
                                             zero), ACT_SPEC)


def _mamba_block(cfg: ModelConfig, lp, x, use_flash):
    """One layer of the ``hybrid`` family; ``use_flash`` has no say here."""
    x = _wsc(x, ACT_SPEC)
    return x + _wsc(ssm_mod.mamba_forward(lp.mamba, L.rmsnorm(lp.ln1, x)),
                    ACT_SPEC)


def _groups(cfg: ModelConfig) -> List[range]:
    """The ``hybrid`` family's layer groups as the JAX package slices them:
    ``max(n_layers // attn_every, 1)`` groups of ``layers[g * attn_every:
    (g + 1) * attn_every]`` -- a depth that ``attn_every`` does not divide
    drops the trailing layers, and fewer than ``attn_every`` layers run in
    one group."""
    ge = cfg.attn_every
    return [range(g * ge, min((g + 1) * ge, cfg.n_layers))
            for g in range(max(cfg.n_layers // ge, 1))]


def _encdec_block(cfg: ModelConfig, lp, x, enc):
    """A whisper decoder layer over the whole sequence: causal
    self-attention, cross-attention to the encoder output ``enc`` (its K
    and V projected by this layer), GELU MLP."""
    x = _wsc(x, ACT_SPEC)
    h = attn_mod.attention(
        lp.attn, L.layernorm(lp.ln1, x), n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta)
    x = x + _wsc(h, ACT_SPEC)
    ek, ev = _cross_kv(cfg, lp, enc)
    h = attn_mod.attention(
        lp.xattn, L.layernorm(lp.ln_x, x), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, d_head=cfg.d_head, cross_kv=(ek, ev))
    x = x + _wsc(h, ACT_SPEC)
    return x + _wsc(L.gelu_mlp(lp.mlp, L.layernorm(lp.ln2, x)), ACT_SPEC)


def _cross_kv(cfg: ModelConfig, lp, enc):
    b, t, _ = enc.shape
    return ((enc @ lp.xattn.wk).reshape(b, t, cfg.n_kv, cfg.d_head),
            (enc @ lp.xattn.wv).reshape(b, t, cfg.n_kv, cfg.d_head))


def _encoder_block(cfg: ModelConfig, lp, x, use_flash):
    x = _wsc(x, ACT_SPEC)
    h = attn_mod.attention(
        lp.attn, L.layernorm(lp.ln1, x), n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, causal=False, rope_theta=0.0)
    x = x + _wsc(h, ACT_SPEC)
    return x + _wsc(L.gelu_mlp(lp.mlp, L.layernorm(lp.ln2, x)), ACT_SPEC)


def _remat(remat: bool) -> bool:
    """Recompute in the backward only where a graph is being recorded."""
    return remat and torch.is_grad_enabled()


def _run(block, cfg: ModelConfig, layers, x, arg, remat: bool):
    """``x = block(cfg, lp, x, arg)`` for each ``lp`` of ``layers``, each
    under ``checkpoint`` with ``remat``."""
    for lp in layers:
        if _remat(remat):
            x = checkpoint(block, cfg, lp, x, arg, use_reentrant=False)
        else:
            x = block(cfg, lp, x, arg)
    return x


def _sinusoid(s: int, d: int, device=None) -> torch.Tensor:
    """[s, d] f32 positions: sines, then cosines, of pos / 10000^(i / d)
    for even i."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def encode(params: LM, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over (stub) frame embeddings [B, T, d] in the
    weights' type: sinusoidal positions added, non-causal attention
    without rope, then ``ln_enc``.  Embeddings of another type raise: the
    JAX package would run its encoder in the promoted type, and the port's
    products do not promote (the JAX ``input_specs`` gives them bf16)."""
    _ported_only(cfg)
    if enc_embeds.dtype != params.embed.table.dtype:
        raise ValueError(f"encode: enc_embeds in {enc_embeds.dtype}, the "
                         f"weights in {params.embed.table.dtype}")
    x = enc_embeds + _sinusoid(enc_embeds.shape[1], cfg.d_model,
                               enc_embeds.device)[None].to(enc_embeds.dtype)
    x = _run(_encoder_block, cfg, params.encoder, x, False, False)
    return L.layernorm(params.ln_enc, x)


def hidden(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
           use_flash: bool = False, remat: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] over the token positions.
    ``remat``: keep only each layer's input for the backward and recompute
    the layer there (``jax.checkpoint`` of the JAX scan body).  ``vlm``
    reads ``batch["patch_embeds"]`` [B, P, d] (cast to the activations'
    type, run before the tokens, dropped before ``ln_f``); ``encdec`` reads
    ``batch["enc_embeds"]`` [B, T, d] and adds the sinusoid to the
    tokens."""
    _ported_only(cfg)
    params = _fsdp(params)
    x = _wsc(L.embed(params.embed, batch["tokens"]), ACT_SPEC)
    if cfg.family == "vlm":
        prefix = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([prefix, x], dim=1)
        x = _run(_dense_block, cfg, params.layers, x, use_flash, remat)
        x = x[:, prefix.shape[1]:, :]
    elif cfg.family == "hybrid":
        # the shared block passes the arch's window: never the flash route
        for grp in _groups(cfg):
            x = _run(_mamba_block, cfg, params.layers[grp.start:grp.stop],
                     x, use_flash, remat)
            x = _dense_block(cfg, params.shared_attn, x, use_flash)
    elif cfg.family == "encdec":
        enc = encode(params, cfg, batch["enc_embeds"])
        x = x + _sinusoid(x.shape[1], cfg.d_model,
                          x.device)[None].to(x.dtype)
        x = _run(_encdec_block, cfg, params.layers, x, enc, remat)
    else:
        block = _rwkv_block if cfg.family == "ssm" else _dense_block
        x = _run(block, cfg, params.layers, x, use_flash, remat)
    return L.rmsnorm(params.ln_f, x)


def forward(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            use_flash: bool = False, remat: bool = False,
            last_only: bool = False) -> torch.Tensor:
    """f32 logits [B, S, vocab].  last_only=True (prefill): unembed only
    the final position -- never materialize [B, 32K, vocab]."""
    params = _fsdp(params)
    x = hidden(params, cfg, batch, use_flash=use_flash, remat=remat)
    if last_only:
        x = x[:, -1:, :]
    return L.unembed(params.embed, x)


def _lse_and_label(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp over the vocabulary, the label's logit).  On DTensor
    logits, whose vocabulary may be sharded on "model", both are reduced
    where they lie: the max-shifted sum of exponentials (a max and a sum
    over "model"; DTensor's ``logsumexp`` would gather the whole
    vocabulary) and a masked sum for the pick (exactly the gathered value,
    every other term being 0; DTensor's gather rule fails in its
    reduction)."""
    idx = labels.clamp(min=0).long()[..., None]
    if not L.is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, idx)[..., 0])
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = [Replicate() if isinstance(p, Partial) else p
          for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    # the layout of a reduction over the vocabulary: its shards gathered
    red = [Replicate() if isinstance(p, Shard) and p.dim == last else p
           for p in pl]
    m = logits.amax(-1, keepdim=True).detach().redistribute(mesh, red)
    se = torch.exp(logits - m).sum(-1).redistribute(mesh, red)
    cols = torch.arange(logits.shape[-1], device=labels.device)
    hit = cols == idx
    if not L.is_dtensor(hit):          # plain labels: replicated
        hit = DTensor.from_local(hit, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    hit = hit.redistribute(mesh, pl)
    lab = torch.where(hit, logits, 0.0).sum(-1).redistribute(mesh, red)
    return torch.log(se) + m[..., 0], lab


def _ce_chunk(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor):
    """One sequence chunk of the cross-entropy: (sum of -log p(label) over
    the unmasked positions, their count), f32.  ``table`` is the f32 tied
    table (``L.unembed``'s product)."""
    x = _wsc(x, ACT_SPEC)
    logits = _wsc(x.float() @ table.T, LOGITS_SPEC)
    lse, lab = _lse_and_label(logits, labels)
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
    params = _fsdp(params)
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
    layer index or -1): ``layers.3.attn.wq`` -> (``layers/attn/wq``, 3),
    ``encoder.3.attn.wq`` -> (``encoder/attn/wq``, 3),
    ``shared_attn.attn.wq`` -> (``shared_attn/attn/wq``, -1)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), -1


def named_leaves(params: LM) -> List[Tuple[str, nn.Parameter]]:
    """The parameters in the JAX tree's leaf order (sorted keys: ``embed``,
    ``encoder``, ``layers``, ``ln_enc``, ``ln_f``, ``shared_attn``; a
    stacked leaf's layers in turn).  The ``ssm`` and ``hybrid`` families'
    ``_shape`` leaves of the JAX tree are no parameters here
    (``RWKV.dims``, ``Mamba.dims``)."""
    return sorted(params.named_parameters(),
                  key=lambda kv: jax_path(kv[0]))


# ---------------------------------------------------------------------------
# decode (single-token serve step with per-layer state)
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    kv: object        # dense, moe, vlm, encdec: attention.KVCache, k and v
                      # stacked over layers [L, B, S, n_kv, hd]; ssm:
                      # ssm.RWKVState, hybrid: ssm.MambaState, each field
                      # stacked over layers
    extra: object     # hybrid: the shared block's attention.KVCache, one a
                      # group [G, B, min(s_max, window), n_kv, hd]; encdec:
                      # the cross K and V (bf16 [L, B, enc_seq, n_kv, hd]
                      # each, zeros until ``prime_encdec``); else None
    pos: int


def _stacked_zeros(n: int, one, dev):
    """Each field of the state ``one`` as zeros stacked n deep."""
    return type(one)(*(torch.zeros((n,) + tuple(a.shape), dtype=a.dtype,
                                   device=dev) for a in one))


def _kv_cache(n: int, batch: int, s_kv: int, cfg: ModelConfig, dev):
    shape = (n, batch, s_kv, cfg.n_kv, cfg.d_head)
    return attn_mod.KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=dev), length=0)


def init_decode_state(params: LM, cfg: ModelConfig, batch: int,
                      s_max: int) -> DecodeState:
    """Empty state on the parameters' device: bf16 KV caches (dense, moe,
    vlm, encdec; the hybrid family's shared block, one a group), zero RWKV
    states (ssm: f32 wkv state, bf16 shifts), zero Mamba2 states (hybrid:
    f32 state, bf16 conv tail), bf16 zero cross K/V (encdec)."""
    _ported_only(cfg)
    dev = params.embed.table.device
    s_kv = min(s_max, cfg.window) if cfg.window else s_max
    if cfg.family == "ssm":
        one = ssm_mod.rwkv_init_state(params.layers[0].tm, batch,
                                      cfg.d_model)
        return DecodeState(_stacked_zeros(cfg.n_layers, one, dev), None, 0)
    if cfg.family == "hybrid":
        one = ssm_mod.mamba_init_state(params.layers[0].mamba, batch)
        return DecodeState(_stacked_zeros(cfg.n_layers, one, dev),
                           _kv_cache(len(_groups(cfg)), batch, s_kv, cfg,
                                     dev), 0)
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv, cfg.d_head)
        xkv = tuple(torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                    for _ in range(2))
        return DecodeState(_kv_cache(cfg.n_layers, batch, s_max, cfg, dev),
                           xkv, 0)
    return DecodeState(_kv_cache(cfg.n_layers, batch, s_kv, cfg, dev),
                       None, 0)


def prime_encdec(params: LM, cfg: ModelConfig, enc_embeds: torch.Tensor,
                 state: DecodeState) -> DecodeState:
    """The state with each layer's cross-attention K and V from the
    encoder output, in bf16 (new tensors; the caches are kept)."""
    enc = encode(params, cfg, enc_embeds)
    kv = [_cross_kv(cfg, lp, enc) for lp in params.layers]
    xk = torch.stack([k for k, _ in kv]).to(torch.bfloat16)
    xv = torch.stack([v for _, v in kv]).to(torch.bfloat16)
    return DecodeState(state.kv, (xk, xv), state.pos)


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


def _dense_decode(cfg: ModelConfig, lp, x: torch.Tensor, kv, i: int,
                  akw: dict) -> torch.Tensor:
    """A dense block's decode step on entry ``i`` of the stacked caches
    ``kv`` (written in place)."""
    cache = attn_mod.KVCache(kv.k[i], kv.v[i], kv.length)
    h, _ = attn_mod.decode_step(lp.attn, L.rmsnorm(lp.ln1, x), cache, **akw)
    x = x + h
    return x + _mlp(cfg, lp, L.rmsnorm(lp.ln2, x))


def _hybrid_decode(params: LM, cfg: ModelConfig, x: torch.Tensor,
                   st: ssm_mod.MambaState, caches: attn_mod.KVCache,
                   akw: dict) -> torch.Tensor:
    """The hybrid layers of one decode step: each group's Mamba2 layers
    (their states written into ``st`` in place), then the shared block on
    the group's own cache (the ring buffer of the window, written in
    place)."""
    for g, grp in enumerate(_groups(cfg)):
        for i in grp:
            lp = params.layers[i]
            y, new = ssm_mod.mamba_decode_step(
                lp.mamba, L.rmsnorm(lp.ln1, x),
                ssm_mod.MambaState(st.h[i], st.conv[i]))
            x = x + y
            st.h[i].copy_(new.h)
            st.conv[i].copy_(new.conv)
        x = _dense_decode(cfg, params.shared_attn, x, caches, g, akw)
    return x


def _encdec_decode(params: LM, cfg: ModelConfig, x: torch.Tensor,
                   kv: attn_mod.KVCache, xkv) -> torch.Tensor:
    """The whisper decoder layers of one decode step: self-attention on the
    layer's cache (no window), cross-attention to the primed K and V
    through ``attention._sdpa`` with an all-true mask.  As in the JAX
    package, no positional encoding is added here (``hidden`` adds the
    sinusoid)."""
    xk, xv = xkv
    b = x.shape[0]
    for i, lp in enumerate(params.layers):
        cache = attn_mod.KVCache(kv.k[i], kv.v[i], kv.length)
        h, _ = attn_mod.decode_step(
            lp.attn, L.layernorm(lp.ln1, x), cache, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, d_head=cfg.d_head, rope_theta=cfg.rope_theta)
        x = x + h
        q = (L.layernorm(lp.ln_x, x) @ lp.xattn.wq).reshape(
            b, 1, cfg.n_heads, cfg.d_head)
        mask = torch.ones((1, xk.shape[2]), dtype=torch.bool,
                          device=x.device)
        o = attn_mod._on_local_heads(attn_mod._dense(mask), q, xk[i],
                                     xv[i], cfg.n_heads, cfg.n_kv)
        x = x + o.reshape(b, 1, -1) @ lp.xattn.wo
        x = x + L.gelu_mlp(lp.mlp, L.layernorm(lp.ln2, x))
    return x


def decode_step(params: LM, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """tokens [B, 1] -> (logits [B, 1, vocab], new state).  The caches and
    states in ``state`` are updated in place (``attention.decode_step``;
    the RWKV and Mamba2 states); the JAX package returns updated copies.
    A hybrid depth that ``attn_every`` does not divide leaves the trailing
    layers' states as they are (the JAX package's new state drops them)."""
    _ported_only(cfg)
    params = _fsdp(params)
    x = L.embed(params.embed, tokens)
    kv, extra = state.kv, state.extra
    akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
               window=cfg.window, rope_theta=cfg.rope_theta)
    if cfg.family == "ssm":
        x = _rwkv_decode(params, x, kv)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, x, kv, extra, akw)
        extra = attn_mod.KVCache(extra.k, extra.v, extra.length + 1)
    elif cfg.family == "encdec":
        x = _encdec_decode(params, cfg, x, kv, extra)
        kv = attn_mod.KVCache(kv.k, kv.v, kv.length + 1)
    else:
        for i, lp in enumerate(params.layers):
            x = _dense_decode(cfg, lp, x, kv, i, akw)
        kv = attn_mod.KVCache(kv.k, kv.v, kv.length + 1)
    x = L.rmsnorm(params.ln_f, x)
    return L.unembed(params.embed, x), DecodeState(kv, extra, state.pos + 1)
