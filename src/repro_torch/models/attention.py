"""GQA attention with causal / sliding-window masks and decode KV cache (the
JAX package's ``models/attention.py`` in PyTorch).

The flash route goes through the port's hand-written kernel
(``kernels.flash_attention.ops.mha``); the dense and chunked routes are
torch ops with the JAX package's rounding points (scores of the dense
route rounded to the input type before the f32 softmax, weights cast back
to it before the PV product).

On DTensor inputs every route runs on each card's local batch rows and
heads (``_on_local_heads``): the flash kernel on the card, the dense and
chunked routes as they are.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn

from ..kernels.flash_attention import ops as flash_ops
from .layers import (_init, _ones, apply_rope, contiguous_grads, is_dtensor,
                     rmsnorm, run_split)

# use the chunked online-softmax path for sequences >= this (0 = off)
CHUNKED_SEQ = 8192
_F32_MIN = torch.finfo(torch.float32).min


class Attention(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                 d_head: int, qk_norm: bool = False, device=None):
        super().__init__()
        self.wq = _init(gen, (d, n_heads * d_head), device=device)
        self.wk = _init(gen, (d, n_kv * d_head), device=device)
        self.wv = _init(gen, (d, n_kv * d_head), device=device)
        self.wo = _init(gen, (n_heads * d_head, d), device=device)
        if qk_norm:
            self.q_norm = _ones((d_head,), device)
            self.k_norm = _ones((d_head,), device)


def attention_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   d_head: int, qk_norm: bool = False,
                   device=None) -> Attention:
    return Attention(gen, d, n_heads, n_kv, d_head, qk_norm, device)


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, S_max, n_kv, d_head] (stacked: [L, ...])
    v: torch.Tensor       # [B, S_max, n_kv, d_head]
    length: int           # tokens currently cached


class _Scale(NamedTuple):
    scale: torch.Tensor


def _qkv(p, x, n_heads, n_kv, d_head, positions, rope_theta):
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, n_heads, d_head)
    k = (x @ p.wk).reshape(b, s, n_kv, d_head)
    v = (x @ p.wv).reshape(b, s, n_kv, d_head)
    if hasattr(p, "q_norm"):  # qwen3-style per-head qk RMSNorm
        q = rmsnorm(_Scale(p.q_norm), q)
        k = rmsnorm(_Scale(p.k_norm), k)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep):
    """q [B,Sq,H,hd]; k,v [B,Sk,Hkv,hd]; mask [Sq,Sk] or [B,Sq,Sk] bool."""
    scale = q.shape[-1] ** -0.5
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask.dim() == 2:
        mask = mask[None, None, :, :]
    else:
        mask = mask[:, None, :, :]
    logits = torch.where(mask, logits, _F32_MIN)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _sdpa_chunked(q, k, v, n_rep, *, causal=True, chunk=1024, window=None):
    """Online-softmax attention over KV chunks in f32 (the JAX package's
    pure-jnp flash).  Peak memory O(Sq x chunk) instead of O(Sq x Sk).
    ``window``: sliding-window banding inside the chunk mask.
    q [B,Sq,H,hd]; k,v [B,Sk,Hkv,hd]."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    if sk % chunk != 0:
        chunk = sk
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    scale = hd ** -0.5
    # [B, H, S, hd] in f32, laid out once (the products per chunk are
    # the JAX package's einsums)
    qh, kh, vh = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), -1e30, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, hd), device=q.device)
    for c0 in range(0, sk, chunk):
        s = (qh @ kh[:, :, c0:c0 + chunk].transpose(-1, -2)) * scale
        if causal:
            cols = c0 + torch.arange(chunk, device=q.device)[None, :]
            band = rows >= cols
            if window is not None:
                band = band & (rows - cols < window)
            s = torch.where(band[None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vh[:, :, c0:c0 + chunk]
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def local_kv_heads(n_heads: int, n_kv: int, tp: int, rank: int) -> List[int]:
    """The K/V heads that q heads ``[rank * H / tp, (rank + 1) * H / tp)``
    attend to when K/V are replicated: head ``h`` reads ``h // (H / n_kv)``
    of the global index.  A contiguous group when whole groups are local
    (one head each for ``H / tp`` at most one group), else one K/V head a
    q head, so that local q head ``j`` reads local K/V head
    ``j // (H_local / n_kv_local)`` as the kernel maps it."""
    hl, rep = n_heads // tp, n_heads // n_kv
    heads = [(rank * hl + j) // rep for j in range(hl)]
    uniq = sorted(set(heads))
    if hl % len(uniq) == 0 and heads == [u for u in uniq
                                         for _ in range(hl // len(uniq))]:
        return uniq
    return heads


def _dense(mask):
    """The dense route with ``mask`` as a route of ``_on_local_heads``
    (the GQA repeat from the local head counts)."""
    return lambda q, k, v: _sdpa(q, k, v, mask, q.shape[2] // k.shape[2])


def _on_local_heads(fn, q, k, v, n_heads: int, n_kv: int):
    """``fn(q, k, v)`` -> [B, Sq, H, d], an attention route, on DTensor q,
    k, v [B, S, heads, d] as each rank's local [B_local, Sq, H_local, d]:
    the batch kept as q has it, the heads sharded on "model" where H
    divides by its size (else replicated); K/V heads sharded with them
    where n_kv divides too, else replicated and cut to the ones the local
    q heads read (``local_kv_heads``), their gradient then a partial sum
    over "model".  The result has q's placements.  Attention is
    independent across batch rows and heads, so this is the global result;
    DTensor's own products would merge batch and heads into one
    strided-sharded dim, which its propagation cannot lay out under
    ``FakeTensorMode``, and the flash kernel takes no DTensor.  Plain
    tensors go to ``fn`` as they are."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    tp = mesh.shape[mi]
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in q.placements]
    q_heads = n_heads % tp == 0
    kv_heads = q_heads and n_kv % tp == 0
    q_pl, kv_pl = list(batch), list(batch)
    q_pl[mi] = Shard(2) if q_heads else Replicate()
    kv_pl[mi] = Shard(2) if kv_heads else Replicate()
    kv_grad = list(kv_pl)
    if q_heads and not kv_heads:
        kv_grad[mi] = Partial()
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
              for t in (k, v))
    ql, kl, vl = contiguous_grads(ql, kl, vl)
    if q_heads and not kv_heads:
        idx = local_kv_heads(n_heads, n_kv, tp, mesh.get_local_rank("model"))
        sel = torch.tensor(idx, device=kl.device)
        kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
    split = 1
    for i, pl in enumerate(q_pl):
        split *= mesh.shape[i] if isinstance(pl, Shard) else 1
    out = run_split(fn, split)(ql, kl, vl).contiguous()
    return DTensor.from_local(out, mesh, q_pl, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def causal_mask(s: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def attention(p, x: torch.Tensor, *, n_heads: int, n_kv: int, d_head: int,
              causal: bool = True, window: Optional[int] = None,
              rope_theta: float = 10000.0, cross_kv: Optional[tuple] = None,
              use_flash: bool = False) -> torch.Tensor:
    """Full-sequence attention (prefill).

    cross_kv: optional (k, v) from an encoder for cross-attention
    (rope/causality disabled on the cross path).  Routes as the JAX
    package: the flash kernel if ``use_flash and causal and window is
    None``, else the chunked path from ``CHUNKED_SEQ`` tokens on, else the
    dense one."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    if cross_kv is not None:
        q = (x @ p.wq).reshape(b, s, n_heads, d_head)
        k, v = cross_kv
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _on_local_heads(_dense(mask), q, k, v, n_heads, k.shape[2])
    else:
        q, k, v = _qkv(p, x, n_heads, n_kv, d_head, positions, rope_theta)
        if use_flash and causal and window is None:
            route = lambda q, k, v: flash_ops.mha(q, k, v, causal=True)
        elif CHUNKED_SEQ and s >= CHUNKED_SEQ and causal:
            route = lambda q, k, v: _sdpa_chunked(
                q, k, v, q.shape[2] // k.shape[2], window=window)
        else:
            mask = (causal_mask(s, window, x.device) if causal else
                    torch.ones((s, s), dtype=torch.bool, device=x.device))
            route = _dense(mask)
        out = _on_local_heads(route, q, k, v, n_heads, n_kv)
    return out.reshape(b, s, n_heads * d_head) @ p.wo


def init_cache(batch: int, s_max: int, n_kv: int, d_head: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, s_max, n_kv, d_head), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, s_max, n_kv, d_head), dtype=dtype,
                      device=device),
        length=0)


def decode_step(p, x: torch.Tensor, cache: KVCache, *, n_heads: int,
                n_kv: int, d_head: int, window: Optional[int] = None,
                rope_theta: float = 10000.0) -> tuple:
    """One-token decode: x [B, 1, d]; returns (out [B,1,d], new cache).

    The new token's K and V are written into ``cache.k`` and ``cache.v``
    in place (the returned cache holds the same tensors); the JAX package
    returns updated copies.  With a sliding window the cache is a ring
    buffer of size ``window`` (positions wrap; the mask keeps only the
    last ``window`` tokens)."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    pos = int(cache.length)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head, positions, rope_theta)
    slot = pos % s_max if window is not None else min(pos, s_max - 1)
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    idx = torch.arange(s_max, device=x.device)
    if window is None or pos < s_max:
        valid = idx <= pos
    else:                                   # ring buffer: all slots live
        valid = torch.ones(s_max, dtype=torch.bool, device=x.device)
    mask = valid[None, None, :]                # [B, 1, S_max]
    out = _on_local_heads(_dense(mask), q, cache.k, cache.v, n_heads, n_kv)
    out = out.reshape(b, 1, n_heads * d_head) @ p.wo
    return out, KVCache(cache.k, cache.v, pos + 1)
