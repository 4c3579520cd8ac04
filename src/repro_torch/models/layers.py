"""Basic layers: norms, RoPE, embeddings, MLPs (the JAX package's
``models/layers.py`` in PyTorch).

Parameters live in small ``nn.Module``s whose attribute names are the JAX
package's dictionary keys (``RMSNorm.scale``, ``SwiGLU.w_gate``, ...), and
weights keep its orientation: ``x @ W`` with ``W [d_in, d_out]``, so a
parameter tree carries across without transposes.  The functions take the
module as the JAX functions take the dictionary.  Parameters require
grad, so the trainer differentiates them with autograd; the serving steps
run under ``torch.inference_mode()`` and record no graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.bfloat16,
          device=None) -> nn.Parameter:
    """Normal f32 draws from ``gen`` times ``scale`` (1/sqrt(fan_in) by
    default, ``shape[0]`` being the fan-in), cast to ``dtype``.  Without a
    generator the parameter is left uninitialised, to be filled from a
    carried-over tree (``convert.lm_params_from_numpy``)."""
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return _param((x * scale).to(dtype))


def _zeros(shape, device, dtype=torch.float32) -> nn.Parameter:
    return _param(torch.zeros(shape, dtype=dtype, device=device))


def _ones(shape, device, dtype=torch.float32) -> nn.Parameter:
    return _param(torch.ones(shape, dtype=dtype, device=device))


# --- norms -------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _ones((d,), device)


def rmsnorm_init(d: int, device=None) -> RMSNorm:
    return RMSNorm(d, device)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32, cast back to ``x``'s type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p.scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _ones((d,), device)
        self.bias = _zeros((d,), device)


def layernorm_init(d: int, device=None) -> LayerNorm:
    return LayerNorm(d, device)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.scale
            + p.bias).to(x.dtype)


# --- rotary embeddings -------------------------------------------------------
def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [d/2]
    ang = positions[..., :, None].float() * freqs               # [..., s, d/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --- embedding / unembedding -------------------------------------------------
class Embedding(nn.Module):
    def __init__(self, table: nn.Parameter):
        super().__init__()
        self.table = table


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   device=None) -> Embedding:
    return Embedding(_init(gen, (vocab, d), scale=0.02, device=device))


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied logits head: x [..., d] -> [..., vocab] (f32)."""
    return x.float() @ p.table.float().T


# --- products ----------------------------------------------------------------
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.matmul`` computes
    an f32 activation times a bf16 weight (torch's ``@`` refuses mixed
    types)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


# --- MLPs --------------------------------------------------------------------
class SwiGLU(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, d_ff: int, device=None):
        super().__init__()
        self.w_gate = _init(gen, (d, d_ff), device=device)
        self.w_up = _init(gen, (d, d_ff), device=device)
        self.w_down = _init(gen, (d_ff, d), device=device)


def swiglu_init(gen: torch.Generator, d: int, d_ff: int,
                device=None) -> SwiGLU:
    return SwiGLU(gen, d, d_ff, device)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(mm(x, p.w_gate))
    return mm(g * mm(x, p.w_up), p.w_down)


class GeluMLP(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, d_ff: int, device=None):
        super().__init__()
        self.w_up = _init(gen, (d, d_ff), device=device)
        self.b_up = _zeros((d_ff,), device)
        self.w_down = _init(gen, (d_ff, d), device=device)
        self.b_down = _zeros((d,), device)


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                  device=None) -> GeluMLP:
    return GeluMLP(gen, d, d_ff, device)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu((x @ p.w_up + p.b_up).to(x.dtype), approximate="tanh")
    return (h @ p.w_down + p.b_down).to(x.dtype)
