"""Flash attention (forward): the wrapper, its plain version and the launch
counters of the two CUDA C++ kernels.

``mha`` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention`` (body
``_flash_kernel``; wrapper ``ops.mha``; oracle ``ref.mha_ref``), called from
``models/attention.py::attention(use_flash=True)`` for causal attention
without a window.  Source: ``src/repro_torch/csrc/flash_attention.cu``,
two kernels: ``route`` sends bf16 to the Hopper kernel ("wgmma": both
products on the tensor cores, a TMA-fed K/V ring, a producer warpgroup)
and f32 to the CUDA-core kernel ("simt"), whose bar of 2e-5 rules out
TF32.  On the card attention is bound by operations (4 H d S^2 / 2 flops
for causal attention at S tokens, on O(S H d) bytes); both kernels read
``[B, S, H, d]`` strided, never repeat K and V for GQA, and skip the key
blocks wholly above the diagonal.  See the source for their design.

``mha_plain`` is the same blocked online softmax in torch ops: a loop over
key blocks of ``min(128, Sk)`` columns with all query rows vectorised, the
scores in f32 times ``float32(d ** -0.5)``, the -1e30 causal fill, ``p``
rounded to the input type before the PV product, and ``l`` clamped at
1e-20.  Under the causal mask it updates only the rows at or below a
block's first column: the rows above see only masked columns, where
``p = 0`` and ``alpha = 1`` exactly, so skipping them changes nothing.
"""
from __future__ import annotations

import torch

BLOCK = 128                       # the Pallas kernel's block_q and block_k
HEAD_DIMS = (32, 64, 128, 256)    # the kernels' instantiations
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
KERNELS = ("wgmma", "simt")       # the Hopper kernel, the CUDA-core one


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` for what the kernel does not take: the shapes
    the JAX kernel's assert refuses (``Sq % min(128, Sq)``, ``Sk % min(128,
    Sk)``), a head size not in ``HEAD_DIMS``, mismatched shapes, types or
    devices."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"mha: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, sq, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if bk != b or dk != d or hkv == 0 or h % hkv or min(b, sq, sk, h) == 0:
        raise ValueError(f"mha: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if sq % min(BLOCK, sq) or sk % min(BLOCK, sk):
        raise ValueError(f"mha: sequence lengths {sq}, {sk} must be "
                         f"multiples of 128 or at most 128")
    if d not in HEAD_DIMS:
        raise ValueError(f"mha: head size {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mha: expects f32 or bf16 q, k, v of one type, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("mha: q, k, v on different devices")


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """The plain PyTorch version: q [B, Sq, H, d]; k, v [B, Sk, Hkv, d] ->
    [B, Sq, H, d] in q's type."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    bk = min(BLOCK, sk)
    scale = d ** -0.5
    # q head h reads kv head h // rep: [B, Hkv, rep, S, d] against
    # [B, Hkv, 1, S, d] (broadcast, not repeated)
    qf = q.float().permute(0, 2, 1, 3).reshape(b, hkv, rep, sq, d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((b, hkv, rep, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, rep, sq), device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, d), device=q.device)
    rows = torch.arange(sq, device=q.device)
    for c0 in range(0, sk, bk):
        r0 = c0 if causal else 0
        if r0 >= sq:
            break
        kb = kf[..., c0:c0 + bk, :]
        s = (qf[..., r0:, :] @ kb.transpose(-1, -2)) * scale
        if causal:
            cols = c0 + torch.arange(bk, device=q.device)
            s = torch.where(rows[r0:, None] >= cols[None, :], s, NEG_INF)
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * alpha + p.sum(-1)
        pv = p.to(v.dtype).float() @ vf[..., c0:c0 + bk, :]
        acc[..., r0:, :] = acc[..., r0:, :] * alpha[..., None] + pv
        m[..., r0:] = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def route(q: torch.Tensor) -> str:
    """The kernel that takes a CUDA call with this q (both are built for
    every head size in ``HEAD_DIMS``): "wgmma", the Hopper kernel, for
    bf16; "simt", the CUDA-core kernel, for f32."""
    return "wgmma" if q.dtype == torch.bfloat16 else "simt"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as TMA reads it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """Launch the kernel ``route`` names on checked inputs and count it:
    ``mha.launches`` in all and ``mha.kernel_launches[name]`` by kernel,
    both through the module-level name ``mha``.  A refused launch raises;
    nothing falls back to the other kernel or to ``mha_plain``."""
    from . import kernel
    name = route(q)
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    kernel.launch(q, k, v, out, causal, name)
    mha.launches += 1
    mha.kernel_launches[name] += 1
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, d]; k, v [B, Sk, Hkv, d] -> [B, Sq, H, d] (f32 or bf16;
    ``check`` says which shapes).

    A CPU tensor takes the plain version; a CUDA tensor launches a CUDA
    kernel (``launch``).  Under autograd it raises on every device: the
    kernel has no backward, so its output would carry no gradient to the
    attention projections (the training path takes the dense and chunked
    routes)."""
    check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention has no backward kernel: call it without "
            "autograd (torch.no_grad or torch.inference_mode) and train "
            "with use_flash=False, the dense and chunked routes, as the "
            "reference's trainer does (ROADMAP.md Queue 1 item 13a)")
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    return launch(q, k, v, causal)


mha.launches = 0
mha.kernel_launches = dict.fromkeys(KERNELS, 0)
