"""ctypes binding of ``csrc/flash_attention.cu`` (built by
``kernels._build`` at first use)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_FN = []


def _fn():
    if not _FN:
        fn = _build.load("flash_attention").flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool) -> None:
    """Enqueue the kernel on the current stream: q and out [B, Sq, H, d],
    k and v [B, Sk, Hkv, d], contiguous, one type (f32 or bf16), shapes
    checked by the caller; raise if the launch was refused."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, sk, h, hkv, d, int(causal),
                int(q.dtype == torch.bfloat16), d ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
