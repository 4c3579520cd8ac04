"""ctypes binding of ``csrc/flash_attention.cu`` (built by
``kernels._build`` at first use): ``flash_attention_sm90``, the Hopper
kernel for bf16, and ``flash_attention``, the CUDA-core kernel for f32.
Every launch runs with its tensors' card as the current device."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import on_card

# the C entry point of each kernel, by the name ops.route gives it
_ENTRY = {"wgmma": "flash_attention_sm90", "simt": "flash_attention"}
# |s (tensor cores) - s (f32 chain)| <= BOUND_ULPS x 2^-24 x |q| x |k| for
# every score s = q . k: the Hopper kernel recomputes by the chain the few
# scores near a bf16 rounding midpoint of p (or near the running max) in
# rows where one rounding of p can move an output.  The largest ratio
# measured on the card is about 4 up to d = 128 and 4.68 at d = 256 (an
# attention sink; tools/flash_probe.py; PERF.md).
BOUND_ULPS = 16.0
# the Hopper kernel's own refusals, besides cudaError codes
_REFUSALS = {-1: "the driver has no cuTensorMapEncodeTiled",
             -2: "the driver refused a tensor map"}
_FNS = {}


def _fn(kernel: str):
    fn = _FNS.get(kernel)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), _ENTRY[kernel])
        if kernel == "wgmma":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[kernel] = fn
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, kernel: str) -> None:
    """Enqueue ``kernel`` ("wgmma" or "simt") on the current stream: q and
    out [B, Sq, H, d], k and v [B, Sk, Hkv, d], contiguous, one type (bf16
    and 16-byte aligned for "wgmma", f32 for "simt"), shapes checked by the
    caller; raise if the launch was refused."""
    with on_card(q.device):
        _launch(q, k, v, out, causal, kernel)


def _launch(q, k, v, out, causal: bool, kernel: str) -> None:
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kernel == "wgmma":
        # the largest key norm of each (batch row, kv head), [B, Hkv]; the
        # caching allocator reuses its memory only for work queued after
        # the kernel on this stream
        kmax = torch.linalg.vector_norm(k, dim=-1,
                                        dtype=torch.float32).amax(1)
        err = _fn(kernel)(*ptrs, kmax.data_ptr(), b, sq, sk, h, hkv, d,
                          int(causal), d ** -0.5,
                          BOUND_ULPS * 2.0 ** -24 * d ** -0.5, stream)
    else:
        err = _fn(kernel)(*ptrs, b, sq, sk, h, hkv, d, int(causal),
                          d ** -0.5, stream)
    if err != 0:
        why = _REFUSALS.get(err, f"cudaError {err}")
        raise RuntimeError(f"flash_attention ({kernel}) launch failed: {why}")


def smem_bytes(d: int) -> int:
    """The dynamic shared memory a block of the Hopper kernel takes at head
    size d (0 for a head size it was not built for)."""
    fn = _build.load("flash_attention").flash_attention_sm90_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(d)
