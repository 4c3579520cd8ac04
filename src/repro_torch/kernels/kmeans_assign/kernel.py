"""ctypes binding of ``csrc/kmeans_assign_segmented.cu`` (built by
``kernels._build`` at first use)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("kmeans_assign_segmented").kmeans_assign_segmented
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(x: torch.Tensor, centers: torch.Tensor, seg: torch.Tensor,
           out: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream (shapes checked by the
    caller); raise if the launch was refused."""
    p, d = x.shape
    s, k, _ = centers.shape
    err = _fn()(x.data_ptr(), centers.data_ptr(), seg.data_ptr(),
                out.data_ptr(), p, s, k, d,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign_segmented launch failed: "
                           f"cudaError {err}")
