"""ctypes bindings of ``csrc/kmeans_assign_segmented.cu`` and
``csrc/kmeans_assign.cu`` (built by ``kernels._build`` at first use): the
two assignment kernels and the two whole-fit kernels."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import on_card

_FNS = {}


def _fn(name: str, n_ptr: int, n_int: int, lib: str = None):
    """The C function ``name`` of ``csrc/<lib>.cu`` (``lib`` defaults to
    ``name``) with ``n_ptr`` pointer and ``n_int`` int arguments and a
    stream."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(lib or name), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    """``fn(*args, stream)`` on ``x``'s card, the current device there, and
    its current stream; raise if the launch was refused."""
    with on_card(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def launch_segmented(x: torch.Tensor, centers: torch.Tensor,
                     seg: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the segmented kernel on the current stream (shapes checked
    by the caller); raise if the launch was refused."""
    p, d = x.shape
    s, k, _ = centers.shape
    _launch("kmeans_assign_segmented", _fn("kmeans_assign_segmented", 4, 4),
            x, x.data_ptr(), centers.data_ptr(), seg.data_ptr(),
            out.data_ptr(), p, s, k, d)


def launch_dense(x: torch.Tensor, centers: torch.Tensor,
                 out: torch.Tensor) -> None:
    """Enqueue the dense kernel on the current stream: x [B, N, D],
    centers [B, K, D] (contiguous, f32 or bf16), out [B, N] int32; raise
    if the launch was refused."""
    b, n, d = x.shape
    k = centers.shape[1]
    _launch("kmeans_assign", _fn("kmeans_assign", 3, 5), x, x.data_ptr(),
            centers.data_ptr(), out.data_ptr(), b, n, k, d,
            int(x.dtype == torch.bfloat16))


def launch_fit(x: torch.Tensor, mask: torch.Tensor, centers: torch.Tensor,
               out: torch.Tensor, a: torch.Tensor, iters: int) -> None:
    """Enqueue the masked Lloyd fit on the current stream: x [B, N, D] f32,
    mask [B, N] bool, centers and out [B, K, D] f32, a [B, N] uint8
    scratch (contiguous, shapes checked by the caller); raise if the
    launch was refused."""
    b, n, d = x.shape
    k = centers.shape[1]
    _launch("kmeans_fit", _fn("kmeans_fit", 5, 5, "kmeans_assign"), x,
            x.data_ptr(), mask.data_ptr(), centers.data_ptr(),
            out.data_ptr(), a.data_ptr(), b, n, k, d, iters)


def launch_fit_segmented(x: torch.Tensor, seg: torch.Tensor,
                         layout: torch.Tensor, centers: torch.Tensor,
                         out: torch.Tensor, sweeps: torch.Tensor,
                         conv: torch.Tensor, a: torch.Tensor, iters: int,
                         width: int) -> None:
    """Enqueue every segment's Lloyd fit on the current stream: x [P, D]
    f32, seg [P] int32, layout [2, S] int32 (first rows, row counts),
    centers and out [S, K, D] f32, sweeps [S] int32, conv [S] bool, a [P]
    uint8 scratch (contiguous, shapes checked by the caller); raise if the
    launch was refused."""
    p, d = x.shape
    s, k, _ = centers.shape
    _launch("kmeans_fit_segmented", _fn("kmeans_fit_segmented", 8, 6,
                                        "kmeans_assign_segmented"), x,
            x.data_ptr(), seg.data_ptr(), layout.data_ptr(),
            centers.data_ptr(), out.data_ptr(), sweeps.data_ptr(),
            conv.data_ptr(), a.data_ptr(), p, s, k, d, iters, width)
