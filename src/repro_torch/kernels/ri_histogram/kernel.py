"""ctypes binding of ``csrc/ri_histogram.cu`` (built by ``kernels._build``
at first use): the kernel, the same launch of an empty kernel (the floor
of a call's time) and the cluster's size and fit.  Every launch runs
with its tensors' card as the current device."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import on_card

_FNS = {}


def _fn(name: str, n_ptr: int, n_int: int, stream: bool = True):
    """The C function ``name`` of ``csrc/ri_histogram.cu`` with ``n_ptr``
    pointer and ``n_int`` int arguments, then a stream if ``stream``."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("ri_histogram"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(index: int) -> int:
    """The current stream of device ``index`` as a raw ``cudaStream_t``
    (``torch.cuda.current_stream`` builds a Python object, which costs
    more host time than the launch itself)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(ri: torch.Tensor, bins: torch.Tensor,
           counts: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream: ``ri`` and ``bins`` int32
    [N], ``counts`` int32 [4] (contiguous, checked by the caller); raise if
    the launch was refused."""
    with on_card(ri.device):
        _check("ri_histogram", _fn("ri_histogram", 3, 1)(
            ri.data_ptr(), bins.data_ptr(), counts.data_ptr(), ri.shape[0],
            _stream(ri.get_device())))


def launch_empty(device) -> None:
    """Enqueue the empty kernel, launched as ``launch`` launches the
    kernel, on the current stream of ``device``."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with torch.cuda.device(index):
        _check("ri_histogram_empty", _fn("ri_histogram_empty", 0, 0)(
            _stream(index)))


def cluster() -> tuple:
    """(CTAs in the launch's cluster, how many such clusters the card holds
    at once by ``cudaOccupancyMaxActiveClusters``)."""
    size, active = ctypes.c_int(), ctypes.c_int()
    _check("cudaOccupancyMaxActiveClusters", _fn(
        "ri_histogram_cluster", 2, 0, stream=False)(
        ctypes.addressof(size), ctypes.addressof(active)))
    return size.value, active.value
