"""ctypes binding of ``csrc/llc_rounds.cu`` (built by ``kernels._build`` at
first use): the round loop of an epoch chunk, the same launch of an empty
kernel (the floor of a call's time) and where the SHCT tables sit."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_FNS = {}


def _fn(name: str, n_ptr: int, n_int: int, stream: bool = True):
    """The C function ``name`` of ``csrc/llc_rounds.cu``: ``n_ptr`` pointer
    and ``n_int`` int arguments, then a stream if ``stream``."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("llc_rounds"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def launch(line, meta, knobs, n_rounds, rows, tick, shct_core, shct_accel,
           stats, percore, *, entries: int, sampler_shift: int,
           region_lines: int, counter_max: int) -> None:
    """Enqueue the kernel on the current stream.  ``line``/``meta`` int32
    [L, R, S]; ``knobs`` int32 [L, 5]; ``n_rounds`` int32 [L] or None;
    ``rows`` the (tags, lru, owner, sig, reused) [L, S, W] state; ``tick``
    int32 [L]; the SHCT tables int32 [L, T]; ``stats`` int32 [L, 10] and
    ``percore`` int32 [L, 8, 2] are written.  All contiguous on one card
    (checked by the caller); raise if the launch was refused."""
    tags, lru, owner, sig, reused = rows
    n_lanes, rounds, sets = line.shape
    _check("llc_rounds", _fn("llc_rounds", 14, 8)(
        line.data_ptr(), meta.data_ptr(), knobs.data_ptr(),
        None if n_rounds is None else n_rounds.data_ptr(),
        tags.data_ptr(), lru.data_ptr(), owner.data_ptr(), sig.data_ptr(),
        reused.data_ptr(), tick.data_ptr(), shct_core.data_ptr(),
        shct_accel.data_ptr(), stats.data_ptr(), percore.data_ptr(),
        n_lanes, rounds, sets, tags.shape[-1], entries, sampler_shift,
        region_lines, counter_max, _stream(line.get_device())))


def launch_empty(n_lanes: int, sets: int, device) -> None:
    """Enqueue the empty kernel with the launch shape of ``launch``."""
    index = torch.device(device).index
    _check("llc_rounds_empty", _fn("llc_rounds_empty", 0, 2)(
        n_lanes, sets, _stream(torch.cuda.current_device() if index is None
                               else index)))


def smem_tables(entries: int) -> bool:
    """Whether both SHCT tables of ``entries`` entries sit in the CTA's
    shared memory (else the kernel works on them in device memory)."""
    return bool(_fn("llc_rounds_smem_tables", 0, 1, stream=False)(entries))
