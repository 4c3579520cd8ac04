"""ctypes binding of ``csrc/llc_rounds.cu`` (built by ``kernels._build`` at
first use): the round loop of an epoch chunk as the cluster kernel (the
path's, ``launch``), at a chosen shape and stage (``launch_shaped``, the
probe's), as the first one-CTA-a-lane design (``launch_simple``, for the
cross-check), the empty launch of that design, and the cluster's shape.
Every launch runs with its tensors' card as the current device, where the
kernel's attributes are set and its launch shape is checked (per card in
the source)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import on_card

_FNS = {}
# llc_rounds_cluster's out array
SHAPE_FIELDS = ("cluster", "threads", "cta_sets", "smem_bytes",
                "smem_tables", "group_lanes", "active_clusters")


def _fn(name: str, n_ptr: int, n_int: int, stream: bool = True,
        n_out: int = 0):
    """The C function ``name`` of ``csrc/llc_rounds.cu``: ``n_ptr`` pointer
    and ``n_int`` int arguments, then a stream if ``stream``, then
    ``n_out`` pointers."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("llc_rounds"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * (stream + n_out))
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def _args(line, meta, knobs, n_rounds, rows, tick, shct_core, shct_accel,
          stats, percore, entries, sampler_shift, region_lines, counter_max):
    tags, lru, owner, sig, reused = rows
    n_lanes, rounds, sets = line.shape
    return [line.data_ptr(), meta.data_ptr(), knobs.data_ptr(),
            None if n_rounds is None else n_rounds.data_ptr(),
            tags.data_ptr(), lru.data_ptr(), owner.data_ptr(),
            sig.data_ptr(), reused.data_ptr(), tick.data_ptr(),
            shct_core.data_ptr(), shct_accel.data_ptr(), stats.data_ptr(),
            percore.data_ptr(), n_lanes, rounds, sets, tags.shape[-1],
            entries, sampler_shift, region_lines, counter_max]


def launch(line, meta, knobs, n_rounds, rows, tick, shct_core, shct_accel,
           stats, percore, *, entries: int, sampler_shift: int,
           region_lines: int, counter_max: int) -> None:
    """Enqueue the cluster kernel on the current stream.  ``line``/``meta``
    int32 [L, R, S]; ``knobs`` int32 [L, 5]; ``n_rounds`` int32 [L] or None;
    ``rows`` the (tags, lru, owner, sig, reused) [L, S, W] state; ``tick``
    int32 [L]; the SHCT tables int32 [L, T]; ``stats`` int32 [L, 10] and
    ``percore`` int32 [L, 8, 2] are written.  All contiguous on one card
    (checked by the caller); raise if the launch was refused."""
    args = _args(line, meta, knobs, n_rounds, rows, tick, shct_core,
                 shct_accel, stats, percore, entries, sampler_shift,
                 region_lines, counter_max)
    with on_card(line.device):
        _check("llc_rounds", _fn("llc_rounds", 14, 8)(
            *args, _stream(line.get_device())))


def launch_simple(line, meta, knobs, n_rounds, rows, tick, shct_core,
                  shct_accel, stats, percore, *, entries: int,
                  sampler_shift: int, region_lines: int,
                  counter_max: int) -> None:
    """``launch`` through the first design (one CTA per lane, the rows in
    device memory): the same results, for the cross-check and timing."""
    args = _args(line, meta, knobs, n_rounds, rows, tick, shct_core,
                 shct_accel, stats, percore, entries, sampler_shift,
                 region_lines, counter_max)
    with on_card(line.device):
        _check("llc_rounds_simple", _fn("llc_rounds_simple", 14, 8)(
            *args, _stream(line.get_device())))


def launch_shaped(line, meta, knobs, n_rounds, rows, tick, shct_core,
                  shct_accel, stats, percore, *, entries: int,
                  sampler_shift: int, region_lines: int, counter_max: int,
                  cluster: int = 0, threads: int = 0,
                  stage: int = 3) -> None:
    """The cluster kernel with ``cluster`` CTAs a lane and ``threads`` a
    CTA (0: as ``launch`` picks) at ``stage``: 3 computes what ``launch``
    does; 0 (the kernel's cluster barriers and nothing else), 1 (+ the
    events), 2 (+ the row search) are the probe's ablation, 4 and 5 its
    barriers as relaxed cluster barriers or as ``__syncthreads``; these
    leave no result; -1 launches an empty kernel at the shape."""
    args = _args(line, meta, knobs, n_rounds, rows, tick, shct_core,
                 shct_accel, stats, percore, entries, sampler_shift,
                 region_lines, counter_max)
    with on_card(line.device):
        _check("llc_rounds_shaped", _fn("llc_rounds_shaped", 14, 11)(
            *args, cluster, threads, stage, _stream(line.get_device())))


def launch_empty(n_lanes: int, sets: int, device) -> None:
    """Enqueue the empty kernel with the launch shape of ``launch_simple``."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with torch.cuda.device(index):
        _check("llc_rounds_empty", _fn("llc_rounds_empty", 0, 2)(
            n_lanes, sets, _stream(index)))


def cluster_shape(sets: int, ways: int, entries: int, sampler_shift: int,
                  rounds: int = 128, cluster: int = 0,
                  threads: int = 0) -> dict:
    """The cluster kernel's shape for a geometry and a chunk of ``rounds``
    rows (``SHAPE_FIELDS``; 0 for ``cluster`` / ``threads``: as ``launch``
    picks), with the number of such clusters the card holds at once.
    Raises for a geometry the kernel does not take."""
    out = (ctypes.c_int * len(SHAPE_FIELDS))()
    err = _fn("llc_rounds_cluster", 0, 7, stream=False, n_out=1)(
        sets, ways, entries, sampler_shift, rounds, cluster, threads, out)
    if err != 0:
        raise RuntimeError(f"llc_rounds_cluster: cudaError {err}")
    return dict(zip(SHAPE_FIELDS, out))
