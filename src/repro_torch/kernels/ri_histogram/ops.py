"""Reuse-interval binning: wrapper, plain version and launch counter.

Replaces the TPU kernel ``repro/kernels/ri_histogram/kernel.py::ri_histogram``
(wrapper ``ops.histogram``; called from ``repro/core/reuse.py::_ri_bins_kernel``).
Maps each reuse interval to its F_RI bin ([1,10], (10,100], (100,500],
(500,inf); -1 = no reuse) and counts bins 0-3.

On the card it is bound by bytes: it reads 4 B and writes 4 B per element
(at the main path's N of about 3e5, about 2.4 MB, under a microsecond at
the H100's 3.35 TB/s), so the launch dominates.  The design keeps a call
to one launch of ``csrc/ri_histogram.cu``: a single thread-block cluster
bins the input and folds the four counts through distributed shared
memory (no atomics, so counts are deterministic; no second kernel, no
memset).
"""
from __future__ import annotations

import torch

from . import kernel

BIN_EDGES = (10, 100, 500)
NUM_BINS = 4


def histogram_plain(ri: torch.Tensor):
    """The plain PyTorch version: ri [N] int32 -> (bins [N] int32,
    counts [4] int32)."""
    e0, e1, e2 = BIN_EDGES
    b = torch.where(ri <= e0, 0, torch.where(
        ri <= e1, 1, torch.where(ri <= e2, 2, 3)))
    b = torch.where(ri < 0, -1, b).to(torch.int32)
    counts = torch.stack([(b == j).sum() for j in range(NUM_BINS)])
    return b, counts.to(torch.int32)


def histogram(ri: torch.Tensor):
    """ri [N] int32 -> (bins [N] int32, counts [4] int32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (``histogram.launches`` counts those launches) or raises.  The
    checks and allocations are the call's host cost beside a kernel of a
    few microseconds, so they are kept to the cheapest forms."""
    if not ri.is_cuda:
        if ri.device.type == "cpu":
            return histogram_plain(ri)
        raise ValueError(f"ri_histogram: unsupported device {ri.device}")
    if ri.dtype != torch.int32 or ri.dim() != 1 or not ri.is_contiguous():
        raise ValueError("ri_histogram: expects a contiguous int32 [N] tensor")
    n = ri.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"ri_histogram: N = {n} is outside [1, 2^31)")
    # bins at ri's offset from a 16-byte boundary (0 for a fresh tensor):
    # the kernel's 16-byte vectors need both at the same one
    phase = ri.data_ptr() % 16 // 4
    bins = torch.empty_like(ri) if phase == 0 else ri.new_empty(
        phase + n)[phase:]
    counts = ri.new_empty(NUM_BINS)
    kernel.launch(ri, bins, counts)
    histogram.launches += 1
    return bins, counts


histogram.launches = 0
