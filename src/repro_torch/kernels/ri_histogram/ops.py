"""Reuse-interval binning: wrapper, plain version and launch counter.

Replaces the TPU kernel ``repro/kernels/ri_histogram/kernel.py::ri_histogram``
(wrapper ``ops.histogram``; called from ``repro/core/reuse.py::_ri_bins_kernel``).
Maps each reuse interval to its F_RI bin ([1,10], (10,100], (100,500],
(500,inf); -1 = no reuse) and counts bins 0-3.

On the card it is bound by bytes: it reads 4 B and writes 4 B per element
(at the main path's N of about 3e5, about 2.4 MB, under a microsecond at
the H100's 3.35 TB/s), so the launch dominates.  The design keeps it to
one pass and one launch: each program bins one block and writes its four
block counts to its own row, and the wrapper folds the rows with one
``sum``; no atomics, so counts are deterministic.
"""
from __future__ import annotations

import torch

BIN_EDGES = (10, 100, 500)
NUM_BINS = 4
BLOCK = 4096


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
    Triton kernel (``histogram.launches`` counts those launches)."""
    if ri.device.type == "cpu":
        return histogram_plain(ri)
    if ri.device.type != "cuda":
        raise ValueError(f"ri_histogram: unsupported device {ri.device}")
    if ri.dtype != torch.int32 or ri.dim() != 1 or not ri.is_contiguous():
        raise ValueError("ri_histogram: expects a contiguous int32 [N] tensor")
    n = ri.shape[0]
    if n == 0:
        raise ValueError("ri_histogram: empty input")
    from . import kernel
    bins = torch.empty(n, dtype=torch.int32, device=ri.device)
    partial = torch.empty(((n + BLOCK - 1) // BLOCK, NUM_BINS),
                          dtype=torch.int32, device=ri.device)
    kernel.launch(ri, bins, partial, BIN_EDGES, BLOCK)
    histogram.launches += 1
    return bins, partial.sum(0, dtype=torch.int32)


histogram.launches = 0
