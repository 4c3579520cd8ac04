"""Triton kernel for reuse-interval binning (LERN feature extraction).

Replaces the Pallas TPU kernel ``repro/kernels/ri_histogram/kernel.py::
ri_histogram``.  One program per ``BLOCK`` elements: a masked load, three
compares, a masked store of the bins and four block sums written to the
program's own row of ``partial`` (no atomics, so the counts are
deterministic).  ``triton`` is imported when the kernel is first compiled,
never when this module is imported.
"""
from __future__ import annotations

_KERNEL = None


def _compile():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def ri_histogram_kernel(ri_ptr, bin_ptr, part_ptr, n,
                            E0: tl.constexpr, E1: tl.constexpr,
                            E2: tl.constexpr, NUM_BINS: tl.constexpr,
                            BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        ri = tl.load(ri_ptr + offs, mask=mask, other=-1)
        b = tl.where(ri <= E0, 0, tl.where(ri <= E1, 1,
                                           tl.where(ri <= E2, 2, 3)))
        b = tl.where(ri < 0, -1, b).to(tl.int32)
        tl.store(bin_ptr + offs, b, mask=mask)
        for j in tl.static_range(NUM_BINS):
            tl.store(part_ptr + pid * NUM_BINS + j,
                     tl.sum((b == j).to(tl.int32), axis=0))

    return triton, ri_histogram_kernel


def launch(ri, bins, partial, edges, block: int) -> None:
    """Enqueue the kernel on the current stream: ``ri``/``bins`` int32
    ``[N]`` and ``partial`` int32 ``[cdiv(N, block), 4]`` on the card."""
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = _compile()
    triton, kern = _KERNEL
    n = ri.shape[0]
    grid = (triton.cdiv(n, block),)
    e0, e1, e2 = edges
    kern[grid](ri, bins, partial, n, E0=e0, E1=e1, E2=e2,
               NUM_BINS=partial.shape[1], BLOCK=block, num_warps=8)
