"""Shared layout helpers for the kernel wrappers."""
from __future__ import annotations

import contextlib

import torch

# Row granularity of the flat-segmented k-means layout: every segment's
# point run is padded to a multiple of this, so each SEG_BLOCK-row block
# belongs to exactly one segment and the segmented assignment kernel reads
# one segment id per block.
SEG_BLOCK = 8


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n``."""
    return ((n + multiple - 1) // multiple) * multiple


def block_and_pad(n: int, block: int, floor: int = 8) -> tuple:
    """Pick a block size for an ``n``-row input and the padded row count.

    Inputs at least ``block`` rows long keep the full block; shorter ones
    shrink to ``max(floor, n)`` so tiny traces don't pay for a full block
    of padding.  Returns ``(block_n, n_padded)`` with
    ``n_padded % block_n == 0``.
    """
    block_n = block if n >= block else max(floor, n)
    return block_n, round_up(n, block_n)


def pad_rows(x: torch.Tensor, n_padded: int, fill) -> torch.Tensor:
    """Pad ``x`` along axis 0 to ``n_padded`` rows with ``fill``."""
    out = torch.full((n_padded,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[: x.shape[0]] = x
    return out


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add:
    the product of two float32 values is exact in float64, so only the
    sum rounds twice (float64, then float32), which differs from one
    rounding only when the float64 sum lands exactly on a float32
    midpoint (about 2**-29 of cases)."""
    return (a.double() * b.double() + c.double()).float()


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_d a[..., d] * b[..., d]`` as the fused multiply-add chain
    ``fma(a3, b3, fma(a2, b2, fma(a1, b1, a0 * b0)))`` -- the arithmetic
    XLA's CPU backend emits for this dot, so distances agree bitwise with
    the JAX package and with the assignment kernel."""
    out = a[..., 0] * b[..., 0]
    for t in range(1, a.shape[-1]):
        out = fma32(a[..., t], b[..., t], out)
    return out


def seq_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` adding its entries in ascending order."""
    v = v.movedim(dim, 0)
    out = v[0]
    for t in range(1, v.shape[0]):
        out = out + v[t]
    return out


def dot_lanes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_d a[..., d] * b[..., d]`` in the arithmetic of XLA's CPU
    matrix product (``x @ centers.T``), measured on the JAX package: for
    D < 4 a fused multiply-add chain in ascending d (as ``dot_fma``); for
    D >= 4 four accumulators, lane l taking d = l, l + 4, ... by fused
    multiply-add, then ``(l0 + l1) + (l2 + l3)`` -- at D = 4 the pairwise
    sum of the four products.  Measured equal for D = 1..4, 8 and 16."""
    d = a.shape[-1]
    if d < 4:
        return dot_fma(a, b)
    lanes = [a[..., t] * b[..., t] for t in range(4)]
    for t in range(4, d):
        lanes[t % 4] = fma32(a[..., t], b[..., t], lanes[t % 4])
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def on_card(device: torch.device):
    """``device`` as the current CUDA device (nothing off the card): a
    ``ctypes`` entry sets its kernel's attributes, checks its shape and
    launches on the current device, and a bucket's shard enqueues its
    events and copies there, which a process that uses several cards must
    not leave to chance."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())
