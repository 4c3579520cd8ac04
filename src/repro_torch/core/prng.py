"""The slice of ``jax.random`` the LERN fit draws from, in torch integer ops.

The JAX package seeds its k-means++ draws with ``jax.random`` keys; to give
the same draws the port reproduces, bit for bit, the generator it runs:
threefry2x32 with ``jax_threefry_partitionable=True`` and 64-bit mode off.

* A key is an int64 tensor ``[..., 2]`` holding two uint32 words.
* ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xFFFFFFFF]`` (a 32-bit seed,
  so the high word is 0).
* ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))``.
* ``split(key, n)[i]`` = ``threefry2x32(key, (0, i))`` (the 64-bit iota
  ``i`` as its high and low words).
* ``uniform(key)`` (a float32 scalar in [0, 1)): ``bits = y0 ^ y1`` of
  ``threefry2x32(key, (0, 0))``, then the float with exponent 0 and
  mantissa ``bits >> 9``, minus 1.

uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks.  Every
function takes a batch of keys (any leading shape) and works on the keys'
device.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of counts ``(x0, x1)`` under ``key``
    ``[..., 2]``; counts broadcast against the key's leading shape.
    Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} outside the 32-bit range")
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for each key of a batch."""
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key, zero, zero + (int(data) & MASK32))
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., 2]`` -> ``[..., num, 2]``."""
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(cnt), cnt)
    return torch.stack([y0, y1], dim=-1)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32)`` for each key of a batch."""
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key, zero, zero)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
