"""SHiP-style signature-based hit predictor (baseline, paper §V-D/§VI-K).

The accelerator has no PC, so (as in SHiP-Mem) the signature is a hashed
memory *region* (32 consecutive lines).  Counter table semantics:

* on LLC hit       : saturating-increment the counter of the signature that
                     inserted the line
* on eviction of a never-reused line : saturating-decrement its signature
* prediction       : counter == 0  ->  dead-on-fill  ->  bypass candidate

Default: 4K entries x 3-bit counters; "Large" variant (§VI-K): 128K x 8-bit.
The update/lookup logic itself lives inside the LLC round loop (llc.py);
this module holds parameters + the signature hash.

The uint32 hash runs in int64 with ``& 0xFFFFFFFF`` masks (torch's uint32
coverage is thin); the 32x32-bit product is split into 16-bit halves so no
intermediate leaves the int64 range.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class ShipParams:
    entries: int = 4096
    counter_bits: int = 3
    region_lines: int = 32  # lines per signature region

    @property
    def counter_max(self) -> int:
        return (1 << self.counter_bits) - 1

    @property
    def init_value(self) -> int:
        # weakly-reused initial state (mid-low), standard SHiP practice
        return 1

    @property
    def size_bytes(self) -> int:
        return self.entries * self.counter_bits // 8


SHIP_DEFAULT = ShipParams()
SHIP_LARGE = ShipParams(entries=128 * 1024, counter_bits=8)


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32) and a constant
    ``c`` in [0, 2**32), without leaving the int64 range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def signature(lines: torch.Tensor, p: ShipParams = SHIP_DEFAULT
              ) -> torch.Tensor:
    """Region signature, xor-folded into the table index space (int64)."""
    r = torch.div(lines.to(torch.int64), p.region_lines,
                  rounding_mode="floor") & MASK32
    h = r ^ (r >> 7) ^ (r >> 15)
    h = mul32(h, _GOLDEN)
    return (h >> 16) & (p.entries - 1)


def signature_np(lines: np.ndarray, p: ShipParams = SHIP_DEFAULT) -> np.ndarray:
    r = (np.asarray(lines, np.int64) // p.region_lines).astype(np.uint32)
    h = r ^ (r >> 7) ^ (r >> 15)
    h = (h * np.uint32(_GOLDEN)).astype(np.uint32)
    return ((h >> 16).astype(np.int64)) & (p.entries - 1)


def init_table(p: ShipParams = SHIP_DEFAULT, device="cpu") -> torch.Tensor:
    return torch.full((p.entries,), p.init_value, dtype=torch.int32,
                      device=device)
