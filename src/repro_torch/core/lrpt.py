"""L-RPT — LERN Reuse Predictor Table (paper §V-B, §VI-J).

Tagless, direct-mapped table: ``entries`` slots x 5 bits
(valid | RI cluster (2b) | RC cluster (2b)), indexed by hashed block address.
Loaded layer-by-layer during layer-transition time.  Variants:

* full      : 512K entries, index = low block-address bits
* LOptv1/v2 : 128K/256K entries, bitmask index (low 17/18 bits)
* LOptv3/v4 : 128K/256K entries, SplitMix32 hash, low 17/18 bits of the hash

Packed encoding (int8): invalid == 0; valid entry = 0x10 | ri<<2 | rc.
No-Reuse lines are *not* stored (invalid entry == No-Reuse, per the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .lern import LernModel


def splitmix32(x: np.ndarray) -> np.ndarray:
    """SplitMix32 hash [Steele et al. 2014], vectorized on uint32."""
    z = (np.asarray(x, dtype=np.uint64) & 0xFFFFFFFF).astype(np.uint32)
    z = (z + np.uint32(0x9E3779B9)).astype(np.uint32)
    z ^= z >> np.uint32(16)
    z = (z * np.uint32(0x21F0AAAD)).astype(np.uint32)
    z ^= z >> np.uint32(15)
    z = (z * np.uint32(0x735A2D97)).astype(np.uint32)
    z ^= z >> np.uint32(15)
    return z


class _BitmaskHash:
    """Picklable bitmask index hash (cached LERN models store hash_fn)."""
    def __init__(self, bits: int):
        self.mask = (1 << bits) - 1

    def __call__(self, a):
        return np.asarray(a, dtype=np.int64) & self.mask


class _SplitmixHash:
    def __init__(self, bits: int):
        self.mask = (1 << bits) - 1

    def __call__(self, a):
        return (splitmix32(np.asarray(a)) & np.uint32(self.mask)
                ).astype(np.int64)


def make_hash(kind: str, bits: int) -> Callable[[np.ndarray], np.ndarray]:
    if kind == "bitmask":
        return _BitmaskHash(bits)
    if kind == "splitmix32":
        return _SplitmixHash(bits)
    raise ValueError(kind)


VARIANTS = {
    "full":   dict(entries=512 * 1024, hash=("bitmask", 19)),
    "loptv1": dict(entries=128 * 1024, hash=("bitmask", 17)),
    "loptv2": dict(entries=256 * 1024, hash=("bitmask", 18)),
    "loptv3": dict(entries=128 * 1024, hash=("splitmix32", 17)),
    "loptv4": dict(entries=256 * 1024, hash=("splitmix32", 18)),
}


@dataclasses.dataclass
class LRPT:
    entries: int
    hash_fn: Callable[[np.ndarray], np.ndarray]
    table: np.ndarray  # int8 [entries]

    @classmethod
    def create(cls, variant: str = "full") -> "LRPT":
        spec = VARIANTS[variant]
        kind, bits = spec["hash"]
        assert (1 << bits) == spec["entries"], (variant, bits)
        return cls(entries=spec["entries"], hash_fn=make_hash(kind, bits),
                   table=np.zeros(spec["entries"], dtype=np.int8))

    @property
    def size_bytes(self) -> int:
        return self.entries * 5 // 8  # 5 bits/entry

    def load_layer(self, model: LernModel, layer_idx: int) -> None:
        """Populate the table with one layer's clusters (layer-transition
        load, §V-B).  Lines with reuse only; collisions: last write wins —
        with hashed training (§VI-J) aliasing is already internalized.

        Consumes the model's stacked lookup arrays directly (padding and
        No-Reuse rows share the -1 cluster encoding, so one mask drops
        both)."""
        self.table[:] = 0
        rc = model.rc_cluster[layer_idx].astype(np.int64)
        ri = model.ri_cluster[layer_idx].astype(np.int64)
        keep = rc >= 0
        uniq = model.uniq[layer_idx][keep]
        # hashed-trained models (§VI-J) store table keys in `uniq` already;
        # unhashed models are indexed through the table's own hash
        idx = uniq if model.hash_fn is not None else self.hash_fn(uniq)
        packed = (0x10 | (ri[keep] << 2) | rc[keep])
        self.table[idx] = packed.astype(np.int8)

    def lookup(self, lines: np.ndarray) -> tuple:
        """Vectorized lookup -> (rc_cluster, ri_cluster), -1 = No Reuse."""
        e = self.table[self.hash_fn(lines)].astype(np.int64)
        valid = (e & 0x10) != 0
        rc = np.where(valid, e & 0x3, -1)
        ri = np.where(valid, (e >> 2) & 0x3, -1)
        return rc, ri


def pack_tables(model: LernModel, variant: str = "full") -> np.ndarray:
    """All layers' L-RPT images as one [L, entries] int8 lookup table.

    Vectorized over the model's stacked cluster arrays — the device-array
    replacement for per-layer dict materialization.  Row ``li`` equals the
    table ``load_layer(model, li)`` would produce (same last-write-wins
    collision order: numpy fancy assignment applies writes in row-major
    order, which preserves each layer's uniq order)."""
    spec = VARIANTS[variant]
    kind, bits = spec["hash"]
    hash_fn = make_hash(kind, bits)
    n_l = model.uniq.shape[0]
    tables = np.zeros((n_l, spec["entries"]), dtype=np.int8)
    rc = model.rc_cluster.astype(np.int64)
    ri = model.ri_cluster.astype(np.int64)
    keep = rc >= 0  # [L, N]; padding rows are -1 too
    rows = np.broadcast_to(np.arange(n_l)[:, None], keep.shape)[keep]
    uniq = model.uniq[keep]
    idx = uniq if model.hash_fn is not None else hash_fn(uniq)
    packed = (0x10 | (ri[keep] << 2) | rc[keep]).astype(np.int8)
    tables[rows, idx] = packed
    return tables


def lookup_tables(tables: np.ndarray, variant: str, layer: np.ndarray,
                  lines: np.ndarray) -> tuple:
    """Vectorized per-access lookup through the packed [L, entries] tables:
    one gather for a whole trace -> (rc_cluster, ri_cluster), -1 = No
    Reuse."""
    kind, bits = VARIANTS[variant]["hash"]
    hash_fn = make_hash(kind, bits)
    e = tables[np.asarray(layer, np.int64), hash_fn(lines)].astype(np.int64)
    valid = (e & 0x10) != 0
    rc = np.where(valid, e & 0x3, -1)
    ri = np.where(valid, (e >> 2) & 0x3, -1)
    return rc, ri


def lrpt_train_hash(variant: str) -> Optional[Callable]:
    """Hash to apply during LERN *training* so the predictor learns under
    the same aliasing as the hardware (§VI-J). The 'full' table is large
    enough for our traces that training unhashed matches the paper."""
    if variant == "full":
        return None
    kind, bits = VARIANTS[variant]["hash"]
    return make_hash(kind, bits)
