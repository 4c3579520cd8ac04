"""Roofline terms of a dry-run cell on NVIDIA H100 terms (the JAX
package's ``launch/roofline.py``, its formula kept, none of its TPU
constants).

Hardware constants: NVIDIA H100 80GB HBM3 (SXM), 700 W -- the data
sheet's dense rates, as PERF.md's kernel table uses them:

    PEAK_FLOPS = 989e12   bf16 dense, a card
    HBM_BW     = 3.35e12  bytes/s, a card
    NVLINK_BW  = 450e9    bytes/s a card and direction, inside an
                          eight-card node (NVLink 4)
    IB_BW      = 50e9     bytes/s a card and direction across nodes (one
                          400 Gb/s NDR port a card, as in a DGX H100)

    compute term    = FLOPs / (cards x PEAK_FLOPS)
    memory term     = bytes / (cards x HBM_BW)
    collective term = collective bytes a card / link bw

The link: a collective on a mesh axis that spans more than eight cards
leaves the node, so it runs at ``IB_BW``; one inside an eight-card node at
``NVLINK_BW``.  A mesh's cards are numbered in mesh order, the last axis
fastest, so an axis spans ``size x (product of the sizes after it)``
consecutive cards.  On the (16, 16) and (2, 16, 16) meshes every axis
spans at least two nodes (``"model"`` 16 cards, ``"data"`` 256), so every
collective term divides by ``IB_BW`` there.

``collective_bytes`` has no HLO to parse: ``CollectiveBytes`` is a
dispatch mode that sees the local ops DTensor issues and sums each
collective's *result* bytes on this rank (a ring all-gather moves ~result
x (n-1)/n a card; the reference reports the same conservative sum).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card and direction, in a node
IB_BW = 50e9                 # bytes/s / card and direction, across nodes
NODE_CARDS = 8

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveBytes(TorchDispatchMode):
    """Counts the functional collectives (``torch.ops._c10d_functional``)
    run while it is active: ``counts()`` gives the bytes of their results
    on this rank by kind (the five of the reference, ``collective-permute``
    always 0) and ``count``, the number of calls.  It lets every DTensor-
    level op through to DTensor (returning ``NotImplemented``), so it sees
    the local ops and collectives DTensor issues for it."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(KINDS, 0)
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        if packet is not None and getattr(packet, "_qualified_op_name",
                                          "").startswith("_c10d_functional"):
            kind = _C10D.get(packet.__name__)
            if kind is not None:
                self.bytes[kind] += _nbytes(out)
                self.calls += 1
        return out

    def counts(self) -> Dict[str, int]:
        return dict(self.bytes, count=self.calls)


def collective_bw(axis_sizes: Sequence[int]) -> float:
    """The link rate of the mesh's slowest collective axis: ``IB_BW`` if
    an axis spans more than ``NODE_CARDS`` consecutive cards, else
    ``NVLINK_BW`` (a mesh of one card: ``NVLINK_BW``, moot)."""
    span, widest = 1, 1
    for s in reversed(tuple(axis_sizes)):
        span *= s
        if s > 1:
            widest = span
    return IB_BW if widest > NODE_CARDS else NVLINK_BW


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes_per_dev: float, n_chips: int,
                   cost_is_global: bool = True,
                   link_bw: float = IB_BW) -> Dict[str, float]:
    """Three roofline terms in seconds.  flops/bytes may be global (the
    dry-run's DTensor-level counts) or per-card; collective bytes are
    always this card's.  ``link_bw``: ``collective_bw`` of the mesh (both
    production meshes: ``IB_BW``)."""
    div = n_chips if cost_is_global else 1
    t_compute = flops / div / PEAK_FLOPS
    t_memory = bytes_accessed / div / HBM_BW
    t_coll = coll_bytes_per_dev / link_bw
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dom[0],
            "bound_s": dom[1]}
