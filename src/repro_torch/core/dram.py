"""Off-chip memory timing models (paper Table II + §VI-H3).

Fluid (epoch-granularity) models: each model has an unloaded line latency
and a peak line service rate (lines / system cycle @ 2 GHz); queueing delay
under utilization rho follows an M/D/1-shaped law, capped for stability.
The LPDDR5 model reflects its 32B bursts (2 accesses / 64B line -> lower
effective line rate, higher effective latency) per §VI-H3.

Scheduled models (:class:`SchedDramModel`) add a bank/rank timing backend
(row-buffer hit/miss/conflict costs, per-bank queue backlog, rank bus
contention, FR-FCFS vs SQUASH-style deadline-urgency arbitration) evaluated
by ``core/dramsched.py``.  The fluid fields double as the rate/latency
envelope (caps, LLC-side utilization), so a scheduled model drops into every
fluid call site unchanged.

Pure Python, a copy of the JAX package's models.
"""
from __future__ import annotations

import dataclasses
import os

# Fluid-model stability constants.  Two different floors appear on purpose:
#
# * QUEUE_TRAFFIC_FLOOR guards the *service capacity* denominator
#   ``rate * window`` against a zero-length window (rho would be 0/0);
#   any positive traffic over a zero window then saturates to the rho cap.
# * QUEUE_STAB_FLOOR guards the *stability* denominator ``2 * (1 - rho)``.
#   With rho capped at QUEUE_RHO_CAP the denominator is at least
#   ``2 * (1 - 0.999) = 2e-3 > QUEUE_STAB_FLOOR`` — the floor is therefore
#   non-binding and exists only as belt-and-braces against float error in
#   ``1 - rho``.
QUEUE_RHO_CAP = 0.999
QUEUE_STAB_FLOOR = 1e-3
QUEUE_TRAFFIC_FLOOR = 1e-9
QUEUE_DELAY_CAP_X = 25.0   # delay cap, in multiples of unloaded latency


def queue_delay_consts(model: "DramModel", window_cycles: float):
    """``(denominator, delay_cap)`` for the fluid queueing law over a fixed
    window: the floored service capacity ``max(rate * window, floor)`` and
    the absolute delay cap ``25 x latency`` (``DramModel.queue_delay``)."""
    return (max(model.rate * window_cycles, QUEUE_TRAFFIC_FLOOR),
            QUEUE_DELAY_CAP_X * model.latency_cycles)


@dataclasses.dataclass(frozen=True)
class DramModel:
    name: str
    latency_cycles: float      # unloaded access latency (system cycles)
    peak_lines_per_cycle: float
    efficiency: float          # sustained fraction of peak

    @property
    def rate(self) -> float:
        return self.peak_lines_per_cycle * self.efficiency

    def queue_delay(self, traffic_lines: float, window_cycles: float) -> float:
        """Extra queueing latency per access given ``traffic_lines`` served
        in ``window_cycles`` (M/D/1 shape, capped at 25x unloaded)."""
        denom, delay_cap = queue_delay_consts(self, window_cycles)
        rho = min(traffic_lines / denom, QUEUE_RHO_CAP)
        w = (rho / max(2.0 * (1.0 - rho), QUEUE_STAB_FLOOR)) / self.rate
        return min(w, delay_cap)

    def utilization(self, traffic_lines: float, window_cycles: float) -> float:
        return min(traffic_lines / max(self.rate * window_cycles,
                                       QUEUE_TRAFFIC_FLOOR), 1.0)


@dataclasses.dataclass(frozen=True)
class SchedDramModel(DramModel):
    """Bank/rank scheduled timing model (FR-FCFS or SQUASH-style).

    Geometry (``banks``/``ranks``/``samples``/``col_bits``) fixes the shapes
    of the per-lane bank state; the cycle costs and the ``scheduler`` kind
    are data (``dramsched.timing_tuple``).  Cycle costs are integers in
    system cycles (``core/dramsched.py`` holds the update rule)."""
    scheduler: str = "frfcfs"   # "frfcfs" | "squash"
    banks: int = 16             # total banks (power of two)
    ranks: int = 2              # banks are split evenly across ranks
    samples: int = 32           # address samples per epoch (fixed shape)
    col_bits: int = 2           # line-address bits below the bank field
    t_cas: int = 12             # row-hit access (CAS) cost, cycles
    t_rcd: int = 12             # activate (RAS-to-CAS) cost, cycles
    t_rp: int = 12              # precharge cost on a row conflict, cycles
    t_bus: int = 4              # per-line rank bus occupancy, cycles
    reset_period: int = 8       # epochs between row-table resets
    queue_cap: int = 4096       # per-bank backlog clamp, cycles

    def __post_init__(self):
        assert self.banks > 0 and self.banks & (self.banks - 1) == 0
        assert self.ranks > 0 and self.banks % self.ranks == 0
        assert self.scheduler in ("frfcfs", "squash"), self.scheduler


# 2 GHz system clock.  DDR3-1600 single channel 64-bit: 12.8 GB/s peak
# = 0.1 lines/cycle;  DDR4-2400: 19.2 GB/s = 0.15;  LPDDR5-5500 x16:
# 11 GB/s with 32B bursts -> ~0.086 lines/cycle but two bursts per line.
DDR3_1600 = DramModel("DDR3_1600_8x8", latency_cycles=100.0,
                      peak_lines_per_cycle=0.100, efficiency=0.70)
DDR4_2400 = DramModel("DDR4_2400_8x8", latency_cycles=90.0,
                      peak_lines_per_cycle=0.150, efficiency=0.70)
LPDDR5_5500 = DramModel("LPDDR5_5500_1x16_BG_BL16", latency_cycles=130.0,
                        peak_lines_per_cycle=0.086, efficiency=0.80)


# Scheduled variants: the fluid envelope of the base part plus bank/rank
# timing.  DDR3 cycle costs in 2 GHz system cycles are ~1.25x the DDR4 ones;
# its 8-bank single-rank geometry saturates the wait cap, while the 32-bank
# dual-rank DDR4 parts keep per-bank waits under it, so FR-FCFS and SQUASH
# arbitration separate (fig. 17).
DDR3_1600_SQUASH = SchedDramModel(
    "DDR3_1600_8b1r_squash", latency_cycles=100.0,
    peak_lines_per_cycle=0.100, efficiency=0.70, scheduler="squash",
    banks=8, ranks=1, t_cas=15, t_rcd=15, t_rp=15, t_bus=5)
DDR4_2400_FRFCFS = SchedDramModel(
    "DDR4_2400_32b2r_frfcfs", latency_cycles=90.0,
    peak_lines_per_cycle=0.150, efficiency=0.70, scheduler="frfcfs",
    banks=32, ranks=2)
DDR4_2400_SQUASH = SchedDramModel(
    "DDR4_2400_32b2r_squash", latency_cycles=90.0,
    peak_lines_per_cycle=0.150, efficiency=0.70, scheduler="squash",
    banks=32, ranks=2)

MODELS = {m.name: m for m in (DDR3_1600, DDR4_2400, LPDDR5_5500,
                              DDR3_1600_SQUASH, DDR4_2400_FRFCFS,
                              DDR4_2400_SQUASH)}


def dram_kind(model: DramModel) -> str:
    """Artifact tag for the model family: ``fluid`` or ``sched:<policy>``."""
    if isinstance(model, SchedDramModel):
        return f"sched:{model.scheduler}"
    return "fluid"


def default_model() -> DramModel:
    """Default DRAM model for call sites that don't pin one.

    ``REPRO_DRAM`` overrides it: empty/``fluid`` -> DDR3-1600 fluid,
    ``sched`` -> the DDR3-1600 SQUASH backend, anything else is looked up in
    ``MODELS`` by name."""
    name = os.environ.get("REPRO_DRAM", "").strip()
    if name in ("", "fluid"):
        return DDR3_1600
    if name == "sched":
        return DDR3_1600_SQUASH
    return MODELS[name]
