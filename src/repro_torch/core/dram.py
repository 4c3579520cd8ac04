"""Off-chip memory timing models (paper Table II + §VI-H3).

Fluid (epoch-granularity) models: each model has an unloaded line latency
and a peak line service rate (lines / system cycle @ 2 GHz); queueing delay
under utilization rho follows an M/D/1-shaped law, capped for stability.
The LPDDR5 model reflects its 32B bursts (2 accesses / 64B line -> lower
effective line rate, higher effective latency) per §VI-H3.

Pure Python, a copy of the JAX package's fluid models.  The scheduled
bank/rank backend (``SchedDramModel`` there) is not ported yet; asking for
it raises ``NotImplementedError`` (ROADMAP.md Queue 1 item 9).
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


# 2 GHz system clock.  DDR3-1600 single channel 64-bit: 12.8 GB/s peak
# = 0.1 lines/cycle;  DDR4-2400: 19.2 GB/s = 0.15;  LPDDR5-5500 x16:
# 11 GB/s with 32B bursts -> ~0.086 lines/cycle but two bursts per line.
DDR3_1600 = DramModel("DDR3_1600_8x8", latency_cycles=100.0,
                      peak_lines_per_cycle=0.100, efficiency=0.70)
DDR4_2400 = DramModel("DDR4_2400_8x8", latency_cycles=90.0,
                      peak_lines_per_cycle=0.150, efficiency=0.70)
LPDDR5_5500 = DramModel("LPDDR5_5500_1x16_BG_BL16", latency_cycles=130.0,
                        peak_lines_per_cycle=0.086, efficiency=0.80)

MODELS = {m.name: m for m in (DDR3_1600, DDR4_2400, LPDDR5_5500)}

# The JAX package's scheduled bank/rank backends (``SchedDramModel``) are
# not ported yet: ROADMAP.md Queue 1 item 9.
SCHED_MODEL_NAMES = ("DDR3_1600_8b1r_squash", "DDR4_2400_32b2r_frfcfs",
                     "DDR4_2400_32b2r_squash")


def dram_kind(model: DramModel) -> str:
    """Artifact tag for the model family: ``fluid`` (the JAX package tags
    its scheduled models ``sched:<policy>``; asking for one raises until
    that backend is ported)."""
    if model.name in SCHED_MODEL_NAMES:
        raise NotImplementedError(
            f"{model.name!r}: the scheduled DRAM backend is not ported yet "
            "(ROADMAP.md Queue 1 item 9)")
    return "fluid"


def default_model() -> DramModel:
    """Default DRAM model for call sites that don't pin one.

    ``REPRO_DRAM`` overrides it: empty/``fluid`` -> DDR3-1600 fluid, a
    fluid model's name -> that model; ``sched`` or a scheduled model's name
    raises until that backend is ported."""
    name = os.environ.get("REPRO_DRAM", "").strip()
    if name in ("", "fluid"):
        return DDR3_1600
    if name == "sched" or name in SCHED_MODEL_NAMES:
        raise NotImplementedError(
            f"REPRO_DRAM={name!r}: the scheduled DRAM backend is not ported "
            "yet (ROADMAP.md Queue 1 item 9)")
    return MODELS[name]
