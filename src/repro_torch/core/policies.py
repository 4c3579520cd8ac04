"""Policy zoo — every cache-management policy evaluated in the paper.

Naming (paper §III): { Arbitration - C(policy) - A(policy) - Deadline }:
C = core bypass, A = accelerator bypass; S = SHIP-driven, L = LERN-driven;
-D = deadline-aware.  HyDRA == ARP-CS-AL-D.

``-ol`` (online-LERN) variants refit the LERN clusters every
``retrain_period`` epochs from the observed epoch trace and swap the
L-RPT images in place (reuse behavior drifts across phases; see
Cohmeleon-style online orchestration).  ``retrain_period=None`` or an
infinite period degenerates bitwise to the offline policy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .apm import APMParams
from .llc import A_HINT, A_NONE, A_RAND, A_SHIP
from .ship import SHIP_DEFAULT, SHIP_LARGE, ShipParams


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    arbitration: str = "fifo"          # "fifo" | "arp" | "flash"
    core_bypass: bool = False          # SHIP-driven core response bypass
    accel_mode: int = A_NONE
    accel_predictor: Optional[str] = None  # "lern" | "ship" | "random"
    deadline_aware: bool = False
    hydra: bool = False                # full APM threshold modulation
    asth_t: float = 1.0                # §VI-G: AS-D bypass-start fraction
    afr_p: float = 0.0                 # §VI-F: random bypass probability
    shared_predictor: bool = False     # ARP-CAS
    dpcp: bool = False                 # §VI-D: 1-way partition + prefetch
    way_partition: Optional[Tuple[int, int]] = None  # (core_mask, accel_mask)
    lrpt_variant: str = "full"
    retrain_period: Optional[float] = None  # online-LERN refit period (epochs)
    ship_params: ShipParams = SHIP_DEFAULT
    apm: APMParams = dataclasses.field(default_factory=APMParams)


def _mk(name, **kw) -> Policy:
    return Policy(name=name, **kw)


POLICIES: Dict[str, Policy] = {}


def _reg(p: Policy) -> Policy:
    POLICIES[p.name] = p
    return p


# --- no-bypass & core-only baselines (§VI-C1a) ------------------------------
_reg(_mk("fifo-nb"))
_reg(_mk("fifo-cs", core_bypass=True))
_reg(_mk("arp-nb", arbitration="arp"))
_reg(_mk("arp-cs", arbitration="arp", core_bypass=True))

# --- accel bypass, SHIP vs LERN (§VI-C1b/c) ---------------------------------
_reg(_mk("arp-as", arbitration="arp", accel_mode=A_SHIP, accel_predictor="ship"))
_reg(_mk("arp-as-d", arbitration="arp", accel_mode=A_SHIP,
         accel_predictor="ship", deadline_aware=True))
_reg(_mk("arp-al", arbitration="arp", accel_mode=A_HINT, accel_predictor="lern"))
_reg(_mk("arp-al-d", arbitration="arp", accel_mode=A_HINT,
         accel_predictor="lern", deadline_aware=True, hydra=True))

# --- shared vs separate predictors (§VI-C1d/e) ------------------------------
_reg(_mk("arp-cas", arbitration="arp", core_bypass=True, accel_mode=A_SHIP,
         accel_predictor="ship", shared_predictor=True))
_reg(_mk("arp-cs-as", arbitration="arp", core_bypass=True, accel_mode=A_SHIP,
         accel_predictor="ship"))
_reg(_mk("arp-cs-as-d", arbitration="arp", core_bypass=True,
         accel_mode=A_SHIP, accel_predictor="ship", deadline_aware=True))

# --- HyDRA (ARP-CS-AL-D) and its no-core-bypass variant ---------------------
_reg(_mk("hydra", arbitration="arp", core_bypass=True, accel_mode=A_HINT,
         accel_predictor="lern", deadline_aware=True, hydra=True))
# LPDDR5-tuned variant (§VI-H3): larger recovery margins
_reg(_mk("hydra-v1", arbitration="arp", core_bypass=True, accel_mode=A_HINT,
         accel_predictor="lern", deadline_aware=True, hydra=True,
         apm=APMParams(margin_high=0.10, margin_low=0.02)))

# --- probabilistic + threshold variants (§VI-F/G) ---------------------------
_reg(_mk("arp-cs-afr0.6", arbitration="arp", core_bypass=True,
         accel_mode=A_RAND, accel_predictor="random", afr_p=0.6))
_reg(_mk("arp-cs-afr0.8", arbitration="arp", core_bypass=True,
         accel_mode=A_RAND, accel_predictor="random", afr_p=0.8))
_reg(_mk("arp-cs-asth0.3-d", arbitration="arp", core_bypass=True,
         accel_mode=A_SHIP, accel_predictor="ship", deadline_aware=True,
         asth_t=0.3))
_reg(_mk("arp-cs-asth0.6-d", arbitration="arp", core_bypass=True,
         accel_mode=A_SHIP, accel_predictor="ship", deadline_aware=True,
         asth_t=0.6))

# --- prior work (§VI-D) ------------------------------------------------------
_reg(_mk("dpcp", dpcp=True, way_partition=(0xFFFE, 0x0001)))
_reg(_mk("flash", arbitration="flash"))

# --- predictor-size studies (§VI-K) ------------------------------------------
_reg(_mk("arp-cs-as-large", arbitration="arp", core_bypass=True,
         accel_mode=A_SHIP, accel_predictor="ship", ship_params=SHIP_LARGE))


DEFAULT_RETRAIN_PERIOD = 100.0  # epochs between online-LERN refits


def with_online(p: Policy,
                period: float = DEFAULT_RETRAIN_PERIOD) -> Policy:
    """Online-LERN variant of a LERN-driven policy (``<name>-ol``)."""
    assert p.accel_predictor == "lern", p.name
    return dataclasses.replace(p, name=f"{p.name}-ol", retrain_period=period)


# --- online-LERN variants (device-resident retraining in the loop) ----------
_reg(with_online(POLICIES["arp-al"]))
_reg(with_online(POLICIES["hydra"]))


def with_way_partition(p: Policy, core_mask: int, accel_mask: int) -> Policy:
    return dataclasses.replace(
        p, name=f"{p.name}-wp", way_partition=(core_mask, accel_mask))


def with_lrpt(p: Policy, variant: str) -> Policy:
    return dataclasses.replace(p, name=f"{p.name}-{variant}",
                               lrpt_variant=variant)


def get(name: str) -> Policy:
    return POLICIES[name]
