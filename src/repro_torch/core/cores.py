"""Synthetic SPEC-CPU2006-like core traffic (paper Tables II/III).

SPEC binaries are not redistributable; only the *LLC-visible* stream matters
for the paper's policies (DESIGN.md §2).  Each benchmark is modelled as a
parameterized address-stream generator:

  apkc     LLC accesses per kilo-cycle at nominal IPC (post-L2 filter)
  p_reuse  probability an access revisits a recently-used line (LRU-stack
           draw with geometric recency) vs. advancing a streaming pointer
  ws_lines working-set size in cache lines (streaming wraps around it)
  ipc0     standalone IPC with an ideal LLC
  sens     memory sensitivity: stall CPI per cycle of average LLC-side
           latency per kilo-instruction (DESIGN.md §6 model)

Categories (paper §VI-B): CI compute-, LI LLC-, MI memory-intensive.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoreProfile:
    name: str
    category: str      # "CI" | "LI" | "MI"
    apkc: float        # LLC accesses / kilocycle
    p_reuse: float     # fraction of accesses hitting the *hot* region
    ws_lines: int      # total footprint (cold/streaming region)
    ipc0: float
    write_frac: float = 0.30  # L2 writeback share
    hot_frac: float = 0.125   # hot region size as fraction of ws_lines


P = CoreProfile
PROFILES: Dict[str, CoreProfile] = {p.name: p for p in [
    # LLC-intensive: big reused working sets
    P("omnetpp", "LI", 6.0, 0.85, 96 * 1024, 1.3),
    P("soplex", "LI", 5.0, 0.70, 160 * 1024, 1.2),
    P("astar", "LI", 3.0, 0.55, 64 * 1024, 1.1),
    P("bzip2", "LI", 3.0, 0.60, 80 * 1024, 1.4),
    # compute-intensive: small footprints, low APKC
    P("gamess", "CI", 0.3, 0.60, 8 * 1024, 2.0),
    P("povray", "CI", 0.4, 0.70, 8 * 1024, 1.9),
    P("namd", "CI", 0.5, 0.50, 16 * 1024, 1.8),
    P("gromacs", "CI", 0.8, 0.60, 16 * 1024, 1.7),
    P("hmmer", "CI", 1.0, 0.80, 16 * 1024, 1.9),
    P("sjeng", "CI", 0.8, 0.40, 24 * 1024, 1.5),
    P("gobmk", "CI", 1.0, 0.50, 24 * 1024, 1.4),
    P("h264ref", "CI", 1.5, 0.70, 32 * 1024, 1.7),
    P("dealII", "CI", 2.0, 0.60, 48 * 1024, 1.5),
    P("wrf", "CI", 2.5, 0.40, 96 * 1024, 1.2),
    # memory-intensive: streaming / giant footprints
    P("mcf", "MI", 12.0, 0.45, 2 * 1024 * 1024, 0.7, hot_frac=0.02),
    P("lbm", "MI", 8.0, 0.05, 4 * 1024 * 1024, 0.9),
    P("bwaves", "MI", 7.0, 0.10, 4 * 1024 * 1024, 0.9),
    P("milc", "MI", 6.0, 0.15, 2 * 1024 * 1024, 0.8),
    P("zeusmp", "MI", 4.0, 0.30, 1024 * 1024, 1.0),
    P("GemsFDTD", "MI", 6.0, 0.20, 2 * 1024 * 1024, 0.8),
    P("leslie3d", "MI", 5.0, 0.20, 2 * 1024 * 1024, 0.9),
    P("libquantum", "MI", 9.0, 0.02, 4 * 1024 * 1024, 1.0),
]}

# Table III — the 12-mix evaluation set (gs=gamess, so=soplex, om=omnetpp).
MIXES: Dict[str, List[str]] = {
    "mix1": ["wrf", "hmmer", "gromacs", "namd", "bzip2", "gromacs", "povray", "dealII"],
    "mix2": ["soplex", "soplex", "soplex", "soplex", "gamess", "gamess", "omnetpp", "omnetpp"],
    "mix3": ["gamess", "gamess", "gamess", "soplex", "soplex", "omnetpp", "omnetpp", "omnetpp"],
    "mix4": ["soplex", "gamess", "soplex", "omnetpp", "soplex", "gamess", "gamess", "gamess"],
    "mix5": ["omnetpp", "omnetpp", "soplex", "gamess", "gamess", "gamess", "soplex", "soplex"],
    "mix6": ["GemsFDTD", "hmmer", "GemsFDTD", "gamess", "bwaves", "lbm", "mcf", "zeusmp"],
    "mix7": ["povray", "astar", "gromacs", "omnetpp", "gamess", "omnetpp", "soplex", "gamess"],
    "mix8": ["sjeng", "namd", "gobmk", "bzip2", "lbm", "bwaves", "libquantum", "mcf"],
    "mix9": ["gamess", "gamess", "gamess", "soplex", "omnetpp", "mcf", "milc", "zeusmp"],
    "mix10": ["povray", "dealII", "soplex", "omnetpp", "gamess", "gamess", "lbm", "milc"],
    "mix11": ["hmmer", "hmmer", "gamess", "gamess", "lbm", "milc", "leslie3d", "bwaves"],
    "mix12": ["h264ref", "gamess", "soplex", "gamess", "soplex", "mcf", "lbm", "zeusmp"],
}

# motivation-section mixes (§III: 1 = omnetpp x8, 2 = omnetpp x4 + mcf x4)
MIXES["moti1"] = ["omnetpp"] * 8
MIXES["moti2"] = ["omnetpp"] * 4 + ["mcf"] * 4

# address-space layout: each core gets its own 2^24-line region above the
# accelerator's region (which starts at 0).
CORE_REGION_BITS = 24


def core_base(core_id: int) -> int:
    return (core_id + 8) << CORE_REGION_BITS


def generate_stream_fast(profile: CoreProfile, n: int, core_id: int,
                         seed: int = 0) -> np.ndarray:
    """Vectorized bimodal stream: a *hot* region (long-lived reuse, zipf-ish
    popularity — cache-friendly and SHIP-learnable) plus a *cold* region
    streamed with stride 1 (dead-on-fill).  The hot/cold split is what gives
    reuse predictors signal, as in real SPEC workloads."""
    from .llc import HW_SCALE
    rng = np.random.default_rng(seed * 1000 + core_id)
    base = core_base(core_id)
    ws = max(profile.ws_lines // HW_SCALE, 512)  # scaled memory system
    hot = max(int(ws * profile.hot_frac), 64)
    is_hot = rng.random(n) < profile.p_reuse
    # hot draws: squared-uniform ~ zipf-ish popularity skew within hot region
    hot_line = base + (rng.random(n) ** 2 * hot).astype(np.int64)
    # cold draws: stride-1 stream through the remaining footprint
    adv = (~is_hot).astype(np.int64)
    sptr = np.cumsum(adv) - adv
    cold_line = base + hot + (sptr % max(ws - hot, 256))
    return np.where(is_hot, hot_line, cold_line)


def epoch_accesses(profile: CoreProfile, ipc: float, epoch_cycles: float) -> int:
    """How many LLC accesses this core issues in one epoch at ``ipc``."""
    nominal = profile.apkc / 1000.0 * epoch_cycles
    return int(nominal * ipc / profile.ipc0)


def core_ipc(profile: CoreProfile, hit_rate: float, llc_lat: float,
             miss_lat: float, llc_queue: float) -> float:
    """DESIGN.md §6 analytic IPC model: stall CPI from LLC-side AMAT.

    MLP of 4 outstanding misses assumed for OoO cores."""
    mlp = 4.0
    amat = hit_rate * (llc_lat + llc_queue) + (1 - hit_rate) * miss_lat
    stall_cpi = profile.apkc / 1000.0 * amat / mlp
    return 1.0 / (1.0 / profile.ipc0 + stall_cpi)
