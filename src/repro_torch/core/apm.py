"""Accelerator Progress Monitor (paper §V-A) — margins, dynamic bypass
thresholds (Algorithm 1) and reuse-threshold selection (Fig. 9).

All quantities are per-epoch scalars; the module is pure Python (the epoch
loop is host-side; the per-access work is in llc.py).

Notation (paper):
  M          total accesses in one input set
  D_sec      deadline for one input set (cycles here)
  ET         epoch length (cycles)
  MA_global  = (M / D_sec) * ET      required completions per epoch
  RA, RT     remaining accesses / remaining time at epoch start
  MA_past    = (M - RA) * ET / (D_sec - RT)   average completed per epoch
  MA^(i)     this epoch's requirement (with safety margins, Fig. 8)
  M̂A^(i)    = MLP * ET / AMAL^(i-1)  predicted completions this epoch
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class APMParams:
    """Paper §VI-L final parameter selection."""
    margin_high: float = 0.05   # 5% of deadline
    margin_low: float = 0.01    # 1%
    mr_threshold: float = 0.30  # MR_Th
    alpha: float = 0.10         # global-progress tolerance
    beta: float = 0.05          # threshold-band tolerance
    delta_a: float = 0.20       # T_A step
    delta_b: float = 0.10       # T_B step
    # base (reset) values of the five dynamic bypass thresholds
    t_a4: float = 2.0
    t_a3: float = 1.5
    t_a2: float = 1.2
    t_a1: float = 1.0
    t_b: float = 0.8


@dataclasses.dataclass
class APMState:
    m_total: int          # M
    deadline: float       # D_sec in cycles
    epoch_len: float      # ET
    params: APMParams

    @property
    def ma_global(self) -> float:
        return self.m_total / self.deadline * self.epoch_len

    def margin(self, mr_i: float, ma_past: float) -> float:
        """Fig. 8 margin requirement estimation."""
        p = self.params
        high_contention = mr_i > p.mr_threshold
        behind_global = ma_past < (1.0 + p.alpha) * self.ma_global
        if high_contention and behind_global:
            return p.margin_high          # condition 4: hardest to recover
        if high_contention or behind_global:
            return p.margin_low           # conditions 2-3: mild inflation
        return 0.0                        # condition 1: on track

    def epoch_requirement(self, ra: float, rt: float, mr_i: float,
                          ma_past: float) -> float:
        """MA^(i): accesses required this epoch (margin-inflated)."""
        m = self.margin(mr_i, ma_past)
        eff_rt = max(rt - m * self.deadline, self.epoch_len)
        return ra / eff_rt * self.epoch_len

    def bypass_thresholds(self, ma_i: float) -> Tuple[float, ...]:
        """Algorithm 1: scale the five thresholds by the proportional
        difference between MA^(i) and MA_global."""
        p = self.params
        mag = self.ma_global
        t_a = [p.t_a1, p.t_a2, p.t_a3, p.t_a4]
        t_b = p.t_b
        if ma_i <= (1.0 - 6.0 * p.beta) * mag:
            t_a = [max(t - 6.0 * p.delta_a, 1.0) for t in t_a]
            t_b = t_b - 6.0 * p.delta_b
        else:
            matched = False
            for k in range(5, 0, -1):
                lo = (1.0 - (k + 1) * p.beta) * mag
                hi = (1.0 - k * p.beta) * mag
                if lo < ma_i <= hi:
                    t_a = [max(t - k * p.delta_a, 1.0) for t in t_a]
                    t_b = t_b - k * p.delta_b
                    matched = True
                    break
            if not matched:
                if ma_i > (1.0 + p.beta) * mag:
                    t_a = [t + p.delta_a for t in t_a]
                # within ±beta: unchanged
        return (t_a[0], t_a[1], t_a[2], t_a[3], t_b)

    def reuse_thresholds(self, ma_hat: float, ma_i: float,
                         thresholds: Tuple[float, ...]
                         ) -> Tuple[int, int, bool]:
        """Fig. 9: map predicted progress to (RI_Th, RC_Th, special_cases).

        Bypass rule downstream: bypass iff RI_cluster > RI_Th or
        RC_cluster < RC_Th (No-Reuse encoded as (-1,-1) bypasses whenever
        RC_Th >= 0).  special_cases=True additionally bypasses Cold-cluster
        lines whose center implies at most one further reuse (§V-C)."""
        t_a1, t_a2, t_a3, t_a4, t_b = thresholds
        if ma_hat > t_a4 * ma_i:
            return (-1, 4, False)   # bypass all
        if ma_hat > t_a3 * ma_i:
            return (0, 3, False)
        if ma_hat > t_a2 * ma_i:
            return (1, 2, False)
        if ma_hat > t_a1 * ma_i:
            return (2, 1, False)
        if ma_hat > t_b * ma_i:
            return (3, 0, True)     # special cases active
        return (3, -1, False)       # no bypass


def bypass_mask(rc_cluster, ri_cluster, ri_th: int, rc_th: int,
                special: bool, cold_center: float):
    """Vectorized Fig. 9 bypass decision for (rc, ri) cluster id arrays
    (-1 == No Reuse).  Returns bool array."""
    import numpy as np
    rc = np.asarray(rc_cluster)
    ri = np.asarray(ri_cluster)
    byp = (ri > ri_th) | (rc < rc_th)
    if special and cold_center <= 2.0:
        byp = byp | (rc == 0)
    return byp
