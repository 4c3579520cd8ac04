"""HyDRA-as-a-serving-feature: deadline- and reuse-aware KV-cache HBM
residency (the JAX package's ``serve/hydra_scheduler.py``, ported).

Mapping from the paper:
  LLC space               -> HBM KV-block budget
  accelerator accesses    -> session KV re-references (multi-turn reuse)
  bypass an access        -> do NOT keep a finished turn's KV resident
                             (re-prefill on the next turn if it returns)
  LERN clusters           -> offline clusters of session reuse behavior
                             (RC = turns per session, RI = inter-turn gap)
  APM deadline progress   -> decoded-tokens vs. per-request deadlines
  Fig. 9 thresholds       -> residency aggressiveness per epoch

The APM/threshold machinery is the port's ``core.apm``; the session
clusters are fit by ``core.kmeans.kmeans_fit_batched``, whose Lloyd
assignment is the dense ``kmeans_assign`` kernel on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core import prng
from ..core.apm import APMState
from ..core.kmeans import kmeans_fit_batched
from .knobs import SchedulerKnobs


@dataclasses.dataclass
class SessionProfile:
    """Offline-learnt reuse clusters over completed sessions."""
    rc_centers: np.ndarray      # turns-per-session cluster centers (Cold..Hot)
    ri_centers: np.ndarray      # inter-turn-gap centers (Immediate..Remote)

    @classmethod
    def fit(cls, turns_per_session: np.ndarray, gaps: np.ndarray,
            seed: int = 0, device="cuda") -> "SessionProfile":
        """Cluster both session features with the batched masked k-means:
        the two 1-D problems are padded to one [2, N, 1] batch and fit in
        one call (``kmeans.kmeans_fit_batched``, on ``device``) with the
        keys ``prng.PRNGKey(seed + i)``."""
        dev = _device.resolve(device)
        feats = [np.log1p(turns_per_session, dtype=np.float32),
                 np.log1p(gaps, dtype=np.float32)]
        cap = max(8, max(f.shape[0] for f in feats))
        x = np.zeros((2, cap, 1), np.float32)
        mask = np.zeros((2, cap), bool)
        lo = np.zeros(2, np.float32)
        span = np.ones(2, np.float32)
        for i, f in enumerate(feats):
            n = f.shape[0]
            lo[i], hi = f.min(), f.max()
            span[i] = max(hi - lo[i], 1e-9)
            x[i, :n, 0] = (f - lo[i]) / span[i]
            mask[i, :n] = True
        keys = torch.stack([prng.PRNGKey(seed + i, dev) for i in range(2)])
        res = kmeans_fit_batched(torch.as_tensor(x, device=dev),
                                 torch.as_tensor(mask, device=dev), keys,
                                 k=4, device=dev)
        centers = res.centers.cpu().numpy().reshape(2, 4)
        rc_c = np.expm1(np.sort(centers[0]) * span[0] + lo[0])
        ri_c = np.expm1(np.sort(centers[1]) * span[1] + lo[1])
        return cls(rc_centers=rc_c, ri_centers=ri_c)

    def classify(self, expected_turns: float, expected_gap: float
                 ) -> Tuple[int, int]:
        """-> (rc_cluster 0..3 Cold..Hot, ri_cluster 0..3 Imm..Remote)."""
        rc = int(np.argmin(np.abs(self.rc_centers - expected_turns)))
        ri = int(np.argmin(np.abs(self.ri_centers - expected_gap)))
        return rc, ri


class HydraKVScheduler:
    """Per-epoch residency decisions for finished-turn KV blocks.

    Configured by a frozen :class:`~repro_torch.serve.knobs.SchedulerKnobs`
    (named presets in ``repro_torch.exp.SERVE``).  With a finite
    ``knobs.retrain_period`` the scheduler refits its
    :class:`SessionProfile` every ``retrain_period`` epochs from the
    (turns, gap) features observed since the last refit, on ``device``;
    ``retrain_period=inf`` (the default) never refits.
    """

    def __init__(self, knobs: SchedulerKnobs = None, *,
                 profile: SessionProfile = None, device="cuda", **legacy):
        if legacy or not isinstance(knobs, SchedulerKnobs):
            bad = ", ".join(sorted(legacy)) or repr(knobs)
            raise TypeError(
                "HydraKVScheduler is configured by a frozen "
                "serve.SchedulerKnobs: use HydraKVScheduler("
                "SchedulerKnobs(token_budget=..., deadline_tokens=...), "
                "profile=...) or a registered preset via "
                "serve.resolve_knobs('kv-default') — the old keyword "
                f"constructor was removed (got: {bad})")
        self.device = _device.resolve(device)
        # APM over "tokens decoded" instead of "memory accesses completed"
        self.knobs = knobs
        self.apm = APMState(m_total=int(knobs.deadline_tokens),
                            deadline=float(knobs.deadline_tokens),
                            epoch_len=float(knobs.epoch_tokens),
                            params=knobs.apm)
        self.token_budget = knobs.token_budget
        self.profile = profile
        self.retrain_period = float(knobs.retrain_period)
        # a sparse observed window must not wipe the profile's knowledge
        self.min_refit_sessions = int(knobs.min_refit_sessions)
        self.seed = knobs.seed
        self.ri_th, self.rc_th = 3, -1   # conservative start (keep all)
        self.resident_tokens = 0
        self.evictions = 0
        self.keeps = 0
        self.epochs = 0
        self.refits = 0
        self.refit_failures = 0
        self._window_turns: List[float] = []
        self._window_gaps: List[float] = []

    def epoch_update(self, *, decoded_rate: float, required_rate: float,
                     hbm_pressure: float) -> None:
        """Select this epoch's residency thresholds (Fig. 9 machinery).

        decoded_rate / required_rate play M̂A / MA^(i); hbm_pressure plays
        the core-miss-rate margin condition."""
        ma_i = max(required_rate, 1e-6)
        th = self.apm.bypass_thresholds(ma_i * self.apm.epoch_len)
        self.ri_th, self.rc_th, _ = self.apm.reuse_thresholds(
            decoded_rate * self.apm.epoch_len, ma_i * self.apm.epoch_len, th)
        if hbm_pressure > 0.9:   # margin condition: high contention
            self.ri_th = max(self.ri_th - 1, -1)
            self.rc_th = min(self.rc_th + 1, 4)
        self.epochs += 1
        if (math.isfinite(self.retrain_period) and self.retrain_period > 0
                and self.epochs % max(int(self.retrain_period), 1) == 0):
            self._online_refit()

    def _online_refit(self) -> None:
        """Refit the session-reuse clusters on the observed window and
        swap the profile in place.

        Degrades gracefully: a refit that raises (degenerate window,
        too-few distinct observations, injected fault) keeps serving on
        the stale profile and bumps ``refit_failures``.  The window is kept
        so the next boundary retries with more observations."""
        if len(self._window_turns) < self.min_refit_sessions:
            return
        from ..exp import faults
        try:
            faults.fire("refit", key=f"e{self.epochs}")
            profile = SessionProfile.fit(
                np.asarray(self._window_turns, np.float64),
                np.asarray(self._window_gaps, np.float64),
                seed=self.seed + self.refits, device=self.device)
        except Exception as e:
            self.refit_failures += 1
            faults.log_event("refit_failure", epochs=self.epochs,
                             window=len(self._window_turns),
                             error=str(e)[:200])
            return
        self.profile = profile
        self._window_turns, self._window_gaps = [], []
        self.refits += 1

    def keep_resident(self, session_turns: float, inter_turn_gap: float
                      ) -> bool:
        """Paper's bypass rule: evict iff RI_cluster > RI_Th or
        RC_cluster < RC_Th.  ``knobs.residency`` short-circuits it to the
        keep-all / evict-all baselines (still counted, so the stats stay
        comparable)."""
        if math.isfinite(self.retrain_period):
            self._window_turns.append(float(session_turns))
            self._window_gaps.append(float(inter_turn_gap))
        if self.knobs.residency == "keep-all":
            evict = False
        elif self.knobs.residency == "evict-all":
            evict = True
        elif self.profile is None:
            rc_cl, ri_cl = 2, 1
            evict = (ri_cl > self.ri_th) or (rc_cl < self.rc_th)
        else:
            rc_cl, ri_cl = self.profile.classify(session_turns,
                                                 inter_turn_gap)
            evict = (ri_cl > self.ri_th) or (rc_cl < self.rc_th)
        if evict:
            self.evictions += 1
        else:
            self.keeps += 1
        return not evict

    def stats(self) -> Dict[str, float]:
        tot = self.evictions + self.keeps
        return {"evictions": self.evictions, "keeps": self.keeps,
                "evict_rate": self.evictions / max(tot, 1),
                "ri_th": self.ri_th, "rc_th": self.rc_th,
                "refits": self.refits,
                "refit_failures": self.refit_failures}
