"""Batched serving engine with slot-based continuous batching and the
HyDRA KV-residency scheduler (the JAX package's ``serve/engine.py``,
ported as written).

Real model execution (``lm.decode_step`` on the port's model) with
multi-turn sessions: when a turn finishes, the scheduler decides whether the
session's KV stays resident (instant next turn) or is evicted (next turn
pays a re-prefill).  Deadlines are per-request token-latency budgets; the
engine reports throughput + deadline miss rate -- the serving analogue of
the paper's (IPC, DMR) pair.

What the reference does, this does too, since its numbers depend on it:
prefill feeds each prompt token through ``decode_step`` to every slot, the
slots share one position, the decode input is all zeros, and the
``serve_admission`` and ``serve_step`` fault sites (``repro_torch.exp.
faults``) fire where they fire there.  The step is a plain call under
``torch.inference_mode()`` where the JAX package jits it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import lm
from ..train.step import make_serve_step
from .hydra_scheduler import HydraKVScheduler


@dataclasses.dataclass
class Request:
    session_id: int
    prompt: List[int]
    max_new: int
    deadline_steps: int         # engine-step budget to finish this turn
    arrival: int = 0
    expected_turns: float = 2.0
    expected_gap: float = 64.0


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    produced: int = 0
    started: int = 0
    last: int = 0


class ServeEngine:
    """Runs on the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 s_max: int = 256,
                 scheduler: Optional[HydraKVScheduler] = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = slots
        self.s_max = s_max
        self.sched = scheduler
        self.device = params.embed.table.device
        self.state = lm.init_decode_state(params, cfg, slots, s_max)
        self.slots = [_Slot() for _ in range(slots)]
        self.resident: Dict[int, bool] = {}   # session -> KV resident?
        self.step_fn = make_serve_step(cfg)
        self.completed: List[Dict] = []
        self.reprefills = 0
        self.clock = 0

    def _tokens(self, tok: int) -> torch.Tensor:
        return torch.full((self.n_slots, 1), tok, dtype=torch.int64,
                          device=self.device)

    # -- admission -------------------------------------------------------------
    def _admit(self, queue: List[Request]) -> None:
        if queue and any(s.req is None for s in self.slots):
            from ..exp import faults
            faults.fire("serve_admission", key=f"t{self.clock}")
        for i, slot in enumerate(self.slots):
            if slot.req is not None or not queue:
                continue
            req = queue.pop(0)
            # returning session with evicted KV pays a re-prefill penalty
            if req.session_id in self.resident and \
                    not self.resident[req.session_id]:
                self.reprefills += 1
            slot.req = req
            slot.produced = 0
            slot.started = self.clock
            # prefill: feed prompt tokens one step at a time
            for tok in req.prompt:
                _, self.state = self.step_fn(self.params, self.state,
                                             self._tokens(tok))

    # -- main loop ---------------------------------------------------------------
    def run(self, requests: List[Request], max_steps: int = 2000) -> Dict:
        queue = sorted(requests, key=lambda r: r.arrival)
        pending = [r for r in queue]
        epoch_tokens = 0
        while (pending or any(s.req for s in self.slots)) \
                and self.clock < max_steps:
            ready = [r for r in pending if r.arrival <= self.clock]
            for r in ready:
                pending.remove(r)
            self._admit(ready)
            pending = ready + pending  # unadmitted stay queued

            # one batched decode step over all active slots
            logits, self.state = self.step_fn(self.params, self.state,
                                              self._tokens(0))
            self.clock += 1
            active = 0
            for i, slot in enumerate(self.slots):
                if slot.req is None:
                    continue
                active += 1
                slot.produced += 1
                epoch_tokens += 1
                if slot.produced >= slot.req.max_new:
                    dur = self.clock - slot.started
                    self.completed.append({
                        "session": slot.req.session_id,
                        "latency": dur,
                        "missed": dur > slot.req.deadline_steps})
                    if self.sched is not None:
                        keep = self.sched.keep_resident(
                            slot.req.expected_turns, slot.req.expected_gap)
                    else:
                        keep = True
                    self.resident[slot.req.session_id] = keep
                    slot.req = None

            # epoch update for the scheduler
            if self.sched is not None and self.clock % 16 == 0:
                from ..exp import faults
                faults.fire("serve_step", key=f"e{self.clock // 16}")
                need = sum(1 for s in self.slots if s.req) or 1
                self.sched.epoch_update(
                    decoded_rate=active / max(need, 1),
                    required_rate=1.0,
                    hbm_pressure=len([v for v in self.resident.values()
                                      if v]) / max(self.n_slots * 2, 1))

        miss = [c["missed"] for c in self.completed]
        return {
            "completed": len(self.completed),
            "dmr": float(np.mean(miss)) if miss else 0.0,
            "throughput_tok_per_step": epoch_tokens / max(self.clock, 1),
            "reprefills": self.reprefills,
            "scheduler": self.sched.stats() if self.sched else None,
        }
