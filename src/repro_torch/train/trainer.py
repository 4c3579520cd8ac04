"""Fault-tolerant training loop (the JAX package's ``train/trainer.py`` in
PyTorch):

* auto-resume from the latest checkpoint (params/opt/step),
* periodic async checkpoints + graceful SIGTERM/SIGINT checkpoint
  (preemption handling),
* per-step deadline straggler mitigation: a step exceeding
  ``straggler_factor`` x the rolling median of the last 20 is logged and
  counted,
* deterministic data (pure function of step) so recovery is exact,
* the reference's loss-spike guard, as it behaves there: a step with a
  non-finite loss is left out of the history, its update already applied.

Checkpoints hold ``{"params", "opt"}`` in the JAX package's layout
(``convert.lm_tree_from_params``, ``convert.opt_state_to_numpy``), so a
run of either package resumes from the other's.  The step is not compiled
(the reference's ``_compile_step`` has no counterpart: the port does not
jit).  ``run`` restores the signal handlers it found when it returns.
A ``mesh`` or ``shardings`` is the multi-card layer (ROADMAP.md Queue 1
item 14).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Dict, List

import numpy as np
import torch

from .. import convert
from .. import device as _device
from ..ckpt import CheckpointManager
from ..configs.base import ModelConfig
from ..data import DataPipeline
from ..models import lm
from ..optim import init_opt_state
from .step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0
    lr_peak: float = 3e-4
    lr_warmup: int = 200


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 pipeline: DataPipeline, mesh=None, shardings=None,
                 device="cuda"):
        if mesh is not None or shardings is not None:
            raise NotImplementedError(
                "a Trainer on a mesh (mesh=, shardings=) is the multi-card "
                "layer: ROADMAP.md Queue 1 item 14")
        self.cfg = cfg
        self.tcfg = tcfg
        self.pipe = pipeline
        self.dev = _device.resolve(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.step_fn = make_train_step(
            cfg, remat=True, lr_peak=tcfg.lr_peak, lr_warmup=tcfg.lr_warmup,
            lr_total=max(tcfg.steps, 10 * tcfg.lr_warmup), device=self.dev)
        self._stop = False
        self.history: List[Dict] = []
        self.straggler_steps = 0

    def _install_signals(self) -> dict:
        def handler(signum, frame):
            self._stop = True
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not main thread (tests)
        return prev

    def _state(self, params, opt) -> Dict:
        """The checkpointed tree: the JAX package's layout on the host."""
        return {"params": convert.lm_tree_from_params(params, self.cfg),
                "opt": convert.opt_state_to_numpy(opt, self.cfg)}

    def init_or_resume(self):
        gen = torch.Generator(self.dev).manual_seed(self.tcfg.seed)
        params = lm.init_params(gen, self.cfg, device=self.dev)
        opt = init_opt_state(params)
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(self._state(params, opt))
            params = convert.lm_params_from_numpy(state["params"], self.cfg,
                                                  self.dev)
            opt = convert.opt_state_from_numpy(state["opt"], self.cfg,
                                               self.dev)
            start = latest
            print(f"[trainer] resumed from step {start}")
        return params, opt, start

    def run(self) -> Dict:
        prev = self._install_signals()
        try:
            return self._run()
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)

    def _run(self) -> Dict:
        params, opt, start = self.init_or_resume()
        durations: List[float] = []
        final_loss = float("nan")
        step = start
        for step in range(start, self.tcfg.steps):
            if self._stop:
                print(f"[trainer] preemption signal: checkpointing @ {step}")
                break
            batch = self.pipe.batch(step)
            t0 = time.time()
            params, opt, metrics = self.step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            durations.append(dt)
            med = float(np.median(durations[-20:]))
            if len(durations) > 5 and dt > self.tcfg.straggler_factor * med:
                self.straggler_steps += 1
                print(f"[trainer] straggler step {step}: {dt:.2f}s "
                      f"(median {med:.2f}s)")
            if not np.isfinite(loss):
                print(f"[trainer] non-finite loss at {step}; skipping")
                continue
            final_loss = loss
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
            self.history.append({"step": step, "loss": loss, "time": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self._state(params, opt),
                               background=True)
        self.ckpt.save(step + 1, self._state(params, opt))
        self.ckpt.wait()
        return {"final_loss": final_loss, "steps_run": step + 1 - start,
                "stragglers": self.straggler_steps,
                "history": self.history}
