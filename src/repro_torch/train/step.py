"""Prefill and serve step factories (the JAX package's ``train/step.py``,
its serving half).  Each step runs under ``torch.inference_mode()`` where
the JAX package jits; ``make_train_step`` waits for the training slice
(ROADMAP.md Queue 1 item 13)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import lm


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False):
    """(params, batch) -> last-token f32 logits [B, 1, vocab]."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            return lm.forward(params, cfg, batch, use_flash=use_flash,
                              last_only=True)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens [B, 1]) -> (logits [B, 1, vocab], state)."""
    def serve_step(params, state, tokens):
        with torch.inference_mode():
            return lm.decode_step(params, cfg, state, tokens)
    return serve_step
