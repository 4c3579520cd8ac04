"""Training, prefill and serve step factories (the JAX package's
``train/step.py``).  The training step differentiates ``lm.loss_fn`` with
autograd and updates the parameters and the optimizer state in place; the
prefill and serve steps run under ``torch.inference_mode()`` where the JAX
package jits.  ``input_specs`` and the ``abstract_*`` shapes belong to the
multi-card layer (ROADMAP.md Queue 1 item 14)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import device as _device
from ..configs.base import ModelConfig
from ..models import lm
from ..optim import adamw_update, clip_by_global_norm, lr_schedule


def to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``dev``: the tokens
    and labels, and the frontend embeddings of the encdec and vlm families
    (``enc_embeds``, ``patch_embeds``; pass them as bf16 tensors, the type
    the JAX package's ``input_specs`` gives them)."""
    return {k: (v.to(dev) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v), device=dev))
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, remat: bool = True,
                    use_flash: bool = False, max_norm: float = 1.0,
                    lr_peak: float = 3e-4, lr_warmup: int = 200,
                    lr_total: int = 10_000, device="cuda"):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the port's ``lm.LM`` and ``opt_state`` its
    ``optim.OptState``, both on ``device``; they are updated in place and
    returned.  The metrics ``loss``, ``grad_norm`` (before clipping) and
    ``lr`` (the schedule at the step count before the update, so 0 at step
    0) are 0-d f32 tensors on the device.  ``use_flash=True`` raises under
    autograd: the flash kernel has no backward
    (``kernels.flash_attention.ops.mha``)."""
    dev = _device.resolve(device)

    def train_step(params, opt_state, batch):
        on = params.embed.table.device
        if on.type != dev.type or dev.index not in (None, on.index):
            raise ValueError(f"train_step: parameters on {on}, step on "
                             f"{dev}")
        leaves = lm.named_leaves(params)
        loss = lm.loss_fn(params, cfg, to_device(batch, dev), remat=remat,
                          use_flash=use_flash)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        grads, gnorm = clip_by_global_norm(
            {k: g for (k, _), g in zip(leaves, grads)}, max_norm)
        lr = lr_schedule(opt_state.step, peak=lr_peak, warmup=lr_warmup,
                         total=lr_total)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False):
    """(params, batch) -> last-token f32 logits [B, 1, vocab].  The batch
    holds ``tokens`` and, for encdec and vlm, ``enc_embeds`` or
    ``patch_embeds`` (``lm.hidden``)."""
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
