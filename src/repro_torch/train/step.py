"""Training, prefill and serve step factories (the JAX package's
``train/step.py``).  The training step differentiates ``lm.loss_fn`` with
autograd and updates the parameters and the optimizer state in place; the
prefill and serve steps run under ``torch.inference_mode()`` where the JAX
package jits (``torch.no_grad()`` on DTensor parameters: a view of a
DTensor made outside inference mode cannot be taken inside it).

Every step runs on plain or DTensor parameters (``sharding.shard_tree``):
each enters ``implicit_replication()``, under which the plain tensors the
model makes as it runs (rope tables, masks, positions, zero states) take
part as replicated DTensors.

``input_specs(arch, shape)`` returns ``meta`` stand-ins for every model
input of an (architecture x assigned-shape) cell, ``abstract_params`` /
``abstract_opt_state`` / ``abstract_decode_state`` the model, optimizer
state and decode state on ``meta``: shapes and types, no allocation.  The
dry-run (``launch.dryrun``) distributes them."""
from __future__ import annotations

from typing import Any, Dict

import contextlib
import sys

import numpy as np
import torch

from .. import device as _device
from ..configs.base import SHAPES, ModelConfig, get_arch
from ..models import lm
from ..models.layers import is_dtensor
from ..optim import adamw_update, clip_by_global_norm, init_opt_state, \
    lr_schedule
from ..optim.adamw import OptState


def to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``dev``: the tokens
    and labels, and the frontend embeddings of the encdec and vlm families
    (``enc_embeds``, ``patch_embeds``; pass them as bf16 tensors, the type
    the JAX package's ``input_specs`` gives them)."""
    return {k: (v if is_dtensor(v) else v.to(dev)
                if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v), device=dev))
            for k, v in batch.items()}


def _no_graph(params):
    """Inference mode on plain parameters, no_grad on DTensor ones."""
    if is_dtensor(params.embed.table):
        return torch.no_grad()
    return torch.inference_mode()


def _replicating():
    """``implicit_replication()`` once DTensor is imported (no DTensor
    parameter exists before), else nothing."""
    if "torch.distributed.tensor" not in sys.modules:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _laid_out(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter's gradient redistributed to the parameter's
    placements (a partial sum over the batch axes becomes a reduce-scatter
    or an all-reduce): the layout the update and the moments need."""
    if is_dtensor(grad):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


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
    (``kernels.flash_attention.ops.mha``).  On DTensor parameters the
    moments are DTensors laid out as their parameters (``init_opt_state``
    of the sharded module), each gradient is redistributed to its
    parameter's placements before the update (``_laid_out``), and
    ``loss`` and ``grad_norm`` are replicated 0-d DTensors."""
    dev = _device.resolve(device)

    def train_step(params, opt_state, batch):
        on = params.embed.table.device
        if on.type != dev.type or dev.index not in (None, on.index):
            raise ValueError(f"train_step: parameters on {on}, step on "
                             f"{dev}")
        leaves = lm.named_leaves(params)
        with _replicating():
            loss = lm.loss_fn(params, cfg, to_device(batch, dev),
                              remat=remat, use_flash=use_flash)
            grads = torch.autograd.grad(loss, [p for _, p in leaves])
            grads, gnorm = clip_by_global_norm(
                {k: _laid_out(g, p) for (k, p), g in zip(leaves, grads)},
                max_norm)
            lr = lr_schedule(opt_state.step, peak=lr_peak,
                             warmup=lr_warmup, total=lr_total)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             lr=lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False):
    """(params, batch) -> last-token f32 logits [B, 1, vocab].  The batch
    holds ``tokens`` and, for encdec and vlm, ``enc_embeds`` or
    ``patch_embeds`` (``lm.hidden``)."""
    def prefill_step(params, batch):
        with _no_graph(params), _replicating():
            return lm.forward(params, cfg, batch, use_flash=use_flash,
                              last_only=True)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens [B, 1]) -> (logits [B, 1, vocab], state)."""
    def serve_step(params, state, tokens):
        with _no_graph(params), _replicating():
            return lm.decode_step(params, cfg, state, tokens)
    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape: str) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for one (arch x shape) cell: int32 ``tokens``
    ([B, 1] for decode, else [B, S]) and ``labels`` (train), and outside
    decode the bf16 frontend stand-ins ``enc_embeds`` [B, enc_seq, d]
    (encdec) and ``patch_embeds`` [B, prefix_len, d] (vlm)."""
    cfg = get_arch(arch)
    sp = SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len
    if sp.kind == "decode":
        batch = {"tokens": _meta((b, 1), torch.int32)}
    else:
        batch = {"tokens": _meta((b, s), torch.int32)}
        if sp.kind == "train":
            batch["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "encdec" and sp.kind != "decode":
        batch["enc_embeds"] = _meta((b, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16)
    if cfg.family == "vlm" and sp.kind != "decode":
        batch["patch_embeds"] = _meta((b, cfg.prefix_len, cfg.d_model),
                                      torch.bfloat16)
    return batch


def abstract_params(cfg: ModelConfig) -> lm.LM:
    """The model on ``meta``: every parameter's shape and type, nothing
    drawn (there is no meta generator) and nothing allocated."""
    lm._ported_only(cfg)
    return lm.LM(None, cfg, torch.device("meta"))


def abstract_opt_state(params_shape: lm.LM) -> OptState:
    return init_opt_state(params_shape)


def abstract_decode_state(cfg: ModelConfig, params_shape: lm.LM, batch: int,
                          s_max: int) -> Any:
    return lm.init_decode_state(params_shape, cfg, batch, s_max)
