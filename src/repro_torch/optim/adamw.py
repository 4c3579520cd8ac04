"""AdamW, global-norm clipping and the warmup-cosine schedule (the JAX
package's ``optim/adamw.py`` in PyTorch).

A tree here is a dict of tensors keyed by parameter name, in the order in
which the global norm sums them (``models.lm.named_leaves`` gives the JAX
tree's leaf order); a module is taken as its named parameters.  The
formulas are the JAX package's as written: f32 moments, a 0-d int32 step,
bias corrections ``1 - b**t``, ``mh / (sqrt(vh) + eps) + wd * p`` and the
result cast back to the parameter's type -- there is no f32 master copy, as
the reference keeps bf16 weights.  ``torch.optim.AdamW`` places the bias
correction, ``eps`` and the decay elsewhere, so it rounds differently.

The update is in place: parameters and moments are overwritten, the
counterpart of the JAX trainer's ``donate_argnums=(0, 1)`` (a second copy
of the moments is 14 GB at qwen3-1.7b's full width).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    m: Tree
    v: Tree
    step: torch.Tensor     # 0-d int32


def _tree(params: Union[nn.Module, Tree]) -> Tree:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def init_opt_state(params: Union[nn.Module, Tree]) -> OptState:
    """Zero f32 moments on each parameter's device; step 0."""
    params = _tree(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(m=zeros,
                    v={k: torch.zeros_like(z) for k, z in zeros.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping).  The squares are summed in f32 per leaf and the
    leaves added in the dict's order; each scaled leaf is cast back to its
    type."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def lr_schedule(step: torch.Tensor, peak: float = 3e-4, warmup: int = 200,
                total: int = 10_000) -> torch.Tensor:
    """Linear warmup from 0 to ``peak`` over ``warmup`` steps, then a
    cosine to 0 at ``total`` (f32, on ``step``'s device)."""
    step = step.float()
    warm = peak * step / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(params: Union[nn.Module, Tree], grads: Tree,
                 state: OptState, *, lr: torch.Tensor, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1
                 ) -> Tuple[Union[nn.Module, Tree], OptState]:
    """One AdamW step in place on ``params`` (a module or a tree) and on
    ``state``'s moments and step; returns them."""
    tree = _tree(params)
    state.step.add_(1)
    t = state.step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for k, p in tree.items():
        gf = grads[k].float()
        m, v = state.m[k], state.v[k]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf.square_())
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        pf = p.float()
        upd.add_(wd * pf)
        p.copy_(pf.sub_(upd.mul_(lr)))
    return params, state
