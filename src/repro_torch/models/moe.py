"""Mixture-of-Experts FFN: Mixtral-style top-k routing, Qwen2-MoE-style
shared + routed experts (the JAX package's ``models/moe.py`` in PyTorch).

Two dispatch routes, as in the reference: ``moe_ffn``, the capacity-bounded
one-hot einsums (tokens -> [E, capacity, d] -> expert FFN -> combine), and
``moe_ffn_sorted``, the row-local route that stably sorts each batch row's
(token, k) pairs by expert id and moves them with gathers; ``dispatch``
takes the sorted route for S > 1 and the one-hot route at S = 1 (decode).
The grouped expert products are ``torch.einsum``; the reference's are plain
einsums too, not Pallas.

What the reference does, this does too, since its numbers depend on it:

* ``jax.lax.top_k`` breaks ties toward the lower expert id; ``torch.topk``
  promises no order, so the selection is a stable descending sort.
* Capacity is ``max(int(n * top_k * capacity_factor / n_exp), 4)`` in
  Python arithmetic; dropped pairs of the sorted route go to a dump row
  (``n_exp * cap``) that is cut off.
* The sorted route's combine (``.at[src].add`` in the reference) adds each
  token's k contributions one at a time in the order of the stable sort
  (ascending expert id), rounding after each add in the activations' type;
  an ``index_add_`` would use atomics on the card and vary from run to run.
* The router runs in f32; the other products take the promoted type of
  their operands where JAX promotes (torch's ``@`` does not).

``BATCH_SPEC`` and ``_wsc_batch`` are the reference's batch-dim
constraint on the sorted route's [B, E, C, d] expert buffers (set by the
dry-run together with ``lm.ACT_SPEC``).  On DTensors the routed experts
run on each rank's local shards (``_experts``), so the constraint lays
out the route's input rows, which the buffers then follow.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import rules as _rules
from .layers import _init, is_dtensor, local_rows, swiglu, swiglu_init

# dispatch route for S > 1: "sorted" (the reference's default) or "einsum"
# (the one-hot route, kept for comparison)
IMPL = "sorted"

# batch-dim sharding constraint for the sorted route (set by the dry-run
# together with lm.ACT_SPEC): the rows its local shards hold.
BATCH_SPEC = None  # sharding.NamedSharding whose spec is P(fsdp)


def _wsc_batch(x):
    """``x`` redistributed to batch-sharded on ``BATCH_SPEC``'s axes, the
    other dims replicated; the identity on a plain tensor or without a
    spec."""
    if BATCH_SPEC is None or not is_dtensor(x):
        return x
    full = _rules.P(BATCH_SPEC.spec[0], *(None,) * (x.ndim - 1))
    return x.redistribute(_rules.dtensor_mesh(BATCH_SPEC.mesh),
                          _rules.placements(full, BATCH_SPEC.mesh))


class MoE(nn.Module):
    """``router`` [d, E] (scale 0.02), the stacked expert weights
    ``w_gate``/``w_up`` [E, d, d_ff] and ``w_down`` [E, d_ff, d], and the
    optional ``shared`` SwiGLU.  The expert weights take the reference's
    ``_init`` scale 1/sqrt(shape[0]), whose fan-in is E, not d."""

    def __init__(self, gen: torch.Generator, d: int, d_ff: int,
                 n_experts: int, n_shared: int = 0, shared_d_ff: int = 0,
                 device=None):
        super().__init__()
        self.router = _init(gen, (d, n_experts), scale=0.02, device=device)
        self.w_gate = _init(gen, (n_experts, d, d_ff), device=device)
        self.w_up = _init(gen, (n_experts, d, d_ff), device=device)
        self.w_down = _init(gen, (n_experts, d_ff, d), device=device)
        if n_shared > 0:
            self.shared = swiglu_init(gen, d, shared_d_ff or d_ff * n_shared,
                                      device)


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             n_shared: int = 0, shared_d_ff: int = 0, device=None) -> MoE:
    return MoE(gen, d, d_ff, n_experts, n_shared, shared_d_ff, device)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted type of the two (``layers.mm``)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(t), b.to(t))


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    ties toward the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(p, x: torch.Tensor, *, top_k: int,
             capacity_factor: float = 1.25) -> torch.Tensor:
    """The sorted route for S > 1 (unless ``IMPL`` is "einsum"); the
    one-hot route at S = 1, where the sorted route's capacity padding
    exceeds the work."""
    if IMPL == "sorted" and x.shape[1] > 1:
        return moe_ffn_sorted(p, x, top_k=top_k,
                              capacity_factor=capacity_factor)
    return moe_ffn(p, x, top_k=top_k, capacity_factor=capacity_factor)


class Experts(NamedTuple):
    """The routed experts' weights (local shards on a mesh)."""
    router: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


class _SwiGLU(NamedTuple):
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def _experts(route, p, x: torch.Tensor, rows: bool, **kw) -> torch.Tensor:
    """``route(Experts, x)`` [B, S, d], the routed experts' output, plus
    the shared SwiGLU of x where there is one (its products over [B, S, d]
    are the reference's over the [B * S, d] tokens).  On DTensors it runs
    on each rank's local shards (``layers.local_rows``): the experts'
    hidden columns on "model" where both hidden widths divide it (the
    output then a partial sum over "model", the counterpart of the
    reference's EP as TP-within-expert), the batch rows as ``BATCH_SPEC``
    lays out x for the row-local sorted route (``rows``), all of them for
    the one-hot route, whose capacity counts every token."""
    args = [(x, 0, None), (p.router, None, None), (p.w_gate, None, 2),
            (p.w_up, None, 2), (p.w_down, None, 1)]
    width = p.w_gate.shape[2]
    if hasattr(p, "shared"):
        sh = p.shared
        args += [(sh.w_gate, None, 1), (sh.w_up, None, 1),
                 (sh.w_down, None, 0)]
        width = math.gcd(width, sh.w_gate.shape[1])

    def local(x, *w):
        out = route(Experts(*w[:4]), x, **kw)
        if len(w) > 4:
            out = out + swiglu(_SwiGLU(*w[4:]), x)
        return out

    if rows:
        x = _wsc_batch(x)
        args[0] = (x, 0, None)
    return local_rows(local, args, [(0, "sum")], model_size=width,
                      rows=rows)


def moe_ffn(p, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  Top-k softmax routing with a capacity
    over all B * S tokens, through one-hot dispatch and combine
    einsums."""
    return _experts(_onehot, p, x, False, top_k=top_k,
                    capacity_factor=capacity_factor)


def _onehot(p, x: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> torch.Tensor:
    b, s, d = x.shape
    n_exp = p.router.shape[1]
    tokens = x.reshape(b * s, d)
    n_tok = b * s
    cap = max(int(n_tok * top_k * capacity_factor / n_exp), 4)

    logits = tokens.float() @ p.router.float()
    weights, sel = _top_k(logits, top_k)                      # [T, k]
    weights = torch.softmax(weights, dim=-1)

    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(sel, n_exp)                              # [T, k, E]
    flat = onehot.reshape(n_tok * top_k, n_exp)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(n_tok, top_k,
                                                          n_exp)
    within = (pos < cap) & (onehot > 0)

    # dispatch [T, k, E, C] one-hot -> expert inputs [E, C, d]
    pos_oh = F.one_hot(torch.where(within, pos, cap), cap + 1
                       ).to(tokens.dtype)[..., :cap]
    disp = pos_oh * within[..., None].to(tokens.dtype)
    expert_in = _einsum("td,tkec->ecd", tokens, disp)

    g = F.silu(_einsum("ecd,edf->ecf", expert_in, p.w_gate))
    h = g * _einsum("ecd,edf->ecf", expert_in, p.w_up)
    expert_out = _einsum("ecf,efd->ecd", h, p.w_down)

    # combine with routing weights
    comb = disp * weights[..., None, None].to(tokens.dtype)
    out = _einsum("ecd,tkec->td", expert_out, comb)
    return out.reshape(b, s, d)


class SortedRoute(NamedTuple):
    """The bookkeeping of the sorted route, each batch row apart (all
    [B, S * k] but ``sel`` and ``weights`` [B, S, k])."""
    cap: int
    sel: torch.Tensor        # selected expert ids, descending logit
    weights: torch.Tensor    # their softmax weights (f32)
    order: torch.Tensor      # stable argsort of the flat expert ids
    dst: torch.Tensor        # expert-buffer row, n_exp * cap when dropped
    src_tok: torch.Tensor    # token of each sorted pair
    w_sorted: torch.Tensor   # weight of each sorted pair


def sorted_route(p, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float = 1.25) -> SortedRoute:
    """The router and the row-local ranking of ``moe_ffn_sorted``: each
    row's (token, k) pairs stably sorted by expert id, ranked within their
    expert, and kept below the per-row capacity."""
    b, s, _ = x.shape
    n_exp = p.router.shape[1]
    cap = max(int(s * top_k * capacity_factor / n_exp), 4)
    logits = x.float() @ p.router.float()                     # [B, S, E]
    weights, sel = _top_k(logits, top_k)                      # [B, S, k]
    weights = torch.softmax(weights, dim=-1)

    flat_e = sel.reshape(b, s * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    idx = torch.arange(s * top_k, device=x.device).expand(b, -1)
    first = torch.ones_like(sorted_e, dtype=torch.bool)
    first[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    grp_start = torch.cummax(torch.where(first, idx, -1), dim=1).values
    rank = idx - grp_start
    dst = torch.where(rank < cap, sorted_e * cap + rank, n_exp * cap)
    src_tok = torch.div(order, top_k, rounding_mode="floor")
    w_sorted = torch.gather(weights.reshape(b, s * top_k), 1, order)
    return SortedRoute(cap, sel, weights, order, dst, src_tok, w_sorted)


def moe_ffn_sorted(p, x: torch.Tensor, *, top_k: int,
                   capacity_factor: float = 1.25) -> torch.Tensor:
    """Sort-based, batch-row-local dispatch: per row the (token, k) pairs
    move by gathers into [B, E, C, d] expert buffers, the grouped expert
    products run over them, and each token's k contributions are summed
    in the stable sort's order.  Capacity is per batch row."""
    return _experts(_sorted, p, x, True, top_k=top_k,
                    capacity_factor=capacity_factor)


def _sorted(p, x: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> torch.Tensor:
    b, s, d = x.shape
    n_exp = p.router.shape[1]
    r = sorted_route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    cap = r.cap
    rows = torch.arange(b, device=x.device)[:, None]
    ein = x.new_zeros((b, n_exp * cap + 1, d))
    ein[rows, r.dst] = x[rows, r.src_tok]
    ein = ein[:, :n_exp * cap].reshape(b, n_exp, cap, d)

    g = F.silu(_einsum("becd,edf->becf", ein, p.w_gate))
    h = g * _einsum("becd,edf->becf", ein, p.w_up)
    eout = _einsum("becf,efd->becd", h, p.w_down).reshape(b, n_exp * cap,
                                                          d)
    eout = torch.cat([eout, eout.new_zeros((b, 1, d))], 1)

    contrib = eout[rows, r.dst] * r.w_sorted[..., None].to(eout.dtype)
    # each token's pairs in sorted position order: the reference's
    # scatter-add sequence, one rounding an add
    pos = torch.sort(torch.argsort(r.order, dim=-1).reshape(b, s, top_k),
                     dim=-1).values.reshape(b, s * top_k)
    parts = contrib[rows, pos].reshape(b, s, top_k, d)
    out = eout.new_zeros((b, s, d))
    for j in range(top_k):
        out = out + parts[:, :, j]
    return out


def aux_load_balance_loss(p, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over experts of
    fraction_dispatched * mean_router_prob * E)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d).float()
    n_exp = p.router.shape[1]
    logits = tokens @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    _, sel = _top_k(logits, top_k)
    frac = F.one_hot(sel, n_exp).float().sum(1).mean(0)
    return torch.sum(frac * probs.mean(0)) * n_exp
