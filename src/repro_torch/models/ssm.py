"""Attention-free sequence mixers: Mamba2 (simplified SSD) and RWKV6 (the
JAX package's ``models/ssm.py`` in PyTorch).

Both run in recurrent form: a Python loop over time where the reference
scans (``lax.scan``, plain JAX, no Pallas), and an O(1) state update a
decode step (the same loop, one step long).  A scan kernel is later work
(ROADMAP.md Queue 2).  On DTensors the loops run on each rank's local
batch rows and heads (``layers.local_rows``).

The reference's ``_shape`` leaves (zero-filled arrays that its code reads
head counts and widths from) are Python ints here (``Mamba.dims``,
``RWKV.dims``); ``convert`` writes them into a JAX-layout tree with the
reference's shape and type.  Where JAX promotes a product of an f32
activation and a bf16 weight to f32, the weight is cast here (torch's
``@`` does not promote): RWKV's time-mix projections are f32 products,
its channel mix casts the mixed input back to the activations' type
first, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from .layers import _init, _ones, _param, _zeros, local_rows, mm


def _full(shape, value: float, device) -> nn.Parameter:
    return _param(torch.full(shape, value, dtype=torch.float32,
                             device=device))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it on the CPU: x * (1 / (1 +
    exp(-x))), each op rounded to x's type.  In bf16 ``F.silu`` rounds once
    and differs from it in about 40 % of the elements."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba2 (simplified SSD: scalar-per-head decay, outer-product state)
# ---------------------------------------------------------------------------
class MambaState(NamedTuple):
    h: torch.Tensor      # [B, H, d_head, d_state] f32
    conv: torch.Tensor   # [B, K-1, d_inner] bf16 conv tail for decode


class Mamba(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, n_heads: int,
                 d_state: int, expand: int = 2, d_conv: int = 4,
                 device=None):
        super().__init__()
        d_inner = expand * d
        self.w_z = _init(gen, (d, d_inner), device=device)
        self.w_x = _init(gen, (d, d_inner), device=device)
        self.w_b = _init(gen, (d, d_state), device=device)
        self.w_c = _init(gen, (d, d_state), device=device)
        self.w_dt = _init(gen, (d, n_heads), device=device)
        self.conv_w = _init(gen, (d_conv, d_inner), scale=0.5, device=device)
        self.a_log = _zeros((n_heads,), device)
        self.d_skip = _ones((n_heads,), device)
        self.dt_bias = _zeros((n_heads,), device)
        self.w_out = _init(gen, (d_inner, d), device=device)
        # the reference's ``_shape`` leaf: (n_heads, d_head, d_state, d_conv)
        self.dims = (n_heads, d_inner // n_heads, d_state, d_conv)


def mamba_init(gen: torch.Generator, d: int, n_heads: int, d_state: int,
               expand: int = 2, d_conv: int = 4, device=None) -> Mamba:
    return Mamba(gen, d, n_heads, d_state, expand, d_conv, device)


def _mamba_split(p, x):
    return (mm(x, p.w_z), mm(x, p.w_x), mm(x, p.w_b), mm(x, p.w_c),
            mm(x, p.w_dt))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,S,C], w [K,C]; the taps summed in
    order in the activations' type."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return _silu(out)


def _ssd_update(xt, bt, dtt):
    """einsum("bhd,bs,bh->bhds"): (x * dt) outer B."""
    return (xt * dtt[..., None])[..., None] * bt[:, None, None, :]


def _ssd_scan(xf, bf, cf, dt, decay, h):
    """The SSD recurrence over time: xf [B,S,nh,dh], bf and cf [B,S,ds],
    dt and decay [B,S,nh], h [B,nh,dh,ds] -> (y [B,S,nh,dh], final h)."""
    ys = []
    for t in range(xf.shape[1]):
        h = h * decay[:, t, :, None, None] + _ssd_update(xf[:, t], bf[:, t],
                                                         dt[:, t])
        ys.append((h @ cf[:, t, None, :, None])[..., 0])
    return torch.stack(ys, 1), h


# ---------------------------------------------------------------------------
# the recurrences as operators
# ---------------------------------------------------------------------------
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_SCANS = {}


def _scan_op(name: str, body):
    """Register ``body`` (six tensors -> (y like the first, the final state
    like the last)) as the operator ``repro_torch::<name>``: its kernel is
    the Python loop on any device, its fake kernel gives the output shapes
    at once.  ``<name>_grad`` is its backward with a fake kernel only: a
    recurrence is one op of known shapes in ``FakeTensorMode`` (the
    dry-run), as XLA's while loop is one op.  ``SCAN_FLOPS`` gives a time
    step's products, which the dry-run registers with
    ``FlopCounterMode``'s formulas."""
    _LIB.define(f"{name}(Tensor a, Tensor b, Tensor c, Tensor d, Tensor e, "
                f"Tensor h) -> (Tensor, Tensor)")
    _LIB.impl(name, body, "CompositeExplicitAutograd")
    _LIB.define(f"{name}_grad(Tensor a, Tensor b, Tensor c, Tensor d, "
                f"Tensor e, Tensor h, Tensor gy, Tensor gh) -> Tensor[]")
    torch.library.register_fake(f"repro_torch::{name}", lambda *t: (
        t[0].new_empty(t[0].shape), t[-1].new_empty(t[-1].shape)))
    torch.library.register_fake(f"repro_torch::{name}_grad", lambda *t: [
        x.new_empty(x.shape) for x in t[:6]])
    _SCANS[name] = (getattr(torch.ops.repro_torch, name),
                    getattr(torch.ops.repro_torch, f"{name}_grad"), body)


class _Scan(torch.autograd.Function):
    """A registered recurrence under autograd: the forward is the
    operator; the backward recomputes the loop with autograd on and takes
    its gradients (on fake tensors: the ``_grad`` operator's shapes)."""

    @staticmethod
    def forward(ctx, name, *inputs):
        ctx.name = name
        ctx.save_for_backward(*inputs)
        return _SCANS[name][0](*inputs)

    @staticmethod
    def backward(ctx, gy, gh):
        _, grad, body = _SCANS[ctx.name]
        inputs = ctx.saved_tensors
        if is_fake(inputs[0]):
            return (None, *grad(*inputs, gy, gh))
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(inputs, ctx.needs_input_grad[1:])]
        wrt = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            y, h = body(*ins)
        got = iter(torch.autograd.grad((y, h), wrt, (gy, gh),
                                       allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None
                        for t in ins))


def _ssd(n_heads, xf, bf, cf, dt, decay, h):
    """``_ssd_scan`` on each rank's local batch rows and heads when its
    inputs are DTensors (``layers.local_rows``): the recurrence is
    independent across both and runs there as plain tensor ops."""
    return local_rows(lambda *t: _Scan.apply("ssd_scan", *t),
                      [(xf, 0, 2), (bf, 0, None), (cf, 0, None),
                       (dt, 0, 2), (decay, 0, 2), (h, 0, 1)],
                      [(0, 2), (0, 1)], model_size=n_heads)


def mamba_forward(p, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: x [B, S, d] -> [B, S, d]."""
    bsz, s, _ = x.shape
    nh, dh, ds, _ = p.dims
    z, xin, b, c, dt = _mamba_split(p, x)
    xin = _causal_conv(xin, p.conv_w)
    xh = xin.reshape(bsz, s, nh, dh)
    dt = _softplus(dt.float() + p.dt_bias)                       # [B,S,H]
    decay = torch.exp(-torch.exp(p.a_log)[None, None, :] * dt)   # [B,S,H]
    xf, bf, cf = xh.float(), b.float(), c.float()
    h = torch.zeros((bsz, nh, dh, ds), dtype=torch.float32, device=x.device)
    y, _ = _ssd(nh, xf, bf, cf, dt, decay, h)               # [B,S,nh,dh]
    y = y + xf * p.d_skip[None, None, :, None]
    y = y.reshape(bsz, s, nh * dh) * F.silu(z.float())
    return mm(y.to(x.dtype), p.w_out)


def mamba_init_state(p, batch: int) -> MambaState:
    nh, dh, ds, dk = p.dims
    dev = p.w_out.device
    return MambaState(
        h=torch.zeros((batch, nh, dh, ds), dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, dk - 1, nh * dh), dtype=torch.bfloat16,
                         device=dev))


def mamba_decode_step(p, x: torch.Tensor, state: MambaState
                      ) -> Tuple[torch.Tensor, MambaState]:
    """x: [B, 1, d] -> ([B, 1, d], new state)."""
    bsz = x.shape[0]
    nh, dh, _, dk = p.dims
    z, xin, b, c, dt = _mamba_split(p, x)
    # conv over [tail, current]
    win = torch.cat([state.conv, xin.to(state.conv.dtype)], 1)
    conv = sum(win[:, i, :] * p.conv_w[i] for i in range(dk))
    xt = _silu(conv).reshape(bsz, nh, dh).float()
    dtt = _softplus(dt[:, 0].float() + p.dt_bias)
    decay = torch.exp(-torch.exp(p.a_log)[None, :] * dtt)
    y, h = _ssd(nh, xt[:, None], b.float(), c.float(), dtt[:, None],
                decay[:, None], state.h)
    y = y[:, 0] + xt * p.d_skip[None, :, None]
    y = y.reshape(bsz, 1, nh * dh) * F.silu(z.float())
    return mm(y.to(x.dtype), p.w_out), MambaState(h=h, conv=win[:, 1:, :])


# ---------------------------------------------------------------------------
# RWKV6 ("Finch"): data-dependent decay time-mix + channel-mix
# ---------------------------------------------------------------------------
class RWKVState(NamedTuple):
    s: torch.Tensor       # [B, H, d_head, d_head] f32 wkv state
    x_tm: torch.Tensor    # [B, d] bf16 previous token (time-mix shift)
    x_cm: torch.Tensor    # [B, d] bf16 previous token (channel-mix shift)


class RWKV(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, n_heads: int,
                 d_ff: int, device=None):
        super().__init__()
        dh = d // n_heads
        for m in "rkvwg":
            setattr(self, f"mix_{m}", _full((d,), 0.5, device))
        self.w_r = _init(gen, (d, d), device=device)
        self.w_k = _init(gen, (d, d), device=device)
        self.w_v = _init(gen, (d, d), device=device)
        self.w_g = _init(gen, (d, d), device=device)
        # data-dependent decay
        self.w_decay = _init(gen, (d, d), scale=0.01, device=device)
        self.decay_bias = _full((d,), -6.0, device)
        self.bonus = _zeros((n_heads, dh), device)
        self.w_o = _init(gen, (d, d), device=device)
        self.ln_x = _ones((d,), device)
        # channel mix
        self.cm_mix_k = _full((d,), 0.5, device)
        self.cm_wk = _init(gen, (d, d_ff), device=device)
        self.cm_wv = _init(gen, (d_ff, d), device=device)
        # the reference's ``_shape`` leaf: (n_heads, d_head)
        self.dims = (n_heads, dh)


def rwkv_init(gen: torch.Generator, d: int, n_heads: int, d_ff: int,
              device=None) -> RWKV:
    return RWKV(gen, d, n_heads, d_ff, device)


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: prepend x_prev, drop last. x [B,S,d], x_prev [B,d]."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_scan(r, k, v, w, bonus, state):
    """The wkv recurrence over time: r, k, v, w [B,S,nh,dh], bonus [nh,dh],
    state [B,nh,dh,dh] -> (y [B,S,nh,dh], final state).  Run on each
    rank's local batch rows and heads on DTensors (``layers.local_rows``)."""
    bonus = bonus[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append((r[:, t, :, None, :] @ (state + bonus * kv))[..., 0, :])
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(ys, 1), state


def rwkv_time_mix(p, x: torch.Tensor, x_prev: torch.Tensor,
                  s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d]; returns (out [B,S,d], final state [B,H,dh,dh])."""
    bsz, s, d = x.shape
    nh, dh = p.dims
    xs = _shift(x, x_prev)

    def mix(m):
        mm = getattr(p, f"mix_{m}")
        return x * mm + xs * (1.0 - mm)            # f32: the mix is f32

    r = mm(mix("r"), p.w_r).reshape(bsz, s, nh, dh).float()
    k = mm(mix("k"), p.w_k).reshape(bsz, s, nh, dh).float()
    v = mm(mix("v"), p.w_v).reshape(bsz, s, nh, dh).float()
    g = F.silu(mm(mix("g"), p.w_g)).float()
    # data-dependent decay (Finch): w_t = exp(-exp(decay(x_t)))
    wdec = mm(mix("w"), p.w_decay).float() + p.decay_bias
    w = torch.exp(-torch.exp(wdec)).reshape(bsz, s, nh, dh)

    y, state = local_rows(
        lambda *t: _Scan.apply("wkv_scan", *t),
        [(r, 0, 2), (k, 0, 2), (v, 0, 2), (w, 0, 2), (p.bonus, None, 0),
         (s0, 0, 1)], [(0, 2), (0, 1)], model_size=nh)      # [B,S,nh,dh]
    # group norm over heads (ln_x) + gate
    y = y * torch.rsqrt(torch.mean(y * y, -1, keepdim=True) + 1e-5)
    y = (y.reshape(bsz, s, d) * p.ln_x * g).to(x.dtype)
    return mm(y, p.w_o), state


def rwkv_channel_mix(p, x: torch.Tensor, x_prev: torch.Tensor
                     ) -> torch.Tensor:
    xs = _shift(x, x_prev)
    xk = (x * p.cm_mix_k + xs * (1.0 - p.cm_mix_k)).to(x.dtype)
    h = torch.square(F.relu(mm(xk, p.cm_wk)))
    return mm(h, p.cm_wv).to(x.dtype)


def rwkv_init_state(p, batch: int, d: int) -> RWKVState:
    nh, dh = p.dims
    dev = p.w_o.device
    return RWKVState(
        s=torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=dev),
        x_tm=torch.zeros((batch, d), dtype=torch.bfloat16, device=dev),
        x_cm=torch.zeros((batch, d), dtype=torch.bfloat16, device=dev))


_scan_op("ssd_scan", _ssd_scan)
_scan_op("wkv_scan", _wkv_scan)
# a time step's products from the shapes of the first input and the state:
# ssd h @ c, [B, nh, dh, ds] x [ds]; wkv r @ (...), [B, nh, dh] x [dh, dh]
SCAN_FLOPS = {"ssd_scan": lambda x, h: 2 * x[0] * h[1] * h[2] * h[3],
              "wkv_scan": lambda r, h: 2 * r[0] * h[1] * h[2] * h[3]}
