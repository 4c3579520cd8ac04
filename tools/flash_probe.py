#!/usr/bin/env python3
"""Measure the Hopper flash attention kernel's exact-rounding repair on the
card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/flash_probe.py

It compiles three variants of ``src/repro_torch/csrc/flash_attention.cu``
with the port's own ``nvcc`` flags into ``build/flash_probe/``: the kernel
as shipped; the kernel with the repair switched off (no score is
recomputed by the f32 chain); and a kernel that writes the raw scores of
its first key block and stops.  Then it prints

* the calibration of ``kernel.BOUND_ULPS``: the largest |s (tensor cores) -
  s (f32 matrix product)| / (2^-24 |q| |k|) over 256 random [128, 128]
  score tiles at each head size of ``HEAD_DIMS``, for normal inputs, a
  shared direction in q and eight keys (an attention sink), and inputs 8x
  larger, and the share of scores that differ at all;
* for both kernels, the per-element hold of ``chip_smoke.py`` (the atol
  needed beside 2^-7 x |plain|; the bar is 2^-12) at one qwen3-1.7b layer
  (B=1, S=4096, H=16, Hkv=8, d=128), the same shape with a sink, the
  prefill path's shape (S=32768), and one paligemma-3b layer at d = 256
  (B=1, S=4096, H=8, Hkv=1);
* their times, in turns (unrepaired, shipped, shipped, unrepaired), beside
  ``scaled_dot_product_attention``'s, with the card's name and power limit.

It exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "flash_probe")
# switches of the repair in the source: the exact running max, the
# rounding-window test
_REPAIR = ("if (__any_sync(0xffffffffu, nm_lo || nm_hi)) {",
           "if (__any_sync(0xffffffffu, thr_lo < 1.0f || thr_hi < 1.0f)) {")
# right after S = Q K^T is waited for
_SCORES_AT = ("    wgmma_commit();\n    wgmma_wait_all();\n"
              "    fence_regs<kBN / 2>(s);\n")
_SCORES = """
    {
      float* so = reinterpret_cast<float*>(o) +
                  static_cast<long long>(blockIdx.x) * kBN * kBN;
      for (int j = 0; j < kBN / 8; ++j)
        for (int e = 0; e < 4; ++e)
          so[(q0 + t_lo + 8 * (e >> 1)) * kBN + 8 * j + c_lane + (e & 1)] =
              s[4 * j + e];
      return;
    }
"""


def variants(src: str) -> dict:
    for text in _REPAIR + (_SCORES_AT,):
        if src.count(text) != 1:
            raise RuntimeError(f"source changed: {text!r} not found once")
    off = src
    for text in _REPAIR:
        off = off.replace(text, "if (false) {")
    return {"shipped": src, "unrepaired": off,
            "scores": src.replace(_SCORES_AT, _SCORES_AT + _SCORES)}


def build(srcs: dict, nvcc: str, flags) -> dict:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).flash_attention_sm90
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        fns = build(variants(f.read()), _build.nvcc(), _build.NVCC_FLAGS)

    def call(name, q, k, v, causal=True, out=None):
        b, sq, h, d = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q) if out is None else out
        kmax = torch.linalg.vector_norm(k, dim=-1,
                                        dtype=torch.float32).amax(1)
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), kmax.data_ptr(), b, sq, sk, h, hkv,
                        d, int(causal), d ** -0.5,
                        fk.BOUND_ULPS * 2.0 ** -24 * d ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return out

    def bf16(*arrays):
        return tuple(torch.as_tensor(a, dtype=torch.float32)
                     .to(torch.bfloat16).to(dev) for a in arrays)

    result = {"device": smi, "bound_ulps": fk.BOUND_ULPS, "calibration": {},
              "hold_atol_needed": {}, "ms": {}}
    rng = np.random.default_rng(3)
    for d in fops.HEAD_DIMS:
        for kind in ("normal", "sink", "large"):
            q = rng.normal(size=(256, 128, 1, d))
            k = rng.normal(size=(256, 128, 1, d))
            if kind == "sink":
                u = rng.normal(size=d)
                u /= np.linalg.norm(u)
                q, k[:, :8] = q + 4 * u, 6 * u
            elif kind == "large":
                q, k = 8 * q, 8 * k
            q, k = bf16(q, k)
            raw = torch.empty(256 * 128 * 128, dtype=torch.float32,
                              device=dev)
            call("scores", q, k, k, causal=False, out=raw)
            chain = q[:, :, 0].float() @ k[:, :, 0].float().transpose(1, 2)
            qn = torch.linalg.vector_norm(q[:, :, 0].float(), dim=-1)
            kn = torch.linalg.vector_norm(k[:, :, 0].float(), dim=-1)
            unit = 2.0 ** -24 * qn[..., None] * kn[:, None]
            diff = raw.view(256, 128, 128) - chain
            result["calibration"][f"d={d} {kind}"] = {
                "max_ratio": float((diff.abs() / unit).max()),
                "share_differing": float((diff != 0).float().mean())}
    shapes = {"layer": cs.flash_inputs(1, 4096, 16, 8, 128, torch.bfloat16,
                                       dev)}
    u = rng.normal(size=128)
    u /= np.linalg.norm(u)
    ks = rng.normal(size=(1, 4096, 8, 128))
    ks[:, 0] = 6 * u * np.sqrt(128) / 4
    shapes["layer with a sink"] = bf16(
        rng.normal(size=(1, 4096, 16, 128)) + 4 * u, ks,
        rng.normal(size=(1, 4096, 8, 128)))
    shapes["path"] = cs.flash_inputs(1, 32768, 16, 8, 128, torch.bfloat16,
                                     dev)
    shapes["paligemma layer"] = cs.flash_inputs(*cs.VLM_LAYER,
                                                torch.bfloat16, dev)
    for key, x in shapes.items():
        want = fops.mha_plain(*x, causal=True)
        for name in ("shipped", "unrepaired"):
            result["hold_atol_needed"][f"{key} {name}"] = cs.flash_diff(
                call(name, *x), want)["atol_needed"]
        del want
        reps = 5 if x[0].shape[1] > 8192 else 20
        times = {"unrepaired": [], "shipped": []}
        for name in ("unrepaired", "shipped", "shipped", "unrepaired"):
            times[name].append(cs.time_ms(lambda: call(name, *x), reps, 2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in x)
        times["sdpa"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps, 2)
        result["ms"][key] = times
    print(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
