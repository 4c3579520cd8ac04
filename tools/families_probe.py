#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 alone: the moe and ssm families on the
card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/families_probe.py [--profile]

It builds the port's kernels (phase 14 launches ``flash_attention`` in
14a's prefill and the ``kmeans_fit`` / ``kmeans_assign`` pair in each
engine's profile fit), then runs 14a, qwen2-moe-a2.7b at full width
(prefill at B=1, S=4096 through the flash kernel, held per layer to
``mha_plain``; the ``ServeEngine`` with the ``HydraKVScheduler``); 14b,
rwkv6-1.6b at full width (prefill at B=1, S=2048, the engine); 14g, the two
family goldens; 14c, the int8 compression on the card.  ``--profile`` then
takes one more prefill of each model and one more decode step of each under
``torch.profiler`` and prints the device's busy share and its time by
kernel, ordered.  The card's name and power limit come first and last.  A
quick check of a change to these families before a full ``chip_smoke.py``
run.

It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled(what: str, fn, top: int = 15) -> None:
    """``fn()`` once warm, then once under the profiler: wall, device busy
    time and the largest device times by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, counts = {}, {}
    for e in kern:
        t_ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + t_ms
        counts[e.name] = counts.get(e.name, 0) + 1
    busy = sum(by_name.values())
    print(f"[profile] {what}: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms ({busy / (wall * 1e3):.1%}), {len(kern)} kernels",
          flush=True)
    for name, t_ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile]   {t_ms:9.3f} ms {counts[name]:7d} x "
              f"{name[:100]}", flush=True)


def profile_families(dev) -> None:
    """A prefill and a four-slot decode step of each full-width model."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step, make_serve_step
    import chip_smoke as cs
    for arch, (b, s), flash in (("qwen2-moe-a2.7b", cs.MOE_PREFILL, True),
                                ("rwkv6-1.6b", cs.SSM_PREFILL, False)):
        cfg = get_arch(arch)
        params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                device=dev)
        gen = torch.Generator(dev).manual_seed(0)
        tok = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
        prefill = make_prefill_step(cfg, use_flash=flash)
        profiled(f"{arch} prefill B={b} S={s}",
                 lambda: prefill(params, {"tokens": tok}))
        state = lm.init_decode_state(params, cfg, 4, 256)
        step = make_serve_step(cfg)
        one = torch.zeros((4, 1), dtype=torch.int64, device=dev)
        profiled(f"{arch} decode step, 4 slots",
                 lambda: step(params, state, one))
        del params, state
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("families_probe: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.kmeans_assign import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cs.run_phase14(dev, fops, kops)
    if args.profile:
        profile_families(dev)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
