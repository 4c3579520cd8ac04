#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 13 alone: training on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/train_probe.py [--profile]

Phase 13 builds no kernel (the train step is torch autograd over the dense
route; the flash kernel has no backward).  It runs 13a, qwen3-1.7b at full
width through ``make_train_step`` at B=1, S=4096 (a warm step, three timed
steps, the peak memory and the step's bound); 13g, the 2-layer full-width
model held to ``src/repro_torch/golden/qwen3_1_7b_w2_train.json``; 13r, the
``Trainer``'s resume on the card.  ``--profile`` then takes one more
full-width step under ``torch.profiler`` and prints the device's busy
share and its time by kernel, ordered.  The card's name and power limit
come first and last.  A quick check of a training change before a full
``chip_smoke.py`` run.

It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_step(dev) -> None:
    """One full-width train step under the profiler: wall, device busy
    time and the largest device times by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data import DataPipeline
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import to_device
    t = cs.TRAIN_FULL
    cfg = get_arch("qwen3-1.7b")
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, remat=True, lr_peak=t["lr_peak"],
                           lr_warmup=t["lr_warmup"], device=dev)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=t["seq"],
                        global_batch=t["batch"], seed=0)
    batches = [to_device(pipe.batch(i), dev) for i in range(2)]
    step(params, opt, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batches[1])
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
    print(f"[profile] one full-width step: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms ({busy / (wall * 1e3):.1%}), "
          f"{len(kern)} kernels", flush=True)
    for name, t_ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"[profile]   {t_ms:9.2f} ms {counts[name]:6d} x {name[:110]}",
              flush=True)

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_probe: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    cs.run_phase13(dev)
    if args.profile:
        profile_step(dev)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
