"""Serving launcher: batched decode with the HyDRA KV-residency scheduler
(the JAX package's ``launch/serve.py`` with a ``--device`` flag).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 12 [--no-hydra] [--device cpu]

As the JAX launcher, it serves the arch's reduced config with weights from
seed 0 and prints the engine's stats; every family serves (dense, moe:
``--arch qwen2-moe-a2.7b`` or ``mixtral-8x22b``, ssm: ``--arch
rwkv6-1.6b``, hybrid: ``--arch zamba2-2.7b``, encdec: ``--arch
whisper-base``, its cross K/V unprimed as in the JAX engine, vlm: ``--arch
paligemma-3b``, decoding tokens only).  The device defaults to the card.
"""
import argparse

import numpy as np
import torch

from .. import device as _device
from ..configs import get_arch
from ..models import lm
from ..serve import HydraKVScheduler, SchedulerKnobs
from ..serve.engine import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-hydra", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = _device.resolve(args.device)
    cfg = get_arch(args.arch).reduced()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    sched = None if args.no_hydra else HydraKVScheduler(
        SchedulerKnobs(token_budget=4096,
                       deadline_tokens=args.max_new * 8), device=dev)
    eng = ServeEngine(cfg, params, slots=args.slots, s_max=128,
                      scheduler=sched)
    rng = np.random.default_rng(0)
    reqs = [Request(session_id=i, prompt=[1, 2, 3], max_new=args.max_new,
                    deadline_steps=args.max_new * 20,
                    arrival=int(rng.integers(0, 32)))
            for i in range(args.requests)]
    out = eng.run(reqs, max_steps=4000)
    print(out)


if __name__ == "__main__":
    main()
