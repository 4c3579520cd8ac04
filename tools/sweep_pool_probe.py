#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 12 alone: the sweep process pool.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/sweep_pool_probe.py

It builds every kernel library (as ``sweep.map_points`` does before it
starts a pool on the card), then runs ``chip_smoke.run_phase12``: phase
6c's twelve points (``config3`` at the ``full`` preset, the six
``test_system`` policies on ``moti2`` and ``moti1``, three lanes a group:
four group tasks) through ``sweep.map_points(engine="host")`` with
``jobs=1`` and with four workers, each from an empty cache, the two equal
bitwise and the moti2 six equal to the test_system golden, every kernel
of the path launched and at least two workers holding a context on the
card (``nvidia-smi``); then the chaos suite's four tiny points on two
workers under a crash, a hang with the watchdog armed, and a raise with
a corrupted commit, each equal to the clean run.  Without phase 6c in
the same run it does not compare with 6c's host leg.  The card's name
and power limit come first and last.  A quick check of a pool change
before a full ``chip_smoke.py`` run.

It exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_pool_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch import exp
    from repro_torch.kernels import _build
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    with open(cs.SYSTEM) as f:
        system = json.load(f)
    spec = exp.ExperimentSpec.grid(config=cs.CONFIG, mix=[cs.MIX, "moti1"],
                                   policy=system["policies"], params="full")
    cache = os.path.join(ROOT, "build", "sweep_pool_probe_cache")
    t0 = time.time()
    try:
        cs.run_phase12(spec, system, torch.device("cuda"), cache)
    finally:
        for leftover in os.listdir(os.path.dirname(cache)):
            if leftover.startswith(os.path.basename(cache)):
                shutil.rmtree(os.path.join(os.path.dirname(cache), leftover),
                              ignore_errors=True)
    print(f"[pool] probe {time.time() - t0:.1f} s", flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
