#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11 alone: the serve replay at full width.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/serve_replay_probe.py

It builds ``src/repro_torch/csrc/kmeans_assign.cu`` (the serve profile's
``kmeans_fit`` and ``kmeans_assign`` kernels; the replay's super-step is
torch ops), then runs ``chip_smoke.run_serve_replay`` on
``src/repro_torch/golden/serve_replay_full.json``: the four cells of
``benchmarks/bench_serve.py``'s full grid through ``serve.run`` on the
batched engine (every super-step under the sync check) and on the host
oracle in turns, each equal to the other and to the golden file.  It
prints each leg's wall, super-steps, enqueue and read seconds and kernel
launches, the cells' DMR gap, and a profiler reading of two super-steps
of the largest cell.  The card's name and power limit come first and
last.  A quick check of a replay change before a full ``chip_smoke.py``
run (about a minute of command).

It exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serve_replay_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import ops as kops
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build(["kmeans_assign"])
    print(f"[build] kmeans_assign {time.time() - t0:.1f} s", flush=True)
    with open(cs.SERVE_REPLAY) as f:
        golden = json.load(f)
    t0 = time.time()
    r = cs.run_serve_replay(golden, kops, torch.device("cuda"))
    for c in r["cells"]:
        print(f"[replay] {c['name']}: " + "; ".join(
            f"{leg} {c[leg]['wall_s']:.3f} s, {c[leg]['supersteps']} "
            f"super-steps, enqueue {c[leg]['enqueue_s']:.3f} s, reads "
            f"{c[leg]['read_s']:.3f} s, launches {c[leg]['launches']}"
            for leg in ("batched", "host"))
            + f"; refits {c['batched']['row']['refits']}, peak_concurrent "
            f"{c['batched']['row']['peak_concurrent']:g}", flush=True)
    print(f"[replay] resid_dmr_delta {r['resid_dmr_delta']}; busy "
          f"{r['busy']} ({r['busy_cell']}); equal to the host oracle and "
          f"the golden in every cell; {time.time() - t0:.1f} s", flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
