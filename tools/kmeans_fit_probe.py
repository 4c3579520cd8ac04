#!/usr/bin/env python3
"""Hold and time the whole-fit k-means kernels on the card, without the
rest of ``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/kmeans_fit_probe.py

It builds ``src/repro_torch/csrc/kmeans_assign.cu`` and
``kmeans_assign_segmented.cu`` and prints each kernel's ``-Xptxas -v``
report, then runs ``chip_smoke.check_fits``: every fit case of phase 3b
(each kernel bitwise against its plain fit, on two streams at once) and,
at synthetic inputs of the paths' shapes (a masked fit of B=2, N=32768,
D=4; a segmented fit of 16 lattice segments of 500-12,000 rows), the
kernel and the plain fit timed in turns, with the bound and the chain
floor.  Last, the masked fit at D = 1 (B=2 and B=1 at N=32768, B=1 at
N=2000, the serve profile's B=2 at N=64) in turns against the plain fit.
The card's name and power limit come first.  A quick check of a kernel
change before a full ``chip_smoke.py`` run (about 45 s held).

It exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kmeans_fit_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import ops as kops
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    for name, rep in _build.build(["kmeans_assign",
                                   "kmeans_assign_segmented"]).items():
        print(f"[build] {name}: " + " | ".join(
            ln.strip() for ln in rep.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln),
            flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    masked = cs.masked_case(2, 32768, 4, rng, dev) + (cs.FIT_ITERS,)
    sizes = [int(v) for v in rng.integers(500, 12000, 16)]
    segmented = cs.segmented_fit_case(sizes, 4, 4, rng, dev,
                                      lattice=True) + (cs.FIT_ITERS,)
    rows = cs.check_fits(kops, masked, segmented, dev,
                         {"kmeans_fit": 0, "kmeans_fit_segmented": 0})
    print(json.dumps(rows), flush=True)
    clock = cs.sm_clock_mhz()
    for b, n, d in ((2, 32768, 1), (1, 32768, 1), (1, 2000, 1), (2, 64, 1)):
        x, m, c = cs.masked_case(b, n, d, rng, dev)
        cs.hold_fit_masked(*cs.fit_masked_both(kops, x, m, c, cs.FIT_ITERS),
                           f"B={b} N={n} D={d}")
        t = cs.turns({
            "kernel": lambda: kops.fit_masked(x, m, c, cs.FIT_ITERS),
            "plain": lambda: kops.fit_masked_plain(x, m, c, cs.FIT_ITERS)},
            2)
        floor = (cs.FIT_ITERS * cs.masked_chain(b, n, d) * 4
                 / (clock * 1e3))
        print(f"[kmeans_fit] B={b} N={n} D={d}: kernel {t['kernel']:.4f} "
              f"ms, plain fit {t['plain']:.4f} ms (in turns), chain floor "
              f"{floor:.4f} ms", flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
