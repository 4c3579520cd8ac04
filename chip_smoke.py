#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's kernels from the checkout's sources, holds each
kernel against its plain PyTorch version on the card, drives the port's
main path -- one paper data point, ``config3``/``moti2`` at the ``full``
preset: the calibrated deadline, then ``hydra`` and ``arp-cs-as-d``
through ``load_artifacts`` -> ``Lane(device="cuda")`` -> ``drive_lane`` --
and holds the results to the JAX reference's numbers in
``src/repro_torch/golden/config3_moti2_full.json`` and to the paper's
orderings.  Every phase raises on failure.  Without CUDA, or without the
rest of the repository, it exits non-zero and prints no result.

The second-to-last lines of standard output are a JSON object of per-kernel
numbers and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "golden",
                      "config3_moti2_full.json")
CONFIG, MIX = "config3", "moti2"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
RTOL = 1e-6


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median time of one call on the card, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


class Capture:
    """Wraps a kernel wrapper where the port calls it, keeping a copy of
    the first call's inputs; the wrapper's own launch count is untouched."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args):
        if self.args is None:
            self.args = tuple(a.clone() for a in args)
        return self.fn(*args)

    # the wrapper counts through its module-level name, which is this
    # object while the capture is installed
    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def restore(self):
        setattr(self.module, self.name, self.fn)


class Timed:
    """Wraps a function where the port calls it and adds up the host
    seconds spent in it (for work that ends in a device sync, or that is
    launch-bound, that is its wall time) and its calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seconds, self.calls, self.rounds = 0.0, 0, 0
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            if self.name == "simulate_epoch":
                self.rounds += args[2].shape[0]

    def restore(self):
        setattr(self.module, self.name, self.fn)


def check_ri_histogram(hops, dev, n: int, rng):
    import torch
    ri = torch.as_tensor(rng.integers(-1, 3000, n), dtype=torch.int32,
                         device=dev)
    b1, c1 = hops.histogram(ri)
    b2, c2 = hops.histogram_plain(ri)
    torch.cuda.synchronize()
    if not (torch.equal(b1, b2) and torch.equal(c1, c2)):
        raise AssertionError(f"ri_histogram kernel != plain at N={n}")


def segmented_case(sizes, d, k, rng, dev):
    """The flat-segmented layout of tests/test_kernels.py."""
    import numpy as np
    import torch
    from repro_torch.core.kmeans import segment_layout
    off, total = segment_layout(sizes)
    s = len(sizes)
    x = np.zeros((total, d), np.float32)
    seg = np.full(total, s, np.int32)
    for i, n in enumerate(sizes):
        x[off[i]:off[i] + n] = rng.normal(size=(n, d)) * 3
        seg[off[i]:off[i] + n] = i
    centers = rng.normal(size=(s, k, d)).astype(np.float32)
    return (torch.as_tensor(x, device=dev),
            torch.as_tensor(centers, device=dev),
            torch.as_tensor(seg, device=dev))


def check_assign(kops, x, centers, seg, what: str) -> int:
    import torch
    a1 = kops.assign_segmented(x, centers, seg)
    a2 = kops.assign_segmented_plain(x, centers, seg)
    torch.cuda.synchronize()
    valid = seg < centers.shape[0]
    bad = int((a1 != a2)[valid].sum())
    if bad:
        raise AssertionError(f"assign_segmented kernel != plain on {bad} "
                             f"valid rows ({what})")
    return int((a1 - a2)[valid].abs().max()) if bool(valid.any()) else 0


def close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * abs(b)


def check_point(name, res, want) -> None:
    got = {"summary": res.summary(), "epochs": res.epochs,
           "llc_accesses": res.llc_accesses,
           "dram_accesses": res.dram_accesses,
           "completion_cycles": list(res.completion_cycles)}
    if got["epochs"] != want["epochs"]:
        raise AssertionError(f"{name}: epochs {got['epochs']} != "
                             f"{want['epochs']}")
    if len(got["completion_cycles"]) != len(want["completion_cycles"]):
        raise AssertionError(f"{name}: completions differ")
    pairs = [(f"summary.{k}", got["summary"][k], want["summary"][k])
             for k in want["summary"]]
    pairs += [(k, got[k], want[k]) for k in ("llc_accesses",
                                             "dram_accesses")]
    pairs += [(f"completion[{i}]", g, w) for i, (g, w) in enumerate(
        zip(got["completion_cycles"], want["completion_cycles"]))]
    for field, g, w in pairs:
        if not close(g, w):
            raise AssertionError(f"{name}: {field} {g!r} != golden {w!r} "
                                 f"(rtol {RTOL})")
    log(f"  {name}: matches golden (bitwise: {got == want})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.exists(GOLDEN):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    cache = os.path.join(ROOT, "build", "chip_smoke_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_CACHE"] = cache

    import numpy as np
    from repro_torch.core import lern, policies, sim
    from repro_torch.core.dram import default_model
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import ops as kops
    from repro_torch.kernels.ri_histogram import ops as hops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    # 1. the device
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"count {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. the kernel build
    t0 = time.time()
    reports = _build.build()
    for name, rep in reports.items():
        log(f"[build] nvcc {name}: " + " | ".join(
            ln.strip() for ln in rep.splitlines() if "registers" in ln
            or "Compiling" in ln))
    t_nvcc = time.time() - t0
    rng = np.random.default_rng(3)
    t0 = time.time()
    check_ri_histogram(hops, dev, 8, rng)       # compiles the Triton kernel
    log(f"[build] nvcc {t_nvcc:.1f} s, triton ri_histogram "
        f"{time.time() - t0:.1f} s")

    # 3a. each kernel against its plain version at the test shapes
    for n in (8, 100, 4096, 10_000, 299_636):
        check_ri_histogram(hops, dev, n, rng)
    log("[ri_histogram] kernel == plain (bitwise) at N = 8, 100, 4096, "
        "10000, 299636")
    rng = np.random.default_rng(11)
    for sizes, d, k in (([13, 8, 29], 4, 4), ([100], 4, 4),
                        ([8, 8, 8, 8], 8, 4), ([5, 300, 11], 4, 6)):
        check_assign(kops, *segmented_case(sizes, d, k, rng, dev),
                     f"sizes={sizes} d={d} k={k}")
    log("[assign_segmented] kernel == plain (argmin) on the test_kernels "
        "cases")

    # 4. the main path at full size
    golden = json.load(open(GOLDEN))
    p = sim.SimParams(**golden["params"])
    dram = default_model()
    hist, assign = hops.histogram, kops.assign_segmented
    cap_h = Capture(hops, "histogram")
    cap_a = Capture(kops, "assign_segmented")
    t_llc = Timed(sim.llc_mod, "simulate_epoch")
    t_lern = Timed(sim, "train_model_batched")
    hist.launches = 0
    assign.launches = 0
    t_main = time.time()
    t0 = time.time()
    deadline = sim.calibrated_deadline(CONFIG, p, dram, device=dev)
    log(f"[main] deadline {deadline!r} ({time.time() - t0:.1f} s)")
    if not close(deadline, golden["deadline_cycles"]):
        raise AssertionError(f"deadline {deadline} != golden "
                             f"{golden['deadline_cycles']}")
    results = {}
    for name in golden["points"]:
        t0 = time.time()
        h0, a0 = hist.launches, assign.launches
        art = sim.load_artifacts(CONFIG, MIX, p)
        res = sim.drive_lane(sim.Lane(CONFIG, MIX, policies.get(name), p,
                                      dram, deadline, art, device=dev),
                             device=dev)
        torch.cuda.synchronize()
        results[name] = res
        log(f"[main] {name}: {res.summary()} epochs {res.epochs} "
            f"wall {time.time() - t0:.1f} s launches ri_histogram "
            f"{hist.launches - h0} assign_segmented {assign.launches - a0}")
    wall_main = time.time() - t_main
    launches = {"ri_histogram": hist.launches,
                "kmeans_assign_segmented": assign.launches}
    for hook in (cap_h, cap_a, t_llc, t_lern):
        hook.restore()
    log(f"[main] wall {wall_main:.1f} s, launches {launches}; in "
        f"llc.simulate_epoch {t_llc.seconds:.1f} s ({t_llc.calls} chunks, "
        f"{t_llc.rounds} rounds, {t_llc.seconds / max(t_llc.rounds, 1) * 1e3:.3f}"
        f" ms a round, enqueue); in the LERN fit {t_lern.seconds:.2f} s "
        f"({t_lern.calls} fits); the rest is the host loop and the waits")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the main path never launched {k}")
    for name, res in results.items():
        check_point(name, res, golden["points"][name])
    hy, sd = results["hydra"], results["arp-cs-as-d"]
    if not (hy.dmr == 0.0 and hy.ipc_total > sd.ipc_total
            and hy.accel_br > sd.accel_br):
        raise AssertionError("test_system orderings do not hold")
    log("[main] orderings hold: hydra.dmr == 0, hydra.ipc > "
        "arp-cs-as-d.ipc, hydra.accel_br > arp-cs-as-d.accel_br")

    # 3b. the kernels at the main path's shapes
    kernels = []
    (ri,) = cap_h.args
    b1, c1 = hops.histogram(ri)
    b2, c2 = hops.histogram_plain(ri)
    torch.cuda.synchronize()
    if not (torch.equal(b1, b2) and torch.equal(c1, c2)):
        raise AssertionError("ri_histogram kernel != plain at the main path")
    n = ri.shape[0]
    edges = torch.tensor([-1, 10, 100, 500], dtype=torch.int32, device=dev)
    h_bytes = 4 * n + 4 * n + 4 * hops.NUM_BINS
    kernels.append({
        "name": "ri_histogram", "route": "triton",
        "source": "src/repro_torch/kernels/ri_histogram/kernel.py",
        "replaces": "src/repro/kernels/ri_histogram/kernel.py:29",
        "launches": launches["ri_histogram"],
        "max_abs_err": int((b1 - b2).abs().max()),
        "ms": time_ms(lambda: hops.histogram(ri)),
        "plain_ms": time_ms(lambda: hops.histogram_plain(ri)),
        "bound_ms": h_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.bucketize(ri, edges)),
        "shape": {"N": n}})
    x, centers, seg = cap_a.args
    err = check_assign(kops, x, centers, seg, "main path")
    pr, d = x.shape
    s, k, _ = centers.shape
    a_bytes = 4 * (pr * d + pr + s * k * d + pr)
    a_flops = pr * k * 4 * d
    bound_bytes = a_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops = a_flops / FP32_FLOPS * 1e3
    kernels.append({
        "name": "kmeans_assign_segmented", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign_segmented.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:39",
        "launches": launches["kmeans_assign_segmented"],
        "max_abs_err": err,
        "ms": time_ms(lambda: kops.assign_segmented(x, centers, seg)),
        "plain_ms": time_ms(lambda: kops.assign_segmented_plain(
            x, centers, seg)),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
        "shape": {"P": pr, "D": d, "S": s, "K": k}})
    for kr in kernels:
        log(f"[{kr['name']}] at main-path shape {kr['shape']}: kernel "
            f"{kr['ms']:.4f} ms, plain {kr['plain_ms']:.4f} ms, bound "
            f"{kr['bound_ms'] * 1e3:.3f} us ({kr['bound_by']}), library "
            f"{kr['library_ms']} ms, launches {kr['launches']}")

    # 5. the LERN fit twice on the card, and once on the CPU
    tr = sim.load_trace(CONFIG, p.subsample_target)
    t0 = time.time()
    m1 = lern.train_model_batched(tr, device=dev)
    t_fit = time.time() - t0
    m2 = lern.train_model_batched(tr, device=dev)
    m3 = lern.train_model_batched(tr, device="cpu")
    fields = ("uniq", "rc_cluster", "ri_cluster", "n_uniq", "rc_centers",
              "ri_centers")
    for f in fields:
        if not np.array_equal(getattr(m1, f), getattr(m2, f)):
            raise AssertionError(f"two LERN fits on the card differ in {f}")
    for f in fields[:4]:
        if not np.array_equal(getattr(m1, f), getattr(m3, f)):
            raise AssertionError(f"LERN fit card vs CPU differs in {f}")
    log(f"[lern] two fits on the card identical (tables and centres); "
        f"tables equal the CPU fit; centres card vs CPU bitwise: "
        f"{all(np.array_equal(getattr(m1, f), getattr(m3, f)) for f in fields[4:])}"
        f"; one fit {t_fit:.2f} s")

    log(json.dumps({"kernels": [{k: v for k, v in kr.items() if k != "shape"}
                                for kr in kernels]}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
