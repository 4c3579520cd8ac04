#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's kernels from the checkout's sources, holds each
kernel against its plain PyTorch version on the card, and drives the
port's two paths at full size, each with the kernels' launch counts set to
0 just before and read just after:

* phase 4, one paper data point, ``config3``/``moti2`` at the ``full``
  preset: the calibrated deadline, then ``hydra`` and ``arp-cs-as-d``
  through ``load_artifacts`` -> ``Lane(device="cuda")`` -> ``drive_lane``,
  held to ``src/repro_torch/golden/config3_moti2_full.json``;
* phase 6, the ``tests/test_system.py`` spec (six policies on the same
  cell) through ``exp.run`` with ``ExecPlan(engine="host",
  fit_engine="bucketed")`` from an empty cache, held to
  ``src/repro_torch/golden/config3_moti2_full_system.json`` and the
  paper's orderings, then served again wholly from the cache; phase 7,
  the bucketed engine's LERN prediction accuracy on ``config7``.

Every phase raises on failure.  Without CUDA, or without the rest of the
repository, it exits non-zero and prints no result.

The second-to-last lines of standard output are a JSON object of per-kernel
numbers and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "src", "repro_torch", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "config3_moti2_full.json")
SYSTEM = os.path.join(GOLDEN_DIR, "config3_moti2_full_system.json")
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
    the first call's inputs (or, with ``largest``, of the call with the
    largest first input); the wrapper's own launch count is untouched."""

    def __init__(self, module, name, largest: bool = False):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.largest = largest
        setattr(module, name, self)

    def __call__(self, *args):
        if self.args is None or (self.largest and args[0].numel()
                                 > self.args[0].numel()):
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
    launch-bound, that is its wall time), its calls and, for the LLC
    round loops, the rounds and lane-rounds they ran."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seconds, self.calls, self.rounds, self.lane_rounds = 0.0, 0, 0, 0
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
                self.lane_rounds += args[2].shape[0]
            elif self.name == "simulate_epoch_lanes":
                self.rounds += args[3].shape[1]
                self.lane_rounds += args[3].shape[0] * args[3].shape[1]

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


def dense_case(n, d, k, dtype, rng, dev, batch=None):
    """tests/test_kernels.py's dense inputs: well-separated clusters, in
    f32 or bf16; with ``batch``, a leading batch axis."""
    import torch
    shape = () if batch is None else (batch,)
    centers = torch.as_tensor(rng.normal(size=shape + (k, d)) * 10,
                              dtype=torch.float32)
    pick = torch.as_tensor(rng.integers(0, k, shape + (n,)))
    x = (torch.gather(centers, -2, pick[..., None].expand(*pick.shape, d))
         + torch.as_tensor(rng.normal(size=shape + (n, d)) * 0.01,
                           dtype=torch.float32))
    return x.to(dtype).to(dev), centers.to(dtype).to(dev)


def check_dense(kops, x, centers, what: str) -> int:
    import torch
    a1 = kops.assign(x, centers)
    a2 = kops.assign_plain(x, centers)
    torch.cuda.synchronize()
    bad = int((a1 != a2).sum())
    if bad:
        raise AssertionError(f"kmeans_assign kernel != plain on {bad} rows "
                             f"({what})")
    return int((a1 - a2).abs().max())


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


def system_point(res) -> dict:
    """One SimResult in the system golden file's form (the history as
    [length, exact sum, min, max] per series)."""
    return {"summary": res.summary(), "epochs": res.epochs,
            "llc_accesses": res.llc_accesses,
            "dram_accesses": res.dram_accesses,
            "completion_cycles": list(res.completion_cycles),
            "core_hit_rate": res.core_hit_rate,
            "accel_hit_rate": res.accel_hit_rate,
            "deadline_cycles": res.deadline_cycles,
            "history": {k: [len(v), math.fsum(v), min(v, default=0.0),
                            max(v, default=0.0)]
                        for k, v in sorted(res.history.items())}}


def compare(got, want, where: str) -> None:
    """Integers (and bools) equal, floats within RTOL, structures alike."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{where}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            compare(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{where}: length {len(got)} != "
                                 f"{len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        if not close(float(got), want):
            raise AssertionError(f"{where}: {got!r} != golden {want!r} "
                                 f"(rtol {RTOL})")
    elif got != want:
        raise AssertionError(f"{where}: {got!r} != golden {want!r}")


def kernel_row(name, route, source, replaces, launches, err, ms, plain_ms,
               n_bytes, n_ops, library_ms, shape) -> dict:
    bound_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_ops / FP32_FLOPS * 1e3
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": library_ms, "shape": shape}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (os.path.exists(GOLDEN) and os.path.exists(SYSTEM)):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    cache = os.path.join(ROOT, "build", "chip_smoke_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_CACHE"] = cache

    import numpy as np
    from repro_torch import exp
    from repro_torch.core import lern, llc, policies, sim
    from repro_torch.core.dram import default_model
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import ops as kops
    from repro_torch.kernels.ri_histogram import ops as hops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    t_script = time.time()

    # 1. the device
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"count {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. the kernel build (one nvcc per source, all started together)
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
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, k in ((64, 4, 4), (777, 4, 4), (2048, 8, 6), (100, 1, 3),
                        (4096, 16, 4)):
            check_dense(kops, *dense_case(n, d, k, dtype, rng, dev),
                        f"n={n} d={d} k={k} {dtype}")
        check_dense(kops, *dense_case(777, 4, 4, dtype, rng, dev, batch=3),
                    f"batched [3, 777, 4] {dtype}")
    log("[kmeans_assign] kernel == plain (argmin) on the test_kernels cases "
        "in f32 and bf16 and a batched case")

    # 4. the main path of the first slice: one data point at full size
    golden = json.load(open(GOLDEN))
    p = sim.SimParams(**golden["params"])
    dram = default_model()
    hist, assign = hops.histogram, kops.assign_segmented
    cap_h = Capture(hops, "histogram")
    cap_a = Capture(kops, "assign_segmented")
    t_llc = Timed(llc, "simulate_epoch")
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

    # 6. the second slice's path: the test_system spec through exp.run
    system = json.load(open(SYSTEM))
    os.environ["REPRO_CACHE"] = cache + "_system"
    shutil.rmtree(os.environ["REPRO_CACHE"], ignore_errors=True)
    spec = exp.ExperimentSpec.grid(config=system["config"],
                                   mix=system["mix"],
                                   policy=system["policies"], params="full")
    if exp.PARAMS.get("full") != sim.SimParams(**system["params"]):
        raise AssertionError("the full preset differs from the golden's")
    plan = exp.ExecPlan(**system["plan"])
    dense = kops.assign
    cap_d = Capture(kops, "assign", largest=True)
    t_lanes = Timed(llc, "simulate_epoch_lanes")
    t_llc = Timed(llc, "simulate_epoch")
    t_fit = [Timed(sim, "train_model_batched"),
             Timed(sim, "train_family_batched")]
    hist.launches = assign.launches = dense.launches = 0
    t0 = time.time()
    rs = exp.run(spec, plan=plan, device=dev)
    torch.cuda.synchronize()
    wall_sys = time.time() - t0
    sys_launches = {"ri_histogram": hist.launches,
                    "kmeans_assign": dense.launches,
                    "kmeans_assign_segmented": assign.launches}
    for hook in (cap_d, t_lanes, t_llc, *t_fit):
        hook.restore()
    llc_s = t_lanes.seconds + t_llc.seconds
    fit_s = sum(t.seconds for t in t_fit)
    rounds = t_lanes.rounds + t_llc.rounds
    lane_rounds = t_lanes.lane_rounds + t_llc.lane_rounds
    log(f"[system] exp.run of {len(spec)} points wall {wall_sys:.1f} s, "
        f"launches {sys_launches}; LLC round loop {llc_s:.1f} s "
        f"({t_lanes.calls} lane-batched chunks of {t_lanes.rounds} rounds "
        f"and {t_lanes.lane_rounds} lane-rounds, "
        f"{t_lanes.seconds / max(t_lanes.rounds, 1) * 1e3:.3f} ms a round; "
        f"{t_llc.calls} one-lane chunks of {t_llc.rounds} rounds, "
        f"{t_llc.seconds / max(t_llc.rounds, 1) * 1e3:.3f} ms a round; "
        f"{llc_s / max(lane_rounds, 1) * 1e3:.3f} ms a lane-round over "
        f"{rounds} rounds); LERN fit {fit_s:.2f} s "
        f"({sum(t.calls for t in t_fit)} fits); host loop and waits "
        f"{wall_sys - llc_s - fit_s:.1f} s")
    if dense.launches <= 0 or hist.launches <= 0:
        raise AssertionError(f"the exp.run path did not launch every kernel "
                             f"of its fit: {sys_launches}")
    got = {row["policy"]: row["result"] for row in rs.to_rows()}
    for name, want in system["points"].items():
        compare(json.loads(json.dumps(system_point(got[name]))), want,
                f"system.{name}")
    log(f"[system] all {len(got)} points match the golden (bitwise: "
        f"{json.loads(json.dumps({k: system_point(v) for k, v in got.items()})) == system['points']})")
    for name, want in golden["points"].items():
        check_point(f"segmented golden {name}", got[name], want)
    r = got
    orderings = {
        "arp-nb and hydra meet the deadline":
            r["arp-nb"].dmr == 0.0 and r["hydra"].dmr == 0.0,
        "arp-cs-as-d dmr <= arp-cs-as dmr":
            r["arp-cs-as-d"].dmr <= r["arp-cs-as"].dmr,
        "arp-cs-as-d accel_br <= arp-cs-as accel_br":
            r["arp-cs-as-d"].accel_br <= r["arp-cs-as"].accel_br,
        "hydra beats arp-cs-as-d (dmr <=, ipc >)":
            r["hydra"].dmr <= r["arp-cs-as-d"].dmr
            and r["hydra"].ipc_total > r["arp-cs-as-d"].ipc_total,
        "hydra accel_br > arp-cs-as-d accel_br":
            r["hydra"].accel_br > r["arp-cs-as-d"].accel_br,
        "hydra core hit rate > arp-nb core hit rate":
            r["hydra"].core_hit_rate > r["arp-nb"].core_hit_rate,
    }
    h = r["hydra"].history
    orderings["hydra history recorded, thresholds move"] = (
        len(h["accel_rate"]) == r["hydra"].epochs
        and max(h["accel_rate"]) > 0
        and any(t != h["ri_th"][0] for t in h["ri_th"]))
    failed = [k for k, ok in orderings.items() if not ok]
    if failed:
        raise AssertionError(f"test_system orderings fail: {failed}")
    log(f"[system] orderings hold: {'; '.join(orderings)}")
    t0 = time.time()
    rs2 = exp.run(spec, plan=plan, device=dev)
    by_source = rs2.run_report.summary()["by_source"]
    if by_source != {"cache": len(spec)} or any(
            system_point(a) != system_point(b)
            for a, b in zip(rs2.results(), rs.results())):
        raise AssertionError(f"second exp.run not served wholly from the "
                             f"cache: {by_source}")
    log(f"[system] second exp.run served from the cache in "
        f"{time.time() - t0:.2f} s: {by_source}")

    # 7. LERN prediction accuracy on config7 under the bucketed engine
    acc_want = system["lern_accuracy"]
    dense.launches = hist.launches = 0
    t0 = time.time()
    with lern.fit_engine_override(acc_want["fit_engine"]):
        model = sim.load_lern(acc_want["config"], acc_want["variant"],
                              acc_want["subsample_target"], device=dev)
    tr = sim.load_trace(acc_want["config"], acc_want["subsample_target"])
    acc = lern.prediction_accuracy(model, tr)
    log(f"[accuracy] {acc_want['config']} bucketed fit {time.time() - t0:.1f}"
        f" s, launches kmeans_assign {dense.launches} ri_histogram "
        f"{hist.launches}; accuracy {acc!r} (golden "
        f"{acc_want['accuracy']!r})")
    if dense.launches <= 0:
        raise AssertionError("the config7 fit never launched kmeans_assign")
    if acc != acc_want["accuracy"] or not acc > 0.7:
        raise AssertionError(f"prediction accuracy {acc} != golden "
                             f"{acc_want['accuracy']} or not > 0.7")

    # 3b. the kernels at the shapes the paths handed them
    kernels = []
    (ri,) = cap_h.args
    b1, c1 = hops.histogram(ri)
    b2, c2 = hops.histogram_plain(ri)
    torch.cuda.synchronize()
    if not (torch.equal(b1, b2) and torch.equal(c1, c2)):
        raise AssertionError("ri_histogram kernel != plain at the main path")
    n = ri.shape[0]
    edges = torch.tensor([-1, 10, 100, 500], dtype=torch.int32, device=dev)
    kernels.append(kernel_row(
        "ri_histogram", "triton",
        "src/repro_torch/kernels/ri_histogram/kernel.py",
        "src/repro/kernels/ri_histogram/kernel.py:29",
        launches["ri_histogram"], int((b1 - b2).abs().max()),
        time_ms(lambda: hops.histogram(ri)),
        time_ms(lambda: hops.histogram_plain(ri)),
        4 * n + 4 * n + 4 * hops.NUM_BINS, 0,
        time_ms(lambda: torch.bucketize(ri, edges)), {"N": n}))
    x, centers, seg = cap_a.args
    err = check_assign(kops, x, centers, seg, "main path")
    pr, d = x.shape
    s, k, _ = centers.shape
    kernels.append(kernel_row(
        "kmeans_assign_segmented", "cuda",
        "src/repro_torch/csrc/kmeans_assign_segmented.cu",
        "src/repro/kernels/kmeans_assign/kernel.py:39",
        launches["kmeans_assign_segmented"], err,
        time_ms(lambda: kops.assign_segmented(x, centers, seg)),
        time_ms(lambda: kops.assign_segmented_plain(x, centers, seg)),
        4 * (pr * d + pr + s * k * d + pr), pr * k * 4 * d, None,
        {"P": pr, "D": d, "S": s, "K": k}))
    x, centers = cap_d.args
    err = check_dense(kops, x, centers, "exp.run path")
    b, nd, d = x.shape
    k = centers.shape[1]
    kernels.append(kernel_row(
        "kmeans_assign", "cuda", "src/repro_torch/csrc/kmeans_assign.cu",
        "src/repro/kernels/kmeans_assign/kernel.py:72",
        sys_launches["kmeans_assign"], err,
        time_ms(lambda: kops.assign(x, centers)),
        time_ms(lambda: kops.assign_plain(x, centers)),
        x.element_size() * (b * nd * d + b * k * d) + 4 * b * nd,
        b * nd * k * (2 * d + 2), None, {"B": b, "N": nd, "D": d, "K": k}))
    for kr in kernels:
        log(f"[{kr['name']}] at path shape {kr['shape']}: kernel "
            f"{kr['ms']:.4f} ms, plain {kr['plain_ms']:.4f} ms, bound "
            f"{kr['bound_ms'] * 1e3:.3f} us ({kr['bound_by']}), library "
            f"{kr['library_ms']} ms, launches {kr['launches']}")

    # 5. the LERN fit twice on the card, and once on the CPU
    os.environ["REPRO_CACHE"] = cache
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
    for f in fields:
        if not np.array_equal(getattr(m1, f), getattr(m3, f)):
            raise AssertionError(f"LERN fit card vs CPU differs in {f}")
    log(f"[lern] two fits on the card identical and equal to the CPU fit "
        f"(tables and centres); one fit {t_fit:.2f} s")
    log(f"[done] whole script {time.time() - t_script:.1f} s after import")

    log(json.dumps({"kernels": [{k: v for k, v in kr.items() if k != "shape"}
                                for kr in kernels]}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
