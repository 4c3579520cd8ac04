#!/usr/bin/env python3
"""Choose the cluster size of the ``ri_histogram`` kernel on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/ri_histogram_probe.py

It compiles ``src/repro_torch/csrc/ri_histogram.cu`` with its cluster of
``kCluster`` CTAs set to 8 (the portable maximum) and to 16 (which needs
the non-portable cluster size) into ``build/ri_histogram_probe/``, with the
port's own ``nvcc`` flags, and prints each build's ``-Xptxas -v`` report
and how many such clusters the card holds (``cudaOccupancyMaxActiveClusters``;
0: the size does not fit).  Then, for every size that fits, at N = 303,104
(the main path's), 2^20, 2^22 and 2^24 random intervals, it holds the
kernel bitwise against ``ops.histogram_plain`` and times it in turns (8,
16, 16, 8): the kernel's device time (``torch.profiler``, median of 50
calls, no other device work) and the time of a call as ``chip_smoke.py``'s
``time_ms`` takes it (CUDA events around a call that allocates its
outputs and finds the stream as the wrapper does), beside the bound (4 B
read and 4 B written an element at 3.35 TB/s) and the same launch of the
empty kernel.  Last, the host's cost of a wrapper call and of its parts
(``host_costs``).  The card's name and power limit come first and last
(about 30 s of command).

It exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ri_histogram_probe")
_SIZE = re.compile(r"constexpr int kCluster = \d+;")
SIZES = (8, 16)
LENGTHS = (303_104, 2 ** 20, 2 ** 22, 2 ** 24)


def build(src: str, nvcc: str, flags) -> dict:
    """One library per cluster size, all compiled together: size ->
    (library, ptxas report)."""
    if len(_SIZE.findall(src)) != 1:
        raise RuntimeError(f"source changed: {_SIZE.pattern} not found once")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for size in SIZES:
        path = os.path.join(OUT, f"cluster{size}.cu")
        with open(path, "w") as f:
            f.write(_SIZE.sub(f"constexpr int kCluster = {size};", src))
        procs[size] = subprocess.Popen(
            [nvcc, *flags, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for size, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cluster {size}:\n{report}")
        lib = ctypes.CDLL(os.path.join(OUT, f"cluster{size}.so"))
        lib.ri_histogram.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int, ctypes.c_void_p])
        lib.ri_histogram_empty.argtypes = [ctypes.c_void_p]
        lib.ri_histogram_cluster.argtypes = [ctypes.c_void_p] * 2
        libs[size] = (lib, report)
    return libs


def host_costs(hops, libs, dev, calls: int = 2000) -> dict:
    """Microseconds of host time a call of the wrapper and of its parts at
    the main path's N (the device is idle or faster throughout, so the
    host's clock over many calls is the host's cost)."""
    import torch
    from repro_torch.kernels.common import on_card
    from repro_torch.kernels.ri_histogram import kernel as hkernel
    n = 303_104
    ri = torch.zeros(n, dtype=torch.int32, device=dev)
    buf = torch.empty(n + hops.NUM_BINS, dtype=torch.int32, device=dev)
    edges = torch.tensor([-1, 10, 100, 500], dtype=torch.int32, device=dev)
    raw = torch.cuda.current_stream(dev).cuda_stream
    parts = {
        "wrapper ops.histogram": lambda: hops.histogram(ri),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.empty": lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "a slice": lambda: buf[n:],
        "data_ptr": lambda: ri.data_ptr(),
        "empty kernel, kernel.launch_empty": lambda: hkernel.launch_empty(
            dev),
        "torch.bucketize": lambda: torch.bucketize(ri, edges),
    }
    for size, lib in libs.items():
        parts[f"empty kernel, cluster {size}, ctypes, stream given"] = (
            lambda lib=lib: lib.ri_histogram_empty(raw))

    def guard():
        with on_card(ri.device):
            pass

    parts["on_card, the device guard of every launch, entered and left"] = \
        guard
    out = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) / calls * 1e6
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ri_histogram_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ri_histogram import ops as hops
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    with open(os.path.join(_build.CSRC, "ri_histogram.cu")) as f:
        libs = build(f.read(), _build.nvcc(), _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    fits = {}
    for size, (lib, report) in libs.items():
        got, active = ctypes.c_int(), ctypes.c_int()
        err = lib.ri_histogram_cluster(ctypes.addressof(got),
                                       ctypes.addressof(active))
        fits[size] = active.value if err == 0 else 0
        print(f"[build] cluster {size}: " + " | ".join(
            ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln) + f" | "
            f"cudaOccupancyMaxActiveClusters {active.value} (cudaError "
            f"{err})", flush=True)

    def stream():
        return torch._C._cuda_getCurrentRawStream(0)

    def call(lib, ri):
        """What ``ops.histogram`` does for a fresh ri, with ``lib``."""
        bins, counts = torch.empty_like(ri), ri.new_empty(hops.NUM_BINS)
        err = lib.ri_histogram(ri.data_ptr(), bins.data_ptr(),
                               counts.data_ptr(), ri.shape[0], stream())
        if err != 0:
            raise RuntimeError(f"ri_histogram launch failed: cudaError {err}")
        return bins, counts

    sizes = [s for s in SIZES if fits[s] > 0]
    rng = np.random.default_rng(5)
    rows = []
    for n in LENGTHS:
        ri = torch.as_tensor(rng.integers(-1, 3000, n), dtype=torch.int32,
                             device=dev)
        want = hops.histogram_plain(ri)
        for size in sizes:
            got = call(libs[size][0], ri)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"cluster {size} != plain at N={n}")
        times = {s: {"device_ms": [], "call_ms": []} for s in sizes}
        for size in sizes + sizes[::-1]:
            lib = libs[size][0]
            times[size]["device_ms"].append(cs.one_kernel_a_call(
                cs.device_events(lambda: call(lib, ri), 50), 50,
                "ri_histogram_kernel", f"cluster {size} N={n}")[0])
            times[size]["call_ms"].append(cs.time_ms(lambda: call(lib, ri)))
        bound = 8 * n / cs.HBM_BYTES_PER_S * 1e3
        for size in sizes:
            row = {"cluster": size, "N": n, "bound_ms": bound, **times[size]}
            rows.append(row)
            print(f"[ri_histogram] cluster {size} N={n}: device "
                  f"{times[size]['device_ms']} ms, call "
                  f"{times[size]['call_ms']} ms (in turns), bound "
                  f"{bound:.6f} ms", flush=True)
    for size in sizes:
        lib = libs[size][0]
        empty, _ = cs.one_kernel_a_call(
            cs.device_events(lambda: lib.ri_histogram_empty(stream()), 50),
            50, "ri_histogram_empty_kernel", f"empty, cluster {size}")
        print(f"[empty] cluster {size}: device {empty:.5f} ms, call "
              f"{cs.time_ms(lambda: lib.ri_histogram_empty(stream())):.5f} "
              f"ms", flush=True)
    host = host_costs(hops, {s: libs[s][0] for s in sizes}, dev)
    print("[host] us a call, host clock over 2000 calls then one sync: "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    print(json.dumps({"fits": fits, "rows": rows, "host_us": host}),
          flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
