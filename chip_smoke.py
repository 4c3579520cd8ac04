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
  the bucketed engine's LERN prediction accuracy on ``config7``;
* phases 4f and 6f, the same data point through
  ``sweep.simulate_group(engine="fused")`` and the same spec through
  ``exp.run(plan=ExecPlan(engine="fused", fit_engine="bucketed"))`` from
  an empty cache, held to the same golden files; each super-step of the
  fused engine runs under ``torch.cuda.set_sync_debug_mode("error")``,
  and a phase fails if no super-step ran on the card;
* phase 6b, the same spec through ``ExecPlan(engine="bucketed",
  fit_engine="bucketed")`` from an empty cache, held to the same golden
  file, each super-step of the bucketed engine under the same sync check,
  with its wall beside phases 6 and 6f and the engine's phase split;
  phase 6c, a sweep whose buckets hold two groups each at full width
  (``config3`` at the ``full`` preset, the six ``test_system`` policies
  on ``moti2`` and ``moti1``, three lanes a group) on the bucketed engine
  with its pipeline on and off, each bitwise equal to the host engine and
  with fewer ``llc_rounds`` launches than the per-group fused engine on
  the same groups, then a forced ``bucket`` and ``bucket_overflow`` fault
  on a small case, each leaving the results equal;
* phase 10, fig. 17's scheduler comparison (``config1``/``moti1`` at the
  ``full`` preset, ``DDR4_2400_32b2r_frfcfs`` against
  ``DDR4_2400_32b2r_squash`` at ``deadline_factor=1.0``, ``hydra`` and
  ``fifo-nb``) on the host and fused engines, held to
  ``src/repro_torch/golden/config1_sched.json``, with fig. 17's
  ``sched_dmr_delta`` (the largest |SQUASH - FR-FCFS| dmr) above 0;
* phase 8, prefill of qwen3-1.7b at full width (28 layers, weights from a
  seeded ``torch.Generator``) through ``make_prefill_step(use_flash=True)``
  at B=1, S=32768 and at B=4, S=4096; the forward is run again with
  ``mha_plain`` in the kernel's place, each layer's kernel output on the
  same q, k, v held to it per element, and the last-token logits are
  held to that forward and to the model's other route (chunked and dense
  attention); phase 8g, the model at full width
  with 2 layers on ``convert.lm_numpy_params`` held to the JAX package's
  logits (``src/repro_torch/golden/qwen3_1_7b_w2_serve.json``); phase 9,
  the 28-layer model in ``ServeEngine`` with the ``HydraKVScheduler``
  answering the serve launcher's 12 requests, stats equal to the golden;
* phase 11, the serve replay at full width: the four cells of
  ``benchmarks/bench_serve.py``'s full grid (a drifting Poisson trace of
  6000 sessions, rates 2 and 8 x ``kv-online`` and ``evict-all``, 128
  slots, 4096 steps) through ``serve.run`` on the batched engine
  (``ExecPlan(engine="auto")``, each super-step under the sync check) and
  on the host oracle in turns, every counter, both histograms and the
  scheduler's stats equal to each other and to
  ``src/repro_torch/golden/serve_replay_full.json``, no demotion, and the
  kv-online cells' profile fits and refits on the ``kmeans_fit`` kernel;
* phase 12, the sweep process pool on the card: 12a, phase 6c's twelve
  points through ``sweep.map_points(engine="host", max_lanes=3,
  fit_engine="bucketed")`` with ``jobs=1`` and with four spawned workers
  (four group tasks), each leg from an empty cache, bitwise equal to each
  other, to 6c's host leg and (the moti2 six) to the system golden, every
  kernel of the path launched (in the caller and, counted in each worker
  by ``counted_pool_task``, in the group tasks), at least two workers
  holding a CUDA context of their own, with each leg's wall and the
  pool's start-up; 12b, the chaos suite's four tiny points on two workers
  under a crash (the pool respawns), a hang with the watchdog armed and a
  raise with a corrupted commit, each bitwise equal to the clean run and
  with its event logged;
* phase 13, training: 13a qwen3-1.7b at full width (28 layers, weights
  from a seeded generator on the card) through ``make_train_step(remat=
  True)`` on ``DataPipeline`` batches at B=1, S=4096 (the ``train_4k``
  shape, its global batch cut to 1): a warm step, then three timed steps
  with their tokens/s, losses, grad norms, lr and the peak memory beside
  the step's bound, every leaf changed by the first step with lr > 0, no
  flash launch (training takes the dense route); 13g the model at full
  width with 2 layers on ``convert.lm_numpy_params`` held to the JAX
  package's training golden (``src/repro_torch/golden/
  qwen3_1_7b_w2_train.json``: step 0's per-leaf gradient norms and three
  steps' loss, grad norm and lr); 13r the ``Trainer`` at the reduced
  config resumed at step 10 equal to 15 straight steps within rel 1e-4,
  and a checkpoint the port wrote restored onto the card bit for bit;
* phase 14, the moe and ssm families: 14a qwen2-moe-a2.7b at full width
  (24 layers, seeded weights on the card) through
  ``make_prefill_step(use_flash=True)`` at B=1, S=4096 (24 flash launches,
  all on the Hopper kernel, each layer's output held to ``mha_plain`` on
  the same q, k, v), then ``ServeEngine`` with the ``HydraKVScheduler`` on
  the launcher's requests (stats equal to the golden's; tok/s, ms a decode
  step beside its bound, peak memory); 14b rwkv6-1.6b at full width, its
  prefill at B=1, S=2048 and the engine; 14g the 1-layer qwen2-moe and the
  2-layer rwkv6 at full width on ``convert.lm_numpy_params`` held to the
  JAX package's logits (``src/repro_torch/golden/
  qwen2_moe_a2_7b_w1_serve.json``, ``rwkv6_1_6b_w2_serve.json``); 14c
  ``optim.compress``: ``quantize`` bitwise its CPU result and
  ``quantized_psum_tree`` over an NCCL world of one on qwen3-1.7b's
  full-width leaf shapes within 0.5 x scale per element;
* phase 16, the sharding layer: 16a ``python -m
  repro_torch.launch.dryrun`` on qwen3-1.7b ``train_4k`` at the (16, 16)
  mesh and ``decode_32k`` at (2, 16, 16), each in a child process on a fake
  process group on the host (every record ``ok``; its dominant roofline
  term on H100 constants, per-card peak, collective bytes, fallbacks);
  16b qwen3-1.7b at full width on ``make_host_mesh()`` (NCCL, a world of
  one): saved with ``CheckpointManager``, restored with ``shardings=`` from
  ``rules.param_specs`` as DTensor parameters, a prefill at B=1, S=4096
  through the flash kernel on the local heads (28 launches, all on the
  Hopper kernel) held to the plain parameters' prefill, and two
  ``make_train_step`` steps on each, in turns, held to 13g's bars.

Flash attention has two kernels (``ops.route``): bf16 goes to the Hopper
kernel (``wgmma`` for both products, a TMA-fed K/V ring, a producer
warpgroup), f32 to the CUDA-core kernel.  Phase 2 prints the Hopper
kernel's ``-Xptxas -v`` report (registers, spills) and shared memory, and
counts the ``HGMMA`` instructions of each product in its SASS
(``cuobjdump``).  Phase 3c holds both kernels to their plain version at
the ``tests/test_kernels.py`` cases and the cases the Hopper kernel's
tiling makes new (a ragged single block, Sq != Sk, S=4096 at d=64), and at
one qwen3 layer, checks that every bf16 call went to the Hopper kernel and
every f32 call to the CUDA-core one, and times the Hopper kernel beside
``scaled_dot_product_attention``; phase 8 checks that its 56 launches were
all the Hopper kernel's; phase 3b holds both again at phase 8's largest
shape.

``ri_histogram`` is one launch of one thread-block cluster
(``csrc/ri_histogram.cu``).  Phase 2 prints the cluster's size and how many
such clusters the card holds; phase 3a holds the kernel bitwise (bins and
counts) against its plain version at the lengths of ``RI_SIZES``, the edge
values, an all-negative input, three misaligned views and on a side
stream, and checks with ``torch.profiler`` that a call runs one CUDA
kernel and nothing else; phase 3b times it at the main path's input four
ways: the wrapper (CUDA events around a call), the kernel's device time
(profiler), the same launch of an empty kernel, and ``torch.bucketize``.

The k-means Lloyd fits run in one launch each: ``kmeans_fit`` (the masked
fit of the bucketed engine and of the serve profile) and
``kmeans_fit_segmented`` (the default engine's fit), each followed by one
launch of its assignment kernel for the final assignment.  Phases 4, 6, 7
and 9 count the launches of all four k-means kernels (one fit: one launch
of each kernel of its pair), phase 11 those of ``kmeans_fit`` and
``kmeans_assign`` (the serve profile and its online refits); phase 3b holds each fit kernel against its
plain fit bitwise on test cases, on two streams at once and at the path
shapes, and times them in turns; phase 5b times the paths' fits (config3
segmented and bucketed, config7 bucketed, the serve profile) through the
kernels and through the plain fits in turns.

The LLC round loop of an epoch chunk is one launch of ``llc_rounds``
(``csrc/llc_rounds.cu``): one thread-block cluster per lane, the set rows
in shared memory, a way-parallel search, the SHCT tables replicated in
every CTA with their deltas posted through distributed shared memory.
Phase 2 prints ptxas's registers, stack and spills of each design and the
cluster's shape at the path's geometry (CTAs, threads, shared memory, how
many clusters fit at once); phase 3d holds it bitwise (state, stats,
per-core counts) against its plain loop and against the first design
(``llc_rounds_simple``, one CTA per lane, on no path) on seeded random
epochs: chained chunks at 1024 and 2048 sets with six lanes covering every
accel mode, core bypass, the shared predictor and fig. 18's way masks,
SHIP_LARGE tables, all-padding rounds, the fused engine's round count, a
side stream, one lane through ``rounds_one``; then 8 and 32 ways (with a
lane whose accel events may use no way), 4096 sets, every set a sampler
(deltas from every CTA on a few entries, the counters at both ends), +1
and -1 on one entry from two CTAs in one round at 0 and at counter_max,
and more lanes than the card holds clusters at once.  Phases 4, 6, 4f, 6f
and 10 count its launches; phase 3b holds both designs at phase 4's and
phase 6's largest chunks and times them in turns beside the plain loop,
each design's empty launch, the barrier floor (one cluster barrier a
round with a sampler event), the bound and the chain floor.

Every phase raises on failure.  Without CUDA, or without the rest of the
repository, it exits non-zero and prints no result.

The second-to-last lines of standard output are a JSON object of per-kernel
numbers and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "src", "repro_torch", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "config3_moti2_full.json")
SYSTEM = os.path.join(GOLDEN_DIR, "config3_moti2_full_system.json")
LM_GOLDEN = os.path.join(GOLDEN_DIR, "qwen3_1_7b_w2_serve.json")
SCHED = os.path.join(GOLDEN_DIR, "config1_sched.json")
SERVE_REPLAY = os.path.join(GOLDEN_DIR, "serve_replay_full.json")
TRAIN_GOLDEN = os.path.join(GOLDEN_DIR, "qwen3_1_7b_w2_train.json")
# phase walls before the round loop became a kernel (the last two runs of
# this script before it did, on an NVIDIA H100 80GB HBM3 at 700.00 W;
# PERF.md section 5)
WALLS_BEFORE = {"4": "113.9 / 66.7 s", "6": "158.2 / 106.6 s"}
CONFIG, MIX = "config3", "moti2"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 on the tensor cores
RTOL = 1e-6
# The model-level tolerance (bf16): the JAX package's own flash and plain
# routes differ by up to REF_GAP x max|logit| (measured on the CPU on the
# golden's 2-layer model; tests/test_torch_models.py), so logits may differ
# by twice that, with a floor of 2e-2 x max|logit|; argmax must be equal.
REF_GAP = 0.011514
LOGIT_RTOL = max(2 * REF_GAP, 2e-2)
# The flash kernel against mha_plain at qwen3 shapes and on the 28-layer
# model's own activations (bf16), per element: |kernel - plain| <=
# FLASH_RTOL x |plain| + FLASH_ATOL.  FLASH_RTOL is one to two bf16 ulps;
# on the H100 every output was within one ulp (atol needed 0), so
# FLASH_ATOL is only a floor for outputs near zero, 1/55 of the mean
# |out| of the later rows at S=32768.
FLASH_RTOL = 2 ** -7
FLASH_ATOL = 2 ** -12
# tests/test_kernels.py::test_flash_attention
FLASH_CASES = ((1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 384, 8, 1, 128),
               (2, 128, 4, 4, 32), (1, 256, 8, 1, 256))
# what the Hopper kernel's tiling makes new: (B, Sq, Sk, H, Hkv, d), causal
# -- one ragged block (Sq = Sk = 100 < 128), Sq != Sk (three key blocks
# for one query tile), and many query tiles at d = 64
FLASH_EDGE = (((1, 100, 100, 2, 2, 64), True),
              ((1, 100, 100, 2, 2, 64), False),
              ((2, 128, 384, 4, 2, 128), False),
              ((1, 4096, 4096, 16, 8, 64), True),
              ((1, 100, 100, 8, 1, 256), True),
              ((2, 128, 384, 8, 1, 256), False))

# phase 13a: qwen3-1.7b train steps at the train_4k shape (S=4096) with
# its global batch cut from 256 to 1; lr_warmup=1, so step 0 has lr 0 and
# the next steps move the weights
TRAIN_FULL = dict(batch=1, seq=4096, lr_peak=3e-4, lr_warmup=1,
                  timed_steps=3)


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


def queued_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Time of one call on the card when ``calls`` of them are enqueued
    back to back between two CUDA events: where the host enqueues faster
    than the card runs, the device time of a call without the host's gap
    before it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


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

    def __call__(self, *args, **kw):
        if self.args is None or (self.largest and args[0].numel()
                                 > self.args[0].numel()):
            self.args = tuple(a.clone() if hasattr(a, "clone") else
                              copy.deepcopy(a) for a in args)
        return self.fn(*args, **kw)

    # the wrapper counts through its module-level name, which is this
    # object while the capture is installed
    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    @property
    def kernel_launches(self):
        return self.fn.kernel_launches

    @kernel_launches.setter
    def kernel_launches(self, value):
        self.fn.kernel_launches = value

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


def hold_ri_histogram(hops, ri, what: str, stream=None) -> int:
    """The kernel (on ``stream`` if given) against the plain version, bins
    and counts bitwise; returns the largest |difference| (0)."""
    import torch
    if stream is None:
        b1, c1 = hops.histogram(ri)
    else:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            b1, c1 = hops.histogram(ri)
    b2, c2 = hops.histogram_plain(ri)
    torch.cuda.synchronize()
    if not (torch.equal(b1, b2) and torch.equal(c1, c2)):
        raise AssertionError(f"ri_histogram kernel != plain at {what}")
    return max(int((b1 - b2).abs().max()), int((c1 - c2).abs().max()))


# phase 3a's random lengths: around the 4-element vectors and the 4096
# block of the Pallas kernel, the paths' N, and 2^24
RI_SIZES = (1, 3, 4, 5, 8, 100, 4095, 4096, 4097, 10_000, 299_636, 303_104,
            2 ** 24)
# the edges of the bins, the ends of int32 and "no reuse" (-1)
RI_EDGES = (-2 ** 31, -1, 0, 1, 10, 11, 100, 101, 500, 501, 2 ** 31 - 1)


def ri_cases(dev, rng):
    """Phase 3a's inputs as (what, ri): random intervals in [-1, 3000) at
    RI_SIZES, an all-negative input, the edge values alone and shuffled
    1000 times over, and ri[1:], ri[2:], ri[3:] of a 10,001-element ri."""
    import numpy as np
    import torch

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    for n in RI_SIZES:
        yield f"N={n}", t(rng.integers(-1, 3000, n))
    yield "all negative, N=10000", t(rng.integers(-2 ** 31, 0, 10_000))
    yield "the edge values", t(RI_EDGES)
    yield "the edge values x 1000", t(rng.permutation(np.tile(RI_EDGES,
                                                              1000)))
    base = t(rng.integers(-1, 3000, 10_001))
    for k in (1, 2, 3):
        if base[k:].data_ptr() % 16 == 0:
            raise AssertionError(f"ri[{k}:] is 16-byte aligned")
        yield f"ri[{k}:] of N=10001", base[k:]


def device_events(fn, calls: int, tries: int = 5) -> list:
    """(name, ms) of every device event (kernel, memset, copy) of
    ``calls`` calls of ``fn``, by ``torch.profiler``, after one call.  The
    profiler may lose events (on the H100: 1 of 50 kernels reported in one
    window, 49 of 50 in three windows in a row), so each window opens and
    closes with a ``torch.cuda._sleep`` kernel as padding (left out of the
    result), and a window with fewer events than calls is taken again, up
    to ``tries`` windows; the fullest is returned, and one with more at
    once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        if len(events) > len(best):
            best = events
        if len(events) >= calls:
            break
    return best


def one_kernel_a_call(events: list, calls: int, kernel: str,
                      what: str) -> tuple:
    """Fail if ``calls`` calls ran any device event but ``kernel`` (a
    memset, a copy, another kernel), more than one ``kernel`` a call, or
    none; (the median ms of the events, how many the profiler saw)."""
    other = sorted(set(n for n, _ in events if kernel not in n))
    if other or not 0 < len(events) <= calls:
        raise AssertionError(f"{what}: {calls} calls ran {len(events)} device"
                             f" events, {other or 'all ' + kernel}; want one "
                             f"{kernel} a call and nothing else")
    ms = sorted(t for _, t in events)
    return ms[len(ms) // 2], len(events)


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


# ---------------------------------------------------------------------------
# the whole-fit k-means kernels (kmeans_fit, kmeans_fit_segmented)
# ---------------------------------------------------------------------------
def bits_equal(a, b) -> bool:
    """Two floating tensors of one type equal bit for bit (the sign of zero
    included)."""
    import torch
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(it), b.contiguous().view(it))


def masked_case(b, n, d, rng, dev, k=4, empty=False, dead_row=None):
    """Masked rows like the LERN fit's: L1-normalized small-integer
    histograms at D > 1 (exact distance ties), min-max normalized log
    counts at D = 1 (many equal rows); ragged valid counts, zero masked
    rows; starting centres drawn from the unit cube.  ``empty`` moves the
    last centre out of reach of every row (a cluster forced empty in the
    first sweep); ``dead_row`` masks that batch row wholly."""
    import numpy as np
    import torch
    x = np.zeros((b, n, d), np.float32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        nv = 0 if i == dead_row else max(1, n - 37 * i)
        if d > 1:
            raw = rng.integers(0, 5, (nv, d)).astype(np.float32)
            v = raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)
        elif nv:
            v = np.log1p(rng.integers(2, 400, (nv, 1))).astype(np.float32)
            v = (v - v.min()) / max(float(v.max() - v.min()), 1e-9)
        else:
            v = np.zeros((0, 1), np.float32)
        x[i, :nv] = v
        mask[i, :nv] = True
    c0 = rng.random((b, k, d)).astype(np.float32)
    if empty:
        c0[:, -1] = 5.0
    return tuple(torch.as_tensor(t, device=dev) for t in (x, mask, c0))


def masked_inertia(x, mask, centers, a):
    """``kmeans_fit_batched``'s inertia of a fit."""
    import torch
    from repro_torch.kernels.common import dot_fma
    diff = x - torch.gather(centers, 1, a.to(torch.int64)[:, :, None]
                            .expand(-1, -1, x.shape[2]))
    return (dot_fma(diff, diff) * mask.to(x.dtype)).sum(1)


def fit_masked_both(kops, x, mask, c0, iters):
    """The fit through the kernels (``fit_masked`` then ``assign``) and
    through the plain versions: (centres, assignments, inertia) each."""
    out = []
    for fit, assign in ((kops.fit_masked, kops.assign),
                        (kops.fit_masked_plain, kops.assign_plain)):
        c = fit(x, mask, c0, iters)
        a = assign(x, c)
        out.append((c, a, masked_inertia(x, mask, c, a)))
    return out


def hold_fit_masked(got, want, what) -> None:
    """A fit kernel's (centres, assignments, inertia) against the plain
    fit's, bitwise."""
    import torch
    torch.cuda.synchronize()
    (ck, ak, ik), (cp, ap, ip) = got, want
    if not (bits_equal(ck, cp) and torch.equal(ak, ap)
            and bits_equal(ik, ip)):
        raise AssertionError(
            f"kmeans_fit kernel != plain fit ({what}): centres max |diff| "
            f"{float((ck - cp).abs().max()):.3g} (bitwise "
            f"{bits_equal(ck, cp)}), {int((ak != ap).sum())} assignments "
            f"differ, inertia bitwise {bits_equal(ik, ip)}")


def segmented_fit_case(sizes, d, k, rng, dev, lattice=False, empty=False):
    """The flat-segmented layout (``segment_layout``) of normal rows x 3
    (the test_kernels inputs) or of lattice rows (the exact distance
    ties of LERN's features), normal starting centres; ``empty`` moves
    each segment's last centre out of reach.  Returns x, seg, offsets,
    counts, centres."""
    import numpy as np
    import torch
    from repro_torch.core.kmeans import segment_layout
    off, total = segment_layout(sizes)
    s = len(sizes)
    x = np.zeros((total, d), np.float32)
    seg = np.full(total, s, np.int32)
    for i, n in enumerate(sizes):
        x[off[i]:off[i] + n] = (np.round(rng.random((n, d)) * 6) / 6
                                if lattice else rng.normal(size=(n, d)) * 3)
        seg[off[i]:off[i] + n] = i
    c0 = rng.normal(size=(s, k, d)).astype(np.float32)
    if empty:
        c0[:, -1] = 50.0
    return (torch.as_tensor(x, device=dev), torch.as_tensor(seg, device=dev),
            off, np.asarray(sizes, np.int32), torch.as_tensor(c0, device=dev))


def fit_segmented_both(kops, x, seg, off, cnt, c0, iters):
    """The segmented fit through the kernels (``fit_segmented`` then
    ``assign_segmented``) and through the plain versions: (centres,
    sweeps, converged, assignments) each."""
    out = []
    for fit, assign in ((kops.fit_segmented, kops.assign_segmented),
                        (kops.fit_segmented_plain,
                         kops.assign_segmented_plain)):
        c, sw, conv = fit(x, seg, off, cnt, c0, iters)
        out.append((c, sw, conv, assign(x, c, seg)))
    return out


def hold_fit_segmented(got, want, seg, what) -> dict:
    """A segmented fit kernel's (centres, sweeps, converged, assignments
    on the valid rows, n_iter) against the plain fit's, bitwise; returns
    the sweeps."""
    import torch
    torch.cuda.synchronize()
    (ck, sk, vk, ak), (cp, sp, vp, ap) = got, want
    valid = seg < ck.shape[0]
    ok = (bits_equal(ck, cp) and torch.equal(sk, sp) and torch.equal(vk, vp)
          and torch.equal(ak[valid], ap[valid])
          and int(sk.max()) == int(sp.max()))
    if not ok:
        raise AssertionError(
            f"kmeans_fit_segmented kernel != plain fit ({what}): centres "
            f"max |diff| {float((ck - cp).abs().max()):.3g} (bitwise "
            f"{bits_equal(ck, cp)}), sweeps {sk.tolist()} vs {sp.tolist()}, "
            f"converged {vk.tolist()} vs {vp.tolist()}, "
            f"{int((ak != ap)[valid].sum())} assignments differ")
    return {"sweeps": sk.tolist(), "converged": vk.tolist(),
            "n_iter": int(sk.max())}


def two_streams(run, cases) -> list:
    """``run`` on each case, every call on a stream of its own, all
    enqueued before any is waited for."""
    import torch
    main = torch.cuda.current_stream()
    outs = []
    for case in cases:
        st = torch.cuda.Stream()
        st.wait_stream(main)
        with torch.cuda.stream(st):
            outs.append(run(*case))
    torch.cuda.synchronize()
    return outs


def turns(fns: dict, reps: int) -> dict:
    """Median wall ms of each named function, called in turns (one of
    each, ``reps`` rounds after a warm-up round), every call ended by a
    device sync."""
    import torch
    times = {name: [] for name in fns}
    for rep in range(reps + 1):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rep:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: sorted(v)[len(v) // 2] for name, v in times.items()}


class PlainFits:
    """While active, the port's Lloyd fits take the plain fits (torch, on
    the card) in place of the whole-fit kernels: the route before them."""

    def __init__(self, kops):
        self.kops = kops

    def __enter__(self):
        self.saved = (self.kops.fit_masked, self.kops.fit_segmented)
        self.kops.fit_masked = self.kops.fit_masked_plain
        self.kops.fit_segmented = self.kops.fit_segmented_plain

    def __exit__(self, *exc):
        self.kops.fit_masked, self.kops.fit_segmented = self.saved


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def masked_chain(b, n, d) -> int:
    """The longest chain of dependent adds in one sweep's sums of the
    masked fit (``ops._lloyd_sums``'s order)."""
    if d > 1:
        blk = min(n, 256)
        nb = -(-n // blk)
        return (blk - 1) + int(nb * blk > n) + (nb - 1)
    if b > 1 or n < 64:
        return n - 1
    lanes = 32 if 512 <= n < 4096 else 8
    m = n // lanes * lanes
    return (m // lanes - 1) + (lanes // 8 - 1) + 3 + (n - m)


def segmented_chain(cnt, sweeps) -> int:
    """The longest chain of dependent adds over a segmented fit: each
    segment's sweeps times (7 in a block, its blocks, +0 if shorter than
    the longest)."""
    nbs = [-(-int(c) // 8) for c in cnt]
    width = max(max(nbs), 1)
    return max(int(sw) * (7 + max(nb - 1, 0) + int(nb < width))
               for nb, sw in zip(nbs, sweeps))


# (B, N, D, options) of the masked fit cases of phase 3b: the path's
# largest bucket at D = 4 and 1, the D = 1 branches of the sums' order for
# a batch of one (4 x 8 lanes, 8 lanes, in order), a fully masked row, a
# cluster forced empty at D = 4 and 1, and K = 5 at D = 6 (the kernel's
# instance for any K and D; the others are compiled for K = 4)
FIT_MASKED_CASES = ((2, 32768, 4, {}), (2, 32768, 1, {}), (1, 4000, 1, {}),
                    (1, 777, 1, {}), (1, 50, 1, {}),
                    (3, 777, 1, {"dead_row": 2}),
                    (2, 2048, 4, {"empty": True}),
                    (2, 2048, 1, {"empty": True}), (2, 1000, 6, {"k": 5}))
# (sizes, D, K, options) of the segmented fit cases: the test_kernels
# sizes (D = 8 and K = 6 take the kernel's instance for any K and D),
# lattice segments that settle at different sweeps, the same cut to 3
# sweeps (a segment reaches iters), a cluster forced empty
FIT_SEGMENTED_CASES = (([13, 8, 29], 4, 4, {}), ([100], 4, 4, {}),
                       ([8, 8, 8, 8], 8, 4, {}), ([5, 300, 11], 4, 6, {}),
                       ([40, 120, 17, 500, 3000, 9], 4, 4, {"lattice": True}),
                       ([40, 120, 17, 500, 3000, 9], 4, 4,
                        {"lattice": True, "iters": 3}),
                       ([100, 37], 4, 4, {"empty": True}))
FIT_ITERS = 50


def check_fits(kops, masked_args, segmented_args, dev, launches) -> list:
    """Phase 3b for the whole-fit kernels: each against its plain fit on
    the card, bitwise, at the FIT_*_CASES, on two streams at once, and at
    the shapes the paths handed them; there, the kernel and the plain fit
    (the route before it) timed in turns.  Returns their ``kernels``
    rows, with the chain floor beside the bound."""
    import numpy as np
    t0 = time.time()
    rng = np.random.default_rng(5)
    masked = []
    for b, n, d, kw in FIT_MASKED_CASES:
        case = masked_case(b, n, d, rng, dev, **kw)
        hold_fit_masked(*fit_masked_both(kops, *case, FIT_ITERS),
                        f"B={b} N={n} D={d} {kw}")
        masked.append(case)
    held = []
    segmented = []
    for sizes, d, k, kw in FIT_SEGMENTED_CASES:
        kw = dict(kw)
        iters = kw.pop("iters", FIT_ITERS)
        case = segmented_fit_case(sizes, d, k, rng, dev, **kw)
        held.append(hold_fit_segmented(
            *fit_segmented_both(kops, *case, iters), case[1],
            f"sizes={sizes} D={d} K={k} iters={iters} {kw}"))
        segmented.append(case)
    sweeps = [r["sweeps"] for r in held]
    cut = FIT_SEGMENTED_CASES[5][3]["iters"]
    if len(set(sweeps[4])) < 2 or not any(
            sw == cut and not cv
            for sw, cv in zip(sweeps[5], held[5]["converged"])):
        raise AssertionError(f"the segmented cases do not cover segments "
                             f"settling at different sweeps {sweeps[4]} and "
                             f"one stopped at iters = {cut} {held[5]}")
    pair = [masked[0], masked[7]]
    for case, got in zip(pair, two_streams(
            lambda x, m, c: kops.fit_masked(x, m, c, FIT_ITERS), pair)):
        c = kops.fit_masked_plain(*case, FIT_ITERS)
        if not bits_equal(got, c):
            raise AssertionError("kmeans_fit kernel != plain fit on two "
                                 "streams")
    pair = [segmented[4], segmented[6]]
    for case, got in zip(pair, two_streams(
            lambda *a: kops.fit_segmented(*a, FIT_ITERS), pair)):
        want = kops.fit_segmented_plain(*case, FIT_ITERS)
        if not all(bits_equal(g, w) if g.is_floating_point() else
                   bool((g == w).all()) for g, w in zip(got, want)):
            raise AssertionError("kmeans_fit_segmented kernel != plain fit "
                                 "on two streams")
    log(f"[kmeans_fit] kernel == plain fit (centres bitwise, final "
        f"assignments, inertia) at (B, N, D) = "
        f"{[c[:3] for c in FIT_MASKED_CASES]} (a row fully masked, a "
        f"cluster forced empty) and on two streams at once; "
        f"[kmeans_fit_segmented] kernel == plain fit (centres bitwise, "
        f"sweeps per segment, converged, final assignments, n_iter) on "
        f"{len(FIT_SEGMENTED_CASES)} cases, sweeps {sweeps}, and on two "
        f"streams; {time.time() - t0:.1f} s")

    clock = sm_clock_mhz()
    rows = []
    x, mask, c0, iters = masked_args
    got, want = fit_masked_both(kops, x, mask, c0, iters)
    hold_fit_masked(got, want, "phase 6 path shape")
    b, n, d = x.shape
    k = c0.shape[1]
    t = turns({"kernel": lambda: kops.fit_masked(x, mask, c0, iters),
               "plain": lambda: kops.fit_masked_plain(x, mask, c0, iters)},
              reps=3)
    ev = time_ms(lambda: kops.fit_masked(x, mask, c0, iters), 20, 2)
    rows.append(kernel_row(
        "kmeans_fit", "cuda", "src/repro_torch/csrc/kmeans_assign.cu",
        "src/repro/kernels/kmeans_assign/kernel.py:72", launches["kmeans_fit"],
        float((got[0] - want[0]).abs().max()), t["kernel"], t["plain"],
        iters * b * n * (4 * d + 1), iters * b * n * k * (4 * d + 3), None,
        {"B": b, "N": n, "D": d, "K": k, "iters": iters,
         "kernel_ms_events": ev}))
    rows[-1]["chain_floor_ms"] = (iters * masked_chain(b, n, d) * 4
                                  / (clock * 1e3))
    x, seg, off, cnt, c0, iters = segmented_args
    got, want = fit_segmented_both(kops, x, seg, off, cnt, c0, iters)
    r = hold_fit_segmented(got, want, seg, "phase 4 path shape")
    d = x.shape[1]
    k = c0.shape[1]
    runs = [-(-int(c) // 8) * 8 for c in cnt]
    swept = sum(sw * run for sw, run in zip(r["sweeps"], runs))
    t = turns({"kernel": lambda: kops.fit_segmented(x, seg, off, cnt, c0,
                                                    iters),
               "plain": lambda: kops.fit_segmented_plain(x, seg, off, cnt,
                                                         c0, iters)}, reps=3)
    ev = time_ms(lambda: kops.fit_segmented(x, seg, off, cnt, c0, iters),
                 20, 2)
    rows.append(kernel_row(
        "kmeans_fit_segmented", "cuda",
        "src/repro_torch/csrc/kmeans_assign_segmented.cu",
        "src/repro/kernels/kmeans_assign/kernel.py:39",
        launches["kmeans_fit_segmented"],
        float((got[0] - want[0]).abs().max()), t["kernel"], t["plain"],
        swept * (4 * d + 4), swept * k * (4 * d + 3), None,
        {"P": x.shape[0], "D": d, "S": len(runs), "K": k, "iters": iters,
         "sweeps": r["sweeps"], "kernel_ms_events": ev}))
    rows[-1]["chain_floor_ms"] = (segmented_chain(cnt, r["sweeps"]) * 4
                                  / (clock * 1e3))
    for kr in rows:
        log(f"[{kr['name']}] at path shape {kr['shape']}: whole fit "
            f"{kr['ms']:.4f} ms against the plain fit on the card "
            f"{kr['plain_ms']:.4f} ms (in turns); bound "
            f"{kr['bound_ms'] * 1e3:.3f} us ({kr['bound_by']}), chain floor "
            f"{kr['chain_floor_ms']:.4f} ms (4 cycles an add at "
            f"{clock:.0f} MHz); launches {kr['launches']}")
    return rows


# ---------------------------------------------------------------------------
# the LLC round loop (llc_rounds)
# ---------------------------------------------------------------------------
# phase 3d's six lanes: every accel mode, core bypass on and off, the shared
# predictor, and fig. 18's way masks
LLC_LANES = (
    dict(accel_mode=0),
    dict(accel_mode=1, core_bypass=True),
    dict(accel_mode=2, core_bypass=True, shared_predictor=True),
    dict(accel_mode=3, core_way_mask=0x00FF, accel_way_mask=0xFF00),
    dict(accel_mode=2, core_way_mask=0xFFFF, accel_way_mask=0x0003),
    dict(accel_mode=1, core_bypass=True, shared_predictor=True,
         core_way_mask=0x0F0F, accel_way_mask=0xF0F0),
)
# rounds of the chained chunks of one case (host buckets and the fused
# engine's capacities)
LLC_CHUNKS = (8, 32, 128)


def llc_events(rng, n_lanes, rounds, sets, n_tags=40, p0=0.9, decay=0.93):
    """Random [L, R, S] int32 (line, meta): set s's events are lines
    s + sets * j (j < n_tags, so sets overflow their 16 ways), present
    with a probability that decays with the round (as an epoch's rounds
    thin out); absent events are padding (line -1, meta 0)."""
    import numpy as np
    from repro_torch.core import llc
    shape = (n_lanes, rounds, sets)
    p = p0 * decay ** np.arange(rounds)[None, :, None]
    valid = rng.random(shape) < p
    line = (np.arange(sets)[None, None, :]
            + sets * rng.integers(0, n_tags, shape)).astype(np.int64)
    meta = llc.pack_meta(rng.random(shape) < 0.5, rng.random(shape) < 0.3,
                         rng.random(shape) < 0.5, rng.random(shape) < 0.1,
                         rng.random(shape) < 0.7, rng.integers(0, 8, shape))
    return (np.where(valid, line, -1).astype(np.int32),
            np.where(valid, meta, 0).astype(np.int32))


def llc_batch(sets, lanes, dev, ship=None, ways=16, sampler_shift=None):
    """(cfg, knobs, fresh stacked states) of a lane batch at ``sets``
    sets of ``ways`` ways, the lanes' knobs from ``lanes``."""
    import dataclasses
    from repro_torch.core import llc
    base = llc.LLCConfig(size_bytes=sets * 64 * ways, ways=ways)
    if ship is not None:
        base = dataclasses.replace(base, ship=ship)
    if sampler_shift is not None:
        base = dataclasses.replace(base, sampler_shift=sampler_shift)
    cfgs = [dataclasses.replace(base, **kw) for kw in lanes]
    return (cfgs[0], llc.lane_knobs(cfgs, dev),
            llc.stack_states(cfgs[0], len(cfgs), dev))


def llc_lanes(ways):
    """LLC_LANES with their 16-way masks repeated over ``ways`` ways (cut
    at 8 ways, where lane 3's accel mask 0xFF00 leaves no way allowed),
    and a lane whose accel events may use no way at all."""
    full = (1 << ways) - 1

    def widen(m):
        return (m | m << 16) & full

    lanes = [dict(kw, **{k: widen(v) for k, v in kw.items()
                         if k.endswith("_way_mask")}) for kw in LLC_LANES]
    return lanes + [dict(accel_mode=1, core_bypass=True, accel_way_mask=0)]


def clone_states(states):
    from repro_torch.core import llc
    return llc.LLCState(*(x.clone() for x in states))


def rounds_simple(rops, rkernel, cfg, knobs, states, line_b, meta_b,
                  n_rounds=None):
    """``ops.rounds`` through the first design (``llc_rounds_simple``, one
    CTA per lane): the state updated in place; (states, stats, percore).
    On no path; its launches are not counted."""
    from repro_torch.core import llc
    if isinstance(knobs, llc.LaneKnobs):
        knobs = rops.pack_knobs(knobs)
    n_lanes = line_b.shape[0]
    stats = line_b.new_empty((n_lanes, len(llc.STAT_NAMES)))
    percore = line_b.new_empty((n_lanes, llc.NUM_CORES, 2))
    ship = cfg.ship
    rkernel.launch_simple(
        line_b, meta_b, knobs, n_rounds, (states.tags, states.lru,
                                          states.owner, states.sig,
                                          states.reused),
        states.tick, states.shct_core, states.shct_accel, stats, percore,
        entries=ship.entries, sampler_shift=cfg.sampler_shift,
        region_lines=ship.region_lines, counter_max=ship.counter_max)
    return states, stats, percore


def hold_llc_rounds(rops, cfg, knobs, kst, pst, line, meta, what, *,
                    rkernel, sst, n_rounds=None, stream=None,
                    plain_knobs=None):
    """One chunk through the kernel (on ``kst``, in place; on ``stream``
    if given), through the plain loop (from ``pst``; ``plain_knobs``, the
    ``llc.LaneKnobs`` form, where ``knobs`` is the kernel's packed
    tensor) and through the first design (``rkernel``'s
    ``launch_simple``, on ``sst`` in place): state, stats and per-core
    counts bitwise.  Returns the next states (kernel, plain, simple)."""
    import torch
    if stream is None:
        kst, ks, kp = rops.rounds(cfg, knobs, kst, line, meta, n_rounds)
    else:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            kst, ks, kp = rops.rounds(cfg, knobs, kst, line, meta, n_rounds)
        torch.cuda.current_stream().wait_stream(stream)
    pst, ps, pp = rops.lanes_plain(cfg, knobs if plain_knobs is None
                                   else plain_knobs, pst, line, meta,
                                   n_rounds)
    sst, ss, sp = rounds_simple(rops, rkernel, cfg, knobs, sst, line, meta,
                                n_rounds)
    torch.cuda.synchronize()
    for name, ost, os_, op in (("plain", pst, ps, pp),
                               ("llc_rounds_simple", sst, ss, sp)):
        bad = [f for f, a, b in zip(kst._fields, kst, ost)
               if not torch.equal(a, b)]
        bad += [n for n, a, b in (("stats", ks, os_), ("percore", kp, op))
                if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"llc_rounds kernel != {name} at {what}: "
                                 f"{bad}")
    return kst, pst, sst


def llc_collision_events(sets, ways):
    """A chunk of ways + 1 rounds in which sampler sets 0 and sets / 2
    (in different CTAs of a cluster) post +1 and -1 on one SHCT entry in
    the same round: set 0 inserts line 0 in round 0 and hits it in the
    last round; set sets / 2 inserts line 1 (the same 32-line region, so
    the same signature) in round 0, then lines of other regions, and the
    last round's insert evicts line 1, never reused.  Returns (line,
    meta, entry): [1, R, S] int32 and the shared core-table entry; set to
    0 or counter_max before the chunk, it ends there (the deltas summed,
    then clipped), where adding and clipping them one by one would not."""
    import numpy as np
    import torch
    from repro_torch.core import llc, ship
    rounds = ways + 1
    line = np.full((1, rounds, sets), -1, dtype=np.int32)
    meta = np.zeros_like(line)
    half = sets // 2
    line[0, 0, 0], line[0, 0, half] = 0, 1
    for r in range(1, ways):
        line[0, r, half] = 64 * r
    line[0, ways, 0], line[0, ways, half] = 0, 64 * ways
    meta[line >= 0] = llc.M_VALID
    entry = int(ship.signature(torch.tensor([0]), ship.SHIP_DEFAULT)[0])
    return line, meta, entry


def check_llc_rounds(rops, rkernel, dev) -> dict:
    """Phase 3d: the kernel against its plain version and against the
    first design (``llc_rounds_simple``), bitwise, on seeded random
    epochs: chained chunks at 1024 and 2048 sets with the six lanes of
    LLC_LANES, SHIP_LARGE tables (device memory), rounds that are all
    padding, the fused engine's round count (n_rounds), one lane through
    ``rounds_one``, and a side stream; then the cluster design's edges: 8
    and 32 ways (with a lane whose accel events may use no way), 4096
    sets, every set a sampler with lines from a few regions (deltas from
    many CTAs on the same entries, the counters at both ends), +1 and -1
    on one entry from two CTAs in one round at 0 and at counter_max, and
    more lanes than the card holds clusters at once (waves).  Returns the
    number of chunks held and the cases' names."""
    import numpy as np
    import torch
    from repro_torch.core import llc
    from repro_torch.core.ship import SHIP_LARGE
    rng = np.random.default_rng(17)
    held, cases = 0, []

    def t(a):
        return torch.as_tensor(a, device=dev)

    for sets, ship, tag in ((1024, None, "1024 sets"),
                            (2048, None, "2048 sets"),
                            (1024, SHIP_LARGE, "1024 sets, SHIP_LARGE")):
        cfg, knobs, kst = llc_batch(sets, LLC_LANES, dev, ship)
        pst, sst = clone_states(kst), clone_states(kst)
        for r in LLC_CHUNKS:
            line, meta = llc_events(rng, len(LLC_LANES), r, sets)
            kst, pst, sst = hold_llc_rounds(
                rops, cfg, knobs, kst, pst, t(line), t(meta),
                f"{tag}, R={r}", rkernel=rkernel, sst=sst)
            held += 1
        pad_l = torch.full((len(LLC_LANES), 16, sets), -1, dtype=torch.int32,
                           device=dev)
        before = clone_states(kst)
        kst, pst, sst = hold_llc_rounds(
            rops, cfg, knobs, kst, pst, pad_l, torch.zeros_like(pad_l),
            f"{tag}, all padding", rkernel=rkernel, sst=sst)
        same = all(torch.equal(a, b) for f, a, b in zip(
            kst._fields, kst, before) if f != "tick")
        if not same or not torch.equal(kst.tick, before.tick + 16):
            raise AssertionError(f"llc_rounds: padding rounds changed the "
                                 f"state at {tag}")
        line, meta = llc_events(rng, len(LLC_LANES), 64, sets)
        n_r = t(rng.integers(0, 64, len(LLC_LANES)).astype(np.int32))
        kst, pst, sst = hold_llc_rounds(
            rops, cfg, knobs, kst, pst, t(line), t(meta),
            f"{tag}, n_rounds {n_r.tolist()}", n_rounds=n_r,
            rkernel=rkernel, sst=sst)
        line, meta = llc_events(rng, len(LLC_LANES), 32, sets)
        kst, pst, sst = hold_llc_rounds(
            rops, cfg, knobs, kst, pst, t(line), t(meta),
            f"{tag}, side stream", stream=torch.cuda.Stream(),
            rkernel=rkernel, sst=sst)
        held += 3
        cases.append(tag)
    for kw in LLC_LANES:
        cfg, _, _ = llc_batch(1024, [kw], dev)
        kst = llc.init_state(cfg, dev)
        pst, sst = clone_states(kst), clone_states(kst)
        one = llc.LLCState(*(x.unsqueeze(0) if x.dim() else x.view(1)
                             for x in sst))   # views: updates sst
        for r in (8, 64):
            line, meta = llc_events(rng, 1, r, 1024)
            kst, ks, kp = rops.rounds_one(cfg, kst, t(line[0]), t(meta[0]))
            pst, ps, pp = rops.epoch_plain(cfg, pst, t(line[0]), t(meta[0]))
            _, ss, sp = rounds_simple(rops, rkernel, cfg,
                                      rops.config_knobs(cfg, dev), one,
                                      t(line), t(meta))
            torch.cuda.synchronize()
            for name, ost, os_, op in (("plain", pst, ps, pp),
                                       ("llc_rounds_simple", sst, ss[0],
                                        sp[0])):
                if not (all(torch.equal(a, b) for a, b in zip(kst, ost))
                        and torch.equal(ks, os_) and torch.equal(kp, op)):
                    raise AssertionError(f"llc_rounds one lane {kw}, R={r}: "
                                         f"kernel != {name}")
            held += 1
    cases.append("one lane x 6 knobs")

    # the cluster design's edges
    for sets, ways, shift, tag in ((1024, 8, None, "8 ways"),
                                   (512, 32, None, "32 ways"),
                                   (4096, 16, None, "4096 sets"),
                                   (1024, 16, 0, "every set a sampler")):
        lanes = llc_lanes(ways)
        cfg, knobs, kst = llc_batch(sets, lanes, dev, ways=ways,
                                    sampler_shift=shift)
        pst, sst = clone_states(kst), clone_states(kst)
        # with every set a sampler, each round's deltas from all CTAs fall on
        # a few entries: 16 lines of one region (hits: the entry climbs to
        # counter_max), then 128 lines of four (evictions: down to 0)
        for r, pool, end in ((32, 16, cfg.ship.counter_max), (128, 128, 0)):
            if shift == 0:
                line, meta = llc_events(rng, len(lanes), r, sets, p0=1.0,
                                        decay=0.99)
                line = np.where(line >= 0, rng.integers(0, pool, line.shape),
                                -1).astype(np.int32)
            else:
                line, meta = llc_events(rng, len(lanes), r, sets,
                                        n_tags=3 * ways)
            kst, pst, sst = hold_llc_rounds(
                rops, cfg, knobs, kst, pst, t(line), t(meta),
                f"{tag}, R={r}", rkernel=rkernel, sst=sst)
            held += 1
            tabs = torch.cat([kst.shct_core, kst.shct_accel])
            if shift == 0 and not bool((tabs == end).any()):
                raise AssertionError(f"llc_rounds: the colliding deltas of "
                                     f"R={r} left no counter at {end}")
        cases.append(tag)
    cfg, knobs, st0 = llc_batch(1024, [{}], dev)
    cmax = cfg.ship.counter_max
    for init in (0, cmax):
        line, meta, entry = llc_collision_events(1024, cfg.ways)
        kst = clone_states(st0)
        kst.shct_core[0, entry] = init
        pst, sst = clone_states(kst), clone_states(kst)
        kst, pst, sst = hold_llc_rounds(
            rops, cfg, knobs, kst, pst, t(line), t(meta),
            f"+1 and -1 on entry {entry} from sets 0 and 512 at {init}",
            rkernel=rkernel, sst=sst)
        if int(kst.shct_core[0, entry]) != init:
            raise AssertionError(f"llc_rounds: +1 and -1 on one entry at "
                                 f"{init} ended at "
                                 f"{int(kst.shct_core[0, entry])}")
        held += 1
    cases.append("+1/-1 on one entry from two CTAs at 0 and counter_max")
    shape = rkernel.cluster_shape(1024, 16, cfg.ship.entries,
                                  cfg.sampler_shift)
    n_lanes = 132 // shape["cluster"] + 12
    lanes = [LLC_LANES[i % len(LLC_LANES)] for i in range(n_lanes)]
    cfg, knobs, kst = llc_batch(1024, lanes, dev)
    pst, sst = clone_states(kst), clone_states(kst)
    for r in (32, 64):
        line, meta = llc_events(rng, n_lanes, r, 1024)
        kst, pst, sst = hold_llc_rounds(
            rops, cfg, knobs, kst, pst, t(line), t(meta),
            f"{n_lanes} lanes, R={r}", rkernel=rkernel, sst=sst)
        held += 1
    cases.append(f"{n_lanes} lanes of {shape['cluster']} CTAs (waves: "
                 f"{shape['active_clusters']} clusters at once)")
    return {"held": held, "cases": cases}


def llc_ptxas(report: str) -> dict:
    """The ``-Xptxas -v`` report of ``llc_rounds.cu``, per kernel:
    registers, stack frame and spills."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            k = re.search(r"llc_rounds_cluster_kernelILb([01])ELi(\d)E", name)
            name = (f"cluster kernel (SHCT in "
                    f"{'shared' if k.group(1) == '1' else 'device'} memory, "
                    f"stage {k.group(2)})" if k else
                    "simple kernel" if "llc_rounds_simple_kernel" in name
                    else None)
            continue
        if name and ("stack frame" in ln or "registers" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":")[-1].strip()
                         ).strip()
    return out


def llc_bound(cfg, n_lanes, rounds, clock_mhz) -> tuple:
    """(bytes, chain floor in ms) of one chunk: the events read once, the
    state and both SHCT tables read and written once, stats and per-core
    counts written; the floor is R dependent rounds, each at least a tag
    search and an LRU search over the W ways and ~10 more dependent
    integer operations (hash, SHCT read, selects) at 4 cycles each."""
    s, w, t = cfg.num_sets, cfg.ways, cfg.ship.entries
    n_bytes = (2 * 4 * n_lanes * rounds * s
               + 2 * n_lanes * s * w * (4 * 4 + 1)
               + 2 * 2 * 4 * n_lanes * t + 4 * n_lanes * (10 + 16 + 1))
    chain = rounds * (2 * w + 10) * 4 / (clock_mhz * 1e3)
    return n_bytes, chain


class RoundsCapture:
    """Wraps ``llc_rounds.ops.rounds`` where the port calls it and keeps a
    copy of the call with the most lane-rounds (state cloned before the
    launch), the calls and the lane-round count; the wrapper's own launch
    count is untouched."""

    def __init__(self, rops):
        self.rops, self.fn = rops, rops.rounds
        self.args, self.calls, self.rounds, self.size = None, 0, 0, -1
        rops.rounds = self

    def __call__(self, cfg, knobs, states, line_b, meta_b, n_rounds=None,
                 **kw):
        self.calls += 1
        self.rounds += line_b.shape[1]
        if line_b.numel() > self.size:
            self.size = line_b.numel()
            self.args = (cfg, knobs, clone_states(states), line_b.clone(),
                         meta_b.clone(),
                         None if n_rounds is None else n_rounds.clone())
        return self.fn(cfg, knobs, states, line_b, meta_b, n_rounds, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def restore(self):
        self.rops.rounds = self.fn


class SyncChecked:
    """Wraps ``fused._superstep`` where ``drive_lanes_fused`` calls it (or
    ``fused._superstep_bucket``, ``drive_lanes_bucketed``'s): each
    super-step's device work runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (an operation that waits
    for the card raises); the engine's one read per super-step comes after
    the call, outside it."""

    def __init__(self, fused, name: str = "_superstep"):
        self.fused, self.name = fused, name
        self.fn = getattr(fused, name)
        self.calls = 0
        self.seconds = 0.0      # host seconds in the calls: the enqueue
        setattr(fused, name, self)

    def __call__(self, *args, **kw):
        import torch
        self.calls += 1
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.seconds += time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode(0)

    def restore(self):
        setattr(self.fused, self.name, self.fn)


def llc_shaped(rkernel, cfg, knobs, st, line, meta, n_r, stage,
               cluster=0, threads=0):
    """One launch of the cluster kernel at ``stage`` (-1 empty, 0 its
    cluster barriers only, 1 + events, 2 + row search, 3 all) and shape on
    ``st`` (a scratch copy: stages below 3 leave no result); not
    counted."""
    from repro_torch.core import llc
    n_lanes = line.shape[0]
    stats = line.new_empty((n_lanes, len(llc.STAT_NAMES)))
    percore = line.new_empty((n_lanes, llc.NUM_CORES, 2))
    ship = cfg.ship
    rkernel.launch_shaped(
        line, meta, knobs, n_r, (st.tags, st.lru, st.owner, st.sig,
                                 st.reused),
        st.tick, st.shct_core, st.shct_accel, stats, percore,
        entries=ship.entries, sampler_shift=cfg.sampler_shift,
        region_lines=ship.region_lines, counter_max=ship.counter_max,
        cluster=cluster, threads=threads, stage=stage)


def time_llc_rounds(rops, rkernel, args, dev, clock) -> dict:
    """Both designs held bitwise (against the plain loop) and timed at a
    path's captured chunk: CUDA events around a wrapper call (``time_ms``)
    of the cluster kernel and of the first design, the two and the plain
    loop in turns (wall, synced), the empty launch of each design, the
    barrier floor (the cluster kernel's stage 0: the cluster barriers it
    takes on the chunk, the rounds with a sampler event, and nothing
    else), bytes and chain floor."""
    from repro_torch.core import llc
    cfg, knobs, st, line, meta, n_r = args
    n_lanes, rounds, sets = line.shape
    plain_knobs = knobs if isinstance(knobs, llc.LaneKnobs) else \
        llc.lane_knobs([cfg], dev)
    if plain_knobs.core_ways.shape[0] != n_lanes:
        raise AssertionError("llc_rounds capture: knobs of another batch")
    hold_llc_rounds(rops, cfg, knobs, clone_states(st), clone_states(st),
                    line, meta, "the path's input", n_rounds=n_r,
                    plain_knobs=plain_knobs, rkernel=rkernel,
                    sst=clone_states(st))
    packed = rops.pack_knobs(knobs) if isinstance(knobs, llc.LaneKnobs) \
        else knobs
    work, work_s, scratch = (clone_states(st) for _ in range(3))

    def cluster():
        rops.rounds(cfg, packed, work, line, meta, n_r)

    def simple():
        rounds_simple(rops, rkernel, cfg, packed, work_s, line, meta, n_r)

    t = turns({"cluster": cluster, "simple": simple,
               "plain": lambda: rops.lanes_plain(cfg, plain_knobs, st, line,
                                                 meta, n_r)}, reps=3)
    ms = time_ms(cluster, reps=20)
    simple_ms = time_ms(simple, reps=20)
    queued = {"cluster": queued_ms(cluster), "simple": queued_ms(simple)}
    empty = time_ms(lambda: llc_shaped(rkernel, cfg, packed, scratch, line,
                                       meta, n_r, -1), reps=20)
    barriers = time_ms(lambda: llc_shaped(rkernel, cfg, packed, scratch,
                                          line, meta, n_r, 0), reps=20)
    simple_empty = time_ms(lambda: rkernel.launch_empty(n_lanes, sets, dev),
                           reps=20)
    r_eff = rounds if n_r is None else min(int(n_r.max()), rounds)
    n_bytes, chain = llc_bound(cfg, n_lanes, r_eff, clock)
    return {"ms": ms, "simple_ms": simple_ms,
            "queued_ms": queued["cluster"],
            "simple_queued_ms": queued["simple"],
            "turn_ms": t["cluster"], "simple_turn_ms": t["simple"],
            "plain_ms": t["plain"], "empty_ms": empty,
            "simple_empty_ms": simple_empty, "barrier_ms": barriers,
            "bytes": n_bytes, "chain_ms": chain,
            "cluster": rkernel.cluster_shape(sets, cfg.ways,
                                             cfg.ship.entries,
                                             cfg.sampler_shift, rounds),
            "shape": {"L": n_lanes, "R": r_eff, "S": sets, "W": cfg.ways,
                      "T": cfg.ship.entries}}


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
               n_bytes, n_ops, library_ms, shape, peak=FP32_FLOPS) -> dict:
    bound_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_ops / peak * 1e3
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": library_ms, "shape": shape}


# ---------------------------------------------------------------------------
# the serving slice: flash attention, prefill, the golden model, the engine
# ---------------------------------------------------------------------------
def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def flash_inputs(b, s, h, hkv, d, dtype, dev, seed=42, sk=None):
    """tests/test_kernels.py's flash inputs: normal q [B, S, H, d], k, v
    [B, Sk, Hkv, d] (Sk = S unless given) from ``default_rng(seed)``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return tuple(torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
                 .to(dtype).to(dev) for shape in
                 ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def flash_build_report(report: str) -> dict:
    """The ``-Xptxas -v`` lines of the Hopper flash kernel, by head size."""
    out, d = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            hit = re.search(r"flash_fwd_sm90ILi(\d+)", m.group(1))
            d = int(hit.group(1)) if hit else None
        elif d is not None and ("registers" in ln or "spill" in ln):
            out.setdefault(d, []).append(ln.replace("ptxas info    :", "")
                                         .strip())
    return out


def hgmma_counts(lib: str) -> dict:
    """HGMMA instructions in the SASS of each Hopper flash kernel of the
    built library, by where the A operand comes from: shared memory (S = Q
    K^T) or registers (O += P V)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, d = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            hit = re.search(r"flash_fwd_sm90ILi(\d+)", m.group(1))
            d = int(hit.group(1)) if hit else None
            continue
        m = re.search(r"HGMMA\.\S+\s+R\d+,\s*(\S+)", ln)
        if m and d is not None:
            kind = "smem" if m.group(1).startswith("gdesc") else "regs"
            out.setdefault(d, {"smem": 0, "regs": 0})[kind] += 1
    return out


def check_flash(fops, q, k, v, causal, what) -> float:
    """The kernel against its plain version: atol 2e-5 in f32, 2e-2 in
    bf16 (the tests/test_kernels.py bars)."""
    import torch
    atol = 2e-5 if q.dtype == torch.float32 else 2e-2
    a = fops.mha(q, k, v, causal=causal)
    b = fops.mha_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = float((a.float() - b.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"flash_attention kernel != plain ({what}): "
                             f"max |diff| {err} > {atol}")
    return err


def flash_diff(got, want) -> dict:
    """A bf16 kernel output against the plain version's, per element: max
    |diff|, the most bf16 ulps of |want| it spans, and the atol it needs
    beside FLASH_RTOL x |want| (the caller holds that to FLASH_ATOL)."""
    import torch
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    ulp = torch.exp2((torch.frexp(b).exponent - 8).float())
    return {"err": float(diff.max()), "ulps": float((diff / ulp).max()),
            "atol_needed": max(0.0, float((diff - FLASH_RTOL * b.abs())
                                          .max()))}


def hold_flash(r, what) -> None:
    if not r["atol_needed"] <= FLASH_ATOL:
        raise AssertionError(
            f"flash_attention kernel != plain ({what}, bf16): |diff| exceeds "
            f"{FLASH_RTOL:.4g} x |plain| by up to {r['atol_needed']:.4g} > "
            f"{FLASH_ATOL:.4g} (max |diff| {r['err']:.4g}, {r['ulps']:.3g} "
            f"ulps)")


def check_flash_path(fops, q, k, v, what) -> dict:
    """The kernel against its plain version at a qwen3 shape, causal: in
    bf16 per element (``flash_diff``, within FLASH_RTOL x |plain| +
    FLASH_ATOL), and the f32 instance on the same inputs within 2e-5.
    Returns the readings, with the mean |plain| over the later half of the
    rows and the f32 max |diff|."""
    import torch
    want = fops.mha_plain(q, k, v, causal=True)
    out = flash_diff(fops.mha(q, k, v, causal=True), want)
    out["late_mean"] = float(want[:, q.shape[1] // 2:].float().abs().mean())
    hold_flash(out, what)
    del want
    qf, kf, vf = (t.float() for t in (q, k, v))
    out["err_f32"] = float((fops.mha(qf, kf, vf, causal=True)
                            - fops.mha_plain(qf, kf, vf, causal=True))
                           .abs().max())
    torch.cuda.synchronize()
    if not out["err_f32"] <= 2e-5:
        raise AssertionError(f"flash_attention kernel != plain ({what}, "
                             f"f32): max |diff| {out['err_f32']} > 2e-5")
    return out


def flash_readings(r) -> str:
    out = (f"max |diff| {r['err']:.4g} ({r['ulps']:.3g} bf16 ulps at most; "
           f"needs atol {r['atol_needed']:.4g} beside rtol {FLASH_RTOL:.4g},"
           f" bar {FLASH_ATOL:.4g}")
    if "late_mean" not in r:
        return out + ")"
    return (out + f"; mean |out| over the later half of the rows "
            f"{r['late_mean']:.4g}); f32 on the same inputs max |diff| "
            f"{r['err_f32']:.3g} (bar 2e-5)")


def flash_bound(b, s, h, hkv, d, elem=2):
    """(bytes, flops) of causal attention: q, k, v read once and o written
    once; 4 H d S^2 / 2 flops per batch row."""
    return (elem * b * s * d * (2 * h + 2 * hkv), 4 * b * h * d * s * s / 2)


def time_flash(fops, q, k, v, reps) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` (causal,
    GQA) on the same inputs, CUDA events, in ms."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return {"ms": time_ms(lambda: fops.mha(q, k, v, causal=True), reps, 2),
            "plain_ms": time_ms(lambda: fops.mha_plain(q, k, v, causal=True),
                                max(2, reps // 4), 1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps, 2)}


def gb(x) -> str:
    return "not measured" if x is None else f"{x:.2f} GB"


def logits_close(got, want, what, rtol: float = LOGIT_RTOL) -> float:
    """Two [B, V] logit arrays within ``rtol`` x max |want| (by default the
    model-level tolerance), and equal argmax; returns max |diff| / max
    |want|."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if rel > rtol:
        raise AssertionError(f"{what}: max |diff| {rel:.4g} x max|logit| > "
                             f"{rtol:.4g}")
    if not np.array_equal(got.argmax(-1), want.argmax(-1)):
        top2 = np.sort(want, -1)[:, -2:]
        raise AssertionError(
            f"{what}: argmax {got.argmax(-1)} != {want.argmax(-1)} (max "
            f"|diff| {rel:.4g} x max|logit|; the reference rows' top-two "
            f"gaps {(top2[:, 1] - top2[:, 0]).tolist()})")
    return rel


def prefill(cfg, params, b, s, dev, seed=0, extra=None) -> dict:
    """Last-token logits of the prefill routes at [B, S] (seeded tokens
    on the card, and the batch entries ``extra``), timed: the flash route
    through the kernel; the same route
    with ``mha_plain`` in the kernel's place, where each layer's kernel
    output on the same q, k, v is held to ``mha_plain``'s per element
    (``flash_diff``); and the other route (chunked from 8192 tokens on, else dense).
    The caller holds the logits to each other (``logits_close``)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.train import make_prefill_step
    gen = torch.Generator(dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev), **(extra or {})}
    out = {}
    kernel = fops.mha
    layers = []

    def held(q, k, v, causal=True):
        want = fops.mha_plain(q, k, v, causal=causal)
        layers.append(flash_diff(kernel(q, k, v, causal=causal), want))
        return want

    # the wrapper counts through its module-level name, which is ``held``
    # in that route: its comparison launches land here, not on the counts
    held.launches = 0
    held.kernel_launches = dict.fromkeys(fops.KERNELS, 0)

    for route, flash, attn in (("flash", True, kernel),
                               ("flash_plain", True, held),
                               ("plain", False, kernel)):
        step = make_prefill_step(cfg, use_flash=flash)
        n0 = kernel.launches
        fops.mha = attn
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        try:
            logits = step(params, batch)
            sync(dev)
        finally:
            fops.mha = kernel
        wall = time.perf_counter() - t0
        out[route] = {
            "logits": logits[:, 0].float().cpu().numpy(), "wall_s": wall,
            "tok_per_s": b * s / wall, "flash_launches":
                kernel.launches - n0,
            "max_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if torch.device(dev).type == "cuda" else None)}
    out["held"] = {"layers": held.launches, **{
        key: max(r[key] for r in layers) for key in layers[0]}}
    out["held"]["worst_layer"] = max(range(len(layers)),
                                     key=lambda i: layers[i]["atol_needed"])
    return out


def check_lm_golden(golden: dict, dev, tree=None) -> dict:
    """Phase 8g: qwen3-1.7b at full width with the golden's depth on
    ``convert.lm_numpy_params`` -- both prefill routes and the decode
    steps held to the JAX package's logits (its flash route) with the
    model-level tolerance."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = golden_config(golden)
    t0 = time.perf_counter()
    params = convert.lm_params_from_numpy(
        golden_tree(golden) if tree is None else tree, cfg, dev)
    t_weights = time.perf_counter() - t0
    rng = np.random.default_rng(golden["seed"])
    tokens = rng.integers(0, cfg.vocab, (golden["batch"], golden["seq"]))
    if rng.integers(0, cfg.vocab, golden["n_sampled"]).tolist() != \
            golden["sample_idx"]:
        raise AssertionError("8g: the seeded inputs differ from the golden's")
    tok = torch.as_tensor(tokens, device=dev)
    want = golden["prefill"]["flash"]
    scale = max(want["max_abs"])
    idx = np.asarray(golden["sample_idx"])
    top = np.asarray(want["top8_idx"])
    worst = 0.0

    def close(got, ref, what):
        nonlocal worst
        err = float(np.abs(np.asarray(got, np.float64)
                           - np.asarray(ref, np.float64)).max()) / scale
        worst = max(worst, err)
        if not err <= LOGIT_RTOL:
            raise AssertionError(f"8g {what}: max |diff| {err:.4g} x "
                                 f"max|logit| > {LOGIT_RTOL:.4g}")

    for route, flash in (("flash", True), ("plain", False)):
        lg = make_prefill_step(cfg, use_flash=flash)(
            params, {"tokens": tok})[:, 0].double().cpu().numpy()
        close(lg[:, idx], want["sampled"], f"{route} sampled logits")
        close(np.take_along_axis(lg, top, -1), want["top8_val"],
              f"{route} top-8 logits")
        lse = lg.max(-1) + np.log(np.exp(lg - lg.max(-1, keepdims=True))
                                  .sum(-1))
        close(lse, want["lse"], f"{route} logsumexp")
        if lg.argmax(-1).tolist() != top[:, 0].tolist():
            raise AssertionError(f"8g {route}: argmax {lg.argmax(-1)} != "
                                 f"golden {top[:, 0]}")
    dec = golden["decode"]
    state = lm.init_decode_state(params, cfg, golden["batch"],
                                 golden["decode_s_max"])
    step = make_serve_step(cfg)
    for t in range(golden["decode_steps"]):
        lg, state = step(params, state, tok[:, t:t + 1])
        lg = lg[:, 0].double().cpu().numpy()
        lse = lg.max(-1) + np.log(np.exp(lg - lg.max(-1, keepdims=True))
                                  .sum(-1))
        scale = max(dec["max_abs"][t])
        close(lse, dec["lse"][t], f"decode step {t} logsumexp")
        if lg.argmax(-1).tolist() != dec["argmax"][t]:
            raise AssertionError(f"8g decode step {t}: argmax "
                                 f"{lg.argmax(-1)} != {dec['argmax'][t]}")
    return {"weights_s": t_weights, "worst_rel": worst}


def run_engine(cfg, params, golden_serve: dict, dev) -> dict:
    """Phase 9: ``SessionProfile.fit`` on the golden's seeded sessions,
    then ``ServeEngine`` with the ``HydraKVScheduler`` on the launcher's
    requests; the stats must equal the golden's."""
    import numpy as np
    from repro_torch.serve import (HydraKVScheduler, Request,
                                   SchedulerKnobs, ServeEngine,
                                   SessionProfile)
    g = golden_serve
    profile = SessionProfile.fit(np.asarray(g["session_turns"]),
                                 np.asarray(g["session_gaps"]),
                                 seed=g["profile_seed"], device=dev)
    for f in ("rc_centers", "ri_centers"):
        got, ref = getattr(profile, f), np.asarray(g["profile"][f])
        if not np.allclose(got, ref, rtol=RTOL, atol=0):
            raise AssertionError(f"profile {f} {got} != golden {ref}")
    sched = HydraKVScheduler(
        SchedulerKnobs(token_budget=g["token_budget"],
                       deadline_tokens=g["deadline_tokens"]),
        profile=profile, device=dev)
    eng = ServeEngine(cfg, params, slots=g["slots"], s_max=g["s_max"],
                      scheduler=sched)
    step, steps = eng.step_fn, []

    def timed_step(*a):
        out = step(*a)
        steps.append(1)
        return out

    eng.step_fn = timed_step
    sync(dev)
    t0 = time.perf_counter()
    stats = eng.run([Request(**r) for r in g["requests"]],
                    max_steps=g["max_steps"])
    sync(dev)
    wall = time.perf_counter() - t0
    stats = json.loads(json.dumps(stats))
    if stats != g["stats"]:
        raise AssertionError(f"engine stats {stats} != golden {g['stats']}")
    tokens = sum(r["max_new"] for r in g["requests"])
    return {"stats": stats, "wall_s": wall, "steps": len(steps),
            "ms_per_step": wall / max(len(steps), 1) * 1e3,
            "tok_per_s": tokens / wall, "clock": eng.clock,
            "profile": profile_decode(eng, dev)}


# ---------------------------------------------------------------------------
# phase 14: the moe and ssm families on the card
MOE_GOLDEN = os.path.join(GOLDEN_DIR, "qwen2_moe_a2_7b_w1_serve.json")
SSM_GOLDEN = os.path.join(GOLDEN_DIR, "rwkv6_1_6b_w2_serve.json")
# (B, S) of 14a's and 14b's prefill
MOE_PREFILL = (1, 4096)
SSM_PREFILL = (1, 2048)
# 14c's tree: a gradient of this arch's full-width leaf shapes, f32
COMPRESS_ARCH = "qwen3-1.7b"


def family_bar(golden: dict) -> float:
    """A family golden's bar: twice the JAX package's own gap between its
    attention routes, and at least the dense family's model-level bar."""
    return max(2 * golden["ref_gap"], LOGIT_RTOL)


def hold_digest(lg, want: dict, sample_idx, bar: float, what,
                values: bool = True) -> dict:
    """Last-token logits ``lg`` [B, V] against a golden digest, as phase
    8g holds them: the logsumexp and, with ``values`` (the prefill), the
    sampled logits and the golden's top-8 logits within ``bar`` x the
    golden's max |logit|.  The argmax must be the golden's, or (a near
    tie, counted) a golden top-8 entry within 2 x bar x max |logit| of the
    golden's top.  Returns the held gap and, apart, the largest gap of
    the sampled and top-8 logits."""
    import numpy as np
    lg = np.asarray(lg, np.float64)
    if not np.isfinite(lg).all():
        raise AssertionError(f"{what}: non-finite logits")
    scale = max(want["max_abs"])
    top = np.asarray(want["top8_idx"])
    lse = lg.max(-1) + np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1))

    def gap(got, ref):
        return float(np.abs(got - np.asarray(ref, np.float64)).max()) / scale

    vals = max(gap(lg[:, sample_idx], want["sampled"]),
               gap(np.take_along_axis(lg, top, -1), want["top8_val"]))
    err = max(gap(lse, want["lse"]), vals if values else 0.0)
    if not err <= bar:
        raise AssertionError(f"{what}: max |diff| {err:.4g} x max|logit| > "
                             f"{bar:.4g}")
    ties = 0
    for row, a in enumerate(lg.argmax(-1).tolist()):
        if a == top[row, 0]:
            continue
        row_vals = dict(zip(top[row].tolist(), want["top8_val"][row]))
        if a not in row_vals or \
                row_vals[top[row, 0]] - row_vals[a] > 2 * bar * scale:
            raise AssertionError(f"{what}: argmax {a} != golden "
                                 f"{top[row, 0]} (row {row}), no near tie")
        ties += 1
    return {"err": err, "values": vals, "ties": ties}


class RouterLog:
    """Wraps ``models.moe.dispatch`` and keeps each call's router choices
    (the top-k expert ids of every token, [B, S, k])."""

    def __init__(self, moe_mod):
        self.moe, self.fn, self.sel = moe_mod, moe_mod.dispatch, []
        moe_mod.dispatch = self

    def __call__(self, p, x, *, top_k, **kw):
        logits = x.float() @ p.router.float()
        self.sel.append(self.moe._top_k(logits, top_k)[1].cpu().numpy())
        return self.fn(p, x, top_k=top_k, **kw)

    def restore(self):
        self.moe.dispatch = self.fn


def flipped_rows(sel, rows: list, k: int, router_gap: float, what) -> set:
    """The batch rows whose last token took other experts than the
    golden's (``rows``: its recorded top router logits).  A row may flip
    only where each expert it took instead lies within 2 x ``router_gap``
    (the JAX package's own largest router-logit movement between its two
    attention routes) of the golden's k-th logit."""
    flipped = set()
    for b, row in enumerate(rows):
        got, want = set(sel[b, -1].tolist()), set(row["idx"][:k])
        if got == want:
            continue
        val = dict(zip(row["idx"], row["val"]))
        kth = row["val"][k - 1]
        for e in got - want:
            if e not in val or kth - val[e] > 2 * router_gap:
                raise AssertionError(
                    f"{what}: row {b} took expert {e} for "
                    f"{sorted(want - got)}, not within 2 x router_gap "
                    f"{router_gap:.4g} of the golden's k-th router logit")
        flipped.add(b)
    return flipped


def golden_embeds(golden: dict, cfg, dev) -> dict:
    """A vlm or encdec golden's frontend stand-ins
    (``convert.lm_numpy_embeds``) as bf16 tensors on ``dev``, checked
    against the digest the JAX child recorded; {} for the other
    families."""
    import numpy as np
    import torch
    from repro_torch import convert
    embeds = convert.lm_numpy_embeds(cfg, golden["batch"], golden["seed"])
    digest = {k: [float(v.astype(np.float64).sum()),
                  float(np.abs(v).astype(np.float64).sum())]
              for k, v in embeds.items()}
    if digest != golden.get("embeds_digest", {}):
        raise AssertionError(f"the seeded embeddings {digest} differ from "
                             f"the golden's {golden.get('embeds_digest')}")
    return {k: torch.as_tensor(v).to(dev, torch.bfloat16)
            for k, v in embeds.items()}


def golden_config(golden: dict):
    """A family golden's arch at full width with the golden's depth."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(golden["arch"]),
                               n_layers=golden["n_layers"])


def golden_tree(golden: dict) -> dict:
    """The golden's seeded numpy parameter tree (``convert.lm_numpy_params``;
    host work only: numpy's draws release the GIL, so a thread can make it
    while the card runs other work)."""
    from repro_torch import convert
    return convert.lm_numpy_params(golden_config(golden),
                                   seed=golden["seed"])


def check_family_golden(golden: dict, dev, tree=None) -> dict:
    """Phases 14g and 15g: an arch at full width with the golden's depth
    on ``convert.lm_numpy_params`` (and, for vlm and encdec, the seeded
    frontend embeddings, ``golden_embeds``) -- both prefill routes'
    last-token logits and the decode steps (encdec: after
    ``prime_encdec``) held to the JAX package's (its flash route) within
    ``family_bar``, the components and argmax as phase 8g holds them
    (``hold_digest``).  At one moe layer a token's logits follow from its
    own router choice: a row whose choice differs from the golden's
    (``flipped_rows``, a near tie of the router) is counted and not
    held.  ``tree``: the golden's parameter tree if made already
    (``golden_tree``)."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import lm, moe as moe_mod
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = golden_config(golden)
    t0 = time.perf_counter()
    params = convert.lm_params_from_numpy(
        golden_tree(golden) if tree is None else tree, cfg, dev)
    t_weights = time.perf_counter() - t0
    rng = np.random.default_rng(golden["seed"])
    tokens = rng.integers(0, cfg.vocab, (golden["batch"], golden["seq"]))
    if rng.integers(0, cfg.vocab, golden["n_sampled"]).tolist() != \
            golden["sample_idx"]:
        raise AssertionError(f"{golden['arch']} golden: the seeded inputs "
                             f"differ from the golden's")
    tok = torch.as_tensor(tokens, device=dev)
    extra = golden_embeds(golden, cfg, dev)
    idx = np.asarray(golden["sample_idx"])
    bar = family_bar(golden)
    router = RouterLog(moe_mod) if "router" in golden else None
    held, flips = [], 0

    def hold(lg, want, what, n_call, values=True):
        nonlocal flips
        lg = lg[:, 0].double().cpu().numpy()
        if router is not None:
            skip = flipped_rows(router.sel[-1], golden["router"][n_call],
                                cfg.top_k, golden["router_gap"], what)
            flips += len(skip)
            keep = [b for b in range(lg.shape[0]) if b not in skip]
            want = {k: [v[b] for b in keep] for k, v in want.items()}
            lg = lg[keep]
            if not keep:
                return
        held.append(hold_digest(lg, want, idx, bar, what, values))

    try:
        for route, flash in (("flash", True), ("plain", False)):
            lg = make_prefill_step(cfg, use_flash=flash)(
                params, {"tokens": tok, **extra})
            hold(lg, golden["prefill"]["flash"],
                 f"{golden['arch']} golden: {route} prefill", 0)
        n_prefill = len(held)
        state = lm.init_decode_state(params, cfg, golden["batch"],
                                     golden["decode_s_max"])
        if cfg.family == "encdec":
            with torch.inference_mode():
                state = lm.prime_encdec(params, cfg, extra["enc_embeds"],
                                        state)
        step = make_serve_step(cfg)
        for t, want in enumerate(golden["decode"]):
            lg, state = step(params, state, tok[:, t:t + 1])
            hold(lg, want, f"{golden['arch']} golden: decode step {t}",
                 t + 1, values=False)
    finally:
        if router is not None:
            router.restore()
    return {"weights_s": t_weights, "bar": bar,
            "worst_rel": max(h["err"] for h in held),
            "decode_values": max(h["values"] for h in held[n_prefill:]),
            "ties": sum(h["ties"] for h in held), "flips": flips}


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def serve_full(cfg, params, golden_serve: dict, dev) -> dict:
    """``run_engine`` on a full-width model, with its peak memory and the
    decode step's bound: every parameter read once at 3.35 TB/s."""
    import torch
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    eng = run_engine(cfg, params, golden_serve, dev)
    eng["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    eng["bound_ms"] = param_bytes(params) / HBM_BYTES_PER_S * 1e3
    return eng


def route_gap(a, b) -> float:
    import numpy as np
    return float(np.abs(a - b).max() / np.abs(b).max())


def run_moe_full(dev, fops, kops) -> dict:
    """14a: qwen2-moe-a2.7b at full width (24 layers, seeded weights on the
    card).  Prefill through ``make_prefill_step(use_flash=True)`` at
    ``MOE_PREFILL``: 24 flash launches, all on the Hopper kernel, each
    layer's kernel output held to ``mha_plain`` on the same q, k, v
    (``prefill``); the routes' logits are finite and their gaps printed
    (the router's top-k turns last-bit differences into other experts, so
    the golden, 14g, holds the numbers).  Then ``ServeEngine`` with the
    ``HydraKVScheduler`` on the launcher's requests: stats equal to the
    golden's, one ``kmeans_fit`` and one ``kmeans_assign`` launch."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    golden = json.load(open(MOE_GOLDEN))
    cfg = get_arch(golden["arch"])
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    sync(dev)
    out = {"init_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in params.parameters()),
           "param_gb": param_bytes(params) / 1e9,
           "heads": (cfg.n_heads, cfg.n_kv, cfg.d_head)}
    b, s = MOE_PREFILL
    # warm: the first calls of this model's GEMM shapes, off the counts
    from repro_torch.train import make_prefill_step
    make_prefill_step(cfg, use_flash=True)(params, {"tokens": torch.zeros(
        (b, 256), dtype=torch.int64, device=dev)})
    flash = fops.mha
    flash.launches = 0
    flash.kernel_launches = dict.fromkeys(fops.KERNELS, 0)
    r = prefill(cfg, params, b, s, dev)
    launches = tuple(r[k]["flash_launches"]
                     for k in ("flash", "flash_plain", "plain"))
    by_kernel = dict(flash.kernel_launches)
    if launches != (cfg.n_layers, 0, 0) or r["held"]["layers"] != \
            cfg.n_layers or by_kernel != {"wgmma": cfg.n_layers, "simt": 0}:
        raise AssertionError(f"14a prefill: flash launches {launches}, by "
                             f"kernel {by_kernel}, {r['held']['layers']} "
                             f"layers held; want {cfg.n_layers}, all on the "
                             f"Hopper kernel")
    hold_flash(r["held"], f"14a prefill, layer {r['held']['worst_layer']}")
    for k in ("flash", "flash_plain", "plain"):
        if not np.isfinite(r[k]["logits"]).all():
            raise AssertionError(f"14a {k} route: non-finite logits")
    out.update(prefill=r, launches=by_kernel,
               gap_kernel=route_gap(r["flash"]["logits"],
                                    r["flash_plain"]["logits"]),
               gap_dense=route_gap(r["flash"]["logits"],
                                   r["plain"]["logits"]))
    out["serve"] = serve_counted("14a", cfg, params, golden["serve"], fops,
                                 kops, dev)
    del params
    return out


def run_ssm_full(dev, fops, kops) -> dict:
    """14b: rwkv6-1.6b at full width (24 layers, seeded weights on the
    card): prefill at ``SSM_PREFILL`` (the time loop: a few torch ops a
    step and layer), finite logits, then ``ServeEngine`` with the
    ``HydraKVScheduler``, stats equal to the golden's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step
    golden = json.load(open(SSM_GOLDEN))
    cfg = get_arch(golden["arch"])
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    sync(dev)
    out = {"init_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in params.parameters()),
           "param_gb": param_bytes(params) / 1e9}
    b, s = SSM_PREFILL
    gen = torch.Generator(dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tok[:, :64]})            # warm: cuBLAS, allocator
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tok})
    sync(dev)
    wall = time.perf_counter() - t0
    if not np.isfinite(logits.float().cpu().numpy()).all():
        raise AssertionError("14b prefill: non-finite logits")
    out["prefill"] = {"wall_s": wall, "tok_per_s": b * s / wall,
                      "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                  if cuda else None)}
    out["serve"] = serve_counted("14b", cfg, params, golden["serve"], fops,
                                 kops, dev)
    del params
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_compress(dev) -> dict:
    """14c: ``quantize`` on the card bitwise its CPU result, then
    ``quantized_psum_tree`` over a world of one (NCCL on the card, gloo on
    the CPU) on an f32 tree of ``COMPRESS_ARCH``'s full-width leaf shapes,
    timed after one warm call: every element within 0.5 x scale of its
    input, plus the f32 roundings of the quotient and the product (2 x 127
    x 2^-24 x scale)."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.optim import compress
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((4096, 2048), generator=gen, device=dev) * 1e-3
    q, scale = compress.quantize(x)
    q_cpu, scale_cpu = compress.quantize(x.cpu())
    if not (torch.equal(q.cpu(), q_cpu)
            and torch.equal(scale.cpu(), scale_cpu)):
        raise AssertionError("14c: quantize on the card != on the CPU")
    cuda = torch.device(dev).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        layout = convert._dense_layout(get_arch(COMPRESS_ARCH))
        tree = convert._nest({
            path: torch.randn(shape, generator=gen, device=dev) * 1e-3
            for path, (shape, _) in layout.items()})
        compress.quantized_psum(x)       # the group's first collectives
        sync(dev)
        t0 = time.perf_counter()
        out = compress.quantized_psum_tree(tree)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    worst, n = 0.0, 0
    for path in layout:
        a, b = tree, out
        for key in path.split("/"):
            a, b = a[key], b[key]
        scale = torch.clamp(a.abs().max(), min=1e-12) / 127.0
        rel = float((b - a).abs().max() / scale)
        if not rel <= 0.5 + 2 * 127 * 2 ** -24:
            raise AssertionError(f"14c {path}: |psum - x| {rel:.6g} x scale")
        worst, n = max(worst, rel), n + a.numel()
    return {"wall_s": wall, "leaves": len(layout), "elements": n,
            "worst_rel": worst}


def run_phase14(dev, fops, kops) -> dict:
    """Phase 14, the moe and ssm families: 14a qwen2-moe-a2.7b and 14b
    rwkv6-1.6b at full width, 14g the two goldens (their numpy parameter
    trees made by a thread during 14a and 14b), 14c compression."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    t0 = time.time()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    goldens = [json.load(open(path)) for path in (MOE_GOLDEN, SSM_GOLDEN)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        trees = [pool.submit(golden_tree, golden) for golden in goldens]
        r = run_families14(dev, fops, kops, goldens, trees)
    r["compress"] = c = check_compress(dev)
    log(f"[compress] 14c quantize bitwise its CPU result; "
        f"quantized_psum_tree over a world of one ({c['leaves']} leaves, "
        f"{c['elements']:,} f32 elements of {COMPRESS_ARCH}'s full-width "
        f"shapes) {c['wall_s'] * 1e3:.1f} ms, worst |psum - x| "
        f"{c['worst_rel']:.6g} x scale")
    r["wall_s"] = time.time() - t0
    log(f"[families] phase 14: {r['wall_s']:.1f} s")
    return r


def run_families14(dev, fops, kops, goldens, trees) -> dict:
    """14a, 14b, then 14g on ``goldens`` with their trees (futures)."""
    r = {"moe": run_moe_full(dev, fops, kops)}
    m = r["moe"]
    p, sv = m["prefill"], m["serve"]
    b, s = MOE_PREFILL
    log(f"[moe] 14a qwen2-moe-a2.7b full width: {m['n_params']:,} "
        f"parameters ({m['param_gb']:.2f} GB) initialised on the card in "
        f"{m['init_s']:.1f} s; prefill B={b} S={s}: " + "; ".join(
            f"{name} {p[key]['wall_s']:.2f} s ({p[key]['tok_per_s']:,.0f} "
            f"tok/s, peak {gb(p[key]['max_mem_gb'])})" for key, name in
            (("flash", "flash route"),
             ("flash_plain", "flash with mha_plain"),
             ("plain", "dense route"))) + f"; flash launches {m['launches']}")
    log(f"[moe] 14a: the kernel on each of the {p['held']['layers']} "
        f"layers' q, k, v (H, Hkv, d = {m['heads']}): "
        f"{flash_readings(p['held'])} (worst layer "
        f"{p['held']['worst_layer']}); last-token logits finite, flash vs "
        f"the mha_plain forward {m['gap_kernel']:.4g} x max|logit|, vs the "
        f"dense route {m['gap_dense']:.4g} (printed, not held: the router "
        f"moves tokens to other experts on last-bit differences)")
    log(f"[moe] 14a ServeEngine: {sv['stats']['completed']} requests in "
        f"{sv['clock']} engine steps, {sv['steps']} decode steps in "
        f"{sv['wall_s']:.2f} s ({sv['ms_per_step']:.2f} ms a step against a "
        f"bound of {sv['bound_ms']:.2f} ms, every parameter read once on "
        f"the one-hot route; {sv['tok_per_s']:.1f} generated tok/s; peak "
        f"{gb(sv['peak_gb'])}); stats equal the golden; profiler: "
        f"{sv['profile'] or 'not measured'}; {nvidia_smi()}")
    r["ssm"] = m = run_ssm_full(dev, fops, kops)
    sv = m["serve"]
    b, s = SSM_PREFILL
    log(f"[ssm] 14b rwkv6-1.6b full width: {m['n_params']:,} parameters "
        f"({m['param_gb']:.2f} GB) in {m['init_s']:.1f} s; prefill B={b} "
        f"S={s} {m['prefill']['wall_s']:.2f} s "
        f"({m['prefill']['tok_per_s']:,.0f} tok/s, the time loop; peak "
        f"{gb(m['prefill']['peak_gb'])}); ServeEngine: "
        f"{sv['stats']['completed']} requests, {sv['steps']} decode steps "
        f"in {sv['wall_s']:.2f} s ({sv['ms_per_step']:.2f} ms a step, bound "
        f"{sv['bound_ms']:.3f} ms; {sv['tok_per_s']:.1f} generated tok/s; "
        f"peak {gb(sv['peak_gb'])}); stats equal the golden; profiler: "
        f"{sv['profile'] or 'not measured'}; {nvidia_smi()}")
    r["golden"] = {}
    for golden, tree in zip(goldens, trees):
        t1 = time.time()
        g = r["golden"][golden["arch"]] = check_family_golden(
            golden, dev, tree.result())
        log(f"[golden] 14g {golden['arch']} full width, "
            f"{golden['n_layers']} layers, B={golden['batch']} "
            f"S={golden['seq']}: both prefill routes and "
            f"{len(golden['decode'])} decode steps match the JAX logits "
            f"(worst {g['worst_rel']:.4g} x max|logit|, bar {g['bar']:.4g}; "
            f"argmax near ties {g['ties']}; rows on other experts than the "
            f"golden's, each a router near tie, not held: {g['flips']}; the "
            f"decode steps' sampled and "
            f"top-8 logits, not held, as in 8g: {g['decode_values']:.4g}); "
            f"weights onto the card {g['weights_s']:.1f} s (their numpy "
            f"tree made during 14a and 14b), {time.time() - t1:.1f} s")
    return r


# ---------------------------------------------------------------------------
# phase 15: the hybrid, encdec and vlm families on the card
HYBRID_GOLDEN = os.path.join(GOLDEN_DIR, "zamba2_2_7b_w2_serve.json")
ENCDEC_GOLDEN = os.path.join(GOLDEN_DIR, "whisper_base_serve.json")
VLM_GOLDEN = os.path.join(GOLDEN_DIR, "paligemma_3b_w1_serve.json")
# (B, tokens) of 15a's prefill, after paligemma's 256 patch positions; one
# of its layers' flash shape (B, S, H, Hkv, d), S = 256 + 3840
VLM_PREFILL = (1, 3840)
VLM_LAYER = (1, 4096, 8, 1, 256)
# (B, S) of 15b's and 15c's prefill (15c: decoder tokens over 1500 frames)
HYBRID_PREFILL = (1, 1024)
ENCDEC_PREFILL = (8, 448)


def full_model(arch: str, dev):
    """``arch`` at full width with seeded weights initialised on the card:
    (config, parameters, their count, size and init time)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    sync(dev)
    return cfg, params, {
        "init_s": time.perf_counter() - t0,
        "n_params": sum(p.numel() for p in params.parameters()),
        "param_gb": param_bytes(params) / 1e9}


def seeded_embeds(cfg, b: int, dev, seed: int = 0) -> dict:
    """The stubbed frontend's stand-ins (``convert.lm_numpy_embeds``) at
    batch ``b`` as bf16 tensors on ``dev``."""
    import torch
    from repro_torch import convert
    return {k: torch.as_tensor(v).to(dev, torch.bfloat16)
            for k, v in convert.lm_numpy_embeds(cfg, b, seed).items()}


def serve_counted(what: str, cfg, params, golden_serve: dict, fops, kops,
                  dev) -> dict:
    """``serve_full`` with every count at 0 before and read after: one
    ``kmeans_fit`` and one ``kmeans_assign`` launch (the profile fit), no
    segmented fit, no flash launch (decode never takes it)."""
    kops.assign.launches = kops.fit_masked.launches = fops.mha.launches = 0
    kops.fit_segmented.launches = kops.assign_segmented.launches = 0
    out = serve_full(cfg, params, golden_serve, dev)
    counts = (kops.fit_masked.launches, kops.assign.launches,
              kops.fit_segmented.launches, kops.assign_segmented.launches,
              fops.mha.launches)
    if counts != (1, 1, 0, 0, 0):
        raise AssertionError(f"{what} serving launched kmeans_fit, "
                             f"kmeans_assign, kmeans_fit_segmented, "
                             f"kmeans_assign_segmented, flash {counts}; "
                             f"want (1, 1, 0, 0, 0)")
    out["kmeans_fit"] = counts[0]
    return out


def run_vlm_full(dev, fops, kops) -> dict:
    """15a: paligemma-3b at full width (18 layers, H = 8, Hkv = 1, d =
    256).  Prefill through ``make_prefill_step`` at ``VLM_PREFILL`` tokens
    after 256 seeded patch positions: on the flash route 18 launches, all
    on the Hopper kernel at d = 256, each layer's output held to
    ``mha_plain`` on the same q, k, v per element (``prefill``); the
    routes' last-token logits finite, their gaps printed.  Then the
    ``ServeEngine`` with the ``HydraKVScheduler`` on the launcher's
    requests: stats equal to the golden's."""
    import numpy as np
    import torch
    from repro_torch.train import make_prefill_step
    golden = json.load(open(VLM_GOLDEN))
    cfg, params, out = full_model(golden["arch"], dev)
    b, s = VLM_PREFILL
    extra = seeded_embeds(cfg, b, dev)
    # warm: the first calls of this model's GEMM shapes, off the counts
    # (a whole number of 128-row blocks with the prefix)
    warm = 128 - cfg.prefix_len % 128
    make_prefill_step(cfg, use_flash=True)(params, {"tokens": torch.zeros(
        (b, warm), dtype=torch.int64, device=dev), **extra})
    flash = fops.mha
    flash.launches = 0
    flash.kernel_launches = dict.fromkeys(fops.KERNELS, 0)
    r = prefill(cfg, params, b, s, dev, extra=extra)
    launches = tuple(r[k]["flash_launches"]
                     for k in ("flash", "flash_plain", "plain"))
    by_kernel = dict(flash.kernel_launches)
    n = cfg.n_layers
    if launches != (n, 0, 0) or r["held"]["layers"] != n or \
            by_kernel != {"wgmma": n, "simt": 0}:
        raise AssertionError(f"15a prefill: flash launches {launches}, by "
                             f"kernel {by_kernel}, {r['held']['layers']} "
                             f"layers held; want {n}, all on the Hopper "
                             f"kernel")
    hold_flash(r["held"], f"15a prefill, layer {r['held']['worst_layer']}")
    for k in ("flash", "flash_plain", "plain"):
        if not np.isfinite(r[k]["logits"]).all():
            raise AssertionError(f"15a {k} route: non-finite logits")
    out.update(prefill=r, flash_launches=by_kernel["wgmma"],
               heads=(cfg.n_heads, cfg.n_kv, cfg.d_head),
               gap_kernel=route_gap(r["flash"]["logits"],
                                    r["flash_plain"]["logits"]),
               gap_dense=route_gap(r["flash"]["logits"],
                                   r["plain"]["logits"]))
    out["serve"] = serve_counted("15a", cfg, params, golden["serve"], fops,
                                 kops, dev)
    del params
    return out


def run_hybrid_full(dev, fops, kops) -> dict:
    """15b: zamba2-2.7b at full width (54 Mamba2 layers, the shared block
    9 times): prefill at ``HYBRID_PREFILL`` through
    ``make_prefill_step(use_flash=True)`` -- no flash launch, since the
    shared block passes its window (the dense route, as the JAX package
    routes it); the Mamba time loop is a few torch ops a step and layer --
    finite logits; then the ``ServeEngine``, stats equal to the golden's."""
    import numpy as np
    import torch
    from repro_torch.train import make_prefill_step
    golden = json.load(open(HYBRID_GOLDEN))
    cfg, params, out = full_model(golden["arch"], dev)
    b, s = HYBRID_PREFILL
    gen = torch.Generator(dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    step = make_prefill_step(cfg, use_flash=True)
    step(params, {"tokens": tok[:, :64]})            # warm: cuBLAS, allocator
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fops.mha.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tok})
    sync(dev)
    wall = time.perf_counter() - t0
    if fops.mha.launches != 0:
        raise AssertionError(f"15b prefill launched flash_attention "
                             f"{fops.mha.launches} times; the windowed "
                             f"shared block takes the dense route")
    if not np.isfinite(logits.float().cpu().numpy()).all():
        raise AssertionError("15b prefill: non-finite logits")
    out["groups"] = max(cfg.n_layers // cfg.attn_every, 1)
    out["prefill"] = {"wall_s": wall, "tok_per_s": b * s / wall,
                      "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                  if cuda else None)}
    out["serve"] = serve_counted("15b", cfg, params, golden["serve"], fops,
                                 kops, dev)
    del params
    return out


def run_encdec_full(dev, fops, kops) -> dict:
    """15c: whisper-base whole (6 encoder and 6 decoder layers) over
    ``enc_seq`` = 1500 seeded frames at ``ENCDEC_PREFILL``: ``encode``,
    ``prime_encdec`` (each layer's cross K/V in bf16) and a prefill of the
    decoder tokens, each timed, finite; no flash launch (the encoder is
    non-causal, the decoder's attention passes no ``use_flash``).  Then the
    ``ServeEngine``, unprimed as in the JAX package, stats equal to the
    golden's."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step
    golden = json.load(open(ENCDEC_GOLDEN))
    cfg, params, out = full_model(golden["arch"], dev)
    b, s = ENCDEC_PREFILL
    extra = seeded_embeds(cfg, b, dev)
    gen = torch.Generator(dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    step = make_prefill_step(cfg, use_flash=True)
    step(params, {"tokens": tok[:, :64], **extra})   # warm
    fops.mha.launches = 0
    walls = {}

    def timed(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = fn()
        sync(dev)
        walls[name] = time.perf_counter() - t0
        return res

    enc = timed("encode", lambda: lm.encode(params, cfg,
                                            extra["enc_embeds"]))
    state = timed("prime", lambda: lm.prime_encdec(
        params, cfg, extra["enc_embeds"],
        lm.init_decode_state(params, cfg, b, s)))
    logits = timed("prefill", lambda: step(params, {"tokens": tok, **extra}))
    if fops.mha.launches != 0:
        raise AssertionError(f"15c launched flash_attention "
                             f"{fops.mha.launches} times; want 0")
    xk, xv = state.extra
    want = (cfg.n_layers, b, cfg.enc_seq, cfg.n_kv, cfg.d_head)
    if tuple(xk.shape) != want or xk.dtype != torch.bfloat16:
        raise AssertionError(f"15c prime_encdec: {tuple(xk.shape)} "
                             f"{xk.dtype}, want {want} bf16")
    for name, t in (("encode", enc), ("cross K", xk), ("cross V", xv),
                    ("prefill logits", logits)):
        if not np.isfinite(t.float().cpu().numpy()).all():
            raise AssertionError(f"15c {name}: non-finite")
    out.update(walls=walls, enc_shape=tuple(enc.shape))
    del enc, state, xk, xv
    out["serve"] = serve_counted("15c", cfg, params, golden["serve"], fops,
                                 kops, dev)
    del params
    return out


def report_vlm(m: dict) -> None:
    p, sv = m["prefill"], m["serve"]
    b, s = VLM_PREFILL
    log(f"[vlm] 15a paligemma-3b full width: {m['n_params']:,} parameters "
        f"({m['param_gb']:.2f} GB) initialised on the card in "
        f"{m['init_s']:.1f} s; prefill B={b}, 256 patch positions + {s} "
        f"tokens: " + "; ".join(
            f"{name} {p[key]['wall_s']:.2f} s ({p[key]['tok_per_s']:,.0f} "
            f"tok/s, peak {gb(p[key]['max_mem_gb'])})" for key, name in
            (("flash", "flash route"),
             ("flash_plain", "flash with mha_plain"),
             ("plain", "dense route"))) + f"; flash launches by kernel "
        f"{ {'wgmma': m['flash_launches']} }")
    log(f"[vlm] 15a: the d = 256 kernel on each of the "
        f"{p['held']['layers']} layers' q, k, v (H, Hkv, d = {m['heads']}): "
        f"{flash_readings(p['held'])} (worst layer "
        f"{p['held']['worst_layer']}); last-token logits finite, flash vs "
        f"the mha_plain forward {m['gap_kernel']:.4g} x max|logit|, vs the "
        f"dense route {m['gap_dense']:.4g} (printed)")
    log(f"[vlm] 15a ServeEngine: {sv['stats']['completed']} requests in "
        f"{sv['clock']} engine steps, {sv['steps']} decode steps in "
        f"{sv['wall_s']:.2f} s ({sv['ms_per_step']:.2f} ms a step against a "
        f"bound of {sv['bound_ms']:.2f} ms, every parameter read once; "
        f"{sv['tok_per_s']:.1f} generated tok/s; peak {gb(sv['peak_gb'])}); "
        f"stats equal the golden; kmeans_fit launches {sv['kmeans_fit']}; "
        f"profiler: {sv['profile'] or 'not measured'}; {nvidia_smi()}")


def report_hybrid(m: dict) -> None:
    sv = m["serve"]
    b, s = HYBRID_PREFILL
    log(f"[hybrid] 15b zamba2-2.7b full width: {m['n_params']:,} "
        f"parameters ({m['param_gb']:.2f} GB), {m['groups']} groups, in "
        f"{m['init_s']:.1f} s; prefill B={b} S={s} "
        f"{m['prefill']['wall_s']:.2f} s ({m['prefill']['tok_per_s']:,.0f} "
        f"tok/s, the Mamba time loop; dense route, no flash launch; peak "
        f"{gb(m['prefill']['peak_gb'])}); ServeEngine: "
        f"{sv['stats']['completed']} requests, {sv['steps']} decode steps "
        f"in {sv['wall_s']:.2f} s ({sv['ms_per_step']:.2f} ms a step, bound "
        f"{sv['bound_ms']:.3f} ms; {sv['tok_per_s']:.1f} generated tok/s; "
        f"peak {gb(sv['peak_gb'])}); stats equal the golden; kmeans_fit "
        f"launches {sv['kmeans_fit']}; profiler: "
        f"{sv['profile'] or 'not measured'}; {nvidia_smi()}")


def report_encdec(m: dict) -> None:
    sv, w = m["serve"], m["walls"]
    b, s = ENCDEC_PREFILL
    log(f"[encdec] 15c whisper-base whole: {m['n_params']:,} parameters "
        f"({m['param_gb']:.3f} GB) in {m['init_s']:.1f} s; B={b}, "
        f"{m['enc_shape'][1]} frames: encode {w['encode'] * 1e3:.1f} ms (out "
        f"{m['enc_shape']}), prime_encdec {w['prime'] * 1e3:.1f} ms, prefill "
        f"of S={s} decoder tokens {w['prefill'] * 1e3:.1f} ms "
        f"({b * s / w['prefill']:,.0f} tok/s), all finite, no flash launch; "
        f"ServeEngine (unprimed): {sv['stats']['completed']} requests, "
        f"{sv['steps']} decode steps in {sv['wall_s']:.2f} s "
        f"({sv['ms_per_step']:.2f} ms a step, bound {sv['bound_ms']:.4f} "
        f"ms; peak {gb(sv['peak_gb'])}); stats equal the golden; kmeans_fit "
        f"launches {sv['kmeans_fit']}; profiler: "
        f"{sv['profile'] or 'not measured'}")


def report_golden(golden: dict, g: dict, t1: float) -> None:
    log(f"[golden] 15g {golden['arch']} full width, "
        f"{golden['n_layers']} layers, B={golden['batch']} "
        f"S={golden['seq']}: both prefill routes and "
        f"{len(golden['decode'])} decode steps match the JAX logits "
        f"(worst {g['worst_rel']:.4g} x max|logit|, bar {g['bar']:.4g}; "
        f"argmax near ties {g['ties']}; the decode steps' sampled and "
        f"top-8 logits, not held, as in 8g: {g['decode_values']:.4g}); "
        f"weights onto the card {g['weights_s']:.1f} s (their numpy tree "
        f"made during 15a-15c), {time.time() - t1:.1f} s")


# 15a-15c by family: the run, its report, its golden
PHASE15 = {"vlm": (run_vlm_full, report_vlm, VLM_GOLDEN),
           "hybrid": (run_hybrid_full, report_hybrid, HYBRID_GOLDEN),
           "encdec": (run_encdec_full, report_encdec, ENCDEC_GOLDEN)}


def run_phase15(dev, fops, kops, families=tuple(PHASE15)) -> dict:
    """Phase 15, the hybrid, encdec and vlm families: 15a paligemma-3b,
    15b zamba2-2.7b, 15c whisper-base at full width, then 15g their
    goldens (``families``: those of these to run).  A thread makes the
    goldens' numpy parameter trees (~27 s of host work at these widths)
    while 15a-15c run."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    t0 = time.time()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    r = {"golden": {}}
    goldens = {fam: json.load(open(PHASE15[fam][2])) for fam in families}
    with ThreadPoolExecutor(max_workers=1) as pool:
        trees = {fam: pool.submit(golden_tree, goldens[fam])
                 for fam in families}
        for fam in families:
            run, report, _ = PHASE15[fam]
            r[fam] = run(dev, fops, kops)
            report(r[fam])
        for fam in families:
            golden = goldens[fam]
            t1 = time.time()
            g = r["golden"][golden["arch"]] = check_family_golden(
                golden, dev, trees.pop(fam).result())
            report_golden(golden, g, t1)
    r["wall_s"] = time.time() - t0
    log(f"[families] phase 15: {r['wall_s']:.1f} s")
    return r


# ---------------------------------------------------------------------------
# phase 16: the sharding layer
# ---------------------------------------------------------------------------
# the dry-run's cells of 16a: (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", False),
                ("qwen3-1.7b", "decode_32k", True))
SHARDED = dict(batch=1, seq=4096)       # 16b's prefill and train steps
DRYRUN_TIMEOUT_S = 300


def start_dryrun(root: str) -> dict:
    """16a's dry-run cells, each in a child process of its own (the fake
    process group is process-wide), all started together; ``finish_dryrun``
    collects them."""
    out = os.path.join(root, "build", "chip_smoke_dryrun")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = {}
    for arch, shape, mp in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out]
        procs[(arch, shape, mp)] = subprocess.Popen(
            cmd + (["--multi-pod"] if mp else []), env=env, cwd=root,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return {"out": out, "procs": procs, "t0": time.time()}


def finish_dryrun(run: dict) -> list:
    """Wait for 16a's children; their records, each ``ok`` or the phase
    fails (a child past ``DRYRUN_TIMEOUT_S`` is killed and fails it)."""
    recs = []
    try:
        for (arch, shape, mp), proc in run["procs"].items():
            left = max(DRYRUN_TIMEOUT_S - (time.time() - run["t0"]), 1)
            _, err = proc.communicate(timeout=left)
            tag = "multipod" if mp else "singlepod"
            path = os.path.join(run["out"], f"{arch}-{shape}-{tag}.json")
            rec = json.load(open(path)) if os.path.exists(path) else {
                "status": "no record", "error": "\n".join(
                    ln for ln in err.splitlines()
                    if "Warning" not in ln and "] W" not in ln)[-3000:]}
            if proc.returncode != 0 or rec["status"] != "ok":
                raise AssertionError(
                    f"16a dry-run {arch} {shape} {tag}: exit "
                    f"{proc.returncode}, {rec['status']}: {rec.get('error')}"
                    f"\n{rec.get('trace', '')}")
            recs.append(rec)
    finally:
        for proc in run["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return recs


def report_dryrun(recs: list, wall: float) -> None:
    for r in recs:
        t = r["roofline"]
        log(f"[sharding] 16a dry-run {r['arch']} {r['shape']} on "
            f"{r['chips']} cards {r['mesh']}: {r['status']}, "
            f"{r['lower_s']} s; dominant {t['dominant']} "
            f"({t['bound_s'] * 1e3:.2f} ms; compute "
            f"{t['compute_s'] * 1e3:.2f}, memory {t['memory_s'] * 1e3:.2f}, "
            f"collective {t['collective_s'] * 1e3:.2f} ms on H100 "
            f"constants); per-card peak {gb(r['memory']['peak_bytes'] / 1e9)}"
            f"; collective bytes {r['collective_bytes']:,} "
            f"({r['collectives']['count']} calls); fallbacks "
            f"{r['fallbacks']}")
    log(f"[sharding] 16a: both cells in child processes, {wall:.1f} s")


def load_leaves(model, leaves: dict):
    """``model`` (on ``meta``) with each named parameter replaced by the
    tensor of ``leaves``."""
    import torch
    for name, t in leaves.items():
        mod, _, attr = name.rpartition(".")
        setattr(model.get_submodule(mod), attr, torch.nn.Parameter(t))
    return model


def run_sharded_full(dev, fops, root: str) -> dict:
    """16b: qwen3-1.7b at full width (28 layers, seeded bf16 weights) on
    ``make_host_mesh()`` (NCCL, a world of one): the parameters saved with
    ``CheckpointManager`` and restored with ``shardings=`` from
    ``rules.param_specs``; a prefill at B=1, S=4096 through the flash
    kernel on the DTensor parameters under the dry-run's constraints (its
    launches counted from 0) held to the plain parameters' prefill, the two
    timed in turns; two ``make_train_step`` steps (dense route, remat,
    ``lr_warmup=1``) on each in turns, held to 13g's bars; the peak
    memory."""
    import dataclasses as dc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data import DataPipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.sharding import (NamedSharding, batch_specs,
                                      param_specs, shard_tree)
    from repro_torch.train import make_prefill_step, make_train_step
    from repro_torch.train.step import abstract_params, to_device
    cfg = get_arch("qwen3-1.7b")
    b, s = SHARDED["batch"], SHARDED["seq"]
    t = TRAIN_FULL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(dev)
    ck = os.path.join(root, "build", "chip_smoke_sharded")
    shutil.rmtree(ck, ignore_errors=True)
    try:
        plain = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                               device=dev)
        leaves = dict(plain.named_parameters())
        specs = param_specs(cfg, mesh, plain)
        t0 = time.perf_counter()
        mgr = CheckpointManager(ck)
        mgr.save(0, leaves)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mgr.restore(leaves, shardings={
            n: NamedSharding(mesh, specs[n]) for n in leaves})
        sync(dev)
        t_restore = time.perf_counter() - t0
        if not all(bits_equal(back[n].to_local(), p.detach())
                   for n, p in leaves.items()):
            raise AssertionError("16b: the restored leaves differ from the "
                                 "saved ones")
        sharded = load_leaves(abstract_params(cfg), back)
        del back
        shutil.rmtree(ck, ignore_errors=True)
        gen = torch.Generator(dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                         device=dev)}
        dbatch = shard_tree(batch, batch_specs(cfg, mesh, batch), mesh)
        sp = dc.replace(SHAPES["prefill_32k"], global_batch=b, seq_len=s)
        dryrun._set_constraints(mesh, sp)
        try:
            step = make_prefill_step(cfg, use_flash=True)
            fops.mha.launches = 0
            fops.mha.kernel_launches = dict.fromkeys(fops.KERNELS, 0)
            got = step(sharded, dbatch)
            sync(dev)
            launches = dict(fops.mha.kernel_launches)
            want = step(plain, batch)
            times = turns({"plain": lambda: step(plain, batch),
                           "dtensor": lambda: step(sharded, dbatch)}, reps=2)
        finally:
            dryrun._clear_constraints()
        if launches != {"wgmma": cfg.n_layers, "simt": 0}:
            raise AssertionError(f"16b: prefill launches by kernel "
                                 f"{launches}; want {cfg.n_layers}, all on "
                                 f"the Hopper kernel")
        got_l = got.full_tensor()[:, 0]
        same = bits_equal(got_l, want[:, 0])
        rel = logits_close(got_l.float().cpu().numpy(),
                           want[:, 0].float().cpu().numpy(), "16b prefill")
        del got, want
        # two train steps on each, in turns
        bars = train_bars(json.load(open(TRAIN_GOLDEN)))
        pipe = DataPipeline(vocab=cfg.vocab, seq_len=t["seq"],
                            global_batch=t["batch"], seed=0)
        batches = [to_device(pipe.batch(i), dev) for i in range(2)]
        dbatches = [shard_tree(x, batch_specs(cfg, mesh, x), mesh)
                    for x in batches]
        runs = {}
        for name, params in (("dtensor", sharded), ("plain", plain)):
            runs[name] = {"params": params, "opt": init_opt_state(params),
                          "step": make_train_step(
                              cfg, remat=True, lr_peak=t["lr_peak"],
                              lr_warmup=t["lr_warmup"], device=dev),
                          "rows": []}
        for i in range(2):
            for name in ("dtensor", "plain"):
                r = runs[name]
                x = dbatches[i] if name == "dtensor" else batches[i]
                sync(dev)
                t0 = time.perf_counter()
                r["params"], r["opt"], m = r["step"](r["params"], r["opt"], x)
                sync(dev)
                r["rows"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                  **{k: float(v.full_tensor() if hasattr(
                                      v, "full_tensor") else v)
                                     for k, v in m.items()}})
        rows = []
        for a, p in zip(runs["dtensor"]["rows"], runs["plain"]["rows"]):
            for k, bar in (("loss", bars["loss"]), ("grad_norm",
                                                    bars["grad"])):
                if not abs(a[k] - p[k]) <= bar * abs(p[k]):
                    raise AssertionError(f"16b train {k}: DTensor {a[k]!r}, "
                                         f"plain {p[k]!r} (bar {bar:.4g})")
            rows.append({"dtensor": a, "plain": p,
                         "bitwise": all(a[k] == p[k] for k in ("loss",
                                                               "grad_norm",
                                                               "lr"))})
        peak = torch.cuda.max_memory_allocated()
        del runs, sharded, plain
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ck, ignore_errors=True)
    return {"launches": launches, "bitwise_logits": same, "logit_rel": rel,
            "prefill_ms": times, "train": rows, "peak_bytes": peak,
            "save_s": t_save, "restore_s": t_restore, "bars": bars,
            "leaves": len(leaves)}


def run_phase16(dev, fops, r13=None) -> dict:
    """Phase 16, the sharding layer: 16a the dry-run's cells in child
    processes on the host's CPU while 16b runs qwen3-1.7b on DTensor
    parameters on the card (``r13``: phase 13's result, whose plain steps
    16b's are set beside)."""
    t0 = time.time()
    run = start_dryrun(ROOT)
    r = {"sharded": run_sharded_full(dev, fops, ROOT)}
    m = r["sharded"]
    pf = m["prefill_ms"]
    log(f"[sharding] 16b qwen3-1.7b full width on make_host_mesh() (NCCL, "
        f"world 1): {m['leaves']} leaves saved in {m['save_s']:.1f} s and "
        f"restored with shardings= (rules.param_specs) in "
        f"{m['restore_s']:.1f} s, equal to the saved; prefill B="
        f"{SHARDED['batch']} S={SHARDED['seq']} with use_flash=True: "
        f"launches by kernel {m['launches']}; logits bitwise equal to the "
        f"plain parameters' prefill: {m['bitwise_logits']} (max |diff| "
        f"{m['logit_rel']:.4g} x max|logit|, bar {LOGIT_RTOL:.4g}); in turns "
        f"DTensor {pf['dtensor']:.1f} ms, plain {pf['plain']:.1f} ms; "
        f"{nvidia_smi()}")
    for i, row in enumerate(m["train"]):
        a, p = row["dtensor"], row["plain"]
        log(f"[sharding] 16b train step {i} (B={TRAIN_FULL['batch']} S="
            f"{TRAIN_FULL['seq']}, dense route, remat): DTensor "
            f"{a['ms']:.1f} ms loss {a['loss']!r} grad norm "
            f"{a['grad_norm']!r}; plain {p['ms']:.1f} ms loss {p['loss']!r} "
            f"grad norm {p['grad_norm']!r}; lr {a['lr']!r}; bitwise "
            f"{row['bitwise']} (bars loss {m['bars']['loss']:.4g}, grad "
            f"{m['bars']['grad']:.4g})")
    plain13 = ([row["ms"] for row in r13["full"]["rows"][1:]]
               if r13 else [])
    log(f"[sharding] 16b: peak memory {gb(m['peak_bytes'] / 1e9)} (both "
        f"models, their moments); phase 13a's plain steps "
        f"{', '.join(f'{x:.1f}' for x in plain13) or 'not run'} ms; "
        f"{nvidia_smi()}")
    t1 = time.time()
    r["dryrun"] = finish_dryrun(run)
    report_dryrun(r["dryrun"], time.time() - run["t0"])
    r["wall_s"] = time.time() - t0
    log(f"[sharding] phase 16: {r['wall_s']:.1f} s (waiting for 16a after "
        f"16b {time.time() - t1:.1f} s)")
    return r


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------
def train_bars(golden: dict) -> dict:
    """The training golden's bars: twice the JAX package's own dense-
    versus-chunked gap (``ref_gap``), with floors of 1e-3 for the loss and
    2e-2 for the gradients (tests/test_torch_train.py)."""
    g = golden["ref_gap"]
    return {"loss": max(2 * g["loss"], 1e-3), "grad": max(2 * g["grad"],
                                                          2e-2)}


def train_step_bound(cfg, params, b, s, ce_chunk=1024) -> dict:
    """The least time of one ``make_train_step(remat=True)`` step, worked
    out from the code: the layers' products and the dense route's scores
    and P V (bf16 on the tensor cores) four times over (forward, the
    remat recompute, a backward of twice the forward); the f32 lm head
    (TF32 off) four times over as well (each cross-entropy chunk is
    recomputed); and the AdamW update's bytes (each parameter, gradient
    and moment read once, each parameter and moment written once).  The
    three parts run one after the other, so their times add."""
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
                        cfg.d_ff)
    tokens = b * s
    weights = d * h * hd * 2 + d * hkv * hd * 2 + 3 * d * f
    layer = 2 * tokens * weights + 2 * 2 * b * h * s * s * hd
    bf16_ops = 4 * cfg.n_layers * layer
    f32_ops = 4 * 2 * tokens * cfg.vocab * d
    adam_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                     for p in params.parameters())
    parts = {"bf16_s": bf16_ops / BF16_FLOPS, "f32_s": f32_ops / FP32_FLOPS,
             "adamw_s": adam_bytes / HBM_BYTES_PER_S}
    return dict(parts, bound_s=sum(parts.values()), bf16_ops=bf16_ops,
                f32_ops=f32_ops, adam_bytes=adam_bytes)


def run_train_full(dev) -> dict:
    """Phase 13a: qwen3-1.7b at full width (28 layers, weights from a
    seeded generator on the card) through ``make_train_step(remat=True)``
    on ``DataPipeline`` batches: a warm step (lr 0), then timed steps, each
    ending in a synchronize.  Every leaf must change in the first step
    with lr > 0, every loss and grad norm be finite and positive, the
    peak memory hold at least the parameters, gradients and moments, and
    the flash kernel never be launched (training takes the dense route)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import to_device
    t = TRAIN_FULL
    cfg = get_arch("qwen3-1.7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, remat=True, lr_peak=t["lr_peak"],
                           lr_warmup=t["lr_warmup"], device=dev)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=t["seq"],
                        global_batch=t["batch"], seed=0)
    batches = [to_device(pipe.batch(i), dev)
               for i in range(1 + t["timed_steps"])]
    n_params = sum(p.numel() for p in params.parameters())
    state_bytes = sum(p.numel() * (2 * p.element_size() + 8)
                      for p in params.parameters())
    flash0 = fops.mha.launches
    rows = []
    for i, batch in enumerate(batches):
        if i == 1:
            before = {n: p.detach().to("cpu", copy=True)
                      for n, p in params.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({"step": i, "ms": wall * 1e3,
                     "tok_per_s": t["batch"] * t["seq"] / wall,
                     **{k: float(v) for k, v in m.items()}})
        if i == 1:
            still = [n for n, p in params.named_parameters()
                     if torch.equal(p.detach().cpu(), before[n])]
            del before
            if still:
                raise AssertionError(f"13a: {len(still)} leaves did not "
                                     f"change in step 1 (lr "
                                     f"{rows[-1]['lr']}): {still[:4]}")
    peak = torch.cuda.max_memory_allocated()
    for r in rows:
        if not (math.isfinite(r["loss"]) and r["loss"] > 0
                and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0):
            raise AssertionError(f"13a step {r['step']}: loss {r['loss']}, "
                                 f"grad norm {r['grad_norm']}")
    if rows[0]["lr"] != 0.0 or not all(r["lr"] > 0 for r in rows[1:]):
        raise AssertionError(f"13a: lr {[r['lr'] for r in rows]}")
    if peak < state_bytes:
        raise AssertionError(f"13a: peak memory {gb(peak / 1e9)} below "
                             f"the {gb(state_bytes / 1e9)} of parameters, "
                             f"gradients and moments")
    if fops.mha.launches != flash0:
        raise AssertionError("13a: the train step launched the flash kernel")
    bound = train_step_bound(cfg, params, t["batch"], t["seq"])
    del params, opt, batches
    torch.cuda.empty_cache()
    return {"rows": rows, "peak_bytes": peak, "state_bytes": state_bytes,
            "n_params": n_params, "bound": bound}


def check_train_golden(golden: dict, dev, tree=None) -> dict:
    """Phase 13g: qwen3-1.7b at full width with the golden's depth on
    ``convert.lm_numpy_params`` -- step 0's per-leaf gradient norms and
    the loss, grad norm and lr of three ``make_train_step`` steps held to
    the JAX package's (``train_bars``)."""
    import torch
    from repro_torch import convert
    from repro_torch.data import DataPipeline
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.step import to_device
    g = golden
    bars = train_bars(g)
    cfg = golden_config(g)
    params = convert.lm_params_from_numpy(
        golden_tree(g) if tree is None else tree, cfg, dev)
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=g["seq"],
                        global_batch=g["batch"], seed=g["data_seed"])
    worst = {"loss": 0.0, "grad": 0.0, "lr": 0.0}

    def hold(got, want, what, kind):
        rel = abs(got - want) / abs(want) if want else abs(got)
        worst[kind] = max(worst[kind], rel)
        bar = 1e-6 if kind == "lr" else bars[kind]
        if not rel <= bar:
            raise AssertionError(f"13g {what}: {got!r} against the golden's "
                                 f"{want!r} (rel {rel:.4g} > {bar:.4g})")

    leaves = lm.named_leaves(params)
    loss = lm.loss_fn(params, cfg, to_device(pipe.batch(0), dev), remat=True)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    norms = {}
    for (name, _), gr in zip(leaves, grads):
        norms.setdefault(lm.jax_path(name)[0], []).append(
            float(gr.double().norm()))
    del grads, leaves, loss
    if sorted(norms) != sorted(g["grad_norms"]):
        raise AssertionError(f"13g: leaves {sorted(norms)}")
    for path, want in g["grad_norms"].items():
        for i, (a, b) in enumerate(zip(norms[path], want, strict=True)):
            hold(a, b, f"step 0 gradient norm of {path}[{i}]", "grad")
    step = make_train_step(cfg, remat=True, lr_peak=g["lr_peak"],
                           lr_warmup=g["lr_warmup"], lr_total=g["lr_total"],
                           device=dev)
    opt = init_opt_state(params)
    got = []
    for i, want in enumerate(g["steps_out"]):
        params, opt, m = step(params, opt, pipe.batch(i))
        got.append({k: float(v) for k, v in m.items()})
        hold(got[-1]["loss"], want["loss"], f"step {i} loss", "loss")
        hold(got[-1]["grad_norm"], want["grad_norm"], f"step {i} grad norm",
             "grad")
        hold(got[-1]["lr"], want["lr"], f"step {i} lr", "lr")
    return {"steps": got, "worst": worst, "bars": bars}


def run_train_resume(dev, root: str) -> dict:
    """Phase 13r: the ``Trainer`` at ``tests/test_integration.py``'s TINY
    (the reduced qwen3-1.7b with 2 layers) on the card: 15 straight steps
    against 10 steps, a checkpoint and a resume to 15 (the reference's bar,
    rel 1e-4); then a checkpoint the port wrote of a state on the card,
    restored onto the card, equal bit for bit to what was saved."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import DataPipeline
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tiny = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), n_layers=2)
    pipe = DataPipeline(vocab=tiny.vocab, seq_len=32, global_batch=4)
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name, steps, every=100):
        return Trainer(tiny, TrainerConfig(
            steps=steps, ckpt_every=every, log_every=100,
            ckpt_dir=os.path.join(root, name)), pipe, device=dev)

    t0 = time.perf_counter()
    straight = trainer("straight", 15).run()
    trainer("resumed", 10, every=10).run()
    resumed = trainer("resumed", 15).run()
    wall = time.perf_counter() - t0
    a, b = straight["final_loss"], resumed["final_loss"]
    if resumed["steps_run"] != 5 or not abs(a - b) <= 1e-4 * abs(a):
        raise AssertionError(f"13r: resumed {resumed['steps_run']} steps to "
                             f"loss {b!r}, straight {a!r} (rel 1e-4)")
    tr = trainer("resumed", 15)
    params, opt, start = tr.init_or_resume()
    saved = tr._state(params, opt)
    mgr = CheckpointManager(os.path.join(root, "bitwise"))
    mgr.save(start, saved)
    back = mgr.restore(saved, device=dev)
    pairs = [(x, torch.as_tensor(y))
             for x, y in zip(tree_flatten(back), tree_flatten(saved))]
    same = all(x.device.type == torch.device(dev).type and x.dtype == y.dtype
               and torch.equal(x.cpu(), y) for x, y in pairs)
    again = convert.lm_params_from_numpy(back["params"], tiny, dev)
    same = same and all(torch.equal(x, y) for x, y in zip(
        again.parameters(), params.parameters()))
    if not same:
        raise AssertionError("13r: the restored checkpoint differs from the "
                             "saved state")
    shutil.rmtree(root, ignore_errors=True)
    return {"straight": a, "resumed": b, "rel": abs(a - b) / abs(a),
            "bitwise": a == b, "wall_s": wall, "leaves": len(pairs),
            "start": start,
            "losses": [h["loss"] for h in straight["history"]]}


def run_phase13(dev, tree=None) -> dict:
    """Phase 13, training: 13a full width, 13g the golden (``tree``: its
    parameter tree if made already), 13r resume."""
    t0 = time.time()
    r = {"full": run_train_full(dev)}
    full = r["full"]
    bd = full["bound"]
    for row in full["rows"]:
        log(f"[train] 13a qwen3-1.7b full width, B={TRAIN_FULL['batch']} "
            f"S={TRAIN_FULL['seq']}, step {row['step']}"
            f"{' (warm)' if row['step'] == 0 else ''}: {row['ms']:.1f} ms, "
            f"{row['tok_per_s']:,.0f} tok/s, loss {row['loss']!r}, grad "
            f"norm {row['grad_norm']!r}, lr {row['lr']!r}")
    timed = [row["ms"] for row in full["rows"][1:]]
    log(f"[train] 13a: {full['n_params']:,} parameters; timed steps "
        f"{', '.join(f'{ms:.1f}' for ms in timed)} ms against a bound of "
        f"{bd['bound_s'] * 1e3:.1f} ms ({bd['bf16_ops']:.4g} bf16 FLOP "
        f"{bd['bf16_s'] * 1e3:.1f} ms + {bd['f32_ops']:.4g} f32 FLOP "
        f"{bd['f32_s'] * 1e3:.1f} ms + {bd['adam_bytes'] / 1e9:.2f} GB of "
        f"AdamW {bd['adamw_s'] * 1e3:.1f} ms); peak memory "
        f"{gb(full['peak_bytes'] / 1e9)} (parameters, gradients and "
        f"moments {gb(full['state_bytes'] / 1e9)}); every leaf changed in "
        f"step 1; no flash launch; {nvidia_smi()}")
    t1 = time.time()
    golden = json.load(open(TRAIN_GOLDEN))
    r["golden"] = g = check_train_golden(golden, dev, tree)
    log(f"[train] 13g qwen3-1.7b full width, {golden['n_layers']} layers, "
        f"B={golden['batch']} S={golden['seq']}: step 0's gradient norms "
        f"and {len(g['steps'])} steps' loss, grad norm and lr within the "
        f"golden's bars (worst loss {g['worst']['loss']:.3g} of "
        f"{g['bars']['loss']:.3g}, grad {g['worst']['grad']:.3g} of "
        f"{g['bars']['grad']:.3g}, lr {g['worst']['lr']:.3g} of 1e-06); "
        f"losses {[s['loss'] for s in g['steps']]}; {time.time() - t1:.1f} s")
    t1 = time.time()
    r["resume"] = rr = run_train_resume(
        dev, os.path.join(ROOT, "build", "chip_smoke_train"))
    log(f"[train] 13r Trainer at the reduced qwen3-1.7b (2 layers) on the "
        f"card: resumed at step 10 to {rr['resumed']!r}, straight "
        f"{rr['straight']!r} (rel {rr['rel']:.3g}, bitwise "
        f"{rr['bitwise']}); three trainer runs {rr['wall_s']:.1f} s; the "
        f"step-{rr['start']} checkpoint's {rr['leaves']} leaves restored "
        f"onto the card equal to the saved state; {time.time() - t1:.1f} s")
    r["wall_s"] = time.time() - t0
    log(f"[train] phase 13: {r['wall_s']:.1f} s")
    return r


# ---------------------------------------------------------------------------
# phase 11: the serve replay at full width
# ---------------------------------------------------------------------------
def replay_record(res, stats) -> dict:
    """One replay outcome as the golden file keeps it."""
    return json.loads(json.dumps({
        "counters": dict(res.counters),
        "wait_hist": [int(v) for v in res.wait_hist],
        "lat_hist": [int(v) for v in res.lat_hist],
        "sched_stats": dict(stats), "summary": res.summary()}))


class Evaluations:
    """Wraps ``serve.api._evaluate`` and keeps each cell's (result,
    scheduler stats): ``serve.run``'s rows carry three of the stats."""

    def __init__(self, api):
        self.api, self.fn, self.out = api, api._evaluate, []
        api._evaluate = self

    def __call__(self, *args, **kw):
        res, stats = self.fn(*args, **kw)
        self.out.append((res, stats))
        return res, stats

    def restore(self):
        self.api._evaluate = self.fn


def superstep_busy(replay_mod, spec, dev, steps: int = 2) -> dict:
    """``torch.profiler`` over ``steps`` super-steps of ``spec``'s replay
    from its first state: the kernels' device time against the wall of
    the enqueue plus one read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import serve
    from repro_torch.serve.api import _build_scheduler
    trace = serve.generate(spec.trace)
    sched = _build_scheduler(spec, spec.resolved_knobs(), dev)
    dims = replay_mod._Dims(
        n=trace.n, slots=spec.slots, budget=int(sched.token_budget),
        max_steps=spec.max_steps, k=int(sched.apm.epoch_len),
        residency=sched.knobs.residency, admission=spec.admission)
    consts, carry = replay_mod._stage(trace, dev)
    rc, ri = (replay_mod._i64(a, dev) for a in replay_mod.classify_sessions(
        sched.profile, trace.turns, trace.gap))
    th = (int(sched.ri_th), int(sched.rc_th))
    replay_mod._read(*replay_mod._superstep(dims, consts, carry, rc, ri,
                                            *th))         # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            carry, comp = replay_mod._superstep(dims, consts, carry, rc, ri,
                                                *th)
            replay_mod._read(carry, comp)
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return {"wall_ms": wall / steps * 1e3, "device_ms": busy / steps,
            "kernels": len(kern) / steps}


def run_serve_replay(golden: dict, kops, dev) -> dict:
    """Phase 11: the four cells of ``benchmarks/bench_serve.py``'s full
    grid (6000 sessions, rates 2 and 8 x kv-online and evict-all, 128
    slots, 4096 steps) through ``serve.run`` on the batched engine
    (``ExecPlan(engine="auto")``, every super-step under the sync check)
    and on the host oracle, in turns a cell.  Each cell's counters, both
    histograms and the scheduler's stats must equal the host oracle's and
    the golden file; every batched row must say ``batched`` with no
    ``serve_degrade`` event; a kv-online cell must launch ``kmeans_fit``
    at least twice (its offline profile and a refit), an evict-all cell
    never.  The launch counts are set to 0 just before each leg and read
    just after it."""
    import importlib
    import torch
    from repro_torch import exp, serve
    from repro_torch.serve import api
    replay_mod = importlib.import_module("repro_torch.serve.replay")
    fit, dense = kops.fit_masked, kops.assign
    cells = []
    for cell in golden["cells"]:
        spec = serve.ServeSpec.from_dict(cell["spec"])
        if json.loads(json.dumps(spec.spec_dict())) != cell["spec"]:
            raise AssertionError(f"phase 11: {spec} does not rebuild the "
                                 f"golden's spec")
        want = {k: cell[k] for k in ("counters", "wait_hist", "lat_hist",
                                     "sched_stats", "summary")}
        legs = {}
        for leg, engine in (("batched", "auto"), ("host", "host")):
            ev = Evaluations(api)
            chk = SyncChecked(replay_mod) if leg == "batched" else None
            read = Timed(replay_mod, "_read")
            fit.launches = dense.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = serve.run(spec, plan=exp.ExecPlan(engine=engine,
                                                   cache=False), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"kmeans_fit": fit.launches,
                        "kmeans_assign": dense.launches}
            for hook in (ev, chk, read):
                if hook is not None:
                    hook.restore()
            row = rs.one()
            degr = [e for e in rs.run_report.events
                    if e["kind"] == "serve_degrade"]
            (res, stats), = ev.out
            legs[leg] = {"row": row, "wall_s": wall, "launches": launches,
                         "record": replay_record(res, stats),
                         "supersteps": chk.calls if chk else 0,
                         "enqueue_s": chk.seconds if chk else 0.0,
                         "read_s": read.seconds, "degraded": degr}
            if row["engine"] != leg or degr:
                raise AssertionError(f"phase 11 {leg} leg of {spec.knobs} "
                                     f"rate {spec.trace.rate}: engine "
                                     f"{row['engine']}, events {degr}")
        b, h = legs["batched"], legs["host"]
        name = f"{spec.knobs} rate {spec.trace.rate:g}"
        if b["record"] != h["record"]:
            raise AssertionError(f"phase 11 {name}: batched != host oracle")
        if b["record"] != want:
            diff = [k for k in want if b["record"][k] != want[k]]
            raise AssertionError(f"phase 11 {name}: differs from the golden "
                                 f"in {diff}")
        if b["supersteps"] < 1:
            raise AssertionError(f"phase 11 {name}: {b['supersteps']} "
                                 f"super-steps")
        n_fit = b["launches"]["kmeans_fit"]
        if spec.knobs == "kv-online":
            if n_fit < 2 or n_fit != 1 + b["row"]["refits"] or \
                    b["launches"]["kmeans_assign"] != n_fit:
                raise AssertionError(f"phase 11 {name}: launches "
                                     f"{b['launches']}, refits "
                                     f"{b['row']['refits']}; want the "
                                     f"offline fit plus one a refit")
        elif b["launches"] != {"kmeans_fit": 0, "kmeans_assign": 0}:
            raise AssertionError(f"phase 11 {name}: launches "
                                 f"{b['launches']}, want none")
        cells.append({"spec": spec, "name": name, **legs})
    rates = sorted({c["spec"].trace.rate for c in cells})
    delta = {}
    for r in rates:
        by = {c["spec"].knobs: c["batched"]["row"]["dmr"] for c in cells
              if c["spec"].trace.rate == r}
        delta[r] = by["evict-all"] - by["kv-online"]
    top = max(cells, key=lambda c: (c["spec"].trace.rate,
                                    c["spec"].knobs == "kv-online"))
    busy = superstep_busy(replay_mod, top["spec"], dev)
    return {"cells": cells, "resid_dmr_delta": delta, "busy": busy,
            "busy_cell": top["name"]}


# ---------------------------------------------------------------------------
# phase 12: the sweep process pool on the card
# ---------------------------------------------------------------------------
# each pool task's kernel launches in its worker, one JSON file a task
POOL_DIR = os.path.join(ROOT, "build", "chip_smoke_pool")
POOL_JOBS = 4
# tests/test_faults.py's four points (config1, two mixes x two policies at
# the tiny point) on two workers; the watchdog gives a task five seconds
# (a task takes about one on the card, the workers already started)
CHAOS_POINTS = dict(config="config1", mixes=("moti1", "moti2"),
                    policies=("fifo-nb", "arp-cs-as"),
                    params=dict(n_inputs=1, max_epochs=40,
                                subsample_target=50_000))
CHAOS_JOBS = 2
CHAOS_TIMEOUT_S = 5.0


def pool_counters() -> dict:
    """The launch counters of the simulator's kernel wrappers."""
    from repro_torch.kernels.kmeans_assign import ops as kops
    from repro_torch.kernels.llc_rounds import ops as rops
    from repro_torch.kernels.ri_histogram import ops as hops
    return {"ri_histogram": hops.histogram, "kmeans_fit": kops.fit_masked,
            "kmeans_assign": kops.assign,
            "kmeans_fit_segmented": kops.fit_segmented,
            "kmeans_assign_segmented": kops.assign_segmented,
            "llc_rounds": rops.rounds}


def counted_pool_task(task, engine, device):
    """``sweep._pool_task`` as a pool worker runs it, then the launches
    the task made (the wrappers' own counts in this worker) written to a
    file of ``POOL_DIR``: the caller cannot read a worker's counters."""
    import torch
    from repro_torch.core import sweep
    counters = pool_counters()
    before = {k: c.launches for k, c in counters.items()}
    try:
        return sweep._pool_task(task, engine, device)
    finally:
        rec = {"pid": os.getpid(), "task": f"{task[0]}|{task[1]}|"
               + "+".join(p.name for p in task[2]),
               "cuda": torch.cuda.is_initialized(),
               "launches": {k: c.launches - before[k]
                            for k, c in counters.items()}}
        path = os.path.join(POOL_DIR, f"{os.getpid()}-{time.time_ns()}.json")
        with open(path, "w") as f:
            json.dump(rec, f)


class TimedPools:
    """Stands in for ``sweep.ProcessPoolExecutor`` and keeps, for each
    pool the sweep creates, the seconds from its creation to the end of
    its warm-up map (every worker started: spawn, import, a CUDA context
    each) and to its first finished calibration (the pool's start-up)."""

    def __init__(self, sweep):
        self.sweep, self.cls = sweep, sweep.ProcessPoolExecutor
        self.started, self.startup = [], []
        sweep.ProcessPoolExecutor = self

    def __call__(self, *args, **kw):
        pool = self.cls(*args, **kw)
        t0, real_map, maps = time.perf_counter(), pool.map, []
        started, startup = self.started, self.startup

        def timed_map(*a, **k):
            maps.append(1)
            first = len(maps) == 2          # the calibration map
            for x in real_map(*a, **k):
                if first:
                    startup.append(time.perf_counter() - t0)
                    first = False
                yield x
            if len(maps) == 1:
                started.append(time.perf_counter() - t0)

        pool.map = timed_map
        return pool

    def restore(self):
        self.sweep.ProcessPoolExecutor = self.cls


class GpuApps:
    """Polls ``nvidia-smi`` while work runs: the compute processes holding
    a context on the card (pid and memory) and the card's used memory."""

    def __init__(self, interval: float = 0.5):
        import threading
        self.samples, self.used = [], []
        self.stop_flag = threading.Event()
        self.thread = threading.Thread(target=self.run, args=(interval,),
                                       daemon=True)
        self.thread.start()

    def run(self, interval):
        while not self.stop_flag.is_set():
            apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout
            used = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout
            seen = {}
            for ln in apps.strip().splitlines():
                parts = [p.strip() for p in ln.split(",")]
                if len(parts) == 2 and parts[0].isdigit():
                    seen[int(parts[0])] = parts[1]
            self.samples.append(seen)
            if used.strip().splitlines():
                self.used.append(int(used.strip().splitlines()[0]))
            self.stop_flag.wait(interval)

    def stop(self) -> dict:
        self.stop_flag.set()
        self.thread.join()
        pids = {}
        for seen in self.samples:
            for pid, mem in seen.items():
                pids.setdefault(pid, mem)
        return {"pids": pids, "samples": len(self.samples),
                "most": max((len(s) for s in self.samples), default=0),
                "used_mib": (self.used[0], max(self.used)) if self.used
                else None}


def host_values(x) -> bool:
    """Only Python and numpy values (no tensor crossed from a worker)."""
    import numpy as np
    if isinstance(x, dict):
        return all(host_values(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(host_values(v) for v in x)
    return x is None or isinstance(x, (bool, int, float, str, np.generic,
                                       np.ndarray))


def run_sweep_pool(points, dev, cache: str) -> dict:
    """Phase 12a: ``points`` through ``sweep.map_points(engine="host",
    max_lanes=3, fit_engine="bucketed")`` with ``jobs=1`` and with
    ``jobs=POOL_JOBS``, each from an empty cache root, so that the LERN
    fit and the deadline calibration run in the leg.  Each leg's kernel
    launches are counted in the caller (set to 0 just before, read just
    after) and, on the pool, in each worker's group tasks
    (``counted_pool_task``); ``nvidia-smi`` is polled while the pool
    runs.  Returns per leg the results (as dicts), wall, launches, pool
    start-up seconds, the tasks' records and the polled processes."""
    import dataclasses as dc
    import torch
    from repro_torch.core import lern, sweep
    from repro_torch.exp import faults
    counters = pool_counters()
    legs = {}
    for jobs in (1, POOL_JOBS):
        root = f"{cache}_pool{jobs}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(POOL_DIR, ignore_errors=True)
        os.makedirs(POOL_DIR)
        os.environ["REPRO_CACHE"] = root
        pools = TimedPools(sweep)
        sweep._pool_task, real_task = counted_pool_task, sweep._pool_task
        apps = GpuApps() if jobs > 1 else None
        report = faults.RunReport()
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with lern.fit_engine_override("bucketed"):
                rs = sweep.map_points(points, jobs=jobs, max_lanes=3,
                                      engine="host", fit_engine="bucketed",
                                      report=report, device=dev)
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            pools.restore()
            sweep._pool_task = real_task
            polled = apps.stop() if apps else None
        caller = {k: c.launches for k, c in counters.items()}
        tasks = []
        for name in sorted(os.listdir(POOL_DIR)):
            with open(os.path.join(POOL_DIR, name)) as f:
                tasks.append(json.load(f))
        legs[jobs] = {"results": [dc.asdict(r) for r in rs], "wall_s": wall,
                      "caller": caller, "tasks": tasks,
                      "started_s": pools.started,
                      "startup_s": pools.startup, "apps": polled,
                      "events": report.events,
                      "host_values": all(host_values(dc.asdict(r))
                                         for r in rs)}
    return legs


def run_pool_chaos(dev, cache: str) -> dict:
    """Phase 12b: the chaos suite's four points on ``CHAOS_JOBS`` workers
    under three fault plans -- a ``task`` crash (the pool respawns), a
    ``task`` hang with the watchdog armed, a ``task`` raise with a
    ``cache_dump`` corruption in a worker -- each from a cache holding the
    clean run's artifacts but no result.  Returns the clean ``jobs=1``
    results and each plan's results, events and wall."""
    import dataclasses as dc
    from repro_torch.core import policies, sim, sweep
    from repro_torch.exp import faults
    c = CHAOS_POINTS
    p = sim.SimParams(**c["params"])
    pts = [sweep.SweepPoint(c["config"], mix, policies.get(n), p)
           for mix in c["mixes"] for n in c["policies"]]
    art = f"{cache}_chaos"
    shutil.rmtree(art, ignore_errors=True)
    os.environ["REPRO_CACHE"] = art
    t0 = time.perf_counter()
    clean = [dc.asdict(r) for r in sweep.map_points(pts, jobs=1, device=dev)]
    out = {"clean": clean, "clean_s": time.perf_counter() - t0, "plans": {}}
    shutil.rmtree(os.path.join(art, "torch", "sim"))
    plans = {
        "crash": ([{"site": "task", "kind": "crash"}], {}),
        "hang": ([{"site": "task", "kind": "hang", "seconds": 600.0}],
                 {"task_timeout": CHAOS_TIMEOUT_S}),
        "raise + cache_dump corrupt": (
            [{"site": "task", "kind": "raise"},
             {"site": "cache_dump", "kind": "corrupt",
              "match": os.path.basename(pts[0].cache_path())}], {}),
    }
    for i, (name, (specs, kw)) in enumerate(plans.items()):
        root = f"{cache}_chaos{i}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(art, root)
        os.environ["REPRO_CACHE"] = root
        report = faults.RunReport()
        t0 = time.perf_counter()
        with faults.activate(faults.FaultPlan.make(specs)):
            got = sweep.map_points(pts, jobs=CHAOS_JOBS, report=report,
                                   device=dev, **kw)
        out["plans"][name] = {"results": [dc.asdict(r) for r in got],
                              "events": report.events,
                              "wall_s": time.perf_counter() - t0}
    return out


def check_pool_chaos(r: dict) -> dict:
    """Each 12b plan bitwise equal to the clean run, with its event: a
    ``worker_crash`` with a respawn, a ``watchdog_kill``, the ``task`` and
    ``cache_dump`` faults of the workers tagged ``origin="worker"``."""
    seen = {}
    for name, plan in r["plans"].items():
        ev = plan["events"]
        if name == "crash":
            ok = any(e["kind"] == "worker_crash" and e.get("respawn")
                     for e in ev)
        elif name == "hang":
            ok = any(e["kind"] == "watchdog_kill" for e in ev)
        else:
            ok = {"task", "cache_dump"} <= {
                e["site"] for e in ev
                if e["kind"] == "fault" and e.get("origin") == "worker"}
        seen[name] = sorted({e["kind"] for e in ev})
        if plan["results"] != r["clean"] or not ok:
            raise AssertionError(f"phase 12b {name}: equal to the clean run"
                                 f" {plan['results'] == r['clean']}, events "
                                 f"{ev}")
    return seen


def run_phase12(spec6c, system: dict, dev, cache: str, host_6c=None,
                walls_6c=None) -> None:
    """Phase 12: 12a (``run_sweep_pool``) on phase 6c's twelve points --
    both legs bitwise equal to each other, to 6c's host leg
    (``host_6c``, when given) and, the moti2 six, to the test_system
    golden; every kernel of the path launched (the caller and the
    workers' group tasks together), every pool task launching
    ``llc_rounds``, at least two worker processes holding a context on the
    card -- then 12b (``run_pool_chaos``).  Raises on failure."""
    from repro_torch.core import sim
    t12 = time.time()
    pts12 = [pt.sweep_point() for pt, _ in spec6c.expand()]
    r12 = run_sweep_pool(pts12, dev, cache)
    one, pool = r12[1], r12[POOL_JOBS]
    for jobs, leg in r12.items():
        done = [t["launches"] for t in leg["tasks"]]
        total = {k: leg["caller"][k] + sum(d[k] for d in done)
                 for k in leg["caller"]}
        leg["total"] = total
        log(f"[pool] phase 12a jobs={jobs}: {len(pts12)} points, wall "
            f"{leg['wall_s']:.2f} s, pool start-up (creation to every "
            f"worker started {leg['started_s']} s, to the first finished "
            f"calibration {leg['startup_s']} s), launches in the "
            f"caller {leg['caller']}, in the workers' group tasks "
            + "; ".join(f"{t['task']} (pid {t['pid']}): {t['launches']}"
                        for t in leg["tasks"])
            + f"; events {[e['kind'] for e in leg['events']]}")
        if not leg["host_values"]:
            raise AssertionError(f"phase 12a jobs={jobs}: a result holds a "
                                 f"tensor")
        if min(total.get(k, 0) for k in ("ri_histogram", "kmeans_fit",
                                         "kmeans_assign", "llc_rounds")) < 1:
            raise AssertionError(f"phase 12a jobs={jobs}: launches {total}")
    if len(pool["tasks"]) != 4 or any(
            t["launches"]["llc_rounds"] < 1 for t in pool["tasks"]):
        raise AssertionError(f"phase 12a: the pool's group tasks "
                             f"{pool['tasks']}; want four, each launching "
                             f"llc_rounds")
    if one["results"] != pool["results"]:
        raise AssertionError("phase 12a: jobs=1 and the pool differ")
    if host_6c is not None and one["results"] != host_6c:
        raise AssertionError("phase 12a: differs from phase 6c's host leg")
    by = {(r["mix"], r["policy"]): r for r in one["results"]}
    for name, want in system["points"].items():
        res = sim.SimResult(**by[(MIX, name)])
        if json.loads(json.dumps(system_point(res))) != want:
            raise AssertionError(f"phase 12a {name}: differs from the "
                                 f"test_system golden")
    apps = pool["apps"]
    # the workers that held a context (each reports its own), and what the
    # card's used memory gained while they ran (nvidia-smi; its list of
    # compute processes may stand in another pid namespace, and then
    # shows the container as one entry)
    workers = {t["pid"] for t in pool["tasks"] if t["cuda"]}
    first, most = apps["used_mib"] or (0, 0)
    log(f"[pool] phase 12a: both legs bitwise equal to each other, "
        + ("to phase 6c's host leg " if host_6c is not None else "")
        + f"and (the {MIX} six) to the test_system golden; "
        f"jobs=1 {one['wall_s']:.2f} s, jobs={POOL_JOBS} "
        f"{pool['wall_s']:.2f} s"
        + (f" (6c on warm artifacts: host {walls_6c['host']:.2f} s, "
           f"bucketed {walls_6c['bucketed, pipeline on']:.2f} s)"
           if walls_6c else "")
        + f"; os.cpu_count() {os.cpu_count()}; group tasks on the workers "
        f"(pids) {sorted(workers)}, each with a CUDA context; nvidia-smi "
        f"over {apps['samples']} polls: the card's used memory {first} MiB "
        f"before the workers, at most {most} MiB with them ("
        f"{(most - first) / POOL_JOBS:.0f} MiB a worker), compute "
        f"processes (pid: MiB) {apps['pids']} (this script's pid "
        f"{os.getpid()}; at most {apps['most']} at once)")
    if len(workers) < 2 or not most > first:
        raise AssertionError(f"phase 12a: workers with a context "
                             f"{sorted(workers)}, the card's used memory "
                             f"{apps['used_mib']}; want two or more, and a "
                             f"rise")
    r12b = run_pool_chaos(dev, cache)
    seen = check_pool_chaos(r12b)
    log(f"[pool] phase 12b: the chaos suite's four points on {CHAOS_JOBS} "
        f"workers, each plan bitwise equal to the clean jobs=1 run "
        f"({r12b['clean_s']:.2f} s from an empty cache): " + "; ".join(
            f"{name} {plan['wall_s']:.2f} s, events {seen[name]}"
            for name, plan in r12b["plans"].items())
        + f"; watchdog {CHAOS_TIMEOUT_S} s")
    log(f"[pool] phase 12: {time.time() - t12:.1f} s; {nvidia_smi()}")


def profile_decode(eng, dev, steps: int = 4) -> dict:
    """``torch.profiler`` over a few more decode steps of the finished
    engine (its stats are already taken): device time against wall time
    and the kernels a step launches.  Empty where the profiler sees no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch.device(dev).type != "cuda":
        return {}
    tok = eng._tokens(0)
    eng.step_fn(eng.params, eng.state, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step_fn(eng.params, eng.state, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {}
    ms = [e.time_range.elapsed_us() / 1e3 for e in kern]
    busy = sum(ms)
    by_name = {}
    for e, t in zip(kern, ms):
        by_name[e.name] = by_name.get(e.name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"wall_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step": busy / steps,
            "kernels_per_step": len(kern) / steps,
            "top": [(n[:60], round(t / steps, 4)) for n, t in top]}


def run_shards_6c(exp, fused, rops, spec6c, host_6c, dev, cache) -> dict:
    """Phase 6c's leg "bucketed, two shards": each bucket of two groups
    split into two shards of one group, as ``ExecPlan(devices=2)`` splits
    it on two cards -- there through that plan, on one card through the
    engine's `_drive_shards` with both shards on it -- bitwise equal to 6c's
    host leg (``host_6c``), every shard's super-steps under the sync
    check and its ``llc_rounds`` launches counted apart; then
    ``ExecPlan(devices=<cards> + 1)`` must raise before any work."""
    import torch
    n_cards = torch.cuda.device_count()
    drive_b, step_b = fused.drive_lanes_bucketed, fused._superstep_bucket
    buckets, calls, by_shard = [], [0], [0, 0]

    def recorded(groups, devices=None, staged=None, pipeline=None):
        buckets.append([g[0].mix for g in groups])
        if n_cards >= 2:
            return drive_b(groups, devices=devices, staged=staged,
                           pipeline=pipeline)
        if len(groups) != 2:
            raise AssertionError(f"phase 6c two shards: a bucket of "
                                 f"{len(groups)} groups")
        return fused._drive_shards(groups, [dev, dev], staged=staged,
                                   pipeline=pipeline)

    chk = SyncChecked(fused, "_superstep_bucket")

    def counted(*a):
        # the engine enqueues the shards in order, every super-step
        k, before = calls[0] % 2, rops.rounds.launches
        calls[0] += 1
        out = chk(*a)
        by_shard[k] += rops.rounds.launches - before
        return out

    fused._superstep_bucket = counted
    fused.drive_lanes_bucketed = recorded
    mapping = ("shard i on cuda:i (ExecPlan(devices=2))" if n_cards >= 2
               else f"both shards on {dev} (one card: _drive_shards)")
    fused.reset_counts()
    fused.reset_phase_times()
    rops.rounds.launches = 0
    t0 = time.time()
    try:
        rs = exp.run(spec6c, plan=exp.ExecPlan(
            engine="bucketed", pipeline=True, cache=False, max_lanes=3,
            fit_engine="bucketed", devices=2 if n_cards >= 2 else None),
            device=dev)
        torch.cuda.synchronize()
    finally:
        fused.drive_lanes_bucketed, fused._superstep_bucket = drive_b, step_b
    wall = time.time() - t0
    c = fused.counts()
    got = [dataclasses.asdict(r) for r in rs.results()]
    log(f"[bucketed] phase 6c bucketed, two shards: {mapping}; wall "
        f"{wall:.1f} s, shards {c['bucket_shards']}, super-steps "
        f"{c['bucket_supersteps']} ({chk.calls} shard super-steps under "
        f"set_sync_debug_mode('error')), llc_rounds launches by shard "
        f"{by_shard} (total {rops.rounds.launches}), counts {c}; phase "
        "split " + ", ".join(f"{k} {v:.3f}"
                             for k, v in fused.phase_times().items()))
    if got != host_6c:
        raise AssertionError("phase 6c two shards: differs from the host "
                             "engine")
    if (len(buckets) != 2 or c["bucket_shards"] != 2 * len(buckets)
            or c["bucket_demotions"] or min(by_shard) <= 0):
        raise AssertionError(f"phase 6c two shards: {c}, launches by shard "
                             f"{by_shard}, buckets {buckets}")
    # a count above the visible cards: refused before anything is staged,
    # cached or launched
    too_many = n_cards + 1
    os.environ["REPRO_CACHE"] = cache + "_shards_refused"
    shutil.rmtree(os.environ["REPRO_CACHE"], ignore_errors=True)
    fused.reset_counts()
    rops.rounds.launches = 0
    try:
        exp.run(spec6c, plan=exp.ExecPlan(engine="bucketed", max_lanes=3,
                                          fit_engine="bucketed",
                                          devices=too_many), device=dev)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"phase 6c: devices={too_many} ran")
    left = [f for _d, _s, fs in os.walk(os.environ["REPRO_CACHE"])
            for f in fs]
    if any(fused.counts().values()) or rops.rounds.launches or left:
        raise AssertionError(f"phase 6c: devices={too_many} did work before "
                             f"it was refused: {fused.counts()}, "
                             f"{rops.rounds.launches} launches, {left}")
    log(f"[bucketed] phase 6c two shards: bitwise equal to the host engine; "
        f"devices={too_many} refused before any work: {refused}")
    return {"wall": wall, "by_shard": by_shard, "mapping": mapping}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not all(os.path.exists(f) for f in (GOLDEN, SYSTEM, LM_GOLDEN,
                                           SCHED, SERVE_REPLAY,
                                           TRAIN_GOLDEN, MOE_GOLDEN,
                                           SSM_GOLDEN, HYBRID_GOLDEN,
                                           ENCDEC_GOLDEN, VLM_GOLDEN)):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    cache = os.path.join(ROOT, "build", "chip_smoke_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_CACHE"] = cache

    import numpy as np
    from repro_torch import exp
    from repro_torch.core import kmeans, lern, llc, policies, sim
    from repro_torch.core.dram import default_model
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.kmeans_assign import ops as kops
    from repro_torch.kernels.llc_rounds import kernel as rkernel
    from repro_torch.kernels.llc_rounds import ops as rops
    from repro_torch.kernels.ri_histogram import ops as hops
    from repro_torch.core import fused, sweep
    from repro_torch.core.ship import SHIP_DEFAULT, SHIP_LARGE
    from repro_torch.models import lm

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
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ri_histogram import kernel as hkernel
    ptxas = flash_build_report(reports["flash_attention"])
    hgmma = hgmma_counts(_build._target("flash_attention"))
    for d in fops.HEAD_DIMS:
        log(f"[build] flash_attention Hopper kernel d={d}: "
            f"{' | '.join(ptxas.get(d, ['no report']))} | dynamic shared "
            f"memory {fkernel.smem_bytes(d):,} bytes a block | HGMMA in its "
            f"SASS: {hgmma.get(d, {}).get('smem', 0)} with A from shared "
            f"memory (S = Q K^T), {hgmma.get(d, {}).get('regs', 0)} with A "
            f"from registers (O += P V)")
        if not (hgmma.get(d, {}).get("smem") and hgmma[d].get("regs")):
            raise AssertionError(f"the Hopper flash kernel at d={d} does not "
                                 f"run both products on the tensor cores: "
                                 f"{hgmma.get(d)}")
    ptx = llc_ptxas(reports.get("llc_rounds", ""))
    shapes = {name: rkernel.cluster_shape(1024, 16, ship.entries, 5)
              for name, ship in (("SHIP_DEFAULT", SHIP_DEFAULT),
                                 ("SHIP_LARGE", SHIP_LARGE))}
    log("[build] llc_rounds (ptxas): " + ("; ".join(
        f"{k}: {v}" for k, v in ptx.items()) or "no report (built before)")
        + "; the path's shape at 1024 sets x 16 ways: " + "; ".join(
            f"{name}: {sh}" for name, sh in shapes.items()))
    if min(sh["active_clusters"] for sh in shapes.values()) < 1:
        raise AssertionError(f"llc_rounds: no cluster fits: {shapes}")
    size, active = hkernel.cluster()
    log(f"[build] nvcc {t_nvcc:.1f} s; ri_histogram: one cluster of {size} "
        f"CTAs x 1024 threads a launch, cudaOccupancyMaxActiveClusters "
        f"{active}")
    if active < 1:
        raise AssertionError(f"a cluster of {size} CTAs does not fit")

    # 3a. each kernel against its plain version at the test shapes
    rng = np.random.default_rng(3)
    t0 = time.time()
    cases = 0
    for what, ri in ri_cases(dev, rng):
        hold_ri_histogram(hops, ri, what)
        cases += 1
    side = torch.cuda.Stream()
    ri = torch.as_tensor(rng.integers(-1, 3000, 303_104), dtype=torch.int32,
                         device=dev)
    hold_ri_histogram(hops, ri, "a side stream", stream=side)
    _, seen = one_kernel_a_call(device_events(lambda: hops.histogram(ri), 1),
                                1, "ri_histogram_kernel",
                                "ri_histogram, one call")
    log(f"[ri_histogram] kernel == plain (bitwise, bins and counts) on "
        f"{cases} cases (N = {', '.join(map(str, RI_SIZES))}; all negative;"
        f" the edge values {list(RI_EDGES)} alone and shuffled x 1000; "
        f"ri[1:], ri[2:], ri[3:] of N=10001) and on a side stream; one "
        f"call runs {seen} CUDA kernel and no other device work (profiler); "
        f"{time.time() - t0:.1f} s")
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
    t0 = time.time()
    errs, edge = [], []
    by_kernel = dict(fops.mha.kernel_launches)
    for case in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                errs.append(check_flash(
                    fops, *flash_inputs(*case, dtype, dev), causal,
                    f"{case} {dtype} causal={causal}"))
    for (b, sq, sk, h, hkv, d), causal in FLASH_EDGE:
        for dtype in (torch.float32, torch.bfloat16):
            edge.append(check_flash(
                fops, *flash_inputs(b, sq, h, hkv, d, dtype, dev, sk=sk),
                causal, f"B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} d={d} "
                        f"{dtype} causal={causal}"))
    qwen = get_arch("qwen3-1.7b")
    layer = (1, 4096, qwen.n_heads, qwen.n_kv, qwen.d_head)
    r_layer = check_flash_path(fops, *flash_inputs(*layer, torch.bfloat16,
                                                   dev), f"qwen3 layer {layer}")
    calls = len(FLASH_CASES) * 2 + len(FLASH_EDGE) + 1    # each type
    by_kernel = {k: n - by_kernel[k]
                 for k, n in fops.mha.kernel_launches.items()}
    if by_kernel != {"wgmma": calls, "simt": calls}:
        raise AssertionError(f"3c: launches by kernel {by_kernel}, want "
                             f"every bf16 call ({calls}) on the Hopper "
                             f"kernel and every f32 call on the CUDA-core "
                             f"one")
    log(f"[flash_attention] 3c: kernel == plain within atol 2e-5 (f32, "
        f"CUDA-core kernel) / 2e-2 (bf16, Hopper kernel) on the "
        f"{len(errs)} test_kernels cases (max |diff| {max(errs):.3g}) and the "
        f"{2 * len(FLASH_EDGE)} edge cases {[c for c, _ in FLASH_EDGE]} "
        f"(max |diff| {max(edge):.3g}); launches by kernel {by_kernel}; at "
        f"one qwen3-1.7b layer B, S, H, Hkv, d = {layer} causal: "
        f"{flash_readings(r_layer)}; {time.time() - t0:.1f} s with the "
        f"first launches")

    # 3d. llc_rounds against its plain loop on seeded random epochs
    t0 = time.time()
    r3d = check_llc_rounds(rops, rkernel, dev)
    log(f"[llc_rounds] 3d: cluster kernel == plain == llc_rounds_simple "
        f"(bitwise: state, stats, per-core counts) on {r3d['held']} chunks: "
        f"{r3d['cases']}, chained chunks "
        f"of {LLC_CHUNKS} rounds, the six lanes' knobs {list(LLC_LANES)}, "
        f"all-padding rounds, n_rounds, a side stream; "
        f"{time.time() - t0:.1f} s")

    # 4. the main path of the first slice: one data point at full size
    golden = json.load(open(GOLDEN))
    p = sim.SimParams(**golden["params"])
    dram = default_model()
    hist, assign = hops.histogram, kops.assign_segmented
    fit_seg, fit = kops.fit_segmented, kops.fit_masked
    dense = kops.assign
    cap_h = Capture(hops, "histogram")
    cap_a = Capture(kops, "assign_segmented")
    cap_fs = Capture(kops, "fit_segmented")
    t_llc = Timed(llc, "simulate_epoch")
    t_lern = Timed(sim, "train_model_batched")
    cap_r = RoundsCapture(rops)
    hist.launches = assign.launches = fit_seg.launches = 0
    fit.launches = dense.launches = 0
    rops.rounds.launches = 0
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
        h0, a0, f0 = hist.launches, assign.launches, fit_seg.launches
        art = sim.load_artifacts(CONFIG, MIX, p)
        res = sim.drive_lane(sim.Lane(CONFIG, MIX, policies.get(name), p,
                                      dram, deadline, art, device=dev),
                             device=dev)
        torch.cuda.synchronize()
        results[name] = res
        log(f"[main] {name}: {res.summary()} epochs {res.epochs} "
            f"wall {time.time() - t0:.1f} s launches ri_histogram "
            f"{hist.launches - h0} kmeans_fit_segmented "
            f"{fit_seg.launches - f0} kmeans_assign_segmented "
            f"{assign.launches - a0}")
    wall_main = time.time() - t_main
    launches = {"ri_histogram": hist.launches,
                "kmeans_fit_segmented": fit_seg.launches,
                "kmeans_assign_segmented": assign.launches,
                "kmeans_fit": fit.launches, "kmeans_assign": dense.launches,
                "llc_rounds": rops.rounds.launches}
    for hook in (cap_h, cap_a, cap_fs, t_llc, t_lern, cap_r):
        hook.restore()
    log(f"[main] wall {wall_main:.1f} s (before the kernel: "
        f"{WALLS_BEFORE['4']}), launches {launches}; in llc.simulate_epoch "
        f"{t_llc.seconds:.1f} s ({t_llc.calls} chunks, {t_llc.rounds} rounds, "
        f"{t_llc.seconds / max(t_llc.rounds, 1) * 1e3:.4f} ms a round, "
        f"enqueue: one llc_rounds launch a chunk); in the LERN fit "
        f"{t_lern.seconds:.2f} s ({t_lern.calls} fits); the rest is the host "
        f"loop and the waits")
    for k, v in launches.items():
        if v <= 0 and k not in ("kmeans_fit", "kmeans_assign"):
            raise AssertionError(f"the main path never launched {k}")
    if launches["ri_histogram"] != 1:
        raise AssertionError(f"phase 4 launched ri_histogram "
                             f"{launches['ri_histogram']} times, want 1 "
                             f"(one LERN fit)")
    # one segmented LERN fit: one launch for its sweeps, one for its
    # final assignment
    if (launches["kmeans_fit_segmented"], launches["kmeans_assign_segmented"],
            launches["kmeans_fit"], launches["kmeans_assign"]) != (1, 1, 0, 0):
        raise AssertionError(f"phase 4 launches {launches}, want one "
                             f"kmeans_fit_segmented and one "
                             f"kmeans_assign_segmented launch (one fit)")
    for name, res in results.items():
        check_point(name, res, golden["points"][name])
    hy, sd = results["hydra"], results["arp-cs-as-d"]
    if not (hy.dmr == 0.0 and hy.ipc_total > sd.ipc_total
            and hy.accel_br > sd.accel_br):
        raise AssertionError("test_system orderings do not hold")
    log("[main] orderings hold: hydra.dmr == 0, hydra.ipc > "
        "arp-cs-as-d.ipc, hydra.accel_br > arp-cs-as-d.accel_br")

    # 4f. the same data point through the fused epoch engine
    names = list(golden["points"])
    chk = SyncChecked(fused)
    fused.reset_counts()
    hist.launches = assign.launches = fit_seg.launches = 0
    fit.launches = dense.launches = rops.rounds.launches = 0
    t0 = time.time()
    res_f = sweep.simulate_group(CONFIG, MIX, [policies.get(n) for n in names],
                                 p, dram, deadline_cycles=deadline,
                                 engine="fused", device=dev)
    torch.cuda.synchronize()
    wall_4f = time.time() - t0
    chk.restore()
    counts_4f = fused.counts()
    log(f"[fused] phase 4f: {names} through simulate_group(engine='fused') "
        f"wall {wall_4f:.1f} s (host engine, phase 4: {wall_main:.1f} s); "
        f"super-steps on the card {counts_4f['supersteps']} (each under "
        f"set_sync_debug_mode('error'), {chk.calls} calls), escalations "
        f"{counts_4f['escalations']}, host stretches "
        f"{counts_4f['host_stretches']} ({counts_4f['host_epochs']} host "
        f"epochs); llc_rounds launches {rops.rounds.launches}")
    if counts_4f["supersteps"] == 0 or rops.rounds.launches <= 0:
        raise AssertionError(f"phase 4f ran no super-step on the card: "
                             f"{counts_4f}, {rops.rounds.launches} launches")
    for name, res in zip(names, res_f):
        check_point(f"fused {name}", res, golden["points"][name])

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
    cap_d = Capture(kops, "assign", largest=True)
    cap_fm = Capture(kops, "fit_masked", largest=True)
    t_lanes = Timed(llc, "simulate_epoch_lanes")
    t_llc = Timed(llc, "simulate_epoch")
    t_fit = [Timed(sim, "train_model_batched"),
             Timed(sim, "train_family_batched")]
    cap_r6 = RoundsCapture(rops)
    hist.launches = assign.launches = dense.launches = 0
    fit.launches = fit_seg.launches = 0
    rops.rounds.launches = 0
    t0 = time.time()
    rs = exp.run(spec, plan=plan, device=dev)
    torch.cuda.synchronize()
    wall_sys = time.time() - t0
    sys_launches = {"ri_histogram": hist.launches,
                    "kmeans_fit": fit.launches,
                    "kmeans_assign": dense.launches,
                    "kmeans_fit_segmented": fit_seg.launches,
                    "kmeans_assign_segmented": assign.launches,
                    "llc_rounds": rops.rounds.launches}
    for hook in (cap_d, cap_fm, t_lanes, t_llc, *t_fit, cap_r6):
        hook.restore()
    if sys_launches["llc_rounds"] <= 0:
        raise AssertionError("phase 6 never launched llc_rounds")
    llc_s = t_lanes.seconds + t_llc.seconds
    fit_s = sum(t.seconds for t in t_fit)
    rounds = t_lanes.rounds + t_llc.rounds
    lane_rounds = t_lanes.lane_rounds + t_llc.lane_rounds
    log(f"[system] exp.run of {len(spec)} points wall {wall_sys:.1f} s "
        f"(before the kernel: {WALLS_BEFORE['6']}), "
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
    # twelve masked fits: one launch each for the sweeps and one for the
    # final assignment
    if (hist.launches != 1 or (fit.launches, dense.launches) != (12, 12)
            or fit_seg.launches or assign.launches):
        raise AssertionError(f"the exp.run path launched {sys_launches}, "
                             f"want 1 ri_histogram and 12 kmeans_fit + 12 "
                             f"kmeans_assign launches (12 bucketed fits)")
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

    # 6f. the test_system spec through exp.run on the fused engine
    os.environ["REPRO_CACHE"] = cache + "_system_fused"
    shutil.rmtree(os.environ["REPRO_CACHE"], ignore_errors=True)
    plan_f = exp.ExecPlan(**dict(system["plan"], engine="fused"))
    chk = SyncChecked(fused)
    fused.reset_counts()
    hist.launches = assign.launches = dense.launches = 0
    fit.launches = fit_seg.launches = rops.rounds.launches = 0
    t0 = time.time()
    rs_f = exp.run(spec, plan=plan_f, device=dev)
    torch.cuda.synchronize()
    wall_6f = time.time() - t0
    chk.restore()
    counts_6f = fused.counts()
    log(f"[fused] phase 6f: exp.run of {len(spec)} points with {plan_f} "
        f"wall {wall_6f:.1f} s (host engine, phase 6: {wall_sys:.1f} s); "
        f"super-steps on the card {counts_6f['supersteps']} ({chk.calls} "
        f"calls under set_sync_debug_mode('error')), escalations "
        f"{counts_6f['escalations']}, host stretches "
        f"{counts_6f['host_stretches']} ({counts_6f['host_epochs']} host "
        f"epochs); launches llc_rounds {rops.rounds.launches}, kmeans_fit "
        f"{fit.launches}, kmeans_assign {dense.launches}, ri_histogram "
        f"{hist.launches}")
    if counts_6f["supersteps"] == 0 or rops.rounds.launches <= 0:
        raise AssertionError(f"phase 6f ran no super-step on the card: "
                             f"{counts_6f}")
    got_f = {row["policy"]: row["result"] for row in rs_f.to_rows()}
    for name, want in system["points"].items():
        compare(json.loads(json.dumps(system_point(got_f[name]))), want,
                f"system fused.{name}")
    log(f"[fused] phase 6f: all {len(got_f)} points match the golden")

    # 6b. the test_system spec through exp.run on the bucketed engine
    os.environ["REPRO_CACHE"] = cache + "_system_bucketed"
    shutil.rmtree(os.environ["REPRO_CACHE"], ignore_errors=True)
    plan_b = exp.ExecPlan(**dict(system["plan"], engine="bucketed"))
    chk = SyncChecked(fused, "_superstep_bucket")
    fused.reset_counts()
    fused.reset_phase_times()
    hist.launches = assign.launches = dense.launches = 0
    fit.launches = fit_seg.launches = rops.rounds.launches = 0
    t0 = time.time()
    rs_b = exp.run(spec, plan=plan_b, device=dev)
    torch.cuda.synchronize()
    wall_6b = time.time() - t0
    chk.restore()
    counts_6b, split_6b = fused.counts(), fused.phase_times()
    log(f"[bucketed] phase 6b: exp.run of {len(spec)} points with {plan_b} "
        f"wall {wall_6b:.1f} s (phase 6, host: {wall_sys:.1f} s; phase 6f, "
        f"fused: {wall_6f:.1f} s; each from an empty cache); bucketed "
        f"super-steps {counts_6b['bucket_supersteps']} ({chk.calls} calls "
        f"under set_sync_debug_mode('error')), escalations "
        f"{counts_6b['bucket_escalations']}, demoted groups "
        f"{counts_6b['bucket_demotions']}; phase split "
        + ", ".join(f"{k} {v:.3f}" for k, v in split_6b.items())
        + f"; launches llc_rounds {rops.rounds.launches}, kmeans_fit "
        f"{fit.launches}, kmeans_assign {dense.launches}, ri_histogram "
        f"{hist.launches}")
    if counts_6b["bucket_supersteps"] == 0 or rops.rounds.launches <= 0 \
            or {r["engine"] for r in rs_b.run_report.points.values()} != \
            {"bucketed"}:
        raise AssertionError(f"phase 6b did not run on the bucketed engine: "
                             f"{counts_6b}, {rs_b.run_report.summary()}")
    got_b = {row["policy"]: row["result"] for row in rs_b.to_rows()}
    for name, want in system["points"].items():
        compare(json.loads(json.dumps(system_point(got_b[name]))), want,
                f"system bucketed.{name}")
    log(f"[bucketed] phase 6b: all {len(got_b)} points match the golden")

    # 6c. buckets of two groups at full width: the bucketed engine (its
    # pipeline on and off) against the host engine, and its launches
    # against the per-group fused engine's, on the same points
    mixes_6c = (MIX, "moti1")
    spec6c = exp.ExperimentSpec.grid(config=CONFIG, mix=list(mixes_6c),
                                     policy=system["policies"],
                                     params="full")
    n6c = len(spec6c)
    log(f"[bucketed] phase 6c: {n6c} points, three lanes a group (every "
        f"mix keys apart, as the core slots of {list(mixes_6c)} differ; "
        f"with max_lanes=3 each mix's six policies make two groups of one "
        f"bucket key)")
    os.environ["REPRO_CACHE"] = cache + "_sweep"
    shutil.rmtree(os.environ["REPRO_CACHE"], ignore_errors=True)
    # the calibration, traces and LERN tables first, so that every leg
    # below runs on warm artifacts
    t0 = time.time()
    with lern.fit_engine_override("bucketed"):
        d6c = sim.calibrated_deadline(CONFIG, p, dram, device=dev)
        for m in mixes_6c:
            art = sim.load_artifacts(CONFIG, m, p)
            for name in system["policies"]:
                sim.Lane(CONFIG, m, policies.get(name), p, dram, d6c, art,
                         device=dev)
    log(f"[bucketed] phase 6c: artifacts in {time.time() - t0:.1f} s")
    runs6c, walls6c, launches6c = {}, {}, {}
    buckets6c = []
    drive_b = fused.drive_lanes_bucketed

    def record_bucket(groups, *a, **kw):
        buckets6c.append([f"{g[0].mix}:" + "+".join(
            lane.policy.name for lane in g) for g in groups])
        return drive_b(groups, *a, **kw)

    for leg, plan6 in (
            ("host", dict(engine="host")),
            ("fused", dict(engine="fused")),
            ("bucketed, pipeline on", dict(engine="bucketed",
                                           pipeline=True)),
            ("bucketed, pipeline off", dict(engine="bucketed",
                                            pipeline=False))):
        chk = (SyncChecked(fused, "_superstep_bucket")
               if plan6["engine"] == "bucketed" else None)
        buckets6c.clear()
        fused.drive_lanes_bucketed = record_bucket
        fused.reset_counts()
        fused.reset_phase_times()
        rops.rounds.launches = 0
        t0 = time.time()
        rs6 = exp.run(spec6c, plan=exp.ExecPlan(
            **plan6, cache=False, max_lanes=3, fit_engine="bucketed"),
            device=dev)
        torch.cuda.synchronize()
        walls6c[leg] = time.time() - t0
        fused.drive_lanes_bucketed = drive_b
        if chk is not None:
            chk.restore()
        launches6c[leg] = rops.rounds.launches
        runs6c[leg] = [dataclasses.asdict(r) for r in rs6.results()]
        c6 = fused.counts()
        log(f"[bucketed] phase 6c {leg}: wall {walls6c[leg]:.1f} s, "
            f"llc_rounds launches {launches6c[leg]}, counts {c6}"
            + ("; phase split " + ", ".join(
                f"{k} {v:.3f}" for k, v in fused.phase_times().items())
               if chk is not None else ""))
        if chk is not None:
            log(f"[bucketed] phase 6c {leg}: buckets {buckets6c}")
            if (c6["bucket_supersteps"] == 0 or c6["bucket_demotions"]
                    or max(map(len, buckets6c), default=0) < 2):
                raise AssertionError(f"phase 6c {leg}: {c6}; every bucket "
                                     f"holds one group: {buckets6c}")
    for leg in ("fused", "bucketed, pipeline on", "bucketed, pipeline off"):
        if runs6c[leg] != runs6c["host"]:
            raise AssertionError(f"phase 6c: {leg} differs from the host "
                                 f"engine")
    for leg in ("bucketed, pipeline on", "bucketed, pipeline off"):
        if not 0 < launches6c[leg] < launches6c["fused"]:
            raise AssertionError(
                f"phase 6c {leg}: {launches6c[leg]} llc_rounds launches, "
                f"the per-group fused engine {launches6c['fused']}")
    log(f"[bucketed] phase 6c: {n6c} points bitwise equal to the "
        f"host engine on every leg; llc_rounds launches bucketed "
        f"{launches6c['bucketed, pipeline on']} / "
        f"{launches6c['bucketed, pipeline off']} (pipeline on / off) "
        f"against the per-group fused engine's "
        f"{launches6c['fused']}; walls " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls6c.items()))
    run_shards_6c(exp, fused, rops, spec6c, runs6c["host"], dev, cache)
    # the forced faults on a small case (two groups of one bucket)
    small = [sweep.SweepPoint("config1", "moti1", policies.get(n),
                              sim.SimParams(n_inputs=1, max_epochs=e,
                                            subsample_target=50_000))
             for e in (40, 25) for n in ("fifo-nb", "arp-cs-as")]
    clean = [dataclasses.asdict(r) for r in sweep.run_bucketed(
        small, cache=False, device=dev)]
    from repro_torch.exp import faults as faults_mod
    for site, kind, ladder in (("bucket", "resource", "bucketed->fused"),
                               ("bucket_overflow", "demote", None)):
        fused.reset_counts()
        report = faults_mod.RunReport()
        with faults_mod.activate(faults_mod.FaultPlan.make(
                [{"site": site, "kind": kind}])):
            got = [dataclasses.asdict(r) for r in sweep.run_bucketed(
                small, cache=False, report=report, device=dev)]
        degr = [e["ladder"] for e in report.events if e["kind"] == "degrade"]
        fired = [e for e in report.events
                 if e["kind"] == "fault" and e["site"] == site]
        c6 = fused.counts()
        log(f"[bucketed] phase 6c forced {site} fault: fired {len(fired)}, "
            f"ladder {degr}, demoted groups {c6['bucket_demotions']}, "
            f"per-group fused super-steps {c6['supersteps']}; results "
            f"equal: {got == clean}")
        walked = (degr == [ladder] if ladder else
                  not degr and c6["bucket_demotions"] > 0)
        if got != clean or not fired or not walked:
            raise AssertionError(f"phase 6c forced {site} fault: {degr}, "
                                 f"{c6}, equal {got == clean}")

    # 10. fig. 17's scheduler comparison on the scheduled DRAM backend
    sched = json.load(open(SCHED))
    os.environ["REPRO_CACHE"] = cache + "_sched"
    shutil.rmtree(os.environ["REPRO_CACHE"], ignore_errors=True)
    if dataclasses.asdict(exp.PARAMS.get(sched["preset"])) != \
            sched["params"]:
        raise AssertionError("the sched golden's preset differs")
    spec10 = exp.ExperimentSpec.grid(
        config=sched["config"], mix=sched["mix"],
        policy=list(sched["policies"]), params=sched["preset"],
        dram=list(sched["drams"]), deadline_factor=sched["deadline_factor"])
    fr, sq = sched["drams"]
    for engine in sched["engines"]:
        chk = SyncChecked(fused) if engine == "fused" else None
        fused.reset_counts()
        rops.rounds.launches = 0
        t0 = time.time()
        rs10 = exp.run(spec10, plan=exp.ExecPlan(engine=engine, cache=False),
                       device=dev)
        torch.cuda.synchronize()
        wall10 = time.time() - t0
        if chk is not None:
            chk.restore()
        pts = {}
        for row in rs10.to_rows():
            pts.setdefault(row["policy"], {})[row["dram"]] = system_point(
                row["result"])
        compare(json.loads(json.dumps(pts)), sched["points"][engine],
                f"sched.{engine}")
        c10 = fused.counts()
        delta = {pol: pts[pol][sq]["summary"]["dmr"]
                 - pts[pol][fr]["summary"]["dmr"] for pol in pts}
        gap = max(abs(v) for v in delta.values())
        log(f"[sched] phase 10 {engine}: {sched['config']}/{sched['mix']} "
            f"{sched['preset']}, {fr} vs {sq}, deadline_factor "
            f"{sched['deadline_factor']}: {len(spec10)} points match the "
            f"golden, wall {wall10:.1f} s, llc_rounds launches "
            f"{rops.rounds.launches}, super-steps {c10['supersteps']}; "
            f"SQUASH - FR-FCFS dmr {delta}, sched_dmr_delta {gap!r}")
        if rops.rounds.launches <= 0 or (engine == "fused"
                                         and c10["supersteps"] == 0):
            raise AssertionError(f"phase 10 {engine}: launches "
                                 f"{rops.rounds.launches}, {c10}")
        if not gap > 0:
            raise AssertionError(f"phase 10 {engine}: sched_dmr_delta {gap}"
                                 f" is not above 0")

    # 7. LERN prediction accuracy on config7 under the bucketed engine
    acc_want = system["lern_accuracy"]
    dense.launches = hist.launches = fit.launches = 0
    fit_seg.launches = assign.launches = 0
    t0 = time.time()
    with lern.fit_engine_override(acc_want["fit_engine"]):
        model = sim.load_lern(acc_want["config"], acc_want["variant"],
                              acc_want["subsample_target"], device=dev)
    tr = sim.load_trace(acc_want["config"], acc_want["subsample_target"])
    acc = lern.prediction_accuracy(model, tr)
    log(f"[accuracy] {acc_want['config']} bucketed fit {time.time() - t0:.1f}"
        f" s, launches kmeans_fit {fit.launches} kmeans_assign "
        f"{dense.launches} kmeans_fit_segmented {fit_seg.launches} "
        f"kmeans_assign_segmented {assign.launches} ri_histogram "
        f"{hist.launches}; accuracy {acc!r} (golden "
        f"{acc_want['accuracy']!r})")
    if ((fit.launches, dense.launches, fit_seg.launches, assign.launches)
            != (20, 20, 0, 0) or hist.launches != 1):
        raise AssertionError(f"the config7 fit launched kmeans_fit "
                             f"{fit.launches}, kmeans_assign "
                             f"{dense.launches} and ri_histogram "
                             f"{hist.launches} times; want 20, 20 and 1 "
                             f"(20 bucketed fits of one trace)")
    if acc != acc_want["accuracy"] or not acc > 0.7:
        raise AssertionError(f"prediction accuracy {acc} != golden "
                             f"{acc_want['accuracy']} or not > 0.7")

    # 8. the third slice's path: prefill of qwen3-1.7b at full width; a
    # thread makes the numpy tree that 8g and 13g share (the same arch,
    # depth and seed) while the card runs phase 8
    lm_golden = json.load(open(LM_GOLDEN))
    tree_pool = ThreadPoolExecutor(max_workers=1)
    tree8 = tree_pool.submit(golden_tree, lm_golden)
    cfg = get_arch("qwen3-1.7b")
    t0 = time.time()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    torch.cuda.synchronize()
    log(f"[prefill] qwen3-1.7b, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {sum(p.numel() for p in params.parameters()):,} "
        f"parameters initialised on the card in {time.time() - t0:.1f} s")
    cap_f = Capture(fops, "mha", largest=True)
    flash = cap_f.fn
    flash.launches = dense.launches = hist.launches = assign.launches = 0
    flash.kernel_launches = dict.fromkeys(fops.KERNELS, 0)
    for b, s in ((1, 32768), (4, 4096)):
        r = prefill(cfg, params, b, s, dev)
        other = "chunked" if s >= 8192 else "dense"
        log(f"[prefill] B={b} S={s}: " + "; ".join(
            f"{name} route {r[key]['wall_s']:.2f} s ({r[key]['tok_per_s']:,.0f}"
            f" tok/s, {r[key]['flash_launches']} flash launches, max memory "
            f"{gb(r[key]['max_mem_gb'])})" for key, name in
            (("flash", "flash"), ("flash_plain", "flash with mha_plain"),
             ("plain", other))))
        launches_fp = tuple(r[key]["flash_launches"]
                            for key in ("flash", "flash_plain", "plain"))
        if launches_fp != (cfg.n_layers, 0, 0) or \
                r["held"]["layers"] != cfg.n_layers:
            raise AssertionError(f"prefill B={b} S={s}: flash launches "
                                 f"{launches_fp}, want ({cfg.n_layers}, 0, 0)"
                                 f"; {r['held']['layers']} layers held")
        log(f"[prefill] B={b} S={s}: the kernel on each of the "
            f"{cfg.n_layers} layers' q, k, v of the mha_plain forward: "
            f"{flash_readings(r['held'])} (worst layer "
            f"{r['held']['worst_layer']})")
        hold_flash(r["held"], f"prefill B={b} S={s}, layer "
                              f"{r['held']['worst_layer']}")
        rel_k = logits_close(r["flash"]["logits"], r["flash_plain"]["logits"],
                             f"prefill B={b} S={s} kernel vs mha_plain")
        rel = logits_close(r["flash"]["logits"], r["plain"]["logits"],
                           f"prefill B={b} S={s} flash vs {other} route")
        log(f"[prefill] B={b} S={s}: last-token logits of the flash route "
            f"agree with the mha_plain forward (max |diff| {rel_k:.4g} x "
            f"max|logit|) and with the {other} route ({rel:.4g}); bar "
            f"{LOGIT_RTOL:.4g}, argmax equal")
    pre_launches = flash.kernel_launches["wgmma"]
    cap_f.restore()
    if (flash.launches, flash.kernel_launches) != (
            2 * cfg.n_layers, {"wgmma": 2 * cfg.n_layers, "simt": 0}):
        raise AssertionError(f"phase 8 launched flash_attention "
                             f"{flash.launches} times, by kernel "
                             f"{flash.kernel_launches}; want "
                             f"{2 * cfg.n_layers}, all on the Hopper kernel")
    log(f"[prefill] phase 8 launches by kernel: {flash.kernel_launches}")

    # 8g. the 2-layer full-width model held to the JAX package's logits
    t0 = time.time()
    g8 = check_lm_golden(lm_golden, dev, tree8.result())
    log(f"[golden] qwen3-1.7b at full width, {lm_golden['n_layers']} "
        f"layers, B={lm_golden['batch']} S={lm_golden['seq']}: both "
        f"prefill routes and {lm_golden['decode_steps']} decode steps "
        f"match the JAX logits (worst {g8['worst_rel']:.4g} x "
        f"max|logit|, bar {LOGIT_RTOL:.4g}; argmax equal); weights onto "
        f"the card {g8['weights_s']:.1f} s (their numpy tree made during "
        f"phase 8), phase {time.time() - t0:.1f} s")

    # 9. the server answers requests on the 28-layer model
    dense.launches = flash.launches = fit.launches = 0
    fit_seg.launches = assign.launches = 0
    eng = run_engine(cfg, params, lm_golden["serve"], dev)
    serve_launches = {"kmeans_fit": fit.launches,
                      "kmeans_assign": dense.launches,
                      "kmeans_fit_segmented": fit_seg.launches,
                      "kmeans_assign_segmented": assign.launches,
                      "flash_attention": flash.launches}
    log(f"[serve] ServeEngine(slots {lm_golden['serve']['slots']}, s_max"
        f" {lm_golden['serve']['s_max']}) on the {cfg.n_layers}-layer "
        f"model: "
        f"{eng['stats']['completed']} requests answered in "
        f"{eng['clock']} engine steps, {eng['steps']} decode steps in "
        f"{eng['wall_s']:.2f} s ({eng['ms_per_step']:.2f} ms a step, "
        f"{eng['tok_per_s']:.1f} generated tok/s); stats equal the "
        f"golden: {eng['stats']}; launches {serve_launches}")
    pr = eng["profile"]
    log("[serve] profiler over 4 more decode steps: " + (
        f"wall {pr['wall_ms_per_step']:.2f} ms a step, device busy "
        f"{pr['device_ms_per_step']:.2f} ms ("
        f"{pr['device_ms_per_step'] / pr['wall_ms_per_step']:.1%}), "
        f"{pr['kernels_per_step']:.0f} kernels a step; most device "
        f"time (ms a step): {pr['top']}" if pr else "not measured"))
    if (fit.launches, dense.launches, fit_seg.launches,
            assign.launches) != (1, 1, 0, 0):
        raise AssertionError(f"the serving path launched {serve_launches}, "
                             f"want one kmeans_fit and one kmeans_assign "
                             f"launch (one profile fit)")
    del params

    # 11. the serve replay at full width: benchmarks/bench_serve.py's grid
    t0 = time.time()
    r11 = run_serve_replay(json.load(open(SERVE_REPLAY)), kops, dev)
    for c in r11["cells"]:
        b, h = c["batched"], c["host"]
        s11 = b["record"]["summary"]
        log(f"[replay] phase 11 {c['name']}: batched {b['wall_s']:.2f} s "
            f"({b['supersteps']} super-steps, none synchronising; enqueue "
            f"{b['enqueue_s']:.2f} s, reads {b['read_s']:.2f} s, the rest "
            f"scheduler feed, epoch updates and profile fits), host oracle "
            f"{h['wall_s']:.2f} s; launches batched {b['launches']}, host "
            f"{h['launches']}; peak_concurrent {s11['peak_concurrent']:g}, "
            f"refits {b['row']['refits']}, dmr {s11['dmr']!r}, p99 wait "
            f"{s11['p99_wait_steps']:g} steps, sessions_per_kstep "
            f"{s11['sessions_per_kstep']!r}; equal to the host oracle and "
            f"the golden (counters, histograms, scheduler stats)")
    bz = r11["busy"]
    log(f"[replay] phase 11: resid_dmr_delta (evict-all dmr - kv-online "
        f"dmr) {r11['resid_dmr_delta']}; profiler over 2 super-steps of "
        f"{r11['busy_cell']}: wall {bz['wall_ms']:.2f} ms a super-step "
        f"(enqueue + one read), device busy {bz['device_ms']:.2f} ms "
        f"({bz['device_ms'] / bz['wall_ms']:.1%}), {bz['kernels']:.0f} "
        f"kernels a super-step; phase {time.time() - t0:.1f} s; {nvidia_smi()}")

    # 12. the sweep process pool: phase 6c's points on POOL_JOBS workers
    # against the inline run, then the chaos suite's plans on the card
    run_phase12(spec6c, system, dev, cache, host_6c=runs6c["host"],
                walls_6c=walls6c)

    # 13. training: qwen3-1.7b train steps at full width, the training
    # golden, the Trainer's resume on the card
    r13 = run_phase13(dev, tree8.result())
    del tree8
    tree_pool.shutdown()

    # 14. the moe and ssm families: qwen2-moe-a2.7b and rwkv6-1.6b at full
    # width (prefill, the server), their goldens, compression
    run_phase14(dev, fops, kops)

    # 15. the hybrid, encdec and vlm families: paligemma-3b (its prefill on
    # the flash kernel at d = 256), zamba2-2.7b and whisper-base at full
    # width (prefill, the server), their goldens
    r15 = run_phase15(dev, fops, kops)

    # 16. the sharding layer: the dry-run's cells on a fake process group
    # (child processes on the host), and qwen3-1.7b restored onto a one-card
    # mesh as DTensor parameters, prefilling through the flash kernel on
    # its local heads and taking train steps
    r16 = run_phase16(dev, fops, r13)

    # 3b. the kernels at the shapes the paths handed them
    kernels = []
    (ri,) = cap_h.args
    err = hold_ri_histogram(hops, ri, "the main path's input")
    n = ri.shape[0]
    edges = torch.tensor([-1, 10, 100, 500], dtype=torch.int32, device=dev)
    kernels.append(kernel_row(
        "ri_histogram", "cuda", "src/repro_torch/csrc/ri_histogram.cu",
        "src/repro/kernels/ri_histogram/kernel.py:29",
        launches["ri_histogram"], err,
        time_ms(lambda: hops.histogram(ri)),
        time_ms(lambda: hops.histogram_plain(ri)),
        4 * n + 4 * n + 4 * hops.NUM_BINS, 0,
        time_ms(lambda: torch.bucketize(ri, edges)), {"N": n}))
    floor_ms = time_ms(lambda: hkernel.launch_empty(dev))
    device_ms, seen = one_kernel_a_call(
        device_events(lambda: hops.histogram(ri), 50), 50,
        "ri_histogram_kernel", "ri_histogram at the main path's input")
    empty_ms, _ = one_kernel_a_call(
        device_events(lambda: hkernel.launch_empty(dev), 50), 50,
        "ri_histogram_empty_kernel", "the empty kernel")
    kr = kernels[-1]
    log(f"[ri_histogram] at the main path's N = {n}: wrapper "
        f"{kr['ms']:.5f} ms (CUDA events around a call), kernel device time "
        f"{device_ms:.5f} ms (profiler, median over 50 calls: {seen} "
        f"kernels seen, no other device work), empty-kernel launch floor "
        f"{floor_ms:.5f} ms through ctypes "
        f"(device {empty_ms:.5f} ms), bucketize {kr['library_ms']:.5f} ms, "
        f"plain {kr['plain_ms']:.5f} ms, bound {kr['bound_ms']:.6f} ms "
        f"({kr['bound_by']})")
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
    clock = sm_clock_mhz()
    r4 = time_llc_rounds(rops, rkernel, cap_r.args, dev, clock)
    r6 = time_llc_rounds(rops, rkernel, cap_r6.args, dev, clock)
    kernels.append(kernel_row(
        "llc_rounds", "cuda", "src/repro_torch/csrc/llc_rounds.cu",
        "src/repro/core/llc.py:213", launches["llc_rounds"], 0, r4["ms"],
        r4["plain_ms"], r4["bytes"], 0, None, r4["shape"]))
    for where, r, calls in (("phase 4", r4, cap_r), ("phase 6", r6, cap_r6)):
        c = r["cluster"]
        log(f"[llc_rounds] at {where}'s largest chunk {r['shape']} (of "
            f"{calls.calls} calls, {calls.rounds} rounds): cluster kernel == "
            f"plain == llc_rounds_simple bitwise; clusters of {c['cluster']} "
            f"CTAs x {c['threads']} threads, {c['cta_sets']} sets a CTA, "
            f"{c['smem_bytes']} bytes of shared memory a CTA (SHCT tables "
            f"in it: {bool(c['smem_tables'])}), {c['group_lanes']} lanes a "
            f"set, {c['active_clusters']} clusters at once; CUDA events: "
            f"cluster {r['ms']:.4f} ms, simple "
            f"{r['simple_ms']:.4f} ms; 20 enqueued back to back: cluster "
            f"{r['queued_ms']:.4f} ms, simple {r['simple_queued_ms']:.4f} ms "
            f"a call; in turns (wall, synced): cluster "
            f"{r['turn_ms']:.4f} ms, simple {r['simple_turn_ms']:.4f} ms, "
            f"plain loop {r['plain_ms']:.2f} ms; empty launch: cluster "
            f"{r['empty_ms']:.4f} ms, simple {r['simple_empty_ms']:.4f} ms; "
            f"barrier floor (the kernel's cluster barriers alone) "
            f"{r['barrier_ms']:.4f} ms; bound "
            f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes), chain "
            f"floor {r['chain_ms']:.5f} ms ({r['shape']['R']} rounds at "
            f"{clock:.0f} MHz); none in the library")
    kernels += check_fits(kops, cap_fm.args, cap_fs.args, dev, {
        "kmeans_fit": sys_launches["kmeans_fit"],
        "kmeans_fit_segmented": launches["kmeans_fit_segmented"]})
    q, k, v = cap_f.args
    b, s, h, d = q.shape
    hkv = k.shape[2]
    r_path = check_flash_path(fops, q, k, v, "phase 8 path shape")
    err = r_path["err"]
    log(f"[flash_attention] kernel == plain at the phase 8 path shape "
        f"{tuple(q.shape)}: {flash_readings(r_path)}")
    times = time_flash(fops, q, k, v, reps=3)
    n_bytes, n_ops = flash_bound(b, s, h, hkv, d)
    kernels.append(kernel_row(
        "flash_attention", "cuda", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:70", pre_launches, err,
        times["ms"], times["plain_ms"], n_bytes, n_ops, times["library_ms"],
        {"B": b, "S": s, "H": h, "Hkv": hkv, "d": d, "dtype": "bf16"},
        peak=BF16_FLOPS))
    del q, k, v, cap_f
    # the d = 256 instance (one consumer warpgroup, one K/V stage) at one
    # paligemma-3b layer of 15a's prefill
    qv, kv, vv = flash_inputs(*VLM_LAYER, torch.bfloat16, dev)
    r256 = check_flash_path(fops, qv, kv, vv, f"paligemma layer {VLM_LAYER}")
    log(f"[flash_attention] d = 256 kernel == plain at one paligemma-3b "
        f"layer {VLM_LAYER}: {flash_readings(r256)}")
    t256 = time_flash(fops, qv, kv, vv, reps=20)
    n_bytes, n_ops = flash_bound(*VLM_LAYER)
    b, s, h, hkv, d = VLM_LAYER
    kernels.append(kernel_row(
        "flash_attention_d256", "cuda",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:70",
        r15["vlm"]["flash_launches"], r256["err"], t256["ms"],
        t256["plain_ms"], n_bytes, n_ops, t256["library_ms"],
        {"B": b, "S": s, "H": h, "Hkv": hkv, "d": d, "dtype": "bf16"},
        peak=BF16_FLOPS))
    del qv, kv, vv
    ql, kl, vl = flash_inputs(*layer, torch.bfloat16, dev)
    t4k = time_flash(fops, ql, kl, vl, reps=20)
    b4, s4 = layer[0], layer[1]
    by4, op4 = flash_bound(*layer)
    bound4 = max(by4 / HBM_BYTES_PER_S, op4 / BF16_FLOPS) * 1e3
    log(f"[flash_attention] at one qwen3 layer B={b4} S={s4}: kernel "
        f"{t4k['ms']:.4f} ms, plain {t4k['plain_ms']:.4f} ms, sdpa "
        f"{t4k['library_ms']} ms, bound {bound4:.4f} ms (operations)")
    # phase 16's launches (the DTensor prefill's local heads) at that shape
    kernels.append(kernel_row(
        "flash_attention_sharded", "cuda",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:70",
        r16["sharded"]["launches"]["wgmma"], r_layer["err"], t4k["ms"],
        t4k["plain_ms"], by4, op4, t4k["library_ms"],
        {"B": b4, "S": s4, "H": layer[2], "Hkv": layer[3], "d": layer[4],
         "dtype": "bf16"}, peak=BF16_FLOPS))
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
    # 5b. the fits of the paths through the whole-fit kernels against the
    # plain fits on the card (the route before them), in turns
    tr7 = sim.load_trace(acc_want["config"], acc_want["subsample_target"])
    serve_g = lm_golden["serve"]

    def lern_fit(trace, engine):
        with lern.fit_engine_override(engine):
            return lern.train_model_batched(trace, device=dev)

    def profile_fit():
        from repro_torch.serve import SessionProfile
        return SessionProfile.fit(np.asarray(serve_g["session_turns"]),
                                  np.asarray(serve_g["session_gaps"]),
                                  seed=serve_g["profile_seed"], device=dev)

    def plain_route(fn):
        with PlainFits(kops):
            return fn()

    for name, fn, keys in (
            (f"{CONFIG} segmented LERN fit",
             lambda: lern_fit(tr, "segmented"), fields),
            (f"{CONFIG} bucketed LERN fit", lambda: lern_fit(tr, "bucketed"),
             fields),
            (f"{acc_want['config']} bucketed LERN fit",
             lambda: lern_fit(tr7, "bucketed"), fields),
            ("serve profile fit", profile_fit, ("rc_centers", "ri_centers"))):
        got, want = fn(), plain_route(fn)
        for f in keys:
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{name}: the kernels' fit and the plain "
                                     f"fit differ in {f}")
        t = turns({"kernels": fn, "plain": lambda: plain_route(fn)}, reps=2)
        seeding = [Timed(kmeans, "_plus_plus_init_masked"),
                   Timed(kmeans, "_plus_plus_init_segmented")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = time.perf_counter() - t0
        for hook in seeding:
            hook.restore()
        log(f"[fit] {name}: through the whole-fit kernels {t['kernels']:.2f} "
            f"ms, through the plain fits on the card {t['plain']:.2f} ms (in "
            f"turns, medians of 2); equal results; of one more fit through "
            f"the kernels ({once * 1e3:.2f} ms), "
            f"{sum(h.seconds for h in seeding) * 1e3:.2f} ms on the host in "
            f"the k-means++ seeding")
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
