#!/usr/bin/env python3
"""Hold and time the ``llc_rounds`` kernels on the card, and drive one small
group through both simulator engines, without the rest of
``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/llc_rounds_probe.py

It builds the port's kernels (printing ``llc_rounds``'s ``-Xptxas -v``
report per kernel), runs ``chip_smoke.check_llc_rounds`` (phase 3d: the
cluster kernel bitwise against its plain loop and against the first
design, ``llc_rounds_simple``), times both designs, the plain loop and
each design's empty launch in turns at 4 lanes x 1024 sets and 6 lanes x
2048 sets for 8, 32 and 128 rounds, and then runs config1/moti2 at a tiny
size (40 epochs, four policies) through ``sweep.simulate_group`` on the
host engine and on the fused engine (each super-step under
``torch.cuda.set_sync_debug_mode("error")``), fluid and scheduled DRAM,
and checks the two engines agree.  The card's name and power limit come
first.  A quick check of a kernel change before a full ``chip_smoke.py``
run.

    python3 tools/llc_rounds_probe.py --ablation

adds, after the hold, the ablation of a round of the cluster kernel at
phase 4's chunk shape (one lane, 128 rounds, 1024 sets, 16 ways): the
largest chunk of phase 4 itself (captured while the calibration and
hydra's data point run) and a synthetic one, each through the kernel's
stages (0: the kernel's cluster barriers, in the rounds with a sampler
event, and nothing else; 1: + the ring of
events; 2: + the way-parallel search and row updates; 3: + the SHCT reads,
deltas and clips, the kernel itself) at clusters of 2, 4, 8 and 16 CTAs,
and at 16 and 8 CTAs with 256, 512 and 1024 threads a CTA; then the
empty cluster barrier loop at 1, 2, 4, 8 and 16 CTAs (64 sets a CTA, 128
rounds: ``cluster.sync()``, a relaxed arrive and wait, and
``__syncthreads`` in its place) and the empty launch; every time is the median of 20 calls,
CUDA events around each, beside the time a call of 20 enqueued back to
back between two events (``chip_smoke.queued_ms``).

    python3 tools/llc_rounds_probe.py --walls

instead measures what the cluster design changed end to end, in one
call: the walls of chip_smoke.py's phase 4 (config3/moti2 at the full
preset, the calibration, hydra and arp-cs-as-d through ``drive_lane``)
and phase 6 (the test_system spec through ``exp.run`` on the host engine,
cache off) with the round loop on the cluster kernel and on the first
design (``llc_rounds_simple``), in turns (simple, cluster, cluster,
simple for phase 4; cluster, simple, simple, cluster for phase 6) after
one warm-up run that fills the trace, LERN and deadline caches; and in
each run the round loop's device time (CUDA events around every launch)
beside the wall.

It exits non-zero without CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SimpleRounds:
    """While active, ``llc_rounds.ops.rounds`` (and so ``rounds_one``)
    launches the first design, ``llc_rounds_simple``, in place of the
    cluster kernel: the round loop before this design."""

    def __init__(self, cs, rops, rkernel):
        self.cs, self.rops, self.rkernel = cs, rops, rkernel

    def __enter__(self):
        self.saved = self.rops.rounds

        def rounds(cfg, knobs, states, line_b, meta_b, n_rounds=None, **kw):
            rounds.launches += 1
            return self.cs.rounds_simple(self.rops, self.rkernel, cfg, knobs,
                                         states, line_b, meta_b, n_rounds)

        rounds.launches = 0
        self.rops.rounds = rounds

    def __exit__(self, *exc):
        self.rops.rounds = self.saved


class LaunchEvents:
    """Wraps ``ops.rounds`` and records CUDA events around every launch;
    ``device_s()`` is the sum of their elapsed times."""

    def __init__(self, rops):
        self.rops, self.fn, self.pairs = rops, rops.rounds, []
        rops.rounds = self

    def __call__(self, *args, **kw):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args, **kw)
        b.record()
        self.pairs.append((a, b))
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def device_s(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3

    def restore(self):
        self.rops.rounds = self.fn


def walls(cs, dev) -> dict:
    """Phases 4 and 6 with the round loop on the cluster kernel and on the
    first design, in turns, each with the round loop's device time."""
    import torch
    from repro_torch import exp
    from repro_torch.core import policies, sim
    from repro_torch.core.dram import default_model
    from repro_torch.kernels.llc_rounds import kernel as rkernel
    from repro_torch.kernels.llc_rounds import ops as rops
    golden = json.load(open(cs.GOLDEN))
    system = json.load(open(cs.SYSTEM))
    p = sim.SimParams(**golden["params"])
    dram = default_model()
    spec = exp.ExperimentSpec.grid(config=system["config"],
                                   mix=system["mix"],
                                   policy=system["policies"], params="full")
    plan = exp.ExecPlan(**dict(system["plan"], cache=False))

    def phase4():
        deadline = sim.calibrated_deadline(cs.CONFIG, p, dram, device=dev)
        for name in golden["points"]:
            art = sim.load_artifacts(cs.CONFIG, cs.MIX, p)
            res = sim.drive_lane(sim.Lane(cs.CONFIG, cs.MIX,
                                          policies.get(name), p, dram,
                                          deadline, art, device=dev),
                                 device=dev)
            cs.check_point(name, res, golden["points"][name])

    def phase6():
        rs = exp.run(spec, plan=plan, device=dev)
        got = {row["policy"]: row["result"] for row in rs.to_rows()}
        for name, want in system["points"].items():
            cs.compare(json.loads(json.dumps(cs.system_point(got[name]))),
                       want, f"system.{name}")

    def run(fn, route, deadline_cache):
        if deadline_cache:   # the calibration runs too: drop its entry
            shutil.rmtree(os.path.join(sim.cache_dir(), "deadline"),
                          ignore_errors=True)
        torch.cuda.synchronize()
        with SimpleRounds(cs, rops, rkernel) if route == "simple" \
                else contextlib.nullcontext():
            ev = LaunchEvents(rops)
            t0 = time.perf_counter()
            try:
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                ev.restore()
        return {"route": route, "wall_s": wall, "launches": len(ev.pairs),
                "round_loop_device_s": ev.device_s()}

    out = {"warm-up": run(phase4, "cluster", False)}
    phase6()       # fills the bucketed LERN fit's cache entries
    out["phase 4"] = [run(phase4, r, True)
                      for r in ("simple", "cluster", "cluster", "simple")]
    out["phase 6"] = [run(phase6, r, True)
                      for r in ("cluster", "simple", "simple", "cluster")]
    return out


def ablation(cs, rops, rkernel, dev) -> list:
    """A round of the cluster kernel taken apart at phase 4's chunk shape
    (see the module's docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import policies, sim
    from repro_torch.core.dram import default_model
    golden = json.load(open(cs.GOLDEN))
    p = sim.SimParams(**golden["params"])
    dram = default_model()
    cap = cs.RoundsCapture(rops)
    try:
        deadline = sim.calibrated_deadline(cs.CONFIG, p, dram, device=dev)
        art = sim.load_artifacts(cs.CONFIG, cs.MIX, p)
        sim.drive_lane(sim.Lane(cs.CONFIG, cs.MIX, policies.get("hydra"), p,
                                dram, deadline, art, device=dev), device=dev)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    cfg, knobs, st, line, meta, n_r = cap.args
    packed = rops.pack_knobs(knobs) if not isinstance(knobs, torch.Tensor) \
        else knobs
    valid = int((meta & 1).ne(0).sum())
    chunks = {f"phase 4's largest chunk {tuple(line.shape)}, {valid} "
              f"events": (cfg, packed, st, line, meta)}
    rng = np.random.default_rng(3)
    cfg1, kn1, st1 = cs.llc_batch(1024, cs.LLC_LANES[:1], dev)
    l1, m1 = (torch.as_tensor(a, device=dev)
              for a in cs.llc_events(rng, 1, 128, 1024))
    chunks["synthetic (1, 128, 1024), decay 0.93"] = (
        cfg1, rops.pack_knobs(kn1), st1, l1, m1)
    rows = []

    def timed(what, fn):
        try:
            ms = cs.time_ms(fn, reps=20)
        except RuntimeError as e:   # a shape that does not fit a CTA
            rows.append({"what": what, "refused": str(e)})
            print(f"[ablation] {what}: refused ({e})", flush=True)
            return
        queued = cs.queued_ms(fn)
        rows.append({"what": what, "ms": ms, "queued_ms": queued})
        print(f"[ablation] {what}: {ms:.4f} ms a call, {queued:.4f} ms a "
              f"call enqueued back to back", flush=True)

    for name, (c, k, st0, ln, mt) in chunks.items():
        scratch = cs.clone_states(st0)
        timed(f"{name}: llc_rounds_simple", lambda: cs.rounds_simple(
            rops, rkernel, c, k, scratch, ln, mt))
        for cluster in (2, 4, 8, 16):
            for stage in (0, 1, 2, 3):
                timed(f"{name}: C={cluster} stage {stage}",
                      lambda: cs.llc_shaped(rkernel, c, k, scratch, ln, mt,
                                            None, stage, cluster))
        for cluster in (16, 8):
            for threads in (256, 512, 1024):
                timed(f"{name}: C={cluster} threads={threads} stage 3",
                      lambda: cs.llc_shaped(rkernel, c, k, scratch, ln, mt,
                                            None, 3, cluster, threads))
    for cluster in (1, 2, 4, 8, 16):
        c, k, st0 = cs.llc_batch(64 * cluster, cs.LLC_LANES[:1], dev)
        # every event valid: every round ends in a barrier (stage 0 reads
        # no event)
        ln = torch.zeros((1, 128, 64 * cluster), dtype=torch.int32,
                         device=dev)
        k = rops.pack_knobs(k)
        for stage, what in ((0, "128 cluster barriers"),
                            (4, "128 relaxed cluster barriers"),
                            (5, "128 __syncthreads"), (-1, "empty")):
            timed(f"barrier loop C={cluster} (64 sets x 16 ways a CTA, "
                  f"1024 threads): {what}",
                  lambda: cs.llc_shaped(rkernel, c, k, st0, ln,
                                        torch.ones_like(ln), None, stage,
                                        cluster))
    return rows


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("llc_rounds_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    cache = os.path.join(ROOT, "build", "llc_rounds_probe_cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_CACHE"] = cache
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.llc_rounds import kernel as rkernel
    from repro_torch.kernels.llc_rounds import ops as rops
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    reports = _build.build()
    print(f"[build] nvcc {time.time() - t0:.1f} s; llc_rounds: " + "; ".join(
        f"{k}: {v}" for k, v in cs.llc_ptxas(reports["llc_rounds"]).items()),
        flush=True)
    for entries in (4096, 128 * 1024):
        print(f"[shape] 1024 sets x 16 ways, {entries} SHCT entries: "
              f"{rkernel.cluster_shape(1024, 16, entries, 5)}", flush=True)
    dev = torch.device("cuda")
    if "--walls" in sys.argv[1:]:
        for phase, rows in walls(cs, dev).items():
            print(f"[walls] {phase}: {json.dumps(rows)}", flush=True)
        print(cs.nvidia_smi(), flush=True)
        return 0
    t0 = time.time()
    r = cs.check_llc_rounds(rops, rkernel, dev)
    print(f"[3d] cluster kernel == plain == llc_rounds_simple (bitwise: "
          f"state, stats, per-core) on {r['held']} chunks: {r['cases']}; "
          f"{time.time() - t0:.1f} s", flush=True)
    if "--ablation" in sys.argv[1:]:
        print(json.dumps(ablation(cs, rops, rkernel, dev)), flush=True)
    clock = cs.sm_clock_mhz()
    rng = np.random.default_rng(5)
    rows = []
    for n_lanes, sets in ((4, 1024), (6, 2048)):
        cfg, knobs, st = cs.llc_batch(sets, cs.LLC_LANES[:n_lanes], dev)
        packed = rops.pack_knobs(knobs)
        for rounds in (8, 32, 128):
            line, meta = (torch.as_tensor(a, device=dev) for a in
                          cs.llc_events(rng, n_lanes, rounds, sets))
            t = cs.turns({
                "cluster": lambda: rops.rounds(cfg, packed, st, line, meta),
                "simple": lambda: cs.rounds_simple(rops, rkernel, cfg, packed,
                                                   st, line, meta),
                "plain": lambda: rops.lanes_plain(cfg, knobs, st, line,
                                                  meta),
                "empty": lambda: cs.llc_shaped(rkernel, cfg, packed, st,
                                               line, meta, None, -1),
                "simple_empty": lambda: rkernel.launch_empty(n_lanes, sets,
                                                             dev)},
                reps=5)
            ev = cs.time_ms(lambda: rops.rounds(cfg, packed, st, line, meta),
                            reps=20)
            ev_s = cs.time_ms(lambda: cs.rounds_simple(
                rops, rkernel, cfg, packed, st, line, meta), reps=20)
            n_bytes, chain = cs.llc_bound(cfg, n_lanes, rounds, clock)
            rows.append(dict(lanes=n_lanes, sets=sets, rounds=rounds,
                             cluster_ms=t["cluster"], cluster_events_ms=ev,
                             simple_ms=t["simple"], simple_events_ms=ev_s,
                             plain_ms=t["plain"], empty_ms=t["empty"],
                             simple_empty_ms=t["simple_empty"],
                             bound_ms=n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                             chain_ms=chain))
            print(f"[time] {rows[-1]}", flush=True)
    from repro_torch.core import dram, fused, policies, sim, sweep
    p = sim.SimParams(n_inputs=1, max_epochs=40, subsample_target=50_000)
    pols = [policies.get(n) for n in ("fifo-nb", "hydra", "arp-cs-as-d",
                                      "arp-al")]
    real = fused._superstep

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    fused._superstep = checked
    for dm in (dram.DDR3_1600, dram.DDR4_2400_SQUASH):
        out = {}
        for engine in ("host", "fused"):
            fused.reset_counts()
            rops.rounds.launches = 0
            t0 = time.time()
            out[engine] = sweep.simulate_group(
                "config1", "moti2", pols, p, dm, deadline_cycles=2e6,
                engine=engine, device=dev)
            torch.cuda.synchronize()
            print(f"[engine] {dm.name} {engine}: {time.time() - t0:.2f} s, "
                  f"llc_rounds launches {rops.rounds.launches}, "
                  f"{fused.counts()}", flush=True)
        for a, b in zip(out["host"], out["fused"]):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            bad = [k for k in da if da[k] != db[k]]
            print(f"[engine] {dm.name} {a.policy}: {a.summary()} host == "
                  f"fused: {not bad} {bad}", flush=True)
            if bad:
                return 1
    fused._superstep = real
    print(json.dumps(rows), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
