#!/usr/bin/env python3
"""Hold and time the ``llc_rounds`` kernel on the card, and drive one small
group through both simulator engines, without the rest of
``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/llc_rounds_probe.py

It builds the port's kernels (printing ``llc_rounds``'s ``-Xptxas -v``
report), runs ``chip_smoke.check_llc_rounds`` (phase 3d: the kernel
bitwise against its plain loop on seeded random epochs), times the
kernel, its plain loop and the empty launch in turns at 4 lanes x 1024
sets and 6 lanes x 2048 sets for 8, 32 and 128 rounds, and then runs
config1/moti2 at a tiny size (40 epochs, four policies) through
``sweep.simulate_group`` on the host engine and on the fused engine (each
super-step under ``torch.cuda.set_sync_debug_mode("error")``), fluid and
scheduled DRAM, and checks the two engines agree.  The card's name and
power limit come first.  A quick check of a kernel change before a full
``chip_smoke.py`` run.

    python3 tools/llc_rounds_probe.py --walls

instead measures what the kernel changed end to end, in one call: the
walls of chip_smoke.py's phase 4 (config3/moti2 at the full preset, the
calibration, hydra and arp-cs-as-d through ``drive_lane``) and phase 6
(the test_system spec through ``exp.run`` on the host engine, cache off)
with the round loop on the kernel and on its plain loop (the route before
it, run on the card), in turns (plain, kernel, kernel, plain for phase 4;
kernel, plain, kernel for phase 6) after one warm-up run that fills the
trace, LERN and deadline caches; and in each kernel run the round loop's
device time (CUDA events around every launch) beside the wall.

It exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class PlainRounds:
    """While active, ``llc_rounds.ops.rounds`` / ``rounds_one`` run the plain
    loops on the card (the round loop before the kernel)."""

    def __init__(self, rops):
        self.rops = rops

    def __enter__(self):
        self.saved = (self.rops.rounds, self.rops.rounds_one)
        self.rops.rounds = lambda cfg, knobs, st, line, meta, n=None, **kw: \
            self.rops.lanes_plain(cfg, knobs, st, line, meta, n)
        self.rops.rounds_one = self.rops.epoch_plain

    def __exit__(self, *exc):
        self.rops.rounds, self.rops.rounds_one = self.saved


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
    """Phases 4 and 6 with the kernel and with the plain loop, in turns."""
    import torch
    from repro_torch import exp
    from repro_torch.core import policies, sim
    from repro_torch.core.dram import default_model
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
        out = []
        for name in golden["points"]:
            art = sim.load_artifacts(cs.CONFIG, cs.MIX, p)
            res = sim.drive_lane(sim.Lane(cs.CONFIG, cs.MIX,
                                          policies.get(name), p, dram,
                                          deadline, art, device=dev),
                                 device=dev)
            cs.check_point(name, res, golden["points"][name])
            out.append(res)
        return out

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
        t0 = time.perf_counter()
        if route == "plain":
            with PlainRounds(rops):
                fn()
            torch.cuda.synchronize()
            return {"route": route, "wall_s": time.perf_counter() - t0}
        ev = LaunchEvents(rops)
        before = rops.rounds.launches
        try:
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ev.restore()
        return {"route": route, "wall_s": wall,
                "launches": rops.rounds.launches - before,
                "round_loop_device_s": ev.device_s()}

    out = {"warm-up": run(phase4, "kernel", False)}
    phase6()       # fills the bucketed LERN fit's cache entries
    out["phase 4"] = [run(phase4, r, True)
                      for r in ("plain", "kernel", "kernel", "plain")]
    out["phase 6"] = [run(phase6, r, True)
                      for r in ("kernel", "plain", "kernel")]
    return out


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
    print(f"[build] nvcc {time.time() - t0:.1f} s; llc_rounds: " + " | ".join(
        ln.strip() for ln in reports["llc_rounds"].splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln),
        flush=True)
    dev = torch.device("cuda")
    if "--walls" in sys.argv[1:]:
        for phase, rows in walls(cs, dev).items():
            print(f"[walls] {phase}: {json.dumps(rows)}", flush=True)
        print(cs.nvidia_smi(), flush=True)
        return 0
    t0 = time.time()
    r = cs.check_llc_rounds(rops, dev)
    print(f"[3d] kernel == plain (bitwise: state, stats, per-core) on "
          f"{r['held']} chunks: {r['cases']}; {time.time() - t0:.1f} s",
          flush=True)
    clock = cs.sm_clock_mhz()
    rng = np.random.default_rng(5)
    rows = []
    for n_lanes, sets in ((4, 1024), (6, 2048)):
        cfg, knobs, st = cs.llc_batch(sets, cs.LLC_LANES[:n_lanes], dev)
        for rounds in (8, 32, 128):
            line, meta = (torch.as_tensor(a, device=dev) for a in
                          cs.llc_events(rng, n_lanes, rounds, sets))
            t = cs.turns({
                "kernel": lambda: rops.rounds(cfg, knobs, st, line, meta),
                "plain": lambda: rops.lanes_plain(cfg, knobs, st, line,
                                                  meta),
                "empty": lambda: rkernel.launch_empty(n_lanes, sets, dev)},
                reps=5)
            ev = cs.time_ms(lambda: rops.rounds(cfg, knobs, st, line, meta),
                            reps=20)
            n_bytes, chain = cs.llc_bound(cfg, n_lanes, rounds, clock)
            rows.append(dict(lanes=n_lanes, sets=sets, rounds=rounds,
                             kernel_ms=t["kernel"], kernel_events_ms=ev,
                             plain_ms=t["plain"], empty_ms=t["empty"],
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
