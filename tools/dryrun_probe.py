#!/usr/bin/env python3
"""The dry-run of every (arch x shape) cell at both production meshes, and
``chip_smoke.py``'s phase 16 alone.

Run from the root of a checkout:

    python3 tools/dryrun_probe.py [--out DIR] [--jobs N] [--table FILE]
    python3 tools/dryrun_probe.py --profile

Without ``--profile`` it needs no card: it runs ``python -m
repro_torch.launch.dryrun --arch A --shape S [--multi-pod]`` for every cell
of ``configs.ARCHS`` x ``configs.SHAPES`` at the (16, 16) and (2, 16, 16)
meshes, ``--jobs`` cells at a time (each in its own process: the fake
process group is process-wide), into ``--out`` (a cell whose record is
there already is read, not run again, as the dry-run itself does), then
prints one row a cell -- status, the cell's seconds, the dominant roofline
term and its time on H100 constants, the per-card peak, the collective
bytes, the fallbacks -- and the wall of the whole set; ``--table`` writes
the rows as a markdown table.  It exits 1 if a cell is not ``ok`` or
``skipped``.

``--profile`` runs on the card: phase 16 (16a's two cells, 16b's restore,
prefill and train steps on DTensor parameters), then one DTensor train
step and one plain step under ``torch.profiler`` (device busy share, the
largest device times by kernel).  It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cell(arch: str, shape: str, multi_pod: bool, out: str) -> dict:
    tag = "multipod" if multi_pod else "singlepod"
    path = os.path.join(out, f"{arch}-{shape}-{tag}.json")
    t0 = time.time()
    if not os.path.exists(path):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run(cmd + (["--multi-pod"] if multi_pod else []), env=env,
                       cwd=ROOT, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, check=False)
    if not os.path.exists(path):
        return {"arch": arch, "shape": shape, "status": "FAIL",
                "error": "no record written", "mesh_tag": tag}
    rec = json.load(open(path))
    rec["mesh_tag"] = tag
    rec["probe_s"] = time.time() - t0
    return rec


def row(r: dict) -> list:
    if r["status"] != "ok":
        return [r["arch"], r["shape"], r["mesh_tag"], r["status"],
                r.get("reason", r.get("error", ""))[:60], "", "", "", ""]
    t = r["roofline"]
    return [r["arch"], r["shape"], r["mesh_tag"], "ok",
            f"{r['lower_s']:.1f}", f"{t['dominant']} "
            f"{t['bound_s'] * 1e3:.1f} ms",
            f"{r['memory']['peak_bytes'] / 1e9:.2f}",
            f"{r['collective_bytes'] / 1e9:.2f}", str(len(r["fallbacks"]))]


HEAD = ["arch", "shape", "mesh", "status", "s", "dominant (bound)",
        "peak GB/card", "coll GB/card", "fallbacks"]


def dry_runs(args) -> int:
    from repro_torch.configs import ARCHS, SHAPES
    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s, mp) for mp in (False, True) for a in ARCHS
             for s in SHAPES]
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        recs = list(pool.map(lambda c: run_cell(*c, args.out), cells))
    wall = time.time() - t0
    rows = [row(r) for r in recs]
    widths = [max(len(str(x)) for x in col) for col in zip(HEAD, *rows)]
    for r in [HEAD] + rows:
        print("  ".join(str(x).ljust(w) for x, w in zip(r, widths)))
    bad = [r for r in recs if r["status"] not in ("ok", "skipped")]
    ok = [r for r in recs if r["status"] == "ok"]
    print(f"[dryrun] {len(ok)} ok, {len(recs) - len(ok) - len(bad)} "
          f"skipped, {len(bad)} failed; cells' own seconds "
          f"{sum(r['lower_s'] for r in ok):.1f}, wall {wall:.1f} s with "
          f"{args.jobs} jobs")
    for r in bad:
        print(f"[dryrun] FAIL {r['arch']} {r['shape']} {r['mesh_tag']}: "
              f"{r.get('error')}")
    if args.table:
        with open(args.table, "w") as f:
            f.write("| " + " | ".join(HEAD) + " |\n")
            f.write("|" + "---|" * len(HEAD) + "\n")
            for r in rows:
                f.write("| " + " | ".join(str(x) for x in r) + " |\n")
    return 1 if bad else 0


def profile_steps(dev) -> None:
    """One DTensor and one plain full-width train step (after a warm one
    each) under the profiler: wall, device busy and kernels by name."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data import DataPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.sharding import param_specs, shard_tree
    from repro_torch.train import make_train_step
    from repro_torch.train.step import to_device
    t = cs.TRAIN_FULL
    cfg = get_arch("qwen3-1.7b")
    mesh = make_host_mesh(dev)
    try:
        pipe = DataPipeline(vocab=cfg.vocab, seq_len=t["seq"],
                            global_batch=t["batch"], seed=0)
        batches = [to_device(pipe.batch(i), dev) for i in range(2)]
        for name in ("dtensor", "plain"):
            params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                    device=dev)
            if name == "dtensor":
                shard_tree(params, param_specs(cfg, mesh, params), mesh)
            opt = init_opt_state(params)
            step = make_train_step(cfg, remat=True, lr_peak=t["lr_peak"],
                                   lr_warmup=t["lr_warmup"], device=dev)
            step(params, opt, batches[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(params, opt, batches[1])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kern = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            by_name = {}
            for e in kern:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
            busy = sum(by_name.values())
            print(f"[profile] {name} train step: wall {wall * 1e3:.1f} ms, "
                  f"device busy {busy:.1f} ms ({busy / (wall * 1e3):.1%}), "
                  f"{len(kern)} kernels", flush=True)
            for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
                print(f"[profile]   {ms:9.2f} ms {k[:100]}", flush=True)
            del params, opt, step, prof
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "dryrun_probe"))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--table", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    if not args.profile:
        return dry_runs(args)
    import torch
    if not torch.cuda.is_available():
        print("dryrun_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    _build.build(["flash_attention"])
    dev = torch.device("cuda")
    cs.run_phase16(dev, fops)
    profile_steps(dev)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
