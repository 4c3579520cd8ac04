"""The port's whole slice against the JAX package: one paper data point
(trace -> LERN -> L-RPT -> LLC -> SimResult) through ``drive_lane`` on the
CPU, held to ``tests/_reference.py::assert_bitwise`` strength.

The reference runs in a child process.  Under the installed JAX,
``repro.core.sim.cache_load`` reaches ``repro.exp``, which needs the
``jax.experimental.enable_x64`` alias; the child installs it before any
``repro`` import, so no pytest worker ever carries it.  This file is also
that child (``python tests/test_torch_sim.py <mode> <out>``):

* ``small``  -- the three policies of ``test_drive_lane_matches_reference``
                at the small point, pickled as plain dicts;
* ``golden`` -- the numbers ``chip_smoke.py`` holds the card's run to,
                written as JSON.  Regenerate the committed golden file with
                ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py
                golden src/repro_torch/golden/config3_moti2_full.json``.
* ``system`` -- the ``tests/test_system.py`` spec through ``exp.run`` with
                ``ExecPlan(engine="host", fit_engine="bucketed")`` and the
                bucketed engine's ``prediction_accuracy`` on config7, as
                JSON: what ``chip_smoke.py`` phases 6 and 7 hold the card
                to.  Regenerate the committed file with
                ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py
                system src/repro_torch/golden/config3_moti2_full_system.json``.
* ``sweep_exp`` -- ``sweep.simulate_group(engine="host")`` results and
                ``exp.run`` records at the tiny point on both fit engines
                (``tests/test_torch_sweep.py``, ``tests/test_torch_exp.py``),
                pickled.
* ``serve``  -- ``serve.engine.ServeEngine`` runs on the reduced qwen3-1.7b
                (stats and final KV caches), ``SessionProfile.fit`` and
                ``classify``, and a scheduler drive under an injected
                ``refit`` fault (``tests/test_torch_serve.py``), pickled.
* ``kmeans_fit`` -- the JAX masked, LERN-layer and segmented k-means fits
                of the ``KMEANS_*`` cases (``tests/test_torch_kmeans_fit.py``),
                pickled.
* ``fused``  -- the JAX fused engine (``fused.drive_lanes_fused``) on the
                ``FUSED_CASES`` groups (``tests/test_torch_fused.py``),
                pickled.
* ``bucketed`` -- the JAX package's ``sweep.run_bucketed`` on the
                ``BUCKET_SWEEP`` points with the result cache off
                (``tests/test_torch_bucketed.py``), pickled.
* ``shards`` -- the JAX package's bucketed engine sharded over two forced
                host devices (``XLA_FLAGS`` with
                ``--xla_force_host_platform_device_count=2``, set by the
                caller in this child's environment only):
                ``fused.drive_lanes_bucketed(devices=2)`` on the
                ``SHARD_CASES`` buckets, and ``sweep.run_bucketed`` and
                ``exp.run`` at ``devices=2`` on the ``BUCKET_SWEEP`` points
                (``tests/test_torch_shards.py``), pickled.
* ``chaos``  -- the JAX package's ``sweep.map_points(jobs=1)`` on the
                chaos suite's four tiny points (``CHAOS``; the clean
                baseline of ``tests/test_faults.py``), from an empty cache,
                pickled: what ``tests/test_torch_faults.py`` holds the
                port's inline and pool runs to under every fault plan.
* ``sched``  -- fig. 17's scheduler comparison cell (``SCHED_CELL``) through
                ``exp.run`` on the host and fused engines, as JSON: what
                ``chip_smoke.py`` phase 10 holds the card to.  Regenerate
                the committed file with ``PYTHONPATH=src JAX_PLATFORMS=cpu
                python tests/test_torch_sim.py sched
                src/repro_torch/golden/config1_sched.json``.
* ``replay`` -- the serve replay at a small size (``REPLAY_*``): the
                ``generate`` arrays of three trace specs, both JAX
                ``replay`` engines on four presets x two admission orders,
                and one ``serve.run`` hydra-serve/v1 document
                (``tests/test_torch_replay.py``), pickled.
* ``serve_replay`` -- the four cells of ``benchmarks/bench_serve.py``'s
                full grid (``SERVE_FULL``) on both JAX engines (which must
                agree), as JSON: what ``chip_smoke.py`` phase 11 holds the
                card to.  Regenerate the committed file with
                ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py
                serve_replay src/repro_torch/golden/serve_replay_full.json``.
* ``lm_golden`` -- qwen3-1.7b at full width with its depth cut to 2 layers
                on ``convert.lm_numpy_params(cfg, seed=0)``: last-token
                logits of both prefill routes and 8 decode steps, plus the
                serving run of ``chip_smoke.py`` phase 9 (its stats depend
                on scheduling only, so the reduced config computes them), as
                JSON.  Regenerate the committed file with
                ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py
                lm_golden src/repro_torch/golden/qwen3_1_7b_w2_serve.json``.
* ``train_golden`` -- the same 2-layer full-width model (``TRAIN_GOLDEN``):
                three ``make_train_step(remat=True, lr_peak=3e-4,
                lr_warmup=1, lr_total=10)`` steps on
                ``DataPipeline(seed=0).batch(0..2)`` at B=1, S=256 (each
                step's loss, grad norm and lr), step 0's per-leaf gradient
                L2 norms (per layer for the stacked leaves), and the JAX
                package's own dense-versus-chunked attention gap in the
                loss and the gradients (``ref_gap``), as JSON: what
                ``chip_smoke.py`` phase 13g holds the card to.  Regenerate
                the committed file with ``PYTHONPATH=src JAX_PLATFORMS=cpu
                python tests/test_torch_sim.py train_golden
                src/repro_torch/golden/qwen3_1_7b_w2_train.json``.
* ``moe_golden`` / ``ssm_golden`` / ``hybrid_golden`` / ``encdec_golden`` /
                ``vlm_golden`` -- qwen2-moe-a2.7b at full width with 1
                layer, rwkv6-1.6b at full width with 2 layers, zamba2-2.7b
                with 2, whisper-base whole, paligemma-3b with 1
                (``FAMILY_GOLDENS``) on ``convert.lm_numpy_params(cfg,
                seed=0)`` and, for whisper and paligemma, the frontends'
                stand-ins ``convert.lm_numpy_embeds``: last-token logits of
                both prefill routes at B=2,
                S=256 and 8 decode steps (each with its top 8), the JAX
                package's own gaps between its routes (``ref_gap``: flash
                versus plain attention; for moe also the sorted versus
                einsum dispatch and the count of top-k selections that
                differ between the attention routes), and the serving run
                on the reduced arch, as JSON: what ``chip_smoke.py`` phase
                14g holds the card to.  Regenerate the committed files with
                ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py
                moe_golden src/repro_torch/golden/qwen2_moe_a2_7b_w1_serve.json``
                and ``... ssm_golden src/repro_torch/golden/rwkv6_1_6b_w2_serve.json``
                (``hybrid_golden zamba2_2_7b_w2_serve.json``,
                ``encdec_golden whisper_base_serve.json``, ``vlm_golden
                paligemma_3b_w1_serve.json``, in the same folder).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

CONFIG, MIX = "config3", "moti2"
SMALL = dict(n_inputs=1, max_epochs=60, subsample_target=50_000)
SMALL_DEADLINE = 2e6
FULL = dict(n_inputs=3, max_epochs=1500)
GOLDEN_POLICIES = ("hydra", "arp-cs-as-d")
# the tests/test_system.py spec
SYSTEM_POLICIES = ("fifo-nb", "arp-nb", "arp-cs-as", "arp-cs-as-d", "hydra",
                   "arp-al")
SYSTEM_PLAN = dict(engine="host", fit_engine="bucketed")
ACCURACY = dict(config="config7", variant="full", subsample_target=300_000)
# tests/test_sweep.py's point
TINY = dict(n_inputs=1, max_epochs=40, subsample_target=50_000)
TINY_DEADLINE = 2e6
EXP_POLICIES = ("fifo-nb", "arp-nb", "hydra", "arp-cs-as-d", "arp-al")


def expansion_spec(exp):
    """A spec with every kind of axis: two configs, policy transforms,
    a params preset and a SimParams override axis (``exp`` is either
    package's experiment API)."""
    return exp.ExperimentSpec.grid(
        config=["config1", "config3"], mix="moti2",
        policy=["fifo-nb", ("hydra", exp.online(50)),
                ("arp-cs-as", exp.way_partition(0x00FF, 0xFF00)),
                ("hydra", exp.lrpt("loptv3")),
                ("hydra", exp.with_apm(alpha=0.2, t_b=0.7))],
        params="smoke", llc_size_bytes=[1 << 19, 1 << 20])


def expansion(exp, sweep):
    """Each point of ``expansion_spec`` as (spec dict, axis row, point
    key)."""
    return [(pt.spec_dict(), row, sweep.point_key(pt.cache_path()))
            for pt, row in expansion_spec(exp).expand()]
# (config, mix, policies, max_epochs) groups of the sweep child: a full
# four-lane roster, lanes that finish at different epochs, and a
# geometry split (SHIP_LARGE tables)
SWEEP_GROUPS = (
    ("config1", "moti2", ("fifo-nb", "hydra", "arp-cs-as-d", "arp-al"), 40),
    ("config1", "moti1", ("arp-nb", "fifo-nb"), 200),
    ("config1", "moti1", ("arp-cs-as", "arp-cs-as-large"), 40),
)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fused-engine groups: (name, config, mix, policies, DRAM model,
# max_epochs, super-step length, max_rounds, round cap) -- fluid and
# scheduled DRAM over several super-steps, an online-LERN lane ("hydra@20":
# a 20-epoch retrain period, which cuts the super-steps at its refits), and
# a forced overflow: capacity 8 escalated to a cap of 40, below the
# 41-45 rounds some epochs of config3 need, so those super-steps replay on
# the host and the others run on the device
FUSED_CASES = (
    ("fluid", "config1", "moti2", ("fifo-nb", "hydra", "arp-cs-as-d",
                                   "arp-al"), "DDR3_1600_8x8", 40, 2, None,
     None),
    ("sched", "config1", "moti1", ("arp-nb", "hydra", "arp-cs-as"),
     "DDR4_2400_32b2r_squash", 60, 2, None, None),
    ("online", "config3", "moti2", ("hydra", "hydra@20"), "DDR3_1600_8x8",
     60, 32, None, None),
    ("overflow", "config3", "moti2", ("hydra", "arp-cs-as-d"),
     "DDR3_1600_8x8", 60, 2, 8, 40),
)
# the bucketed child's sweep at the tiny point: per mix two groups that
# share a bucket (their params differ in max_epochs only), three lanes each
# with a LERN lane; moti1 and moti2 key apart (their core slots differ)
BUCKET_SWEEP = dict(config="config1", mixes=("moti1", "moti2"),
                    policies=("fifo-nb", "arp-cs-as", "hydra"),
                    max_epochs=(40, 25))
# tests/test_faults.py's four points: config1, two mixes x two policies
# at the tiny point
CHAOS = dict(config="config1", mixes=("moti1", "moti2"),
             policies=("fifo-nb", "arp-cs-as"))
# the sharded buckets of tests/test_torch_shards.py: four groups of
# synthetic traces ((seed, lines, accesses); moti2's cores, the overflow
# tests' params) in one bucket, two groups a shard on two devices; in
# "hot" the first group hammers 8 lines, overflows a capacity of 32
# escalated to a cap of 64, and leaves its shard
SHARD_PARAMS = dict(n_inputs=1, max_epochs=12, accel_epoch_cap=400,
                    subsample_target=50_000)
SHARD_POLICIES = ("fifo-nb", "arp-cs-as")
SHARD_CASES = {
    "plain": dict(groups=((11, 4000, 1500), (12, 4000, 1500),
                          (13, 4000, 1500), (14, 4000, 1500)),
                  drive={}, cap=None),
    "hot": dict(groups=((3, 8, 2000), (4, 6000, 2000), (11, 4000, 1500),
                        (12, 4000, 1500)),
                drive=dict(k_epochs=4, max_rounds=32), cap=64),
}
# fig. 17's scheduler comparison (benchmarks/fig17_ddr.py:43-47) on its
# smoke footprint's mix, with two of its policies, at the full preset
SCHED_CELL = dict(config="config1", mix="moti1", policies=("hydra",
                                                           "fifo-nb"),
                  drams=("DDR4_2400_32b2r_frfcfs", "DDR4_2400_32b2r_squash"),
                  deadline_factor=1.0, preset="full",
                  engines=("host", "fused"))
# the serving slice: qwen3-1.7b, the serve launcher's requests and knobs
LM_ARCH = "qwen3-1.7b"
LM_GOLDEN = dict(n_layers=2, seed=0, batch=2, seq=512, decode_steps=8,
                 decode_s_max=16, n_sampled=64)
# the training golden: the serving golden's model, three train steps
TRAIN_GOLDEN = dict(n_layers=2, seed=0, batch=1, seq=256, steps=3,
                    lr_peak=3e-4, lr_warmup=1, lr_total=10, data_seed=0)
# the moe and ssm goldens: full width, depth cut, B=2, S=256
FAMILY_GOLDENS = {
    "moe_golden": dict(arch="qwen2-moe-a2.7b", n_layers=1, seed=0, batch=2,
                       seq=256, decode_steps=8, decode_s_max=16,
                       n_sampled=64),
    "ssm_golden": dict(arch="rwkv6-1.6b", n_layers=2, seed=0, batch=2,
                       seq=256, decode_steps=8, decode_s_max=16,
                       n_sampled=64),
    # the hybrid, encdec and vlm goldens: zamba2-2.7b with 2 layers (one
    # group) and the shared block, the whole whisper-base (1500 frames,
    # cross K/V primed before the decode steps), paligemma-3b with 1 layer
    # over 256 patch positions and 256 tokens (its flash route through the
    # Pallas kernel at d = 256)
    "hybrid_golden": dict(arch="zamba2-2.7b", n_layers=2, seed=0, batch=2,
                          seq=256, decode_steps=8, decode_s_max=16,
                          n_sampled=64),
    "encdec_golden": dict(arch="whisper-base", n_layers=6, seed=0, batch=2,
                          seq=256, decode_steps=8, decode_s_max=16,
                          n_sampled=64),
    "vlm_golden": dict(arch="paligemma-3b", n_layers=1, seed=0, batch=2,
                       seq=256, decode_steps=8, decode_s_max=16,
                       n_sampled=64)}
SERVE_RUN = dict(slots=4, s_max=256, max_steps=4000, token_budget=4096,
                 deadline_tokens=128, profile_seed=0)
SESSIONS = 64          # seeded session features the profile is fit on
# the serve replay at a small size (tests/test_torch_replay.py): a drifting
# Poisson trace of 300 sessions on 16 slots for at most 1024 steps (the
# kv-online cells refit at least once), the four presets under both
# admission orders, and a serve.run grid of 2 rates x 2 knobs
REPLAY_TRACE = dict(sessions=300, rate=0.5, prompt_tokens=8,
                    decode_mean=6.0, drift=dict(period=3, strength=0.6,
                                                seed=1), seed=3)
REPLAY_RUN = dict(slots=16, max_steps=1024)
REPLAY_KNOBS = ("kv-default", "kv-online", "keep-all", "evict-all")
REPLAY_ADMISSIONS = ("urgency", "fifo")
REPLAY_GRID = dict(rate=[0.5, 1.0], knobs=["kv-online", "evict-all"])
# chip_smoke.py phase 11: the full grid of benchmarks/bench_serve.py:40-60
# (6000 sessions, rates 2 and 8 x kv-online and evict-all, 128 slots, 4096
# steps), whose golden file the child's serve_replay mode writes
SERVE_FULL = dict(sessions=6000, arrival="poisson",
                  drift=dict(period=4, strength=0.5), seed=0,
                  rates=[2.0, 8.0], knobs=["kv-online", "evict-all"],
                  slots=128, max_steps=4096)
LERN_FIELDS = ("uniq", "rc_cluster", "ri_cluster", "n_uniq", "rc_centers",
               "ri_centers", "features_ri")
# the fields tests/_reference.py::assert_bitwise compares
BITWISE_FIELDS = ("epochs", "completion_cycles", "core_hit_rate",
                  "accel_hit_rate", "llc_accesses", "dram_accesses",
                  "history", "occupancy")


def small_policies(policies):
    """hydra, arp-cs-as-d and hydra online-LERN with a 20-epoch period
    (so the 21-epoch small point retrains once)."""
    return [policies.get("hydra"), policies.get("arp-cs-as-d"),
            policies.with_online(policies.get("hydra"), 20)]


def fused_policies(policies, names):
    """Policies by name; ``"base@R"`` is ``base`` with online LERN every R
    epochs (``policies`` is either package's policy module)."""
    out = []
    for name in names:
        base, _, period = name.partition("@")
        pol = policies.get(base)
        out.append(policies.with_online(pol, int(period)) if period else pol)
    return out


def fused_case_lanes(sim, policies, dram, case, **kw):
    """Fresh lanes of one FUSED_CASES group (``kw``: the port's device)."""
    _, config, mix, names, dram_name, epochs = case[:6]
    p = sim.SimParams(**dict(TINY, max_epochs=epochs))
    art = sim.load_artifacts(config, mix, p)
    return [sim.Lane(config, mix, pol, p, dram.MODELS[dram_name],
                     TINY_DEADLINE, art, **kw)
            for pol in fused_policies(policies, names)]


def drive_fused_case(fused, lanes, case):
    """``fused.drive_lanes_fused`` on one group, at the case's super-step
    length, round capacity and cap; returns the lanes' results."""
    k_epochs, max_rounds, cap = case[6:]
    saved = fused.MAX_ROUNDS_CAP
    if cap:
        fused.MAX_ROUNDS_CAP = cap
    try:
        fused.drive_lanes_fused(lanes, k_epochs=k_epochs,
                                **({"max_rounds": max_rounds}
                                   if max_rounds else {}))
    finally:
        fused.MAX_ROUNDS_CAP = saved
    return [lane.result() for lane in lanes]


def bucket_sweep_points(sim, sweep, policies):
    """BUCKET_SWEEP as SweepPoints of either package."""
    c = BUCKET_SWEEP
    return [sweep.SweepPoint(c["config"], mix, policies.get(name),
                             sim.SimParams(**dict(TINY, max_epochs=epochs)))
            for mix in c["mixes"] for epochs in c["max_epochs"]
            for name in c["policies"]]


def bucket_sweep_spec(exp, sim):
    """BUCKET_SWEEP as an ExperimentSpec of either package (the same
    points, in the same order, as ``bucket_sweep_points``)."""
    c = BUCKET_SWEEP
    return exp.ExperimentSpec.grid(
        config=c["config"], mix=list(c["mixes"]),
        policy=list(c["policies"]), params=sim.SimParams(**TINY),
        max_epochs=list(c["max_epochs"]))


def synthetic_artifacts(sim, cores, Trace, p, seed: int, n_lines: int,
                        length: int):
    """A random accelerator trace of ``length`` accesses over ``n_lines``
    lines with moti2's core streams (tests/test_fused.py's), for either
    package."""
    rng = np.random.default_rng(seed)
    tr = Trace(line=rng.integers(0, n_lines, length).astype(np.int64),
               write=rng.random(length) < 0.3,
               cycle=np.arange(length, dtype=np.int64),
               layer=np.zeros(length, np.int32), layer_names=["l0"],
               compute_cycles=length)
    profiles = [cores.PROFILES[b] for b in cores.MIXES["moti2"]]
    est = [max(1024, cores.epoch_accesses(pr, pr.ipc0, float(p.epoch_cycles))
               * p.max_epochs) for pr in profiles]
    streams = [cores.generate_stream_fast(pr, est[k], k, seed=p.seed)
               .astype(np.int64) for k, pr in enumerate(profiles)]
    return sim.Artifacts(trace=tr, profiles=profiles, est=est,
                         streams=streams)


def shard_groups(sim, policies, dram, cores, Trace, case: str, **kw):
    """Fresh lane groups of one SHARD_CASES bucket (``kw``: the port's
    device)."""
    p = sim.SimParams(**SHARD_PARAMS)
    out = []
    for seed, n_lines, length in SHARD_CASES[case]["groups"]:
        art = synthetic_artifacts(sim, cores, Trace, p, seed, n_lines,
                                  length)
        out.append([sim.Lane("synthetic", "moti2", policies.get(name), p,
                             dram.DDR3_1600, TINY_DEADLINE, art, True, **kw)
                    for name in SHARD_POLICIES])
    return out


def drive_shard_case(fused, groups, case: str, devices) -> list:
    """``fused.drive_lanes_bucketed`` on one SHARD_CASES bucket at the
    case's super-step length, round capacity and cap; returns each group's
    results as dicts."""
    c = SHARD_CASES[case]
    saved = fused.MAX_ROUNDS_CAP
    if c["cap"]:
        fused.MAX_ROUNDS_CAP = c["cap"]
    try:
        fused.drive_lanes_bucketed(groups, devices=devices, **c["drive"])
    finally:
        fused.MAX_ROUNDS_CAP = saved
    return [[dataclasses.asdict(lane.result()) for lane in g]
            for g in groups]


def chaos_points(sim, sweep, policies, mixes=CHAOS["mixes"]):
    """The chaos suite's points (mix-major), for either package."""
    p = sim.SimParams(**TINY)
    return [sweep.SweepPoint(CHAOS["config"], mix, policies.get(n), p)
            for mix in mixes for n in CHAOS["policies"]]


def sched_spec(exp):
    """SCHED_CELL as an ExperimentSpec of either package."""
    c = SCHED_CELL
    return exp.ExperimentSpec.grid(
        config=c["config"], mix=c["mix"], policy=list(c["policies"]),
        params=c["preset"], dram=list(c["drams"]),
        deadline_factor=c["deadline_factor"])


def sched_doc(exp, run, engines=SCHED_CELL["engines"]) -> dict:
    """SCHED_CELL's golden document: per engine the points as
    ``system_point``s by policy and DRAM model, each policy's SQUASH -
    FR-FCFS dmr delta, and fig. 17's ``sched_dmr_delta`` (the largest
    |delta|).  ``run(spec, engine)`` is either package's ``exp.run``."""
    c = SCHED_CELL
    fr, sq = c["drams"]
    points = {}
    for engine in engines:
        rs = run(sched_spec(exp), engine)
        pts = {}
        for row in rs.to_rows():
            pts.setdefault(row["policy"], {})[row["dram"]] = system_point(
                row["result"])
        points[engine] = pts
    first = points[engines[0]]
    delta = {pol: first[pol][sq]["summary"]["dmr"]
             - first[pol][fr]["summary"]["dmr"] for pol in c["policies"]}
    return dict(c, params=dataclasses.asdict(
        exp.PARAMS.get(c["preset"])), points=points, dmr_delta=delta,
        sched_dmr_delta=max(abs(v) for v in delta.values()))


def run_child(mode: str, out: str, cache: str, timeout: float = 600,
              env_extra: dict = None):
    """Run this file as the reference child (``env_extra`` added to its
    environment only); raise with its stderr."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", REPRO_CACHE=cache, **(env_extra or {}))
    env.pop("REPRO_DRAM", None)
    env.pop("REPRO_LERN_FIT", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                           out], env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference child failed:\n{proc.stderr[-4000:]}")


def _result_dict(res) -> dict:
    return dataclasses.asdict(res)


def golden_point(res) -> dict:
    """The fields of one SimResult that the golden file keeps."""
    return {"summary": res.summary(), "epochs": res.epochs,
            "llc_accesses": res.llc_accesses,
            "dram_accesses": res.dram_accesses,
            "completion_cycles": list(res.completion_cycles)}


def history_digest(history: dict) -> dict:
    """Per history series: [length, exact sum, min, max]."""
    import math
    return {k: [len(v), math.fsum(v), min(v, default=0.0),
                max(v, default=0.0)] for k, v in sorted(history.items())}


def system_point(res) -> dict:
    """The fields of one SimResult that the system golden file keeps."""
    return dict(golden_point(res), core_hit_rate=res.core_hit_rate,
                accel_hit_rate=res.accel_hit_rate,
                deadline_cycles=res.deadline_cycles,
                history=history_digest(res.history))


def exp_record(row) -> dict:
    """One exp.run row as plain data (the point spec and the result as
    dicts)."""
    out = {k: v for k, v in row.items() if k not in ("point", "result")}
    out["point"] = row["point"].spec_dict()
    out["result"] = dataclasses.asdict(row["result"])
    return out


def serve_requests():
    """``launch/serve.py``'s requests: 12 sessions, prompt [1, 2, 3],
    max_new 16, deadline 20 x max_new, arrivals ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [dict(session_id=i, prompt=[1, 2, 3], max_new=16,
                 deadline_steps=16 * 20, arrival=int(rng.integers(0, 32)))
            for i in range(12)]


def session_features(seed: int = 0, n: int = SESSIONS):
    """Seeded (turns per session, inter-turn gap) features."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 12, n), rng.integers(2, 800, n)


def engine_cases(serve):
    """name -> scheduler factory of the engine runs held to the
    reference (``serve`` is either package's serve layer; the port's
    needs ``device=`` and gets it through ``kw``)."""
    K = serve.SchedulerKnobs
    knobs = dict(token_budget=SERVE_RUN["token_budget"],
                 deadline_tokens=SERVE_RUN["deadline_tokens"])

    def hydra(**kw):
        prof = serve.SessionProfile.fit(*session_features(), seed=0, **kw)
        return serve.HydraKVScheduler(K(**knobs), profile=prof, **kw)

    def online(**kw):
        prof = serve.SessionProfile.fit(*session_features(), seed=0, **kw)
        return serve.HydraKVScheduler(
            K(**knobs, retrain_period=2, min_refit_sessions=4),
            profile=prof, **kw)

    return {"none": lambda **kw: None, "hydra": hydra, "online": online}


def trace_specs(serve) -> dict:
    """name -> the TraceSpecs whose ``generate`` arrays are compared:
    the replay trace (drift), plain Poisson, and bursty."""
    base = replay_trace(serve)
    return {"drift": base,
            "poisson": dataclasses.replace(base, drift=None, sessions=500),
            "bursty": dataclasses.replace(base, drift=None, sessions=800,
                                          arrival="bursty", rate=2.0,
                                          burst_factor=6.0,
                                          burst_period=64, seed=5)}


def replay_trace(serve):
    d = dict(REPLAY_TRACE)
    return serve.TraceSpec(drift=serve.MixDrift(**d.pop("drift")), **d)


def replay_spec(serve, knobs, admission="urgency"):
    return serve.ServeSpec(trace=replay_trace(serve), knobs=knobs,
                           admission=admission, **REPLAY_RUN)


def replay_grid(serve):
    return serve.grid(trace=replay_trace(serve), **REPLAY_GRID, **REPLAY_RUN)


def full_grid(serve):
    """The phase 11 cells (rate-outer x knobs-inner, as bench_serve)."""
    f = SERVE_FULL
    base = serve.TraceSpec(sessions=f["sessions"], arrival=f["arrival"],
                           drift=serve.MixDrift(**f["drift"]), seed=f["seed"])
    return serve.grid(trace=base, rate=list(f["rates"]),
                      knobs=list(f["knobs"]), slots=f["slots"],
                      max_steps=f["max_steps"])


def replay_record(res, stats) -> dict:
    """One replay outcome as plain data: counters, both histograms (as
    lists), the scheduler's stats and the summary."""
    return {"counters": dict(res.counters),
            "wait_hist": np.asarray(res.wait_hist).tolist(),
            "lat_hist": np.asarray(res.lat_hist).tolist(),
            "sched_stats": dict(stats), "summary": res.summary()}


def drive_scheduler(sched, n=64, seed=0):
    """tests/test_faults.py's scheduler drive: n sessions, an epoch update
    every 4."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        sched.keep_resident(float(rng.integers(1, 12)),
                            float(rng.integers(2, 800)))
        if (i + 1) % 4 == 0:
            sched.epoch_update(decoded_rate=float(rng.random()),
                               required_rate=1.0,
                               hbm_pressure=float(rng.random()))


def profile_cases():
    """(turns, gaps, seed) inputs of ``SessionProfile.fit``: the profile
    of tests/test_faults.py and seeded ones of 5 to 300 sessions."""
    cases = [(np.array([1, 1, 2, 4, 6, 8, 8, 12] * 4),
              np.array([2, 4, 8, 16, 64, 256, 400, 800] * 4), 0)]
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(5, 300))
        cases.append((rng.integers(1, 12, n), rng.integers(2, 800, n), seed))
    return cases


# the masked fit cases of tests/test_torch_kmeans_fit.py: (name, B, N, D,
# options).  They cover the branches of the Lloyd sums' order that the
# kmeans_fit kernel replays: D = 1 with a batch of one in order (N < 64),
# in 4 x 8 lanes (512 <= N < 4096) and in 8 lanes; D = 4 across the
# 256-row block edge; a fully masked batch row; a cluster forced empty
# (three distinct points for four clusters).
KMEANS_FIT_CASES = (
    ("b1_d1_n50", 1, 50, 1, {}), ("b1_d1_n32", 1, 32, 1, {}),
    ("b1_d1_n777", 1, 777, 1, {}), ("b1_d1_n4000", 1, 4000, 1, {}),
    ("b2_d4_n512", 2, 512, 4, {}), ("b2_d4_n513", 2, 513, 4, {}),
    ("b3_d1_n777_dead", 3, 777, 1, {"dead": 2}),
    ("b3_d4_n512_dead", 3, 512, 4, {"dead": 1}),
    ("b2_d1_n200_empty", 2, 200, 1, {"empty": True}),
    ("b1_d1_n64_empty", 1, 64, 1, {"empty": True}),
    ("b2_d4_n512_empty", 2, 512, 4, {"empty": True}))
# (name, sizes, iters) of its segmented cases: lattice segments (exact
# distance ties) that settle at different sweeps, some after the CPU's
# first 6-sweep pass; the same cut to 8 sweeps, so a segment stops at iters
KMEANS_SEG_CASES = (("stragglers", [40, 120, 17, 500, 3000, 9], 50),
                    ("reaches_iters", [40, 120, 17, 500, 3000, 9], 8))


def kmeans_fit_inputs(name: str) -> dict:
    """One masked case of KMEANS_FIT_CASES from its seed: LERN-like rows
    (L1-normalized small-integer histograms at D > 1, min-max normalized
    log counts at D = 1), ragged valid counts, zero masked rows, and the
    key seeds of its batch rows."""
    _, b, n, d, opt = next(c for c in KMEANS_FIT_CASES if c[0] == name)
    rng = np.random.default_rng(n + 10 * d + 100 * b)
    x = np.zeros((b, n, d), np.float32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        nv = 0 if i == opt.get("dead") else max(8, n - 37 * i)
        if nv == 0:
            continue
        if opt.get("empty"):
            pts = rng.random((3, d)).astype(np.float32)
            v = pts[np.arange(nv) % 3]
        elif d > 1:
            raw = rng.integers(0, 5, (nv, d)).astype(np.float32)
            v = raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)
        else:
            v = np.log1p(rng.integers(2, 400, (nv, 1))).astype(np.float32)
            v = (v - v.min()) / max(float(v.max() - v.min()), 1e-9)
        x[i, :nv] = v
        mask[i, :nv] = True
    return {"x": x, "mask": mask, "seeds": [n + i for i in range(b)]}


def kmeans_lern_inputs(n: int = 777) -> dict:
    """One layer's LERN features at capacity ``n`` (a bucket of one):
    f_ri [n, 4], f_rc [n] int32, the first n_multi rows real."""
    rng = np.random.default_rng(n)
    nm = n - 3
    f_rc = np.zeros(n, np.int32)
    f_rc[:nm] = rng.integers(2, 400, nm)
    f_ri = np.zeros((n, 4), np.int32)
    f_ri[:nm] = rng.integers(0, 5, (nm, 4))
    return {"f_ri": f_ri, "f_rc": f_rc, "n_multi": nm, "seed": n}


def kmeans_seg_inputs(sizes) -> dict:
    """The flat-segmented layout of lattice rows (tests/test_torch_lern.py's
    inputs), padded to a 2048 multiple as the LERN fit pads it."""
    rng = np.random.default_rng(len(sizes))
    off, total = [], 0
    for n in sizes:
        off.append(total)
        total += -(-n // 8) * 8
    p = max(-(-total // 2048) * 2048, 8)
    s = len(sizes)
    x = np.zeros((p, 4), np.float32)
    seg = np.full(p, s, np.int32)
    for i, n in enumerate(sizes):
        x[off[i]:off[i] + n] = np.round(rng.random((n, 4)) * 6) / 6
        seg[off[i]:off[i] + n] = i
    return {"x": x, "seg": seg, "off": np.asarray(off, np.int32),
            "cnt": np.asarray(sizes, np.int32), "seeds": list(range(s))}


def _kmeans_fit_child(out: str) -> None:
    """The JAX fits of the KMEANS_* cases (use_kernel=False, as
    tests/test_torch_kmeans.py runs them)."""
    import jax
    import jax.numpy as jnp
    from repro.core import kmeans as jkm, lern as jlern
    res = {"masked": {}, "segmented": {}}
    for name, *_ in KMEANS_FIT_CASES:
        inp = kmeans_fit_inputs(name)
        keys = jnp.stack([jax.random.PRNGKey(i) for i in inp["seeds"]])
        r = jkm.kmeans_fit_batched(jnp.asarray(inp["x"]),
                                   jnp.asarray(inp["mask"]), keys, k=4,
                                   use_kernel=False)
        res["masked"][name] = (np.asarray(r.centers), np.asarray(r.assign))
    inp = kmeans_lern_inputs()
    r = jlern._fit_layer(jnp.asarray(inp["f_ri"]), jnp.asarray(inp["f_rc"]),
                         jnp.int32(inp["n_multi"]),
                         jax.random.PRNGKey(inp["seed"]), use_kernel=False)
    res["lern"] = {k: np.asarray(v) for k, v in r.items()}
    for name, sizes, iters in KMEANS_SEG_CASES:
        inp = kmeans_seg_inputs(sizes)
        r = jkm.kmeans_fit_segmented(
            jnp.asarray(inp["x"]), jnp.asarray(inp["seg"]), inp["off"],
            inp["cnt"], jnp.stack([jax.random.PRNGKey(i)
                                   for i in inp["seeds"]]),
            n_seg=len(sizes), k=4, iters=iters, use_kernel=False)
        res["segmented"][name] = (np.asarray(r.centers), np.asarray(r.assign),
                                  int(r.n_iter))
    with open(out, "wb") as f:
        pickle.dump(res, f)


CLASSIFY_GRID = [(t, g) for t in (1.0, 2.0, 3.5, 8.0, 30.0)
                 for g in (1.0, 10.0, 64.0, 300.0, 5000.0)]


def logit_digest(logits, sample_idx) -> dict:
    """Last-token logits [B, V] (f32) as the golden file keeps them."""
    lg = np.asarray(logits, np.float64)
    top = np.argsort(-lg, axis=-1, kind="stable")[:, :8]
    m = lg.max(-1, keepdims=True)
    lse = (m[:, 0] + np.log(np.exp(lg - m).sum(-1)))
    return {"top8_idx": top.tolist(),
            "top8_val": np.take_along_axis(lg, top, -1).tolist(),
            "lse": lse.tolist(), "max_abs": np.abs(lg).max(-1).tolist(),
            "sampled": lg[:, sample_idx].tolist()}


def lm_golden_inputs(vocab: int):
    """The prompt tokens [B, S] and the sampled logit indices."""
    rng = np.random.default_rng(LM_GOLDEN["seed"])
    tokens = rng.integers(0, vocab, (LM_GOLDEN["batch"], LM_GOLDEN["seq"]))
    sample = rng.integers(0, vocab, LM_GOLDEN["n_sampled"])
    return tokens.astype(np.int32), sample


def _jax_params(cfg, tree):
    """The numpy tree as jnp arrays of the JAX init's types."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm
    shapes = jax.eval_shape(lambda: lm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)


def _jax_engine(cfg, params, sched):
    from repro.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SERVE_RUN["slots"],
                      s_max=SERVE_RUN["s_max"], scheduler=sched)
    stats = eng.run([Request(**r) for r in serve_requests()],
                    max_steps=SERVE_RUN["max_steps"])
    return eng, stats


def _serve_child(out: str) -> None:
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro import serve
    from repro.exp import faults
    from repro_torch.convert import lm_numpy_params
    from repro_torch.configs import get_arch as port_arch
    cfg = get_arch(LM_ARCH).reduced()
    params = _jax_params(cfg, lm_numpy_params(port_arch(LM_ARCH).reduced(),
                                              seed=0))
    engines = {}
    for name, make in engine_cases(serve).items():
        sched = make()
        eng, stats = _jax_engine(cfg, params, sched)
        engines[name] = {
            "stats": stats, "pos": int(eng.state.pos),
            "k": np.asarray(eng.state.kv.k.astype(jnp.float32)),
            "v": np.asarray(eng.state.kv.v.astype(jnp.float32)),
            "profile": None if sched is None else (
                sched.profile.rc_centers, sched.profile.ri_centers)}
    profiles = []
    for turns, gaps, seed in profile_cases():
        prof = serve.SessionProfile.fit(turns, gaps, seed=seed)
        profiles.append({"rc": prof.rc_centers, "ri": prof.ri_centers,
                         "classify": [prof.classify(t, g)
                                      for t, g in CLASSIFY_GRID]})
    turns, gaps, _ = profile_cases()[0]
    sched = serve.HydraKVScheduler(
        serve.SchedulerKnobs(token_budget=2048, deadline_tokens=128,
                             retrain_period=4),
        profile=serve.SessionProfile.fit(turns, gaps))
    plan = faults.FaultPlan.make([faults.FaultSpec(site="refit",
                                                   kind="raise")])
    with faults.activate(plan):
        drive_scheduler(sched)
    refit = {"stats": sched.stats(), "rc": sched.profile.rc_centers,
             "ri": sched.profile.ri_centers}
    with open(out, "wb") as f:
        pickle.dump({"engines": engines, "profiles": profiles,
                     "refit_fault": refit}, f)


def _replay_child(out: str) -> None:
    from repro import exp, serve
    from repro.serve.api import _build_scheduler
    from repro.serve.replay import replay
    traces = {}
    for name, spec in trace_specs(serve).items():
        t = serve.generate(spec)
        traces[name] = {f: getattr(t, f) for f in (
            "arrival", "turns", "gap", "prompt", "decode", "deadline",
            "cls")}
    runs = {}
    for knobs in REPLAY_KNOBS:
        for adm in REPLAY_ADMISSIONS:
            spec = replay_spec(serve, knobs, adm)
            trace = serve.generate(spec.trace)
            for engine in ("host", "batched"):
                sched = _build_scheduler(spec, spec.resolved_knobs())
                res = replay(trace, sched, slots=spec.slots,
                             max_steps=spec.max_steps, admission=adm,
                             engine=engine)
                runs[(knobs, adm, engine)] = replay_record(res,
                                                           sched.stats())
    rs = serve.run(replay_grid(serve), plan=exp.ExecPlan(cache=False))
    with open(out, "wb") as f:
        pickle.dump({"traces": traces, "runs": runs,
                     "doc": json.loads(json.dumps(serve.to_serve_doc(rs)))},
                    f)


def _serve_replay_child(out: str) -> None:
    from repro import serve
    from repro.serve.api import _build_scheduler
    from repro.serve.replay import replay
    cells = []
    for spec in full_grid(serve):
        trace = serve.generate(spec.trace)
        recs = {}
        for engine in ("host", "batched"):
            sched = _build_scheduler(spec, spec.resolved_knobs())
            res = replay(trace, sched, slots=spec.slots,
                         max_steps=spec.max_steps, admission=spec.admission,
                         engine=engine)
            recs[engine] = replay_record(res, sched.stats())
        if recs["host"] != recs["batched"]:
            raise SystemExit(f"the JAX engines disagree on {spec}")
        cells.append(dict(recs["host"], spec=spec.spec_dict()))
    doc = {"grid": SERVE_FULL, "source": "benchmarks/bench_serve.py:40-60",
           "cells": cells}
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def _lm_golden_child(out: str) -> None:
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro import serve
    from repro.models import lm
    from repro_torch.convert import lm_numpy_params
    from repro_torch.configs import get_arch as port_arch
    n = LM_GOLDEN["n_layers"]
    cfg = dc.replace(get_arch(LM_ARCH), n_layers=n)
    params = _jax_params(cfg, lm_numpy_params(
        dc.replace(port_arch(LM_ARCH), n_layers=n), seed=LM_GOLDEN["seed"]))
    tokens, sample = lm_golden_inputs(cfg.vocab)
    prefill, raw = {}, {}
    for route, flash in (("flash", True), ("plain", False)):
        fn = jax.jit(lambda p, t, f=flash: lm.forward(
            p, cfg, {"tokens": t}, use_flash=f, last_only=True))
        raw[route] = np.asarray(fn(params, jnp.asarray(tokens)))[:, 0]
        prefill[route] = logit_digest(raw[route], sample)
    gap = float(np.abs(raw["flash"] - raw["plain"]).max()
                / np.abs(raw["flash"]).max())
    state = lm.init_decode_state(params, cfg, LM_GOLDEN["batch"],
                                 LM_GOLDEN["decode_s_max"])
    step = jax.jit(lambda p, s, t: lm.decode_step(p, cfg, s, t))
    decode = {"argmax": [], "lse": [], "max_abs": []}
    for t in range(LM_GOLDEN["decode_steps"]):
        lg, state = step(params, state, jnp.asarray(tokens[:, t:t + 1]))
        d = logit_digest(np.asarray(lg)[:, 0], sample)
        decode["argmax"].append([row[0] for row in d["top8_idx"]])
        decode["lse"].append(d["lse"])
        decode["max_abs"].append(d["max_abs"])
    # phase 9: the stats depend on scheduling only (not on the logits), so
    # the reduced config's engine gives them
    small = get_arch(LM_ARCH).reduced()
    sparams = _jax_params(small, lm_numpy_params(
        port_arch(LM_ARCH).reduced(), seed=0))
    sched = engine_cases(serve)["hydra"]()
    _, stats = _jax_engine(small, sparams, sched)
    turns, gaps = session_features()
    doc = {"arch": LM_ARCH, **LM_GOLDEN, "sample_idx": sample.tolist(),
           "ref_gap": gap, "prefill": prefill, "decode": decode,
           "serve": dict(SERVE_RUN, requests=serve_requests(),
                         session_turns=turns.tolist(),
                         session_gaps=gaps.tolist(),
                         profile={"rc_centers": sched.profile.rc_centers
                                  .tolist(),
                                  "ri_centers": sched.profile.ri_centers
                                  .tolist()},
                         stats=stats)}
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def family_golden_inputs(spec: dict, vocab: int):
    """A family golden's prompt tokens [B, S] and sampled logit indices."""
    rng = np.random.default_rng(spec["seed"])
    tokens = rng.integers(0, vocab, (spec["batch"], spec["seq"]))
    sample = rng.integers(0, vocab, spec["n_sampled"])
    return tokens.astype(np.int32), sample


def _moe_topk_flips(params, cfg, tokens) -> dict:
    """The first layer's top-k selections on the flash and the plain
    attention route: how many of the B * S * k differ (the whole story at
    one layer, where the MoE follows the only attention), and the largest
    difference of a router logit between the routes (``router_gap``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention, layers as L
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    x = L.embed(params["embed"], jnp.asarray(tokens))
    sel, logit = {}, {}
    for flash in (True, False):
        h = attention.attention(
            lp["attn"], L.rmsnorm(lp["ln1"], x), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, d_head=cfg.d_head, window=cfg.window,
            rope_theta=cfg.rope_theta, use_flash=flash)
        y = L.rmsnorm(lp["ln2"], x + h)
        logits = (y.astype(jnp.float32)
                  @ lp["moe"]["router"].astype(jnp.float32))
        sel[flash] = np.asarray(jax.lax.top_k(logits, cfg.top_k)[1])
        logit[flash] = np.asarray(logits)
    return {"differ": int((sel[True] != sel[False]).sum()),
            "of": int(sel[True].size),
            "router_gap": float(np.abs(logit[True] - logit[False]).max())}


ROUTER_TOP = 8   # router logits a golden keeps of each token it records


def _recording_dispatch(moe, log: list):
    """``moe.dispatch`` that also hands the top ``ROUTER_TOP`` router
    logits of each call's tokens ([B, S, ROUTER_TOP] values and expert ids)
    to ``log`` through a debug callback; the dispatch itself is
    untouched."""
    import jax
    import jax.numpy as jnp
    dispatch = moe.dispatch

    def record(vals, idx):
        log.append((np.asarray(vals), np.asarray(idx)))

    def recording(p, x, *, top_k, capacity_factor=1.25):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        jax.debug.callback(record, *jax.lax.top_k(logits, ROUTER_TOP),
                           ordered=True)
        return dispatch(p, x, top_k=top_k, capacity_factor=capacity_factor)
    return recording


def router_rows(vals, idx) -> list:
    """The last token's recorded router logits of each batch row."""
    return [{"idx": i[-1].tolist(), "val": v[-1].tolist()}
            for v, i in zip(vals, idx)]


def _family_golden_child(mode: str, out: str) -> None:
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro import serve
    from repro.models import lm, moe
    from repro_torch.convert import lm_numpy_embeds, lm_numpy_params
    from repro_torch.configs import get_arch as port_arch
    spec = FAMILY_GOLDENS[mode]
    arch, n = spec["arch"], spec["n_layers"]
    cfg = dc.replace(get_arch(arch), n_layers=n)
    tcfg = dc.replace(port_arch(arch), n_layers=n)
    params = _jax_params(cfg, lm_numpy_params(tcfg, seed=spec["seed"]))
    tokens, sample = family_golden_inputs(spec, cfg.vocab)
    embeds = lm_numpy_embeds(tcfg, spec["batch"], spec["seed"])
    extras = {k: jnp.asarray(v, jnp.bfloat16) for k, v in embeds.items()}

    def prefill(flash):
        fn = jax.jit(lambda p, t, e: lm.forward(p, cfg, {"tokens": t, **e},
                                                use_flash=flash,
                                                last_only=True))
        return np.asarray(fn(params, jnp.asarray(tokens), extras))[:, 0]

    def decode_logits():
        state = lm.init_decode_state(params, cfg, spec["batch"],
                                     spec["decode_s_max"])
        if cfg.family == "encdec":
            state = jax.jit(lambda p, e, s: lm.prime_encdec(p, cfg, e, s))(
                params, extras["enc_embeds"], state)
        step = jax.jit(lambda p, s, t: lm.decode_step(p, cfg, s, t))
        out = []
        for t in range(spec["decode_steps"]):
            lg, state = step(params, state,
                             jnp.asarray(tokens[:, t:t + 1]))
            out.append(np.asarray(lg)[:, 0])
        return out

    raw = {"flash": prefill(True), "plain": prefill(False)}
    scale = np.abs(raw["flash"]).max()
    gaps = {"attention": float(np.abs(raw["flash"] - raw["plain"]).max()
                               / scale)}
    doc = {}
    if cfg.family == "moe":
        moe.IMPL = "einsum"
        try:
            einsum = prefill(True)
        finally:
            moe.IMPL = "sorted"
        gaps["dispatch"] = float(np.abs(raw["flash"] - einsum).max() / scale)
        flips = _moe_topk_flips(params, cfg, tokens)
        doc["router_gap"] = flips.pop("router_gap")
        doc["topk_flips"] = flips
    dec = decode_logits()
    if cfg.family == "moe" and n == 1:
        # the router's choices of the golden's tokens, recorded in a second
        # run that must give the same logits bit for bit
        log = []
        moe.dispatch, plain = _recording_dispatch(moe, log), moe.dispatch
        try:
            again = [prefill(True)] + decode_logits()
        finally:
            moe.dispatch = plain
        jax.effects_barrier()
        if not all(np.array_equal(a, b) for a, b in
                   zip([raw["flash"]] + dec, again)):
            raise SystemExit("the recording run changed the logits")
        doc["router"] = [router_rows(*rec) for rec in log]
    decode = [logit_digest(lg, sample) for lg in dec]
    # the engine's stats depend on scheduling only: the reduced arch
    small = get_arch(arch).reduced()
    sparams = _jax_params(small, lm_numpy_params(port_arch(arch).reduced(),
                                                 seed=0))
    sched = engine_cases(serve)["hydra"]()
    _, stats = _jax_engine(small, sparams, sched)
    turns, gaps_s = session_features()
    if embeds:
        # what chip_smoke.py checks its own seeded embeddings against
        doc["embeds_digest"] = {k: [float(v.astype(np.float64).sum()),
                                    float(np.abs(v).astype(np.float64).sum())]
                                for k, v in embeds.items()}
    doc.update({
        **spec, "sample_idx": sample.tolist(), "ref_gap": gaps["attention"],
        "route_gaps": gaps,
        "prefill": {r: logit_digest(v, sample) for r, v in raw.items()},
        "decode": decode,
        "serve": dict(SERVE_RUN, requests=serve_requests(),
                      session_turns=turns.tolist(),
                      session_gaps=gaps_s.tolist(),
                      profile={"rc_centers": sched.profile.rc_centers
                               .tolist(),
                               "ri_centers": sched.profile.ri_centers
                               .tolist()},
                      stats=stats)})
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def leaf_norms(tree) -> dict:
    """Each leaf's L2 norm (f64 over the f32 values), per layer for the
    stacked ``layers`` leaves, keyed by path."""
    out = {}
    for path, a in _tree_leaves(tree):
        a = np.asarray(a, np.float64)
        out[path] = ([float(np.sqrt((x * x).sum())) for x in a]
                     if path.startswith("layers/") else
                     [float(np.sqrt((a * a).sum()))])
    return out


def _tree_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def route_gap(loss_a, grads_a, loss_b, grads_b) -> dict:
    """The gap between two (loss, grads) of one model: the loss's
    relative difference and the largest max |dgrad| / max |grad| of a
    leaf (the gradients as f32 numpy trees)."""
    ga, gb = dict(_tree_leaves(grads_a)), dict(_tree_leaves(grads_b))
    return {"loss": abs(float(loss_a) - float(loss_b)) / abs(float(loss_a)),
            "grad": max(float(np.abs(ga[k] - gb[k]).max()
                              / np.abs(ga[k]).max()) for k in ga)}


def _train_golden_child(out: str) -> None:
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.data import DataPipeline
    from repro.models import attention, lm
    from repro.optim import init_opt_state
    from repro.train.step import make_train_step
    from repro_torch.convert import lm_numpy_params
    from repro_torch.configs import get_arch as port_arch
    g = TRAIN_GOLDEN
    cfg = dc.replace(get_arch(LM_ARCH), n_layers=g["n_layers"])
    params = _jax_params(cfg, lm_numpy_params(
        dc.replace(port_arch(LM_ARCH), n_layers=g["n_layers"]),
        seed=g["seed"]))
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=g["seq"],
                        global_batch=g["batch"], seed=g["data_seed"])
    batches = [{k: jnp.asarray(v) for k, v in pipe.batch(i).items()}
               for i in range(g["steps"])]

    def f32(tree):
        return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                            tree)

    def value_and_grad(chunked: bool):
        prev = attention.CHUNKED_SEQ
        attention.CHUNKED_SEQ = g["seq"] if chunked else prev
        try:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: lm.loss_fn(p, cfg, batches[0], remat=True)))(params)
        finally:
            attention.CHUNKED_SEQ = prev
        return float(loss), f32(grads)

    loss, grads = value_and_grad(False)
    gap = route_gap(loss, grads, *value_and_grad(True))
    norms = leaf_norms(grads)
    del grads
    step = jax.jit(make_train_step(cfg, remat=True, lr_peak=g["lr_peak"],
                                   lr_warmup=g["lr_warmup"],
                                   lr_total=g["lr_total"]))
    opt = init_opt_state(params)
    steps = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        steps.append({k: float(v) for k, v in m.items()})
    doc = {"arch": LM_ARCH, **g, "steps_out": steps, "grad_norms": norms,
           "ref_gap": gap}
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def _child_main(mode: str, out: str) -> None:
    import jax
    import jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _reference import run_reference
    from repro.core import policies, sim
    from repro.core.dram import default_model

    if mode == "small":
        p = sim.SimParams(**SMALL)
        res = {pol.name: _result_dict(run_reference(
            CONFIG, MIX, pol, p, deadline_cycles=SMALL_DEADLINE))
            for pol in small_policies(policies)}
        model = sim.load_lern(CONFIG, "full", SMALL["subsample_target"])
        lern = {f: getattr(model, f) for f in LERN_FIELDS}
        with open(out, "wb") as f:
            pickle.dump({"results": res, "lern": lern}, f)
    elif mode == "golden":
        p = sim.SimParams(**FULL)
        dram = default_model()
        deadline = float(sim.calibrated_deadline(CONFIG, p, dram))
        points = {name: golden_point(run_reference(
            CONFIG, MIX, policies.get(name), p, dram=dram,
            deadline_cycles=deadline)) for name in GOLDEN_POLICIES}
        doc = {"config": CONFIG, "mix": MIX, "params": FULL,
               "dram": dram.name, "deadline_cycles": deadline,
               "points": points}
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    elif mode == "system":
        from repro import exp
        from repro.core import lern
        rs = exp.run(exp.ExperimentSpec.grid(
            config=CONFIG, mix=MIX, policy=list(SYSTEM_POLICIES),
            params="full"), plan=exp.ExecPlan(**SYSTEM_PLAN))
        points = {row["policy"]: system_point(row["result"])
                  for row in rs.to_rows()}
        with lern.fit_engine_override(SYSTEM_PLAN["fit_engine"]):
            model = sim.load_lern(ACCURACY["config"], ACCURACY["variant"],
                                  ACCURACY["subsample_target"])
        tr = sim.load_trace(ACCURACY["config"], ACCURACY["subsample_target"])
        doc = {"config": CONFIG, "mix": MIX, "params": FULL,
               "dram": default_model().name, "plan": SYSTEM_PLAN,
               "policies": list(SYSTEM_POLICIES), "points": points,
               "lern_accuracy": dict(
                   ACCURACY, fit_engine=SYSTEM_PLAN["fit_engine"],
                   accuracy=lern.prediction_accuracy(model, tr))}
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    elif mode == "serve":
        _serve_child(out)
    elif mode == "lm_golden":
        _lm_golden_child(out)
    elif mode == "train_golden":
        _train_golden_child(out)
    elif mode in FAMILY_GOLDENS:
        _family_golden_child(mode, out)
    elif mode == "replay":
        _replay_child(out)
    elif mode == "serve_replay":
        _serve_replay_child(out)
    elif mode == "kmeans_fit":
        _kmeans_fit_child(out)
    elif mode == "fused":
        from repro.core import dram, fused
        res = {case[0]: [dataclasses.asdict(r) for r in drive_fused_case(
            fused, fused_case_lanes(sim, policies, dram, case), case)]
            for case in FUSED_CASES}
        with open(out, "wb") as f:
            pickle.dump(res, f)
    elif mode == "bucketed":
        from repro.core import sweep
        rs = sweep.run_bucketed(bucket_sweep_points(sim, sweep, policies),
                                cache=False)
        with open(out, "wb") as f:
            pickle.dump([dataclasses.asdict(r) for r in rs], f)
    elif mode == "shards":
        from repro import exp
        from repro.core import cores, dram, fused, sweep
        from repro.core.tracegen import Trace
        from repro.sharding import compat
        if len(jax.devices()) != 2:
            raise SystemExit(f"two host devices expected: {jax.devices()}")
        # jax 0.9 renamed shard_map's check_rep, which the reference passes
        # (src/repro/core/fused.py:1481), to check_vma: an alias, as the
        # x64 one above
        compat.shard_map = lambda f, check_rep=True, **kw: jax.shard_map(
            f, check_vma=check_rep, **kw)
        doc = {case: drive_shard_case(fused, shard_groups(
            sim, policies, dram, cores, Trace, case), case, 2)
            for case in SHARD_CASES}
        doc["run_bucketed"] = [dataclasses.asdict(r) for r in
                               sweep.run_bucketed(bucket_sweep_points(
                                   sim, sweep, policies), devices=2,
                                   cache=False)]
        doc["exp_run"] = [dataclasses.asdict(r) for r in exp.run(
            bucket_sweep_spec(exp, sim), plan=exp.ExecPlan(
                engine="bucketed", devices=2, cache=False)).results()]
        with open(out, "wb") as f:
            pickle.dump(doc, f)
    elif mode == "chaos":
        from repro.core import sweep
        rs = sweep.map_points(chaos_points(sim, sweep, policies), jobs=1)
        with open(out, "wb") as f:
            pickle.dump([dataclasses.asdict(r) for r in rs], f)
    elif mode == "sched":
        from repro import exp
        doc = sched_doc(exp, lambda spec, engine: exp.run(
            spec, plan=exp.ExecPlan(engine=engine, cache=False)))
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    elif mode == "sweep_exp":
        from repro import exp
        from repro.core import sweep
        cache = os.environ["REPRO_CACHE"]
        groups = []
        for config, mix, names, epochs in SWEEP_GROUPS:
            p = sim.SimParams(**dict(TINY, max_epochs=epochs))
            grp = sweep.simulate_group(
                config, mix, [policies.get(n) for n in names], p,
                default_model(), deadline_cycles=TINY_DEADLINE,
                engine="host")
            groups.append([dataclasses.asdict(r) for r in grp])
        recs = {"expansion": expansion(exp, sweep)}
        for fit in ("segmented", "bucketed"):
            # each engine its own cache: sim result keys omit the engine
            sim.CACHE_DIR = os.path.join(cache, fit)
            rs = exp.run(exp.ExperimentSpec.grid(
                config=CONFIG, mix=MIX, policy=list(EXP_POLICIES),
                params=sim.SimParams(**TINY)),
                plan=exp.ExecPlan(engine="host", fit_engine=fit))
            recs[fit] = [exp_record(row) for row in rs.to_rows()]
        with open(out, "wb") as f:
            pickle.dump({"sweep": groups, "exp": recs}, f)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# the tests (the port runs on the CPU in this process)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def torch_one_thread():
    """Run the port's CPU tests on one torch thread: the round loop's ops
    are small, and intra-op threads only contend (several times slower
    with the test workers side by side)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("torch_one_thread")


_SWEEP_EXP = {}


def sweep_exp_reference(tmp_path_factory) -> dict:
    """The ``sweep_exp`` child's results, run once per test process
    (``tests/test_torch_sweep.py`` and ``tests/test_torch_exp.py`` share
    them)."""
    if not _SWEEP_EXP:
        d = tmp_path_factory.mktemp("ref_sweep_exp")
        out = str(d / "sweep_exp.pkl")
        run_child("sweep_exp", out, str(d / "cache"))
        with open(out, "rb") as f:
            _SWEEP_EXP.update(pickle.load(f))
    return _SWEEP_EXP


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    out = str(d / "small.pkl")
    run_child("small", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    return tmp_path


def _port_run(policy, device="cpu"):
    from repro_torch.core import sim
    from repro_torch.core.dram import default_model
    p = sim.SimParams(**SMALL)
    art = sim.load_artifacts(CONFIG, MIX, p)
    lane = sim.Lane(CONFIG, MIX, policy, p, default_model(), SMALL_DEADLINE,
                    art, device=device)
    return sim.drive_lane(lane, device=device)


def _assert_bitwise(got, want: dict, who):
    """tests/_reference.py::assert_bitwise on the reference's dict form."""
    got_d = dataclasses.asdict(got)
    assert got.summary() == {"ipc": want["ipc_total"], "dmr": want["dmr"],
                             "core_br": want["core_br"],
                             "accel_br": want["accel_br"]}, who
    for f in BITWISE_FIELDS:
        assert got_d[f] == want[f], (who, f)
    assert got_d == want, who


@pytest.mark.parametrize("name", ["hydra", "arp-cs-as-d", "hydra-ol"])
def test_drive_lane_matches_reference(reference, port_cache, name):
    """The whole slice -- trace, LERN fit, L-RPT, LLC rounds, host loop --
    equals run_reference at assert_bitwise strength."""
    from repro_torch.core import policies
    pol = {p.name: p for p in small_policies(policies)}[name]
    _assert_bitwise(_port_run(pol), reference["results"][name], name)


def test_drive_lane_with_reference_lern(reference, port_cache):
    """The reference's own LERN model, carried across, drives the port's
    host loop and LLC engine to the reference's result (parity of
    llc/sim apart from the k-means fit)."""
    from repro_torch.convert import lern_model_from_numpy
    from repro_torch.core import policies, sim
    model = lern_model_from_numpy(**reference["lern"])
    key = (f"{CONFIG}-full-ss{SMALL['subsample_target']}-s0-"
           f"{sim._lern_tag()}")
    sim._atomic_dump(model, sim._cache_path("lern", key))
    got = _port_run(policies.get("hydra"))
    _assert_bitwise(got, reference["results"]["hydra"], "hydra/ref-lern")


def test_entry_points_raise_without_cuda(port_cache, monkeypatch):
    """Without a card, every entry point's default device raises instead
    of running on the CPU."""
    import torch
    from repro_torch.core import lern, llc, policies, sim
    from repro_torch.core.dram import default_model
    p = sim.SimParams(**SMALL)
    art = sim.load_artifacts(CONFIG, MIX, p)
    lane = sim.Lane(CONFIG, MIX, policies.get("arp-nb"), p, default_model(),
                    SMALL_DEADLINE, art, device="cpu")
    state = llc.init_state(lane.llc_cfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: sim.Lane(CONFIG, MIX, policies.get("arp-nb"), p,
                         default_model(), SMALL_DEADLINE, art),
        lambda: sim.drive_lane(lane),
        lambda: sim.calibrated_deadline(CONFIG, p, default_model()),
        lambda: sim.load_lern(CONFIG, "full", SMALL["subsample_target"]),
        lambda: lern.train_model_batched(art.trace),
        lambda: llc.init_state(lane.llc_cfg),
        lambda: llc.simulate_epoch(lane.llc_cfg, state,
                                   np.zeros((8, 1024), np.int32),
                                   np.zeros((8, 1024), np.int32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

if __name__ == "__main__":
    _child_main(sys.argv[1], sys.argv[2])
