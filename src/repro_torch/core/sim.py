"""Heterogeneous CPU+accelerator shared-LLC system simulator (paper §VI).

Epoch-driven: exact LLC content simulation (``llc.simulate_epoch``, torch
on the device) + fluid timing (queueing at the LLC controller and DRAM,
analytic core IPC; numpy float64 on the host, as in the JAX package).
Arbitration:

* FIFO  — all agents share LLC/DRAM queues (single class M/G/1 delay).
* ARP   — accelerator requests are prioritized at the LLC controller *and*
          down the memory path (non-preemptive priority queue formulas).
* FLASH — per-epoch toggle: accel priority while behind the deadline-derived
          progress requirement, core priority when ahead (bandwidth-only
          management; never bypasses accelerator accesses).

The APM (apm.py) modulates HyDRA's per-epoch reuse thresholds; plain "-D"
policies use the §III-C1 within-epoch switch point instead.

Entry points (``load_lern``, ``load_lern_family``, ``trace_clusters``,
``Lane``, ``drive_lane``, ``calibrated_deadline``) take ``device=`` and
default to the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import struct
import uuid
import zlib
from typing import Dict, List, Optional

import numpy as np

from .. import device as _device
from . import cores as cores_mod
from . import dramsched
from . import lern as lern_mod
from . import llc as llc_mod
from . import lrpt as lrpt_mod
from .apm import APMState, bypass_mask
from .dram import DDR3_1600, DramModel, SchedDramModel
from .lern import LernModel, train_family_batched, train_model_batched
from .llc import A_HINT, A_RAND, HW_SCALE, LLCConfig, build_rounds, pack_meta
from .lrpt import lrpt_train_hash
from .policies import Policy
from .tracegen import Trace, generate_trace
from .workloads import CONFIGS

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "..")


def cache_dir() -> str:
    """The port's artifact cache: ``<REPRO_CACHE or .cache>/torch``, a
    namespace of its own (it never reads an entry the JAX package wrote)."""
    return os.path.join(os.environ.get("REPRO_CACHE")
                        or os.path.join(_REPO, ".cache"), "torch")


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation knobs for one evaluation point.

    Frozen: presets are derived with ``dataclasses.replace``, never by
    in-place mutation, so one object can be shared and hashed into cache
    keys."""
    epoch_cycles: int = 50_000
    llc_rate: float = 0.30          # LLC controller accesses / cycle
    llc_hit_lat: float = 12.0       # tag+data
    w_cap: float = 5.0              # queue-delay cap (x unloaded latency)
    prio_cap: float = 1.5           # max priority penalty divisor for cores
    mlp_core: float = 4.0
    mlp_accel: float = 16.0
    n_inputs: int = 5
    deadline_factor: float = 1.3    # deadline = factor x standalone time
    max_epochs: int = 3000
    accel_epoch_cap: int = 5000     # accel DMA port bound per epoch
    subsample_target: int = 300_000  # max accel accesses per input
    seed: int = 0
    al_ri_th: int = 1               # deadline-agnostic LERN thresholds
    al_rc_th: int = 2
    llc_size_bytes: int = 8 * 1024 * 1024 // HW_SCALE  # scaled memory system
    llc_ways: int = 16
    record_occupancy: bool = False


@dataclasses.dataclass
class SimResult:
    policy: str
    config: str
    mix: str
    ipc_total: float                # combined cores IPC (paper throughput)
    dmr: float
    core_br: float
    accel_br: float
    core_hit_rate: float
    accel_hit_rate: float
    completion_cycles: List[float]
    deadline_cycles: float
    epochs: int
    history: Dict[str, List[float]]
    occupancy: List[List[float]]    # [(core_lines, accel_lines), ...]
    llc_accesses: float
    dram_accesses: float

    def summary(self) -> Dict[str, float]:
        return {"ipc": self.ipc_total, "dmr": self.dmr,
                "core_br": self.core_br, "accel_br": self.accel_br}


# ---------------------------------------------------------------------------
# artifact caching (traces + LERN models are deterministic & reusable)
# ---------------------------------------------------------------------------
# Every entry on disk is a checksummed, versioned envelope:
#     HYC1 | crc32(payload) as <I | payload (pickle)
# cache_load() verifies magic + crc before unpickling; anything that fails
# (torn write survivor, bit rot, a foreign file) is moved to
# <cache>/quarantine/ and reported as a miss, so the caller recomputes.
_CACHE_MAGIC = b"HYC1"

#: cache_load sentinel: "no valid entry" (None is a legitimate payload).
MISS = object()


def _faults():
    # lazy: repro_torch.exp.faults is stdlib-only, but core must stay
    # importable without the exp package initialized (import cycles)
    from ..exp import faults
    return faults


def _seal(obj) -> bytes:
    payload = pickle.dumps(obj)
    return (_CACHE_MAGIC + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
            + payload)


def _quarantine(path: str, reason: str) -> None:
    qdir = os.path.join(cache_dir(), "quarantine")
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, os.path.basename(path) + "." + uuid.uuid4().hex[:8])
    try:
        os.replace(path, dst)
    except OSError:
        try:
            os.remove(path)
        except OSError:
            pass
        dst = None
    _faults().log_event("quarantine", path=path, reason=reason,
                        quarantined_to=dst)


def _mangle(path: str, spec) -> None:
    """Apply an injected cache_read fault to the entry on disk, so the
    recovery under test is the real quarantine/recompute machinery."""
    try:
        size = os.path.getsize(path)
        if spec.kind == "truncate":
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
        elif spec.kind == "corrupt":
            with open(path, "r+b") as f:
                f.seek(max(0, size - 1))
                b = f.read(1)
                f.seek(max(0, size - 1))
                f.write(bytes([(b[0] if b else 0) ^ 0xFF]))
    except OSError:
        pass


def cache_load(path: str):
    """Read one envelope cache entry.  Returns :data:`MISS` when the
    file is absent or invalid; invalid entries are quarantined first."""
    spec = _faults().fire("cache_read", key=os.path.basename(path))
    if spec is not None and os.path.exists(path):
        _mangle(path, spec)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return MISS
    if len(blob) < 8 or blob[:4] != _CACHE_MAGIC:
        _quarantine(path, "bad_magic")
        return MISS
    (crc,) = struct.unpack("<I", blob[4:8])
    payload = blob[8:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        _quarantine(path, "crc_mismatch")
        return MISS
    try:
        return pickle.loads(payload)
    except Exception:  # any unpickling failure is a damaged entry
        _quarantine(path, "unpickle_error")
        return MISS


def _atomic_dump(obj, path: str) -> None:
    """Durably commit one envelope cache entry: write to a unique temp
    file, fsync it, rename over ``path`` -- a kill at any instant leaves
    either the old entry or the new one, never a torn one.  An injected
    ``cache_dump`` fault damages the blob (corrupt/truncate) or stops
    after half the temp file (torn), as in the JAX package."""
    blob = _seal(obj)
    spec = _faults().fire("cache_dump", key=os.path.basename(path))
    tmp = path + f".{os.getpid()}.{uuid.uuid4().hex}.tmp"
    if spec is not None:
        if spec.kind == "corrupt":
            bad = (struct.unpack("<I", blob[4:8])[0]
                   ^ 0x5EED0000 ^ _faults().plan_seed()) & 0xFFFFFFFF
            if struct.pack("<I", bad) == blob[4:8]:
                bad ^= 1
            blob = blob[:4] + struct.pack("<I", bad) + blob[8:]
        elif spec.kind == "truncate":
            blob = blob[:max(9, len(blob) // 2)]
        elif spec.kind == "torn":
            with open(tmp, "wb") as f:
                f.write(blob[:max(1, len(blob) // 2)])
                f.flush()
                os.fsync(f.fileno())
            raise _faults().InjectedFault(
                f"injected torn write at {os.path.basename(path)}")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _cache_path(kind: str, key: str) -> str:
    d = os.path.join(cache_dir(), kind)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, key + ".pkl")


def _family_k(config: str, subsample_target: int) -> int:
    """Sampling ratio shared by all configs that run the same ML model, so
    relative traffic volumes within a family stay honest (the paper's
    config-3/4 see ~4x config-1's LLC traffic for the same network)."""
    model = CONFIGS[config].model
    key = f"famk-{model}-{subsample_target}"
    path = _cache_path("trace", key)
    v = cache_load(path)
    if v is not MISS:
        return v
    worst = 0
    # drift variants are excluded: they would inflate the family worst-case
    # (period x the base accesses) and silently re-key every cached trace.
    for name, c in CONFIGS.items():
        if c.model == model and c.drift is None:
            worst = max(worst, generate_trace(c).num_accesses)
    k = max(1, -(-worst // subsample_target))
    _atomic_dump(k, path)
    return k


def load_trace(config: str, subsample_target: int) -> Trace:
    """Generate + address-sample the accelerator trace.

    Address sampling (keep every occurrence of a deterministic 1/k subset of
    lines) preserves per-line reuse counts exactly and scales reuse
    intervals ~1/k — the standard set-sampling methodology for scaled cache
    studies; temporal decimation would destroy the RC structure LERN
    learns from."""
    cfg = CONFIGS[config]
    key = f"{config}-fam{subsample_target}"
    path = _cache_path("trace", key)
    v = cache_load(path)
    if v is not MISS:
        return v
    tr = generate_trace(cfg)
    k = _family_k(config, subsample_target)
    if k > 1:
        from .lrpt import splitmix32
        keep = (splitmix32(tr.line) % np.uint32(k)) == 0
        # compress time so the sampled trace's issue rate matches the full
        # trace's (the sampled stream stands in for all traffic)
        tr = Trace(line=tr.line[keep], write=tr.write[keep],
                   cycle=tr.cycle[keep] // k, layer=tr.layer[keep],
                   layer_names=tr.layer_names,
                   compute_cycles=tr.compute_cycles // k)
    _atomic_dump(tr, path)
    return tr


def _lern_tag() -> str:
    """Cache-key suffix for LERN artifacts: ``v4`` for the default
    (segmented) fit engine; a non-default engine (``REPRO_LERN_FIT``,
    ``lern.fit_engine_override``) lands under its own tag, since the two
    engines' centres differ by FP reassociation."""
    eng = lern_mod.resolve_engine()
    return "v4" if eng == "segmented" else f"v4-{eng}"


def load_lern(config: str, lrpt_variant: str, subsample_target: int,
              seed: int = 0, device="cuda") -> LernModel:
    """Train (or load) the LERN model; a fit runs on ``device``."""
    key = f"{config}-{lrpt_variant}-ss{subsample_target}-s{seed}-{_lern_tag()}"
    path = _cache_path("lern", key)
    v = cache_load(path)
    if v is not MISS:
        return v
    tr = load_trace(config, subsample_target)
    model = train_model_batched(tr, hash_fn=lrpt_train_hash(lrpt_variant),
                                seed=seed, device=device)
    _atomic_dump(model, path)
    return model


# Family-fit regime bound for the BUCKETED engine: one family fit
# amortizes the fixed per-fit cost that dominates *tiny* traces; with
# padded capacity buckets, big traces train individually.  The
# flat-segmented engine has no padding, so the gate is lifted there.
FAMILY_MAX_ACCESSES = 64_000


def family_cap() -> float:
    """Max trace size eligible for family-batched training under the
    active LERN fit engine (unbounded for segmented)."""
    if lern_mod.resolve_engine() == "segmented":
        return float("inf")
    return FAMILY_MAX_ACCESSES


def load_lern_family(configs, lrpt_variant: str, subsample_target: int,
                     seed: int = 0, family_only: bool = False,
                     device="cuda") -> Dict[str, LernModel]:
    """Train every *uncached* config's LERN model on ``device``,
    family-batching the small ones into one fit.

    ``lern.train_family_batched`` equals ``train_model_batched`` per
    config, so results land under the same cache keys ``load_lern``
    reads.  Traces above ``family_cap()`` train alone;
    ``family_only=True`` skips them (the sweep pre-pass leaves them to
    the group tasks)."""
    out: Dict[str, LernModel] = {}
    missing = []
    for config in configs:
        key = (f"{config}-{lrpt_variant}-ss{subsample_target}-s{seed}-"
               f"{_lern_tag()}")
        path = _cache_path("lern", key)
        v = cache_load(path)
        if v is not MISS:
            out[config] = v
        else:
            missing.append((config, path))
    if missing:
        hash_fn = lrpt_train_hash(lrpt_variant)
        traces = [load_trace(c, subsample_target) for c, _ in missing]
        cap = family_cap()
        small = [i for i, tr in enumerate(traces)
                 if tr.num_accesses <= cap]
        if len(small) > 1:
            models = train_family_batched(
                [traces[i] for i in small], hash_fn=hash_fn, seed=seed,
                device=device)
            for i, model in zip(small, models):
                config, path = missing[i]
                _atomic_dump(model, path)
                out[config] = model
        else:
            small = []
        for i, (config, path) in enumerate(missing):
            if i in small or family_only:
                continue
            model = train_model_batched(traces[i], hash_fn=hash_fn,
                                        seed=seed, device=device)
            _atomic_dump(model, path)
            out[config] = model
    return out


def clusters_from_model(model: LernModel, trace: Trace, lrpt_variant: str
                        ) -> Dict[str, np.ndarray]:
    """Per-access (rc, ri) cluster ids for a whole trace in one gather
    through the packed [L, entries] table images (lrpt.pack_tables)."""
    tables = lrpt_mod.pack_tables(model, lrpt_variant)
    rc, ri = lrpt_mod.lookup_tables(tables, lrpt_variant, trace.layer,
                                    trace.line)
    return {"rc": rc.astype(np.int8), "ri": ri.astype(np.int8),
            "cold_center": model.rc_centers[:, 0].astype(np.float64)}


def trace_clusters(config: str, lrpt_variant: str, subsample_target: int,
                   device="cuda") -> Dict[str, np.ndarray]:
    """Per-access (rc, ri) cluster ids via the L-RPT, plus per-layer cold
    centers -- precomputed once (the table is static per layer)."""
    key = (f"{config}-{lrpt_variant}-ss{subsample_target}-clusters-"
           f"{_lern_tag()}")
    path = _cache_path("lern", key)
    v = cache_load(path)
    if v is not MISS:
        return v
    tr = load_trace(config, subsample_target)
    model = load_lern(config, lrpt_variant, subsample_target, device=device)
    out = clusters_from_model(model, tr, lrpt_variant)
    _atomic_dump(out, path)
    return out


# ---------------------------------------------------------------------------
# queueing helpers
# ---------------------------------------------------------------------------
def _mg1_delay(rho: float, service: float) -> float:
    rho = min(rho, 0.98)
    return rho * service / max(2.0 * (1.0 - rho), 1e-2)


# ---------------------------------------------------------------------------
# epoch-interleave keys
# ---------------------------------------------------------------------------
# Exact fixed-point analogue of the original ``linspace(0, 1, n,
# endpoint=False)`` event timestamps: segment slot i of an n-event segment
# interleaves at the rational i/n, encoded as floor(i * 2^41 / n): pure
# integer ops, so event order is exact and the same as the JAX package's.
# 2^41 keeps distinct rationals distinct for any two segments up to 2^13
# events each (key gap >= 2^41/(n_a*n_k) >= 2^15 > 0), and consecutive
# accel keys are >= 2^41/n_a apart, which exceeds PF_WHEN_OFF (~2^27.7)
# for n_a <= 2^13 — so a DPCP prefetch always lands between its trigger
# and the next accel access, like the old 1e-4 float offset.  Residual
# cross-segment key collisions resolve by stable segment order on both
# every side identically.
WHEN_BITS = 41
# DPCP prefetches trail their triggering access by the old 1e-4 offset,
# quantized to the same fixed point.
PF_WHEN_OFF = int(1e-4 * (1 << WHEN_BITS))


def when_keys(n: int) -> np.ndarray:
    """int64 interleave keys for an ``n``-event epoch segment."""
    return (np.arange(n, dtype=np.int64) << WHEN_BITS) // n


# ---------------------------------------------------------------------------
# main simulation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Artifacts:
    """Policy-independent simulation inputs for one (config, mix, params).

    Deterministic in their key, so several policies can share them."""
    trace: Trace
    profiles: List
    est: List[int]
    streams: List[np.ndarray]


def load_artifacts(config: str, mix: str, p: SimParams,
                   core_traffic: bool = True) -> Artifacts:
    tr = load_trace(config, p.subsample_target)
    profiles = [cores_mod.PROFILES[b] for b in cores_mod.MIXES[mix]]
    streams: List[np.ndarray] = []
    est: List[int] = []
    if core_traffic:
        et = float(p.epoch_cycles)
        est = [max(1024, cores_mod.epoch_accesses(pr, pr.ipc0, et)
                   * p.max_epochs) for pr in profiles]
        for k, pr in enumerate(profiles):
            s = cores_mod.generate_stream_fast(pr, est[k], k, seed=p.seed)
            streams.append(s.astype(np.int64))
    return Artifacts(trace=tr, profiles=profiles, est=est, streams=streams)


class Lane:
    """One policy's epoch-by-epoch simulation state.

    ``begin_epoch`` covers arbitration, admission, APM thresholds and
    event-list construction; ``finish_epoch`` consumes the LLC stats and
    does the fluid-timing update and progress bookkeeping.  The host loop
    is numpy float64, exactly as in the JAX package; only the LLC state
    and the LERN fit live on ``device``.  The caller owns the LLC state and
    the engine calls (``drive_lane``).

    Per-lane RNG draws (AFRp hints, core write flags) replay the exact
    draw order of the original ``run`` so results stay bitwise-identical.
    """

    def __init__(self, config: str, mix: str, policy: Policy, params: SimParams,
                 dram: DramModel, deadline: float, art: Artifacts,
                 core_traffic: bool = True, device="cuda"):
        self.device = _device.resolve(device)
        self.config, self.mix = config, mix
        self.policy, self.p, self.dram = policy, params, dram
        self.core_traffic = core_traffic
        p = params
        self.et = float(p.epoch_cycles)
        rng = np.random.default_rng(p.seed)

        self.tr = art.trace
        self.m_total = self.tr.num_accesses
        need_lern = policy.accel_predictor == "lern"
        self.clusters = (trace_clusters(config, policy.lrpt_variant,
                                        p.subsample_target, self.device)
                         if need_lern else None)
        # online-LERN (``*-ol`` policies): refit clusters every R epochs
        # from the observed epoch trace and swap the L-RPT images in place.
        # An infinite period degenerates bitwise to the offline policy.
        r = policy.retrain_period
        self._retrain_every = (max(int(r), 1) if need_lern and r is not None
                               and np.isfinite(r) and r > 0 else None)
        if self._retrain_every is not None:
            self._lern_model = load_lern(config, policy.lrpt_variant,
                                         p.subsample_target,
                                         device=self.device)
            self._train_hash = lrpt_train_hash(policy.lrpt_variant)
            self._win_ranges: List[tuple] = []
            # own copy: trace_clusters results may be shared across lanes
            self.clusters = {k: np.array(v) for k, v in self.clusters.items()}
        self.afr_hints = ((rng.random(self.m_total) < policy.afr_p)
                          if policy.accel_predictor == "random" else None)

        self.profiles = art.profiles
        self.n_cores = len(art.profiles)
        self.streams = art.streams
        self.writes: List[np.ndarray] = []
        if core_traffic:
            for k, pr in enumerate(art.profiles):
                self.writes.append(rng.random(art.est[k]) < pr.write_frac)

        self.deadline = float(deadline)
        self.period = self.deadline  # 10-IPS-style periodic arrival

        cw, aw = (policy.way_partition or (0xFFFF, 0xFFFF))
        self.llc_cfg = LLCConfig(
            size_bytes=p.llc_size_bytes, ways=p.llc_ways,
            core_bypass=policy.core_bypass, accel_mode=policy.accel_mode,
            shared_predictor=policy.shared_predictor,
            core_way_mask=cw, accel_way_mask=aw, ship=policy.ship_params)

        self.apm = APMState(m_total=self.m_total, deadline=self.deadline,
                            epoch_len=self.et, params=policy.apm)

        # --- dynamic state (names kept from the original loop) -------------
        self.ipc = np.array([pr.ipc0 for pr in art.profiles])
        self.hr_core = 0.5
        self.hr_accel = 0.3
        self.amal = 200.0
        self.stream_pos = np.zeros(self.n_cores, dtype=np.int64)

        self.input_idx = 0
        self.pos = 0                 # accesses completed in current input
        self.input_start = 0.0
        self.completions: List[float] = []
        self.now = 0.0
        self.ri_th, self.rc_th, self.special = p.al_ri_th, p.al_rc_th, False
        if policy.hydra:
            self.ri_th, self.rc_th, self.special = 3, -1, False  # conservative

        self.total_instr = 0.0
        self.total_core_hits = 0
        self.total_core_miss = 0
        self.total_core_byp = 0
        self.total_accel_hits = 0
        self.total_accel_miss = 0
        self.total_accel_byp = 0
        self.total_accel_acc = 0
        self.total_llc = 0.0
        self.total_dram = 0.0
        self.hist: Dict[str, List[float]] = {k: [] for k in (
            "accel_rate", "requirement", "ri_th", "rc_th", "core_ipc", "amal")}
        self.occ: List[List[float]] = []

        self.epoch = 0
        self.llc_capacity = p.llc_rate * self.et
        self.s_llc = 1.0 / p.llc_rate
        self.dram_cap = dram.rate * self.et
        self.cm_prev = 0.0
        self.pf_prev = 0.0
        # per-epoch scratch carried from begin_epoch to finish_epoch
        self._n_a = 0
        self._shed_core = np.ones(self.n_cores)
        self._accel_prio = False
        # scheduled DRAM backend: per-lane bank state (host twin of the
        # fused carry's bank-state block; core/dramsched.py)
        self.dsched = (dramsched.host_init(dram)
                       if isinstance(dram, SchedDramModel) else None)
        self._et_i = int(p.epoch_cycles)

    @property
    def active(self) -> bool:
        return (self.epoch < self.p.max_epochs
                and self.input_idx < self.p.n_inputs)

    def begin_epoch(self):
        """Advance to this epoch's event list: ``(line, meta)`` ordered
        arrays for build_rounds, or ``None`` when the epoch is empty."""
        p, policy, apm, et = self.p, self.policy, self.apm, self.et
        tr = self.tr

        # ---- arbitration mode -----------------------------------------
        arrived = self.now >= self.input_start
        remaining = self.m_total - self.pos
        flash_accel_prio = False
        if policy.arbitration == "flash":
            req = apm.ma_global
            done_rate = (self.pos / max((self.now - self.input_start) / et, 1.0)
                         if arrived else req)
            flash_accel_prio = done_rate < req
        accel_prio = (policy.arbitration == "arp") or flash_accel_prio
        self._accel_prio = accel_prio

        # ---- accelerator admission ------------------------------------
        # bounded by (a) DMA queue depth / achieved latency, (b) its DRAM
        # share (misses must fit the epoch's DRAM budget), (c) LLC slot cap.
        if arrived and remaining > 0:
            miss_rate_a = max(1.0 - self.hr_accel, 0.05)
            if accel_prio:
                dram_share_a = self.dram_cap     # fills issued first
            else:
                dram_share_a = max(self.dram_cap - self.cm_prev - self.pf_prev,
                                   0.1 * self.dram_cap)
            demand_a = min(remaining,
                           int(p.mlp_accel * et / max(self.amal, 1.0)),
                           int(dram_share_a / miss_rate_a),
                           p.accel_epoch_cap)
        else:
            demand_a = 0

        # ---- core demand ------------------------------------------------
        n_c = np.array([cores_mod.epoch_accesses(pr, self.ipc[k], et)
                        if self.core_traffic else 0
                        for k, pr in enumerate(self.profiles)], dtype=np.int64)

        # ---- LLC controller bandwidth / shedding -------------------------
        total_demand = demand_a + int(n_c.sum())
        shed_core = np.ones(self.n_cores)
        n_a = demand_a
        if total_demand > self.llc_capacity:
            if accel_prio:
                n_a = min(demand_a, int(self.llc_capacity))
                rem = self.llc_capacity - n_a
                f = rem / max(int(n_c.sum()), 1)
                shed_core[:] = min(f, 1.0)
            else:
                f = self.llc_capacity / total_demand
                n_a = int(demand_a * f)
                shed_core[:] = f
        n_c = (n_c * shed_core).astype(np.int64)
        self._n_a = n_a
        self._shed_core = shed_core

        # ---- HyDRA / APM epoch decision -----------------------------------
        switch_point = -1
        if policy.deadline_aware and not policy.hydra:
            # §III-C1: bypass starts after t x required accesses complete
            switch_point = int(policy.asth_t * apm.ma_global)
        if policy.hydra and arrived and remaining > 0:
            rt = max((self.input_start + self.deadline) - self.now, et)
            elapsed = max(self.deadline - rt, 0.0)
            ma_past = ((self.m_total - remaining) * et / elapsed
                       if elapsed >= et else apm.ma_global)
            mr_i = 1.0 - self.hr_core
            ma_i = apm.epoch_requirement(remaining, rt, mr_i, ma_past)
            th = apm.bypass_thresholds(ma_i)
            ma_hat = p.mlp_accel * et / max(self.amal, 1.0)
            self.ri_th, self.rc_th, self.special = apm.reuse_thresholds(
                ma_hat, ma_i, th)
            self.hist["requirement"].append(ma_i)
        else:
            self.hist["requirement"].append(apm.ma_global if arrived else 0.0)

        # ---- build the epoch event list -----------------------------------
        ev_line = []
        ev_accel = []
        ev_write = []
        ev_hint = []
        ev_pf = []
        ev_src = []
        ev_when = []
        if n_a > 0:
            sl = slice(self.pos, self.pos + n_a)
            if self._retrain_every is not None:
                self._win_ranges.append((self.pos, self.pos + n_a))
            lines_a = tr.line[sl].astype(np.int64)
            writes_a = tr.write[sl]
            if policy.accel_mode == A_HINT and self.clusters is not None:
                layer_now = int(tr.layer[self.pos])
                hints = bypass_mask(
                    self.clusters["rc"][sl], self.clusters["ri"][sl],
                    self.ri_th, self.rc_th, self.special,
                    float(self.clusters["cold_center"][layer_now]))
            elif policy.accel_mode == A_RAND:
                hints = self.afr_hints[sl]
            else:
                hints = np.zeros(n_a, dtype=bool)
            ev_line.append(lines_a)
            ev_accel.append(np.ones(n_a, bool))
            ev_write.append(writes_a)
            ev_hint.append(hints)
            ev_pf.append(np.zeros(n_a, bool))
            ev_src.append(np.zeros(n_a, np.int64))
            ev_when.append(when_keys(n_a))
            if policy.dpcp:
                ev_line.append(lines_a + 1)
                ev_accel.append(np.ones(n_a, bool))
                ev_write.append(np.zeros(n_a, bool))
                ev_hint.append(np.zeros(n_a, bool))
                ev_pf.append(np.ones(n_a, bool))
                ev_src.append(np.zeros(n_a, np.int64))
                ev_when.append(when_keys(n_a) + PF_WHEN_OFF)
        for k in range(self.n_cores):
            nk = int(n_c[k])
            if nk == 0:
                continue
            sl = slice(int(self.stream_pos[k]), int(self.stream_pos[k]) + nk)
            ev_line.append(self.streams[k][sl])
            ev_accel.append(np.zeros(nk, bool))
            ev_write.append(self.writes[k][sl])
            ev_hint.append(np.zeros(nk, bool))
            ev_pf.append(np.zeros(nk, bool))
            ev_src.append(np.full(nk, k, np.int64))
            ev_when.append(when_keys(nk))
            self.stream_pos[k] += nk

        n_ev = sum(len(x) for x in ev_line)
        if n_ev == 0:
            return None
        order = np.argsort(np.concatenate(ev_when), kind="stable")
        line = np.concatenate(ev_line)[order]
        isacc = np.concatenate(ev_accel)[order]
        wr = np.concatenate(ev_write)[order]
        hint = np.concatenate(ev_hint)[order]
        pf = np.concatenate(ev_pf)[order]
        src = np.concatenate(ev_src)[order]
        # exact per-event deadline switch: bypass active once the count
        # of accel accesses this epoch exceeds switch_point (§III-C1)
        acc_seen = np.cumsum(isacc & ~pf)
        dlok = acc_seen > switch_point
        meta = pack_meta(isacc, wr, hint, pf, dlok, src)
        return line, meta

    def finish_epoch(self, stats: np.ndarray, percore: np.ndarray,
                     llc_state=None) -> None:
        """Consume the epoch's LLC stats: fluid-timing update + progress."""
        p, et = self.p, self.et
        dram = self.dram
        n_a = self._n_a
        accel_prio = self._accel_prio
        st = dict(zip(llc_mod.STAT_NAMES, np.asarray(stats).tolist()))

        # ---- timing update -------------------------------------------------
        ch, cm = st["core_hits"], st["core_misses"]
        ah, am = st["accel_hits"], st["accel_misses"]
        self.hr_core = ch / max(ch + cm, 1)
        self.hr_accel = ah / max(ah + am, 1)
        # LLC controller utilization: bypassed fills cost a tag lookup only;
        # bypassed accel writes use the direct path (zero LLC service).
        llc_units = (ch + cm + ah + am
                     - 0.7 * (st["core_bypasses"] + st["accel_bypasses"])
                     - 0.3 * st["accel_writes_bypassed"])
        rho_llc = llc_units / self.llc_capacity
        rho_a_llc = (ah + am) / self.llc_capacity
        dram_traffic = cm + am + st["prefetch_fills"]
        w_cap_dram = p.w_cap * dram.latency_cycles
        s_llc = self.s_llc
        if accel_prio:
            # accel requests (and their fills) are issued first by the LLC
            # controller; cores queue behind them on both paths.
            w_llc_a = min(_mg1_delay(rho_a_llc, s_llc), p.w_cap * s_llc)
            prio = min(1.0 / max(1.0 - rho_a_llc, 1e-3), p.prio_cap)
            w_llc_c = min(_mg1_delay(rho_llc, s_llc) * prio,
                          p.w_cap * s_llc * p.prio_cap)
        else:
            w_llc_a = w_llc_c = min(_mg1_delay(rho_llc, s_llc),
                                    p.w_cap * s_llc)
        if self.dsched is None:
            # fluid M/G/1 DRAM waits (LLC-side waits above are fluid in
            # both backends)
            w_dram_fifo = min(dram.queue_delay(dram_traffic, et),
                              w_cap_dram)
            if accel_prio:
                rho_a_dram = dram.utilization(am, et)
                w_dram_a = min(dram.queue_delay(am, et), w_cap_dram)
                prio_d = min(1.0 / max(1.0 - rho_a_dram, 1e-3), p.prio_cap)
                w_dram_c = min(w_dram_fifo * prio_d,
                               w_cap_dram * p.prio_cap)
            else:
                w_dram_a = w_dram_c = w_dram_fifo
        else:
            # scheduled (bank/rank) DRAM backend, the host twin of the
            # fused engine's in-carry bank model.  SQUASH urgency: explicit
            # accel priority, or a hydra lane predicting it will miss this
            # epoch's requirement (amal is still pre-update here).
            ma_hat = p.mlp_accel * et / max(self.amal, 1.0)
            urgent = accel_prio or (self.policy.hydra
                                    and ma_hat < self.hist["requirement"][-1])
            samp = dramsched.sample_window(self.tr.line, self.pos, n_a,
                                           dram.samples)
            w_a, w_c = dramsched.host_epoch(
                self.dsched, dram, samp, am, cm, st["prefetch_fills"],
                urgent, self.epoch, self._et_i)
            w_dram_a = min(w_a, w_cap_dram)
            w_dram_c = min(w_c, w_cap_dram * p.prio_cap)
        miss_lat_c = p.llc_hit_lat + w_llc_c + dram.latency_cycles + w_dram_c
        miss_lat_a = p.llc_hit_lat + w_llc_a + dram.latency_cycles + w_dram_a
        self.cm_prev, self.pf_prev = float(cm), float(st["prefetch_fills"])
        for k, pr in enumerate(self.profiles):
            hk = percore[k, 0] / max(percore[k, 0] + percore[k, 1], 1)
            self.ipc[k] = cores_mod.core_ipc(pr, hk, p.llc_hit_lat,
                                             miss_lat_c, w_llc_c)
        if n_a > 0:
            self.amal = (self.hr_accel * (p.llc_hit_lat + w_llc_a)
                         + (1 - self.hr_accel) * miss_lat_a)

        self.total_instr += float(np.sum(self.ipc * self._shed_core) * et)
        self.total_core_hits += ch
        self.total_core_miss += cm
        self.total_core_byp += st["core_bypasses"]
        self.total_accel_hits += ah
        self.total_accel_miss += am
        self.total_accel_byp += st["accel_bypasses"]
        self.total_accel_acc += n_a
        self.total_llc += llc_units
        self.total_dram += dram_traffic

        self.hist["accel_rate"].append(float(n_a))
        self.hist["ri_th"].append(float(self.ri_th))
        self.hist["rc_th"].append(float(self.rc_th))
        self.hist["core_ipc"].append(float(np.sum(self.ipc * self._shed_core)))
        self.hist["amal"].append(float(self.amal))
        if p.record_occupancy and llc_state is not None:
            self.occ.append(list(llc_mod.occupancy(llc_state)))

        # ---- progress bookkeeping ------------------------------------------
        self.now += et
        if n_a > 0:
            self.pos += n_a
            if self.pos >= self.m_total:
                self.completions.append(self.now - self.input_start)
                self.input_idx += 1
                self.pos = 0
                self.input_start = max(self.input_start + self.period, self.now)
        self.epoch += 1
        if (self._retrain_every is not None
                and self.epoch % self._retrain_every == 0):
            self._online_retrain()

    def _online_retrain(self) -> None:
        """Online-LERN: refit clusters on the accesses observed since the
        last retrain and swap the packed L-RPT images in place.

        Only layers with enough observed multi-occurrence lines are
        replaced (a sparse window must not wipe a layer's knowledge);
        future per-access lookups — including the next input's replay —
        see the updated tables."""
        if not self._win_ranges:
            return
        idx = np.concatenate([np.arange(a, b) for a, b in self._win_ranges])
        self._win_ranges = []
        tr = self.tr
        window = Trace(line=tr.line[idx], write=tr.write[idx],
                       cycle=tr.cycle[idx], layer=tr.layer[idx],
                       layer_names=tr.layer_names,
                       compute_cycles=tr.compute_cycles)
        refit = train_model_batched(window, hash_fn=self._train_hash,
                                    seed=self.p.seed, device=self.device)
        good = [li for li in range(refit.n_layers)
                if (refit.rc_cluster[li] >= 0).any()]
        if not good:
            return
        self._lern_model = self._lern_model.replace_layers(good, refit)
        fresh = clusters_from_model(self._lern_model, tr,
                                    self.policy.lrpt_variant)
        for k in ("rc", "ri", "cold_center"):
            self.clusters[k] = fresh[k]

    def result(self) -> SimResult:
        completions, deadline = self.completions, self.deadline
        dmr = (float(np.mean([c > deadline for c in completions]))
               if completions else 1.0)
        n_epochs = max(self.epoch, 1)
        core_acc = max(self.total_core_hits + self.total_core_miss, 1)
        return SimResult(
            policy=self.policy.name, config=self.config, mix=self.mix,
            ipc_total=self.total_instr / (n_epochs * self.et),
            dmr=dmr,
            core_br=self.total_core_byp / core_acc,
            accel_br=self.total_accel_byp / max(self.total_accel_acc, 1),
            core_hit_rate=self.total_core_hits / core_acc,
            accel_hit_rate=self.total_accel_hits / max(self.total_accel_acc, 1),
            completion_cycles=completions, deadline_cycles=deadline,
            epochs=self.epoch, history=self.hist, occupancy=self.occ,
            llc_accesses=self.total_llc, dram_accesses=self.total_dram)


def drive_lane(lane: Lane, state: Optional[llc_mod.LLCState] = None,
               device="cuda") -> SimResult:
    """Drive one Lane to completion through the LLC round engine on
    ``device`` (the lane's; ``state`` carries a mid-run lane's LLC
    content).  Each epoch's chunks are enqueued back to back; their stats
    come to the host in one copy per epoch."""
    llc_cfg = lane.llc_cfg
    dev = _device.resolve(device)
    if dev.type != lane.device.type:
        raise ValueError(f"lane runs on {lane.device}, not {dev}")
    if state is None:
        state = llc_mod.init_state(llc_cfg, dev)
    while lane.active:
        ev = lane.begin_epoch()
        stats = np.zeros(len(llc_mod.STAT_NAMES), np.int64)
        percore = np.zeros((llc_mod.NUM_CORES, 2), np.int64)
        if ev is not None:
            line, meta = ev
            st_sum, pc_sum = 0, 0
            for line_m, meta_m in build_rounds(llc_cfg, line, meta):
                state, st_c, pc_c = llc_mod.simulate_epoch(
                    llc_cfg, state, line_m, meta_m, device=dev)
                st_sum, pc_sum = st_sum + st_c, pc_sum + pc_c
            stats = stats + st_sum.cpu().numpy()
            percore = percore + pc_sum.cpu().numpy()
        lane.finish_epoch(stats, percore, llc_state=state)
    return lane.result()


def calibrated_deadline(config: str, p: SimParams, dram: DramModel,
                        device="cuda") -> float:
    """Deadline = deadline_factor x this config's standalone (no core
    traffic, ARP-NB) completion time — the 10-IPS analogue for the scaled
    workloads.  Per-config slack keeps the paper's tradeoff dynamics live
    for every config (an absolute shared deadline would leave light
    configs with unbounded slack after workload scaling).  The standalone
    run goes through ``device``."""
    key = (f"cfg-{config}-ss{p.subsample_target}-et{p.epoch_cycles}"
           f"-{dram.name}-mlp{p.mlp_accel}-cap{p.accel_epoch_cap}"
           f"-r{p.llc_rate}-s{p.llc_size_bytes}")
    path = _cache_path("deadline", hashlib.md5(key.encode()).hexdigest())
    v = cache_load(path)
    if v is not MISS:
        return v * p.deadline_factor
    from .policies import get
    pq = dataclasses.replace(p, n_inputs=1, deadline_factor=1.0)
    art = load_artifacts(config, "mix1", pq, False)
    res = drive_lane(Lane(config, "mix1", get("arp-nb"), pq, dram,
                          float(10**12), art, False, device=device),
                     device=device)
    t0 = res.completion_cycles[0] if res.completion_cycles else 10**9
    _atomic_dump(t0, path)
    return t0 * p.deadline_factor


def result_cache_path(config: str, mix: str, policy: Policy,
                      params: Optional[SimParams] = None,
                      dram: DramModel = DDR3_1600, **kw) -> str:
    """Disk-cache location of one simulated point, keyed by all inputs
    (the JAX package's key, under the port's own cache root).  Shared by
    the sweep's dedup layer and anything that wants a pure cache read of
    a finished point."""
    p = params or SimParams()
    # "v": engine-semantics version (v2: exact integer when_keys)
    key = json.dumps({"c": config, "m": mix, "pol": dataclasses.asdict(policy),
                      "par": dataclasses.asdict(p), "d": dram.name, "v": 2,
                      "kw": {k: str(v) for k, v in kw.items()}},
                     sort_keys=True, default=str)
    return _cache_path("sim", hashlib.md5(key.encode()).hexdigest())
