"""The bucketed engine's ``devices`` on the CPU: a bucket's lane groups
split into shards as the JAX package's ``shard_map`` of the group axis
splits them (``src/repro/core/fused.py:1401-1486,1609-1610``), every
shard on the CPU (the stand-in for JAX's forced host devices):

* ``fused.drive_lanes_bucketed(devices=2)`` on the ``SHARD_CASES``
  buckets (four groups, two a shard; in "hot" one group demotes inside its
  shard), and ``sweep.run_bucketed`` and ``exp.run`` with
  ``ExecPlan(devices=2)`` on the ``BUCKET_SWEEP`` points, are bitwise the
  JAX package's at ``devices=2`` on two forced host devices (the
  ``shards`` mode of the reference child in ``tests/test_torch_sim.py``)
  and the port's at ``devices=1``;
* the shard rule: a bucket shards when the count is above 1 and divides
  its groups, else it runs whole; on ``"cuda"`` shard i is ``cuda:i`` and
  ``devices=None`` counts the visible cards (patched here);
* a group that demotes inside one shard leaves the other shard's groups
  as they are in a bucket of their own;
* ``run_bucketed`` and ``exp.run`` at ``devices=2`` equal the host engine
  and write the same cache entries as at ``devices=1``;
* every kernel launch calls its C entry point inside ``on_card`` of its
  tensors' device (both replaced by recorders).

Every test starts and ends with an empty staging cache and zeroed engine
counts, and sets environment variables only through ``monkeypatch``.
"""
import dataclasses
import os
import pickle
import shutil
import types

import pytest
import torch

from test_torch_sim import (  # noqa: F401 (fixture)
    SHARD_CASES, SHARD_POLICIES, bucket_sweep_points, bucket_sweep_spec,
    drive_shard_case, run_child, shard_groups, torch_one_thread)

from repro_torch import exp
from repro_torch.core import cores, dram, fused, policies, sim, sweep
from repro_torch.core.tracegen import Trace
from repro_torch.exp import faults

pytestmark = pytest.mark.usefixtures("torch_one_thread")
CPU = torch.device("cpu")
_ENV = ("REPRO_DRAM", "REPRO_ENGINE", "REPRO_FUSED", "REPRO_LERN_FIT",
        "REPRO_FAULTS", "REPRO_BUCKET_PIPELINE", "REPRO_MANIFEST",
        "REPRO_RESUME")


def _seal():
    sweep._STAGE_CACHE.clear()
    fused.reset_counts()
    fused.reset_phase_times()
    faults.drain_events()


@pytest.fixture(scope="module")
def artifact_cache(tmp_path_factory):
    """Traces, LERN tables and calibrations of the BUCKET_SWEEP points,
    made once for the module; a test that caches results runs on a copy."""
    root = tmp_path_factory.mktemp("shard_artifacts")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CACHE", str(root))
        sweep.run_bucketed(bucket_sweep_points(sim, sweep, policies),
                           cache=False, device="cpu")
    return root


@pytest.fixture(autouse=True)
def sealed(artifact_cache, monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("REPRO_CACHE", str(artifact_cache))
    _seal()
    yield
    _seal()


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_shards")
    out = str(d / "shards.pkl")
    flags = os.environ.get("XLA_FLAGS", "")
    run_child("shards", out, str(d / "cache"), env_extra={
        "XLA_FLAGS": f"{flags} --xla_force_host_platform_device_count=2"})
    with open(out, "rb") as f:
        return pickle.load(f)


def _groups(case):
    return shard_groups(sim, policies, dram, cores, Trace, case,
                        device="cpu")


def _asdicts(results):
    return [dataclasses.asdict(r) for r in results]


def _spy_batches(monkeypatch):
    """The lane count of every shard super-step enqueued."""
    lanes = []
    real = fused._superstep_bucket

    def spy(dims, sh, lc, carry, stop):
        lanes.append(int(stop.shape[0]))
        return real(dims, sh, lc, carry, stop)

    monkeypatch.setattr(fused, "_superstep_bucket", spy)
    return lanes


def _spy_demotions(monkeypatch):
    demoted = []
    real = fused.drive_lanes_fused

    def spy(lanes, *a, **kw):
        demoted.append(tuple(lanes))
        return real(lanes, *a, **kw)

    monkeypatch.setattr(fused, "drive_lanes_fused", spy)
    return demoted


# ---------------------------------------------------------------------------
# against the JAX package's shard_map and the port's one device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_shards_equal_jax_and_one_device(jax_shards, monkeypatch, case):
    """Every group's SimResult (summary and histories) at ``devices=2`` is
    bitwise the JAX package's at ``devices=2`` and the port's at
    ``devices=1``; two shards of two groups ran, each its own lane batch."""
    lanes = _spy_batches(monkeypatch)
    got = drive_shard_case(fused, _groups(case), case, 2)
    counts = fused.counts()
    assert counts["bucket_shards"] == 2
    assert set(lanes) == {2 * len(SHARD_POLICIES)}
    assert len(lanes) == 2 * counts["bucket_supersteps"]
    assert (counts["bucket_demotions"] == 1) == (case == "hot")
    assert got == jax_shards[case]
    _seal()
    one = drive_shard_case(fused, _groups(case), case, 1)
    assert fused.counts()["bucket_shards"] == 1
    assert got == one


def test_run_bucketed_equals_jax(jax_shards):
    pts = bucket_sweep_points(sim, sweep, policies)
    got = _asdicts(sweep.run_bucketed(pts, devices=2, cache=False,
                                      device="cpu"))
    # the premise: both buckets (one a mix) split into two shards
    assert fused.counts()["bucket_shards"] == 4
    assert got == jax_shards["run_bucketed"]
    assert got == _asdicts(sweep.run_bucketed(pts, devices=1, cache=False,
                                              device="cpu"))


def test_exp_run_equals_jax(jax_shards):
    spec = bucket_sweep_spec(exp, sim)
    got = _asdicts(exp.run(spec, plan=exp.ExecPlan(
        engine="bucketed", devices=2, cache=False), device="cpu").results())
    assert fused.counts()["bucket_shards"] == 4
    assert got == jax_shards["exp_run"]


# ---------------------------------------------------------------------------
# the shard rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_groups,devices,shards", [(3, 2, 1), (6, 3, 3)],
                         ids=["3_groups_2_devices", "6_groups_3_devices"])
def test_shard_rule(monkeypatch, n_groups, devices, shards):
    """``src/repro/core/fused.py:1609-1610``: the groups shard only when
    the count divides them; each shard is a contiguous slice run as its
    own lane batch, and the results are those of one device."""
    specs = [g for case in SHARD_CASES.values() for g in case["groups"]]
    specs = [g for g in specs if g[1] > 8][:n_groups]
    assert len(specs) == n_groups
    monkeypatch.setitem(SHARD_CASES, "rule", dict(groups=tuple(specs),
                                                  drive={}, cap=None))
    lanes = _spy_batches(monkeypatch)
    got = drive_shard_case(fused, _groups("rule"), "rule", devices)
    assert fused.counts()["bucket_shards"] == shards
    assert set(lanes) == {n_groups // shards * len(SHARD_POLICIES)}
    assert len(lanes) == shards * fused.counts()["bucket_supersteps"]
    _seal()
    assert got == drive_shard_case(fused, _groups("rule"), "rule", 1)


def test_shard_devices(monkeypatch):
    """The devices of a bucket's shards: every visible card by default on
    ``"cuda"`` (``cuda:i`` for shard i), 1 on the CPU, one device when the
    count does not divide the groups, and a count above the visible cards
    refused."""
    cuda = torch.device("cuda")
    assert fused.shard_devices(4, None, CPU) == [CPU]
    assert fused.shard_devices(6, 3, CPU) == [CPU] * 3
    assert fused.shard_devices(3, 2, CPU) == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert fused.shard_devices(4, None, cuda) == [
        torch.device("cuda", i) for i in range(4)]
    assert fused.shard_devices(6, None, cuda) == [cuda]
    assert fused.shard_devices(6, 2, cuda) == [torch.device("cuda", 0),
                                               torch.device("cuda", 1)]
    assert fused.shard_devices(6, 1, cuda) == [cuda]
    with pytest.raises(ValueError, match="devices=5: only 4 CUDA"):
        fused.shard_devices(10, 5, cuda)


# ---------------------------------------------------------------------------
# demotion inside one shard
# ---------------------------------------------------------------------------
def test_demotion_in_one_shard_leaves_the_other(monkeypatch):
    """In "hot" the first group overflows past the cap inside shard 0 and
    leaves through ``drive_lanes_fused``; shard 1's groups are bitwise what
    they are in a bucket of their own, and every group equals the
    per-group fused engine."""
    demoted = _spy_demotions(monkeypatch)
    groups = _groups("hot")
    got = drive_shard_case(fused, groups, "hot", 2)
    assert demoted == [tuple(groups[0])]
    assert fused.counts()["bucket_demotions"] == 1
    monkeypatch.setitem(SHARD_CASES, "rest", dict(SHARD_CASES["hot"],
                                                  groups=SHARD_CASES["hot"]
                                                  ["groups"][2:]))
    _seal()
    alone = drive_shard_case(fused, _groups("rest"), "rest", 1)
    assert fused.counts()["bucket_demotions"] == 0
    assert got[2:] == alone
    for g, want in zip(_groups("hot"), got):
        monkeypatch.setattr(fused, "MAX_ROUNDS_CAP", 64)
        fused.drive_lanes_fused(g, k_epochs=4, max_rounds=32)
        assert _asdicts(lane.result() for lane in g) == want


# ---------------------------------------------------------------------------
# run_bucketed and exp.run: the host engine, the cache entries
# ---------------------------------------------------------------------------
def _entries(root) -> dict:
    sims = os.path.join(root, "torch", "sim")
    out = {}
    for dirpath, _dirs, files in os.walk(sims):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, sims)] = f.read()
    return out


def _fresh_cache(artifact_cache, tmp_path, name, monkeypatch):
    root = tmp_path / name
    shutil.copytree(artifact_cache, root)
    shutil.rmtree(root / "torch" / "sim", ignore_errors=True)
    monkeypatch.setenv("REPRO_CACHE", str(root))
    return root


@pytest.mark.parametrize("entry", ["run_bucketed", "exp_run"])
def test_two_devices_equal_one_and_the_host_engine(artifact_cache, tmp_path,
                                                   monkeypatch, entry):
    def run(devices):
        if entry == "run_bucketed":
            return sweep.run_bucketed(
                bucket_sweep_points(sim, sweep, policies), devices=devices,
                device="cpu")
        return exp.run(bucket_sweep_spec(exp, sim), plan=exp.ExecPlan(
            engine="bucketed", devices=devices), device="cpu").results()

    rows, entries = {}, {}
    for devices in (2, 1):
        root = _fresh_cache(artifact_cache, tmp_path, f"d{devices}",
                            monkeypatch)
        _seal()
        rows[devices] = _asdicts(run(devices))
        assert fused.counts()["bucket_shards"] == 2 * devices
        entries[devices] = _entries(root)
    assert rows[2] == rows[1]
    assert len(entries[2]) == len(rows[2]) and entries[2] == entries[1]
    _fresh_cache(artifact_cache, tmp_path, "host", monkeypatch)
    if entry == "run_bucketed":
        host = sweep.map_points(bucket_sweep_points(sim, sweep, policies),
                                engine="host", device="cpu")
    else:
        host = exp.run(bucket_sweep_spec(exp, sim), plan=exp.ExecPlan(
            engine="host"), device="cpu").results()
    assert rows[2] == _asdicts(host)


# ---------------------------------------------------------------------------
# kernel launches on their tensors' card
# ---------------------------------------------------------------------------
class _Current:
    """A stand-in for ``kernels.common.on_card``: records the device each
    launch entered, and whether a C call came while it was current."""

    entered: list = []
    depth = 0

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _Current.entered.append(self.device)
        _Current.depth += 1

    def __exit__(self, *exc):
        _Current.depth -= 1


def _recorder(calls):
    def fn(*args):
        calls.append(_Current.depth)
        return 0
    return fn


def _launch_llc_rounds():
    from repro_torch.kernels.llc_rounds import kernel
    t = torch.zeros((1, 1, 1), dtype=torch.int32)
    kernel.launch(t, t, t, None, (t,) * 5, t, t, t, t, t, entries=1,
                  sampler_shift=0, region_lines=1, counter_max=1)
    return kernel, t.device


def _launch_ri_histogram():
    from repro_torch.kernels.ri_histogram import kernel
    t = torch.zeros(4, dtype=torch.int32)
    kernel.launch(t, t, t)
    return kernel, t.device


def _launch_kmeans_assign():
    from repro_torch.kernels.kmeans_assign import kernel
    x = torch.zeros((1, 4, 2))
    kernel.launch_dense(x, x, torch.zeros((1, 4), dtype=torch.int32))
    return kernel, x.device


def _launch_flash_attention():
    from repro_torch.kernels.flash_attention import kernel
    q = torch.zeros((1, 8, 2, 32))
    kernel.launch(q, q, q, q.clone(), True, "simt")
    return kernel, q.device


@pytest.mark.parametrize("launch", [_launch_llc_rounds, _launch_ri_histogram,
                                    _launch_kmeans_assign,
                                    _launch_flash_attention],
                         ids=["llc_rounds", "ri_histogram", "kmeans_assign",
                              "flash_attention"])
def test_kernel_launches_run_on_their_tensors_card(monkeypatch, launch):
    calls = []
    _Current.entered, _Current.depth = [], 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0,
                        raising=False)
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        **{fn: _recorder(calls) for fn in (
            "llc_rounds", "ri_histogram", "kmeans_assign",
            "flash_attention")}))
    for mod in ("llc_rounds", "ri_histogram", "kmeans_assign",
                "flash_attention"):
        monkeypatch.setattr(f"repro_torch.kernels.{mod}.kernel._FNS", {})
        monkeypatch.setattr(f"repro_torch.kernels.{mod}.kernel.on_card",
                            _Current)
    kernel, device = launch()
    assert calls == [1]                 # the C call, under the device
    assert _Current.entered == [device]
