"""The port's host-side modules (pure numpy copies) against the JAX
package: traces, core streams, L-RPT hashes and table images, policy and
DRAM tables, bitwise."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cores as jcores, dram as jdram, lrpt as jlrpt
from repro.core import policies as jpol, ship as jship, workloads as jwl
from repro.core.tracegen import generate_trace as jgen
from repro_torch.core import cores as tcores, dram as tdram, lrpt as tlrpt
from repro_torch.core import policies as tpol, ship as tship
from repro_torch.core import workloads as twl
from repro_torch.core.tracegen import generate_trace as tgen
from repro_torch.convert import lern_model_from_numpy

BASE_CONFIGS = [n for n, c in jwl.CONFIGS.items() if c.drift is None]


@pytest.mark.parametrize("config", BASE_CONFIGS)
def test_traces_bitwise(config):
    a, b = jgen(jwl.CONFIGS[config]), tgen(twl.CONFIGS[config])
    for f in ("line", "write", "cycle", "layer"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.layer_names == b.layer_names
    assert a.compute_cycles == b.compute_cycles


@pytest.mark.parametrize("mix", sorted(jcores.MIXES))
def test_core_streams_bitwise(mix):
    assert jcores.MIXES[mix] == tcores.MIXES[mix]
    for k, name in enumerate(jcores.MIXES[mix]):
        jp, tp = jcores.PROFILES[name], tcores.PROFILES[name]
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        np.testing.assert_array_equal(
            jcores.generate_stream_fast(jp, 5000, k, seed=3),
            tcores.generate_stream_fast(tp, 5000, k, seed=3))
        for hr in (0.0, 0.37, 1.0):
            assert jcores.core_ipc(jp, hr, 12.0, 250.0, 3.5) == \
                tcores.core_ipc(tp, hr, 12.0, 250.0, 3.5)
        assert jcores.epoch_accesses(jp, 1.3, 5e4) == \
            tcores.epoch_accesses(tp, 1.3, 5e4)


def test_policy_and_dram_tables_equal():
    assert sorted(jpol.POLICIES) == sorted(tpol.POLICIES)
    for name, p in jpol.POLICIES.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(tpol.POLICIES[name])
    for name, m in tdram.MODELS.items():
        assert dataclasses.asdict(m) == dataclasses.asdict(jdram.MODELS[name])
        for traffic in (0.0, 10.0, 3e3, 1e6):
            assert m.queue_delay(traffic, 5e4) == \
                jdram.MODELS[name].queue_delay(traffic, 5e4)
            assert m.utilization(traffic, 5e4) == \
                jdram.MODELS[name].utilization(traffic, 5e4)


def test_sched_dram_not_ported(monkeypatch):
    """(The name predates the port of the scheduled backend.)
    ``REPRO_DRAM=sched`` and each scheduled model's name resolve to the
    model the JAX package's ``default_model()`` gives, name and fields,
    with its ``sched:<policy>`` tag; a fluid name still resolves too."""
    names = ["sched", "DDR3_1600_8b1r_squash", "DDR4_2400_32b2r_frfcfs",
             "DDR4_2400_32b2r_squash", "DDR4_2400_8x8"]
    for name in names:
        monkeypatch.setenv("REPRO_DRAM", name)
        got, want = tdram.default_model(), jdram.default_model()
        assert type(got).__name__ == type(want).__name__, name
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert tdram.dram_kind(got) == jdram.dram_kind(want), name
    monkeypatch.setenv("REPRO_DRAM", "sched")
    assert tdram.dram_kind(tdram.default_model()) == "sched:squash"


@pytest.mark.parametrize("variant", sorted(jlrpt.VARIANTS))
def test_lrpt_hashes_and_tables_bitwise(variant):
    rng = np.random.default_rng(5)
    lines = rng.integers(0, 1 << 30, 20_000).astype(np.int64)
    np.testing.assert_array_equal(jlrpt.splitmix32(lines),
                                  tlrpt.splitmix32(lines))
    jh, th = jlrpt.lrpt_train_hash(variant), tlrpt.lrpt_train_hash(variant)
    assert (jh is None) == (th is None)
    if jh is not None:
        np.testing.assert_array_equal(jh(lines), th(lines))
    # a synthetic trained model: 3 layers, ragged unique tables
    n_l, n = 3, 512
    uniq = np.sort(rng.choice(1 << 19, (n_l, n), replace=False), 1)
    if th is not None:
        uniq = np.sort(th(uniq), 1)
    rc = rng.integers(-1, 4, (n_l, n)).astype(np.int8)
    ri = np.where(rc < 0, -1, rng.integers(0, 4, (n_l, n))).astype(np.int8)
    model = lern_model_from_numpy(
        uniq, rc, ri, np.full(n_l, n, np.int32), np.zeros((n_l, 4)),
        np.zeros((n_l, 4, 4)), [np.zeros((0, 4))] * n_l, variant)
    jmodel = dataclasses.replace(model, hash_fn=jh)
    jt, tt = jlrpt.pack_tables(jmodel, variant), tlrpt.pack_tables(model,
                                                                   variant)
    np.testing.assert_array_equal(jt, tt)
    layer = rng.integers(0, n_l, 5000)
    probe = np.concatenate([uniq[0, :100], rng.integers(0, 1 << 19, 4900)])
    for a, b in zip(jlrpt.lookup_tables(jt, variant, layer, probe),
                    tlrpt.lookup_tables(tt, variant, layer, probe)):
        np.testing.assert_array_equal(a, b)


def test_ship_signature_bitwise():
    """The torch uint32 hash (int64 with masks) equals both JAX-package
    versions, padding lines (-1) included."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    lines = np.concatenate([[-1, 0, 31, 32], rng.integers(
        0, (1 << 31) - 1, 10_000)]).astype(np.int32)
    for p in (jship.SHIP_DEFAULT, jship.SHIP_LARGE):
        tp = tship.ShipParams(p.entries, p.counter_bits, p.region_lines)
        got = tship.signature(torch.as_tensor(lines), tp).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jship.signature(jnp.asarray(lines), p)))
        np.testing.assert_array_equal(got[lines >= 0],
                                      jship.signature_np(lines[lines >= 0], p))
