"""The port's LLC round engine against the JAX package: stats, per-core
counters and all eight state arrays bitwise after every chunk, from a
fresh state and from a mid-run state carried across, for every accel
mode and with core bypass / shared predictor / way masks; and the serial
oracle on one-event-per-round inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llc as jllc
from repro_torch.convert import llc_state_from_numpy
from repro_torch.core import llc as tllc

KNOBS = [
    dict(),
    dict(core_bypass=True),
    dict(core_bypass=True, shared_predictor=True),
    dict(core_way_mask=0x00FF, accel_way_mask=0xFF00),
    dict(core_bypass=True, core_way_mask=0xFFFF, accel_way_mask=0x0003),
]
SMALL = dict(size_bytes=64 * 1024)   # 64 sets x 16 ways


def _events(rng, n, n_lines=2000):
    line = rng.integers(0, n_lines, n).astype(np.int64)
    meta = jllc.pack_meta(rng.random(n) < 0.5, rng.random(n) < 0.3,
                          rng.random(n) < 0.5, rng.random(n) < 0.1,
                          rng.random(n) < 0.7, rng.integers(0, 8, n))
    return line, meta


def _assert_state(tst, jst):
    for f in jllc.LLCState._fields:
        a, b = getattr(tst, f).numpy(), np.asarray(getattr(jst, f))
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("knobs", KNOBS, ids=range(len(KNOBS)))
@pytest.mark.parametrize("mode", [jllc.A_NONE, jllc.A_HINT, jllc.A_SHIP,
                                  jllc.A_RAND])
def test_simulate_epoch_bitwise(mode, knobs):
    rng = np.random.default_rng(mode * 10 + len(knobs))
    kw = dict(SMALL, accel_mode=mode, **knobs)
    jcfg, tcfg = jllc.LLCConfig(**kw), tllc.LLCConfig(**kw)
    jst = jllc.init_state(jcfg)
    tst = tllc.init_state(tcfg, device="cpu")
    _assert_state(tst, jst)
    for n in (400, 2500):            # two round buckets
        line, meta = _events(rng, n)
        for lm, mm in jllc.build_rounds(jcfg, line, meta):
            jst, js, jp = jllc.simulate_epoch(jcfg, jst, jnp.asarray(lm),
                                              jnp.asarray(mm))
            tst, ts, tp = tllc.simulate_epoch(tcfg, tst, lm, mm,
                                              device="cpu")
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            _assert_state(tst, jst)
        assert tllc.occupancy(tst) == jllc.occupancy(jst)


@pytest.mark.parametrize("mode", [jllc.A_HINT, jllc.A_SHIP])
def test_simulate_epoch_from_carried_state(mode):
    """A mid-run reference state converted with llc_state_from_numpy
    continues bitwise, through an epoch whose hot set (> 512 events)
    splits it into two chunks."""
    rng = np.random.default_rng(7)
    kw = dict(SMALL, accel_mode=mode, core_bypass=True)
    jcfg, tcfg = jllc.LLCConfig(**kw), tllc.LLCConfig(**kw)
    jst = jllc.init_state(jcfg)
    for lm, mm in jllc.build_rounds(jcfg, *_events(rng, 2500)):
        jst, _, _ = jllc.simulate_epoch(jcfg, jst, jnp.asarray(lm),
                                        jnp.asarray(mm))
    tst = llc_state_from_numpy(*(np.asarray(a) for a in jst), device="cpu")
    _assert_state(tst, jst)
    line, meta = _events(rng, 400)
    line = np.concatenate([line, np.full(600, 64 * 7 + 5, np.int64)])
    meta = np.concatenate([meta, meta[:400], meta[:200]])
    chunks = list(jllc.build_rounds(jcfg, line, meta))
    assert len(chunks) == 2
    for lm, mm in chunks:
        jst, js, jp = jllc.simulate_epoch(jcfg, jst, jnp.asarray(lm),
                                          jnp.asarray(mm))
        tst, ts, tp = tllc.simulate_epoch(tcfg, tst, lm, mm, device="cpu")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_state(tst, jst)
    assert tllc.occupancy(tst) == jllc.occupancy(jst)


@pytest.mark.parametrize("mode,core_byp", [
    (jllc.A_NONE, False), (jllc.A_HINT, False), (jllc.A_SHIP, True)])
def test_engine_matches_serial_oracle(mode, core_byp):
    """One event per round == the exact serial semantics (SHIP included)."""
    rng = np.random.default_rng(0)
    cfg = tllc.LLCConfig(size_bytes=64 * 64 * 4, ways=4, accel_mode=mode,
                         core_bypass=core_byp)
    n = 200
    line = rng.integers(0, 256, n).astype(np.int64)
    isacc = rng.random(n) < 0.5
    wr = rng.random(n) < 0.2
    hint = rng.random(n) < 0.5
    pf = np.zeros(n, bool)
    src = rng.integers(0, 8, n)
    meta = tllc.pack_meta(isacc, wr, hint, pf, np.ones(n, bool), src)
    state = tllc.init_state(cfg, device="cpu")
    stats = np.zeros(len(tllc.STAT_NAMES), np.int64)
    for i in range(n):
        for lm, mm in tllc.build_rounds(cfg, line[i:i + 1], meta[i:i + 1]):
            state, s, _ = tllc.simulate_epoch(cfg, state, lm, mm,
                                              device="cpu")
            stats += s.numpy()
    ev = list(zip(line.tolist(), isacc.tolist(), wr.tolist(), hint.tolist(),
                  pf.tolist(), [True] * n, src.tolist()))
    assert dict(zip(tllc.STAT_NAMES, stats.tolist())) == \
        tllc.ref_simulate(cfg, ev)


def test_state_device_must_match():
    cfg = tllc.LLCConfig(**SMALL)
    st = tllc.init_state(cfg, device="cpu")
    line_m = np.full((8, cfg.num_sets), -1, np.int32)
    meta_m = np.zeros((8, cfg.num_sets), np.int32)
    st2, stats, _ = tllc.simulate_epoch(cfg, st, line_m, meta_m,
                                        device="cpu")
    assert int(st2.tick) == 8 and int(stats.sum()) == 0
    assert isinstance(st2.tags, torch.Tensor)
