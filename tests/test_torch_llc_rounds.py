"""The ``llc_rounds`` kernel's plain version (``kernels/llc_rounds/ops.py``)
against the JAX package's lane-batched round engine
(``repro.core.llc.simulate_epoch_lanes``): state, stats and per-core
counters bitwise over chained chunks, for lanes that together cover every
knob the kernel takes (all accel modes, core bypass, the shared
predictor, fig. 18's way masks) and SHIP_LARGE tables; the fused engine's
round count (``n_rounds``) and the column-gathered rounds (``sparse_cap``)
against the full loop; padding rounds; the wrappers' device rule.  The
kernel itself runs only on the card: ``chip_smoke.py`` phase 3d holds it
to this plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llc as jllc
from repro.core.ship import SHIP_LARGE as JSHIP_LARGE
from repro_torch.core import llc as tllc
from repro_torch.core.ship import SHIP_LARGE
from repro_torch.core.ship import signature as ship_signature
from repro_torch.kernels.llc_rounds import ops as rops

SETS = 64
# every accel mode, core bypass on and off, the shared predictor, way masks
LANES = (
    dict(accel_mode=0),
    dict(accel_mode=1, core_bypass=True),
    dict(accel_mode=2, core_bypass=True, shared_predictor=True),
    dict(accel_mode=3, core_way_mask=0x00FF, accel_way_mask=0xFF00),
    dict(accel_mode=2, core_way_mask=0xFFFF, accel_way_mask=0x0003),
    dict(accel_mode=1, core_bypass=True, shared_predictor=True,
         core_way_mask=0x0F0F, accel_way_mask=0xF0F0),
)


def _events(rng, n_lanes, rounds, sets=SETS, n_tags=40, p0=0.9):
    """[L, R, S] int32 (line, meta): set s's events are lines
    s + sets * j, present with a probability that decays with the round;
    absent events are padding (line -1, meta 0)."""
    shape = (n_lanes, rounds, sets)
    valid = rng.random(shape) < p0 * 0.93 ** np.arange(rounds)[None, :, None]
    line = np.arange(sets)[None, None, :] + sets * rng.integers(0, n_tags,
                                                                 shape)
    meta = jllc.pack_meta(rng.random(shape) < 0.5, rng.random(shape) < 0.3,
                          rng.random(shape) < 0.5, rng.random(shape) < 0.1,
                          rng.random(shape) < 0.7, rng.integers(0, 8, shape))
    return (np.where(valid, line, -1).astype(np.int32),
            np.where(valid, meta, 0).astype(np.int32))


def _batch(lanes, large=False):
    kw = dict(size_bytes=SETS * 64 * 16)
    jcfgs = [jllc.LLCConfig(**kw, **k, **(
        {"ship": JSHIP_LARGE} if large else {})) for k in lanes]
    tcfgs = [tllc.LLCConfig(**kw, **k, **(
        {"ship": SHIP_LARGE} if large else {})) for k in lanes]
    return (jcfgs[0], jllc.lane_knobs(jcfgs),
            jllc.stack_states(jcfgs[0], len(lanes)),
            tcfgs[0], tllc.lane_knobs(tcfgs, "cpu"),
            tllc.stack_states(tcfgs[0], len(lanes), "cpu"))


def _assert_same(tst, ts, tp, jst, js, jp, what):
    for f in jllc.LLCState._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js), what)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), what)


@pytest.mark.parametrize("large", [False, True], ids=["default", "large"])
def test_plain_rounds_match_jax_lanes(large):
    """Chained chunks of 8, 32 and 128 rounds (host buckets and fused
    capacities) through ``rounds`` on the CPU (the plain loop) and the
    JAX ``simulate_epoch_lanes``, six lanes of different knobs."""
    rng = np.random.default_rng(7 + large)
    jcfg, jkn, jst, tcfg, tkn, tst = _batch(LANES, large)
    for r in (8, 32, 128):
        line, meta = _events(rng, len(LANES), r)
        jst, js, jp = jllc.simulate_epoch_lanes(jcfg, jkn, jst,
                                                jnp.asarray(line),
                                                jnp.asarray(meta))
        tst, ts, tp = rops.rounds(tcfg, tkn, tst, torch.as_tensor(line),
                                  torch.as_tensor(meta))
        _assert_same(tst, ts, tp, jst, js, jp, f"R={r}")


@pytest.mark.parametrize("mode", [jllc.A_NONE, jllc.A_HINT, jllc.A_SHIP,
                                  jllc.A_RAND])
def test_plain_one_lane_matches_jax(mode):
    """``rounds_one`` on the CPU against the JAX ``simulate_epoch``."""
    rng = np.random.default_rng(mode)
    kw = dict(size_bytes=SETS * 64 * 16, accel_mode=mode, core_bypass=True)
    jcfg, tcfg = jllc.LLCConfig(**kw), tllc.LLCConfig(**kw)
    jst, tst = jllc.init_state(jcfg), tllc.init_state(tcfg, "cpu")
    for r in (16, 64):
        line, meta = _events(rng, 1, r)
        jst, js, jp = jllc.simulate_epoch(jcfg, jst, jnp.asarray(line[0]),
                                          jnp.asarray(meta[0]))
        tst, ts, tp = rops.rounds_one(tcfg, tst, torch.as_tensor(line[0]),
                                      torch.as_tensor(meta[0]))
        _assert_same(tst, ts, tp, jst, js, jp, f"mode {mode} R={r}")


def test_n_rounds_and_sparse_columns_equal_the_full_loop():
    """The fused engine's form: ``n_rounds`` runs max(n_rounds) rounds (the
    tick advances by that much for every lane) and equals the full loop on
    the first max(n_rounds) rows; gathering each round's occupied columns
    (``sparse_cap``) changes nothing."""
    rng = np.random.default_rng(2)
    _, _, _, tcfg, tkn, st0 = _batch(LANES)
    line, meta = _events(rng, len(LANES), 48)
    n_r = torch.tensor([0, 12, 30, 5, 30, 1], dtype=torch.int32)
    line_t, meta_t = torch.as_tensor(line), torch.as_tensor(meta)
    want = rops.lanes_plain(tcfg, tkn, st0, line_t[:, :30], meta_t[:, :30])
    for cap in (0, 8, 64):
        got = rops.rounds(tcfg, tkn, st0, line_t, meta_t, n_r,
                          sparse_cap=cap)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b), cap
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[0].tick.tolist() == [30] * len(LANES)
    none = rops.rounds(tcfg, tkn, st0, line_t, meta_t,
                       torch.zeros(len(LANES), dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(none[0], st0))
    assert int(none[1].abs().sum()) == 0


def test_padding_rounds_change_only_the_tick():
    rng = np.random.default_rng(4)
    _, _, _, tcfg, tkn, st = _batch(LANES)
    line, meta = _events(rng, len(LANES), 32)
    st, _, _ = rops.rounds(tcfg, tkn, st, torch.as_tensor(line),
                           torch.as_tensor(meta))
    pad = torch.full((len(LANES), 16, SETS), -1, dtype=torch.int32)
    st2, s2, p2 = rops.rounds(tcfg, tkn, st, pad, torch.zeros_like(pad))
    for f, a, b in zip(st._fields, st2, st):
        if f == "tick":
            assert torch.equal(a, b + 16)
        else:
            assert torch.equal(a, b), f
    assert int(s2.abs().sum()) == 0 and int(p2.abs().sum()) == 0


def test_pack_knobs_matches_the_configs():
    cfgs = [tllc.LLCConfig(size_bytes=SETS * 64 * 16, **k) for k in LANES]
    packed = rops.pack_knobs(tllc.lane_knobs(cfgs, "cpu"))
    assert packed.dtype == torch.int32 and packed.shape == (len(LANES), 5)
    for row, cfg in zip(packed.tolist(), cfgs):
        assert row == [cfg.accel_mode, int(cfg.core_bypass),
                       int(cfg.shared_predictor), cfg.core_way_mask,
                       cfg.accel_way_mask]
        assert rops.config_knobs(cfg, "cpu").tolist() == [row]


def test_wrappers_raise_without_a_card(monkeypatch):
    """On the CPU the wrappers take the plain loop only because the
    tensors lie on the CPU: a CUDA request without a card raises, and a
    tensor on another device is refused, never run elsewhere."""
    _, _, _, tcfg, tkn, st = _batch(LANES[:2])
    line = torch.full((2, 8, SETS), -1, dtype=torch.int32)
    meta = torch.zeros_like(line)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllc.simulate_epoch_lanes(tcfg, tkn, st, line, meta)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllc.simulate_epoch(tcfg, tllc.lane_state(st, 0), line[0], meta[0])
    with pytest.raises(ValueError, match="unsupported device"):
        rops.rounds(tcfg, tkn, st, line.to("meta"), meta.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rops.rounds_one(tcfg, tllc.lane_state(st, 0), line[0].to("meta"),
                        meta[0].to("meta"))


def test_source_keeps_one_launch_and_its_barriers():
    """The CUDA source launches the path's kernel (one thread-block cluster
    per lane) once a call, keeps a cluster barrier between a round's SHCT
    reads and the adds of its deltas, and keeps the first design as
    ``llc_rounds_simple`` with its own one launch."""
    import os
    import re
    from repro_torch.kernels import _build
    with open(os.path.join(_build.CSRC, "llc_rounds.cu")) as f:
        src = f.read()
    # one cluster launch: the C entry point llc_rounds goes through
    # launch_shaped at the full stage, whose one cudaLaunchKernelEx carries
    # the cluster dimension
    entry = src[src.index('extern "C" int llc_rounds(const int* line'):]
    entry = entry[:entry.index("\n}\n")]
    assert entry.count("launch_shaped(") == 1 and "kAll" in entry
    assert src.count("cudaLaunchKernelEx(") == 1
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "llc_rounds_cluster_kernel<true, kAll>" in src
    assert "llc_rounds_cluster_kernel<false, kAll>" in src
    # in the cluster kernel: the SHCT reads, then a cluster barrier, then
    # the adds of the round's deltas
    body = src[src.index("llc_rounds_cluster_kernel(Params p)"):
               src.index("llc_rounds_cluster_empty_kernel")]
    read = body.index("table_at<kSmemTables>(tc, sig_e)")
    post = body.index("cluster.map_shared_rank(box, c)")
    barrier = body.index("cluster.sync();", post)
    add = body.index("atomicAdd(((word & 4) ? ta : tc)")
    assert read < post < barrier < add
    assert re.search(r"if \(!\(\(bars >> j\) & 1u\)\) continue;", body)
    # the first design, on no path
    assert src.count("llc_rounds_simple_kernel<<<") == 1
    assert "__syncthreads_or(mine)" in src
    # the paths' LLCs: 1024 sets, and 2048 at fig. 16's 16 MB
    assert 2 * tllc.LLCConfig().num_sets <= rops.MAX_SETS


# ---------------------------------------------------------------------------
# the edges the cluster kernel brings out (its sets cut into CTAs, a group of
# lanes a set, SHCT deltas from several CTAs in one round), held between the
# plain loop and the JAX engine
# ---------------------------------------------------------------------------
def _jax_and_plain(cfg_kw, lanes, line, meta, init=None):
    """One chunk through the JAX ``simulate_epoch_lanes`` and the port's
    plain loop from fresh states (``init``: (lane, entry, value) set in
    the core SHCT table first); both results, states compared bitwise."""
    jcfgs = [jllc.LLCConfig(**cfg_kw, **k) for k in lanes]
    tcfgs = [tllc.LLCConfig(**cfg_kw, **k) for k in lanes]
    jst = jllc.stack_states(jcfgs[0], len(lanes))
    tst = tllc.stack_states(tcfgs[0], len(lanes), "cpu")
    if init is not None:
        lane, entry, value = init
        jst = jst._replace(shct_core=jst.shct_core.at[lane, entry].set(value))
        tst.shct_core[lane, entry] = value
    jst, js, jp = jllc.simulate_epoch_lanes(jcfgs[0], jllc.lane_knobs(jcfgs),
                                            jst, jnp.asarray(line),
                                            jnp.asarray(meta))
    tst, ts, tp = rops.rounds(tcfgs[0], tllc.lane_knobs(tcfgs, "cpu"), tst,
                              torch.as_tensor(line), torch.as_tensor(meta))
    _assert_same(tst, ts, tp, jst, js, jp, f"{cfg_kw} {lanes}")
    return tcfgs[0], tst, ts


def _collision_chunk(sets, ways):
    """ways + 1 rounds in which sampler sets 0 and sets / 2 (in different
    CTAs of any cluster of 2 or more) post +1 and -1 on one SHCT entry in
    the last round: set 0 hits line 0, inserted in round 0; set sets / 2
    evicts line 1 (the same 32-line region, so the same signature),
    inserted in round 0 and never reused, after lines of other regions
    filled its ways."""
    rounds = ways + 1
    line = np.full((1, rounds, sets), -1, dtype=np.int32)
    half = sets // 2
    line[0, 0, 0], line[0, 0, half] = 0, 1
    for r in range(1, ways):
        line[0, r, half] = 64 * r
    line[0, ways, 0], line[0, ways, half] = 0, 64 * ways
    meta = np.where(line >= 0, jllc.M_VALID, 0).astype(np.int32)
    return line, meta


@pytest.mark.parametrize("at", ["zero", "counter_max"])
def test_opposite_deltas_from_two_ctas_sum_then_clip(at):
    """+1 and -1 on one SHCT entry in the same round from sets that fall in
    different CTAs of the cluster: the deltas are summed, then clipped, so
    an entry at 0 or at counter_max ends where it was (adding and clipping
    them one by one would end at 1 or counter_max - 1)."""
    line, meta = _collision_chunk(SETS, 16)
    cfg = tllc.LLCConfig(size_bytes=SETS * 64 * 16)
    entry = int(ship_signature(torch.tensor([0]), cfg.ship)[0])
    assert entry == int(ship_signature(torch.tensor([1]), cfg.ship)[0])
    value = 0 if at == "zero" else cfg.ship.counter_max
    _, tst, ts = _jax_and_plain(dict(size_bytes=SETS * 64 * 16), [{}], line,
                                meta, init=(0, entry, value))
    assert int(tst.shct_core[0, entry]) == value
    assert int(ts[0, 0]) == 1 and int(ts[0, 7]) == 1   # the hit, the eviction


@pytest.mark.parametrize("ways", [8, 32])
def test_plain_rounds_match_jax_other_ways(ways):
    """8 and 32 ways (a group of 8 or 32 lanes a set in the cluster
    kernel), the knobs of LANES with their masks over all ways, and a lane
    whose accel events may use no way; chained chunks of 8 and 24
    rounds."""
    rng = np.random.default_rng(ways)
    full = (1 << ways) - 1
    lanes = [dict(kw, **{k: (v | v << 16) & full for k, v in kw.items()
                         if k.endswith("_way_mask")}) for kw in LANES]
    lanes.append(dict(accel_mode=1, core_bypass=True, accel_way_mask=0))
    kw = dict(size_bytes=SETS * 64 * ways, ways=ways)
    jcfgs = [jllc.LLCConfig(**kw, **k) for k in lanes]
    tcfgs = [tllc.LLCConfig(**kw, **k) for k in lanes]
    jst = jllc.stack_states(jcfgs[0], len(lanes))
    tst = tllc.stack_states(tcfgs[0], len(lanes), "cpu")
    jkn, tkn = jllc.lane_knobs(jcfgs), tllc.lane_knobs(tcfgs, "cpu")
    for r in (8, 24):
        line, meta = _events(rng, len(lanes), r, n_tags=3 * ways)
        jst, js, jp = jllc.simulate_epoch_lanes(jcfgs[0], jkn, jst,
                                                jnp.asarray(line),
                                                jnp.asarray(meta))
        tst, ts, tp = rops.rounds(tcfgs[0], tkn, tst, torch.as_tensor(line),
                                  torch.as_tensor(meta))
        _assert_same(tst, ts, tp, jst, js, jp, f"W={ways} R={r}")


def test_no_way_allowed_takes_way_0():
    """An insert for a side whose way mask allows no way goes to way 0
    (the argmin over all-excluded ways), evicting what is there, although
    other ways are empty."""
    line = np.full((1, 2, SETS), -1, dtype=np.int32)
    line[0, :, 5] = (5, 5 + SETS)
    meta = np.where(line >= 0, jllc.M_VALID | jllc.M_ACCEL, 0).astype(
        np.int32)
    _, tst, ts = _jax_and_plain(dict(size_bytes=SETS * 64 * 8, ways=8),
                                [dict(accel_way_mask=0)], line, meta)
    assert tst.tags[0, 5].tolist() == [5 + SETS] + [-1] * 7
    assert int(ts[0, 7]) == 1     # one eviction
