"""The port's scheduled bank/rank DRAM backend against the JAX package:
``epoch_compute``'s torch twin (a lane axis) and numpy twin, and
``host_epoch``, bitwise against the reference's numpy twin called
in-process with ``xp=np`` (as tests/test_dramsched.py runs its numpy leg)
over chained epochs; the scatter helpers at their edges; the models'
geometry and timing tuples."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dram as jdram, dramsched as jds
from repro_torch.core import dram as tdram, dramsched as tds

MODELS = ("DDR4_2400_32b2r_squash", "DDR4_2400_32b2r_frfcfs",
          "DDR3_1600_8b1r_squash")
ET = 50_000


def _ref_epoch(model, state, samp, am, cm, pf, urgent, epoch):
    """The reference's numpy twin for one lane: (outputs, next state)."""
    out = jds.epoch_compute(
        np, jds.sched_dims(model), jds.timing_tuple(model), state[0],
        state[1], np.int64(state[2]), np.asarray(samp, np.int64),
        np.int64(am), np.int64(cm), np.int64(pf), bool(urgent),
        np.int64(epoch), np.int64(ET))
    return [int(v) for v in out[:4]], (out[4], out[5], int(out[6]))


def _inputs(rng, model, n_lanes, epoch):
    """One epoch's seeded inputs for ``n_lanes`` lanes; every few epochs
    some lanes get no accel misses (no present sample: the scatter-max
    of every bank stays at its fill)."""
    samp = rng.integers(0, 1 << 20, (n_lanes, model.samples), dtype=np.int64)
    if epoch % 4 == 1:   # few rows: many same-bank, same-row samples
        samp &= (1 << 9) - 1
    am = rng.integers(0, 3000, n_lanes)
    if epoch % 5 == 3:
        am[::2] = 0
    return (samp, am, rng.integers(0, 1500, n_lanes),
            rng.integers(0, 300, n_lanes), rng.random(n_lanes) < 0.5)


@pytest.mark.parametrize("name", MODELS)
def test_epoch_compute_twins_match_reference(name):
    """30 chained epochs of 4 lanes: the torch twin (one call for all
    lanes), the port's numpy twin and ``host_epoch`` each equal the
    reference's numpy twin lane by lane -- every output and the state
    fed forward on each side independently."""
    jm, tm = jdram.MODELS[name], tdram.MODELS[name]
    rng = np.random.default_rng(11)
    n_l = 4
    ref = [(jds.host_init(jm).row, jds.host_init(jm).queue, 0)
           for _ in range(n_l)]
    host = [tds.host_init(tm) for _ in range(n_l)]
    npy = [(tds.host_init(tm).row, tds.host_init(tm).queue, 0)
           for _ in range(n_l)]
    t_row = torch.full((n_l, tm.banks), -1, dtype=torch.int64)
    t_queue = torch.zeros((n_l, tm.banks), dtype=torch.int64)
    t_rr = torch.zeros(n_l, dtype=torch.int64)
    dims, timing = tds.sched_dims(tm), tds.timing_tuple(tm)
    for epoch in range(30):
        samp, am, cm, pf, urg = _inputs(rng, tm, n_l, epoch)
        got = tds.epoch_compute(
            torch, dims, timing, t_row, t_queue, t_rr, torch.as_tensor(samp),
            torch.as_tensor(am), torch.as_tensor(cm), torch.as_tensor(pf),
            torch.as_tensor(urg), torch.full((n_l,), epoch),
            torch.full((n_l,), ET))
        for i in range(n_l):
            want, ref[i] = _ref_epoch(jm, ref[i], samp[i], am[i], cm[i],
                                      pf[i], urg[i], epoch)
            assert [int(v[i]) for v in got[:4]] == want, (epoch, i)
            np.testing.assert_array_equal(got[4][i].numpy(), ref[i][0])
            np.testing.assert_array_equal(got[5][i].numpy(), ref[i][1])
            assert int(got[6][i]) == ref[i][2]
            out = tds.epoch_compute(
                np, dims, timing, npy[i][0], npy[i][1], npy[i][2], samp[i],
                am[i], cm[i], pf[i], bool(urg[i]), epoch, ET)
            assert [int(v) for v in out[:4]] == want
            npy[i] = (out[4], out[5], int(out[6]))
            w = tds.host_epoch(host[i], tm, samp[i], int(am[i]), int(cm[i]),
                               int(pf[i]), bool(urg[i]), epoch, ET)
            assert w == (want[0] / want[1], want[2] / want[3])
            np.testing.assert_array_equal(host[i].row, ref[i][0])
            np.testing.assert_array_equal(host[i].queue, ref[i][1])
            assert host[i].rr == ref[i][2]
        t_row, t_queue, t_rr = got[4], got[5], got[6]
        for a, b in zip((t_row, t_queue), (npy[0][0], npy[0][1])):
            assert a.dtype == torch.int64 and b.dtype == np.int64


def test_scatter_helpers_match_numpy_at_their_edges():
    """Empty index sets keep the fill (``np.maximum.at``); repeated
    indices add and take the max; the torch helpers work row by row."""
    rng = np.random.default_rng(3)
    for fill in (-1, 0, 7):
        idx = rng.integers(0, 8, (3, 12))
        idx[1] = 5                              # one index for every value
        vals = rng.integers(-4, 40, (3, 12))
        vals[2] = -9                            # below the fill everywhere
        got_max = tds._scatter_max(torch, 8, fill, torch.as_tensor(idx),
                                   torch.as_tensor(vals))
        got_add = tds._scatter_add(torch, 8, torch.as_tensor(idx),
                                   torch.as_tensor(vals))
        for r in range(3):
            want = np.full(8, fill, np.int64)
            np.maximum.at(want, idx[r], vals[r])
            np.testing.assert_array_equal(got_max[r].numpy(), want)
            np.testing.assert_array_equal(
                tds._scatter_max(np, 8, fill, idx[r], vals[r]), want)
            want = np.zeros(8, np.int64)
            np.add.at(want, idx[r], vals[r])
            np.testing.assert_array_equal(got_add[r].numpy(), want)
    # a shared 1-D index (the ranks of the banks) over a lane axis
    got = tds._scatter_add(torch, 2, torch.as_tensor([0, 0, 1, 1]),
                           torch.as_tensor([[1, 2, 3, 4], [5, 6, 7, 8]]))
    assert got.tolist() == [[3, 7], [11, 15]]


@pytest.mark.parametrize("name", MODELS)
def test_sched_dims_timing_and_windows_match(name):
    jm, tm = jdram.MODELS[name], tdram.MODELS[name]
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert tuple(jds.sched_dims(jm)) == tuple(tds.sched_dims(tm))
    assert tds.sched_dims(tm).bank_bits == jds.sched_dims(jm).bank_bits
    assert jds.timing_tuple(jm) == tds.timing_tuple(tm)
    line = np.random.default_rng(1).integers(0, 1 << 24, 5000)
    for pos, n_a in ((0, 0), (17, 1), (100, 31), (200, 4000), (4999, 1)):
        np.testing.assert_array_equal(
            jds.sample_window(line, pos, n_a, jm.samples),
            tds.sample_window(line, pos, n_a, tm.samples))
