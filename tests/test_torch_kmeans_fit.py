"""The whole-fit k-means wrappers on the CPU: ``kmeans_assign.ops
.fit_masked`` and ``fit_segmented`` (on the card, the ``kmeans_fit`` and
``kmeans_fit_segmented`` kernels: one launch for a whole Lloyd fit).

* The dispatch rule: a CPU tensor takes the plain fit and counts no
  launch; ``device="cuda"`` raises without CUDA.
* The plain masked fit (what ``kmeans_fit`` computes, bit for bit, on the
  card) against the JAX package's ``kmeans_fit_batched`` on the branches
  of the Lloyd sums' order that the kernel replays, bitwise in centres
  and assignments.  Three cases are the exception (``NOT_BITWISE``): for
  a batch of one at D = 1 with N = 50 and 777 the standalone JAX fit adds
  its sums in another order than the one in ``lern._fit_layer`` that the
  port follows, and at D = 4 with N = 513 (a partial last 256-row block)
  XLA's order is not the padded-block order for every input; the centres
  there are one ulp apart and held within atol 1e-5 as in
  ``tests/test_torch_kmeans.py``.  N = 777 is held bitwise to the JAX
  LERN layer fit.  The paths hand the fit power-of-two capacities.
* The segmented fit in one pass (``first_chunk=iters``: what the kernel
  runs) against the CPU's default two passes with straggler compaction:
  the same centres, assignments and ``n_iter``, on a case with stragglers
  and one where a segment stops at ``iters``; and against the JAX
  ``kmeans_fit_segmented`` (assignments equal, centres within atol 1e-5,
  as in ``tests/test_torch_lern.py``, and ``n_iter`` equal).

The JAX fits run in the reference child of ``tests/test_torch_sim.py``
(mode ``kmeans_fit``), so this file imports neither JAX nor the JAX
package.
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core import kmeans as tkm, lern as tlern, prng
from repro_torch.kernels.kmeans_assign import ops as tkops
from test_torch_sim import (KMEANS_FIT_CASES, KMEANS_SEG_CASES,
                            kmeans_fit_inputs, kmeans_lern_inputs,
                            kmeans_seg_inputs, run_child)
from test_torch_sim import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CENTRE_ATOL = 1e-5
# the standalone JAX fit adds these cases' sums in another order
# (measured: centres up to 5.96e-08 apart)
NOT_BITWISE = ("b1_d1_n50", "b1_d1_n777", "b2_d4_n513")


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_kmeans_fit")
    out = str(d / "kmeans_fit.pkl")
    run_child("kmeans_fit", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


def _keys(seeds):
    return torch.stack([prng.PRNGKey(s) for s in seeds])


def _masked_case(name):
    inp = kmeans_fit_inputs(name)
    x, mask = torch.as_tensor(inp["x"]), torch.as_tensor(inp["mask"])
    centers0 = tkm._plus_plus_init_masked(_keys(inp["seeds"]), x, mask, 4)
    return x, mask, centers0


def test_cpu_tensors_take_the_plain_fits_and_count_no_launches():
    x, mask, c0 = _masked_case("b2_d4_n513")
    seg = kmeans_seg_inputs([13, 8, 29])
    sx, sseg = torch.as_tensor(seg["x"]), torch.as_tensor(seg["seg"])
    sc0 = torch.as_tensor(np.random.default_rng(0).random((3, 4, 4)),
                          dtype=torch.float32)
    before = (tkops.fit_masked.launches, tkops.fit_segmented.launches,
              tkops.assign.launches, tkops.assign_segmented.launches)
    assert torch.equal(tkops.fit_masked(x, mask, c0, 7),
                       tkops.fit_masked_plain(x, mask, c0, 7))
    got = tkops.fit_segmented(sx, sseg, seg["off"], seg["cnt"], sc0, 9)
    want = tkops.fit_segmented_plain(sx, sseg, seg["off"], seg["cnt"], sc0,
                                     9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    inp = kmeans_fit_inputs("b2_d4_n513")
    tkm.kmeans_fit_batched(inp["x"], inp["mask"], _keys(inp["seeds"]),
                           device="cpu")
    tkm.kmeans_fit_segmented(seg["x"], seg["seg"], seg["off"], seg["cnt"],
                             _keys(seg["seeds"]), n_seg=3, device="cpu")
    assert before == (tkops.fit_masked.launches,
                      tkops.fit_segmented.launches, tkops.assign.launches,
                      tkops.assign_segmented.launches)


def test_fits_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = kmeans_fit_inputs("b1_d1_n32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkm.kmeans_fit_batched(inp["x"], inp["mask"], _keys(inp["seeds"]))
    seg = kmeans_seg_inputs([13, 8, 29])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkm.kmeans_fit_segmented(seg["x"], seg["seg"], seg["off"],
                                 seg["cnt"], _keys(seg["seeds"]), n_seg=3)
    x, mask, c0 = (t.to("meta") for t in _masked_case("b1_d1_n32"))
    with pytest.raises(ValueError, match="unsupported device"):
        tkops.fit_masked(x, mask, c0, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tkops.fit_segmented(torch.empty((8, 4), device="meta"),
                            torch.empty(8, dtype=torch.int32, device="meta"),
                            [0], [8], torch.empty((1, 4, 4), device="meta"),
                            3)


@pytest.mark.parametrize("name", [c[0] for c in KMEANS_FIT_CASES])
def test_masked_fit_matches_jax(jax_fits, name):
    inp = kmeans_fit_inputs(name)
    got = tkm.kmeans_fit_batched(inp["x"], inp["mask"], _keys(inp["seeds"]),
                                 k=4, device="cpu")
    centers, assign = jax_fits["masked"][name]
    mask = inp["mask"]
    np.testing.assert_array_equal(got.assign.numpy()[mask], assign[mask])
    if name in NOT_BITWISE:
        np.testing.assert_allclose(got.centers.numpy(), centers,
                                   atol=CENTRE_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(got.centers.numpy(), centers)
    if name.endswith("_empty"):
        # three distinct points for four clusters: the first sweep leaves a
        # cluster empty, and the fit re-seeds it
        x, _, c0 = _masked_case(name)
        a = tkops.assign_plain(x, c0)
        for row, ar in zip(mask, a.numpy()):
            assert len(np.unique(ar[row])) < 4


def test_lern_layer_fit_matches_jax_bitwise(jax_fits):
    """A bucket of one layer at N = 777: the RC fit (D = 1, batch of one,
    the 4 x 8-lane order) and the RI fit (D = 4, a partial last block)
    bitwise against the JAX LERN layer fit."""
    inp = kmeans_lern_inputs()
    got = tlern._fit_layer(torch.as_tensor(inp["f_ri"])[None],
                           torch.as_tensor(inp["f_rc"])[None],
                           torch.as_tensor([inp["n_multi"]]),
                           _keys([inp["seed"]]))
    want = jax_fits["lern"]
    nm = inp["n_multi"]
    np.testing.assert_array_equal(got["rc_centers_norm"][0].numpy(),
                                  want["rc_centers_norm"])
    for f in ("rc_assign", "ri_assign"):
        np.testing.assert_array_equal(got[f][0].numpy()[:nm], want[f][:nm])


def iters_of(name):
    return next(c[2] for c in KMEANS_SEG_CASES if c[0] == name)


def _segmented(name, first_chunk):
    _, sizes, iters = next(c for c in KMEANS_SEG_CASES if c[0] == name)
    inp = kmeans_seg_inputs(sizes)
    res = tkm.kmeans_fit_segmented(inp["x"], inp["seg"], inp["off"],
                                   inp["cnt"], _keys(inp["seeds"]),
                                   n_seg=len(sizes), k=4, iters=iters,
                                   first_chunk=first_chunk, device="cpu")
    return inp, iters, res


@pytest.mark.parametrize("name", [c[0] for c in KMEANS_SEG_CASES])
def test_segmented_one_pass_equals_two_passes(name):
    inp, iters, one = _segmented(name, first_chunk=iters_of(name))
    _, _, two = _segmented(name, first_chunk=6)
    valid = inp["seg"] < len(inp["cnt"])
    np.testing.assert_array_equal(one.centers.numpy(), two.centers.numpy())
    np.testing.assert_array_equal(one.assign.numpy()[valid],
                                  two.assign.numpy()[valid])
    assert one.n_iter == two.n_iter
    # the case does what it is for: segments still sweeping after the
    # first 6-sweep pass; for reaches_iters, one stopped at iters
    x, seg = torch.as_tensor(inp["x"]), torch.as_tensor(inp["seg"])
    c0 = tkm._plus_plus_init_segmented(
        _keys(inp["seeds"]), x, seg, torch.as_tensor(inp["off"]).long(),
        torch.as_tensor(inp["cnt"]).long(), len(inp["cnt"]), 4)
    _, sweeps, conv = tkops.fit_segmented(x, seg, inp["off"], inp["cnt"],
                                          c0, iters)
    assert int(sweeps.max()) == one.n_iter > 6
    assert len(set(sweeps.tolist())) > 1
    if name == "reaches_iters":
        assert one.n_iter == iters and not bool(conv.all())


@pytest.mark.parametrize("name", [c[0] for c in KMEANS_SEG_CASES])
def test_segmented_fit_matches_jax(jax_fits, name):
    inp, _, got = _segmented(name, first_chunk=iters_of(name))
    centers, assign, n_iter = jax_fits["segmented"][name]
    valid = inp["seg"] < len(inp["cnt"])
    np.testing.assert_array_equal(got.assign.numpy()[valid], assign[valid])
    np.testing.assert_allclose(got.centers.numpy(), centers,
                               atol=CENTRE_ATOL, rtol=0)
    assert got.n_iter == n_iter
