"""The golden files chip_smoke.py holds the card's runs to (the data
point, the test_system spec, fig. 17's scheduler cell and the serving
model) are what the JAX package computes: regenerate each in the reference child and compare
with the committed file, field for field.  The serving golden is also held
to the port on the CPU, through the same checks chip_smoke.py runs on the
card (phases 8g and 9)."""
import importlib.util
import json
import os

import numpy as np
import pytest

from test_torch_sim import (ROOT, SYSTEM_POLICIES, run_child,
                            torch_one_thread)  # noqa: F401

GOLDEN_DIR = os.path.join(ROOT, "src", "repro_torch", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "config3_moti2_full.json")
SYSTEM = os.path.join(GOLDEN_DIR, "config3_moti2_full_system.json")
LM_GOLDEN = os.path.join(GOLDEN_DIR, "qwen3_1_7b_w2_serve.json")
TRAIN_GOLDEN = os.path.join(GOLDEN_DIR, "qwen3_1_7b_w2_train.json")
SCHED = os.path.join(GOLDEN_DIR, "config1_sched.json")


def _fresh(tmp_path, mode):
    out = str(tmp_path / f"{mode}.json")
    run_child(mode, out, str(tmp_path / "cache"), timeout=900)
    with open(out) as f:
        return json.load(f)


def test_golden_file_is_the_reference(tmp_path):
    fresh = _fresh(tmp_path, "golden")
    with open(GOLDEN) as f:
        committed = json.load(f)
    assert committed == fresh
    hy, sd = committed["points"]["hydra"], committed["points"]["arp-cs-as-d"]
    # the tests/test_system.py orderings chip_smoke.py checks on the card
    assert hy["summary"]["dmr"] == 0.0
    assert hy["summary"]["ipc"] > sd["summary"]["ipc"]
    assert hy["summary"]["accel_br"] > sd["summary"]["accel_br"]


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    return _fresh(tmp_path_factory.mktemp("system"), "system")


def test_system_golden_file_is_the_reference(system):
    with open(SYSTEM) as f:
        committed = json.load(f)
    assert committed == system
    assert committed["policies"] == list(SYSTEM_POLICIES)
    assert sorted(committed["points"]) == sorted(SYSTEM_POLICIES)
    assert committed["lern_accuracy"]["accuracy"] > 0.7


def test_system_golden_holds_the_paper_orderings(system):
    """tests/test_system.py's claims, on the committed numbers (the card's
    run must equal them); the segmented golden's two points agree too,
    since both fit engines give the same cluster tables."""
    pts = {k: v["summary"] for k, v in system["points"].items()}
    assert pts["arp-nb"]["dmr"] == 0.0 and pts["hydra"]["dmr"] == 0.0
    assert pts["arp-cs-as-d"]["dmr"] <= pts["arp-cs-as"]["dmr"]
    assert pts["arp-cs-as-d"]["accel_br"] <= pts["arp-cs-as"]["accel_br"]
    assert pts["hydra"]["ipc"] > pts["arp-cs-as-d"]["ipc"]
    assert pts["hydra"]["accel_br"] > pts["arp-cs-as-d"]["accel_br"]
    assert (system["points"]["hydra"]["core_hit_rate"]
            > system["points"]["arp-nb"]["core_hit_rate"])
    with open(GOLDEN) as f:
        segmented = json.load(f)
    for name, want in segmented["points"].items():
        got = system["points"][name]
        assert {k: got[k] for k in want} == want, name


def test_sched_golden_file_is_the_reference(tmp_path):
    """fig. 17's scheduler cell: the JAX package's host and fused engines
    agree, and fig. 17's sched_dmr_delta (the largest |SQUASH - FR-FCFS|
    dmr difference) is above 0, the floor its trend gate holds."""
    fresh = _fresh(tmp_path, "sched")
    with open(SCHED) as f:
        committed = json.load(f)
    assert committed == fresh
    assert committed["preset"] == "full"
    assert committed["points"]["host"] == committed["points"]["fused"]
    assert committed["sched_dmr_delta"] > 0


@pytest.fixture(scope="module")
def lm_golden(tmp_path_factory):
    return _fresh(tmp_path_factory.mktemp("lm_golden"), "lm_golden")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_golden_file_is_the_reference(lm_golden):
    """The serving golden is what the JAX package computes, and its own
    flash and plain routes stay inside the gap the tolerance is built
    on (tests/test_torch_models.py, chip_smoke.py).  The prefill digests'
    floats and the route gap vary with the host that runs the reference
    (up to 0.34 % of max |logit|, and a gap of 0.011701 against the
    committed 0.011513, measured): the digests are held as the family
    goldens' are, the regenerated gap inside the bar built on the
    committed one; everything else is exact."""
    from test_torch_models import LOGIT_RTOL, REF_GAP
    with open(LM_GOLDEN) as f:
        committed = json.load(f)
    fresh, want = dict(lm_golden), dict(committed)
    got_pre, want_pre = fresh.pop("prefill"), want.pop("prefill")
    gap = fresh.pop("ref_gap")
    want.pop("ref_gap")
    assert fresh == want
    assert sorted(got_pre) == sorted(want_pre)
    for route, digest in want_pre.items():
        _hold_digest(got_pre[route], digest, LOGIT_RTOL, f"prefill/{route}")
    assert 0.0 <= gap <= LOGIT_RTOL
    assert committed["ref_gap"] <= REF_GAP
    cs = _chip_smoke()
    assert (cs.REF_GAP, cs.LOGIT_RTOL) == (REF_GAP, LOGIT_RTOL)
    assert committed["serve"]["stats"]["completed"] == len(
        committed["serve"]["requests"])


def test_train_golden_file_is_the_reference(tmp_path):
    """The training golden is what the JAX package computes: three steps
    of its train step, step 0's gradient norms and its own dense-versus-
    chunked gap, which stays inside the gap the training tolerance is built
    on (tests/test_torch_train.py); chip_smoke.py takes its bars from it."""
    from test_torch_sim import TRAIN_GOLDEN as SPEC
    from test_torch_train import GRAD_GAP, GRAD_RTOL, LOSS_GAP, LOSS_RTOL
    fresh = _fresh(tmp_path, "train_golden")
    with open(TRAIN_GOLDEN) as f:
        committed = json.load(f)
    _hold_train_golden(fresh, committed, _chip_smoke().train_bars(committed),
                       {"loss": LOSS_RTOL, "grad": GRAD_RTOL})
    assert {k: committed[k] for k in SPEC} == SPEC
    assert committed["ref_gap"]["loss"] <= LOSS_GAP
    assert committed["ref_gap"]["grad"] <= GRAD_GAP
    steps = committed["steps_out"]
    assert len(steps) == SPEC["steps"] and steps[0]["lr"] == 0.0
    assert all(s["loss"] > 0 and s["grad_norm"] > 0 for s in steps)
    assert len(committed["grad_norms"]["layers/attn/wq"]) == \
        SPEC["n_layers"]
    cs = _chip_smoke()
    assert cs.train_bars(committed) == {
        "loss": max(2 * committed["ref_gap"]["loss"], 1e-3),
        "grad": max(2 * committed["ref_gap"]["grad"], 2e-2)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float((np.abs(got - want) / np.maximum(np.abs(want),
                                                  1e-300)).max())


def _hold_train_golden(fresh: dict, committed: dict, bars: dict,
                       gap_bars: dict) -> None:
    """The regenerated training golden against the committed one.  The
    losses, the grad norms and the JAX package's own dense-versus-chunked
    gaps vary with the host that runs the reference (grad norms up to
    5.2e-4 relative, the grad gap 0.02545 against the committed 0.01642,
    measured): losses and grad norms are held within half the bars
    chip_smoke.py takes from the committed file (``bars``), each
    regenerated gap inside the training tolerance built on the measured
    ones (``gap_bars``); everything else is exact."""
    fresh, committed = dict(fresh), dict(committed)
    got_steps, want_steps = fresh.pop("steps_out"), committed.pop(
        "steps_out")
    got_norms, want_norms = fresh.pop("grad_norms"), committed.pop(
        "grad_norms")
    got_gap = fresh.pop("ref_gap")
    committed.pop("ref_gap")
    assert fresh == committed
    assert len(got_steps) == len(want_steps)
    for got, want in zip(got_steps, want_steps):
        assert sorted(got) == sorted(want) and got["lr"] == want["lr"]
        assert _rel(got["loss"], want["loss"]) <= 0.5 * bars["loss"]
        assert _rel(got["grad_norm"], want["grad_norm"]) <= \
            0.5 * bars["grad"]
    assert sorted(got_norms) == sorted(want_norms)
    for leaf, want in want_norms.items():
        assert np.shape(got_norms[leaf]) == np.shape(want), leaf
        assert _rel(got_norms[leaf], want) <= 0.5 * bars["grad"], leaf
    assert sorted(got_gap) == sorted(gap_bars)
    for k, bar in gap_bars.items():
        assert 0.0 <= got_gap[k] <= bar, k


@pytest.mark.usefixtures("torch_one_thread")
def test_port_matches_lm_golden_on_the_cpu():
    """chip_smoke.py's phase 8g and phase 9 checks on the CPU: the 2-layer
    full-width model's prefill (both routes) and decode logits against the
    JAX golden, and the engine's stats on the reduced config (they depend
    on scheduling only)."""

    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    cs = _chip_smoke()
    with open(LM_GOLDEN) as f:
        golden = json.load(f)
    got = cs.check_lm_golden(golden, "cpu")
    assert got["worst_rel"] <= cs.LOGIT_RTOL
    cfg = get_arch(golden["arch"]).reduced()
    params = lm_params_from_numpy(lm_numpy_params(cfg, seed=0), cfg, "cpu")
    eng = cs.run_engine(cfg, params, golden["serve"], "cpu")
    assert eng["stats"] == golden["serve"]["stats"]



FAMILY_GOLDEN_FILES = {"moe_golden": "qwen2_moe_a2_7b_w1_serve.json",
                       "ssm_golden": "rwkv6_1_6b_w2_serve.json",
                       "hybrid_golden": "zamba2_2_7b_w2_serve.json",
                       "encdec_golden": "whisper_base_serve.json",
                       "vlm_golden": "paligemma_3b_w1_serve.json"}


# the logit digests' floats (prefill and decode), which depend on the host
# the reference runs on (its CPU's XLA kernels); every other field of a
# family golden does not
DIGEST_FLOATS = ("lse", "max_abs", "sampled", "top8_val")


def _top8_equal_up_to_ties(got_idx, want_idx, got_val, want_val,
                           tol: float, where: str) -> None:
    """A row's top-8 indices equal the committed ones, except that entries
    whose committed values lie within ``tol`` of each other may swap, and
    an entry may cross the eighth place at a value within ``tol`` of it."""
    if got_idx == want_idx:
        return
    want_v = dict(zip(want_idx, want_val))
    got_v = dict(zip(got_idx, got_val))
    for i in set(want_idx) - set(got_idx):
        assert want_v[i] - want_val[-1] <= tol, (where, "left", i)
    for i in set(got_idx) - set(want_idx):
        assert got_v[i] - got_val[-1] <= tol, (where, "entered", i)
    both = [i for i in want_idx if i in got_v]
    rank = {i: r for r, i in enumerate(i for i in got_idx if i in want_v)}
    for a, i in enumerate(both):
        for j in both[a + 1:]:
            if rank[j] < rank[i]:
                assert abs(want_v[i] - want_v[j]) <= tol, (where, i, j)


def _hold_digest(got: dict, want: dict, bar: float, where: str) -> None:
    """One logit digest: its floats (``DIGEST_FLOATS``) within half the
    family bar x the committed max |logit|, its top-8 indices equal up to
    such near ties."""
    assert sorted(got) == sorted(want), where
    tol = 0.5 * bar * max(want["max_abs"])
    for k in DIGEST_FLOATS:
        g, w = np.asarray(got[k], float), np.asarray(want[k], float)
        assert g.shape == w.shape, (where, k)
        assert np.abs(g - w).max() <= tol, (where, k)
    for row, (gi, wi) in enumerate(zip(got["top8_idx"], want["top8_idx"])):
        _top8_equal_up_to_ties(gi, wi, got["top8_val"][row],
                               want["top8_val"][row], tol, f"{where}[{row}]")


def _hold_family_golden(fresh: dict, committed: dict, bar: float) -> None:
    """The regenerated golden against the committed one: every field
    equal, except the logit digests of the prefill routes and the decode
    steps, held by ``_hold_digest``."""
    fresh, committed = dict(fresh), dict(committed)
    got_pre, want_pre = fresh.pop("prefill"), committed.pop("prefill")
    got_dec, want_dec = fresh.pop("decode"), committed.pop("decode")
    assert fresh == committed
    assert sorted(got_pre) == sorted(want_pre)
    for route, want in want_pre.items():
        _hold_digest(got_pre[route], want, bar, f"prefill/{route}")
    assert len(got_dec) == len(want_dec)
    for t, (got, want) in enumerate(zip(got_dec, want_dec)):
        _hold_digest(got, want, bar, f"decode[{t}]")


@pytest.mark.parametrize("mode", sorted(FAMILY_GOLDEN_FILES))
def test_family_golden_file_is_the_reference(mode, tmp_path):
    """The family serving goldens (moe, ssm; hybrid, encdec, vlm) are what
    the JAX package computes (``FAMILY_GOLDENS`` of the reference child),
    with its own route gaps and, for encdec and vlm, the digest of the
    seeded frontend embeddings; chip_smoke.py phases 14g and 15g take
    their bar from them.  The logit digests' floats vary with the host
    that runs the reference (up to 0.66 % of max |logit| measured), so
    they are held within half the family bar; everything else is exact."""
    from test_torch_models import LOGIT_RTOL
    from test_torch_sim import FAMILY_GOLDENS
    fresh = _fresh(tmp_path, mode)
    with open(os.path.join(GOLDEN_DIR, FAMILY_GOLDEN_FILES[mode])) as f:
        committed = json.load(f)
    _hold_family_golden(fresh, committed,
                        _chip_smoke().family_bar(committed))
    spec = FAMILY_GOLDENS[mode]
    assert {k: committed[k] for k in spec} == spec
    assert committed["ref_gap"] == committed["route_gaps"]["attention"]
    assert len(committed["decode"]) == spec["decode_steps"]
    if "moe" in mode:
        assert committed["topk_flips"]["of"] == (
            spec["batch"] * spec["seq"] * 4)
        assert len(committed["router"]) == 1 + spec["decode_steps"]
    assert committed["serve"]["stats"]["completed"] == len(
        committed["serve"]["requests"])
    assert _chip_smoke().family_bar(committed) == max(
        2 * committed["ref_gap"], LOGIT_RTOL)
    assert ("embeds_digest" in committed) == (
        spec["arch"] in ("whisper-base", "paligemma-3b"))


@pytest.mark.usefixtures("torch_one_thread")
@pytest.mark.parametrize("mode", sorted(FAMILY_GOLDEN_FILES))
def test_port_matches_family_golden_on_the_cpu(mode):
    """chip_smoke.py's phase 14g and 15g check on the CPU (the full-width
    model with the golden's depth: both prefill routes and the decode steps
    against the JAX logits), and the engine's stats on the reduced arch
    (they depend on scheduling only)."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    cs = _chip_smoke()
    with open(os.path.join(GOLDEN_DIR, FAMILY_GOLDEN_FILES[mode])) as f:
        golden = json.load(f)
    got = cs.check_family_golden(golden, "cpu")
    assert got["worst_rel"] <= cs.family_bar(golden)
    cfg = get_arch(golden["arch"]).reduced()
    params = lm_params_from_numpy(lm_numpy_params(cfg, seed=0), cfg, "cpu")
    eng = cs.run_engine(cfg, params, golden["serve"], "cpu")
    assert eng["stats"] == golden["serve"]["stats"]
