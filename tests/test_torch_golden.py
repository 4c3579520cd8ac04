"""The golden files chip_smoke.py holds the card's runs to (the data
point, the test_system spec, fig. 17's scheduler cell and the serving
model) are what the JAX package computes: regenerate each in the reference child and compare
with the committed file, field for field.  The serving golden is also held
to the port on the CPU, through the same checks chip_smoke.py runs on the
card (phases 8g and 9)."""
import importlib.util
import json
import os

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
    on (tests/test_torch_models.py, chip_smoke.py)."""
    from test_torch_models import LOGIT_RTOL, REF_GAP
    with open(LM_GOLDEN) as f:
        committed = json.load(f)
    assert committed == lm_golden
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
    from test_torch_train import GRAD_GAP, LOSS_GAP
    fresh = _fresh(tmp_path, "train_golden")
    with open(TRAIN_GOLDEN) as f:
        committed = json.load(f)
    assert committed == fresh
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
                       "ssm_golden": "rwkv6_1_6b_w2_serve.json"}


@pytest.mark.parametrize("mode", sorted(FAMILY_GOLDEN_FILES))
def test_family_golden_file_is_the_reference(mode, tmp_path):
    """The moe and ssm serving goldens are what the JAX package computes
    (``FAMILY_GOLDENS`` of the reference child), with its own route gaps;
    chip_smoke.py phase 14g takes its bar from them."""
    from test_torch_models import LOGIT_RTOL
    from test_torch_sim import FAMILY_GOLDENS
    fresh = _fresh(tmp_path, mode)
    with open(os.path.join(GOLDEN_DIR, FAMILY_GOLDEN_FILES[mode])) as f:
        committed = json.load(f)
    assert committed == fresh
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


@pytest.mark.usefixtures("torch_one_thread")
@pytest.mark.parametrize("mode", sorted(FAMILY_GOLDEN_FILES))
def test_port_matches_family_golden_on_the_cpu(mode):
    """chip_smoke.py's phase 14g check on the CPU (the full-width model
    with the golden's depth: both prefill routes and the decode steps
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
