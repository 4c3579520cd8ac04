"""The golden files chip_smoke.py holds the card's runs to are what the
JAX package computes: regenerate each in the reference child and compare
with the committed file, field for field."""
import json
import os

import pytest

from test_torch_sim import ROOT, SYSTEM_POLICIES, run_child

GOLDEN_DIR = os.path.join(ROOT, "src", "repro_torch", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "config3_moti2_full.json")
SYSTEM = os.path.join(GOLDEN_DIR, "config3_moti2_full_system.json")


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
