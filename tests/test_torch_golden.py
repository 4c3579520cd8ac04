"""The golden file chip_smoke.py holds the card's run to is what the JAX
package computes: regenerate it in the reference child and compare with
the committed file, field for field."""
import json
import os

from test_torch_sim import ROOT, run_child

GOLDEN = os.path.join(ROOT, "src", "repro_torch", "golden",
                      "config3_moti2_full.json")


def test_golden_file_is_the_reference(tmp_path):
    out = str(tmp_path / "golden.json")
    run_child("golden", out, str(tmp_path / "cache"), timeout=900)
    with open(out) as f:
        fresh = json.load(f)
    with open(GOLDEN) as f:
        committed = json.load(f)
    assert committed == fresh
    hy, sd = committed["points"]["hydra"], committed["points"]["arp-cs-as-d"]
    # the tests/test_system.py orderings chip_smoke.py checks on the card
    assert hy["summary"]["dmr"] == 0.0
    assert hy["summary"]["ipc"] > sd["summary"]["ipc"]
    assert hy["summary"]["accel_br"] > sd["summary"]["accel_br"]
