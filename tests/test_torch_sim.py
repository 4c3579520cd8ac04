"""The port's whole slice against the JAX package: one paper data point
(trace -> LERN -> L-RPT -> LLC -> SimResult) through ``drive_lane`` on the
CPU, held to ``tests/_reference.py::assert_bitwise`` strength.

The reference runs in a child process.  Under the installed JAX,
``repro.core.sim.cache_load`` reaches ``repro.exp``, which needs the
``jax.experimental.enable_x64`` alias; the child installs it before any
``repro`` import, so no pytest worker ever carries it.  This file is also
that child (``python tests/test_torch_sim.py <mode> <out>``):

* ``small``  -- the three policies of ``test_drive_lane_matches_reference``
                at the small point, pickled as plain dicts;
* ``golden`` -- the numbers ``chip_smoke.py`` holds the card's run to,
                written as JSON.  Regenerate the committed golden file with
                ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py
                golden src/repro_torch/golden/config3_moti2_full.json``.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

CONFIG, MIX = "config3", "moti2"
SMALL = dict(n_inputs=1, max_epochs=60, subsample_target=50_000)
SMALL_DEADLINE = 2e6
FULL = dict(n_inputs=3, max_epochs=1500)
GOLDEN_POLICIES = ("hydra", "arp-cs-as-d")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LERN_FIELDS = ("uniq", "rc_cluster", "ri_cluster", "n_uniq", "rc_centers",
               "ri_centers", "features_ri")
# the fields tests/_reference.py::assert_bitwise compares
BITWISE_FIELDS = ("epochs", "completion_cycles", "core_hit_rate",
                  "accel_hit_rate", "llc_accesses", "dram_accesses",
                  "history", "occupancy")


def small_policies(policies):
    """hydra, arp-cs-as-d and hydra online-LERN with a 20-epoch period
    (so the 21-epoch small point retrains once)."""
    return [policies.get("hydra"), policies.get("arp-cs-as-d"),
            policies.with_online(policies.get("hydra"), 20)]


def run_child(mode: str, out: str, cache: str, timeout: float = 600):
    """Run this file as the reference child; raise with its stderr."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", REPRO_CACHE=cache)
    env.pop("REPRO_DRAM", None)
    env.pop("REPRO_LERN_FIT", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                           out], env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference child failed:\n{proc.stderr[-4000:]}")


def _result_dict(res) -> dict:
    return dataclasses.asdict(res)


def golden_point(res) -> dict:
    """The fields of one SimResult that the golden file keeps."""
    return {"summary": res.summary(), "epochs": res.epochs,
            "llc_accesses": res.llc_accesses,
            "dram_accesses": res.dram_accesses,
            "completion_cycles": list(res.completion_cycles)}


def _child_main(mode: str, out: str) -> None:
    import jax
    import jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _reference import run_reference
    from repro.core import policies, sim
    from repro.core.dram import default_model

    if mode == "small":
        p = sim.SimParams(**SMALL)
        res = {pol.name: _result_dict(run_reference(
            CONFIG, MIX, pol, p, deadline_cycles=SMALL_DEADLINE))
            for pol in small_policies(policies)}
        model = sim.load_lern(CONFIG, "full", SMALL["subsample_target"])
        lern = {f: getattr(model, f) for f in LERN_FIELDS}
        with open(out, "wb") as f:
            pickle.dump({"results": res, "lern": lern}, f)
    elif mode == "golden":
        p = sim.SimParams(**FULL)
        dram = default_model()
        deadline = float(sim.calibrated_deadline(CONFIG, p, dram))
        points = {name: golden_point(run_reference(
            CONFIG, MIX, policies.get(name), p, dram=dram,
            deadline_cycles=deadline)) for name in GOLDEN_POLICIES}
        doc = {"config": CONFIG, "mix": MIX, "params": FULL,
               "dram": dram.name, "deadline_cycles": deadline,
               "points": points}
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    else:
        raise SystemExit(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# the tests (the port runs on the CPU in this process)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    out = str(d / "small.pkl")
    run_child("small", out, str(d / "cache"))
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    return tmp_path


def _port_run(policy, device="cpu"):
    from repro_torch.core import sim
    from repro_torch.core.dram import default_model
    p = sim.SimParams(**SMALL)
    art = sim.load_artifacts(CONFIG, MIX, p)
    lane = sim.Lane(CONFIG, MIX, policy, p, default_model(), SMALL_DEADLINE,
                    art, device=device)
    return sim.drive_lane(lane, device=device)


def _assert_bitwise(got, want: dict, who):
    """tests/_reference.py::assert_bitwise on the reference's dict form."""
    got_d = dataclasses.asdict(got)
    assert got.summary() == {"ipc": want["ipc_total"], "dmr": want["dmr"],
                             "core_br": want["core_br"],
                             "accel_br": want["accel_br"]}, who
    for f in BITWISE_FIELDS:
        assert got_d[f] == want[f], (who, f)
    assert got_d == want, who


@pytest.mark.parametrize("name", ["hydra", "arp-cs-as-d", "hydra-ol"])
def test_drive_lane_matches_reference(reference, port_cache, name):
    """The whole slice -- trace, LERN fit, L-RPT, LLC rounds, host loop --
    equals run_reference at assert_bitwise strength."""
    from repro_torch.core import policies
    pol = {p.name: p for p in small_policies(policies)}[name]
    _assert_bitwise(_port_run(pol), reference["results"][name], name)


def test_drive_lane_with_reference_lern(reference, port_cache):
    """The reference's own LERN model, carried across, drives the port's
    host loop and LLC engine to the reference's result (parity of
    llc/sim apart from the k-means fit)."""
    from repro_torch.convert import lern_model_from_numpy
    from repro_torch.core import policies, sim
    model = lern_model_from_numpy(**reference["lern"])
    key = (f"{CONFIG}-full-ss{SMALL['subsample_target']}-s0-"
           f"{sim._lern_tag()}")
    sim._atomic_dump(model, sim._cache_path("lern", key))
    got = _port_run(policies.get("hydra"))
    _assert_bitwise(got, reference["results"]["hydra"], "hydra/ref-lern")


def test_entry_points_raise_without_cuda(port_cache, monkeypatch):
    """Without a card, every entry point's default device raises instead
    of running on the CPU."""
    import torch
    from repro_torch.core import lern, llc, policies, sim
    from repro_torch.core.dram import default_model
    p = sim.SimParams(**SMALL)
    art = sim.load_artifacts(CONFIG, MIX, p)
    lane = sim.Lane(CONFIG, MIX, policies.get("arp-nb"), p, default_model(),
                    SMALL_DEADLINE, art, device="cpu")
    state = llc.init_state(lane.llc_cfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: sim.Lane(CONFIG, MIX, policies.get("arp-nb"), p,
                         default_model(), SMALL_DEADLINE, art),
        lambda: sim.drive_lane(lane),
        lambda: sim.calibrated_deadline(CONFIG, p, default_model()),
        lambda: sim.load_lern(CONFIG, "full", SMALL["subsample_target"]),
        lambda: lern.train_model_batched(art.trace),
        lambda: llc.init_state(lane.llc_cfg),
        lambda: llc.simulate_epoch(lane.llc_cfg, state,
                                   np.zeros((8, 1024), np.int32),
                                   np.zeros((8, 1024), np.int32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

if __name__ == "__main__":
    _child_main(sys.argv[1], sys.argv[2])
