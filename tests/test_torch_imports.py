"""The port stands alone: no module under src/repro_torch/ and not
chip_smoke.py imports JAX or the JAX package, and no port module imports
Triton, whose kernels the port no longer has (checked on the syntax tree,
so an import inside a function counts too)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _sources():
    """chip_smoke.py, then every port module in a fixed (sorted) order."""
    mods = [os.path.join(d, f) for d, _, files in os.walk(PORT)
            for f in files if f.endswith(".py")]
    return [os.path.join(ROOT, "chip_smoke.py")] + sorted(mods)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    """Every module name that ``path`` imports, by statement or by
    ``import_module`` / ``__import__`` with a constant name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names += [node.module] if node.module else []
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            names += [a.value for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                    str)]
    return names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("path", _sources()[1:],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_triton_imports(path):
    bad = [n for n in _imports(path) if n.split(".")[0] == "triton"]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_every_port_module_is_checked():
    names = {os.path.relpath(p, PORT) for p in _sources()[1:]}
    for must in ("core/sim.py", "core/kmeans.py", "core/sweep.py",
                 "kernels/_build.py", "kernels/ri_histogram/kernel.py",
                 "kernels/kmeans_assign/ops.py", "convert.py",
                 "exp/__init__.py", "exp/faults.py", "exp/plan.py",
                 "exp/registry.py", "exp/resultset.py", "exp/runner.py",
                 "exp/schema.py", "exp/spec.py", "serve/knobs.py",
                 "configs/base.py", "configs/qwen3_1_7b.py",
                 "models/layers.py", "models/attention.py", "models/lm.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/kernel.py", "train/step.py",
                 "serve/hydra_scheduler.py", "serve/engine.py",
                 "launch/serve.py", "core/dramsched.py", "core/fused.py",
                 "kernels/llc_rounds/ops.py",
                 "kernels/llc_rounds/kernel.py", "serve/trace.py",
                 "serve/replay.py", "serve/api.py", "optim/adamw.py",
                 "optim/__init__.py", "data/pipeline.py", "ckpt/manager.py",
                 "train/trainer.py", "launch/train.py",
                 "optim/compress.py", "models/moe.py", "models/ssm.py",
                 "sharding/__init__.py", "sharding/compat.py",
                 "sharding/rules.py", "launch/mesh.py",
                 "launch/roofline.py", "launch/dryrun.py"):
        assert must in names
