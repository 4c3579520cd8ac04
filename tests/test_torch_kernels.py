"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode) and oracles, and the
dispatch rule (plain version for CPU tensors only, counted launches only
on the card)."""
import importlib
import os
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core.kmeans import segment_layout
from repro.kernels.kmeans_assign import ops as jkops, ref as jkref
from repro.kernels.ri_histogram import ops as jhops, ref as jhref
from repro_torch import device as tdevice
from repro_torch.core import kmeans as tkm
from repro_torch.kernels import _build, common as tcommon
from repro_torch.kernels.kmeans_assign import ops as tkops
from repro_torch.kernels.ri_histogram import ops as thops


# the edges of the bins, the ends of int32 and "no reuse" (-1)
RI_EDGES = [-2 ** 31, -1, 0, 1, 10, 11, 100, 101, 500, 501, 2 ** 31 - 1]


def _ri_case(case) -> np.ndarray:
    """N random intervals in [-1, 3000) for an int ``case``; else the edge
    values, or 1000 negative intervals down to -2^31."""
    rng = np.random.default_rng(3)
    if case == "edges":
        return np.array(RI_EDGES, np.int32)
    if case == "all_negative":
        return rng.integers(-2 ** 31, 0, 1000).astype(np.int32)
    return rng.integers(-1, 3000, case).astype(np.int32)


@pytest.mark.parametrize("case", [8, 100, 4096, 10_000, "edges",
                                  "all_negative"])
def test_ri_histogram_plain_matches_pallas(case):
    """Bitwise: bins and counts equal the Pallas kernel and the oracle."""
    ri = _ri_case(case)
    b, c = thops.histogram(torch.as_tensor(ri))
    for jb, jc in (jhops.histogram(jnp.asarray(ri)),
                   jhref.histogram_ref(jnp.asarray(ri))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert b.dtype == torch.int32 and c.dtype == torch.int32
    if case == "edges":
        assert b.tolist() == [-1, -1, 0, 0, 0, 1, 1, 2, 2, 3, 3]
    if case == "all_negative":
        assert (b == -1).all() and c.tolist() == [0, 0, 0, 0]


def test_ri_histogram_rejects_other_devices():
    """Neither a CPU nor a CUDA tensor: no kernel, no plain version."""
    with pytest.raises(ValueError, match="unsupported device"):
        thops.histogram(torch.empty(4, dtype=torch.int32, device="meta"))


def test_ri_histogram_source_keeps_nothing_past_its_launch():
    """One launch: no global atomics, no memset, no second kernel."""
    with open(os.path.join(_build.CSRC, "ri_histogram.cu")) as f:
        src = f.read()
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    for word in ("atomic", "Memset", "__device__ int", "<<<"):
        assert word not in code
    assert code.count("__global__") == 2          # the kernel, the empty one
    assert code.count("cluster.sync()") == 2
    assert "map_shared_rank" in code and "__reduce_add_sync" in code


def _segmented_case(sizes, d, k):
    """The flat-segmented inputs of tests/test_kernels.py."""
    rng = np.random.default_rng(11)
    off, total = segment_layout(sizes)
    s = len(sizes)
    x = np.zeros((total, d), np.float32)
    seg = np.full(total, s, np.int32)
    for i, n in enumerate(sizes):
        x[off[i]:off[i] + n] = rng.normal(size=(n, d)) * 3
        seg[off[i]:off[i] + n] = i
    centers = rng.normal(size=(s, k, d)).astype(np.float32)
    return x, centers, seg


@pytest.mark.parametrize("sizes,d,k", [
    ([13, 8, 29], 4, 4), ([100], 4, 4), ([8, 8, 8, 8], 8, 4),
    ([5, 300, 11], 4, 6),
])
def test_assign_segmented_plain_matches_pallas(sizes, d, k):
    """Equal on valid rows to the Pallas kernel and the oracle."""
    x, centers, seg = _segmented_case(sizes, d, k)
    got = tkops.assign_segmented(torch.as_tensor(x), torch.as_tensor(centers),
                                 torch.as_tensor(seg)).numpy()
    valid = seg < len(sizes)
    for want in (jkops.assign_segmented(jnp.asarray(x), jnp.asarray(centers),
                                        jnp.asarray(seg)),
                 jkref.assign_segmented_ref(jnp.asarray(x),
                                            jnp.asarray(centers),
                                            jnp.asarray(seg))):
        np.testing.assert_array_equal(got[valid], np.asarray(want)[valid])


def test_assign_segmented_ties_keep_first_index():
    """Equidistant centres resolve to the lower index, as jnp.argmin."""
    x = torch.zeros((8, 2))
    centers = torch.tensor([[[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0]]])
    seg = torch.zeros(8, dtype=torch.int32)
    assert tkops.assign_segmented(x, centers, seg).tolist() == [0] * 8


def test_fma32_rounds_once():
    """fma32 is a fused multiply-add: one rounding of a*b + c."""
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-(1.0 + 2.0 ** -11)], dtype=torch.float32)
    # a*a = 1 + 2^-11 + 2^-24: the 2^-24 term survives only unrounded
    assert tcommon.fma32(a, a, c).item() == 2.0 ** -24
    assert (a * a + c).item() == 0.0


def test_cpu_tensors_take_plain_version_and_count_nothing():
    h0 = thops.histogram.launches
    a0 = tkops.assign_segmented.launches
    thops.histogram(torch.arange(-1, 600, dtype=torch.int32))
    x, centers, seg = _segmented_case([13, 8], 4, 4)
    tkops.assign_segmented(torch.as_tensor(x), torch.as_tensor(centers),
                           torch.as_tensor(seg))
    assert thops.histogram.launches == h0
    assert tkops.assign_segmented.launches == a0


def test_default_device_raises_without_cuda(monkeypatch):
    """The entry points run on the card unless asked for the CPU; with no
    card they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve("cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    x, centers, seg = _segmented_case([13, 8], 4, 4)
    off, _ = segment_layout([13, 8])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkm.kmeans_fit_segmented(x, seg, off, np.array([13, 8], np.int32),
                                 torch.zeros((2, 2), dtype=torch.int64),
                                 n_seg=2)


def test_every_port_module_imports_without_triton_or_nvcc():
    """Kernels compile inside the launching call, never at import."""
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.ri_histogram.kernel" in names
    for name in names:
        importlib.import_module(name)


def test_cuda_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT",
                        os.path.join(str(tmp_path), "no-nvcc"))
    assert _build.sources() == ["flash_attention", "kmeans_assign",
                                "kmeans_assign_segmented", "llc_rounds",
                                "ri_histogram"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
