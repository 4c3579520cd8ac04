"""The flash attention kernel's plain version against the JAX package's
Pallas kernel (interpret mode) and its oracle, at the
``tests/test_kernels.py::test_flash_attention`` cases and bars, and the
wrapper's contract: the shapes the Pallas wrapper refuses are refused here
too, the plain version only for CPU tensors, launches counted only on the
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fops, ref as fref
from repro_torch.kernels.flash_attention import ops as tops
from test_torch_sim import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CASES = [(1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 384, 8, 1, 128),
         (2, 128, 4, 4, 32),
         (1, 256, 8, 1, 256)]     # paligemma-3b's heads: d = 256, GQA 8
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, s, h, hkv, d, dtype):
    """tests/test_kernels.py's inputs, in both packages."""
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(42)
    arrs = [jnp.asarray(rng.normal(size=shape), jd) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    return arrs, [torch.tensor(np.asarray(a.astype(jnp.float32))).to(td)
                  for a in arrs]


@pytest.mark.parametrize("b,s,h,hkv,d", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_oracle(b, s, h, hkv, d, dtype, causal):
    (q, k, v), (tq, tk, tv) = _inputs(b, s, h, hkv, d, dtype)
    atol = DTYPES[dtype][2]
    got = tops.mha_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    pallas = np.asarray(fops.mha(q, k, v, causal=causal), np.float32)
    rep = h // hkv
    kk = jnp.repeat(k, rep, 2).transpose(0, 2, 1, 3).reshape(b * h, s, d)
    vv = jnp.repeat(v, rep, 2).transpose(0, 2, 1, 3).reshape(b * h, s, d)
    qq = q.transpose(0, 2, 1, 3).reshape(b * h, s, d)
    want = np.asarray(fref.mha_ref(qq, kk, vv, causal=causal).reshape(
        b, h, s, d).transpose(0, 2, 1, 3), np.float32)
    np.testing.assert_allclose(got, pallas, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # the wrapper takes the plain version for CPU tensors, uncounted
    n = tops.mha.launches
    np.testing.assert_array_equal(
        tops.mha(tq, tk, tv, causal=causal).float().numpy(), got)
    assert tops.mha.launches == n


def test_plain_rounds_p_before_the_pv_product():
    """In bf16 the weights are rounded to the input type before they meet
    V (``p.astype(v.dtype)`` in the Pallas kernel): the plain version
    equals the Pallas kernel more closely than an f32-weights variant."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 256, 4, 2, 64, "bfloat16")
    pallas = np.asarray(fops.mha(q, k, v, causal=True), np.float32)
    got = tops.mha_plain(tq, tk, tv, causal=True).float().numpy()
    f32 = tops.mha_plain(tq.float(), tk.float(), tv.float(),
                         causal=True).to(torch.bfloat16).float().numpy()
    assert np.abs(got - pallas).max() < np.abs(f32 - pallas).max()


@pytest.mark.parametrize("b,sq,sk,h,hkv,d", [
    (1, 200, 200, 2, 2, 64),       # Sq > 128, not a multiple of 128
    (1, 128, 130, 2, 1, 32),       # Sk > 128, not a multiple of 128
    (2, 320, 320, 4, 2, 64),
])
def test_refuses_what_the_pallas_kernel_refuses(b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    with pytest.raises(AssertionError):
        fops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    with pytest.raises(ValueError, match="multiples of 128"):
        tops.mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(k))


@pytest.mark.parametrize("what", ["head_size", "dtype", "mixed", "gqa",
                                  "rank", "device"])
def test_refuses_what_the_kernel_does_not_take(what):
    q = torch.zeros(1, 128, 4, 64)
    k = torch.zeros(1, 128, 2, 64)
    v = k
    if what == "head_size":
        q, k, v = q[..., :48], k[..., :48], k[..., :48]
    elif what == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif what == "mixed":
        v = k.to(torch.bfloat16)
    elif what == "gqa":
        k = v = torch.zeros(1, 128, 3, 64)
    elif what == "rank":
        q = q[0]
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        tops.mha(q, k, v)



@pytest.mark.parametrize("d", tops.HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_route_sends_bf16_to_the_hopper_kernel(d, dtype, want):
    """bf16 at every head size goes to the Hopper kernel, f32 (whose bar of
    2e-5 rules out TF32 tensor cores) to the CUDA-core kernel."""
    assert tops.route(torch.zeros(1, 128, 2, d, dtype=dtype)) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_kernel_counters_stay_at_zero_on_the_cpu(dtype):
    (_, _, _), (tq, tk, tv) = _inputs(1, 128, 2, 2, 64, dtype)
    n, by_kernel = tops.mha.launches, dict(tops.mha.kernel_launches)
    tops.mha(tq, tk, tv, causal=True)
    assert tops.mha.launches == n
    assert tops.mha.kernel_launches == by_kernel
    assert set(by_kernel) == set(tops.KERNELS)


def _counted(monkeypatch):
    """Fresh counters on ``mha`` for one test."""
    monkeypatch.setattr(tops.mha, "launches", 0)
    monkeypatch.setattr(tops.mha, "kernel_launches",
                        dict.fromkeys(tops.KERNELS, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_refused_launch_raises_and_never_falls_back(monkeypatch, dtype):
    """The card's path (``ops.launch``, what ``mha`` calls for a CUDA
    tensor) raises when the kernel's launch is refused: it takes neither
    the other kernel nor the plain version, and counts nothing."""
    from repro_torch.kernels.flash_attention import kernel as tkernel
    _counted(monkeypatch)
    tried = []

    def refuse(q, k, v, out, causal, kernel):
        tried.append(kernel)
        raise RuntimeError(f"flash_attention ({kernel}) launch failed: "
                           f"cudaError 1")

    def no_plain(*a, **kw):
        raise AssertionError("fell back to mha_plain")

    monkeypatch.setattr(tkernel, "launch", refuse)
    monkeypatch.setattr(tops, "mha_plain", no_plain)
    (_, _, _), (tq, tk, tv) = _inputs(1, 128, 2, 2, 64, dtype)
    with pytest.raises(RuntimeError, match="launch failed"):
        tops.launch(tq, tk, tv, causal=True)
    assert tried == [tops.route(tq)]
    assert tops.mha.launches == 0
    assert tops.mha.kernel_launches == dict.fromkeys(tops.KERNELS, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_launch_counts_on_its_kernel_and_in_all(monkeypatch, dtype):
    from repro_torch.kernels.flash_attention import kernel as tkernel
    _counted(monkeypatch)
    monkeypatch.setattr(tkernel, "launch", lambda *a: None)
    (_, _, _), (tq, tk, tv) = _inputs(1, 128, 2, 2, 64, dtype)
    out = tops.launch(tq, tk, tv, causal=True)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    want = dict.fromkeys(tops.KERNELS, 0)
    want[tops.route(tq)] = 1
    assert (tops.mha.launches, tops.mha.kernel_launches) == (1, want)


@pytest.mark.parametrize("code,why", [(-1, "no cuTensorMapEncodeTiled"),
                                      (-2, "refused a tensor map"),
                                      (98, "cudaError 98")])
def test_the_binding_raises_on_an_error_code(monkeypatch, code, why):
    """A nonzero return of the C entry point raises, with the Hopper
    kernel's own refusals named; the Hopper kernel gets the largest key
    norm of each kv head beside the inputs."""
    from repro_torch.kernels.flash_attention import kernel as tkernel
    seen = []

    def entry(*args):
        seen.append(args)
        return code

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tkernel, "_fn", lambda kernel: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    (_, _, _), (tq, tk, tv) = _inputs(1, 128, 2, 2, 64, "bfloat16")
    with pytest.raises(RuntimeError, match=why):
        tkernel.launch(tq, tk, tv, torch.empty_like(tq), True, "wgmma")
    (args,) = seen
    assert args[5:12] == (1, 128, 128, 2, 2, 64, 1)
    assert args[-2] == pytest.approx(
        tkernel.BOUND_ULPS * 2.0 ** -24 * 64 ** -0.5)
