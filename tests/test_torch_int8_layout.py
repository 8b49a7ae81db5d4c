"""The int8 weight layout of the port (K-major values from ``quantize(w,
axis=0)``) against the JAX reference, bit for bit, on the CPU; and the int8
wrappers' host-side choices (layout checks, kernel variant, transposes,
the quantisation kernel's refusals) driven without a card.

The reference keeps w (K, N) row-major; the port stores the same values
(N, K)-contiguous, stride (1, K), because ``wgmma`` takes 8-bit operands
only K-major.  Values, scales and every product stay the reference's.
Reference calls run under ``jax.jit``, as in ``test_torch_quant.py``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul as j_pallas  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.int8_matmul import (int8_matmul_2d_ref,  # noqa: E402
                                             int8_matmul_ref)
from repro_torch.kernels.int8_matmul import ops as i8_ops  # noqa: E402

j_quantize = jax.jit(jq.quantize, static_argnames=("axis", "bits"))
j_quantize_dynamic = jax.jit(jq.quantize_dynamic, static_argnames=("bits",))
j_dense = jax.jit(jq.dense_maybe_quant, static_argnames=("use_int8",))


def bits(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.asarray(a, np.float32).view(np.int32)


def as_row_major(q: quant.QTensor) -> quant.QTensor:
    return quant.QTensor(q.values.contiguous(), q.scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, -2])
@pytest.mark.parametrize("kn", [(96, 40), (1024, 384), (17, 1)])
def test_quantize_2d_weight_is_k_major_and_bit_equal(rng, dtype, axis, kn):
    w = rng.normal(size=kn).astype(np.float32)
    w[:, 0] = 0.5 + rng.integers(-40, 40, kn[0])       # exact .5 ties
    w[0, 0] = 127.0
    got = quant.quantize(torch.from_numpy(w).to(getattr(torch, dtype)),
                         axis=axis)
    want = j_quantize(jnp.asarray(w).astype(getattr(jnp, dtype)), axis=axis)
    assert got.values.shape == kn and got.values.t().is_contiguous()
    if kn[1] > 1:                  # a dim of size 1 keeps any stride
        assert got.values.stride() == (1, kn[0])
    assert got.values.dtype == torch.int8 and got.scale.shape == (1, kn[1])
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(bits(got.scale), bits(want.scale))


@pytest.mark.parametrize("axis", [-1, (0, 1)])
def test_other_axes_keep_the_row_major_layout(rng, axis):
    w = rng.normal(size=(32, 16)).astype(np.float32)
    got = quant.quantize(torch.from_numpy(w), axis=axis)
    assert got.values.is_contiguous()
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(j_quantize(jnp.asarray(w),
                                                        axis=axis).values))


def pallas_case(rng, m, k, n):
    x = rng.normal(size=(m, k)).astype(np.float32)
    jw = j_quantize(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)),
                    axis=0)
    tw = quant.QTensor(torch.from_numpy(np.array(jw.values)),
                       torch.from_numpy(np.array(jw.scale)))
    k_major = quant.QTensor(tw.values.t().contiguous().t(), tw.scale)
    assert k_major.values.stride() == (1, k)
    return x, jw, {"row": tw, "k_major": k_major}


@pytest.mark.parametrize("mkn", [(64, 256, 128), (17, 300, 130),
                                 (1, 128, 128), (33, 208, 100)])
def test_plain_versions_bit_equal_on_both_layouts(rng, mkn):
    """Both plain versions give the same bits on either layout, and those
    bits are the reference Pallas kernel's (interpret mode)."""
    x, jw, layouts = pallas_case(rng, *mkn)
    want = j_pallas(jnp.asarray(x), jw, block_m=16, block_n=128, block_k=128)
    xq = quant.quantize_dynamic(torch.from_numpy(x))
    outs, accs = [], []
    for wq in layouts.values():
        np.testing.assert_array_equal(
            bits(int8_matmul_ref(torch.from_numpy(x), wq)), bits(want))
        out, acc = int8_matmul_2d_ref(xq.values, wq.values, xq.scale,
                                      wq.scale, with_acc=True)
        outs.append(out)
        accs.append(acc)
    assert torch.equal(accs[0], accs[1])
    np.testing.assert_array_equal(bits(outs[0]), bits(outs[1]))
    np.testing.assert_array_equal(bits(outs[0]), bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_maybe_quant_k_major_matches_reference(rng, dtype):
    x = rng.normal(size=(2, 5, 96)).astype(np.float32)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    jw = j_quantize(jnp.asarray(w), axis=0)
    tw = quant.quantize(torch.from_numpy(w), axis=0)
    assert tw.values.stride() == (1, 96)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    np.testing.assert_array_equal(bits(quant.dense_maybe_quant(xt, tw)),
                                  bits(j_dense(xj, jw)))
    np.testing.assert_array_equal(
        bits(quant.dense_maybe_quant(xt, torch.from_numpy(w), use_int8=True)),
        bits(j_dense(xj, jnp.asarray(w), use_int8=True)))
    np.testing.assert_array_equal(bits(quant.dense_maybe_quant(xt, tw)),
                                  bits(quant.dense_maybe_quant(
                                      xt, as_row_major(tw))))


# --------------------------------------------- the wrappers' host side --

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' card
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(a):
    return torch.as_tensor(a).as_subclass(_FakeCuda)


@pytest.fixture
def no_toolchain(monkeypatch, tmp_path):
    """No nvcc anywhere and an empty build cache: a call that gets past its
    checks raises from the build."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})


def _no_plain(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(i8_ops, "int8_matmul_2d_ref", fail)
    monkeypatch.setattr(i8_ops, "int8_matmul_ref", fail)


def _weights(k, n):
    w = torch.ones((k, n), dtype=torch.int8)
    return {"row": w, "k_major": w.t().contiguous().t(),
            "strided": torch.ones((k, 2 * n), dtype=torch.int8)[:, ::2],
            "transposed_view": torch.ones((n, 2 * k), dtype=torch.int8)[:, ::2].t()}


@pytest.mark.parametrize("layout", ["row", "k_major", "strided",
                                    "transposed_view"])
def test_wrapper_accepts_both_layouts_and_refuses_other_strides(
        layout, no_toolchain, monkeypatch):
    """Row-major and K-major weights pass the checks (and reach the
    build); any other strides are refused before any launch."""
    _no_plain(monkeypatch)
    k, n = 64, 32
    wv = _fake(_weights(k, n)[layout])
    xv = _fake(torch.ones((4, k), dtype=torch.int8))
    xs, ws = _fake(torch.ones(())), _fake(torch.ones((1, n)))
    before = (i8_ops.int8_matmul.launches, i8_ops.int8_matmul.transposes)
    ok = layout in ("row", "k_major")
    with pytest.raises(RuntimeError if ok else ValueError,
                       match="nvcc" if ok else "row-major or K-major"):
        i8_ops.int8_matmul_2d(xv, wv, xs, ws)
    with pytest.raises(RuntimeError if ok else ValueError):
        i8_ops.int8_matmul(_fake(torch.ones((4, k))), quant.QTensor(wv, ws))
    assert (i8_ops.int8_matmul.launches,
            i8_ops.int8_matmul.transposes) == before


@pytest.mark.parametrize("k,offset,layout,variant", [
    (1024, 0, "k_major", "wgmma"), (1024, 0, "row", "wgmma"),
    (208, 0, "k_major", "wgmma"), (200, 0, "k_major", "mma_sync"),
    (200, 0, "row", "mma_sync"), (1024, 1, "k_major", "mma_sync")])
def test_kernel_variant_follows_the_host_shape(k, offset, layout, variant):
    """wgmma where TMA can describe both operands (K % 16 == 0, 16-byte
    aligned bases; a row-major w is copied, so its own base does not
    matter), mma.sync otherwise."""
    xv = torch.ones((8 * k + 16,), dtype=torch.int8)[offset:offset + 8 * k]
    assert (xv.data_ptr() % 16 == 0) == (offset == 0)
    wv = _weights(k, 48)[layout]
    assert i8_ops.kernel_variant(xv.view(8, k), wv) == variant


@pytest.mark.parametrize("mn,tile", [((4096, 1024), 256), ((4096, 4096), 256),
                                     ((256, 1024), 128), ((1, 4096), 128),
                                     ((2048, 1024), 128), ((2112, 1024), 256)])
def test_default_tile_n(mn, tile):
    assert i8_ops.default_tile_n(*mn) == tile


def test_pinned_variant_and_tile_are_checked(no_toolchain, monkeypatch):
    _no_plain(monkeypatch)
    xv = _fake(torch.ones((4, 200), dtype=torch.int8))
    wv = _fake(torch.ones((200, 32), dtype=torch.int8))
    xs, ws = _fake(torch.ones(())), _fake(torch.ones((1, 32)))
    with pytest.raises(ValueError, match="K % 16"):
        i8_ops.int8_matmul_2d(xv, wv, xs, ws, variant="wgmma")
    with pytest.raises(ValueError, match="variant"):
        i8_ops.int8_matmul_2d(xv, wv, xs, ws, variant="cutlass")
    with pytest.raises(ValueError, match="tile_n"):
        i8_ops.int8_matmul_2d(xv, wv, xs, ws, tile_n=64)
    with pytest.raises(RuntimeError, match="nvcc"):
        i8_ops.int8_matmul_2d(xv, wv, xs, ws, variant="mma_sync")


def test_quantize_dynamic_cuda_tensor_goes_to_the_kernel(no_toolchain,
                                                         monkeypatch):
    """On a CUDA tensor ``quantize_dynamic`` reaches the build (here:
    raises without nvcc) and never the plain version; what the kernel
    does not take is refused first; no count moves."""
    def fail(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(quant, "_quantize", fail)
    before = quant.quantize_dynamic.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        quant.quantize_dynamic(_fake(np.ones((4, 8), np.float32)))
    with pytest.raises(RuntimeError, match="nvcc"):
        quant.quantize_dynamic(_fake(torch.ones((4, 8), dtype=torch.bfloat16)),
                               bits=4)
    for bad, err in ((dict(x=np.ones(4, np.float64)), TypeError),
                     (dict(x=torch.ones(4, dtype=torch.float16)), TypeError),
                     (dict(x=np.ones(4, np.float32), bits=9), ValueError),
                     (dict(x=np.ones(4, np.float32), bits=1), ValueError),
                     (dict(x=np.ones((4, 4), np.float32).T), ValueError),
                     (dict(x=np.ones(0, np.float32)), ValueError)):
        x = _fake(bad.pop("x"))
        with pytest.raises(err):
            quant.quantize_dynamic(x, **bad)
    with pytest.raises(ValueError, match="unsupported device"):
        quant.quantize_dynamic(torch.zeros(4, device="meta"))
    assert quant.quantize_dynamic.launches == before


def test_int8_matmul_checks_the_weight_before_quantising(no_toolchain,
                                                         monkeypatch):
    """A weight the kernel does not take is refused before the
    quantisation kernel is reached."""
    monkeypatch.setattr(quant, "quantize_dynamic", None)
    monkeypatch.setattr(i8_ops, "quantize_dynamic",
                        lambda x: pytest.fail("quantised before the checks"))
    x = _fake(np.ones((4, 64), np.float32))
    ws = _fake(np.ones((1, 32), np.float32))
    for wv, err in ((np.ones((64, 32), np.float32), TypeError),
                    (np.ones((48, 32), np.int8), ValueError),
                    (_weights(64, 32)["strided"], ValueError)):
        with pytest.raises(err):
            i8_ops.int8_matmul(x, quant.QTensor(_fake(wv), ws))


def test_dynamic_quantisation_of_a_k_major_free_input_is_the_reference(rng):
    """The CPU quantisation (the kernel's plain version) of activations is
    the jitted reference's, whatever the weight layout downstream."""
    x = (rng.normal(size=(33, 77)) * 3).astype(np.float32)
    for b in (8, 4):
        got = quant.quantize_dynamic(torch.from_numpy(x), bits=b)
        want = j_quantize_dynamic(jnp.asarray(x), bits=b)
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
        np.testing.assert_array_equal(bits(got.scale), bits(want.scale))
