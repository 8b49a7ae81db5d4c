"""PyTorch port vs JAX reference: the INT8 substrate (``core/quant.py``) and
the int8 matmul kernel's plain version, bit for bit (atol=0), on the CPU.

The reference applies the two scales in two orders: its core computes
``(acc·x_scale)·w_scale``, its Pallas kernel ``acc·(x_scale·w_scale)``.
The port's ``core.quant.int8_matmul`` on the CPU is held to the core, its
``kernels.int8_matmul`` plain version to the Pallas kernel (run in interpret
mode, as ``tests/test_kernels.py`` runs it); the two orders differ by at most
two f32 ulps.  Reference calls run under ``jax.jit``, as every reference path
that quantises is compiled (see ``test_quantize_scale_follows_the_compiled_
reference``).  The CUDA kernel against its plain version on the card is in
``test_torch_kernels_cuda.py``."""
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
from repro_torch.core import (QTensor, dense_maybe_quant, int8_matmul,  # noqa: E402
                              quantize, quantize_dynamic)
from repro_torch.kernels import int8_matmul as t_kernel  # noqa: E402
from repro_torch.kernels import int8_matmul_ref  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul_2d_ref  # noqa: E402

j_quantize = jax.jit(jq.quantize, static_argnames=("axis", "bits"))
j_quantize_dynamic = jax.jit(jq.quantize_dynamic, static_argnames=("bits",))
j_core = jax.jit(jq.int8_matmul)
j_dense = jax.jit(jq.dense_maybe_quant, static_argnames=("use_int8",))
j_acc = jax.jit(lambda xv, wv: jax.lax.dot_general(
    xv, wv, (((xv.ndim - 1,), (0,)), ((), ())),
    preferred_element_type=jnp.int32))

SWEEP = [(64, 256, 128), (17, 300, 130), (4, 128, 512), (257, 1024, 384),
         (1, 128, 128)]          # the reference kernel suite's shapes


def bits(a) -> np.ndarray:
    """f32 (or bf16) values as their bit patterns, for atol=0 checks."""
    a = np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else
                   np.asarray(a, np.float32), np.float32)
    return a.view(np.int32)


def to_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def to_torch(a: np.ndarray, dtype: str):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def qt(jqt) -> QTensor:
    """A reference QTensor, crossed exactly into the port."""
    return QTensor(torch.from_numpy(np.array(jqt.values)),
                   torch.from_numpy(np.array(jqt.scale)))


def assert_qtensor_equal(got: QTensor, want):
    assert got.values.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.scale.shape == tuple(want.scale.shape)
    np.testing.assert_array_equal(bits(got.scale), bits(want.scale))


def weight_with_edges(rng, shape):
    """Normal weights whose first column holds exact .5 ties (absmax 127 →
    scale 1) and whose second column is all zero (the 1e-12 floor)."""
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 0] = 0.5 + rng.integers(-40, 40, shape[0])
    w[0, 0] = 127.0
    w[:, 1] = 0.0
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, -1, (0, 1)])
def test_quantize_bit_equal(rng, dtype, axis):
    w = weight_with_edges(rng, (96, 40))
    got = quantize(to_torch(w, dtype), axis=axis)
    assert_qtensor_equal(got, j_quantize(to_jax(w, dtype), axis=axis))


def test_quantize_rounds_ties_to_even_and_floors_zero_columns(rng):
    w = weight_with_edges(rng, (64, 8))
    q = quantize(torch.from_numpy(w), axis=0)
    assert float(q.scale[0, 0]) == 1.0
    np.testing.assert_array_equal(q.values[:, 0].numpy(),
                                  np.round(w[:, 0]).astype(np.int8))
    assert not q.values[:, 1].any()
    assert float(q.scale[0, 1]) == np.float32(1e-12) * (np.float32(1) / np.float32(127))


@pytest.mark.parametrize("bits_", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 7, 64), (257, 130)])
def test_quantize_dynamic_bit_equal(rng, dtype, shape, bits_):
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    got = quantize_dynamic(to_torch(x, dtype), bits=bits_)
    assert got.scale.shape == ()
    assert_qtensor_equal(got, j_quantize_dynamic(to_jax(x, dtype), bits=bits_))


def test_quantize_dynamic_divides_bf16_in_f32(rng):
    """The promotion trap: torch keeps bf16 / 0-d f32 in bf16, the reference
    divides in f32.  The port widens first, so its int8 values are the
    reference's where a bf16 quotient would round elsewhere."""
    x = rng.normal(size=(512, 64)).astype(np.float32)
    xb = to_torch(x, "bfloat16")
    q = quantize_dynamic(xb)
    want = np.asarray(j_quantize_dynamic(to_jax(x, "bfloat16")).values)
    np.testing.assert_array_equal(q.values.numpy(), want)
    bf16_quotient = torch.clamp(torch.round(xb / q.scale), -128, 127).to(torch.int8)
    assert (bf16_quotient.numpy() != want).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(33,), (2, 3), (1,)])
def test_core_int8_matmul_bit_equal(rng, dtype, lead):
    x = rng.normal(size=(*lead, 192)).astype(np.float32)
    w = j_quantize(jnp.asarray(rng.normal(size=(192, 72)).astype(np.float32)),
                   axis=0)
    got = int8_matmul(to_torch(x, dtype), qt(w))
    want = j_core(to_jax(x, dtype), w)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(bits(got), bits(want))


def pallas_case(rng, m, k, n):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = j_quantize(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)),
                   axis=0)
    return x, w


@pytest.mark.parametrize("mkn", SWEEP)
def test_kernel_plain_version_bit_equal_to_pallas(rng, mkn):
    """The plain version is the reference kernel's function (interpret
    mode, the reference suite's small blocks): f32 outputs bit for bit."""
    x, w = pallas_case(rng, *mkn)
    want = j_pallas(jnp.asarray(x), w, block_m=16, block_n=128, block_k=128)
    got = int8_matmul_ref(torch.from_numpy(x), qt(w))
    np.testing.assert_array_equal(bits(got), bits(want))
    # the CPU branch of the public wrapper is that plain version
    np.testing.assert_array_equal(bits(t_kernel(torch.from_numpy(x), qt(w))),
                                  bits(want))


@pytest.mark.parametrize("mkn", SWEEP)
def test_kernel_plain_version_accumulator_exact(rng, mkn):
    """The int32 accumulator equals the reference's int8 dot with int32
    accumulation, and the 2-D plain version's output is built from it."""
    x, w = pallas_case(rng, *mkn)
    xq = j_quantize_dynamic(jnp.asarray(x))
    want_acc = np.asarray(j_acc(xq.values, w.values))
    (xv, xs), (wv, ws) = qt(xq), qt(w)
    out, acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    want = j_pallas(jnp.asarray(x), w, block_m=16, block_n=128, block_k=128)
    np.testing.assert_array_equal(bits(out), bits(want))


def test_kernel_plain_version_batched_bf16(rng):
    """Leading dims fold into M; a bf16 input quantises from an f32
    quotient on both sides."""
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    w = j_quantize(jnp.asarray(rng.normal(size=(256, 64)).astype(np.float32)),
                   axis=0)
    for dtype in ("float32", "bfloat16"):
        want = j_pallas(to_jax(x, dtype), w, block_m=8, block_n=128,
                        block_k=128)
        got = int8_matmul_ref(to_torch(x, dtype), qt(w))
        assert got.shape == (2, 3, 64)
        np.testing.assert_array_equal(bits(got), bits(want))


def test_accumulator_past_2_24_rounds_like_the_reference():
    """|acc| > 2^24 (all ±127 operands): int→f32 rounds to nearest even on
    both sides."""
    k, n = 1536, 24
    x = np.ones((16, k), np.float32)
    x[8:, ::3] = -1.0
    wsign = np.where(np.arange(k)[:, None] % (np.arange(n) + 2) == 0, -1.0, 1.0)
    w = j_quantize(jnp.asarray(wsign.astype(np.float32)), axis=0)
    xq = j_quantize_dynamic(jnp.asarray(x))
    acc = np.asarray(j_acc(xq.values, w.values))
    assert np.abs(acc).max() > 2 ** 24 and (acc % 4 != 0).any()
    want = j_pallas(jnp.asarray(x), w, block_m=16, block_n=128, block_k=128)
    got = int8_matmul_ref(torch.from_numpy(x), qt(w))
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(int8_matmul(torch.from_numpy(x), qt(w))),
                                  bits(j_core(jnp.asarray(x), w)))


def test_two_scale_orders_differ_by_at_most_two_ulps(rng):
    """The reference's core and kernel orders disagree in the last bit on a
    third of the outputs, in the reference and in the port alike; never by
    more than two f32 ulps (two roundings on each side)."""
    x, w = pallas_case(rng, 257, 1024, 384)
    core, kern = j_core(jnp.asarray(x), w), j_pallas(
        jnp.asarray(x), w, block_m=16, block_n=128, block_k=128)
    t_core = int8_matmul(torch.from_numpy(x), qt(w))
    t_kern = int8_matmul_ref(torch.from_numpy(x), qt(w))
    for a, b in ((core, kern), (t_core, t_kern)):
        ulps = np.abs(bits(a).astype(np.int64) - bits(b).astype(np.int64))
        assert ulps.max() <= 2 and 0.05 < (ulps > 0).mean() < 0.95


def test_dense_maybe_quant_three_branches(rng):
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    jw = j_quantize(jnp.asarray(w), axis=0)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    # QTensor → the int8 path; use_int8 → quantize(w, axis=0) first
    np.testing.assert_array_equal(
        bits(dense_maybe_quant(xt, qt(jw))),
        bits(j_dense(jnp.asarray(x), jw)))
    forced = dense_maybe_quant(xt, wt, use_int8=True)
    np.testing.assert_array_equal(
        bits(forced), bits(j_dense(jnp.asarray(x), jnp.asarray(w),
                                   use_int8=True)))
    np.testing.assert_array_equal(bits(forced),
                                  bits(dense_maybe_quant(xt, quantize(wt, axis=0))))
    # full precision: f32 sums in another order (BLAS vs XLA) — rtol 1e-6
    exact = dense_maybe_quant(xt, wt)
    assert exact.dtype == torch.float32
    np.testing.assert_allclose(exact.numpy(), np.asarray(
        j_dense(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=1e-6)
    rel = float(torch.linalg.norm(forced - exact) / torch.linalg.norm(exact))
    assert rel < 0.05


def test_dense_maybe_quant_full_precision_bf16_and_promotion(rng):
    """bf16 × bf16 stays bf16 (f32 sums rounded once: equal to the reference
    but for a rare one-ulp tie); bf16 × f32 promotes to f32 as the
    reference's einsum does."""
    x = rng.normal(size=(6, 64)).astype(np.float32)
    w = rng.normal(size=(64, 16)).astype(np.float32)
    got = dense_maybe_quant(to_torch(x, "bfloat16"), to_torch(w, "bfloat16"))
    want = j_dense(to_jax(x, "bfloat16"), to_jax(w, "bfloat16"))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ulps = np.abs(bits(got).astype(np.int64) - bits(want).astype(np.int64))
    assert (ulps >> 16).max() <= 1
    mixed = dense_maybe_quant(to_torch(x, "bfloat16"), torch.from_numpy(w))
    assert mixed.dtype == torch.float32
    assert j_dense(to_jax(x, "bfloat16"), jnp.asarray(w)).dtype == jnp.float32


def test_qtensor_shape_and_dequantize(rng):
    w = rng.normal(size=(32, 16)).astype(np.float32)
    q = quantize(torch.from_numpy(w), axis=0)
    jqt = j_quantize(jnp.asarray(w), axis=0)
    assert q.shape == (32, 16) == jqt.shape
    np.testing.assert_array_equal(bits(q.dequantize()), bits(jqt.dequantize()))
    # symmetric quantisation: |err| ≤ scale/2 per column
    assert (np.abs(q.dequantize().numpy() - w)
            <= q.scale.numpy() / 2 + 1e-7).all()


def test_quantize_scale_follows_the_compiled_reference(rng):
    """Under ``jax.jit`` XLA turns ``absmax / qmax`` into a product with the
    f32 reciprocal; op-by-op dispatch divides.  The port gives the compiled
    scales; the eager ones sit at most one f32 ulp away."""
    w = (rng.normal(size=(512, 64)) * 3).astype(np.float32)
    got = quantize(torch.from_numpy(w), axis=0)
    jit, eager = j_quantize(jnp.asarray(w), axis=0), jq.quantize(
        jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(bits(got.scale), bits(jit.scale))
    gap = np.abs(bits(got.scale).astype(np.int64) - bits(eager.scale))
    assert gap.max() == 1
