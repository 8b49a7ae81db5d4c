"""PyTorch port vs JAX reference: the LUT exponential and int8 KV-row
quantisation, bit for bit (atol=0), on the CPU.  The CUDA kernel against
its plain version on the card is in ``test_torch_kernels_cuda.py``."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.lut_exp  # noqa: E402
from repro.core.streaming_attention import quantize_kv_rows as j_quant  # noqa: E402
from repro.kernels.lut_exp.ops import lut_exp as j_pallas_lut_exp  # noqa: E402
import repro_torch.core.lut_exp as tlut  # noqa: E402
from repro_torch.core.streaming_attention import quantize_kv_rows as t_quant  # noqa: E402
from repro_torch.kernels.lut_exp import lut_exp as t_kernel_lut_exp  # noqa: E402
from repro_torch.kernels.lut_exp import lut_exp_ref  # noqa: E402

# the reference package re-exports the function under the module's name
jlut = sys.modules["repro.core.lut_exp"]

SHAPES = [(7,), (128,), (3, 5, 11), (256, 128), (1, 1), (1000,)]
EDGES = np.array([-1e30, -100.0, 0.0, 80.0], np.float32)


def bits(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


def to_np(t):
    return t.to(torch.float32).numpy()


def test_table_bit_exact():
    assert bits(tlut.make_table().numpy()).tolist() == \
        bits(jlut.make_table()).tolist()


def test_pow2_int_bit_exact():
    n = np.arange(-300, 300, dtype=np.float32)
    np.testing.assert_array_equal(
        bits(tlut.pow2_int(torch.from_numpy(n)).numpy()),
        bits(jlut.pow2_int(jnp.asarray(n))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", [0, 1])
def test_lut_exp_bit_exact_vs_core_and_pallas(rng, shape, dtype, order):
    """atol=0: the port's core math, its kernel wrapper's CPU path and its
    plain version all equal the JAX core ``lut_exp`` (one rounding per
    operation) over the reference sweep shapes in f32 and bf16.

    The Pallas kernel (interpret mode) equals the *jitted* core bit for bit,
    and under jit XLA contracts the order-1 correction ``1 + r·ln2/K`` into
    one FMA — a single rounding where the eager core and the port round
    twice.  So against Pallas the port is bit-exact at order 0 and in bf16,
    and within 2 f32 ulps at order 1 in f32: exactly that contraction."""
    x = rng.uniform(-20, 20, size=shape).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jlut.lut_exp(xj, order=order).astype(jnp.float32))
    for got in (tlut.lut_exp(xt, order=order), t_kernel_lut_exp(xt, order=order),
                lut_exp_ref(xt, order=order)):
        assert got.dtype == xt.dtype and tuple(got.shape) == shape
        np.testing.assert_array_equal(bits(to_np(got)), bits(want))

    pallas = np.asarray(j_pallas_lut_exp(xj, order=order,
                                         interpret=True).astype(jnp.float32))
    jitted = np.asarray(jax.jit(lambda v: jlut.lut_exp(v, order=order))(xj)
                        .astype(jnp.float32))
    np.testing.assert_array_equal(bits(pallas), bits(jitted))
    ulps = np.abs(bits(to_np(tlut.lut_exp(xt, order=order))).astype(np.int64)
                  - bits(pallas))
    assert ulps.max() <= (2 if (order == 1 and dtype == "float32") else 0)


@pytest.mark.parametrize("order", [0, 1])
def test_lut_exp_edges_and_wide_range_bit_exact(rng, order):
    x = np.concatenate([EDGES, rng.uniform(-100, 90, 20000).astype(np.float32),
                        rng.uniform(-1, 1, 20000).astype(np.float32)])
    want = np.asarray(jlut.lut_exp(jnp.asarray(x), order=order))
    got = tlut.lut_exp(torch.from_numpy(x), order=order).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert got[0] == 0.0 and got[1] == 0.0 and got[2] == 1.0


@pytest.mark.parametrize("shape", [(2, 3, 50, 16), (1, 2, 7, 128)])
def test_quantize_kv_rows_bit_exact(rng, shape):
    """atol=0 on both outputs: int8 values and f32 per-row scales (both
    frameworks round half to even)."""
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # all-zero row: 1e-8 floor
    x[0, 0, 1, :4] = [0.5, -0.5, 1.5, 127.0]          # exact halves
    qj, sj = j_quant(jnp.asarray(x))
    qt, st = t_quant(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(bits(st.numpy()), bits(sj))


def nonpos_sweep(rng):
    """x <= 0 where the LUT's floors turn: every table step k/128 of
    ln 2 from −126·ln 2 to 0 and its two f32 neighbours, uniform draws, the
    underflow edge and both zeros."""
    grid = (np.arange(-126 * 128, 1, dtype=np.float64) / 128 * np.log(2.0))
    grid = grid.astype(np.float32)
    near = [grid, np.nextafter(grid, np.float32(-np.inf)),
            np.minimum(np.nextafter(grid, np.float32(np.inf)), 0)]
    return np.concatenate([EDGES[:3], np.float32([-0.0, -87.0, -86.99999]),
                           *near, -rng.uniform(0, 100, 20000).astype(np.float32)])


def lut_exp_nonpos_formula(x, order):
    """``lut_exp_nonpos`` of ``csrc/lut_exp.cuh`` in numpy, one rounded f32
    operation per step.  An addition of an integer constant rounded toward
    −∞ whose result lies in [2^23, 2^24), where the floats are the
    integers, is the constant plus the floor of the other operand."""
    f32 = np.float32
    with np.errstate(all="ignore"):
        t = x * f32(tlut.LOG2E)
        nb = (np.floor(t.astype(np.float64)) + 12582912.0).astype(f32)
        fk = (t - (nb - f32(12582912.0))) * f32(tlut.K)
        db = np.minimum((np.floor(fk.astype(np.float64)) + 8388608.0)
                        .astype(f32), f32(8388608.0 + tlut.K - 1))
        r = fk - (db - f32(8388608.0))
        di = db.view(np.uint32) - np.uint32(0x4B000000)
        p2 = ((nb.view(np.uint32) - np.uint32(0x4B400000) + np.uint32(127))
              << np.uint32(23)).view(f32)
        out = p2 * tlut.make_table().numpy()[di]
        if order:
            out = out * (f32(1.0) + r * f32(tlut.LN2 / tlut.K))
        return np.where(x < f32(tlut.UNDERFLOW_X), f32(0.0), out).astype(f32)


@pytest.mark.parametrize("order", [0, 1])
def test_lut_exp_nonpos_formula_is_the_plain_lut(rng, order):
    """The bf16 streaming-attention kernel's exponential floors by adding a
    magic constant rounded toward −∞ instead of ``floorf`` and float → int
    conversions; for every x <= 0 it is the reference's LUT (JAX core,
    eager: one rounding per operation) bit for bit, and the port's plain
    LUT.  One input differs between those two: the sweep's denormal
    −2^-149, which XLA on the CPU (like the TPU) reads as −0 (e^x = 1)
    while torch and the card keep it (⌊t⌋ = −1, table entry 127).  The
    CUDA code itself is held to the plain LUT on the card (``softmax_exp``
    in ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""
    x = nonpos_sweep(rng)
    got = bits(lut_exp_nonpos_formula(x, order))
    port = tlut.lut_exp(torch.from_numpy(x), order=order).numpy()
    np.testing.assert_array_equal(got, bits(port))
    want = bits(np.asarray(jlut.lut_exp(jnp.asarray(x), order=order)))
    normal = (x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)
    assert (~normal).sum() == 1 and want[~normal] == bits(np.float32(1.0))
    np.testing.assert_array_equal(got[normal], want[normal])
