// LUT exponential, the paper's UCLM exp (§III-B1), as a __device__ function.
//
// Replaces the body of the TPU kernel src/repro/kernels/lut_exp/kernel.py
// (lut_exp_block, mxu_table_lookup, _pow2_int_f32).  The TPU does the table
// lookup as a one-hot × table product on its matrix unit; here it is a plain
// indexed read of a 128-entry f32 table that the caller keeps in shared
// memory (512 bytes per block).
//
//   e^x = 2^n · T[d] · (1 + r·ln2/128),  n = ⌊x·log2e⌋, d = ⌊frac·128⌋
//
// Bit-exactness with the plain PyTorch version (repro_torch/core/lut_exp.py)
// needs the same operations in the same order, each rounded once: every step
// goes through __fmul_rn / __fadd_rn / __fsub_rn, which the compiler never
// contracts into an FMA.  The constants are the reference's Python doubles
// rounded once to f32.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int LUT_K = 128;
constexpr float LUT_LOG2E = (float)1.4426950408889634;            // 1/ln 2
constexpr float LUT_LN2_OVER_K = (float)(0.6931471805599453 / 128.0);
constexpr float LUT_UNDERFLOW_X = -87.0f;

// order 1: with the residual correction; order 0: without it.
__device__ __forceinline__ float lut_exp(float x, const float* tab, int order) {
  const float t = __fmul_rn(x, LUT_LOG2E);
  const float n = floorf(t);
  const float fk = __fmul_rn(__fsub_rn(t, n), (float)LUT_K);
  const float d = fminf(fmaxf(floorf(fk), 0.0f), (float)(LUT_K - 1));
  const float r = __fsub_rn(fk, d);
  // 2^n from the exponent field, n clipped to [-127, 127]; n <= -127 → 0.
  const int ni = (int)fminf(fmaxf(n, -127.0f), 127.0f);
  const float p2 = ni <= -127 ? 0.0f : __int_as_float((ni + 127) << 23);
  float out = __fmul_rn(p2, tab[(int)d]);
  if (order != 0) out = __fmul_rn(out, __fadd_rn(1.0f, __fmul_rn(r, LUT_LN2_OVER_K)));
  return x < LUT_UNDERFLOW_X ? 0.0f : out;
}

// The derivative of lut_exp at order 1 times an incoming gradient g: the
// floors and the exponent bitcast carry none, so only the residual
// r = (t - n)·K - d moves with x, and
//
//   gx = ((((g · A) · ln2/K) + 0) · K) · log2e,   A = 2^n · T[d],
//
// each operation rounded once, in the order in which autograd of the plain
// version (repro_torch/core/lut_exp.py) takes them: the floors' zero
// gradients are added where their paths join, which turns a product that
// underflowed to -0 into +0 (jax.vjp of the reference multiplies in the
// same order).  A recomputes n and d from x with lut_exp's clamps (a NaN x
// reads n = -127, so A = 0 and gx = +0; a NaN g gives NaN), and x < -87,
// -inf included, gives 0.  At order 0 the derivative is 0: the caller
// launches nothing.
__device__ __forceinline__ float lut_exp_grad(float x, float g, const float* tab) {
  const float t = __fmul_rn(x, LUT_LOG2E);
  const float n = floorf(t);
  const float fk = __fmul_rn(__fsub_rn(t, n), (float)LUT_K);
  const float d = fminf(fmaxf(floorf(fk), 0.0f), (float)(LUT_K - 1));
  const int ni = (int)fminf(fmaxf(n, -127.0f), 127.0f);
  const float p2 = ni <= -127 ? 0.0f : __int_as_float((ni + 127) << 23);
  const float a = __fmul_rn(p2, tab[(int)d]);
  const float gr = __fadd_rn(__fmul_rn(__fmul_rn(g, a), LUT_LN2_OVER_K), 0.0f);
  const float gx = __fmul_rn(__fmul_rn(gr, (float)LUT_K), LUT_LOG2E);
  return x < LUT_UNDERFLOW_X ? 0.0f : gx;
}

// The same function as lut_exp, bit for bit, for every x <= 0 (the
// softmax's s − m and m_prev − m_new), in fewer and cheaper instructions:
// no floorf and no float → int conversion (the card's conversion pipe),
// and no clamp that the domain never needs.  Each floor is one addition
// of a magic constant rounded toward −∞: t + 1.5·2^23 lands in [2^23,
// 2^24), where the floats are the integers, so it is 1.5·2^23 + ⌊t⌋
// exactly, and its low mantissa bits hold ⌊t⌋ as an integer; fk + 2^23
// likewise holds ⌊fk⌋.  On [-87, 0], ⌊t⌋ lies in [-126, 0], so 2^⌊t⌋ is a
// normal float and lut_exp's clamp of n never acts; below -87 both return
// 0.  fk lies in [0, 128] (128 when a tiny negative t makes t − ⌊t⌋ round
// to 1), and one fminf clamps ⌊fk⌋ to 127 as lut_exp does, which also
// keeps the table index in [0, 127] for any input, NaN included.
__device__ __forceinline__ float lut_exp_nonpos(float x, const float* tab, int order) {
  constexpr float MAGIC_N = 12582912.0f;      // 1.5·2^23, bits 0x4B400000
  constexpr float MAGIC_D = 8388608.0f;       // 2^23, bits 0x4B000000
  const float t = __fmul_rn(x, LUT_LOG2E);
  const float nb = __fadd_rd(t, MAGIC_N);                       // 1.5·2^23 + ⌊t⌋
  const float fk = __fmul_rn(__fsub_rn(t, __fsub_rn(nb, MAGIC_N)), (float)LUT_K);
  const float db = fminf(__fadd_rd(fk, MAGIC_D), MAGIC_D + (float)(LUT_K - 1));
  const float r = __fsub_rn(fk, __fsub_rn(db, MAGIC_D));
  const float p2 = __uint_as_float((__float_as_uint(nb) - 0x4B400000u + 127u) << 23);
  float out = __fmul_rn(p2, tab[__float_as_uint(db) - 0x4B000000u]);
  if (order != 0) out = __fmul_rn(out, __fadd_rn(1.0f, __fmul_rn(r, LUT_LN2_OVER_K)));
  return x < LUT_UNDERFLOW_X ? 0.0f : out;
}

}  // namespace repro
