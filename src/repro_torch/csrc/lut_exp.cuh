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

}  // namespace repro
