// PTX wrappers for the bf16 tensor-core path of streaming_attention.cu
// (beside cp.async from cp_async.cuh): ldmatrix (8×8 b16 fragments out
// of shared memory, optionally transposed) and mma.sync m16n8k16 with
// bf16 operands and f32 accumulation.  Fragment layouts are those of the PTX ISA ("Matrix
// Fragments for mma.m16n8k16"): with g = lane / 4 and t = lane % 4,
//   A (16×16, row)  a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..)   a2 = (g, 2t+8..)
//                   a3 = (g+8, 2t+8..)
//   B (16×8, col)   b0 = (2t..2t+1, g)   b1 = (2t+8.., g)
//   C (16×8, f32)   c0, c1 = (g, 2t..2t+1)   c2, c3 = (g+8, 2t..2t+1)
// and the lower 16 bits of a packed pair hold the lower column (or row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace repro {

// Lanes 8i..8i+7 give the row addresses of matrix i; register i receives
// matrix i's (g, 2t..2t+1) pair, or with .trans its (2t..2t+1, g) pair.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* d, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}

// c += a · b on the bf16 tensor cores, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two f32 values x0, x1 as packed bf16 pairs hi + lo: hi is each value's
// upper half (the bf16 truncation; one byte permute packs both), and lo =
// bf16(x − hi), where x − hi is exact in f32 and needs at most 16 bits;
// hi + lo is within 2^-16·|x| of x.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = pack_bf16(__float2bfloat16_rn(__fsub_rn(x0, __uint_as_float(u0 & 0xffff0000u))),
                 __float2bfloat16_rn(__fsub_rn(x1, __uint_as_float(u1 & 0xffff0000u))));
}

}  // namespace repro
