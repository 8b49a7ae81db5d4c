// int8 × int8 → int32 matrix product on the int8 tensor cores, both
// quantisation scales applied in the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py
// (int8_matmul_2d → int8_matmul_kernel).  Same contract:
//
//   x        (M, K) int8, row-major        the dynamically quantised input
//   w        (K, N) int8, row-major        the per-channel quantised weight
//   x_scale  one f32 in device memory      per tensor
//   w_scale  (N,) f32                      per output channel
//   out      (M, N) f32                    float(acc) · (x_scale · w_scale[n])
//   acc_out  (M, N) int32 or null          the exact accumulator, for checks
//
// The conversion float(acc) rounds to nearest even once |acc| > 2^24, as
// the reference's astype(f32) does, and the two scales multiply first, as
// in the reference kernel (its core applies them the other way round,
// within two f32 ulps).  No pad copies: ragged M and N are masked and the K
// tail is zero-filled in shared memory, which is what the reference's zero
// padding (ops.py _pad2) means.
//
// Translation from the TPU: the TPU grid is (M/bm, N/bn, K/bk) with k a
// sequential axis carrying a 256×256 int32 accumulator in VMEM scratch.
// Here one block of 8 warps owns a 128×128 output tile and loops over K in
// 64-byte steps itself, the accumulators living in registers (each warp a
// 64×32 sub-tile: 4 × 4 mma tiles of 16×8, 64 int32 a thread).  Products
// go through mma.sync.m16n8k32.s8.s8.s32.  Tiles reach shared memory
// through a three-stage cp.async ring (16-byte copies, zero-fill past the
// edges) when K and N are multiples of 16, else through plain byte loads.
// A is read with ldmatrix (an int8 m16k32 A fragment is a b16 8×8 ldmatrix
// fragment).  B must be "col" (k contiguous for each n) but w is (K, N)
// with n contiguous, and ldmatrix cannot transpose bytes: each thread
// loads four 32-bit words from four consecutive k rows at the same four
// columns and transposes the 4×4 bytes with __byte_perm.  Those four
// columns feed the warp's four n8 tiles, so the mma tile j's column c is
// physical column 4c + j; in the accumulator each thread then holds eight
// consecutive columns of a row, stored as two float4.  Both tiles are XOR
// swizzled in 16-byte chunks, so ldmatrix and the B words load without
// bank conflicts.
//
// Bound (H100 SXM: 1,979 TOPS int8 dense, 3.35 TB/s): at the BERT-large
// projections (M = 4096 tokens) the f32 output dominates the bytes and the
// 1024×1024 and 1024×4096 products are bound by bytes (22 and 75 MB); the
// 4096×1024 one is bound by operations (34 GOP).  mma.sync reaches only
// part of the int8 rate (wgmma is the way to all of it) and the epilogue
// stores half-sectors per instruction; wgmma with TMA loads, a persistent
// tile loop and a staged, fully coalesced store are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;      // block tile; k bytes a step
constexpr int STAGES = 3;
constexpr int THREADS = 256;                     // 8 warps: 2 (m) × 4 (n)
constexpr int A_BYTES = BM * BK, B_BYTES = BK * BN;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* x_scale;
  const float* w_scale;
  float* out;
  int32_t* acc_out;
  int m, n, k;
};

// Byte offset of (row r, byte c) in a tile: 16-byte chunks XOR swizzled.
// A rows are 64 bytes (4 chunks): chunk ^ ((r >> 1) & 3) puts the 8 rows of
// an ldmatrix phase in 8 distinct bank quads.  B rows are 128 bytes (8
// chunks): chunk ^ (2 · ((r >> 2) & 3)) spreads the 4 k-groups that one
// word load of a warp touches over 4 distinct pairs of chunks.
__device__ __forceinline__ int a_off(int r, int c) {
  return r * BK + ((((c >> 4) ^ ((r >> 1) & 3))) << 4) + (c & 15);
}
__device__ __forceinline__ int b_off(int r, int c) {
  return r * BN + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15);
}

// Tile kt of x (rows m0.., k bytes kt·BK..) and of w (k rows kt·BK.., columns
// n0..) into one stage; everything past M, N or K reads as 0.
template <bool ALIGNED>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* st, int kt,
                                           int m0, int n0, int tid) {
  uint8_t* as = st;
  uint8_t* bs = st + A_BYTES;
  const int k0 = kt * BK;
  if constexpr (ALIGNED) {            // K % 16 == 0 and N % 16 == 0
#pragma unroll
    for (int i = 0; i < A_BYTES / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 16), ch = c % (BK / 16);
      const bool ok = m0 + r < p.m && k0 + ch * 16 < p.k;
      const int8_t* src = ok ? p.x + (size_t)(m0 + r) * p.k + k0 + ch * 16 : p.x;
      repro::cp_async16(as + a_off(r, ch * 16), src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_BYTES / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const bool ok = k0 + r < p.k && n0 + ch * 16 < p.n;
      const int8_t* src = ok ? p.w + (size_t)(k0 + r) * p.n + n0 + ch * 16 : p.w;
      repro::cp_async16(bs + b_off(r, ch * 16), src, ok);
    }
  } else {
    for (int i = tid; i < A_BYTES; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const bool ok = m0 + r < p.m && k0 + c < p.k;
      as[a_off(r, c)] = ok ? (uint8_t)p.x[(size_t)(m0 + r) * p.k + k0 + c] : 0;
    }
    for (int i = tid; i < B_BYTES; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const bool ok = k0 + r < p.k && n0 + c < p.n;
      bs[b_off(r, c)] = ok ? (uint8_t)p.w[(size_t)(k0 + r) * p.n + n0 + c] : 0;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(repro::smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w0..w3 hold rows k..k+3 at columns j = 0..3 (byte j of each); → r[j] holds
// column j at rows k..k+3 (byte i = row k + i).
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2,
                                             uint32_t w3, uint32_t* r) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2) int8_matmul_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;      // warp's 64×32 sub-tile
  const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (p.k + BK - 1) / BK;

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage<ALIGNED>(p, smem + s * STAGE_BYTES, s, m0, n0, tid);
    repro::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {   // refill the stage every warp finished with in the previous step
      const int nk = kt + STAGES - 1;
      if (nk < ktiles)
        load_stage<ALIGNED>(p, smem + (nk % STAGES) * STAGE_BYTES, nk, m0, n0, tid);
      repro::cp_async_commit();
    }
    const uint8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* bs = as + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // lanes 0-7: rows 0-7, bytes kk..+15; 8-15: rows 8-15; 16-31: +16 bytes
        const int r = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[i], as + a_off(r, kk + (lane >> 4) * 16));
      }
      uint32_t b[2][4];                 // [k half][n8 tile j]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kk + h * 16 + t * 4, c = wn * 32 + g * 4;
        transpose4x4(*reinterpret_cast<const uint32_t*>(bs + b_off(r, c)),
                     *reinterpret_cast<const uint32_t*>(bs + b_off(r + 1, c)),
                     *reinterpret_cast<const uint32_t*>(bs + b_off(r + 2, c)),
                     *reinterpret_cast<const uint32_t*>(bs + b_off(r + 3, c)), b[h]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[0][j], b[1][j]);
    }
  }
  repro::cp_async_wait<0>();

  // Epilogue.  Tile j's fragment column 2t (+1) is physical column
  // 8t + j (+4): the thread holds columns cb .. cb + 7 of rows g and g + 8.
  const int cb = n0 + wn * 32 + t * 8;
  const float xs = __ldg(p.x_scale);
  float sc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    sc[q] = cb + q < p.n ? __fmul_rn(xs, __ldg(p.w_scale + cb + q)) : 0.0f;
  const bool vec = (p.n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + i * 16 + g + hr * 8;
      if (row >= p.m) continue;
      int32_t v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[i][q][hr * 2];
        v[q + 4] = acc[i][q][hr * 2 + 1];
      }
      float o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) o[q] = __fmul_rn(__int2float_rn(v[q]), sc[q]);
      const size_t base = (size_t)row * p.n + cb;
      if (vec && cb + 8 <= p.n) {
        float4* dst = reinterpret_cast<float4*>(p.out + base);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        if (p.acc_out) {
          int4* da = reinterpret_cast<int4*>(p.acc_out + base);
          da[0] = make_int4(v[0], v[1], v[2], v[3]);
          da[1] = make_int4(v[4], v[5], v[6], v[7]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (cb + q < p.n) {
            p.out[base + q] = o[q];
            if (p.acc_out) p.acc_out[base + q] = v[q];
          }
        }
      }
    }
  }
}

template <bool ALIGNED>
int launch(const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  int8_matmul_kernel<ALIGNED><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k), w (k, n) int8 row-major; x_scale one f32; w_scale (n,) f32;
// out (m, n) f32; acc_out (m, n) int32 or null.  Returns a cudaError_t code.
int int8_matmul_launch(const void* x, const void* w, const void* x_scale,
                       const void* w_scale, void* out, void* acc_out, int m,
                       int n, int k, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || k <= 0 || (m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.x_scale = (const float*)x_scale;
  p.w_scale = (const float*)w_scale;
  p.out = (float*)out;
  p.acc_out = (int32_t*)acc_out;
  p.m = m;
  p.n = n;
  p.k = k;
  const bool aligned = k % 16 == 0 && n % 16 == 0 && ((uintptr_t)x & 15) == 0 &&
                       ((uintptr_t)w & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return aligned ? launch<true>(p, s) : launch<false>(p, s);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
