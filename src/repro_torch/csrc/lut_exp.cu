// Elementwise LUT exponential over a flat f32 or bf16 array.
//
// Replaces the TPU kernel src/repro/kernels/lut_exp/kernel.py::lut_exp_2d
// (lut_exp_kernel over (M, 128) tiles).  On the card the serving path does
// not launch this kernel: paged_attention.cu inlines the same __device__
// function (lut_exp.cuh).  This kernel is the bit-exact check of that
// function against the plain PyTorch version, and the standalone op.
//
// Bound: bytes.  Each element is read once and written once and costs ~12
// f32 operations, far below the card's operations-per-byte balance.  The
// design: 16 bytes a thread per step (4 f32 or 8 bf16 values, one vector
// load and one vector store), neighbouring threads on neighbouring vectors
// (coalesced), a grid-stride loop over the grid the card holds at once, so
// the 512-byte table is staged in shared memory once per resident block,
// not once per 256 elements, while each thread's first load is in flight.
// Unaligned arrays and the tail past the last whole vector go one element
// a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lut_exp.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One 16-byte vector: 4 f32 or 8 bf16 values, through f32.
__device__ __forceinline__ uint4 lut_vec(uint4 in, const float* tab, int order, float) {
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __float_as_uint(repro::lut_exp(__uint_as_float(w[i]), tab, order));
  return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ uint4 lut_vec(uint4 in, const float* tab, int order,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // bf16 → f32: the bf16 bits on top
    const float lo = repro::lut_exp(__uint_as_float(w[i] << 16), tab, order);
    const float hi = repro::lut_exp(__uint_as_float(w[i] & 0xFFFF0000u), tab, order);
    o[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) lut_exp_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ table,
    long long n, int order) {
  __shared__ float tab[repro::LUT_K];
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long nv = VEC ? n / V : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  // the first vector is in flight while the table is staged; each later
  // one while the previous is computed
  uint4 cur = make_uint4(0, 0, 0, 0);
  if (tid < nv) cur = __ldg(xv + tid);
  for (int i = threadIdx.x; i < repro::LUT_K; i += THREADS) tab[i] = table[i];
  __syncthreads();
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < nv; i += stride) {
    const uint4 next = i + stride < nv ? __ldg(xv + i + stride) : make_uint4(0, 0, 0, 0);
    ov[i] = lut_vec(cur, tab, order, T());
    cur = next;
  }
  for (long long i = nv * V + tid; i < n; i += stride)
    from_f32(out + i, repro::lut_exp(to_f32(x[i]), tab, order));
}

// SMs × the blocks of THREADS that fit on one (queried once per kernel).
template <typename K>
long long resident_blocks(K kernel, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) !=
            cudaSuccess || per_sm <= 0)
      return 132LL * 4;
    *cache = sms * per_sm;
  }
  return *cache;
}

template <typename T, bool VEC>
int launch_as(const void* x, void* out, const void* table, long long n, int order,
              cudaStream_t stream) {
  static int grid = 0;
  const long long per_block = (long long)THREADS * (VEC ? 16 / (long long)sizeof(T) : 1);
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = resident_blocks(lut_exp_kernel<T, VEC>, &grid);
  if (blocks > cap) blocks = cap;
  lut_exp_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)x, (T*)out, (const float*)table, n, order);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, const void* table, long long n, int order,
           cudaStream_t stream) {
  const bool vec = ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0;
  return vec ? launch_as<T, true>(x, out, table, n, order, stream)
             : launch_as<T, false>(x, out, table, n, order, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code.
int lut_exp_launch(const void* x, void* out, const void* table, long long n,
                   int dtype, int order, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, out, table, n, order, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, table, n, order, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
