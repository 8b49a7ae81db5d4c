// Per-tensor dynamic int8 quantisation of an f32 or bf16 array: the
// activation side of every int8 projection.
//
// Replaces src/repro/core/quant.py:45 (_quantize / quantize_dynamic), which
// the reference computes in jnp outside its Pallas int8 kernel and XLA
// fuses.  The function is the port's plain version (core/quant.py), bit for
// bit:
//
//   absmax = max |float(x)|
//   scale  = max(absmax, 1e-12) · inv_qmax          (one f32 product)
//   q      = int8(clamp(rint(float(x) / scale), −qmax − 1, qmax))
//
// with inv_qmax the f32 reciprocal of qmax as the compiled reference forms
// it (passed in from Python), the division IEEE-rounded (__fdiv_rn) and
// rint rounding half to even, as torch.round does.  No fast-math.
//
// Two launches behind one C entry, on the caller's stream, with no host
// synchronisation: the scale never leaves the card.
//   1. absmax: a grid-stride reduction over 16 elements a thread per step
//      (16-byte loads), warp shuffles, then one atomicMax per block on the
//      bit pattern of |x| as an unsigned int.  Non-negative floats order as
//      their bits do, so the max is exact and independent of the order; a
//      NaN's bits exceed every other |x|, so a NaN propagates as it does
//      through torch.amax.  The scratch word is zeroed by cudaMemsetAsync
//      in the same entry.
//   2. quantise: every block reads absmax, forms the scale, and writes 16
//      int8 values a thread per step as one 16-byte store; block 0 also
//      writes the scale.
// Unaligned arrays and the tail past the last 16 elements go one element
// a thread.
//
// Bound: bytes.  The function reads x once and writes int8 once (at 4096 ×
// 1024 bf16: 8 + 4 MB, 3.6 µs at 3.35 TB/s); the two passes read x twice,
// the second mostly from the 50 MB L2.  Each pass runs as many blocks as
// the card holds at once, in a grid-stride loop, so the whole grid has its
// 16-byte loads in flight together: at 4096 × 1024 every thread makes
// about one step, one trip to memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;                  // elements a thread per step

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 elements at p (16-byte aligned) into f32.
__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // bf16 → f32: the bf16 bits on top
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) absmax_kernel(const T* __restrict__ x,
                                                         long long n,
                                                         unsigned int* __restrict__ out) {
  uint32_t m = 0;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * THREADS;
  long long done = 0;
  if constexpr (VEC) {
    const long long steps = n / PER_THREAD;
    for (long long s = tid; s < steps; s += nthreads) {
      float v[PER_THREAD];
      load16(x + s * PER_THREAD, v);
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) m = max(m, abs_bits(v[i]));
    }
    done = steps * PER_THREAD;
  }
  for (long long i = done + tid; i < n; i += nthreads) m = max(m, abs_bits(widen(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  __shared__ uint32_t warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(out, m);
  }
}

__device__ __forceinline__ int8_t quantize_one(float v, float scale, float qmax) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -qmax - 1.0f), qmax);
  return (int8_t)(int)q;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) quantize_kernel(
    const T* __restrict__ x, long long n, const unsigned int* __restrict__ absmax_bits,
    float inv_qmax, float qmax, int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const float absmax = __uint_as_float(*absmax_bits);
  // clamp_min(absmax, 1e-12) keeps a NaN, as torch's clamp does
  const float scale = __fmul_rn(absmax < 1e-12f ? 1e-12f : absmax, inv_qmax);
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * THREADS;
  if (tid == 0) *scale_out = scale;
  long long done = 0;
  if constexpr (VEC) {
    const long long steps = n / PER_THREAD;
    for (long long s = tid; s < steps; s += nthreads) {
      float v[PER_THREAD];
      load16(x + s * PER_THREAD, v);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          b |= (uint32_t)(uint8_t)quantize_one(v[4 * j + i], scale, qmax) << (8 * i);
        w[j] = b;
      }
      reinterpret_cast<uint4*>(q)[s] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    done = steps * PER_THREAD;
  }
  for (long long i = done + tid; i < n; i += nthreads)
    q[i] = quantize_one(widen(x[i]), scale, qmax);
}

// The resident grid of a kernel: SMs × the blocks of THREADS that fit on
// one, so every thread issues its first loads at once (queried once).
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
int launch(const void* x, long long n, float inv_qmax, float qmax, void* q,
           void* scale, void* scratch, cudaStream_t stream) {
  static int absmax_grid = 0, quantize_grid = 0;
  const long long per_block = (long long)THREADS * (VEC ? PER_THREAD : 1);
  const long long blocks = (n + per_block - 1) / per_block;
  const long long b1 = std::min(blocks, resident_blocks(absmax_kernel<T, VEC>, &absmax_grid));
  const long long b2 =
      std::min(blocks, resident_blocks(quantize_kernel<T, VEC>, &quantize_grid));
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<T, VEC><<<(unsigned)b1, THREADS, 0, stream>>>(
      (const T*)x, n, (unsigned int*)scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantize_kernel<T, VEC><<<(unsigned)b2, THREADS, 0, stream>>>(
      (const T*)x, n, (const unsigned int*)scratch, inv_qmax, qmax, (int8_t*)q,
      (float*)scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n elements, dtype 0 = float32, 1 = bfloat16; q: n int8; scale: one
// f32; scratch: one 4-byte word of device memory, distinct from scale.
// inv_qmax: the f32 reciprocal of qmax = 2^(bits−1) − 1.  Returns a
// cudaError_t code.
int quantize_dynamic_launch(const void* x, long long n, int dtype, float inv_qmax,
                            float qmax, void* q, void* scale, void* scratch,
                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = ((uintptr_t)x & 15) == 0 && ((uintptr_t)q & 15) == 0;
  if (dtype == 0)
    return vec ? launch<float, true>(x, n, inv_qmax, qmax, q, scale, scratch, s)
               : launch<float, false>(x, n, inv_qmax, qmax, q, scale, scratch, s);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(x, n, inv_qmax, qmax, q, scale, scratch, s)
               : launch<__nv_bfloat16, false>(x, n, inv_qmax, qmax, q, scale, scratch, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
