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
// design is a grid-stride loop with neighbouring threads on neighbouring
// elements (coalesced), the table staged once per block in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lut_exp.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void lut_exp_kernel(const T* __restrict__ x, T* __restrict__ out,
                               const float* __restrict__ table, long long n,
                               int order) {
  __shared__ float tab[repro::LUT_K];
  for (int i = threadIdx.x; i < repro::LUT_K; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    from_f32(out + i, repro::lut_exp(to_f32(x[i]), tab, order));
  }
}

template <typename T>
int launch(const void* x, void* out, const void* table, long long n, int order,
           cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride past 32 waves
  lut_exp_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)x, (T*)out, (const float*)table, n, order);
  return (int)cudaGetLastError();
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
