// Contiguous streaming (flash-style) attention forward with the LUT softmax.
//
// Replaces the TPU kernel src/repro/kernels/streaming_attention/kernel.py
// (attention_3d → attention_kernel).  Same contract:
//
//   q    (B, Hq, Lq, D)    f32 or bf16, any row/head/batch strides, D contiguous
//   k, v (B, Hkv, Lkv, D)  q's dtype; query head h reads kv head h / (Hq/Hkv)
//   out  (B, Hq, Lq, D)    q's dtype, any strides
//
// Row i sits at position q_offset + i.  Key c is visible to it when
// c < kv_len, and (causal) c <= q_offset + i, and (window) q_offset + i - c
// < window.  Logits s = (q·k)·scale, optionally soft-capped (cap·tanh(s/cap)),
// fold into an f32 online softmax (m, l, acc): m starts at -1e30, p =
// visible ? exp(s − m_new) : 0 and alpha = exp(m_prev − m_new), both through
// the same exponential (the LUT of lut_exp.cuh at order 1 or 0, or expf for
// exp_mode "exact"); the output is acc / max(l, 1e-30), so a row that sees
// no key emits 0.
//
// Translation from the TPU: the TPU grid is (B·Hq, q block, kv block) with
// the kv block a sequential axis carrying (m, l, acc) in VMEM scratch.  Here
// one block owns one (batch·head, 64-row q tile) and loops over 64-row kv
// tiles itself, from the first tile its window can see to the last one its
// causal bound and kv_len allow: fully masked tiles are never loaded.
// Blocks run in any order; nothing is carried between them.  Ragged tails
// (Lq, Lkv not multiples of 64) are zero-filled in shared memory and masked.
//
// Bound: at BERT-large widths (l = 512, 16 heads × 64) the work is
// operations (2·l·D per logit and per output row), far above the card's
// bytes-per-operation balance; q, k, v and out each cross device memory once
// per (q tile, kv tile) pair.  This first version computes in f32 on the
// CUDA cores, as the reference does (its P·V multiplies f32 p by f32 v), not
// on bf16 tensor cores, which would round p first.  256 threads hold the
// q tile's 64 × 64 logits as a 16 × 16 grid of 4 × 4 register tiles: a
// thread owns rows ty + 16i and key columns tx + 16j, so every row lives in
// one half-warp and its max and sum are 4-step shuffles.  The same threads
// own the same rows of the output accumulator (columns tx + 16n), so the
// online-softmax rescale never leaves registers; P goes through shared
// memory once for P·V.  Q and K tiles sit in shared memory as f32 with an
// odd row stride (D + 1), which keeps the 16 columns a half-warp reads in 16
// banks.  Tensor-core products (wgmma on bf16 with p rounded, or TF32), TMA
// tile loads and a double-buffered kv ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lut_exp.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int TX = 16, TY = THREADS / TX;   // thread grid over (rows, cols)
constexpr int BQ = 64;                      // query rows per block
constexpr int BK = 64;                      // key rows per kv tile
constexpr int RI = BQ / TY;                 // rows per thread
constexpr int CJ = BK / TX;                 // key columns per thread
constexpr int PS = BK + 16;                 // row stride of the P tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = f[j];
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* table;    // 128-entry LUT
  void* out;
  long long q_sb, q_sh, q_sl;   // element strides: batch, head, row
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int hq, group, lq, lkv;
  int kv_len;            // min(kv_len, Lkv)
  int q_offset;
  int causal;
  int window;            // <= 0: no window
  float scale, cap;      // cap <= 0: no soft-capping
  int exp_mode;          // 0 = lut (order 1), 1 = lut0, 2 = exact
  int vec;               // every row 16-byte aligned: vector loads
};

// Rows [0, n) of a (ROWS × D) tile into shared memory as f32 with row stride
// DS; rows n..ROWS-1 are zero.  Neighbouring threads read neighbouring
// elements; the vector path moves 16 bytes per thread and load.
template <typename T, int D, int ROWS, int DS>
__device__ __forceinline__ void load_tile(const T* base, long long sl, int n,
                                          float* dst, int vec, int tid) {
  if (vec) {
    constexpr int V = Vec16<T>::N;
    for (int i = tid; i < ROWS * D / V; i += THREADS) {
      const int r = (i * V) / D, e = (i * V) % D;
      float f[V];
      if (r < n) {
        unpack16(__ldg(reinterpret_cast<const uint4*>(base + r * sl + e)), f, base);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * DS + e + j] = f[j];
    }
  } else {
    for (int i = tid; i < ROWS * D; i += THREADS) {
      const int r = i / D, e = i % D;
      dst[r * DS + e] = r < n ? to_f32(base[r * sl + e]) : 0.0f;
    }
  }
}

__device__ __forceinline__ float attn_exp(float x, const float* tab, int mode) {
  if (mode == 2) return expf(x);
  return repro::lut_exp(x, tab, mode == 0 ? 1 : 0);
}

template <int D>
constexpr int smem_floats() {
  return repro::LUT_K + BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) streaming_attention_kernel(const Params p) {
  constexpr int DS = D + 1;                 // odd row stride of the Q and K tiles
  constexpr int NJ = (D + TX - 1) / TX;     // output columns per thread
  extern __shared__ float smem[];
  float* tab = smem;                        // LUT_K
  float* qs = tab + repro::LUT_K;           // BQ × DS
  float* ks = qs + BQ * DS;                 // BK × DS
  float* vs = ks + BK * DS;                 // BK × D
  float* ps = vs + BK * D;                  // BQ × PS softmax weights

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int bh = blockIdx.y;
  const int b = bh / p.hq, h = bh - b * p.hq, hk = h / p.group;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, p.lq - q0);
  const T* qb = (const T*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl;
  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  load_tile<T, D, BQ, DS>(qb, p.q_sl, nq, qs, p.vec, tid);

  // kv tiles this q tile can see: the window's first key up to the causal
  // bound of its last row and kv_len.
  const int qpos0 = p.q_offset + q0;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, qpos0 + nq);
  const int kv_begin = p.window > 0 ? max(0, qpos0 - p.window + 1) : 0;
  const int j_begin = kv_begin / BK;
  const int j_end = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  float m[RI], l[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.0f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int c0 = j * BK;
    const int nk = min(BK, p.lkv - c0);
    __syncthreads();  // the previous tile's readers are done (and Q is staged)
    load_tile<T, D, BK, DS>(kb + (long long)c0 * p.k_sl, p.k_sl, nk, ks, p.vec, tid);
    load_tile<T, D, BK, D>(vb + (long long)c0 * p.v_sl, p.v_sl, nk, vs, p.vec, tid);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float a[RI], kk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + TY * i) * DS + e];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kk[c] = ks[(tx + TX * c) * DS + e];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) s[i][c] = fmaf(a[i], kk[c], s[i][c]);
    }

    // Online softmax, one row per half-warp: mask, row max, weights, sum.
    // Masked weights are zeroed explicitly, never left to underflow.
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + TY * i;
      const int qpos = qpos0 + row;
      float rmax = NEG_INF;
      bool vis[CJ];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int col = c0 + tx + TX * c;
        float x = __fmul_rn(s[i][c], p.scale);  // rounded: never fused into s − m
        if (p.cap > 0.0f) x = p.cap * tanhf(x / p.cap);
        bool ok = col < p.kv_len;
        if (p.causal) ok = ok && col <= qpos;
        if (p.window > 0) ok = ok && qpos - col < p.window;
        vis[c] = ok;
        s[i][c] = ok ? x : NEG_INF;
        rmax = fmaxf(rmax, s[i][c]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float w = vis[c] ? attn_exp(s[i][c] - m_new, tab, p.exp_mode) : 0.0f;
        ps[row * PS + tx + TX * c] = w;
        rsum += w;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = attn_exp(m[i] - m_new, tab, p.exp_mode);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NJ; ++n) acc[i][n] *= alpha;
    }
    __syncwarp();  // a row's weights are written and read by its own half-warp

    // acc += P·V: a V row feeds RI rows, a P column NJ output columns
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[RI], vv[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pr[i] = ps[(ty + TY * i) * PS + c];
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const int e = tx + TX * n;
        vv[n] = e < D ? vs[c * D + e] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int n = 0; n < NJ; ++n) acc[i][n] = fmaf(pr[i], vv[n], acc[i][n]);
    }
  }

  T* ob = (T*)p.out + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_sl;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + TY * i;
    if (row >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int e = tx + TX * n;
      if (e < D) store_f32(ob + row * p.o_sl + e, acc[i][n] / denom);
    }
  }
}

template <typename T, int D>
int launch(Params p, int bhq, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  const long long strides[] = {p.q_sb, p.q_sh, p.q_sl, p.k_sb, p.k_sh,
                               p.k_sl, p.v_sb, p.v_sh, p.v_sl};
  bool vec = D % V == 0 && (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
             (uintptr_t)p.v % 16 == 0;
  for (long long s : strides) vec = vec && s % V == 0;
  p.vec = vec;
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        streaming_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.lq + BQ - 1) / BQ, bhq);
  streaming_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, int d, int bhq, cudaStream_t s) {
  switch (d) {
    case 8: return launch<T, 8>(p, bhq, s);
    case 16: return launch<T, 16>(p, bhq, s);
    case 32: return launch<T, 32>(p, bhq, s);
    case 64: return launch<T, 64>(p, bhq, s);
    case 128: return launch<T, 128>(p, bhq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  Strides are in
// elements.  Returns a cudaError_t code.
int streaming_attention_launch(const void* q, const void* k, const void* v,
                               const void* table, void* out, int batch, int hq,
                               int hkv, int lq, int lkv, int d, long long q_sb,
                               long long q_sh, long long q_sl, long long k_sb,
                               long long k_sh, long long k_sl, long long v_sb,
                               long long v_sh, long long v_sl, long long o_sb,
                               long long o_sh, long long o_sl, int q_offset,
                               int kv_len, int causal, int window, float scale,
                               float cap, int exp_mode, int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || lq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || batch * hq > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.table = (const float*)table;
  p.out = out;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sl = q_sl;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sl = k_sl;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sl = v_sl;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sl = o_sl;
  p.hq = hq;
  p.group = hq / hkv;
  p.lq = lq;
  p.lkv = lkv;
  p.kv_len = kv_len < lkv ? kv_len : lkv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  p.exp_mode = exp_mode;
  p.vec = 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(p, d, batch * hq, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, d, batch * hq, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
