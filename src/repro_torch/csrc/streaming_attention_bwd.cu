// Backward of the streaming (flash-style) attention with the LUT softmax.
//
// Replaces the backward the reference attaches to its TPU kernel as a
// custom VJP: src/repro/core/attention_api.py (_pallas, attn_bwd) runs the
// jnp flash backward of src/repro/core/streaming_attention.py (_bwd), which
// re-streams the KV blocks and keeps no (Lq, Lkv) tensor.  The TPU has no
// Pallas kernel for it; this is its kernel on the card.  Same contract as
// the forward (streaming_attention.cu):
//
//   q, dq       (B, Hq, Lq, D)    f32 or bf16, any row/head/batch strides, D contiguous
//   k, v, dk, dv (B, Hkv, Lkv, D) q's dtype; query head h reads kv head h / (Hq/Hkv)
//   out, dout   (B, Hq, Lq, D)    q's dtype: the forward's output and its gradient
//   lse         (B, Hq, Lq)       f32, contiguous: the forward's m + log(max(l, 1e-30))
//   delta       (B, Hq, Lq)       f32 scratch, contiguous
//
// With s_c = softcap((q·k)·scale) and the visibility of the forward (key c
// seen by row i at position q_offset + i when c < kv_len, causal c <= pos,
// window pos − c < window), the reference computes, all in f32:
//
//   δ_i   = Σ_e dout_ie · out_ie
//   p_ic  = visible ? exp(s_c − lse_i) : 0   (the call's exponential: the LUT
//           at order 1 or 0, or expf; s_c − lse_i <= 0 since l >= 1, so the
//           LUT is lut_exp_nonpos of lut_exp.cuh, bit-equal to lut_exp there)
//   dp_ic = Σ_e dout_ie · v_ce
//   ds_ic = p_ic (dp_ic − δ_i) · (1 − (s_c/cap)²) · scale   (the cap factor only with a cap)
//   dq_i  = Σ_c ds_ic k_c,   dk_c = Σ_i ds_ic q_i,   dv_c = Σ_i p_ic dout_i
//
// and the outputs round once to the input dtype, as the reference casts
// dq.astype(q.dtype).  dk and dv sum over the G query heads of the kv head
// (GQA) and over every row.
//
// Three kernels, launched in order on the caller's stream, none with an
// atomic: every output element is written once, by one thread, after a
// sum in a fixed order, so two runs give the same bits.
//
//   delta_kernel  one warp per row: δ.
//   dkdv_kernel   one block per (batch·kv head, 64-key tile).  K and V stay
//                 in shared memory; the block loops over the G query heads
//                 of its group and over the 64-row q tiles that can see the
//                 tile (causal and window bounds), recomputing S = Q·Kᵀ and
//                 P, then dV += Pᵀ·dO, dP = dO·Vᵀ, dS, dK += dSᵀ·Q.
//   dq_kernel     one block per (batch·q head, 64-row q tile).  Q and dO
//                 stay in shared memory; the block loops over the key tiles
//                 the q tile can see, recomputing S, P and dP, and
//                 dQ += dS·K.
//
// The translation from the TPU: the reference's backward is one scan over
// the KV blocks carrying dq, which the grid of a card cannot carry across
// blocks without atomics; splitting it into a key-major pass (dK, dV) and a
// query-major pass (dQ) recomputes S and dP once more (7 products of
// 64 × 64 × D a tile pair instead of 5) but keeps every sum inside one block.
//
// A first, simple kernel: every product on the CUDA cores in f32 (bf16
// inputs are widened as they land in shared memory), 256 threads holding
// 4 × 4 register tiles of the 64 × 64 logits as the forward's f32 kernel
// does.  Bound: at the training shapes (BERT-large 8 × 16 × 512 × 64,
// deepseek-7b 8 × 32 × 512 × 128 causal) the work is operations, and f32
// FMAs from shared memory (half a load per FMA) are far from the card's
// bf16 tensor-core peak the bound is counted against; mma.sync or wgmma
// products, with P and dS split into bf16 halves as the forward splits P,
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lut_exp.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;                      // query rows per q tile
constexpr int BK = 64;                      // key rows per kv tile
constexpr int THREADS = 256;
constexpr int TX = 16, TY = THREADS / TX;   // thread grid over (rows, cols)
constexpr int RI = BQ / TY;                 // rows (or keys) per thread
constexpr int CJ = BK / TX;                 // key columns per thread
constexpr int PS = BK + 1;                  // row stride of the P / dS tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  const float* table;    // 128-entry LUT
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_sl;   // element strides: batch, head, row
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int hq, hkv, group, lq, lkv, d;
  int kv_len;            // min(kv_len, Lkv)
  int q_offset;
  int causal;
  int window;            // <= 0: no window
  float scale, cap;      // cap <= 0: no soft-capping
  int exp_mode;          // 0 = lut (order 1), 1 = lut0, 2 = exact
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool visible(const Params& p, int qpos, int col) {
  bool ok = col < p.kv_len;
  if (p.causal) ok = ok && col <= qpos;
  if (p.window > 0) ok = ok && qpos - col < p.window;
  return ok;
}

__device__ __forceinline__ float attn_exp(float x, const float* tab, int mode) {
  if (mode == 2) return expf(x);
  return repro::lut_exp_nonpos(x, tab, mode == 0 ? 1 : 0);
}

// Rows [0, n) of a (ROWS × D) tile into shared memory as f32 with row
// stride D + 1; rows n..ROWS-1 are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(const T* base, long long sl, int n, float* dst,
                                          int tid) {
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, e = i % D;
    dst[r * (D + 1) + e] = r < n ? to_f32(base[r * sl + e]) : 0.0f;
  }
}

template <int D>
constexpr int smem_floats() {
  return repro::LUT_K + 4 * 64 * (D + 1) + BQ * PS + 2 * BQ;
}

// s[i][c] += Σ_e a[row_i][e] · b[key_c][e]: rows ty + TY·i of a, keys
// tx + TX·c of b, both tiles with row stride D + 1.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float (&s)[RI][CJ]) {
  constexpr int DS = D + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) s[i][c] = 0.0f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) {
    float x[RI], y[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = a[(ty + TY * i) * DS + e];
#pragma unroll
    for (int c = 0; c < CJ; ++c) y[c] = b[(tx + TX * c) * DS + e];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = fmaf(x[i], y[c], s[i][c]);
  }
}

// The softmax weights and the logits' gradient of one 64 × 64 tile, in the
// thread's registers: from S (raw q·k sums) and dP, with the rows' lse and
// δ in shared memory.  p[i][c] = visible ? exp(s_c − lse) : 0 and
// ds[i][c] = p (dp − δ) (1 − (s_c/cap)²) scale.
__device__ __forceinline__ void tile_grads(const Params& p, const float* tab,
                                           const float* lse_s, const float* delta_s,
                                           int qpos0, int nq, int c0, int ty, int tx,
                                           const float (&s)[RI][CJ], const float (&dp)[RI][CJ],
                                           float (&pr)[RI][CJ], float (&ds)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + TY * i;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = c0 + tx + TX * c;
      float x = __fmul_rn(s[i][c], p.scale);   // rounded: never fused into s − lse
      if (p.cap > 0.0f) x = p.cap * tanhf(x / p.cap);
      const bool ok = row < nq && visible(p, qpos0 + row, col);
      const float w = ok ? attn_exp(x - lse_s[row], tab, p.exp_mode) : 0.0f;
      float g = w * (dp[i][c] - delta_s[row]);
      if (p.cap > 0.0f) {
        const float t = x / p.cap;
        g = g * (1.0f - t * t);
      }
      pr[i][c] = w;
      ds[i][c] = g * p.scale;
    }
  }
}

// ---------------------------------------------------------------- delta --

template <typename T>
__global__ void delta_kernel(const Params p, long long rows) {
  const long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int i = (int)(r % p.lq);
  const long long bh = r / p.lq;
  const int h = (int)(bh % p.hq), b = (int)(bh / p.hq);
  const T* o = (const T*)p.out + b * p.o_sb + h * p.o_sh + (long long)i * p.o_sl;
  const T* g = (const T*)p.dout + b * p.do_sb + h * p.do_sh + (long long)i * p.do_sl;
  float acc = 0.0f;
  for (int e = lane; e < p.d; e += 32) acc = fmaf(to_f32(g[e]), to_f32(o[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// ----------------------------------------------------------------- dK dV --

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Params p) {
  constexpr int DS = D + 1;
  constexpr int NJ = (D + TX - 1) / TX;     // output columns per thread
  extern __shared__ float smem[];
  float* tab = smem;
  float* ks = tab + repro::LUT_K;           // BK × DS
  float* vs = ks + BK * DS;                 // BK × DS
  float* qs = vs + BK * DS;                 // BQ × DS
  float* gs = qs + BQ * DS;                 // BQ × DS: dout
  float* ps = gs + BQ * DS;                 // BQ × PS: P, then dS
  float* lse_s = ps + BQ * PS;              // BQ
  float* delta_s = lse_s + BQ;              // BQ

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int bk = blockIdx.y;                // batch · kv head
  const int b = bk / p.hkv, hk = bk - b * p.hkv;
  const int c0 = blockIdx.x * BK;
  const int nk = min(BK, p.lkv - c0);

  for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  load_tile<T, D, BK>((const T*)p.k + b * p.k_sb + hk * p.k_sh + (long long)c0 * p.k_sl,
                      p.k_sl, nk, ks, tid);
  load_tile<T, D, BK>((const T*)p.v + b * p.v_sb + hk * p.v_sh + (long long)c0 * p.v_sl,
                      p.v_sl, nk, vs, tid);

  float dk[RI][NJ], dv[RI][NJ];             // keys ty + TY·i, columns tx + TX·n
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) dk[i][n] = dv[i][n] = 0.0f;

  // The rows that can see a key of this tile: past the causal diagonal of
  // its first key, before the window's reach of its last visible key.
  const int c_last = min(c0 + nk, p.kv_len) - 1;
  int r_begin = 0, r_end = c_last >= c0 ? p.lq : 0;
  if (p.causal) r_begin = max(0, c0 - p.q_offset);
  if (p.window > 0) r_end = min(r_end, max(0, c_last + p.window - p.q_offset));
  const int t_begin = r_begin / BQ, t_end = r_end > r_begin ? (r_end + BQ - 1) / BQ : 0;

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    for (int qt = t_begin; qt < t_end; ++qt) {
      const int q0 = qt * BQ;
      const int nq = min(BQ, p.lq - q0);
      __syncthreads();                      // the previous tile's readers are done
      load_tile<T, D, BQ>((const T*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl,
                          p.q_sl, nq, qs, tid);
      load_tile<T, D, BQ>(
          (const T*)p.dout + b * p.do_sb + h * p.do_sh + (long long)q0 * p.do_sl, p.do_sl,
          nq, gs, tid);
      const long long row0 = ((long long)b * p.hq + h) * p.lq + q0;
      for (int i = tid; i < BQ; i += THREADS) {
        lse_s[i] = i < nq ? p.lse[row0 + i] : 0.0f;
        delta_s[i] = i < nq ? p.delta[row0 + i] : 0.0f;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ], pr[RI][CJ], ds[RI][CJ];
      tile_dot<D>(qs, ks, ty, tx, s);
      tile_dot<D>(gs, vs, ty, tx, dp);
      tile_grads(p, tab, lse_s, delta_s, p.q_offset + q0, nq, c0, ty, tx, s, dp, pr, ds);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) ps[(ty + TY * i) * PS + tx + TX * c] = pr[i][c];
      __syncthreads();
      // dV += Pᵀ·dO over the tile's rows, in row order
      for (int r = 0; r < BQ; ++r) {
        float w[RI], y[NJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) w[i] = ps[r * PS + ty + TY * i];
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const int e = tx + TX * n;
          y[n] = e < D ? gs[r * DS + e] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n) dv[i][n] = fmaf(w[i], y[n], dv[i][n]);
      }
      __syncthreads();                      // P is read: the tile takes dS
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) ps[(ty + TY * i) * PS + tx + TX * c] = ds[i][c];
      __syncthreads();
      // dK += dSᵀ·Q over the tile's rows, in row order
      for (int r = 0; r < BQ; ++r) {
        float w[RI], y[NJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) w[i] = ps[r * PS + ty + TY * i];
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const int e = tx + TX * n;
          y[n] = e < D ? qs[r * DS + e] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n) dk[i][n] = fmaf(w[i], y[n], dk[i][n]);
      }
    }
  }

  T* dkb = (T*)p.dk + b * p.dk_sb + hk * p.dk_sh + (long long)c0 * p.dk_sl;
  T* dvb = (T*)p.dv + b * p.dv_sb + hk * p.dv_sh + (long long)c0 * p.dv_sl;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = ty + TY * i;
    if (key >= nk) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int e = tx + TX * n;
      if (e >= D) continue;
      store(dkb + key * p.dk_sl + e, dk[i][n]);
      store(dvb + key * p.dv_sl + e, dv[i][n]);
    }
  }
}

// -------------------------------------------------------------------- dQ --

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Params p) {
  constexpr int DS = D + 1;
  constexpr int NJ = (D + TX - 1) / TX;
  extern __shared__ float smem[];
  float* tab = smem;
  float* ks = tab + repro::LUT_K;           // BK × DS
  float* vs = ks + BK * DS;                 // BK × DS
  float* qs = vs + BK * DS;                 // BQ × DS
  float* gs = qs + BQ * DS;                 // BQ × DS: dout
  float* ps = gs + BQ * DS;                 // BQ × PS: dS
  float* lse_s = ps + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int bh = blockIdx.y;
  const int b = bh / p.hq, h = bh - b * p.hq, hk = h / p.group;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, p.lq - q0);
  const int qpos0 = p.q_offset + q0;

  for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  load_tile<T, D, BQ>((const T*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl,
                      p.q_sl, nq, qs, tid);
  load_tile<T, D, BQ>((const T*)p.dout + b * p.do_sb + h * p.do_sh + (long long)q0 * p.do_sl,
                      p.do_sl, nq, gs, tid);
  const long long row0 = (long long)bh * p.lq + q0;
  for (int i = tid; i < BQ; i += THREADS) {
    lse_s[i] = i < nq ? p.lse[row0 + i] : 0.0f;
    delta_s[i] = i < nq ? p.delta[row0 + i] : 0.0f;
  }

  // key tiles this q tile can see, as the forward's tile_range
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, qpos0 + nq);
  const int kv_begin = p.window > 0 ? max(0, qpos0 - p.window + 1) : 0;
  const int j_begin = kv_begin / BK;
  const int j_end = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  float dq[RI][NJ];                         // rows ty + TY·i, columns tx + TX·n
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) dq[i][n] = 0.0f;

  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  for (int j = j_begin; j < j_end; ++j) {
    const int c0 = j * BK;
    const int nk = min(BK, p.lkv - c0);
    __syncthreads();                        // the previous tile's readers are done
    load_tile<T, D, BK>(kb + (long long)c0 * p.k_sl, p.k_sl, nk, ks, tid);
    load_tile<T, D, BK>(vb + (long long)c0 * p.v_sl, p.v_sl, nk, vs, tid);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ], pr[RI][CJ], ds[RI][CJ];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(gs, vs, ty, tx, dp);
    tile_grads(p, tab, lse_s, delta_s, qpos0, nq, c0, ty, tx, s, dp, pr, ds);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) ps[(ty + TY * i) * PS + tx + TX * c] = ds[i][c];
    __syncthreads();
    // dQ += dS·K over the tile's keys, in key order
    for (int c = 0; c < BK; ++c) {
      float w[RI], y[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) w[i] = ps[(ty + TY * i) * PS + c];
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const int e = tx + TX * n;
        y[n] = e < D ? ks[c * DS + e] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int n = 0; n < NJ; ++n) dq[i][n] = fmaf(w[i], y[n], dq[i][n]);
    }
  }

  T* dqb = (T*)p.dq + b * p.dq_sb + h * p.dq_sh + (long long)q0 * p.dq_sl;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + TY * i;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int e = tx + TX * n;
      if (e < D) store(dqb + row * p.dq_sl + e, dq[i][n]);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * p.hq * p.lq;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int k_tiles = (p.lkv + BK - 1) / BK, q_tiles = (p.lq + BQ - 1) / BQ;
  if (k_tiles > 0) {
    dkdv_kernel<T, D><<<dim3(k_tiles, batch * p.hkv), THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dq_kernel<T, D><<<dim3(q_tiles, batch * p.hq), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 8: return launch<T, 8>(p, batch, s);
    case 16: return launch<T, 16>(p, batch, s);
    case 32: return launch<T, 32>(p, batch, s);
    case 64: return launch<T, 64>(p, batch, s);
    case 128: return launch<T, 128>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv alike);
// lse and delta f32 (B, Hq, Lq) contiguous.  Strides
// are in elements.  Head dims 8–128.  Returns a cudaError_t code.
int streaming_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* lse,
    const void* dout, const void* table, void* delta, void* dq, void* dk, void* dv,
    int batch, int hq, int hkv, int lq, int lkv, int d, long long q_sb, long long q_sh,
    long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
    long long do_sb, long long do_sh, long long do_sl, long long dq_sb, long long dq_sh,
    long long dq_sl, long long dk_sb, long long dk_sh, long long dk_sl, long long dv_sb,
    long long dv_sh, long long dv_sl, int q_offset, int kv_len, int causal, int window,
    float scale, float cap, int exp_mode, int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || lq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || batch * hq > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = (const float*)lse;
  p.table = (const float*)table;
  p.delta = (float*)delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sl = q_sl;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sl = k_sl;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sl = v_sl;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_sl = o_sl;
  p.do_sb = do_sb, p.do_sh = do_sh, p.do_sl = do_sl;
  p.dq_sb = dq_sb, p.dq_sh = dq_sh, p.dq_sl = dq_sl;
  p.dk_sb = dk_sb, p.dk_sh = dk_sh, p.dk_sl = dk_sl;
  p.dv_sb = dv_sb, p.dv_sh = dv_sh, p.dv_sl = dv_sl;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.kv_len = kv_len < lkv ? kv_len : lkv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  p.exp_mode = exp_mode;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(p, batch, d, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, batch, d, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
