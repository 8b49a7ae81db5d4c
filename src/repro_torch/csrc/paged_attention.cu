// Paged attention over a page pool, read in place through the page table:
// a split-KV pass and a combine pass.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_4d → paged_attention_kernel).  Same contract:
//
//   q      (B, Hkv, R = G·Lq, D)  f32 or bf16; row r is query head group
//                                 r / Lq, query index r % Lq
//   pools  (N+1, Hkv, ps, D)      f32, bf16 or int8 (+ f32 (N+1, Hkv, ps)
//                                 per-row scales for int8)
//   table  (B, P) int32, kv_len (B,) int32
//   out    (B, Hkv, R, D)         q's dtype
//
// Row r of lane b attends pool rows at structural positions
// col <= kv_len - Lq + r % Lq (and, with a window, kv_len - Lq + r % Lq - col
// < window).  Logits are scaled, optionally soft-capped, masked, and folded
// into an f32 online softmax (m, l, acc) with the LUT exponential of
// lut_exp.cuh (or expf for exp_mode "exact").
//
// Translation from the TPU: the TPU grid walks (lane, kv head, page slot)
// with the page slot as a sequential axis carrying (m, l, acc) in VMEM
// scratch, and the page table arrives by scalar prefetch.  Here a lane's
// table slots are cut into S = ⌈P / kv_split⌉ splits of kv_split pages,
// and one block owns one (lane, kv head, row tile, split): it walks its
// split's live page tiles (col < kv_len) from a fresh (m, l, acc), reading
// its own page ids from the table row, and writes the three partials to an
// f32 workspace.  A split that starts at or past kv_len returns at once.
// The combine pass (paged_combine_kernel, one warp per row) then merges the
// live splits of each row — the paper's softmax by reduce and gather: M =
// max m_s, w_s = exp(m_s − M), out = Σ w_s·acc_s / max(Σ w_s·l_s, 1e-30).
// S depends only on P (the scheduler's power-of-two bucket), never on a
// device value, so the host never reads kv_len.  Dead q-blocks (kv_len
// pinned to 1) walk one page, and their table rows name the pool's scratch
// page, so every read stays in bounds; their rows are fully masked and
// emit zeros.
//
// Bound: bytes for decode-like steps (each live KV row is read once per row
// tile and feeds only G·Lq rows), operations for long prefill chunks.
// Splitting a long lane over blocks puts the card's 132 SMs on the decode
// step's few lanes (a block walks at most kv_split pages, not the longest
// lane's whole table).  K/V tiles of up to 32 rows are staged in shared
// memory as they lie in the pool (f32, bf16 or int8, with the int8 rows'
// scales) through a two-stage cp.async ring: the next tile is in flight
// while the current one is consumed.  They are widened (and int8
// dequantised, (float)k · scale as the plain version) on the read from
// shared memory.  The (rows × keys) logits, the online softmax (warp
// shuffles across a row's keys) and P·V run on the CUDA cores in f32, one
// thread per logit or output element; the exponential is lut_exp_nonpos,
// bit-equal to lut_exp on its x <= 0 arguments.  Tensor-core products,
// TMA and persistent blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "lut_exp.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int MAX_ROW_TILE = 16;   // query rows per block (ops.py MAX_ROW_TILE)
constexpr int MAX_HEAD_DIM = 256;  // ops.py MAX_HEAD_DIM
constexpr int COMBINE_WARPS = 4;   // rows per combine block
constexpr int SPLIT_BATCH = 8;     // splits whose partials a combine warp loads at once

__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Pool elements widened to f32, exactly, on the integer and FP32 pipes
// (no conversion instructions): a bf16 is the upper half of its f32; a
// signed byte b, flipped to b + 128 and placed under the exponent of 2^23,
// is 2^23 + 128 + b, from which one exact subtraction leaves b.
constexpr float INT8_BIAS = 8388736.0f;   // 2^23 + 128
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((uint32_t)(uint8_t)x ^ 0x80u)), INT8_BIAS);
}

template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = f[j];
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const __nv_bfloat16*) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const int8_t*) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[4 * j + i] =
          __fsub_rn(__uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7540u | i)), INT8_BIAS);
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // null for float pools
  const float* v_scale;
  const int* page_table;
  const int* kv_len;
  const float* table;    // 128-entry LUT
  float* part_m;         // (B, Hkv, S, R)
  float* part_l;         // (B, Hkv, S, R)
  float* part_acc;       // (B, Hkv, S, R, D)
  int hkv, rows, d, ps, slots, q_len, row_tile, key_tile, kv_split, splits;
  float scale, cap;      // cap <= 0: no soft-capping
  int window;            // <= 0: no window
  int exp_mode;          // 0 = lut (order 1), 1 = lut0, 2 = exact
  int vec_ok;            // pools 16-byte aligned and D a multiple of a vector
  int kt_pow2;           // key tile a power of two (<= 32): warp softmax
};

// Shared-memory layout, byte offsets (each region 16-byte aligned).  K rows
// are padded by one 16-byte vector: a quarter-warp's eight 16-byte reads of
// eight consecutive keys then fall in eight distinct bank groups.
__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }
template <typename KVT>
__host__ __device__ constexpr int dv_elems(int d) {   // V row stride, elements
  return (d + Vec16<KVT>::N - 1) / Vec16<KVT>::N * Vec16<KVT>::N;
}
template <typename KVT>
__host__ __device__ constexpr int ks_elems(int d) {   // K row stride, elements
  return dv_elems<KVT>(d) + Vec16<KVT>::N;
}
__host__ __device__ constexpr int qd_elems(int d) { return (d + 3) & ~3; }
__host__ __device__ constexpr int rt4(int rt) { return (rt + 3) & ~3; }

struct Layout {
  int qs, ss, acc, ml, scl, kst, vst, bytes;
};

template <typename KVT>
__host__ __device__ Layout smem_layout(int rt, int kt, int d) {
  Layout L{};
  int o = repro::LUT_K * 4;                   // the table first
  L.qs = o;  o = up16(o + rt * qd_elems(d) * 4);
  L.ss = o;  o = up16(o + kt * rt4(rt) * 4);   // [key][row]: a key's rows as float4
  L.acc = o; o = up16(o + rt * d * 4);
  L.ml = o;  o = up16(o + 3 * rt * 4);
  L.scl = o; o = up16(o + 2 * 2 * kt * 4);    // [stage][k, v][key] scales
  L.kst = o; o = up16(o + 2 * kt * ks_elems<KVT>(d) * (int)sizeof(KVT));
  L.vst = o; o = up16(o + 2 * kt * dv_elems<KVT>(d) * (int)sizeof(KVT));
  L.bytes = o;
  return L;
}

// Issue the copy of the KT pool rows at structural column col0 of lane b,
// head h into one stage: 16-byte cp.async where the pool allows it, else
// element by element through registers; int8 row scales by 4-byte cp.async.
template <typename KVT>
__device__ __forceinline__ void issue_tile(const Params& p, int b, int h, int col0,
                                           KVT* kdst, KVT* vdst, float* sdst, int tid) {
  const int KT = p.key_tile, D = p.d;
  const int slot = col0 / p.ps;
  const long long page = p.page_table[(long long)b * p.slots + slot];
  const long long prow = (page * p.hkv + h) * p.ps + (col0 - slot * p.ps);
  const KVT* kp = (const KVT*)p.k_pool + prow * D;
  const KVT* vp = (const KVT*)p.v_pool + prow * D;
  constexpr int V = Vec16<KVT>::N;
  const int KS = ks_elems<KVT>(D), DV = dv_elems<KVT>(D);
  if (p.vec_ok) {
    const int per_row = D / V;
    for (int i = tid; i < KT * per_row; i += THREADS) {
      const int c = i / per_row, e = (i - c * per_row) * V;
      repro::cp_async16(kdst + c * KS + e, kp + c * D + e, true);
      repro::cp_async16(vdst + c * DV + e, vp + c * D + e, true);
    }
  } else {
    for (int i = tid; i < KT * D; i += THREADS) {
      const int c = i / D, e = i - c * D;
      kdst[c * KS + e] = kp[c * D + e];
      vdst[c * DV + e] = vp[c * D + e];
    }
  }
  if (p.k_scale != nullptr) {
    for (int c = tid; c < KT; c += THREADS) {
      repro::cp_async4(sdst + c, p.k_scale + prow + c);
      repro::cp_async4(sdst + KT + c, p.v_scale + prow + c);
    }
  }
}

__device__ __forceinline__ float attn_exp(float x, const float* tab, int mode) {
  if (mode == 2) return expf(x);
  return repro::lut_exp_nonpos(x, tab, mode == 0 ? 1 : 0);
}

// q·k over D, k widened (int8: times its row scale, one rounding, the
// plain version's f32 value) on the read; four independent partial sums.
template <typename KVT>
__device__ __forceinline__ float qk_dot(const float* q, const KVT* k, int D, float ksc) {
  constexpr bool QUANT = sizeof(KVT) == 1;
  constexpr int V = Vec16<KVT>::N;
  const int dfull = D / V * V;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 2
  for (int e = 0; e < dfull; e += V) {
    float kf[V];
    unpack16(*reinterpret_cast<const uint4*>(k + e), kf, k);
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q + e + j);
      s0 += qv.x * (QUANT ? __fmul_rn(kf[j], ksc) : kf[j]);
      s1 += qv.y * (QUANT ? __fmul_rn(kf[j + 1], ksc) : kf[j + 1]);
      s2 += qv.z * (QUANT ? __fmul_rn(kf[j + 2], ksc) : kf[j + 2]);
      s3 += qv.w * (QUANT ? __fmul_rn(kf[j + 3], ksc) : kf[j + 3]);
    }
  }
  for (int e = dfull; e < D; ++e) {
    const float kf = widen(k[e]);
    s0 += q[e] * (QUANT ? __fmul_rn(kf, ksc) : kf);
  }
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ bool visible(const Params& p, int kv_len, int row, int col) {
  const int qpos = kv_len - p.q_len + row % p.q_len;
  return col <= qpos && (p.window <= 0 || qpos - col < p.window);
}

// The split pass.  RTM: compile-time bound on the row tile (8 or 16), the
// size of the P·V register accumulators.
template <typename QT, typename KVT, int RTM>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(const Params p) {
  constexpr bool QUANT = sizeof(KVT) == 1;
  const int b = blockIdx.x, h = blockIdx.y;
  const int rt_idx = blockIdx.z / p.splits, split = blockIdx.z - rt_idx * p.splits;
  const int RT = p.row_tile, KT = p.key_tile, D = p.d;
  const int r0 = rt_idx * RT;
  const int nr = min(RT, p.rows - r0);
  const int tid = threadIdx.x;

  const int kv_len = p.kv_len[b];
  const int live_slots = min(p.slots, (max(kv_len, 0) + p.ps - 1) / p.ps);
  const int slot0 = split * p.kv_split;
  if (slot0 >= live_slots) return;            // block-uniform: a dead split
  const int col_begin = slot0 * p.ps;
  const int col_end = min(min(slot0 + p.kv_split, live_slots) * p.ps, kv_len);
  const int n_tiles = (col_end - col_begin + KT - 1) / KT;   // >= 1

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = smem_layout<KVT>(RT, KT, D);
  const int QD = qd_elems(D), KS = ks_elems<KVT>(D), DV = dv_elems<KVT>(D);
  const int RT4 = rt4(RT);
  float* tab = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L.qs);     // RT × QD
  float* ss = reinterpret_cast<float*>(smem + L.ss);     // KT × RT4 logits, then weights
  float* acc = reinterpret_cast<float*>(smem + L.acc);   // RT × D
  float* m_s = reinterpret_cast<float*>(smem + L.ml);    // RT running max
  float* l_s = m_s + RT;                                 // RT running denominator
  float* a_s = l_s + RT;                                 // RT rescale factor of this tile
  float* scl = reinterpret_cast<float*>(smem + L.scl);   // [2][2][KT]
  KVT* kst = reinterpret_cast<KVT*>(smem + L.kst);       // [2][KT × KS]
  KVT* vst = reinterpret_cast<KVT*>(smem + L.vst);       // [2][KT × DV]

  issue_tile(p, b, h, col_begin, kst, vst, scl, tid);    // tile 0 → stage 0
  repro::cp_async_commit();

  for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  const long long q_base = (((long long)b * p.hkv + h) * p.rows + r0) * D;
  const QT* q = (const QT*)p.q;
  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = i / D;
    qs[r * QD + i - r * D] = widen(q[q_base + i]);
    acc[i] = 0.0f;
  }
  for (int r = tid; r < nr; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int col0 = col_begin + t * KT;
    // Tile t has landed for every thread, and every reader of tile t − 1
    // (its stage, the weights, the rescale factors) is done.
    repro::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles)
      issue_tile(p, b, h, col0 + KT, kst + (stage ^ 1) * KT * KS,
                 vst + (stage ^ 1) * KT * DV, scl + (stage ^ 1) * 2 * KT, tid);
    repro::cp_async_commit();
    const KVT* ks = kst + stage * KT * KS;
    const KVT* vs = vst + stage * KT * DV;
    const float* k_sc = scl + stage * 2 * KT;
    const float* v_sc = k_sc + KT;

    // Logits and the online-softmax update.  Masked weights are zeroed
    // explicitly, never left to the exponential's underflow.
    if (p.kt_pow2) {
      // One (row, key) per thread: a row's KT keys sit in KT adjacent
      // lanes of one warp, so its max and sum are shuffle reductions and
      // the row's first lane updates (m, l) and the rescale factor.  The
      // loop bound is block-uniform, so every lane reaches every shuffle.
      for (int base = 0; base < nr * KT; base += THREADS) {
        const int i = base + tid;
        const bool active = i < nr * KT;
        const int r = i / KT, c = i - r * KT;
        float s = NEG_INF, m_prev = NEG_INF;
        bool vis = false;
        if (active) {
          s = qk_dot(qs + r * QD, ks + c * KS, D, QUANT ? k_sc[c] : 1.0f) * p.scale;
          if (p.cap > 0.0f) s = p.cap * tanhf(s / p.cap);
          vis = visible(p, kv_len, r0 + r, col0 + c);
          if (!vis) s = NEG_INF;
          m_prev = m_s[r];
        }
        float m_new = s;
        for (int off = KT >> 1; off > 0; off >>= 1)
          m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
        m_new = fmaxf(m_new, m_prev);
        const float w = vis ? attn_exp(s - m_new, tab, p.exp_mode) : 0.0f;
        float sum = w;
        for (int off = KT >> 1; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        __syncwarp();  // every lane has read m_s[r] before it is updated
        if (active) {
          ss[c * RT4 + r] = w;
          if (c == 0) {
            const float alpha = attn_exp(m_prev - m_new, tab, p.exp_mode);
            l_s[r] = l_s[r] * alpha + sum;
            m_s[r] = m_new;
            a_s[r] = alpha;
          }
        }
      }
    } else {
      // Any other key tile: one (row, key) dot product per thread, then
      // one row per thread.
      for (int i = tid; i < nr * KT; i += THREADS) {
        const int r = i / KT, c = i - r * KT;
        float s = qk_dot(qs + r * QD, ks + c * KS, D, QUANT ? k_sc[c] : 1.0f) * p.scale;
        if (p.cap > 0.0f) s = p.cap * tanhf(s / p.cap);
        ss[c * RT4 + r] = visible(p, kv_len, r0 + r, col0 + c) ? s : NEG_INF;
      }
      __syncthreads();
      for (int r = tid; r < nr; r += THREADS) {
        float* sr = ss + r;                    // key c at sr[c · RT4]
        const float m_prev = m_s[r];
        float m_new = m_prev;
        for (int c = 0; c < KT; ++c) m_new = fmaxf(m_new, sr[c * RT4]);
        float sum = 0.0f;
        for (int c = 0; c < KT; ++c) {
          const float w = visible(p, kv_len, r0 + r, col0 + c)
                              ? attn_exp(sr[c * RT4] - m_new, tab, p.exp_mode)
                              : 0.0f;
          sr[c * RT4] = w;
          sum += w;
        }
        const float alpha = attn_exp(m_prev - m_new, tab, p.exp_mode);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc·alpha + P·V: one feature column per thread, every row of
    // the tile accumulated in registers (one V element, widened once,
    // feeds nr products; a key's weights arrive four rows to a read; rows
    // past nr hold whatever the stage left and are never stored)
    for (int e = tid; e < D; e += THREADS) {
      float pv[RTM];
#pragma unroll
      for (int r = 0; r < RTM; ++r) pv[r] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < KT; ++c) {
        float v = widen(vs[c * DV + e]);
        if (QUANT) v = __fmul_rn(v, v_sc[c]);
        const float4* w4 = reinterpret_cast<const float4*>(ss + c * RT4);
#pragma unroll
        for (int r = 0; r < RTM; r += 4) {
          if (r < nr) {
            const float4 w = w4[r / 4];
            pv[r] += w.x * v;
            pv[r + 1] += w.y * v;
            pv[r + 2] += w.z * v;
            pv[r + 3] += w.w * v;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RTM; ++r)
        if (r < nr) acc[r * D + e] = acc[r * D + e] * a_s[r] + pv[r];
    }
  }
  __syncthreads();
  // This split's partials: (m, l) per row and the unnormalised acc.
  const long long part = (((long long)b * p.hkv + h) * p.splits + split) * p.rows + r0;
  for (int i = tid; i < nr * D; i += THREADS) p.part_acc[part * D + i] = acc[i];
  for (int r = tid; r < nr; r += THREADS) {
    p.part_m[part + r] = m_s[r];
    p.part_l[part + r] = l_s[r];
  }
}

template <typename QT, typename KVT, int RTM>
int launch_rt(const Params& p, int batch, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<QT, KVT, RTM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(batch, p.hkv, (p.rows + p.row_tile - 1) / p.row_tile * p.splits);
  paged_attention_kernel<QT, KVT, RTM><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int launch(Params p, int batch, cudaStream_t stream) {
  p.vec_ok = (p.d % Vec16<KVT>::N == 0) && ((uintptr_t)p.k_pool % 16 == 0) &&
             ((uintptr_t)p.v_pool % 16 == 0);
  p.kt_pow2 = p.key_tile <= 32 && (p.key_tile & (p.key_tile - 1)) == 0;
  const int smem = smem_layout<KVT>(p.row_tile, p.key_tile, p.d).bytes;
  if (p.row_tile <= 8) return launch_rt<QT, KVT, 8>(p, batch, smem, stream);
  return launch_rt<QT, KVT, MAX_ROW_TILE>(p, batch, smem, stream);
}

template <typename QT>
int launch_kv(const Params& p, int batch, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 0) return launch<QT, float>(p, batch, s);
  if (kv_dtype == 1) return launch<QT, __nv_bfloat16>(p, batch, s);
  if (kv_dtype == 2) return launch<QT, int8_t>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- combine --

struct CombineParams {
  const float* part_m;
  const float* part_l;
  const float* part_acc;
  const int* kv_len;
  const float* table;
  void* out;             // (B, Hkv, R, D)
  long long n_rows;      // B · Hkv · R
  int hkv, rows, d, ps, kv_split, splits, exp_mode;
};

// One warp per (lane, kv head, row): the max of the live splits' m by
// shuffles, then each split's weight (computed by one lane, broadcast),
// and Σ w·l and Σ w·acc summed in split order; lane j owns columns j,
// j + 32, …  A lane's live splits are the first ⌈⌈kv_len / ps⌉ / kv_split⌉.
template <typename QT, int COLS>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    paged_combine_kernel(const CombineParams p) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (row >= p.n_rows) return;                 // warp-uniform
  const long long bh = row / p.rows;
  const int r = (int)(row - bh * p.rows);
  const int kv_len = p.kv_len[bh / p.hkv];
  const int live_pages = (max(kv_len, 0) + p.ps - 1) / p.ps;
  const int n = min(p.splits, (live_pages + p.kv_split - 1) / p.kv_split);
  const long long first = bh * p.splits * p.rows + r;   // split s at + s·rows

  float mx = NEG_INF;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, p.part_m[first + (long long)s * p.rows]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

  float den = 0.0f, num[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) num[c] = 0.0f;
  for (int s0 = 0; s0 < n; s0 += 32) {
    float w = 0.0f, l = 0.0f;
    if (s0 + lane < n) {
      const long long i = first + (long long)(s0 + lane) * p.rows;
      const float x = p.part_m[i] - mx;
      w = p.exp_mode == 2 ? expf(x)
                          : repro::lut_exp_nonpos(x, p.table, p.exp_mode == 0 ? 1 : 0);
      l = p.part_l[i];
    }
    const int cnt = min(32, n - s0);
    // SPLIT_BATCH splits' accumulator rows are loaded before any is summed,
    // so their reads are in flight together; the sums stay in split order.
    for (int j0 = 0; j0 < cnt; j0 += SPLIT_BATCH) {
      float av[SPLIT_BATCH][COLS];
#pragma unroll
      for (int j = 0; j < SPLIT_BATCH; ++j) {
        const float* a = p.part_acc + (first + (long long)(s0 + j0 + j) * p.rows) * p.d;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int e = lane + 32 * c;
          av[j][c] = (j0 + j < cnt && e < p.d) ? a[e] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < SPLIT_BATCH; ++j) {
        if (j0 + j < cnt) {                    // warp-uniform
          const float wj = __shfl_sync(0xffffffffu, w, j0 + j);
          den += wj * __shfl_sync(0xffffffffu, l, j0 + j);
#pragma unroll
          for (int c = 0; c < COLS; ++c) num[c] += wj * av[j][c];
        }
      }
    }
  }
  QT* out = (QT*)p.out;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int e = lane + 32 * c;
    if (e < p.d) store_f32(out, row * p.d + e, num[c] / fmaxf(den, 1e-30f));
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns a cudaError_t code.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale,
                           const void* page_table, const void* kv_len,
                           const void* table, void* part_m, void* part_l,
                           void* part_acc, int batch, int hkv, int rows, int d,
                           int ps, int slots, int q_len, int row_tile, int key_tile,
                           int kv_split, float scale, float cap, int window,
                           int exp_mode, int q_dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || rows <= 0) return 0;
  if (row_tile > MAX_ROW_TILE || d > MAX_HEAD_DIM || kv_split < 1 || slots < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = (const float*)k_scale;
  p.v_scale = (const float*)v_scale;
  p.page_table = (const int*)page_table;
  p.kv_len = (const int*)kv_len;
  p.table = (const float*)table;
  p.part_m = (float*)part_m;
  p.part_l = (float*)part_l;
  p.part_acc = (float*)part_acc;
  p.hkv = hkv;
  p.rows = rows;
  p.d = d;
  p.ps = ps;
  p.slots = slots;
  p.q_len = q_len;
  p.row_tile = row_tile;
  p.key_tile = key_tile;
  p.kv_split = kv_split;
  p.splits = (slots + kv_split - 1) / kv_split;
  p.scale = scale;
  p.cap = cap;
  p.window = window;
  p.exp_mode = exp_mode;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0) return launch_kv<float>(p, batch, kv_dtype, s);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(p, batch, kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}

// Merges the split pass's partials (B, Hkv, splits, R[, D]) into out
// (B, Hkv, R, D) in out_dtype (0 = float32, 1 = bfloat16).
int paged_combine_launch(const void* part_m, const void* part_l, const void* part_acc,
                         const void* kv_len, const void* table, void* out, int batch,
                         int hkv, int rows, int d, int ps, int kv_split, int splits,
                         int exp_mode, int out_dtype, void* stream) {
  if (batch <= 0 || rows <= 0) return 0;
  if (d > MAX_HEAD_DIM || kv_split < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  CombineParams p;
  p.part_m = (const float*)part_m;
  p.part_l = (const float*)part_l;
  p.part_acc = (const float*)part_acc;
  p.kv_len = (const int*)kv_len;
  p.table = (const float*)table;
  p.out = out;
  p.n_rows = (long long)batch * hkv * rows;
  p.hkv = hkv;
  p.rows = rows;
  p.d = d;
  p.ps = ps;
  p.kv_split = kv_split;
  p.splits = splits;
  p.exp_mode = exp_mode;
  const unsigned blocks = (unsigned)((p.n_rows + COMBINE_WARPS - 1) / COMBINE_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  const bool wide = d > 128;                    // 8 columns a lane, else 4
  if (out_dtype == 0 && wide)
    paged_combine_kernel<float, 8><<<blocks, COMBINE_WARPS * 32, 0, s>>>(p);
  else if (out_dtype == 0)
    paged_combine_kernel<float, 4><<<blocks, COMBINE_WARPS * 32, 0, s>>>(p);
  else if (wide)
    paged_combine_kernel<__nv_bfloat16, 8><<<blocks, COMBINE_WARPS * 32, 0, s>>>(p);
  else
    paged_combine_kernel<__nv_bfloat16, 4><<<blocks, COMBINE_WARPS * 32, 0, s>>>(p);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
