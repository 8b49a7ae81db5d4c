// Paged attention over a page pool, read in place through the page table.
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
// lut_exp.cuh (or expf for exp_mode "exact"); the output is acc / max(l,
// 1e-30).
//
// Translation from the TPU: the TPU grid walks (lane, kv head, page slot)
// with the page slot as a sequential axis carrying (m, l, acc) in VMEM
// scratch, and the page table arrives by scalar prefetch.  Here one block
// owns one (lane, kv head, row tile) and loops over the lane's live page
// slots itself (j·ps < kv_len), reading its own page ids from the table row;
// blocks run in any order and nothing is carried between them.  The carry
// lives in shared memory.  Dead q-blocks (kv_len pinned to 1) walk one
// page, and their table rows name the pool's scratch page, so every read
// stays in bounds; their rows are fully masked and emit zeros.
//
// Bound: bytes for decode-like steps (each live KV row is read once per row
// tile and feeds only G·Lq rows), operations for long prefill chunks.  This
// first version is the simple, right kernel: K/V tiles of up to 32 rows are
// staged in shared memory as f32 with 16-byte loads, all in flight at once
// (int8 dequantised with the row scale on the way in); the (rows × keys)
// logits, the online softmax (warp shuffles across a row's keys) and P·V
// run on the CUDA cores in f32, one thread per logit or output element.  A
// lane's pages are walked by one block, so the longest lane sets the time
// of a decode step.  Tensor-core products (wgmma), TMA,
// double-buffered page loads and splitting long lanes are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lut_exp.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int MAX_ROW_TILE = 16;   // query rows per block (ops.py MAX_ROW_TILE)

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f32(const int8_t* p, long long i) { return (float)p[i]; }
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// 16-byte vector loads of the pools: 4 f32, 8 bf16 or 16 int8 values.
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
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, const int8_t*) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = (float)b[j];
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
  void* out;
  int hkv, rows, d, ps, slots, q_len, row_tile, key_tile;
  float scale, cap;      // cap <= 0: no soft-capping
  int window;            // <= 0: no window
  int exp_mode;          // 0 = lut (order 1), 1 = lut0, 2 = exact
  int vec_ok;            // pools 16-byte aligned and D a multiple of a vector
  int kt_pow2;           // key tile a power of two (<= 32): warp softmax
};

// Stage KT pool rows of page-head ``prow`` into shared memory as f32 (K with
// a padded row stride, V dense), dequantising int8 with the row scale.  The
// vector path issues all of a thread's 16-byte loads before any store, so a
// page costs about one round trip to device memory instead of one per
// element group.
constexpr int MAX_VEC_LOADS = 4;   // 16-byte loads in flight per thread and pool

template <typename KVT>
__device__ __forceinline__ void stage_tile(const Params& p, const KVT* kp, const KVT* vp,
                                           long long prow, float* ks, float* vs, int tid) {
  const int KT = p.key_tile, D = p.d;
  const bool quantized = p.k_scale != nullptr;
  if (!p.vec_ok) {
    for (int i = tid; i < KT * D; i += THREADS) {
      const int c = i / D, e = i - c * D;
      float kv = load_f32(kp, (prow + c) * D + e);
      float vv = load_f32(vp, (prow + c) * D + e);
      if (quantized) {
        kv *= p.k_scale[prow + c];
        vv *= p.v_scale[prow + c];
      }
      ks[c * (D + 1) + e] = kv;
      vs[c * D + e] = vv;
    }
    return;
  }
  constexpr int V = Vec16<KVT>::N;
  const int nvec = KT * D / V;
  const uint4* kv4 = reinterpret_cast<const uint4*>(kp + prow * D);
  const uint4* vv4 = reinterpret_cast<const uint4*>(vp + prow * D);
  for (int base = 0; base < nvec; base += MAX_VEC_LOADS * THREADS) {
    uint4 kraw[MAX_VEC_LOADS], vraw[MAX_VEC_LOADS];
#pragma unroll
    for (int r = 0; r < MAX_VEC_LOADS; ++r) {
      const int i = base + r * THREADS + tid;
      if (i < nvec) {
        kraw[r] = __ldg(kv4 + i);
        vraw[r] = __ldg(vv4 + i);
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_VEC_LOADS; ++r) {
      const int i = base + r * THREADS + tid;
      if (i < nvec) {
        const int c = (i * V) / D, e = i * V - c * D;
        float kf[V], vf[V];
        unpack16(kraw[r], kf, kp);
        unpack16(vraw[r], vf, vp);
        const float ksc = quantized ? p.k_scale[prow + c] : 1.0f;
        const float vsc = quantized ? p.v_scale[prow + c] : 1.0f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ks[c * (D + 1) + e + j] = quantized ? kf[j] * ksc : kf[j];
          vs[c * D + e + j] = quantized ? vf[j] * vsc : vf[j];
        }
      }
    }
  }
}

__device__ __forceinline__ float attn_exp(float x, const float* tab, int mode) {
  if (mode == 2) return expf(x);
  return repro::lut_exp(x, tab, mode == 0 ? 1 : 0);
}

// q·k over D with four independent partial sums (a shorter dependency chain
// than one running sum).
__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int e = 0;
  for (; e + 4 <= n; e += 4) {
    s0 += a[e] * b[e];
    s1 += a[e + 1] * b[e + 1];
    s2 += a[e + 2] * b[e + 2];
    s3 += a[e + 3] * b[e + 3];
  }
  for (; e < n; ++e) s0 += a[e] * b[e];
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ bool visible(const Params& p, int kv_len, int row, int col) {
  const int qpos = kv_len - p.q_len + row % p.q_len;
  return col <= qpos && (p.window <= 0 || qpos - col < p.window);
}

// RTM: compile-time bound on the row tile (8 or 16), the size of the P·V
// register accumulators.
template <typename QT, typename KVT, int RTM>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(const Params p) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int RT = p.row_tile, KT = p.key_tile, D = p.d;
  const int r0 = blockIdx.z * RT;
  const int nr = min(RT, p.rows - r0);
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* tab = smem;                    // LUT_K
  float* qs = tab + repro::LUT_K;       // RT × D
  float* ks = qs + RT * D;              // KT × (D + 1), padded against bank conflicts
  float* vs = ks + KT * (D + 1);        // KT × D
  float* ss = vs + KT * D;              // RT × KT logits, then weights
  float* acc = ss + RT * KT;            // RT × D
  float* m_s = acc + RT * D;            // RT running max
  float* l_s = m_s + RT;                // RT running denominator
  float* a_s = l_s + RT;                // RT rescale factor of this tile

  for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  const long long q_base = (((long long)b * p.hkv + h) * p.rows + r0) * D;
  const QT* q = (const QT*)p.q;
  for (int i = tid; i < nr * D; i += THREADS) {
    qs[i] = load_f32(q, q_base + i);
    acc[i] = 0.0f;
  }
  for (int r = tid; r < nr; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  const int kv_len = p.kv_len[b];
  const int live_slots = min(p.slots, (max(kv_len, 0) + p.ps - 1) / p.ps);
  const KVT* kp = (const KVT*)p.k_pool;
  const KVT* vp = (const KVT*)p.v_pool;

  for (int j = 0; j < live_slots; ++j) {
    const long long page = p.page_table[(long long)b * p.slots + j];
    for (int sub = 0; sub < p.ps; sub += KT) {
      const int col0 = j * p.ps + sub;
      if (col0 >= kv_len) break;
      __syncthreads();  // the previous tile's readers are done
      const long long prow = (page * p.hkv + h) * p.ps + sub;  // first pool row
      stage_tile(p, kp, vp, prow, ks, vs, tid);
      __syncthreads();
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
            s = dot(qs + r * D, ks + c * (D + 1), D) * p.scale;
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
            ss[i] = w;
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
          float s = dot(qs + r * D, ks + c * (D + 1), D) * p.scale;
          if (p.cap > 0.0f) s = p.cap * tanhf(s / p.cap);
          ss[i] = visible(p, kv_len, r0 + r, col0 + c) ? s : NEG_INF;
        }
        __syncthreads();
        for (int r = tid; r < nr; r += THREADS) {
          float* sr = ss + r * KT;
          const float m_prev = m_s[r];
          float m_new = m_prev;
          for (int c = 0; c < KT; ++c) m_new = fmaxf(m_new, sr[c]);
          float sum = 0.0f;
          for (int c = 0; c < KT; ++c) {
            const float w = visible(p, kv_len, r0 + r, col0 + c)
                                ? attn_exp(sr[c] - m_new, tab, p.exp_mode)
                                : 0.0f;
            sr[c] = w;
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
      // the tile accumulated in registers (one V load feeds nr products)
      for (int e = tid; e < D; e += THREADS) {
        float pv[RTM];
#pragma unroll
        for (int r = 0; r < RTM; ++r) pv[r] = 0.0f;
#pragma unroll 4
        for (int c = 0; c < KT; ++c) {
          const float v = vs[c * D + e];
#pragma unroll
          for (int r = 0; r < RTM; ++r)
            if (r < nr) pv[r] += ss[r * KT + c] * v;
        }
#pragma unroll
        for (int r = 0; r < RTM; ++r)
          if (r < nr) acc[r * D + e] = acc[r * D + e] * a_s[r] + pv[r];
      }
    }
  }
  __syncthreads();
  QT* out = (QT*)p.out;
  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = i / D;
    store_f32(out, q_base + i, acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

size_t smem_bytes(const Params& p) {
  const size_t rt = p.row_tile, kt = p.key_tile, d = p.d;
  return sizeof(float) *
         (repro::LUT_K + rt * d + kt * (d + 1) + kt * d + rt * kt + rt * d + 3 * rt);
}

template <typename QT, typename KVT, int RTM>
int launch_rt(const Params& p, int batch, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<QT, KVT, RTM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(batch, p.hkv, (p.rows + p.row_tile - 1) / p.row_tile);
  paged_attention_kernel<QT, KVT, RTM><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int launch(Params p, int batch, cudaStream_t stream) {
  p.vec_ok = (p.d % Vec16<KVT>::N == 0) && ((uintptr_t)p.k_pool % 16 == 0) &&
             ((uintptr_t)p.v_pool % 16 == 0);
  p.kt_pow2 = p.key_tile <= 32 && (p.key_tile & (p.key_tile - 1)) == 0;
  const size_t smem = smem_bytes(p);
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

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns a cudaError_t code.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale,
                           const void* page_table, const void* kv_len,
                           const void* table, void* out, int batch, int hkv,
                           int rows, int d, int ps, int slots, int q_len,
                           int row_tile, int key_tile, float scale, float cap,
                           int window, int exp_mode, int q_dtype, int kv_dtype,
                           void* stream) {
  if (batch <= 0 || rows <= 0) return 0;
  if (row_tile > MAX_ROW_TILE) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = (const float*)k_scale;
  p.v_scale = (const float*)v_scale;
  p.page_table = (const int*)page_table;
  p.kv_len = (const int*)kv_len;
  p.table = (const float*)table;
  p.out = out;
  p.hkv = hkv;
  p.rows = rows;
  p.d = d;
  p.ps = ps;
  p.slots = slots;
  p.q_len = q_len;
  p.row_tile = row_tile;
  p.key_tile = key_tile;
  p.scale = scale;
  p.cap = cap;
  p.window = window;
  p.exp_mode = exp_mode;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0) return launch_kv<float>(p, batch, kv_dtype, s);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(p, batch, kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
