// Contiguous streaming (flash-style) attention forward with the LUT softmax.
//
// Replaces the TPU kernel src/repro/kernels/streaming_attention/kernel.py
// (attention_3d → attention_kernel).  Same contract:
//
//   q    (B, Hq, Lq, D)    f32 or bf16, any row/head/batch strides, D contiguous
//   k, v (B, Hkv, Lkv, D)  q's dtype; query head h reads kv head h / (Hq/Hkv)
//   out  (B, Hq, Lq, D)    q's dtype, any strides
//   lse  (B, Hq, Lq)       f32, contiguous; optional (null: not written)
//
// Row i sits at position q_offset + i.  Key c is visible to it when
// c < kv_len, and (causal) c <= q_offset + i, and (window) q_offset + i - c
// < window.  Logits s = (q·k)·scale, optionally soft-capped (cap·tanh(s/cap)),
// fold into an f32 online softmax (m, l, acc): m starts at -1e30, p =
// visible ? exp(s − m_new) : 0 and alpha = exp(m_prev − m_new), both through
// the same exponential (the LUT of lut_exp.cuh at order 1 or 0, or expf for
// exp_mode "exact"); the output is acc / max(l, 1e-30), so a row that sees
// no key emits 0.  Where the caller passes lse (the training forward: the
// backward kernel, streaming_attention_bwd.cu, reads it), each row's
// m + log(max(l, 1e-30)) is written at the same emit step, from the m and
// l the block already holds; serving passes none, and its output is the
// same bits either way.
//
// Translation from the TPU: the TPU grid is (B·Hq, q block, kv block) with
// the kv block a sequential axis carrying (m, l, acc) in VMEM scratch.  Here
// one block owns one (batch·head, 64-row q tile) and loops over 64-key
// tiles itself, from the first tile its window can see to the last one its
// causal bound and kv_len allow: fully masked tiles are never loaded.
// Blocks run in any order; nothing is carried between them.  Ragged tails
// (Lq, Lkv not multiples of 64) are zero-filled in shared memory and masked.
//
// Two kernels behind one entry point, chosen by dtype:
//
// bf16 → tensor_core::attention_kernel, FlashAttention-2's shape on
// mma.sync.  4 warps, 16 query rows each.  Q is staged once through shared
// memory into m16n8k16 A fragments; K and V tiles arrive through a
// two-stage cp.async ring (16-byte chunks, XOR swizzled so every ldmatrix
// phase touches 8 distinct bank quads; a ragged tail is zero-filled by
// cp.async's src-size), so tile j + 1 loads while tile j computes.  Rows
// that are not 16-byte aligned are staged through registers instead.
// S = Q·Kᵀ: ldmatrix on K, f32 accumulators; bf16 × bf16 products are
// exact in f32, so this differs from the reference only in summation
// order.  The softmax stays in registers: a row's 64 logits sit in one
// quad of lanes (two shuffles for its max and sum).  The per-element mask
// and the softcap run only where they act (tiles that cross kv_len, the
// causal diagonal or the window edge; cap > 0), as tile-uniform branches
// around whole loops, and the exponential is a compile-time choice, so
// the 32 exponentials a thread takes per tile carry no branch.  The LUT is
// lut_exp_nonpos (lut_exp.cuh): the same function as lut_exp bit for bit on
// x <= 0, its floors done by magic-constant additions rather than
// conversion instructions.  P·V: the reference multiplies f32 p by f32 v,
// and rounding p once to bf16 would be a different computation; each p is
// split into p_hi (its upper 16 bits) and p_lo = bf16(p − p_hi), and
// p_hi·V + p_lo·V (two mma per fragment, V by ldmatrix.trans) is within
// 2^-16·p of p·V — far inside one bf16 ulp of the output.  The S
// accumulator layout of two adjacent n8 tiles is the m16k16 A layout, so p
// never leaves registers; alpha rescales the output accumulator in place.
// The row sum l adds the f32 p.  D ∈ {16, 32, 64, 128, 256} are
// compile-time instantiations; D = 8 runs as D = 16 with the head dim
// zero-filled in shared memory.  At D = 256 (gemma2, gemma3) a warp's 16
// rows would need 64 registers a thread for Q's fragments, 128 for the f32
// output accumulator and 32 for a 64-key logit tile, past the 255 a thread
// may hold: there the key tile is 32 rows (16 logits a thread) and Q stays
// in shared memory, its A fragment read by one ldmatrix per k-step beside
// the two on K.  Q (32 KB) and the two-stage K/V ring (4 × 16 KB) take 96
// KB of dynamic shared memory, past the 48 KB default (the launch raises
// the limit).
//
// f32 → cuda_core::attention_kernel, unchanged from the first version (D
// 256 is one more instantiation, 213 KB of shared memory): the
// products in f32 on the CUDA cores.  No bf16 split reaches the f32 check's
// atol 3e-5 and TF32 keeps about three digits, so f32 — the precision path
// of the checks; every main-path forward on the card is bf16 — stays here.
// 256 threads hold the 64 × 64 logits as 4 × 4 register tiles (rows ty +
// 16i, keys tx + 16j: each row in one half-warp), Q and K sit in shared
// memory as f32 with an odd row stride, P goes through shared memory once
// for P·V.
//
// Bound: at the main path's shapes (BERT-large 16 heads × 64 at l = 512 and
// 4096, deepseek-7b 32 × 128 causal at l = 1024) the work is operations,
// far above the card's bytes-per-operation balance, yet the bf16 kernel
// reaches about a tenth of the tensor-core peak.  No one pipe bounds it.
// tools/streaming_attention_variants.py times copies of this kernel with
// named lines replaced (PERF.md keeps the readings): the LUT exponential
// is about a third of the time (the identity in its place takes 23–34%
// less, expf 11–19% less), the split P·V's second product 12–19%, and
// at D = 64 with both gone about half remains: the mma.sync products, the
// row max and sums, the rescale and a block barrier per tile, with four
// warps per SM sub-partition to hide their latencies (how that half
// splits is not measured).  A per-bank copy of the table (16 KB, no bank
// conflict) and dropping the 128-register cap at D <= 64 change nothing
// measurable.  wgmma with a warp-specialised overlap of softmax and
// products (FA3's ping-pong) and TMA loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "lut_exp.cuh"
#include "mma_ptx.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;                      // query rows per block
constexpr int BK = 64;                      // key rows per kv tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* table;    // 128-entry LUT
  void* out;
  float* lse;            // (B, Hq, Lq) logsumexp, or null
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
  int vec;               // every row 16-byte aligned: vector / cp.async loads
  int o_pair;            // every output row 4-byte aligned: paired bf16 stores
};

using repro::sees_any;
using repro::tile_range;
using repro::TileRange;
using repro::visible;

// ------------------------------------------------------------------ f32 --

namespace cuda_core {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = THREADS / TX;   // thread grid over (rows, cols)
constexpr int RI = BQ / TY;                 // rows per thread
constexpr int CJ = BK / TX;                 // key columns per thread
constexpr int PS = BK + 16;                 // row stride of the P tile

// Rows [0, n) of a (ROWS × D) tile into shared memory with row stride DS;
// rows n..ROWS-1 are zero.  Neighbouring threads read neighbouring
// elements; the vector path moves 16 bytes per thread and load.
template <int D, int ROWS, int DS>
__device__ __forceinline__ void load_tile(const float* base, long long sl, int n,
                                          float* dst, int vec, int tid) {
  if (vec) {
    constexpr int V = 4;
    for (int i = tid; i < ROWS * D / V; i += THREADS) {
      const int r = (i * V) / D, e = (i * V) % D;
      float f[V];
      if (r < n) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(base + r * sl + e));
        const float* fr = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = fr[j];
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
      dst[r * DS + e] = r < n ? base[r * sl + e] : 0.0f;
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

template <int D>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Params p) {
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
  const float* qb = (const float*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl;
  const float* kb = (const float*)p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = (const float*)p.v + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  load_tile<D, BQ, DS>(qb, p.q_sl, nq, qs, p.vec, tid);

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
    load_tile<D, BK, DS>(kb + (long long)c0 * p.k_sl, p.k_sl, nk, ks, p.vec, tid);
    load_tile<D, BK, D>(vb + (long long)c0 * p.v_sl, p.v_sl, nk, vs, p.vec, tid);
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

  float* ob = (float*)p.out + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_sl;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + TY * i;
    if (row >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0)
      p.lse[(long long)bh * p.lq + q0 + row] = m[i] + logf(denom);
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int e = tx + TX * n;
      if (e < D) ob[row * p.o_sl + e] = acc[i][n] / denom;
    }
  }
}

template <int D>
int launch(Params p, int bhq, cudaStream_t stream) {
  const long long strides[] = {p.q_sb, p.q_sh, p.q_sl, p.k_sb, p.k_sh,
                               p.k_sl, p.v_sb, p.v_sh, p.v_sl};
  bool vec = D % 4 == 0 && (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
             (uintptr_t)p.v % 16 == 0;
  for (long long s : strides) vec = vec && s % 4 == 0;
  p.vec = vec;
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.lq + BQ - 1) / BQ, bhq);
  attention_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

// ----------------------------------------------------------------- bf16 --

namespace tensor_core {

constexpr int WARPS = BQ / 16;              // 16 query rows per warp
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;                   // K/V ring depth

template <int D>
struct Tile {
  static constexpr int DP = D < 16 ? 16 : D;     // head dim in shared memory
  static constexpr int CH = DP / 8;              // 16-byte chunks per row
  // D <= 128: 64-key tiles and the warp's Q fragments held in registers.
  // D = 256: the f32 output accumulator alone takes 128 registers a
  // thread, so the key tile halves to 32 (16 logits a thread) and Q stays
  // in shared memory, its A fragment read by ldmatrix at each k-step.
  static constexpr int KT = D <= 128 ? BK : 32;  // key rows per kv tile
  static constexpr bool Q_REGS = D <= 128;
  static constexpr int Q_BYTES = BQ * DP * 2;    // the 64-row Q tile
  static constexpr int BYTES = KT * DP * 2;      // one K or V tile
  static constexpr int TAB_BYTES = repro::LUT_K * 4;   // the 128-entry LUT
  static constexpr int SMEM = TAB_BYTES + Q_BYTES + 2 * STAGES * BYTES;
  // D <= 64: 128 registers a thread let 4 blocks share an SM (16 warps)
  static constexpr int MIN_BLOCKS = D <= 64 ? 4 : 1;
};

using repro::swz;

// Rows [0, n) of a ROWS-row tile into shared memory (attention_tile.cuh).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base, long long sl, int n,
                                          uint8_t* dst, int vec, int tid) {
  repro::load_tile<D, ROWS, THREADS>(base, sl, n, dst, vec, tid);
}

// The exponential of exp mode MODE, a compile-time constant: the 32 calls
// per tile carry no branch and interleave freely.
template <int MODE>
__device__ __forceinline__ float attn_exp(float x, const float* tab) {
  if constexpr (MODE == 2) return expf(x);
  else return repro::lut_exp_nonpos(x, tab, MODE == 0 ? 1 : 0);
}

// Sum or max of a row's 2·NT values in one thread as a tree.
template <bool MAX, int NT>
__device__ __forceinline__ float reduce_row(const float (&s)[NT][4], int half) {
  float v[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    v[n] = MAX ? fmaxf(s[n][2 * half], s[n][2 * half + 1])
               : s[n][2 * half] + s[n][2 * half + 1];
#pragma unroll
  for (int w = NT / 2; w > 0; w >>= 1)
#pragma unroll
    for (int n = 0; n < w; ++n) v[n] = MAX ? fmaxf(v[n], v[n + w]) : v[n] + v[n + w];
  return v[0];
}

template <int D, int MODE>
__global__ void __launch_bounds__(THREADS, Tile<D>::MIN_BLOCKS) attention_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int CH = TL::CH;
  constexpr int KT = TL::KT;                // key rows per kv tile
  constexpr int NT = KT / 8;                // n8 tiles of logits per tile
  constexpr int KS = TL::DP / 16;           // k16 steps of Q·Kᵀ
  constexpr int NO = TL::DP / 8;            // n8 tiles of the output
  extern __shared__ __align__(128) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem);
  uint8_t* qs = smem + TL::TAB_BYTES;
  uint8_t* ks = qs + TL::Q_BYTES;           // STAGES K tiles
  uint8_t* vs = ks + STAGES * TL::BYTES;    // STAGES V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh - b * p.hq, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest causal rows first
  const int nq = min(BQ, p.lq - q0);
  using bf16 = __nv_bfloat16;
  const bf16* qb = (const bf16*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl;
  const bf16* kb = (const bf16*)p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = (const bf16*)p.v + b * p.v_sb + hk * p.v_sh;

  const int qpos0 = p.q_offset + q0;
  const TileRange tr = tile_range<KT>(p, qpos0, nq);

  load_tile<D, BQ>(qb, p.q_sl, nq, qs, p.vec, tid);
  if (tr.begin < tr.end) {
    const long long c0 = (long long)tr.begin * KT;
    const int nk = min(KT, p.lkv - tr.begin * KT);
    load_tile<D, KT>(kb + c0 * p.k_sl, p.k_sl, nk, ks, p.vec, tid);
    load_tile<D, KT>(vb + c0 * p.v_sl, p.v_sl, nk, vs, p.vec, tid);
  }
  repro::cp_async_commit();
  if constexpr (MODE != 2)
    for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  repro::cp_async_wait<0>();
  __syncthreads();

  // The warp's 16 rows of Q as A fragments: in registers for the whole
  // loop (D <= 128), else read from shared memory at each k-step.
  const int wr0 = warp * 16;                // first row of the warp in the tile
  uint32_t qf[TL::Q_REGS ? KS : 1][4];
  if constexpr (TL::Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      repro::ldmatrix_x4(qf[kk], qs + swz<CH>(wr0 + (lane & 15), 2 * kk + (lane >> 4)));
  }

  const int wpos0 = qpos0 + wr0;            // position of the warp's first row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int j = tr.begin, it = 0; j < tr.end; ++j, ++it) {
    if (it > 0) {
      repro::cp_async_wait<0>();            // tile j has landed
      __syncthreads();                      // ... for every thread; tile j - 1 is free
    }
    if (j + 1 < tr.end) {                   // tile j + 1 loads while j computes
      const long long c1 = (long long)(j + 1) * KT;
      const int nk = min(KT, p.lkv - (j + 1) * KT);
      const int st = (it + 1) % STAGES;
      load_tile<D, KT>(kb + c1 * p.k_sl, p.k_sl, nk, ks + st * TL::BYTES, p.vec, tid);
      load_tile<D, KT>(vb + c1 * p.v_sl, p.v_sl, nk, vs + st * TL::BYTES, p.vec, tid);
      repro::cp_async_commit();
    }
    const uint8_t* kt = ks + (it % STAGES) * TL::BYTES;
    const uint8_t* vt = vs + (it % STAGES) * TL::BYTES;
    const int c0 = j * KT;

    // A warp none of whose rows sees a key of this tile (or whose rows lie
    // past Lq) skips it: m, l and the accumulator would not change.
    if (wr0 >= nq || !sees_any<KT>(p, wpos0, wpos0 + 15, c0)) continue;
    // Every key visible to every row of the warp: no per-element mask.
    const bool full = c0 + KT <= p.kv_len && (!p.causal || c0 + KT - 1 <= wpos0) &&
                      (p.window <= 0 || wpos0 + 15 - c0 < p.window);

    // S = Q·Kᵀ: NT n8 tiles of keys, s[n][e] at row g + 8(e / 2), key
    // c0 + 8n + 2t + e % 2.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* qa = qf[TL::Q_REGS ? kk : 0];
      if constexpr (!TL::Q_REGS)
        repro::ldmatrix_x4(qf[0], qs + swz<CH>(wr0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, kt + swz<CH>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kk + ((lane >> 3) & 1)));
        repro::mma_bf16(s[2 * n2], qa, kf[0], kf[1]);
        repro::mma_bf16(s[2 * n2 + 1], qa, kf[2], kf[3]);
      }
    }

    // Online softmax in registers; row g + 8i's logits sit in lanes
    // 4g..4g+3.  Softcap and mask are tile-uniform branches around whole
    // loops, and every exponential is computed (a masked logit's is
    // selected away), so the 4·NT of a tile run without branches.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], p.scale);  // never fused into s − m
    if (p.cap > 0.0f) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(p.cap, tanhf(s[n][e] / p.cap));
    }
    uint32_t vis = 0xffffffffu;             // bit 4n + e: s[n][e] is visible
    if (!full) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(p, wpos0 + g + 8 * (e >> 1), c0 + 8 * n + 2 * t + (e & 1))) {
            s[n][e] = NEG_INF;
            vis &= ~(1u << (4 * n + e));
          }
    }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = reduce_row<true, NT>(s, i);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[i] = fmaxf(m[i], mx);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = attn_exp<MODE>(s[n][e] - m_new[e >> 1], tab);
    if (!full) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = (vis >> (4 * n + e)) & 1u ? s[n][e] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float rs = reduce_row<false, NT>(s, i);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float alpha = attn_exp<MODE>(m[i] - m_new[i], tab);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new[i];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P·V with P = p_hi + p_lo: the C fragments of key tiles 2kk and
    // 2kk + 1 are the A fragment of key step kk.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t ah[4], al[4];
      repro::split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      repro::split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      repro::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      repro::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t vf[4];
        repro::ldmatrix_x4_trans(
            vf, vt + swz<CH>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                             2 * n2 + (lane >> 4)));
        repro::mma_bf16(o[2 * n2], ah, vf[0], vf[1]);
        repro::mma_bf16(o[2 * n2], al, vf[0], vf[1]);
        repro::mma_bf16(o[2 * n2 + 1], ah, vf[2], vf[3]);
        repro::mma_bf16(o[2 * n2 + 1], al, vf[2], vf[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30), rows g and g + 8 of the warp, columns 8n + 2t.
  bf16* ob = (bf16*)p.out + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_sl;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * p.lq + q0 + row] = m[i] + logf(denom);
    bf16* orow = ob + row * p.o_sl;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= D) continue;
      const bf16 lo = __float2bfloat16_rn(o[n][2 * i] / denom);
      const bf16 hi = __float2bfloat16_rn(o[n][2 * i + 1] / denom);
      if (p.o_pair) {
        *reinterpret_cast<uint32_t*>(orow + col) = repro::pack_bf16(lo, hi);
      } else {
        orow[col] = lo;
        orow[col + 1] = hi;
      }
    }
  }
}

template <int D, int MODE>
int launch(Params p, int bhq, cudaStream_t stream) {
  const long long in_strides[] = {p.q_sb, p.q_sh, p.q_sl, p.k_sb, p.k_sh,
                                  p.k_sl, p.v_sb, p.v_sh, p.v_sl};
  bool vec = (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
             (uintptr_t)p.v % 16 == 0;
  for (long long s : in_strides) vec = vec && s % 8 == 0;
  p.vec = vec;
  p.o_pair = (uintptr_t)p.out % 4 == 0 && p.o_sb % 2 == 0 && p.o_sh % 2 == 0 &&
             p.o_sl % 2 == 0;
  constexpr int smem = Tile<D>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (p.lq + BQ - 1) / BQ;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bhq, q_tiles);
  attention_kernel<D, MODE><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const Params& p, int bhq, cudaStream_t stream) {
  switch (p.exp_mode) {
    case 0: return launch<D, 0>(p, bhq, stream);
    case 1: return launch<D, 1>(p, bhq, stream);
    case 2: return launch<D, 2>(p, bhq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 kernel's exponential (lut_exp_nonpos, order 1 or 0) over a flat
// f32 array: the check that it is the plain LUT bit for bit.  Not on the
// main path.
__global__ void softmax_exp_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   const float* __restrict__ table, long long n,
                                   int order) {
  __shared__ float tab[repro::LUT_K];
  for (int i = threadIdx.x; i < repro::LUT_K; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = repro::lut_exp_nonpos(x[i], tab, order);
}

}  // namespace tensor_core

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); q, k, v and out alike.  lse: null, or the (B, Hq, Lq) f32
// logsumexp to write.  Strides are in elements.  Returns a cudaError_t code.
int streaming_attention_launch(const void* q, const void* k, const void* v,
                               const void* table, void* out, void* lse, int batch, int hq,
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
  p.lse = (float*)lse;
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
  p.o_pair = 0;
  const int bhq = batch * hq;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (d) {
      case 8: return cuda_core::launch<8>(p, bhq, s);
      case 16: return cuda_core::launch<16>(p, bhq, s);
      case 32: return cuda_core::launch<32>(p, bhq, s);
      case 64: return cuda_core::launch<64>(p, bhq, s);
      case 128: return cuda_core::launch<128>(p, bhq, s);
      case 256: return cuda_core::launch<256>(p, bhq, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 8: return tensor_core::launch_mode<8>(p, bhq, s);
      case 16: return tensor_core::launch_mode<16>(p, bhq, s);
      case 32: return tensor_core::launch_mode<32>(p, bhq, s);
      case 64: return tensor_core::launch_mode<64>(p, bhq, s);
      case 128: return tensor_core::launch_mode<128>(p, bhq, s);
      case 256: return tensor_core::launch_mode<256>(p, bhq, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// x, out: n float32; order 1 (lut) or 0 (lut0).  Returns a cudaError_t code.
int streaming_attention_exp_launch(const void* x, void* out, const void* table,
                                   long long n, int order, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  tensor_core::softmax_exp_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)table, n, order);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
