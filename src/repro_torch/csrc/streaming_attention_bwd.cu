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
// Three passes, launched in order on the caller's stream, none with an
// atomic: every output element is written once, by one thread, after a
// sum in a fixed order, so two runs give the same bits.
//
//   delta_kernel  one warp per row: δ.
//   dkdv          one block per (batch·kv head, 64-key tile).  The block
//                 loops over the G query heads of its group and over the q
//                 tiles that can see its keys (causal and window bounds),
//                 recomputing S and P, then dV += Pᵀ·dO, dP, dS, dK += dSᵀ·Q
//                 (bf16 at D 256: two launches, a dV and a dK block a tile).
//   dq            one block per (batch·q head, 64-row q tile).  The block
//                 loops over the key tiles the q tile can see, recomputing
//                 S, P and dP, and dQ += dS·K.
//
// The translation from the TPU: the reference's backward is one scan over
// the KV blocks carrying dq, which the grid of a card cannot carry across
// blocks without atomics; splitting it into a key-major pass (dK, dV) and a
// query-major pass (dQ) recomputes S and dP once more (7 products of a
// tile pair instead of 5) but keeps every sum inside one block.
//
// Two kernels per pass behind one entry point, chosen by dtype, as in the
// forward:
//
// bf16 → tensor_core::dkdv_kernel and dq_kernel, every product on mma.sync
// m16n8k16 with bf16 operands and f32 accumulators; 4 warps, each owning 16
// of the block's rows.  In the dK/dV pass the keys are the mma rows: Sᵀ =
// K·Qᵀ and dPᵀ = V·dOᵀ (K and V as A fragments, Q and dO as B fragments by
// ldmatrix, as the forward reads K), so Pᵀ and dSᵀ come out in the C
// layout of two adjacent n8 tiles, which is the A layout of dV += Pᵀ·dO and
// dK += dSᵀ·Q (dO and Q by ldmatrix.trans, as the forward reads V): nothing
// of the key × query tile goes through shared memory.  The row lse and δ
// are per column there, staged per q tile.  In the dQ pass the queries are
// the rows: S = Q·Kᵀ and dP = dO·Vᵀ, and dS is the A fragment of
// dQ += dS·K (K by ldmatrix.trans).  bf16 × bf16 products are exact in f32,
// so S and dP differ from the plain version only in summation order.  P
// and dS are f32; rounding them once to bf16 would be another computation,
// so each is split as the forward splits P: x_hi (its upper 16 bits) and
// x_lo = bf16(x − x_hi), two mma per fragment, x_hi + x_lo within
// 2^-16·|x| of x.  The outputs round once to bf16, far inside the checks'
// one bf16 ulp of the largest gradient.  The streamed tiles (Q, dO, lse and
// δ in the dK/dV pass; K and V in the dQ pass) arrive through a two-stage
// cp.async ring (16-byte chunks, swizzled as the forward's; ragged tails
// zero-filled by the copy's source size; rows that are not 16-byte aligned
// are staged through registers), so tile j + 1 lands while tile j
// computes.  The per-element mask runs only on tiles that cross kv_len, Lq,
// the causal diagonal or the window edge, and the softcap only with a cap,
// as tile-uniform branches around whole loops; the exponential is a
// compile-time choice inside a uniform branch on the call's mode.
// Registers: a warp's dK and dV accumulators for 16 keys take D / 2 + D / 2
// registers a thread (128 at D 128), so at D 128 the warp re-reads its K
// and V (dK/dV) or Q and dO (dQ) A fragments by ldmatrix at each k-step
// instead of holding them, and the dK/dV pass steps over 32 query rows (16
// logits a thread for Sᵀ and for dPᵀ) rather than 64.  There the dK/dV
// kernel still sits at 255 registers with a few bytes spilled; a 16-row
// step spills nothing but re-reads K and V once per 16 rows, and ran
// slower at both D 128 training shapes.  D ∈ {16, 32, 64, 128, 256} are
// instantiations; D 8 runs as D 16 with the head dim zero-filled.
// D 256 (gemma2, gemma3): a warp's dK and dV for 16 keys would be 256
// accumulator registers a thread, so each output gets blocks of its own,
// two launches over the same grid (Part): a dV block computes Sᵀ → Pᵀ
// and dV += Pᵀ·dO, holding no V and staging no δ (97 KB of shared memory,
// two blocks an SM); a dK block computes Sᵀ and dPᵀ → dSᵀ and dK += dSᵀ·Q
// (129 KB, one block an SM).  Sᵀ is computed twice, ~10% more products
// over the three passes; both blocks compute it from the same exact
// products in the same k-step order, so P is the same in each.  The dK/dV
// pass steps 32 query rows, the dQ pass 16 keys (97 KB, two blocks an
// SM); K and V (dK/dV) or Q and dO (dQ) are re-read by ldmatrix per
// k-step.  Measured on the card (tools/streaming_attention_bwd_variants.py
// at gemma2's and gemma3's training shapes, device alone): 16-key dQ steps
// ran 6–14% faster than 32-key steps (the forward's) at all three shapes,
// and are kept; 16-row dK/dV steps ran faster at gemma2's 512 tokens and
// gemma3's global layers but slower at its local ones (window 1,024), and
// are not.  Splitting dK's and dV's head dim across two warps that share
// Sᵀ and dPᵀ through shared memory (the other way to 128 accumulators)
// was not tried.  ptxas: 250–255 registers, no spill, at D 256.
// The two passes compute Sᵀ and S in two orientations: each k-step of an
// mma adds the same 16 exact products to the same accumulator, in the same
// k-step order, so the two agree unless the tensor core's multi-term adder
// depends on which operand is A (not measured apart; at lut0 an ulp of s on
// a table boundary would move p by one table step, 0.54%, between the
// passes, inside the checks' 2^-7 of the largest gradient either way).
//
// f32 → cuda_core::dkdv_kernel and dq_kernel, the precision path of the
// checks (no bf16 split reaches the f32 check's 3e-5, as in the forward):
// every product on the CUDA cores in f32, 256 threads holding 4 × 4
// register tiles of the 64 × 64 logits as the forward's f32 kernel does
// (2 × 2 of 32 × 32 at D 256: four resident 64-row tiles of 257 floats
// would pass the 227 KB of shared memory a block gets), P and dS through
// shared memory.
//
// Bound: at the training shapes (BERT-large 8 × 16 × 512 × 64, deepseek-7b
// 8 × 32 × 512 × 128 causal, gemma3-12b 2 × 16:8 × 2,048 × 256) the work
// is operations at the bf16 tensor-core peak (10·D per visible pair), at
// gemma2-9b's 8 × 16:8 × 512 × 256 bytes; the bf16 kernels issue about
// twice those operations (S and dP twice, three products split in two;
// S three times at D 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "lut_exp.cuh"
#include "mma_ptx.cuh"

namespace {

using repro::sees_any;
using repro::visible;

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
  int vec;               // bf16: every streamed row 16-byte aligned (cp.async)
  int pair;              // bf16: every output row 4-byte aligned (paired stores)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The rows [r_begin, r_end) that can see a key of the keys [c0, c0 + nk):
// past the causal diagonal of the first key, before the window's reach of
// the last visible key.
struct RowRange {
  int begin, end;
};
__device__ __forceinline__ RowRange row_range(const Params& p, int c0, int nk) {
  const int c_last = min(c0 + nk, p.kv_len) - 1;
  int r_begin = 0, r_end = c_last >= c0 ? p.lq : 0;
  if (p.causal) r_begin = max(0, c0 - p.q_offset);
  if (p.window > 0) r_end = min(r_end, max(0, c_last + p.window - p.q_offset));
  return {r_begin, r_end};
}

// ---------------------------------------------------------------- delta --

constexpr int DELTA_THREADS = 256;

template <typename T>
__global__ void delta_kernel(const Params p, long long rows) {
  const long long r = (long long)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
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

template <typename T>
int launch_delta(const Params& p, int batch, cudaStream_t stream) {
  const long long rows = (long long)batch * p.hq * p.lq;
  const long long blocks = (rows + DELTA_THREADS / 32 - 1) / (DELTA_THREADS / 32);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, DELTA_THREADS, 0, stream>>>(p, rows);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ f32 --

namespace cuda_core {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = THREADS / TX;   // thread grid over (rows, cols)

// A block's tiles: B query rows a q tile, B keys a kv tile — 64, or 32 at
// D 256, where the four resident 64-row tiles of D + 1 floats (K, V, Q,
// dO) would take 263 KB of shared memory, past the 227 KB a block gets.
template <int D>
struct Shape {
  static constexpr int B = D > 128 ? 32 : 64;
  static constexpr int RI = B / TY;                // rows (or keys) per thread
  static constexpr int CJ = B / TX;                // key columns per thread
  static constexpr int PS = B + 1;                 // row stride of the P / dS tile
  static constexpr int NJ = (D + TX - 1) / TX;     // output columns per thread
  static constexpr int SMEM_FLOATS = repro::LUT_K + 4 * B * (D + 1) + B * PS + 2 * B;
};

__device__ __forceinline__ float attn_exp(float x, const float* tab, int mode) {
  if (mode == 2) return expf(x);
  return repro::lut_exp_nonpos(x, tab, mode == 0 ? 1 : 0);
}

// Rows [0, n) of a (ROWS × D) tile into shared memory with row stride
// D + 1; rows n..ROWS-1 are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const float* base, long long sl, int n, float* dst,
                                          int tid) {
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, e = i % D;
    dst[r * (D + 1) + e] = r < n ? base[r * sl + e] : 0.0f;
  }
}

// s[i][c] += Σ_e a[row_i][e] · b[key_c][e]: rows ty + TY·i of a, keys
// tx + TX·c of b, both tiles with row stride D + 1.
template <int D, int RI, int CJ>
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

// The softmax weights and the logits' gradient of one B × B tile, in the
// thread's registers: from S (raw q·k sums) and dP, with the rows' lse and
// δ in shared memory.  p[i][c] = visible ? exp(s_c − lse) : 0 and
// ds[i][c] = p (dp − δ) (1 − (s_c/cap)²) scale.
template <int RI, int CJ>
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

template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Params p) {
  using SH = Shape<D>;
  constexpr int DS = D + 1, BQ = SH::B, BK = SH::B, RI = SH::RI, CJ = SH::CJ, PS = SH::PS,
                NJ = SH::NJ;
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
  load_tile<D, BK>((const float*)p.k + b * p.k_sb + hk * p.k_sh + (long long)c0 * p.k_sl,
                   p.k_sl, nk, ks, tid);
  load_tile<D, BK>((const float*)p.v + b * p.v_sb + hk * p.v_sh + (long long)c0 * p.v_sl,
                   p.v_sl, nk, vs, tid);

  float dk[RI][NJ], dv[RI][NJ];             // keys ty + TY·i, columns tx + TX·n
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) dk[i][n] = dv[i][n] = 0.0f;

  const RowRange rr = row_range(p, c0, nk);
  const int t_begin = rr.begin / BQ, t_end = rr.end > rr.begin ? (rr.end + BQ - 1) / BQ : 0;

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    for (int qt = t_begin; qt < t_end; ++qt) {
      const int q0 = qt * BQ;
      const int nq = min(BQ, p.lq - q0);
      __syncthreads();                      // the previous tile's readers are done
      load_tile<D, BQ>((const float*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl,
                       p.q_sl, nq, qs, tid);
      load_tile<D, BQ>(
          (const float*)p.dout + b * p.do_sb + h * p.do_sh + (long long)q0 * p.do_sl,
          p.do_sl, nq, gs, tid);
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

  float* dkb = (float*)p.dk + b * p.dk_sb + hk * p.dk_sh + (long long)c0 * p.dk_sl;
  float* dvb = (float*)p.dv + b * p.dv_sb + hk * p.dv_sh + (long long)c0 * p.dv_sl;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = ty + TY * i;
    if (key >= nk) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int e = tx + TX * n;
      if (e >= D) continue;
      dkb[key * p.dk_sl + e] = dk[i][n];
      dvb[key * p.dv_sl + e] = dv[i][n];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Params p) {
  using SH = Shape<D>;
  constexpr int DS = D + 1, BQ = SH::B, BK = SH::B, RI = SH::RI, CJ = SH::CJ, PS = SH::PS,
                NJ = SH::NJ;
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
  load_tile<D, BQ>((const float*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl,
                   p.q_sl, nq, qs, tid);
  load_tile<D, BQ>((const float*)p.dout + b * p.do_sb + h * p.do_sh + (long long)q0 * p.do_sl,
                   p.do_sl, nq, gs, tid);
  const long long row0 = (long long)bh * p.lq + q0;
  for (int i = tid; i < BQ; i += THREADS) {
    lse_s[i] = i < nq ? p.lse[row0 + i] : 0.0f;
    delta_s[i] = i < nq ? p.delta[row0 + i] : 0.0f;
  }

  const repro::TileRange tr = repro::tile_range<BK>(p, qpos0, nq);

  float dq[RI][NJ];                         // rows ty + TY·i, columns tx + TX·n
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) dq[i][n] = 0.0f;

  const float* kb = (const float*)p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = (const float*)p.v + b * p.v_sb + hk * p.v_sh;
  for (int j = tr.begin; j < tr.end; ++j) {
    const int c0 = j * BK;
    const int nk = min(BK, p.lkv - c0);
    __syncthreads();                        // the previous tile's readers are done
    load_tile<D, BK>(kb + (long long)c0 * p.k_sl, p.k_sl, nk, ks, tid);
    load_tile<D, BK>(vb + (long long)c0 * p.v_sl, p.v_sl, nk, vs, tid);
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

  float* dqb = (float*)p.dq + b * p.dq_sb + h * p.dq_sh + (long long)q0 * p.dq_sl;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + TY * i;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int e = tx + TX * n;
      if (e < D) dqb[row * p.dq_sl + e] = dq[i][n];
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int B = Shape<D>::B;
  const size_t smem = sizeof(float) * Shape<D>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_delta<float>(p, batch, stream);
  if (rc != 0) return rc;
  const int k_tiles = (p.lkv + B - 1) / B, q_tiles = (p.lq + B - 1) / B;
  if (k_tiles > 0) {
    dkdv_kernel<D><<<dim3(k_tiles, batch * p.hkv), THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dq_kernel<D><<<dim3(q_tiles, batch * p.hq), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

// ----------------------------------------------------------------- bf16 --

namespace tensor_core {

using bf16 = __nv_bfloat16;
using repro::swz;

constexpr int WARPS = 4;                    // 16 of the block's rows each
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;            // the block's keys (dK/dV) or queries (dQ)
constexpr int STAGES = 2;                   // depth of the streamed tiles' ring

// What a dK/dV block accumulates: dK and dV (D <= 128), or at D 256 one of
// them, in blocks of their own (two launches; the header says why).
enum Part { BOTH = 0, DV = 1, DK = 2 };

template <int D>
struct Tile {
  static constexpr int DP = D < 16 ? 16 : D;     // head dim in shared memory
  static constexpr int CH = DP / 8;              // 16-byte chunks per row
  static constexpr int KS = DP / 16;             // k16 steps over the head dim
  static constexpr int NO = DP / 8;              // n8 tiles over the head dim
  // D <= 64: the warp's own A fragments (K and V, or Q and dO) stay in
  // registers; D >= 128: its 128 accumulator registers leave no room, and
  // they are re-read by ldmatrix at each k-step.
  static constexpr bool OWN_REGS = D <= 64;
  // D 256: a warp's dK and dV for 16 keys would be 256 registers a thread.
  static constexpr bool SPLIT = D > 128;
  static constexpr int BQ = D <= 64 ? 64 : 32;   // query rows per step of the dK/dV pass
  static constexpr int KT = D <= 128 ? 64 : 16;  // key rows per step of the dQ pass
  static constexpr int TAB_BYTES = repro::LUT_K * 4;
  static constexpr int OWN_BYTES = ROWS * DP * 2;     // one of the block's own tiles
  static constexpr int Q_BYTES = BQ * DP * 2;         // one streamed Q or dO tile
  static constexpr int K_BYTES = KT * DP * 2;         // one streamed K or V tile
  // A dV block holds no V and stages no δ.
  template <int PART>
  static constexpr int dkdv_smem() {
    constexpr int n = PART == DV ? 1 : 2;
    return TAB_BYTES + n * OWN_BYTES + STAGES * (2 * Q_BYTES + n * BQ * 4);
  }
  static constexpr int DQ_SMEM = TAB_BYTES + 2 * OWN_BYTES + STAGES * 2 * K_BYTES;
};

template <int D, int NROWS>
__device__ __forceinline__ void load_tile(const bf16* base, long long sl, int n, uint8_t* dst,
                                          int vec, int tid) {
  repro::load_tile<D, NROWS, THREADS>(base, sl, n, dst, vec, tid);
}

template <int MODE>
__device__ __forceinline__ float attn_exp(float x, const float* tab) {
  if constexpr (MODE == 2) return expf(x);
  else return repro::lut_exp_nonpos(x, tab, MODE == 0 ? 1 : 0);
}

// The A fragment of rows r0 .. r0 + 15 at k-step kk of a row-major tile.
template <int CH>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const uint8_t* tile, int r0, int kk,
                                     int lane) {
  repro::ldmatrix_x4(a, tile + swz<CH>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}
// The B fragments of n8 tiles 2·n2 and 2·n2 + 1 at k-step kk, where the
// tile's rows are the n index (b[0], b[1]: tile 2·n2; b[2], b[3]: 2·n2 + 1).
template <int CH>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const uint8_t* tile, int n2, int kk,
                                     int lane) {
  repro::ldmatrix_x4(b, tile + swz<CH>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kk + ((lane >> 3) & 1)));
}
// The same where the tile's rows are the k index (ldmatrix.trans).
template <int CH>
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4], const uint8_t* tile, int n2, int kk,
                                      int lane) {
  repro::ldmatrix_x4_trans(b, tile + swz<CH>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                             2 * n2 + (lane >> 4)));
}

// P and dS of a tile of C fragments in place: s (raw q·k sums) → p, dp →
// ds, with lse and δ of element (n, e) given by li(n, e) and di(n, e),
// and vis(n, e) its visibility, asked only where the tile crosses an edge
// (!full).  p = exp(x − lse) with x = softcap(s·scale), ds = p (dp − δ)
// (1 − (x/cap)²) scale; masked elements are 0 (selected: whatever the
// exponential gave them).  The exponential is the template's; the cap and
// the mask are tile-uniform branches around whole loops.  Without DS
// (a dV block) only p, by the same operations: dp is left as it is.
template <int MODE, bool DS, int NT, class L, class Dl, class V>
__device__ __forceinline__ void tile_grads(const Params& p, const float* tab, bool full,
                                           float (&s)[NT][4], float (&dp)[NT][4], L li, Dl di,
                                           V vis) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], p.scale);  // never fused into s − lse
  if (p.cap > 0.0f) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fmul_rn(p.cap, tanhf(s[n][e] / p.cap));
        const float u = x / p.cap;
        s[n][e] = x;
        if constexpr (DS) dp[n][e] = (dp[n][e] - di(n, e)) * (1.0f - u * u);
      }
  } else if constexpr (DS) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = dp[n][e] - di(n, e);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = attn_exp<MODE>(s[n][e] - li(n, e), tab);
      s[n][e] = w;
      if constexpr (DS) dp[n][e] = __fmul_rn(w * dp[n][e], p.scale);
    }
  if (!full) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!vis(n, e)) {
          s[n][e] = 0.0f;
          if constexpr (DS) dp[n][e] = 0.0f;
        }
  }
}

// The exp mode as a uniform branch around the template's three copies.
template <bool DS, int NT, class L, class Dl, class V>
__device__ __forceinline__ void tile_grads_mode(const Params& p, const float* tab, bool full,
                                                float (&s)[NT][4], float (&dp)[NT][4], L li,
                                                Dl di, V vis) {
  if (p.exp_mode == 2) tile_grads<2, DS>(p, tab, full, s, dp, li, di, vis);
  else if (p.exp_mode == 1) tile_grads<1, DS>(p, tab, full, s, dp, li, di, vis);
  else tile_grads<0, DS>(p, tab, full, s, dp, li, di, vis);
}

// acc += X·B: X (16 rows × 16·KSTEPS) in C fragments, whose n8 tiles 2kk
// and 2kk + 1 are the A fragment of k-step kk, split hi + lo (two mma per
// fragment); B by ldmatrix.trans from a tile whose rows are the k index.
template <int KSTEPS, int NO, int CH>
__device__ __forceinline__ void split_product(float (&acc)[NO][4], const float (&x)[2 * KSTEPS][4],
                                              const uint8_t* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t ah[4], al[4];
    repro::split_bf16(x[2 * kk][0], x[2 * kk][1], ah[0], al[0]);
    repro::split_bf16(x[2 * kk][2], x[2 * kk][3], ah[1], al[1]);
    repro::split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], ah[2], al[2]);
    repro::split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int n2 = 0; n2 < NO / 2; ++n2) {
      uint32_t b[4];
      ld_bt<CH>(b, tile, n2, kk, lane);
      repro::mma_bf16(acc[2 * n2], ah, b[0], b[1]);
      repro::mma_bf16(acc[2 * n2], al, b[0], b[1]);
      repro::mma_bf16(acc[2 * n2 + 1], ah, b[2], b[3]);
      repro::mma_bf16(acc[2 * n2 + 1], al, b[2], b[3]);
    }
  }
}

// The 16 rows × D f32 accumulator of a warp to bf16 rows r0 + g, r0 + g + 8
// of out (row stride sl), rows below n, columns below D.
template <int D, int NO>
__device__ __forceinline__ void store_rows(bf16* out, long long sl, int r0, int n,
                                           const float (&acc)[NO][4], int pair, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= n) continue;
    bf16* orow = out + row * sl;
#pragma unroll
    for (int nn = 0; nn < NO; ++nn) {
      const int col = 8 * nn + 2 * t;
      if (col >= D) continue;
      const bf16 lo = __float2bfloat16_rn(acc[nn][2 * i]);
      const bf16 hi = __float2bfloat16_rn(acc[nn][2 * i + 1]);
      if (pair) {
        *reinterpret_cast<uint32_t*>(orow + col) = repro::pack_bf16(lo, hi);
      } else {
        orow[col] = lo;
        orow[col + 1] = hi;
      }
    }
  }
}

// ------------------------------------------------------------ dK/dV pass --

template <int D, int PART>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int CH = TL::CH, KS = TL::KS, NO = TL::NO, BQ = TL::BQ;
  constexpr int NT = BQ / 8;                // n8 tiles of queries per step
  constexpr bool WANT_DV = PART != DK, WANT_DK = PART != DV;
  constexpr int NV = WANT_DK ? 2 : 1;       // own tiles (K, V) and staged rows (lse, δ)
  static_assert(2 * BQ <= THREADS, "one thread per staged lse or δ");
  extern __shared__ __align__(128) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem);
  uint8_t* ks = smem + TL::TAB_BYTES;       // the block's keys
  uint8_t* vs = ks + TL::OWN_BYTES;         // ... and values (dK)
  uint8_t* qs = ks + NV * TL::OWN_BYTES;    // STAGES Q tiles
  uint8_t* gs = qs + STAGES * TL::Q_BYTES;  // STAGES dO tiles
  float* lse_s = reinterpret_cast<float*>(gs + STAGES * TL::Q_BYTES);   // STAGES × BQ
  float* delta_s = lse_s + STAGES * BQ;                                 // STAGES × BQ (dK)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.x;                // batch · kv head
  const int b = bk / p.hkv, hk = bk - b * p.hkv;
  const int c0 = blockIdx.y * ROWS;         // the first tiles see the most causal rows
  const int nk = min(ROWS, p.lkv - c0);
  const RowRange rr = row_range(p, c0, nk);
  const int t_begin = rr.begin / BQ;
  const int n_t = rr.end > rr.begin ? (rr.end + BQ - 1) / BQ - t_begin : 0;
  const int n_it = p.group * n_t;           // (head of the group, q tile) steps

  // Step it's Q, dO, lse and δ into stage st.
  auto issue = [&](int it, int st) {
    const int h = hk * p.group + it / n_t;
    const int q0 = (t_begin + it % n_t) * BQ;
    const int nq = min(BQ, p.lq - q0);
    load_tile<D, BQ>((const bf16*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl,
                     p.q_sl, nq, qs + st * TL::Q_BYTES, p.vec, tid);
    load_tile<D, BQ>((const bf16*)p.dout + b * p.do_sb + h * p.do_sh + (long long)q0 * p.do_sl,
                     p.do_sl, nq, gs + st * TL::Q_BYTES, p.vec, tid);
    if (tid < NV * BQ) {
      const int i = tid % BQ;
      const float* src = tid < BQ ? p.lse : p.delta;
      float* dst = (tid < BQ ? lse_s : delta_s) + st * BQ + i;
      if (i < nq) repro::cp_async4(dst, src + ((long long)b * p.hq + h) * p.lq + q0 + i);
      else *dst = 0.0f;
    }
  };

  const bf16* kb = (const bf16*)p.k + b * p.k_sb + hk * p.k_sh + (long long)c0 * p.k_sl;
  const bf16* vb = (const bf16*)p.v + b * p.v_sb + hk * p.v_sh + (long long)c0 * p.v_sl;
  load_tile<D, ROWS>(kb, p.k_sl, nk, ks, p.vec, tid);
  if constexpr (WANT_DK) load_tile<D, ROWS>(vb, p.v_sl, nk, vs, p.vec, tid);
  if (n_it > 0) issue(0, 0);
  repro::cp_async_commit();
  if (p.exp_mode != 2)
    for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];
  repro::cp_async_wait<0>();
  __syncthreads();

  const int wr0 = warp * 16;                // the warp's first key in the tile
  const int kw0 = c0 + wr0;
  uint32_t kf[TL::OWN_REGS ? KS : 1][4], vf[TL::OWN_REGS ? KS : 1][4];
  if constexpr (TL::OWN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ld_a<CH>(kf[kk], ks, wr0, kk, lane);
      if constexpr (WANT_DK) ld_a<CH>(vf[kk], vs, wr0, kk, lane);
    }
  }

  // keys wr0 + g (+ 8), columns 8n + 2t (+ 1)
  float dk[WANT_DK ? NO : 1][4], dv[WANT_DV ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (WANT_DK) dk[n][e] = 0.0f;
      if constexpr (WANT_DV) dv[n][e] = 0.0f;
    }

  for (int it = 0; it < n_it; ++it) {
    if (it > 0) {
      repro::cp_async_wait<0>();            // step it has landed
      __syncthreads();                      // ... for every thread; step it - 1's stage is free
    }
    if (it + 1 < n_it) {                    // step it + 1 loads while it computes
      issue(it + 1, (it + 1) % STAGES);
      repro::cp_async_commit();
    }
    const int st = it % STAGES;
    const uint8_t* qt = qs + st * TL::Q_BYTES;
    const uint8_t* gt = gs + st * TL::Q_BYTES;
    const float* lse_c = lse_s + st * BQ;
    const float* delta_c = delta_s + st * BQ;
    const int q0 = (t_begin + it % n_t) * BQ;
    const int nq = min(BQ, p.lq - q0);
    const int qpos0 = p.q_offset + q0;

    // A warp none of whose keys any row of the step sees skips it.
    if (!sees_any<16>(p, qpos0, qpos0 + nq - 1, kw0)) continue;
    // Every key of the warp visible to every row of the step.
    const bool full = nq == BQ && kw0 + 15 < p.kv_len && (!p.causal || kw0 + 15 <= qpos0) &&
                      (p.window <= 0 || qpos0 + BQ - 1 - kw0 < p.window);

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dK): s[n][e] at key wr0 + g + 8(e / 2),
    // query 8n + 2t + e % 2 of the step.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (!TL::OWN_REGS) {
        ld_a<CH>(ka, ks, wr0, kk, lane);
        if constexpr (WANT_DK) ld_a<CH>(va, vs, wr0, kk, lane);
      }
      const uint32_t* kx = TL::OWN_REGS ? kf[TL::OWN_REGS ? kk : 0] : ka;
      const uint32_t* vx = TL::OWN_REGS ? vf[TL::OWN_REGS ? kk : 0] : va;
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bq[4];
        ld_b<CH>(bq, qt, n2, kk, lane);
        repro::mma_bf16(s[2 * n2], kx, bq[0], bq[1]);
        repro::mma_bf16(s[2 * n2 + 1], kx, bq[2], bq[3]);
        if constexpr (WANT_DK) {
          uint32_t bg[4];
          ld_b<CH>(bg, gt, n2, kk, lane);
          repro::mma_bf16(dp[2 * n2], vx, bg[0], bg[1]);
          repro::mma_bf16(dp[2 * n2 + 1], vx, bg[2], bg[3]);
        }
      }
    }

    // Pᵀ and dSᵀ (Pᵀ alone in a dV block); lse and δ are per column (query).
    tile_grads_mode<WANT_DK>(
        p, tab, full, s, dp,
        [&](int n, int e) { return lse_c[8 * n + 2 * t + (e & 1)]; },
        [&](int n, int e) { return delta_c[8 * n + 2 * t + (e & 1)]; },
        [&](int n, int e) {
          const int j = 8 * n + 2 * t + (e & 1);
          return j < nq && visible(p, qpos0 + j, kw0 + g + 8 * (e >> 1));
        });

    // dV += Pᵀ·dO and dK += dSᵀ·Q: the C fragments of query tiles 2kk and
    // 2kk + 1 are the A fragment of query step kk.
    if constexpr (WANT_DV) split_product<BQ / 16, NO, CH>(dv, s, gt, lane);
    if constexpr (WANT_DK) split_product<BQ / 16, NO, CH>(dk, dp, qt, lane);
  }

  if constexpr (WANT_DK)
    store_rows<D, NO>((bf16*)p.dk + b * p.dk_sb + hk * p.dk_sh + (long long)c0 * p.dk_sl,
                      p.dk_sl, wr0, nk, dk, p.pair, lane);
  if constexpr (WANT_DV)
    store_rows<D, NO>((bf16*)p.dv + b * p.dv_sb + hk * p.dv_sh + (long long)c0 * p.dv_sl,
                      p.dv_sl, wr0, nk, dv, p.pair, lane);
}

// --------------------------------------------------------------- dQ pass --

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int CH = TL::CH, KS = TL::KS, NO = TL::NO, KT = TL::KT;
  constexpr int NT = KT / 8;                // n8 tiles of keys per step
  extern __shared__ __align__(128) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem);
  uint8_t* qs = smem + TL::TAB_BYTES;       // the block's queries
  uint8_t* gs = qs + TL::OWN_BYTES;         // ... and their dO
  uint8_t* ks = gs + TL::OWN_BYTES;         // STAGES K tiles
  uint8_t* vs = ks + STAGES * TL::K_BYTES;  // STAGES V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh - b * p.hq, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // the longest causal rows first
  const int nq = min(ROWS, p.lq - q0);
  const int qpos0 = p.q_offset + q0;
  const repro::TileRange tr = repro::tile_range<KT>(p, qpos0, nq);
  const bf16* kb = (const bf16*)p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = (const bf16*)p.v + b * p.v_sb + hk * p.v_sh;

  auto issue = [&](int j, int st) {
    const long long c0 = (long long)j * KT;
    const int nk = min(KT, p.lkv - j * KT);
    load_tile<D, KT>(kb + c0 * p.k_sl, p.k_sl, nk, ks + st * TL::K_BYTES, p.vec, tid);
    load_tile<D, KT>(vb + c0 * p.v_sl, p.v_sl, nk, vs + st * TL::K_BYTES, p.vec, tid);
  };

  load_tile<D, ROWS>((const bf16*)p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_sl,
                     p.q_sl, nq, qs, p.vec, tid);
  load_tile<D, ROWS>((const bf16*)p.dout + b * p.do_sb + h * p.do_sh + (long long)q0 * p.do_sl,
                     p.do_sl, nq, gs, p.vec, tid);
  if (tr.begin < tr.end) issue(tr.begin, 0);
  repro::cp_async_commit();
  if (p.exp_mode != 2)
    for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];

  // The rows' lse and δ (rows past Lq: 0, never stored).
  const int wr0 = warp * 16;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    const long long r = (long long)bh * p.lq + q0 + row;
    lse_r[i] = row < nq ? p.lse[r] : 0.0f;
    delta_r[i] = row < nq ? p.delta[r] : 0.0f;
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[TL::OWN_REGS ? KS : 1][4], of[TL::OWN_REGS ? KS : 1][4];
  if constexpr (TL::OWN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ld_a<CH>(qf[kk], qs, wr0, kk, lane);
      ld_a<CH>(of[kk], gs, wr0, kk, lane);
    }
  }

  const int wpos0 = qpos0 + wr0;            // position of the warp's first row
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  for (int j = tr.begin, it = 0; j < tr.end; ++j, ++it) {
    if (it > 0) {
      repro::cp_async_wait<0>();
      __syncthreads();
    }
    if (j + 1 < tr.end) {
      issue(j + 1, (it + 1) % STAGES);
      repro::cp_async_commit();
    }
    const uint8_t* kt = ks + (it % STAGES) * TL::K_BYTES;
    const uint8_t* vt = vs + (it % STAGES) * TL::K_BYTES;
    const int c0 = j * KT;

    if (wr0 >= nq || !sees_any<KT>(p, wpos0, wpos0 + 15, c0)) continue;
    const bool full = c0 + KT <= p.kv_len && (!p.causal || c0 + KT - 1 <= wpos0) &&
                      (p.window <= 0 || wpos0 + 15 - c0 < p.window);

    // S = Q·Kᵀ and dP = dO·Vᵀ: s[n][e] at row wr0 + g + 8(e / 2), key
    // c0 + 8n + 2t + e % 2.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      if constexpr (!TL::OWN_REGS) {
        ld_a<CH>(qa, qs, wr0, kk, lane);
        ld_a<CH>(oa, gs, wr0, kk, lane);
      }
      const uint32_t* qx = TL::OWN_REGS ? qf[TL::OWN_REGS ? kk : 0] : qa;
      const uint32_t* ox = TL::OWN_REGS ? of[TL::OWN_REGS ? kk : 0] : oa;
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4], bv[4];
        ld_b<CH>(bk, kt, n2, kk, lane);
        ld_b<CH>(bv, vt, n2, kk, lane);
        repro::mma_bf16(s[2 * n2], qx, bk[0], bk[1]);
        repro::mma_bf16(s[2 * n2 + 1], qx, bk[2], bk[3]);
        repro::mma_bf16(dp[2 * n2], ox, bv[0], bv[1]);
        repro::mma_bf16(dp[2 * n2 + 1], ox, bv[2], bv[3]);
      }
    }

    // P and dS; lse and δ are per row.
    tile_grads_mode<true>(
        p, tab, full, s, dp, [&](int, int e) { return lse_r[e >> 1]; },
        [&](int, int e) { return delta_r[e >> 1]; },
        [&](int n, int e) {
          return visible(p, wpos0 + g + 8 * (e >> 1), c0 + 8 * n + 2 * t + (e & 1));
        });

    // dQ += dS·K.
    split_product<KT / 16, NO, CH>(dq, dp, kt, lane);
  }

  store_rows<D, NO>((bf16*)p.dq + b * p.dq_sb + h * p.dq_sh + (long long)q0 * p.dq_sl,
                    p.dq_sl, wr0, nq, dq, p.pair, lane);
}

// One dK/dV launch of the given part over (batch · kv head, key tile).
template <int D, int PART>
cudaError_t launch_dkdv(const Params& p, int batch, int k_tiles, cudaStream_t stream) {
  constexpr int smem = Tile<D>::template dkdv_smem<PART>();
  const cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dkdv_kernel<D, PART><<<dim3(batch * p.hkv, k_tiles), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch(Params p, int batch, cudaStream_t stream) {
  using TL = Tile<D>;
  const long long in_strides[] = {p.q_sb, p.q_sh, p.q_sl, p.k_sb, p.k_sh, p.k_sl,
                                  p.v_sb, p.v_sh, p.v_sl, p.do_sb, p.do_sh, p.do_sl};
  bool vec = (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
             (uintptr_t)p.v % 16 == 0 && (uintptr_t)p.dout % 16 == 0;
  for (long long s : in_strides) vec = vec && s % 8 == 0;
  p.vec = vec;
  const long long out_strides[] = {p.dq_sb, p.dq_sh, p.dq_sl, p.dk_sb, p.dk_sh,
                                   p.dk_sl, p.dv_sb, p.dv_sh, p.dv_sl};
  bool pair = (uintptr_t)p.dq % 4 == 0 && (uintptr_t)p.dk % 4 == 0 &&
              (uintptr_t)p.dv % 4 == 0;
  for (long long s : out_strides) pair = pair && s % 2 == 0;
  p.pair = pair;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int k_tiles = (p.lkv + ROWS - 1) / ROWS, q_tiles = (p.lq + ROWS - 1) / ROWS;
  if (k_tiles > 65535 || q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const int rc = launch_delta<bf16>(p, batch, stream);
  if (rc != 0) return rc;
  if (k_tiles > 0) {
    if constexpr (TL::SPLIT) {
      err = launch_dkdv<D, DK>(p, batch, k_tiles, stream);
      if (err == cudaSuccess) err = launch_dkdv<D, DV>(p, batch, k_tiles, stream);
    } else {
      err = launch_dkdv<D, BOTH>(p, batch, k_tiles, stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  dq_kernel<D><<<dim3(batch * p.hq, q_tiles), THREADS, TL::DQ_SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tensor_core

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels); q, k, v, out, dout, dq, dk, dv alike.  lse and delta f32
// (B, Hq, Lq) contiguous.  Strides are in elements.  Head dims 8–256.
// Returns a cudaError_t code.
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
  p.vec = 0;
  p.pair = 0;
  if (exp_mode < 0 || exp_mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (d) {
      case 8: return cuda_core::launch<8>(p, batch, s);
      case 16: return cuda_core::launch<16>(p, batch, s);
      case 32: return cuda_core::launch<32>(p, batch, s);
      case 64: return cuda_core::launch<64>(p, batch, s);
      case 128: return cuda_core::launch<128>(p, batch, s);
      case 256: return cuda_core::launch<256>(p, batch, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 8: return tensor_core::launch<8>(p, batch, s);
      case 16: return tensor_core::launch<16>(p, batch, s);
      case 32: return tensor_core::launch<32>(p, batch, s);
      case 64: return tensor_core::launch<64>(p, batch, s);
      case 128: return tensor_core::launch<128>(p, batch, s);
      case 256: return tensor_core::launch<256>(p, batch, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
