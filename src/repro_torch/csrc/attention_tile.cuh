// What the bf16 tensor-core kernels of #3 share (streaming_attention.cu, the
// forward; streaming_attention_bwd.cu, its backward): the swizzled layout of
// a bf16 tile in shared memory, its cp.async load, and the mask rules over
// a params struct that holds kv_len, causal and window.
//
// A tile row is DP = max(D, 16) bf16 wide (D = 8 is zero-filled to 16, the
// k of one mma), CH = DP / 8 chunks of 16 bytes.  Chunk c of row r sits at
// swz<CH>(r, c): the 8 rows an ldmatrix phase reads at one logical chunk
// land in 8 distinct 16-byte bank quads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace repro {

// Byte offset of chunk c (8 bf16) of row r.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  int pc;
  if constexpr (CH >= 8) pc = c ^ (r & 7);
  else pc = c ^ ((r / (8 / CH)) & (CH - 1));
  return (r * CH + pc) * 16;
}

// Rows [0, n) of a ROWS-row tile of D-wide bf16 rows (row stride sl) into
// shared memory by THREADS threads; rows past n and chunks past D read as
// 0.  vec: cp.async (asynchronous, the caller commits; a ragged tail is
// zero-filled by the copy's source size); else staged through registers.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base, long long sl, int n,
                                          uint8_t* dst, int vec, int tid) {
  constexpr int CH = (D < 16 ? 16 : D) / 8, DC = D / 8;
  static_assert(ROWS * CH % THREADS == 0, "a tile's chunks split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < n && c < DC;
    uint8_t* d = dst + swz<CH>(r, c);
    const __nv_bfloat16* src = base + r * sl + c * 8;
    if (vec) {
      cp_async16(d, ok ? src : base, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (ok) {
        const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = (uint32_t)s[2 * e] | ((uint32_t)s[2 * e + 1] << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Key col is visible to the row at position qpos: col < kv_len, and
// (causal) col <= qpos, and (window) qpos − col < window.
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int col) {
  bool ok = col < p.kv_len;
  if (p.causal) ok = ok && col <= qpos;
  if (p.window > 0) ok = ok && qpos - col < p.window;
  return ok;
}

// Does any row at positions r0 .. r1 see any key of the KT keys from c0?
// The last key below kv_len is the one the window reaches first.
template <int KT, class P>
__device__ __forceinline__ bool sees_any(const P& p, int r0, int r1, int c0) {
  const int cmax = min(c0 + KT - 1, p.kv_len - 1);
  return c0 <= cmax && (!p.causal || c0 <= r1) && (p.window <= 0 || r0 - cmax < p.window);
}

// The KT-key tiles that rows at positions qpos0 .. qpos0 + nq − 1 can see:
// the window's first key up to the causal bound of the last row and kv_len.
struct TileRange {
  int begin, end;
};
template <int KT, class P>
__device__ __forceinline__ TileRange tile_range(const P& p, int qpos0, int nq) {
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, qpos0 + nq);
  const int kv_begin = p.window > 0 ? max(0, qpos0 - p.window + 1) : 0;
  return {kv_begin / KT, kv_end > 0 ? (kv_end + KT - 1) / KT : 0};
}

}  // namespace repro
