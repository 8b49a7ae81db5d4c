// int8 × int8 → int32 matrix product on the int8 tensor cores, both
// quantisation scales applied in the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py
// (int8_matmul_2d → int8_matmul_kernel).  Same contract:
//
//   x        (M, K) int8, row-major        the dynamically quantised input
//   w        (K, N) int8                   the per-channel quantised weight
//   x_scale  one f32 in device memory      per tensor
//   w_scale  (N,) f32                      per output channel
//   out      (M, N) f32                    float(acc) · (x_scale · w_scale[n])
//   acc_out  (M, N) int32 or null          the exact accumulator, for checks
//
// The conversion float(acc) rounds to nearest even once |acc| > 2^24, as
// the reference's astype(f32) does, and the two scales multiply first, as
// in the reference kernel (its core applies them the other way round,
// within two f32 ulps).  The sum is an exact int32 sum, so neither the
// tiling nor the order of the k-steps changes a bit.  No pad copies: what
// lies past M, N or K reads as zero, which is what the reference's zero
// padding (ops.py _pad2) means.
//
// Translation from the TPU: the TPU grid is (M/bm, N/bn, K/bk) with k a
// sequential axis carrying a 256×256 int32 accumulator in VMEM scratch.
// Here one block owns an output tile and loops over K itself, the
// accumulators in registers.  Two variants, chosen by the host from the
// shape (int8_matmul_launch's `variant`):
//
// wgmma (K % 16 == 0, x and w 16-byte aligned, w K-major: element (k, n)
// at n·K + k).  wgmma takes 8-bit operands only K-major in shared memory
// (the transpose flags exist for 16-bit types alone) and TMA cannot
// transpose bytes, so the weight is stored (N, K) (core/quant.py quantize).
// A block of three warpgroups works through 128 × BN output tiles (BN =
// 128 or 256; see Tile): one producer thread keeps a ring of 4 stages full
// with TMA loads (cp.async.bulk.tensor.2d, 128-byte swizzle, mbarrier
// completion), each stage 128 bytes of K (one swizzle atom) of the x tile
// (128 rows) and the w tile (BN rows); TMA zero-fills boxes past M, N and
// K.  Two consumer warpgroups each own 64 rows and issue
// wgmma.mma_async m64nBNk32 s8 from the stage's descriptors, keeping one
// k-step in flight while they release the previous stage.  setmaxnreg
// moves registers from the producer (40) to the consumers (232).  The
// epilogue stages each warpgroup's int32 accumulators through shared
// memory (rows padded by 4 words: conflict-free writes from the fragment
// layout), then every thread reads back 4 consecutive columns and leaves
// them as one 16-byte store of f32 (and of int32 when asked), a warp
// covering 512 contiguous bytes of a row.
//
// mma.sync (any other K, unaligned operands, or any w strides): PR 13's
// kernel.  One block of 8 warps owns a 128×128 tile and loops over K in
// 64-byte steps (each warp a 64×32 sub-tile: 4 × 4 mma tiles of 16×8).
// Products go through mma.sync.m16n8k32.s8.s8.s32.  Tiles reach shared
// memory through a three-stage cp.async ring (16-byte copies, zero-fill
// past the edges) when K and N are multiples of 16 and w is row-major,
// else through byte loads at w's strides.  A is read with ldmatrix; B
// must be "col" (k contiguous for each n) but a row-major w has n
// contiguous, and ldmatrix cannot transpose bytes: each thread loads four
// 32-bit words from four consecutive k rows at the same four columns and
// transposes the 4×4 bytes with __byte_perm.  Those four columns feed the
// warp's four n8 tiles, so the mma tile j's column c is physical column
// 4c + j; in the accumulator each thread then holds eight consecutive
// columns of a row, stored as two float4.  Both tiles are XOR swizzled in
// 16-byte chunks, so ldmatrix and the B words load without bank conflicts.
//
// Bound (H100 SXM: 1,979 TOPS int8 dense, 3.35 TB/s): at the BERT-large
// projections (M = 4096 tokens) the f32 output dominates the bytes and the
// 1024×1024 and 1024×4096 products are bound by bytes (22 and 75 MB); the
// 4096×1024 one is bound by operations (34 GOP).  Only wgmma reaches the
// full int8 rate.  What holds the wgmma variant from its bound at those
// shapes (PERF.md; tools/int8_matmul_variants.py times the loads alone,
// the products alone and the call without its stores): the loads and the
// products each take most of the main loop's time, and the epilogue's
// stores, which no main loop overlaps in a one-wave grid, a quarter of
// the call at K = 1024.
//
// The tensor maps are encoded on the host for every call through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint, so the
// library links against the runtime alone (no -lcuda).
#include <cuda.h>               // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma_s8.cuh"

namespace {

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* x_scale;
  const float* w_scale;
  float* out;
  int32_t* acc_out;
  int m, n, k;
  long long w_sk, w_sn;          // w's strides in elements: (k, n) at k·w_sk + n·w_sn
};

}  // namespace

// ------------------------------------------------------------ wgmma + TMA --

namespace wg {

constexpr int BM = 128, BK = 128;             // block rows; k bytes a stage
constexpr int THREADS = 384;                  // producer + 2 consumer warpgroups

// A 128 × BN output tile per turn of a block's tile loop.
//  BN = 128: persistent.  One block per SM walks tiles blockIdx.x,
//    blockIdx.x + gridDim.x, …; the staging rows have their own shared
//    memory, so the producer fills the next tile's stages while the
//    consumers store this one (the epilogue overlaps the next main loop).
//  BN = 256: one tile per block (the grid covers the tiles); the staging
//    rows reuse the ring (4 stages of 48 KB and 128 KB of staging do not
//    fit side by side).
template <int BN>
struct Tile {
  static constexpr bool PERSISTENT = BN == 128;
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int LD = BN + 4;           // staging row, in int32
  static constexpr int STAGING = 2 * 64 * LD * 4;
  static constexpr int STAGING_AT = PERSISTENT ? RING : 0;
  static constexpr int DATA = PERSISTENT ? RING + STAGING
                                         : (RING > STAGING ? RING : STAGING);
  static constexpr int SMEM = 1024 + DATA + 2 * STAGES * 8;   // + alignment slack
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(repro::smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   repro::smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(repro::smem_u32(bar))
               : "memory");
}
// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(repro::smem_u32(bar)), "r"(parity) : "memory");
}
// TMA: the box at (c0 = k byte, c1 = row) of the map into dst; completion
// (the box's bytes, zero-filled past the tensor) counts on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(repro::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(repro::smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const Params p) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::DATA);
  uint64_t* empty = full + STAGES;
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int ntn = (p.n + BN - 1) / BN;
  const int ntiles = ((p.m + BM - 1) / BM) * ntn;
  const int ktiles = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);                 // the producer's arrival + bytes
      mbar_init(empty + s, 2);                // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {                             // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + s, ph ^ 1);       // the first round passes at once
          mbar_expect_tx(full + s, T::STAGE_BYTES);
          uint8_t* st = smem + s * T::STAGE_BYTES;
          tma_load(st, &xmap, kt * BK, m0, full + s);
          tma_load(st + T::A_BYTES, &wmap, kt * BK, n0, full + s);
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wgi - 1;                      // this consumer's 64 rows
  int32_t* stg = reinterpret_cast<int32_t*>(smem + T::STAGING_AT) + c * 64 * T::LD;
  const float xs = __ldg(p.x_scale);
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
    int32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + s, ph);
      const uint32_t a0 = repro::smem_u32(smem + s * T::STAGE_BYTES + c * 64 * BK);
      const uint32_t b0 = repro::smem_u32(smem + s * T::STAGE_BYTES + T::A_BYTES);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        const uint64_t da = repro::wgmma_desc_sw128(a0 + kk);
        const uint64_t db = repro::wgmma_desc_sw128(b0 + kk);
        if constexpr (BN == 256) repro::wgmma_m64n256k32(acc, da, db, 1);
        else repro::wgmma_m64n128k32(acc, da, db, 1);
      }
      repro::wgmma_commit();
      repro::wgmma_wait<1>();                 // the previous k-step is done
      repro::wgmma_fence_operands<BN / 2>(acc);
      if (prev >= 0 && t == 0) mbar_arrive(empty + prev);
      prev = s;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    repro::wgmma_wait<0>();
    repro::wgmma_fence_operands<BN / 2>(acc);
    if (t == 0) mbar_arrive(empty + prev);    // the producer moves on

    // Epilogue.  Staging in the ring: both consumers are past their last
    // product before either overwrites it.  Own staging: this warpgroup
    // has read back its previous tile's rows before they are overwritten.
    if constexpr (T::PERSISTENT) named_sync(2 + c, 128);
    else named_sync(1, 256);
    {
      const int r = (t >> 5) * 16 + ((t & 31) >> 2), col = 2 * (t & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<int2*>(stg + r * T::LD + 8 * j + col) =
            make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(stg + (r + 8) * T::LD + 8 * j + col) =
            make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_sync(2 + c, 128);
    constexpr int TPR = BN / 4;               // threads a row
    constexpr int RPP = 128 / TPR;            // rows a pass
    const int cc = (t % TPR) * 4, col = n0 + cc;
    float sc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sc[q] = col + q < p.n ? __fmul_rn(xs, __ldg(p.w_scale + col + q)) : 0.0f;
    const bool vec = (p.n & 3) == 0 && col + 4 <= p.n;
    for (int r = t / TPR; r < 64; r += RPP) {
      const int row = m0 + c * 64 + r;
      if (row >= p.m) break;
      const int4 v = *reinterpret_cast<const int4*>(stg + r * T::LD + cc);
      const int32_t vv[4] = {v.x, v.y, v.z, v.w};
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = __fmul_rn(__int2float_rn(vv[q]), sc[q]);
      const size_t base = (size_t)row * p.n + col;
      if (vec) {
        *reinterpret_cast<float4*>(p.out + base) = make_float4(o[0], o[1], o[2], o[3]);
        if (p.acc_out) *reinterpret_cast<int4*>(p.acc_out + base) = v;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (col + q < p.n) {
            p.out[base + q] = o[q];
            if (p.acc_out) p.acc_out[base + q] = vv[q];
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A K-major int8 operand of `rows` rows of k bytes, `ld` bytes apart, cut
// into boxes of 128 bytes × box_rows with the 128-byte swizzle.
int make_map(CUtensorMap* map, const void* base, int k, int rows, long long ld,
             int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tile<BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  CUtensorMap xmap, wmap;
  int err = make_map(&xmap, p.x, p.k, p.m, p.k, BM);
  if (err == 0) err = make_map(&wmap, p.w, p.k, p.n, p.w_sn, BN);
  if (err != 0) return err;
  const long long tiles = (long long)((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  long long grid = tiles;
  if constexpr (T::PERSISTENT) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return (int)cudaErrorInvalidValue;
    }
    if (grid > sms) grid = sms;
  }
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  wgmma_kernel<BN><<<(unsigned)grid, THREADS, T::SMEM, stream>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ------------------------------------------------------ mma.sync + cp.async --

namespace mma {

constexpr int BM = 128, BN = 128, BK = 64;      // block tile; k bytes a step
constexpr int STAGES = 3;
constexpr int THREADS = 256;                     // 8 warps: 2 (m) × 4 (n)
constexpr int A_BYTES = BM * BK, B_BYTES = BK * BN;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;


// Byte offset of (row r, byte c) in a tile: 16-byte chunks XOR swizzled.
// A rows are 64 bytes (4 chunks): chunk ^ ((r >> 1) & 3) puts the 8 rows of
// an ldmatrix phase in 8 distinct bank quads.  B rows are 128 bytes (8
// chunks): chunk ^ (2 · ((r >> 2) & 3)) spreads the 4 k-groups that one
// word load of a warp touches over 4 distinct pairs of chunks.
__device__ __forceinline__ int a_off(int r, int c) {
  return r * BK + ((((c >> 4) ^ ((r >> 1) & 3))) << 4) + (c & 15);
}
__device__ __forceinline__ int b_off(int r, int c) {
  return r * BN + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15);
}

// Tile kt of x (rows m0.., k bytes kt·BK..) and of w (k rows kt·BK.., columns
// n0..) into one stage; everything past M, N or K reads as 0.
template <bool ALIGNED>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* st, int kt,
                                           int m0, int n0, int tid) {
  uint8_t* as = st;
  uint8_t* bs = st + A_BYTES;
  const int k0 = kt * BK;
  if constexpr (ALIGNED) {            // K, N % 16 == 0, w row-major
#pragma unroll
    for (int i = 0; i < A_BYTES / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 16), ch = c % (BK / 16);
      const bool ok = m0 + r < p.m && k0 + ch * 16 < p.k;
      const int8_t* src = ok ? p.x + (size_t)(m0 + r) * p.k + k0 + ch * 16 : p.x;
      repro::cp_async16(as + a_off(r, ch * 16), src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_BYTES / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const bool ok = k0 + r < p.k && n0 + ch * 16 < p.n;
      const int8_t* src = ok ? p.w + (size_t)(k0 + r) * p.n + n0 + ch * 16 : p.w;
      repro::cp_async16(bs + b_off(r, ch * 16), src, ok);
    }
  } else {
    for (int i = tid; i < A_BYTES; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const bool ok = m0 + r < p.m && k0 + c < p.k;
      as[a_off(r, c)] = ok ? (uint8_t)p.x[(size_t)(m0 + r) * p.k + k0 + c] : 0;
    }
    for (int i = tid; i < B_BYTES; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const bool ok = k0 + r < p.k && n0 + c < p.n;
      bs[b_off(r, c)] = ok ? (uint8_t)p.w[(k0 + r) * p.w_sk + (n0 + c) * p.w_sn] : 0;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(repro::smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w0..w3 hold rows k..k+3 at columns j = 0..3 (byte j of each); → r[j] holds
// column j at rows k..k+3 (byte i = row k + i).
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2,
                                             uint32_t w3, uint32_t* r) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2) mma_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;      // warp's 64×32 sub-tile
  const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (p.k + BK - 1) / BK;

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage<ALIGNED>(p, smem + s * STAGE_BYTES, s, m0, n0, tid);
    repro::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {   // refill the stage every warp finished with in the previous step
      const int nk = kt + STAGES - 1;
      if (nk < ktiles)
        load_stage<ALIGNED>(p, smem + (nk % STAGES) * STAGE_BYTES, nk, m0, n0, tid);
      repro::cp_async_commit();
    }
    const uint8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* bs = as + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // lanes 0-7: rows 0-7, bytes kk..+15; 8-15: rows 8-15; 16-31: +16 bytes
        const int r = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[i], as + a_off(r, kk + (lane >> 4) * 16));
      }
      uint32_t b[2][4];                 // [k half][n8 tile j]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kk + h * 16 + t * 4, c = wn * 32 + g * 4;
        transpose4x4(*reinterpret_cast<const uint32_t*>(bs + b_off(r, c)),
                     *reinterpret_cast<const uint32_t*>(bs + b_off(r + 1, c)),
                     *reinterpret_cast<const uint32_t*>(bs + b_off(r + 2, c)),
                     *reinterpret_cast<const uint32_t*>(bs + b_off(r + 3, c)), b[h]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[0][j], b[1][j]);
    }
  }
  repro::cp_async_wait<0>();

  // Epilogue.  Tile j's fragment column 2t (+1) is physical column
  // 8t + j (+4): the thread holds columns cb .. cb + 7 of rows g and g + 8.
  const int cb = n0 + wn * 32 + t * 8;
  const float xs = __ldg(p.x_scale);
  float sc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    sc[q] = cb + q < p.n ? __fmul_rn(xs, __ldg(p.w_scale + cb + q)) : 0.0f;
  const bool vec = (p.n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + i * 16 + g + hr * 8;
      if (row >= p.m) continue;
      int32_t v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[i][q][hr * 2];
        v[q + 4] = acc[i][q][hr * 2 + 1];
      }
      float o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) o[q] = __fmul_rn(__int2float_rn(v[q]), sc[q]);
      const size_t base = (size_t)row * p.n + cb;
      if (vec && cb + 8 <= p.n) {
        float4* dst = reinterpret_cast<float4*>(p.out + base);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        if (p.acc_out) {
          int4* da = reinterpret_cast<int4*>(p.acc_out + base);
          da[0] = make_int4(v[0], v[1], v[2], v[3]);
          da[1] = make_int4(v[4], v[5], v[6], v[7]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (cb + q < p.n) {
            p.out[base + q] = o[q];
            if (p.acc_out) p.acc_out[base + q] = v[q];
          }
        }
      }
    }
  }
}

template <bool ALIGNED>
int launch(const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      mma_kernel<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  mma_kernel<ALIGNED><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace mma

extern "C" {

// x (m, k) int8 row-major; w (k, n) int8 with element (k, n) at
// k·w_sk + n·w_sn; x_scale one f32; w_scale (n,) f32; out (m, n) f32;
// acc_out (m, n) int32 or null.  variant 0: wgmma (needs k % 16 == 0, x
// and w 16-byte aligned and w K-major: w_sk == 1, w_sn == k), tile_n its
// block width (128 or 256); variant 1: mma.sync, any w strides.  Returns a
// cudaError_t code.
int int8_matmul_launch(const void* x, const void* w, const void* x_scale,
                       const void* w_scale, void* out, void* acc_out, int m,
                       int n, int k, long long w_sk, long long w_sn, int variant,
                       int tile_n, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || k <= 0 || (m + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.x_scale = (const float*)x_scale;
  p.w_scale = (const float*)w_scale;
  p.out = (float*)out;
  p.acc_out = (int32_t*)acc_out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.w_sk = w_sk;
  p.w_sn = w_sn;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    const bool ok = k % 16 == 0 && w_sk == 1 && w_sn == k && ((uintptr_t)x & 15) == 0 &&
                    ((uintptr_t)w & 15) == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (tile_n == 256) return wg::launch<256>(p, s);
    if (tile_n == 128) return wg::launch<128>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 1) return (int)cudaErrorInvalidValue;
  const bool aligned = k % 16 == 0 && n % 16 == 0 && w_sn == 1 && w_sk == n &&
                       ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  return aligned ? mma::launch<true>(p, s) : mma::launch<false>(p, s);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
