// Hopper building blocks of the bf16 instance of the training flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): TMA tile loads
// into an mbarrier ring, wgmma products with operands read from shared
// memory by descriptor, and the per-tile segment-id ranges that let a
// kernel skip a (q tile, k tile) pair with no visible pair in it.
//
// Tiles are 64 rows of one head of a [B, T, H, D] bf16 tensor. TMA copies
// one in D / 64 boxes of [64 rows][64 columns] (128 bytes a row) with the
// 128-byte swizzle, each box 8 KB and 1024-byte aligned in shared memory:
// the layout wgmma's SWIZZLE_128B descriptors read. Rows at or past T are
// zero-filled by the copy (the tensor map's T dimension bounds it), so a
// ragged last tile needs no padding by the caller. The tensor maps are
// encoded on the host for each call and passed by value as
// __grid_constant__ kernel parameters, so a CUDA graph captures them with
// the launch. The encoder, cuTensorMapEncodeTiled, is looked up by
// cudaGetDriverEntryPoint, so the library links no -lcuda.
//
// Each block is one consumer warpgroup (warps 0-3, 64 output rows) and one
// producer warp (warp 4) whose lane 0 starts every tile copy while its 32
// lanes load the tile's row values (segment ids, LSE, delta): a ring of
// kStages stages, each with a "full" barrier (the 32 producer lanes arrive,
// lane 0 with the copies' byte count, and the bytes land) and an "empty"
// barrier (all 128 consumer threads are done with the stage).
// The producer and the consumers walk the same list of tiles (the caller's
// predicate, the same on both sides), so the ring needs no other signal.
//
// Products are wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate). The
// accumulator layout (PTX ISA, warpgroup thread 32 w + 4 g + t): element
// 4 j + e of a 64 x N accumulator is row 16 w + g (+ 8 for e >= 2),
// column 8 j + 2 t + (e & 1), the mma.sync m16n8 C layout stacked over the
// four warps. Packed to bf16x2, accumulator blocks 2 kk and 2 kk + 1 are
// the register A operand of the next product's k step kk, so probabilities
// and their gradients go from one product to the next in registers. They
// go as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), which carries
// x to about 2^-17 of its value for twice the products (see split_a).
#pragma once

#include <cstdint>
#include <cuda.h>

#include "flash_common.cuh"

namespace polyrl_flash {
namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;                     // rows of every tile
constexpr int kThreads = 128 + 32;            // consumer warpgroup + producer warp
constexpr int kProducerWarp = 4;
constexpr int kBoxBytes = kRows * 128;        // one [64][64] bf16 swizzled box
constexpr int kVecBytes = kRows * 4;          // 64 4-byte row values
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D> __host__ __device__ constexpr int tile_bytes() { return kRows * D * 2; }

// -- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn lookup_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                   cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                          &found);
#endif
  return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiledFn)fn
                                                                  : nullptr;
}

inline EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = lookup_encoder();
  return fn;
}

// Rows of head h of a [B, T, H, D] bf16 tensor: boxes of 64 columns x 64
// rows, 128-byte swizzle. Base and row stride must be 16-byte aligned.
inline int rows_map(CUtensorMap* m, const void* base, int B, int T_, int H, int D) {
  EncodeTiledFn enc = encoder();
  if (!enc) return (int)cudaErrorInvalidDevice;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T_, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T_ * H * D * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                   strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// -- device: shared memory, barriers, copies -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the launcher asks for
// 1024 more than the layout needs): the swizzle atoms must be aligned.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// Tile rows [row0, row0 + 64) of head h, batch b into dst (D / 64 boxes).
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                          int b, int row0, int h) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_4d(reinterpret_cast<unsigned char*>(dst) + cb * kBoxBytes, map, bar, cb * 64, h, row0,
           b);
}

// 64 consecutive 4-byte row values src[base + row0 + r] into dst, 0 for
// rows at or past T, by the 32 lanes of the calling warp. Segment ids,
// LSE and delta are plain loads by the producer warp, not TMA copies: a
// 1-D box whose start is not 16-byte aligned (b T + row0 for a T that is
// not a multiple of 4) faults.
template <typename V>
__device__ __forceinline__ void warp_load_rows(V* dst, const V* __restrict__ src, size_t base,
                                               int row0, int T_, V mul = V(1)) {
  for (int r = threadIdx.x & 31; r < kRows; r += 32)
    dst[r] = row0 + r < T_ ? src[base + row0 + r] * mul : V(0);
}

// The producer's place in a ring of S stages: stage and the parity of its
// current round. Consumers keep the same count.
template <int S> struct Ring {
  int i = 0;
  __device__ __forceinline__ int stage() const { return i % S; }
  __device__ __forceinline__ uint32_t parity() const { return (i / S) & 1; }
};

// -- device: wgmma ---------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_field(uint32_t x) { return (uint64_t)((x & 0x3FFFF) >> 4); }

// SWIZZLE_128B matrix descriptor: start address, leading and stride byte
// offsets.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return desc_field(smem_u32(p)) | (desc_field(lbo) << 16) | (desc_field(sbo) << 32) |
         (1ull << 62);
}

// k step kk (16 columns) of a tile whose columns are the product's
// reduction (K-major): rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  const unsigned char* p = reinterpret_cast<const unsigned char*>(tile) +
                           (kk >> 2) * kBoxBytes + (kk & 3) * 32;
  return make_desc(p, 16, 1024);
}

// k step kk (16 rows) of a tile whose rows are the product's reduction and
// whose columns are its N (MN-major): 64-column boxes kBoxBytes apart
// (leading offset), 8-row groups 1024 bytes apart (stride offset).
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return make_desc(reinterpret_cast<const unsigned char*>(tile) + kk * 2048, kBoxBytes, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving register reads or writes across the
// asynchronous products.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define POLYRL_OUT8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define POLYRL_OUT32 POLYRL_OUT8(0), POLYRL_OUT8(8), POLYRL_OUT8(16), POLYRL_OUT8(24)
#define POLYRL_OUT64 POLYRL_OUT32, POLYRL_OUT8(32), POLYRL_OUT8(40), POLYRL_OUT8(48), POLYRL_OUT8(56)
#define POLYRL_REGS32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define POLYRL_REGS64                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64) = or += A B^T for one k step, both operands K-major in
// shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " POLYRL_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : POLYRL_OUT32
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A B for one k step, A in registers, B MN-major in shared
// memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " POLYRL_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : POLYRL_OUT32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " POLYRL_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : POLYRL_OUT64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef POLYRL_OUT8
#undef POLYRL_OUT32
#undef POLYRL_OUT64
#undef POLYRL_REGS32
#undef POLYRL_REGS64

// s (64 x 64) = A B^T over D columns: a and b are [64][D] tiles whose rows
// are the product's rows and columns. Started, not waited for.
template <int D>
__device__ __forceinline__ void wgmma_ss(float (&s)[32], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss_n64(s, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// acc (64 x D) += X B, X (64 x 64) as two bf16 terms in registers, b a
// [64][D] tile whose rows are the reduction. Started, not waited for.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&acc)[D / 2], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_rs(acc, hi[kk], desc_mn(b, kk));
    mma_rs(acc, lo[kk], desc_mn(b, kk));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator as the A operand of 4 k steps, in two bf16
// terms: hi = bf16(x), lo = bf16(x - hi). Rounded once to bf16, P moved
// the forward's outputs past their gate next to a key with p near 1 and
// a large v, and dS the full-model gradient gate on bf16 weights (PERF.md).
__device__ __forceinline__ void split_a(const float (&c)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // register i: row g (i even) or g + 8, block 2 kk + i / 2
      const float x = c[4 * (2 * kk + (i >> 1)) + 2 * (i & 1)];
      const float y = c[4 * (2 * kk + (i >> 1)) + 2 * (i & 1) + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][i] = pack_bf16(x - __low2float(h), y - __high2float(h));
    }
}

// Reductions over the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A 64 x D accumulator, the thread's row r scaled by mul0 and row r + 8 by
// mul1, as bf16 into rows row0.. (< T) of head h, batch b of a
// [B, T, H, D] tensor (2 columns a block).
template <int D>
__device__ __forceinline__ void store_bf16(const float (&acc)[D / 2], float mul0, float mul1,
                                           bf16* __restrict__ dst, int b, int row0, int h,
                                           int T_, int H) {
  const int l = threadIdx.x & 31, r = 16 * (threadIdx.x >> 5) + (l >> 2), c = 2 * (l & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + r + 8 * half;
    if (t >= T_) continue;
    bf16* row = dst + row_off(b, t, h, T_, H, D) + c;
    const float mul = half ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// The same in f32 (a partial sum of the backward's split).
template <int D>
__device__ __forceinline__ void store_f32(const float (&acc)[D / 2], float mul,
                                          float* __restrict__ dst, int b, int row0, int h,
                                          int T_, int H) {
  const int l = threadIdx.x & 31, r = 16 * (threadIdx.x >> 5) + (l >> 2), c = 2 * (l & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + r + 8 * half;
    if (t >= T_) continue;
    float* row = dst + row_off(b, t, h, T_, H, D) + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// -- segment-id ranges of the tiles ----------------------------------------------
//
// range[b, i] = (min, max) of seg[b, t] over the rows t < T of tile i
// (rows 64 i .. 64 i + 63), made on the device by flash_seg_ranges_kernel
// (flash_attention_fwd.cu); nothing is read on the host. Query tile i and
// key tile j hold a visible pair only if their ranges meet (seg_q == seg_k
// is needed), so a pair of tiles whose ranges are disjoint is skipped. A
// pad tail (id 0) widens its tile's range down to 0, so no visible pair is
// skipped: the test is conservative, never lossy.

__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// Bit 4 j + e of the result: accumulator element e of block j is visible
// (flash_common.cuh), for a thread whose accumulator rows are row0 and
// row1 with ids id0 and id1, and whose columns 8 j + (0, 1) start at
// col0 with ids cols[8 j], cols[8 j + 1] (shared memory). With
// rows_are_keys the rows are key positions and the columns query
// positions (the dk/dv kernel's transposed scores). Only for a pair of
// tiles that tile_is_uniform turns down: the others skip it.
__device__ __forceinline__ uint32_t visible_bits(int row0, int row1, int id0, int id1,
                                                 int col0, const int* cols, int T_,
                                                 int causal, bool rows_are_keys) {
  uint32_t ok = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int col = col0 + 8 * j + e2, id = cols[8 * j + e2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = hf ? row1 : row0;
        const bool vis = rows_are_keys ? visible(col, row, T_, id, hf ? id1 : id0, causal)
                                       : visible(row, col, T_, hf ? id1 : id0, id, causal);
        ok |= (uint32_t)vis << (4 * j + 2 * hf + e2);
      }
    }
  return ok;
}

// The pair (query tile, key tile) needs no per-element mask: both full
// inside T, strictly below the diagonal when causal, one segment id
// throughout both.
__device__ __forceinline__ bool tile_is_uniform(int2 qr, int2 kr, int qt, int kt, int T_,
                                                int causal) {
  return (!causal || kt < qt) && (qt + 1) * kRows <= T_ && (kt + 1) * kRows <= T_ &&
         qr.x == qr.y && kr.x == kr.y && qr.x == kr.x;
}

}  // namespace wg
}  // namespace polyrl_flash
