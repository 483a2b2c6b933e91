// Tensor-core helpers of the bf16 instance of the training flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Tiles are 64 rows of one head, staged as bf16 [64][D] in shared memory by
// cp.async 16-byte copies (rows at or past T are zero-filled, so the ragged
// last tile needs no padding by the caller). A row's 16-byte chunks are
// XOR-swizzled by the row's low 3 bits: the 8 row addresses one ldmatrix
// phase reads then fall in 8 different bank groups.
//
// Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate), one warp per
// 16 rows of the output, fed by ldmatrix (.trans for an operand whose
// reduction runs along the tile's rows). Fragment layouts (PTX ISA, lane =
// 4 g + t): a C fragment holds rows g and g + 8, columns 2t and 2t + 1 of a
// 16 x 8 tile; packed to bf16x2, two neighbouring C fragments are exactly
// the A fragment of the next product's 16-column step. So probabilities and
// their gradients go from one product to the next in registers (gemm_pv).
#pragma once

#include <cstdint>

#include "flash_common.cuh"

namespace polyrl_flash {
namespace mma {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // rows of every staged tile
constexpr int kWarps = 4;      // 16 output rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; with valid false it writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of 16-byte chunk c of row r in a swizzled [R][D] tile.
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Rows [row0, row0 + 64) of head h, batch b of a [B, T, H, D] tensor into
// the swizzled tile dst.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b,
                                          int row0, int h, int T_, int H) {
  constexpr int C = D / 8;
#pragma unroll
  for (int it = 0; it < kRows * C / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x, r = i / C, c = i % C, t = row0 + r;
    const bool ok = t < T_;
    cp_async16(dst + swz<D>(r, c), ok ? src + row_off(b, t, h, T_, H, D) + c * 8 : src, ok);
  }
}

// 64 consecutive 4-byte values src[base + row0 + i] (rows < T) into dst.
template <typename V>
__device__ __forceinline__ void load_row_values(V* dst, const V* __restrict__ src,
                                                size_t base, int row0, int T_) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const bool ok = row0 + i < T_;
    cp_async4(dst + i, ok ? src + base + row0 + i : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b for one 16 x 8 x 16 step.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A fragment: rows m0..m0 + 15, columns 16 kk..16 kk + 15 of a tile.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int m0, int kk) {
  const int l = lane_id();
  ldsm_x4(a, tile + swz<D>(m0 + (l & 15), 2 * kk + (l >> 4)));
}

// B fragments of two 8-column blocks where the tile's rows n0..n0 + 15 are
// the product's columns and its columns 16 kk.. the reduction (K in Q K^T):
// r[0..1] for rows n0..n0 + 7, r[2..3] for n0 + 8..n0 + 15.
template <int D>
__device__ __forceinline__ void frag_b_nt(uint32_t (&r)[4], const bf16* tile, int n0, int kk) {
  const int l = lane_id();
  ldsm_x4(r, tile + swz<D>(n0 + (l & 7) + ((l >> 4) << 3), 2 * kk + ((l >> 3) & 1)));
}

// B fragments where the tile's rows k0..k0 + 15 are the reduction and its
// columns 16 dn2.. the product's columns (V in P V): r[0..1] for columns
// 16 dn2..+7, r[2..3] for 16 dn2 + 8..+15.
template <int D>
__device__ __forceinline__ void frag_b_nn(uint32_t (&r)[4], const bf16* tile, int k0,
                                          int dn2) {
  const int l = lane_id();
  ldsm_x4_t(r, tile + swz<D>(k0 + (l & 7) + (((l >> 3) & 1) << 3), 2 * dn2 + (l >> 4)));
}

// c[j] += (rows m0.. of ta) . (rows n0 + 8 j.. of tb) over all D columns:
// a 16 x N block of A B^T.
template <int D, int N>
__device__ __forceinline__ void gemm_nt(float (&c)[N / 8][4], const bf16* ta, int m0,
                                        const bf16* tb, int n0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<D>(a, ta, m0, kk);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      frag_b_nt<D>(b, tb, n0 + 16 * j, kk);
      mma16816(c[2 * j], a, b[0], b[1]);
      mma16816(c[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// The same with the 16 rows of A already in registers (a[kk], kk < D / 16).
template <int D, int N>
__device__ __forceinline__ void gemm_nt_reg(float (&c)[N / 8][4],
                                            const uint32_t (&a)[D / 16][4], const bf16* tb,
                                            int n0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      frag_b_nt<D>(b, tb, n0 + 16 * j, kk);
      mma16816(c[2 * j], a[kk], b[0], b[1]);
      mma16816(c[2 * j + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x D) += P (16 x K, f32 C fragments) . (rows k0..k0 + K of tb),
// P being probabilities or their gradients. Packed to bf16x2, two
// neighbouring C fragments are the A fragment of a 16-column step, and P
// goes as two such terms, hi = bf16(P) and lo = bf16(P - hi): the product
// carries P to about 2^-17 of its value instead of bf16's 2^-9, for twice
// the mma count and no more shared-memory reads (each B fragment feeds
// both terms).
template <int D, int K>
__device__ __forceinline__ void gemm_pv(float (&acc)[D / 8][4], const float (&c)[K / 8][4],
                                        const bf16* tb, int k0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // A register i: rows g (i even) or g + 8, block 2 kk + i / 2
      const float x = c[2 * kk + (i >> 1)][2 * (i & 1)];
      const float y = c[2 * kk + (i >> 1)][2 * (i & 1) + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      hi[i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[i] = pack_bf16(x - __low2float(h), y - __high2float(h));
    }
#pragma unroll
    for (int dn2 = 0; dn2 < D / 16; ++dn2) {
      uint32_t b[4];
      frag_b_nn<D>(b, tb, k0 + 16 * kk, dn2);
      mma16816(acc[2 * dn2], hi, b[0], b[1]);
      mma16816(acc[2 * dn2 + 1], hi, b[2], b[3]);
      mma16816(acc[2 * dn2], lo, b[0], b[1]);
      mma16816(acc[2 * dn2 + 1], lo, b[2], b[3]);
    }
  }
}

template <int N> __device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Reductions over the 4 lanes that hold one row of a C fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp's 16 x D f32 accumulator (rows m0.. of its block), row g scaled by
// mul0 and row g + 8 by mul1, as bf16 into global rows row0.. (< T) of head
// h, batch b of a [B, T, H, D] tensor. It goes through the warp's own rows
// of the swizzled tile `stage` so that global stores are 16 bytes a lane.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul0,
                                           float mul1, bf16* stage, int m0,
                                           bf16* __restrict__ dst, int b, int row0, int h,
                                           int T_, int H) {
  const int l = lane_id(), g = l >> 2, t2 = 2 * (l & 3);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(stage + swz<D>(m0 + g, dn) + t2) =
        pack_bf16(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(m0 + g + 8, dn) + t2) =
        pack_bf16(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
  __syncwarp();
  constexpr int C = D / 8;
#pragma unroll
  for (int i = l; i < 16 * C; i += 32) {
    const int r = i / C, c = i % C, t = row0 + r;
    if (t < T_)
      *reinterpret_cast<uint4*>(dst + row_off(b, t, h, T_, H, D) + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(m0 + r, c));
  }
}

// Shared memory of a block with n_tiles staged [64][D] bf16 tiles and
// n_vals arrays of 64 4-byte row values.
template <int D> __host__ __device__ constexpr size_t smem_bytes(int n_tiles, int n_vals) {
  return (size_t)n_tiles * kRows * D * sizeof(bf16) + (size_t)n_vals * kRows * 4;
}

}  // namespace mma
}  // namespace polyrl_flash
