// CUDA-core helpers of the f32 instance of the training flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu). f32 inputs
// come only from gradient checks on an f32 copy of the weights and from the
// f32 card tests; the tensor cores have no f32 mode without TF32, which the
// port keeps off, so this instance stays exact f32 on CUDA cores. The bf16
// instance (the training path) is in flash_mma.cuh.
//
// Tiles: 64 query rows x 64 key rows, 256 threads. A tile of one tensor is
// staged in shared memory as f32 [64][D + 1]: the +1 makes the row stride
// 1 mod 32 banks, so 16 threads reading 16 different rows at one column hit
// 16 different banks. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i (i < 4) and columns tx + 16 j of every 64 x 64 score tile and
// of every 64 x D accumulator: the score rows a thread computes are the
// accumulator rows it updates, so the online softmax needs only a
// reduction across the 16 threads of a half-warp. Rows past T are staged
// as zeros and masked; the ragged last tile needs no padding by the caller.
#pragma once

#include "flash_common.cuh"

namespace polyrl_flash {
namespace f32 {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;
constexpr int kPLd = kTile + 1;  // row stride of a 64 x 64 f32 tile in smem

__device__ __forceinline__ int tx_of() { return threadIdx.x & 15; }
__device__ __forceinline__ int ty_of() { return threadIdx.x >> 4; }

// Reductions over the 16 threads of a half-warp (the threads that share ty).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0 + 64) of head h, batch b of a [B, T, H, D] f32
// tensor into dst as [64][D + 1]; rows >= T are zeros. Consecutive threads
// read consecutive columns (coalesced).
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int b, int row0,
                                          int h, int T_, int H, float* dst) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D, t = row0 + r;
    dst[r * (D + 1) + d] = t < T_ ? src[row_off(b, t, h, T_, H, D) + d] : 0.f;
  }
}

// Segment ids of rows [row0, row0 + 64) of batch b; -1 past T.
__device__ __forceinline__ void load_seg(const int* __restrict__ seg, int b, int row0,
                                         int T_, int* dst) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = row0 + i < T_ ? seg[(size_t)b * T_ + row0 + i] : -1;
}

// f32 [B, H, T] values of rows [row0, row0 + 64) of (b, h); 0 past T.
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int b, int h,
                                          int row0, int T_, int H, float* dst) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = row0 + i < T_ ? src[((size_t)b * H + h) * T_ + row0 + i] : 0.f;
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float (&s)[4][4]) {
  constexpr int LD = D + 1;
  const float* a = A + ty_of() * LD;
  const float* bb = B + tx_of() * LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[16 * i * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bb[16 * j * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][jd] += sum_c P[ty + 16 i][c] * V[c][tx + 16 jd], P a 64 x 64 tile
// (row stride kPLd) and V a staged [64][D + 1] tile.
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* V,
                                         float (&acc)[4][D / 16]) {
  constexpr int LD = D + 1;
  const float* p = P + ty_of() * kPLd;
  const float* v = V + tx_of();
#pragma unroll 2
  for (int c = 0; c < kTile; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[16 * i * kPLd + c];
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      const float vv = v[c * LD + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
    }
  }
}

// Shared memory of a block with n_big staged [64][D + 1] tiles and n_p
// 64 x 64 tiles, plus 4 x 64 words of row data (segment ids, LSE, delta).
template <int D> __host__ __device__ constexpr size_t smem_bytes(int n_big, int n_p) {
  return sizeof(float) * ((size_t)n_big * kTile * (D + 1) + (size_t)n_p * kTile * kPLd +
                          4 * kTile);
}

}  // namespace f32
}  // namespace polyrl_flash
