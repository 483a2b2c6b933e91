// Training flash attention, forward: causal GQA attention with segment ids.
//
// Replaces: polyrl_tpu/ops/flash.py:flash_attention_train, which runs JAX's
//   bundled TPU kernel (jax/experimental/pallas/ops/tpu/flash_attention.py,
//   _flash_attention_impl, the pallas_call with the l and m residuals).
// Computes: o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / rep] * scale)
//   v[b, j, h / rep] over the keys j visible to i (flash_common.cuh), in
//   f32; writes o in the input type and lse[b, h, i] = m + log(l) in f32,
//   the residual the backward recomputes the probabilities from.
// Bound on the H100: at the train phase's shapes (B 4, T 512, Hq 16, Hkv 8,
//   D 128, bf16) it moves about 25 MB (0.0076 ms at 3.35 TB/s) and does
//   4.3 GFLOP under the causal segment mask (0.0044 ms at 989 TFLOP/s), so
//   bytes bound it by a little, though 512 blocks of 4 K/V tiles on
//   average are short and their prologue and epilogue weigh beside the
//   loop. At T 4096 (B 1) the flops bound it (0.023 ms for the long case's
//   pairs), and the loop's products are the time.
// Design, one instance per dtype in this library:
//   bf16 (the training path), on Hopper's own instructions
//   (flash_wgmma.cuh): one block per (q tile of 64 rows, q head, batch),
//   the q tile the slowest grid dimension and taken from the last tile
//   down, so that the blocks with the most K/V tiles start first. A
//   producer warp copies Q once and the K/V tiles with their segment ids
//   by TMA into a ring of two stages (64 KB at D 128: two blocks an SM),
//   its lanes loading the ids;
//   the consumer warpgroup owns the 64 q rows, S = Q K^T runs as wgmma
//   with both operands read from shared memory by descriptor, the online
//   softmax runs on the accumulator in registers (a row's max and sum
//   reduced over the 4 lanes that hold it), and O += P V as wgmma with P
//   the register A operand, never through shared memory. P goes as two
//   bf16 terms (flash_wgmma.cuh, split_a): rounded once, it moved outputs
//   next to a key with p near 1 and a large v past the output gate. A K/V
//   tile whose segment-id range is disjoint from the q tile's is never
//   copied nor computed (the ranges come from flash_seg_ranges_kernel,
//   made on the device beside this kernel); a tile strictly below the
//   diagonal, inside T, with one segment id throughout both tiles skips
//   the per-element mask.
//   f32 (gradient checks on an f32 copy of the weights): the CUDA-core
//   kernel of flash_f32.cuh, exact f32 products from shared memory, since
//   the tensor cores have no f32 mode without TF32. Not a fallback: each
//   dtype has its one kernel, and a launch that fails raises.
#include <climits>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace polyrl_flash;
using wg::bf16;

// range[b, i] = (min, max) of seg[b, t] over the rows t < T of tile i
// (flash_wgmma.cuh). Replaces no TPU kernel (the TPU kernel masks every
// block it visits); added so that K4 skips the tiles of packed rows that
// hold no visible pair. Bound by bytes (B T ids read, 8 bytes a tile
// written: 16 KB at B 4, T 1024), in practice by its launch: one warp a
// tile. The backward takes the forward's table.
constexpr int kRangeThreads = 256;

__global__ void __launch_bounds__(kRangeThreads)
    flash_seg_ranges_kernel(const int* __restrict__ seg, int2* __restrict__ range, int B,
                            int T_, int n_tiles) {
  const int w = blockIdx.x * (kRangeThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * n_tiles) return;  // whole warp leaves together
  const int b = w / n_tiles, t0 = (w % n_tiles) * wg::kRows;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = lane; r < wg::kRows; r += 32)
    if (t0 + r < T_) {
      const int s = seg[(size_t)b * T_ + t0 + r];
      lo = min(lo, s);
      hi = max(hi, s);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) range[w] = make_int2(lo, hi);
}

inline int launch_seg_ranges(const void* seg, void* range, int B, int T_,
                             cudaStream_t stream) {
  const int n_tiles = (T_ + wg::kRows - 1) / wg::kRows, warps = B * n_tiles;
  const int per_block = kRangeThreads / 32;
  flash_seg_ranges_kernel<<<(warps + per_block - 1) / per_block, kRangeThreads, 0, stream>>>(
      (const int*)seg, (int2*)range, B, T_, n_tiles);
  return (int)cudaGetLastError();
}

constexpr int kFwdStages = 2;

// Q, kFwdStages x (K, V) tiles; 64 q ids and kFwdStages x 64 k ids; the
// barriers (Q, and full and empty a stage); 1024 bytes for the alignment.
template <int D> constexpr size_t fwd_smem() {
  return 1024 + (size_t)(1 + 2 * kFwdStages) * wg::tile_bytes<D>() +
         (size_t)(1 + kFwdStages) * wg::kVecBytes + (size_t)(1 + 2 * kFwdStages) * 8;
}

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 2)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const int* __restrict__ seg, const int2* __restrict__ range,
                          bf16* __restrict__ o,
                          float* __restrict__ lse, int T_, int Hq, int Hkv, int causal,
                          float scale) {
  using namespace wg;
  constexpr int S = kFwdStages, TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ks = reinterpret_cast<bf16*>(sm + TB);            // [S] tiles
  bf16* vs = reinterpret_cast<bf16*>(sm + (1 + S) * TB);  // [S] tiles
  int* seg_q = reinterpret_cast<int*>(sm + (1 + 2 * S) * TB);
  int* seg_k = seg_q + kRows;                             // [S][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(seg_k + S * kRows);
  uint64_t* full = q_full + 1;                            // [S]
  uint64_t* empty = full + S;                             // [S]

  const int n_tiles = (T_ + kRows - 1) / kRows;
  const int h = blockIdx.x, b = blockIdx.y, qt = n_tiles - 1 - blockIdx.z;
  const int hk = h / (Hq / Hkv), q0 = qt * kRows;
  const int n_kt = causal ? qt + 1 : n_tiles;
  const int2* rng = range + (size_t)b * n_tiles;
  const int2 qr = rng[qt];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    bar_init(q_full, 32);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 32);
      bar_init(empty + s, 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    const size_t sb = (size_t)b * T_;
    warp_load_rows(seg_q, seg, sb, q0, T_);
    if (lane == 0) {
      bar_expect(q_full, TB);
      load_tile<D>(qs, &q_map, q_full, b, q0, h);
    } else {
      bar_arrive(q_full);
    }
    Ring<S> ring;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (!ranges_meet(qr, rng[kt])) continue;
      const int st = ring.stage();
      bar_wait(empty + st, ring.parity() ^ 1);
      warp_load_rows(seg_k + st * kRows, seg, sb, kt * kRows, T_);
      if (lane == 0) {
        bar_expect(full + st, 2 * TB);
        load_tile<D>(ks + st * kRows * D, &k_map, full + st, b, kt * kRows, hk);
        load_tile<D>(vs + st * kRows * D, &v_map, full + st, b, kt * kRows, hk);
      } else {
        bar_arrive(full + st);
      }
      ++ring.i;
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r0 and r0 + 8 of the tile
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = 16 * warp + g, row0 = q0 + r0, row1 = row0 + 8;
  bar_wait(q_full, 0);
  const int sq0 = seg_q[r0], sq1 = seg_q[r0 + 8];

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {-FLT_MAX, -FLT_MAX}, l_r[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 below

  Ring<S> ring;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int2 kr = rng[kt];
    if (!ranges_meet(qr, kr)) continue;
    const int st = ring.stage(), k0 = kt * kRows;
    bar_wait(full + st, ring.parity());

    float s[32];
    wg_fence();
    wgmma_ss<D>(s, qs, ks + st * kRows * D);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // bit 4 j + e: element e of block j visible
    uint32_t ok = 0xffffffffu;
    if (!tile_is_uniform(qr, kr, qt, kt, T_, causal))
      ok = visible_bits(row0, row1, sq0, sq1, k0 + t2, seg_k + st * kRows + t2, T_, causal,
                        false);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = (ok >> i) & 1u ? s[i] * sl2 : kMaskValue;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = (ok >> i) & 1u ? exp2f(s[i] - m_r[(i >> 1) & 1]) : 0.f;
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];  // this lane's part
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t hi[4][4], lo[4][4];
    split_a(s, hi, lo);
    fence_regs(acc);
    wg_fence();
    wgmma_rs<D>(acc, hi, lo, vs + st * kRows * D);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    bar_arrive(empty + st);  // stage st is consumed: the producer may refill it
    ++ring.i;
  }

  // every row inside T sees at least itself, so l >= 1 there
  const float l0 = quad_sum(l_r[0]), l1 = quad_sum(l_r[1]);
  store_bf16<D>(acc, 1.f / l0, 1.f / l1, o, b, q0, h, T_, Hq);
  if ((lane & 3) == 0) {
    float* lse_bh = lse + ((size_t)b * Hq + h) * T_;
    if (row0 < T_) lse_bh[row0] = m_r[0] * kLn2 + logf(l0);
    if (row1 < T_) lse_bh[row1] = m_r[1] * kLn2 + logf(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(f32::kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         float* __restrict__ o, float* __restrict__ lse, int T_, int Hq,
                         int Hkv, int causal, float scale) {
  using namespace f32;
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                // [64][D + 1]
  float* ks = qs + kTile * LD;       // [64][D + 1]
  float* vs = ks + kTile * LD;       // [64][D + 1]
  float* ps = vs + kTile * LD;       // [64][65] probabilities
  int* seg_q = reinterpret_cast<int*>(ps + kTile * kPLd);
  int* seg_k = seg_q + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTile;
  const int tx = tx_of(), ty = ty_of();
  load_tile<D>(q, b, q0, h, T_, Hq, qs);
  load_seg(seg, b, q0, T_, seg_q);

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) acc[i][jd] = 0.f;
  }

  const int n_tiles = (T_ + kTile - 1) / kTile;
  const int n_kt = causal ? min(qt + 1, n_tiles) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    load_tile<D>(k, b, k0, hk, T_, Hkv, ks);
    load_tile<D>(v, b, k0, hk, T_, Hkv, vs);
    load_seg(seg, b, k0, T_, seg_k);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = visible(q0 + r, k0 + c, T_, seg_q[r], seg_k[c], causal);
        s[i][j] = ok[j] ? s[i][j] * scale : kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * kPLd + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(ps, vs, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_) continue;
    // every row sees at least itself, so l >= 1 here
    const float inv = 1.f / l[i];
    float* dst = o + row_off(b, t, h, T_, Hq, D);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) dst[tx + 16 * jd] = acc[i][jd] * inv;
    if (tx == 0) lse[((size_t)b * Hq + h) * T_ + t] = m[i] + logf(l[i]);
  }
}


template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* seg,
                const void* range, void* o, void* lse, int B, int T_, int Hq, int Hkv,
                int causal, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int e = wg::rows_map(&q_map, q, B, T_, Hq, D);
  if (!e) e = wg::rows_map(&k_map, k, B, T_, Hkv, D);
  if (!e) e = wg::rows_map(&v_map, v, B, T_, Hkv, D);
  if (e) return e;
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t ce = allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(Hq, B, (T_ + wg::kRows - 1) / wg::kRows);
  flash_fwd_bf16_kernel<D><<<grid, wg::kThreads, smem, stream>>>(
      q_map, k_map, v_map, (const int*)seg, (const int2*)range, (bf16*)o, (float*)lse, T_, Hq, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* seg, void* o,
               void* lse, int B, int T_, int Hq, int Hkv, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = f32::smem_bytes<D>(3, 1);
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + f32::kTile - 1) / f32::kTile, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, f32::kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)seg, (float*)o,
      (float*)lse, T_, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}


}  // namespace

// range[b, i] (int2, [B, ceil(T / 64)]): the (min, max) segment id of
// rows 64 i.. of row b inside T (flash_wgmma.cuh), made on the device for
// the bf16 kernel's skip of segment-disjoint tiles.
extern "C" int polyrl_flash_segment_ranges(const void* seg, void* range, int B, int T_,
                                           void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  return launch_seg_ranges(seg, range, B, T_, (cudaStream_t)stream);
}

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}; Hq a multiple of Hkv;
// q, k and v 16-byte aligned, as TMA needs (checked by the Python
// wrapper, ops/flash.py). range: polyrl_flash_segment_ranges of seg
// (bf16 only; the f32 kernel ignores it).
extern "C" int polyrl_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* seg, const void* range, void* o,
                                          void* lse, int dtype, int B, int T_, int Hq,
                                          int Hkv, int D, int causal, float scale,
                                          void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, seg, range, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, seg, range, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 kernel at head dim D, in bytes.
extern "C" int polyrl_flash_attention_fwd_smem(int D) {
  return D == 64 ? (int)fwd_smem<64>() : D == 128 ? (int)fwd_smem<128>() : -1;
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
