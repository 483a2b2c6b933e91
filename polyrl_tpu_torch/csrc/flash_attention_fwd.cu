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
//   bytes bound it by a little; but 512 blocks of 4 K/V tiles on average
//   are short, and the prologue (Q and the first K/V tile land before any
//   product) and the epilogue weigh beside the loop. At T 4096 (B 1) the
//   flops bound it (0.023 ms for the long case's pairs) and the loop is
//   the time: the rate at which mma.sync issues, and the shared-memory
//   reads that feed it (one ldmatrix.x4 per two mma in Q K^T).
// Design, one instance per dtype in this library:
//   bf16 (the training path): one block of 4 warps per (q tile of 64 rows,
//   q head, batch). The q tile is the slowest grid dimension, taken from
//   the last tile down: the blocks with the most K/V tiles start first and
//   the short ones fill the tail wave. Q, K, V are staged as bf16 in
//   swizzled shared memory by cp.async (flash_mma.cuh), K/V in a ring of
//   two stages so that tile kt + 1 loads while tile kt computes (81 KB at
//   D 128: two blocks per SM). Each warp keeps its 16 Q rows as A fragments
//   in registers; S = Q K^T and O += P V run on the tensor cores (mma.sync
//   m16n8k16, f32 accumulate); the online softmax runs on the S fragments,
//   a row's max and sum reduced over the 4 lanes that hold it, and P goes
//   to P V as A fragments in registers, never through shared memory. P
//   goes as two bf16 terms, bf16(P) and the bf16 of the remainder: P
//   rounded once to bf16 moved outputs next to a key with p near 1 and a
//   large v by up to 2 ulps, past the output gate, while the split carries
//   P to about 2^-17 for a second P V product per tile. A K/V tile strictly
//   below the diagonal, inside T, whose q and k segment ids are all one
//   value (a block vote on the staged ids) skips the per-element mask.
//   128-row q tiles over 8 warps share each K/V tile between twice the
//   rows but hold one block per SM by registers; they were slower at
//   both shapes (PERF.md).
//   f32 (gradient checks on an f32 copy of the weights): the CUDA-core
//   kernel of flash_f32.cuh, exact f32 products from shared memory, since
//   the tensor cores have no f32 mode without TF32. Not a fallback: each
//   dtype has its one kernel, and a launch that fails raises.
//   wgmma with operands read from shared memory by descriptor, and TMA
//   loads, are the next step.
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace {

using namespace polyrl_flash;
using mma::bf16;

// The launch bound's minimum of one block per SM: without it ptxas held the
// D 64 instance to 128 registers and spilled.
template <int D>
__global__ void __launch_bounds__(mma::kThreads, 1)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ seg,
                          bf16* __restrict__ o, float* __restrict__ lse, int T_, int Hq,
                          int Hkv, int causal, float scale) {
  using namespace mma;
  constexpr int R = kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);              // [64][D]
  bf16* ks = qs + R * D;                                 // [2][64][D]
  bf16* vs = ks + 2 * R * D;                             // [2][64][D]
  int* seg_q = reinterpret_cast<int*>(vs + 2 * R * D);   // [64]
  int* seg_k = seg_q + R;                                // [2][64]

  const int n_tiles = (T_ + R - 1) / R;
  const int h = blockIdx.x, b = blockIdx.y, qt = n_tiles - 1 - blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * R;
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int row0 = q0 + m0 + g, row1 = row0 + 8;
  const int n_kt = causal ? qt + 1 : n_tiles;

  auto issue_kv = [&](int kt, int st) {
    load_tile<D>(ks + st * R * D, k, b, kt * R, hk, T_, Hkv);
    load_tile<D>(vs + st * R * D, v, b, kt * R, hk, T_, Hkv);
    load_row_values(seg_k + st * R, seg, (size_t)b * T_, kt * R, T_);
    cp_async_commit();
  };
  load_tile<D>(qs, q, b, q0, h, T_, Hq);
  load_row_values(seg_q, seg, (size_t)b * T_, q0, T_);
  cp_async_commit();
  issue_kv(0, 0);
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a<D>(qf[kk], qs, m0, kk);
  const int sq0 = seg_q[m0 + g], sq1 = seg_q[m0 + g + 8], seg0 = seg_q[0];
  const bool q_uniform =
      __syncthreads_and(seg_q[threadIdx.x % R] == seg0) && q0 + R <= T_;

  float acc[D / 8][4];
  zero(acc);
  float m_r[2] = {-FLT_MAX, -FLT_MAX}, l_r[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2 below

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * R;
    if (kt + 1 < n_kt) {
      issue_kv(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int* sk = seg_k + st * R;
    const bf16* kst = ks + st * R * D;
    const bf16* vst = vs + st * R * D;
    // the vote is also the barrier that publishes stage st to every warp
    const bool fast = __syncthreads_and(sk[threadIdx.x % R] == seg0) && q_uniform &&
                      k0 + R <= T_ && (!causal || k0 + R <= q0);

    float s[R / 8][4];
    zero(s);
    gemm_nt_reg<D, R>(s, qf, kst, 0);

    uint32_t ok = 0xffffffffu;  // bit 4 j + e: element e of block j visible
    if (!fast) {
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + t2 + (e & 1);
          if (!visible(e < 2 ? row0 : row1, k0 + c, T_, e < 2 ? sq0 : sq1, sk[c], causal))
            ok &= ~(1u << (4 * j + e));
        }
    }
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (ok >> (4 * j + e)) & 1u ? s[j][e] * sl2 : kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (ok >> (4 * j + e)) & 1u ? exp2f(s[j][e] - m_r[e >> 1]) : 0.f;
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];  // this lane's part
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    gemm_pv<D, R>(acc, s, vst, 0);
    __syncthreads();  // stage st is consumed: the next issue may refill it
  }

  // every row inside T sees at least itself, so l >= 1 there
  const float l0 = quad_sum(l_r[0]), l1 = quad_sum(l_r[1]);
  store_rows<D>(acc, 1.f / l0, 1.f / l1, qs, m0, o, b, q0 + m0, h, T_, Hq);
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
int launch_bf16(const void* q, const void* k, const void* v, const void* seg, void* o,
                void* lse, int B, int T_, int Hq, int Hkv, int causal, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = mma::smem_bytes<D>(5, 3);  // q, 2 x (k, v); 3 x 64 segment ids
  cudaError_t e = allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (T_ + mma::kRows - 1) / mma::kRows);
  flash_fwd_bf16_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (bf16*)o,
      (float*)lse, T_, Hq, Hkv, causal, scale);
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

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}; Hq a multiple of Hkv;
// q, k, v 16-byte aligned (checked by the Python wrapper, ops/flash.py).
extern "C" int polyrl_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* seg, void* o, void* lse, int dtype,
                                          int B, int T_, int Hq, int Hkv, int D,
                                          int causal, float scale, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
