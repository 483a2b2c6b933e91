// Training flash attention, backward: dq, dk, dv from the forward's LSE.
//
// Replaces: the backward of polyrl_tpu/ops/flash.py:flash_attention_train,
//   JAX's bundled TPU kernel's _flash_attention_bwd_dkv and
//   _flash_attention_bwd_dq pallas_calls
//   (jax/experimental/pallas/ops/tpu/flash_attention.py).
// Computes, with p = exp(q . k * scale - lse) on visible pairs and 0 else:
//   delta[b, h, i] = sum_d do[b, i, h, d] * o[b, i, h, d]          (entry 1)
//   ds = p * (do . v - delta)
//   dq[i] = scale * sum_j ds[i, j] k[j]                               (entry 2)
//   dv[j] = sum_{h in kv head, i} p[i, j] do[i]
//   dk[j] = scale * sum_{h in kv head, i} ds[i, j] q[i]               (entry 3)
//   The GQA gradient of a kv head is the sum over its rep query heads (the
//   VJP of the JAX wrapper's jnp.repeat), taken inside one block in
//   registers: no atomics, so the result is the same every run.
// Bound on the H100: at the train phase's shapes (B 4, T 512, Hq 16, Hkv 8,
//   D 128, bf16) it moves about 51 MB (0.015 ms at 3.35 TB/s) and does
//   10.7 GFLOP under the causal segment mask (0.011 ms at 989 TFLOP/s); at
//   T 4096 (B 1) the flops bound it (0.057 ms for the long case's pairs).
//   In practice the dk/dv kernel is two thirds of the time at both shapes
//   (PERF.md), and shared-memory reads bound it: with one warp per 16 k
//   rows, each mma of the four products (the second bf16 terms below
//   aside) needs 0.75 ldmatrix.x4 (512 bytes, 3 clocks of the SM's 128
//   bytes a clock), against 0.5 or less in the forward. At T 512
//   its 256 blocks also run 2 to 16 q tiles each (the causal triangle over
//   two q heads), so the SMs that hold k tile 0 finish last.
// Design, the TPU kernel's split into a dq call and a dkv call, as two
//   kernels that share nothing, one instance per dtype:
//   bf16 (the training path): 4 warps per block, tiles of 64 rows staged
//   as bf16 in swizzled shared memory by cp.async with a ring of two
//   stages for the streamed tiles (flash_mma.cuh), every product on the
//   tensor cores (mma.sync m16n8k16, f32 accumulate). dq: one block per
//   (q tile, q head, batch), heaviest q tile first; each warp owns 16 q
//   rows, computes S = Q K^T and dP = dO V^T per K/V tile, forms
//   dS = P (dP - delta) in registers and adds dS K (K read transposed by
//   ldmatrix.trans) to its dq rows. dk/dv: one block per (k tile, kv head,
//   batch), k tile 0 (the longest causal loop) first; each warp owns 16 k
//   rows and walks the rep q heads and the q tiles from the diagonal on,
//   16 q columns at a time: S^T = K Q^T and dP^T = V dO^T, then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T passed as A fragments
//   in registers, never through shared memory. The 16 x D dK and dV
//   accumulators (128 registers at D 128) leave room for 16 columns of
//   scores and no more: 32 spilled. 96 KB of shared memory at D 128 in
//   both kernels: two blocks per SM. Tiles strictly below the diagonal
//   with one segment id throughout skip the mask. P and dS go to their
//   products as two bf16 terms each (flash_mma.cuh, gemm_pv): rounded
//   once to bf16, they moved the train phase's full-model gradient gate
//   on bf16 weights past its norm-ratio limit (PERF.md); the second term
//   adds mma but no shared-memory reads. A warp layout that gives each
//   warp more rows of dK and dV (FA2's, with P and dS through shared
//   memory) or wgmma reading its operands from shared memory would cut
//   the ldmatrix reads.
//   f32 (gradient checks on an f32 copy of the weights): the CUDA-core
//   kernels of flash_f32.cuh, exact f32; the tensor cores have no f32
//   mode without TF32. Not a fallback: each dtype has its one kernel.
//   The delta kernel is one warp per row for both.
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace {

using namespace polyrl_flash;
using mma::bf16;

constexpr int kDeltaThreads = 256;

// delta[b, h, t] = sum_d do * o in f32: one warp per (b, t, h) row.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int T_, int Hq) {
  const int row = blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warp leaves together
  const size_t off = (size_t)row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f32(o[off + d]) * to_f32(dout[off + d]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (lane == 0) {
    // row = (b * T + t) * Hq + h of the [B, T, Hq, D] layout
    const int h = row % Hq, bt = row / Hq, t = bt % T_, b = bt / T_;
    delta[((size_t)b * Hq + h) * T_ + t] = sum;
  }
}

// -- bf16: tensor cores --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ seg,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq, int T_,
                         int Hq, int Hkv, int causal, float scale) {
  using namespace mma;
  constexpr int R = kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);              // [64][D]
  bf16* dos = qs + R * D;                                // [64][D]
  bf16* ks = dos + R * D;                                // [2][64][D]
  bf16* vs = ks + 2 * R * D;                             // [2][64][D]
  int* seg_q = reinterpret_cast<int*>(vs + 2 * R * D);   // [64]
  int* seg_k = seg_q + R;                                // [2][64]

  const int n_tiles = (T_ + R - 1) / R;
  const int h = blockIdx.x, b = blockIdx.y, qt = n_tiles - 1 - blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * R;
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int m0 = (threadIdx.x >> 5) * 16;
  const int row0 = q0 + m0 + g, row1 = row0 + 8;
  const int n_kt = causal ? qt + 1 : n_tiles;

  auto issue_kv = [&](int kt, int st) {
    load_tile<D>(ks + st * R * D, k, b, kt * R, hk, T_, Hkv);
    load_tile<D>(vs + st * R * D, v, b, kt * R, hk, T_, Hkv);
    load_row_values(seg_k + st * R, seg, (size_t)b * T_, kt * R, T_);
    cp_async_commit();
  };
  load_tile<D>(qs, q, b, q0, h, T_, Hq);
  load_tile<D>(dos, dout, b, q0, h, T_, Hq);
  load_row_values(seg_q, seg, (size_t)b * T_, q0, T_);
  cp_async_commit();
  issue_kv(0, 0);

  // this lane's two rows: LSE in log2 units, delta (0 past T, masked there)
  const float* lse_bh = lse + ((size_t)b * Hq + h) * T_;
  const float* delta_bh = delta + ((size_t)b * Hq + h) * T_;
  const float lse0 = row0 < T_ ? lse_bh[row0] * kLog2e : 0.f;
  const float lse1 = row1 < T_ ? lse_bh[row1] * kLog2e : 0.f;
  const float dl0 = row0 < T_ ? delta_bh[row0] : 0.f;
  const float dl1 = row1 < T_ ? delta_bh[row1] : 0.f;

  cp_async_wait<1>();
  __syncthreads();
  const int sq0 = seg_q[m0 + g], sq1 = seg_q[m0 + g + 8], seg0 = seg_q[0];
  const bool q_uniform =
      __syncthreads_and(seg_q[threadIdx.x % R] == seg0) && q0 + R <= T_;

  float acc[D / 8][4];
  zero(acc);
  const float sl2 = scale * kLog2e;

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
    const bool fast = __syncthreads_and(sk[threadIdx.x % R] == seg0) && q_uniform &&
                      k0 + R <= T_ && (!causal || k0 + R <= q0);

    float s[R / 8][4];
    zero(s);
    gemm_nt<D, R>(s, qs, m0, kst, 0);
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + t2 + (e & 1);
        const bool ok =
            fast || visible(e < 2 ? row0 : row1, k0 + c, T_, e < 2 ? sq0 : sq1, sk[c], causal);
        s[j][e] = ok ? exp2f(s[j][e] * sl2 - (e < 2 ? lse0 : lse1)) : 0.f;
      }
    float dp[R / 8][4];
    zero(dp);
    gemm_nt<D, R>(dp, dos, m0, vst, 0);
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - (e < 2 ? dl0 : dl1));
    gemm_pv<D, R>(acc, dp, kst, 0);  // dq += dS K
    __syncthreads();  // stage st is consumed
  }
  store_rows<D>(acc, scale, scale, qs, m0, dq, b, q0 + m0, h, T_, Hq);
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ seg,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int T_, int Hq, int Hkv, int causal,
                          float scale) {
  using namespace mma;
  constexpr int R = kRows;
  constexpr int NC = 16;  // q columns per step of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);                // [64][D] this block's keys
  bf16* vs = ks + R * D;                                   // [64][D]
  bf16* qs = vs + R * D;                                   // [2][64][D] streamed q tiles
  bf16* dos = qs + 2 * R * D;                              // [2][64][D]
  int* seg_k = reinterpret_cast<int*>(dos + 2 * R * D);    // [64]
  int* seg_q = seg_k + R;                                  // [2][64]
  float* lse_s = reinterpret_cast<float*>(seg_q + 2 * R);  // [2][64]
  float* dl_s = lse_s + 2 * R;                             // [2][64]

  const int n_tiles = (T_ + R - 1) / R;
  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int rep = Hq / Hkv;
  const int k0 = kt * R;
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int m0 = (threadIdx.x >> 5) * 16;
  const int krow0 = k0 + m0 + g, krow1 = krow0 + 8;
  const int qt0 = causal ? kt : 0, nq = n_tiles - qt0, n_it = rep * nq;

  // step i: q head hk * rep + i / nq, q tile qt0 + i % nq
  auto issue_q = [&](int i, int st) {
    const int h = hk * rep + i / nq, q0 = (qt0 + i % nq) * R;
    const size_t bh = ((size_t)b * Hq + h) * T_;
    load_tile<D>(qs + st * R * D, q, b, q0, h, T_, Hq);
    load_tile<D>(dos + st * R * D, dout, b, q0, h, T_, Hq);
    load_row_values(seg_q + st * R, seg, (size_t)b * T_, q0, T_);
    load_row_values(lse_s + st * R, lse, bh, q0, T_);
    load_row_values(dl_s + st * R, delta, bh, q0, T_);
    cp_async_commit();
  };
  load_tile<D>(ks, k, b, k0, hk, T_, Hkv);
  load_tile<D>(vs, v, b, k0, hk, T_, Hkv);
  load_row_values(seg_k, seg, (size_t)b * T_, k0, T_);
  cp_async_commit();
  issue_q(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const int sk0 = seg_k[m0 + g], sk1 = seg_k[m0 + g + 8], seg0 = seg_k[0];
  const bool k_uniform =
      __syncthreads_and(seg_k[threadIdx.x % R] == seg0) && k0 + R <= T_;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (qt0 + it % nq) * R;
    if (it + 1 < n_it) {
      issue_q(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int* sq = seg_q + st * R;
    const float* lse_q = lse_s + st * R;
    const float* dl_q = dl_s + st * R;
    const bf16* qst = qs + st * R * D;
    const bf16* dost = dos + st * R * D;
    const bool fast = __syncthreads_and(sq[threadIdx.x % R] == seg0) && k_uniform &&
                      q0 + R <= T_ && (!causal || k0 + R <= q0);

#pragma unroll 1  // unrolled, the 4 steps' smem addresses stay live and spill
    for (int c0 = 0; c0 < R; c0 += NC) {
      // P^T: rows are this warp's keys, columns the queries c0..c0 + NC - 1
      float p[NC / 8][4];
      zero(p);
      gemm_nt<D, NC>(p, ks, m0, qst, c0);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + t2 + (e & 1);
          const bool ok = fast || visible(q0 + c, e < 2 ? krow0 : krow1, T_, sq[c],
                                          e < 2 ? sk0 : sk1, causal);
          p[j][e] = ok ? exp2f(p[j][e] * sl2 - lse_q[c] * kLog2e) : 0.f;
        }
      gemm_pv<D, NC>(dv_acc, p, dost, c0);
      float ds[NC / 8][4];  // dP^T, then dS^T
      zero(ds);
      gemm_nt<D, NC>(ds, vs, m0, dost, c0);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + t2 + (e & 1);
          ds[j][e] = p[j][e] * (ds[j][e] - dl_q[c]);
        }
      gemm_pv<D, NC>(dk_acc, ds, qst, c0);
    }
    __syncthreads();  // stage st is consumed
  }
  store_rows<D>(dk_acc, scale, scale, ks, m0, dk, b, k0 + m0, hk, T_, Hkv);
  store_rows<D>(dv_acc, 1.f, 1.f, vs, m0, dv, b, k0 + m0, hk, T_, Hkv);
}

// -- f32: CUDA cores -------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(f32::kThreads)
    flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ seg,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int T_,
                        int Hq, int Hkv, int causal, float scale) {
  using namespace f32;
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;             // [64][D + 1]
  float* dos = qs + kTile * LD;   // [64][D + 1]
  float* ks = dos + kTile * LD;   // [64][D + 1]
  float* vs = ks + kTile * LD;    // [64][D + 1]
  float* dss = vs + kTile * LD;   // [64][65] ds
  int* seg_q = reinterpret_cast<int*>(dss + kTile * kPLd);
  int* seg_k = seg_q + kTile;
  float* lse_s = reinterpret_cast<float*>(seg_k + kTile);
  float* delta_s = lse_s + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTile;
  const int tx = tx_of(), ty = ty_of();
  load_tile<D>(q, b, q0, h, T_, Hq, qs);
  load_tile<D>(dout, b, q0, h, T_, Hq, dos);
  load_seg(seg, b, q0, T_, seg_q);
  load_rows(lse, b, h, q0, T_, Hq, lse_s);
  load_rows(delta, b, h, q0, T_, Hq, delta_s);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) acc[i][jd] = 0.f;

  const int n_tiles = (T_ + kTile - 1) / kTile;
  const int n_kt = causal ? min(qt + 1, n_tiles) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(k, b, k0, hk, T_, Hkv, ks);
    load_tile<D>(v, b, k0, hk, T_, Hkv, vs);
    load_seg(seg, b, k0, T_, seg_k);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, ks, s);
    tile_dot<D>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, T_, seg_q[r], seg_k[c], causal);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * kPLd + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_acc<D>(dss, ks, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_) continue;
    float* dst = dq + row_off(b, t, h, T_, Hq, D);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) dst[tx + 16 * jd] = acc[i][jd] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(f32::kThreads)
    flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int T_, int Hq, int Hkv, int causal,
                         float scale) {
  using namespace f32;
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;             // [64][D + 1] this block's keys
  float* vs = ks + kTile * LD;    // [64][D + 1]
  float* qs = vs + kTile * LD;    // [64][D + 1] the current q tile
  float* dos = qs + kTile * LD;   // [64][D + 1]
  float* pts = dos + kTile * LD;  // [64][65] p, transposed: [key][query]
  float* dsts = pts + kTile * kPLd;  // [64][65] ds, transposed
  int* seg_k = reinterpret_cast<int*>(dsts + kTile * kPLd);
  int* seg_q = seg_k + kTile;
  float* lse_s = reinterpret_cast<float*>(seg_q + kTile);
  float* delta_s = lse_s + kTile;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int k0 = kt * kTile;
  const int tx = tx_of(), ty = ty_of();
  load_tile<D>(k, b, k0, hk, T_, Hkv, ks);
  load_tile<D>(v, b, k0, hk, T_, Hkv, vs);
  load_seg(seg, b, k0, T_, seg_k);

  // this thread's key rows ty + 16 i, columns tx + 16 jd
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;

  const int n_tiles = (T_ + kTile - 1) / kTile;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<D>(q, b, q0, h, T_, Hq, qs);
      load_tile<D>(dout, b, q0, h, T_, Hq, dos);
      load_seg(seg, b, q0, T_, seg_q);
      load_rows(lse, b, h, q0, T_, Hq, lse_s);
      load_rows(delta, b, h, q0, T_, Hq, delta_s);
      __syncthreads();
      float st[4][4], dpt[4][4];  // [key row][query column]
      tile_dot<D>(ks, qs, st);
      tile_dot<D>(vs, dos, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool ok = visible(q0 + r, k0 + c, T_, seg_q[r], seg_k[c], causal);
          const float p = ok ? expf(st[i][j] * scale - lse_s[r]) : 0.f;
          pts[c * kPLd + r] = p;
          dsts[c * kPLd + r] = p * (dpt[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      tile_acc<D>(pts, dos, dv_acc);
      tile_acc<D>(dsts, qs, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T_) continue;
    float* dk_row = dk + row_off(b, t, hk, T_, Hkv, D);
    float* dv_row = dv + row_off(b, t, hk, T_, Hkv, D);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      dk_row[tx + 16 * jd] = dk_acc[i][jd] * scale;
      dv_row[tx + 16 * jd] = dv_acc[i][jd];
    }
  }
}

// -- launchers -------------------------------------------------------------------

template <typename T, int D>
int launch_delta(const void* o, const void* dout, void* delta, int B, int T_, int Hq,
                 cudaStream_t st) {
  const int n_rows = B * T_ * Hq;
  const int rows_per_block = kDeltaThreads / 32;
  flash_delta_kernel<T, D><<<(n_rows + rows_per_block - 1) / rows_per_block,
                             kDeltaThreads, 0, st>>>((const T*)o, (const T*)dout,
                                                     (float*)delta, n_rows, T_, Hq);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* seg,
                   const void* dout, const void* lse, const void* delta, void* dq, int B,
                   int T_, int Hq, int Hkv, int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = mma::smem_bytes<D>(6, 3);  // q, do, 2 x (k, v); 3 x 64 ids
  cudaError_t e = allow_smem(flash_dq_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (T_ + mma::kRows - 1) / mma::kRows);
  flash_dq_bf16_kernel<D><<<grid, mma::kThreads, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, T_, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* seg,
                    const void* dout, const void* lse, const void* delta, void* dk,
                    void* dv, int B, int T_, int Hq, int Hkv, int causal, float scale,
                    cudaStream_t st) {
  // k, v, 2 x (q, do); 64 k ids and 2 x 64 each of q ids, LSE, delta
  constexpr size_t smem = mma::smem_bytes<D>(6, 7);
  cudaError_t e = allow_smem(flash_dkv_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hkv, B, (T_ + mma::kRows - 1) / mma::kRows);
  flash_dkv_bf16_kernel<D><<<grid, mma::kThreads, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, T_, Hq, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* seg,
                  const void* dout, const void* lse, const void* delta, void* dq, int B,
                  int T_, int Hq, int Hkv, int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = f32::smem_bytes<D>(4, 1);
  cudaError_t e = allow_smem(flash_dq_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + f32::kTile - 1) / f32::kTile, Hq, B);
  flash_dq_f32_kernel<D><<<grid, f32::kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)seg,
      (const float*)dout, (const float*)lse, (const float*)delta, (float*)dq, T_, Hq, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* seg,
                   const void* dout, const void* lse, const void* delta, void* dk,
                   void* dv, int B, int T_, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t st) {
  constexpr size_t smem = f32::smem_bytes<D>(4, 2);
  cudaError_t e = allow_smem(flash_dkv_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + f32::kTile - 1) / f32::kTile, Hkv, B);
  flash_dkv_f32_kernel<D><<<grid, f32::kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)seg,
      (const float*)dout, (const float*)lse, (const float*)delta, (float*)dk, (float*)dv,
      T_, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// The instance of the dtype code (0 = float32: F32<D>, 1 = bfloat16:
// BF16<D>) for D in {64, 128}; anything else is refused.
#define POLYRL_DISPATCH(dtype, D, F32, BF16, ...)                     \
  do {                                                                \
    if ((dtype) == 0 && (D) == 64) return F32<64>(__VA_ARGS__);       \
    if ((dtype) == 0 && (D) == 128) return F32<128>(__VA_ARGS__);     \
    if ((dtype) == 1 && (D) == 64) return BF16<64>(__VA_ARGS__);      \
    if ((dtype) == 1 && (D) == 128) return BF16<128>(__VA_ARGS__);    \
    return (int)cudaErrorInvalidValue;                                \
  } while (0)

template <int D> int launch_delta_f32(const void* o, const void* dout, void* delta, int B,
                                      int T_, int Hq, cudaStream_t st) {
  return launch_delta<float, D>(o, dout, delta, B, T_, Hq, st);
}
template <int D> int launch_delta_bf16(const void* o, const void* dout, void* delta, int B,
                                       int T_, int Hq, cudaStream_t st) {
  return launch_delta<bf16, D>(o, dout, delta, B, T_, Hq, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}; Hq a multiple of Hkv;
// q, k, v, do 16-byte aligned (checked by the Python wrapper, ops/flash.py).
extern "C" int polyrl_flash_attention_bwd_delta(const void* o, const void* dout,
                                                void* delta, int dtype, int B, int T_,
                                                int Hq, int D, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  POLYRL_DISPATCH(dtype, D, launch_delta_f32, launch_delta_bf16, o, dout, delta, B, T_, Hq,
                  (cudaStream_t)stream);
}

extern "C" int polyrl_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* seg, const void* dout,
                                             const void* lse, const void* delta, void* dq,
                                             int dtype, int B, int T_, int Hq, int Hkv,
                                             int D, int causal, float scale, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  POLYRL_DISPATCH(dtype, D, launch_dq_f32, launch_dq_bf16, q, k, v, seg, dout, lse, delta,
                  dq, B, T_, Hq, Hkv, causal, scale, (cudaStream_t)stream);
}

extern "C" int polyrl_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* seg, const void* dout,
                                              const void* lse, const void* delta, void* dk,
                                              void* dv, int dtype, int B, int T_, int Hq,
                                              int Hkv, int D, int causal, float scale,
                                              void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  POLYRL_DISPATCH(dtype, D, launch_dkv_f32, launch_dkv_bf16, q, k, v, seg, dout, lse, delta,
                  dk, dv, B, T_, Hq, Hkv, causal, scale, (cudaStream_t)stream);
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
