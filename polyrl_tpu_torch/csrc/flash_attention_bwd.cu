// Training flash attention, backward: dq, dk, dv from the forward's LSE.
//
// Replaces: the backward of polyrl_tpu/ops/flash.py:flash_attention_train,
//   JAX's bundled TPU kernel's _flash_attention_bwd_dkv and
//   _flash_attention_bwd_dq pallas_calls
//   (jax/experimental/pallas/ops/tpu/flash_attention.py).
// Computes, with p = exp(q . k * scale - lse) on visible pairs and 0 else:
//   delta[b, h, i] = sum_d do[b, i, h, d] * o[b, i, h, d]          (delta)
//   ds = p * (do . v - delta)
//   dq[i] = scale * sum_j ds[i, j] k[j]                               (dq)
//   dv[j] = sum_{h in kv head, i} p[i, j] do[i]
//   dk[j] = scale * sum_{h in kv head, i} ds[i, j] q[i]               (dkv)
//   The GQA gradient of a kv head is the sum over its rep query heads (the
//   VJP of the JAX wrapper's jnp.repeat).
// Bound on the H100: at the train phase's shapes (B 4, T 512, Hq 16, Hkv 8,
//   D 128, bf16) it moves about 51 MB (0.015 ms at 3.35 TB/s) and does
//   10.7 GFLOP under the causal segment mask (0.011 ms at 989 TFLOP/s); at
//   T 4096 (B 1) the flops bound it (0.057 ms for the long case's pairs).
//   The Ampere-style kernel this one replaced spent two thirds of its time
//   in dk/dv, bound by shared-memory reads (0.75 ldmatrix.x4 a product)
//   and, at rep 8, by its grid: one block a (kv head, batch, k tile) walked
//   all 8 q heads and every q tile in series, 128 blocks on 132 SMs.
// Design, the TPU kernel's split into a dq call and a dkv call, one
//   instance per dtype:
//   bf16 (the training path), on Hopper's own instructions
//   (flash_wgmma.cuh): blocks of one consumer warpgroup and one producer
//   warp that copies tiles by TMA into an mbarrier ring (its lanes load
//   the row values: ids, LSE, delta); every product a
//   wgmma with its shared-memory operands read by descriptor and P or dS
//   the register A operand, in two bf16 terms (split_a: rounded once,
//   they moved the train phase's full-model gradient gate on bf16 weights
//   past its norm-ratio limit). dq: one block per (q tile, q head, batch),
//   heaviest q tile first; Q and dO copied once, K/V tiles streamed; per
//   tile S = Q K^T and dP = dO V^T, dS = P (dP - delta) in registers,
//   dq += dS K. dk/dv: the warpgroup owns 64 k rows (K and V copied once)
//   and streams Q, dO, their ids, LSE and delta tile by tile: S^T = K Q^T
//   and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q, with no
//   transposed copy anywhere (the MN-major descriptor reads Q and dO as
//   the reduction's rows). A kv head's rep q heads are spread over
//   n_split blocks (rep / n_split heads each, the wrapper's choice from
//   the shapes, so that the grid fills the card): each writes its f32
//   partial dk, dv, and flash_dkv_sum_kernel adds the n_split partials in
//   split order. No float atomics: the backward is bitwise the same from
//   call to call. With n_split 1 the block writes bf16 dk, dv itself. In
//   both kernels a tile pair whose segment-id ranges are disjoint is never
//   copied nor computed, and a pair strictly off the diagonal with one id
//   throughout skips the per-element mask (flash_wgmma.cuh): a mask
//   evaluated on every tile, branch-free, took half of dk/dv's time.
//   f32 (gradient checks on an f32 copy of the weights): the CUDA-core
//   kernels of flash_f32.cuh, exact f32; the tensor cores have no f32
//   mode without TF32. Not a fallback: each dtype has its one kernel.
//   The delta kernel is one warp per row for both.
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace polyrl_flash;
using wg::bf16;

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


// -- bf16: wgmma and TMA -------------------------------------------------------

constexpr int kDqStages = 2;
constexpr int kDkvStages = 2;

// Q, dO, kDqStages x (K, V) tiles; 64 q ids and kDqStages x 64 k ids; the
// barriers; 1024 bytes for the alignment.
template <int D> constexpr size_t dq_smem() {
  return 1024 + (size_t)(2 + 2 * kDqStages) * wg::tile_bytes<D>() +
         (size_t)(1 + kDqStages) * wg::kVecBytes + (size_t)(1 + 2 * kDqStages) * 8;
}

// K, V, kDkvStages x (Q, dO) tiles; 64 k ids and kDkvStages x 64 each of q
// ids, LSE and delta; the barriers; 1024 bytes for the alignment.
template <int D> constexpr size_t dkv_smem() {
  return 1024 + (size_t)(2 + 2 * kDkvStages) * wg::tile_bytes<D>() +
         (size_t)(1 + 3 * kDkvStages) * wg::kVecBytes + (size_t)(1 + 2 * kDkvStages) * 8;
}

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 2)
    flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const int* __restrict__ seg, const int2* __restrict__ range,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq, int T_,
                         int Hq, int Hkv, int causal, float scale) {
  using namespace wg;
  constexpr int S = kDqStages, TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* dos = reinterpret_cast<bf16*>(sm + TB);
  bf16* ks = reinterpret_cast<bf16*>(sm + 2 * TB);            // [S] tiles
  bf16* vs = reinterpret_cast<bf16*>(sm + (2 + S) * TB);      // [S] tiles
  int* seg_q = reinterpret_cast<int*>(sm + (2 + 2 * S) * TB);
  int* seg_k = seg_q + kRows;                                 // [S][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(seg_k + S * kRows);
  uint64_t* full = q_full + 1;                                // [S]
  uint64_t* empty = full + S;                                 // [S]

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
      bar_expect(q_full, 2 * TB);
      load_tile<D>(qs, &q_map, q_full, b, q0, h);
      load_tile<D>(dos, &do_map, q_full, b, q0, h);
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

  // the consumer warpgroup: this thread's rows r0 and r0 + 8 of the q tile,
  // their LSE in log2 units and delta (0 past T, masked there)
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = 16 * warp + g, row0 = q0 + r0, row1 = row0 + 8;
  const float* lse_bh = lse + ((size_t)b * Hq + h) * T_;
  const float* delta_bh = delta + ((size_t)b * Hq + h) * T_;
  const float lse_r[2] = {row0 < T_ ? lse_bh[row0] * kLog2e : 0.f,
                          row1 < T_ ? lse_bh[row1] * kLog2e : 0.f};
  const float dl_r[2] = {row0 < T_ ? delta_bh[row0] : 0.f, row1 < T_ ? delta_bh[row1] : 0.f};
  bar_wait(q_full, 0);
  const int sq0 = seg_q[r0], sq1 = seg_q[r0 + 8];

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float sl2 = scale * kLog2e;

  Ring<S> ring;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int2 kr = rng[kt];
    if (!ranges_meet(qr, kr)) continue;
    const int st = ring.stage(), k0 = kt * kRows;
    const bf16* kst = ks + st * kRows * D;
    bar_wait(full + st, ring.parity());

    // S first, dP behind it: the softmax of S runs while dP computes
    float s[32], dp[32];
    wg_fence();
    wgmma_ss<D>(s, qs, kst);
    wg_commit();
    wgmma_ss<D>(dp, dos, vs + st * kRows * D);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);

    uint32_t ok = 0xffffffffu;  // bit i: element i visible
    if (!tile_is_uniform(qr, kr, qt, kt, T_, causal))
      ok = visible_bits(row0, row1, sq0, sq1, k0 + t2, seg_k + st * kRows + t2, T_, causal,
                        false);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = (ok >> i) & 1u ? exp2f(s[i] * sl2 - lse_r[(i >> 1) & 1]) : 0.f;  // P
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl_r[(i >> 1) & 1]);  // dS
    uint32_t hi[4][4], lo[4][4];
    split_a(dp, hi, lo);
    fence_regs(acc);
    wg_fence();
    wgmma_rs<D>(acc, hi, lo, kst);  // dq += dS K
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    bar_arrive(empty + st);
    ++ring.i;
  }
  store_bf16<D>(acc, scale, scale, dq, b, q0, h, T_, Hq);
}

// One block per (kv head x split, batch, k tile); the block's q heads are
// kv head hk's rep / n_split heads of split sp.
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const int* __restrict__ seg, const float* __restrict__ lse,
                          const float* __restrict__ delta, const int2* __restrict__ range,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ part, int B, int T_,
                          int Hq, int Hkv, int causal, int n_split, float scale) {
  using namespace wg;
  constexpr int S = kDkvStages, TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(sm);
  bf16* vs = reinterpret_cast<bf16*>(sm + TB);
  bf16* qs = reinterpret_cast<bf16*>(sm + 2 * TB);            // [S] tiles
  bf16* dos = reinterpret_cast<bf16*>(sm + (2 + S) * TB);     // [S] tiles
  int* seg_k = reinterpret_cast<int*>(sm + (2 + 2 * S) * TB);
  int* seg_q = seg_k + kRows;                                 // [S][64]
  float* lse_s = reinterpret_cast<float*>(seg_q + S * kRows);  // [S][64]
  float* dl_s = lse_s + S * kRows;                            // [S][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + S * kRows);
  uint64_t* full = kv_full + 1;                               // [S]
  uint64_t* empty = full + S;                                 // [S]

  const int n_tiles = (T_ + kRows - 1) / kRows;
  const int rep = Hq / Hkv, hpb = rep / n_split;
  const int hk = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const int b = blockIdx.y, kt = blockIdx.z, k0 = kt * kRows;
  const int h0 = hk * rep + sp * hpb;
  const int qt0 = causal ? kt : 0;
  const int2* rng = range + (size_t)b * n_tiles;
  const int2 kr = rng[kt];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 32);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 32);
      bar_init(empty + s, 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    const size_t sb = (size_t)b * T_;
    warp_load_rows(seg_k, seg, sb, k0, T_);
    if (lane == 0) {
      bar_expect(kv_full, 2 * TB);
      load_tile<D>(ks, &k_map, kv_full, b, k0, hk);
      load_tile<D>(vs, &v_map, kv_full, b, k0, hk);
    } else {
      bar_arrive(kv_full);
    }
    Ring<S> ring;
    for (int hh = 0; hh < hpb; ++hh) {
      const int h = h0 + hh;
      const size_t bh = ((size_t)b * Hq + h) * T_;
      for (int qt = qt0; qt < n_tiles; ++qt) {
        if (!ranges_meet(rng[qt], kr)) continue;
        const int st = ring.stage(), q0 = qt * kRows;
        bar_wait(empty + st, ring.parity() ^ 1);
        warp_load_rows(seg_q + st * kRows, seg, sb, q0, T_);
        warp_load_rows(lse_s + st * kRows, lse, bh, q0, T_, kLog2e);
        warp_load_rows(dl_s + st * kRows, delta, bh, q0, T_);
        if (lane == 0) {
          bar_expect(full + st, 2 * TB);
          load_tile<D>(qs + st * kRows * D, &q_map, full + st, b, q0, h);
          load_tile<D>(dos + st * kRows * D, &do_map, full + st, b, q0, h);
        } else {
          bar_arrive(full + st);
        }
        ++ring.i;
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's key rows r0 and r0 + 8 of the tile
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = 16 * warp + g, krow0 = k0 + r0;
  bar_wait(kv_full, 0);
  const int sk0 = seg_k[r0], sk1 = seg_k[r0 + 8];

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float sl2 = scale * kLog2e;

  Ring<S> ring;
  for (int hh = 0; hh < hpb; ++hh) {
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int2 qr = rng[qt];
      if (!ranges_meet(qr, kr)) continue;
      const int st = ring.stage(), q0 = qt * kRows;
      const bf16* qst = qs + st * kRows * D;
      const bf16* dost = dos + st * kRows * D;
      bar_wait(full + st, ring.parity());

      // P^T and dP^T: rows are this block's keys, columns the tile's
      // queries; P^T's softmax runs while dP^T computes
      float pt[32], dpt[32];
      wg_fence();
      wgmma_ss<D>(pt, ks, qst);
      wg_commit();
      wgmma_ss<D>(dpt, vs, dost);
      wg_commit();
      wg_wait<1>();
      fence_regs(pt);

      // bit i: element i visible; rows are keys here, columns queries
      uint32_t ok = 0xffffffffu;
      if (!tile_is_uniform(qr, kr, qt, kt, T_, causal))
        ok = visible_bits(krow0, krow0 + 8, sk0, sk1, q0 + t2, seg_q + st * kRows + t2, T_,
                          causal, true);
      const float* lq = lse_s + st * kRows + t2;  // LSE in log2 units
      const float* dl = dl_s + st * kRows + t2;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        pt[i] = (ok >> i) & 1u ? exp2f(pt[i] * sl2 - lq[8 * (i >> 2) + (i & 1)]) : 0.f;
      uint32_t hi[4][4], lo[4][4];
      split_a(pt, hi, lo);
      wg_wait<0>();
      fence_regs(dpt);
      fence_regs(dv_acc);
      wg_fence();
      wgmma_rs<D>(dv_acc, hi, lo, dost);  // dV += P^T dO, while dS^T is formed
      wg_commit();
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dpt[i] = pt[i] * (dpt[i] - dl[8 * (i >> 2) + (i & 1)]);  // dS^T
      wg_wait<0>();
      fence_regs(dv_acc);
      fence_regs(hi);
      fence_regs(lo);
      split_a(dpt, hi, lo);
      fence_regs(dk_acc);
      wg_fence();
      wgmma_rs<D>(dk_acc, hi, lo, qst);  // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      fence_regs(dk_acc);
      fence_regs(hi);
      fence_regs(lo);
      bar_arrive(empty + st);
      ++ring.i;
    }
  }
  if (n_split == 1) {
    store_bf16<D>(dk_acc, scale, scale, dk, b, k0, hk, T_, Hkv);
    store_bf16<D>(dv_acc, 1.f, 1.f, dv, b, k0, hk, T_, Hkv);
  } else {  // part: [2][n_split][B, T, Hkv, D] f32, dk's partials then dv's
    const size_t n = (size_t)B * T_ * Hkv * D;
    store_f32<D>(dk_acc, scale, part + sp * n, b, k0, hk, T_, Hkv);
    store_f32<D>(dv_acc, 1.f, part + (n_split + sp) * n, b, k0, hk, T_, Hkv);
  }
}

constexpr int kSumThreads = 256;

// dk, dv (bf16) = the sum of the n_split partials in split order, 4
// elements a thread (n4 = B * T * Hkv * D / 4). Replaces no TPU kernel: the
// TPU kernel summed a kv head's q heads along its sequential grid, which a
// card's blocks cannot share; this fixed-order second pass keeps the sum
// the same every call. Bound by bytes: 2 n_split f32 partials read and 2
// bf16 results written an element (16 MB at rep 8's train shapes, split 2:
// 0.005 ms at 3.35 TB/s).
__global__ void __launch_bounds__(kSumThreads)
    flash_dkv_sum_kernel(const float4* __restrict__ part, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int n_split, size_t n4) {
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n4) return;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float4* src = part + (size_t)w * n_split * n4 + i;
    float4 a = src[0];
    for (int s = 1; s < n_split; ++s) {
      const float4 x = src[(size_t)s * n4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    *reinterpret_cast<uint2*>((w ? dv : dk) + 4 * i) =
        make_uint2(wg::pack_bf16(a.x, a.y), wg::pack_bf16(a.z, a.w));
  }
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
                   const void* dout, const void* lse, const void* delta, const void* range,
                   void* dq, int B, int T_, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t st) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = wg::rows_map(&q_map, q, B, T_, Hq, D);
  if (!e) e = wg::rows_map(&k_map, k, B, T_, Hkv, D);
  if (!e) e = wg::rows_map(&v_map, v, B, T_, Hkv, D);
  if (!e) e = wg::rows_map(&do_map, dout, B, T_, Hq, D);
  if (e) return e;
  constexpr size_t smem = dq_smem<D>();
  cudaError_t ce = allow_smem(flash_dq_bf16_kernel<D>, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(Hq, B, (T_ + wg::kRows - 1) / wg::kRows);
  flash_dq_bf16_kernel<D><<<grid, wg::kThreads, smem, st>>>(
      q_map, k_map, v_map, do_map, (const int*)seg, (const int2*)range, (const float*)lse,
      (const float*)delta, (bf16*)dq, T_, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* seg,
                    const void* dout, const void* lse, const void* delta, const void* range,
                    void* dk, void* dv, void* part, int B, int T_, int Hq, int Hkv,
                    int causal, int n_split, float scale, cudaStream_t st) {
  if (n_split < 1 || (Hq / Hkv) % n_split || (n_split > 1 && !part))
    return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = wg::rows_map(&q_map, q, B, T_, Hq, D);
  if (!e) e = wg::rows_map(&k_map, k, B, T_, Hkv, D);
  if (!e) e = wg::rows_map(&v_map, v, B, T_, Hkv, D);
  if (!e) e = wg::rows_map(&do_map, dout, B, T_, Hq, D);
  if (e) return e;
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t ce = allow_smem(flash_dkv_bf16_kernel<D>, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(Hkv * n_split, B, (T_ + wg::kRows - 1) / wg::kRows);
  flash_dkv_bf16_kernel<D><<<grid, wg::kThreads, smem, st>>>(
      q_map, k_map, v_map, do_map, (const int*)seg, (const float*)lse, (const float*)delta,
      (const int2*)range,
      (bf16*)dk, (bf16*)dv, (float*)part, B, T_, Hq, Hkv, causal, n_split, scale);
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

// FN<64> or FN<128> for D in {64, 128}; anything else is refused.
#define POLYRL_BY_D(D, FN, ...)                                \
  do {                                                         \
    if ((D) == 64) return FN<64>(__VA_ARGS__);                 \
    if ((D) == 128) return FN<128>(__VA_ARGS__);               \
    return (int)cudaErrorInvalidValue;                         \
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
// q, k, v and do 16-byte aligned, as TMA needs (checked by the Python
// wrapper, ops/flash.py). range: the forward library's
// polyrl_flash_segment_ranges of seg (bf16 only; the f32 kernels ignore
// it, and part and n_split).

extern "C" int polyrl_flash_attention_bwd_delta(const void* o, const void* dout,
                                                void* delta, int dtype, int B, int T_,
                                                int Hq, int D, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) POLYRL_BY_D(D, launch_delta_f32, o, dout, delta, B, T_, Hq, st);
  if (dtype == 1) POLYRL_BY_D(D, launch_delta_bf16, o, dout, delta, B, T_, Hq, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int polyrl_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* seg, const void* dout,
                                             const void* lse, const void* delta,
                                             const void* range, void* dq, int dtype, int B,
                                             int T_, int Hq, int Hkv, int D, int causal,
                                             float scale, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    POLYRL_BY_D(D, launch_dq_f32, q, k, v, seg, dout, lse, delta, dq, B, T_, Hq, Hkv, causal,
                scale, st);
  if (dtype == 1)
    POLYRL_BY_D(D, launch_dq_bf16, q, k, v, seg, dout, lse, delta, range, dq, B, T_, Hq, Hkv,
                causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// part: f32 [2, n_split, B, T, Hkv, D] when n_split > 1 (bf16 only); then
// dk and dv are written by polyrl_flash_attention_bwd_dkv_sum.
extern "C" int polyrl_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* seg, const void* dout,
                                              const void* lse, const void* delta,
                                              const void* range, void* dk, void* dv,
                                              void* part, int dtype, int B, int T_, int Hq,
                                              int Hkv, int D, int causal, int n_split,
                                              float scale, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    POLYRL_BY_D(D, launch_dkv_f32, q, k, v, seg, dout, lse, delta, dk, dv, B, T_, Hq, Hkv,
                causal, scale, st);
  if (dtype == 1)
    POLYRL_BY_D(D, launch_dkv_bf16, q, k, v, seg, dout, lse, delta, range, dk, dv, part, B,
                T_, Hq, Hkv, causal, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}

// dk, dv (bf16 [B, T, Hkv, D]) = the n_split partials of part summed in
// split order.
extern "C" int polyrl_flash_attention_bwd_dkv_sum(const void* part, void* dk, void* dv,
                                                  int B, int T_, int Hkv, int D, int n_split,
                                                  void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  if (n_split < 2 || D % 4) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)B * T_ * Hkv * D / 4;
  flash_dkv_sum_kernel<<<(unsigned)((n4 + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                         (cudaStream_t)stream>>>((const float4*)part, (bf16*)dk, (bf16*)dv,
                                                 n_split, n4);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 kernel (0 = dq, 1 = dk/dv) at head dim D,
// in bytes.
extern "C" int polyrl_flash_attention_bwd_smem(int kernel, int D) {
  if (D != 64 && D != 128) return -1;
  if (kernel == 0) return D == 64 ? (int)dq_smem<64>() : (int)dq_smem<128>();
  if (kernel == 1) return D == 64 ? (int)dkv_smem<64>() : (int)dkv_smem<128>();
  return -1;
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
