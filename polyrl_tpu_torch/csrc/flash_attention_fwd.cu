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
//   4.3 GFLOP under the causal mask (0.0044 ms at 989 TFLOP/s): bytes bound
//   by a little; at T 4096 the flops bound it.
// Design: one block per (q tile of 64 rows, q head, batch); the block
//   stages its q tile once, then loops over the 64-row K/V tiles of kv head
//   h / rep up to the causal diagonal, keeping the online softmax (m, l) and
//   the 64 x D accumulator in registers, split over 256 threads so that
//   each thread's score rows are its accumulator rows. Products run on CUDA
//   cores in f32 from shared memory. This is the simple first version: the
//   tensor cores (mma.sync / wgmma), TMA and a pipelined K/V ring are later
//   work, and they are what closes the gap to the bound.
#include "flash_common.cuh"

namespace {

using namespace polyrl_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ o, float* __restrict__ lse, int T_, int Hq, int Hkv,
                     int causal, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [64][D + 1]
  float* ks = qs + kTile * LD;       // [64][D + 1]
  float* vs = ks + kTile * LD;       // [64][D + 1]
  float* ps = vs + kTile * LD;       // [64][65] probabilities
  int* seg_q = reinterpret_cast<int*>(ps + kTile * kPLd);
  int* seg_k = seg_q + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTile;
  const int tx = tx_of(), ty = ty_of();
  load_tile<T, D>(q, b, q0, h, T_, Hq, qs);
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
    load_tile<T, D>(k, b, k0, hk, T_, Hkv, ks);
    load_tile<T, D>(v, b, k0, hk, T_, Hkv, vs);
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
    T* dst = o + row_off(b, t, h, T_, Hq, D);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) dst[tx + 16 * jd] = from_f32<T>(acc[i][jd] * inv);
    if (tx == 0) lse[((size_t)b * Hq + h) * T_ + t] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o,
           void* lse, int B, int T_, int Hq, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(3, 1);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + kTile - 1) / kTile, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg, (T*)o, (float*)lse, T_,
      Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* seg,
             void* o, void* lse, int B, int T_, int Hq, int Hkv, int causal, float scale,
             cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}; Hq a multiple of Hkv
// (checked by the Python wrapper, ops/flash.py).
extern "C" int polyrl_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* seg, void* o, void* lse, int dtype,
                                          int B, int T_, int Hq, int Hkv, int D,
                                          int causal, float scale, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
    case 1: return launch_d<__nv_bfloat16>(D, q, k, v, seg, o, lse, B, T_, Hq, Hkv, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
