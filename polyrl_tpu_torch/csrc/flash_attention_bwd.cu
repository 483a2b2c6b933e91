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
//   10.7 GFLOP under the causal mask (0.011 ms at 989 TFLOP/s); at T 4096
//   the flops bound it.
// Design: the TPU kernel's split into a dq call and a dkv call, as two
//   kernels that share nothing. dq: one block per (q tile, q head, batch),
//   looping over the K/V tiles up to the diagonal. dk/dv: one block per
//   (k tile, kv head, batch), looping over the rep q heads and over the q
//   tiles from the diagonal on, with dk and dv accumulated in registers.
//   Tiles are staged in shared memory as f32 and the products run on CUDA
//   cores (flash_common.cuh); tensor cores and TMA are later work.
#include "flash_common.cuh"

namespace {

using namespace polyrl_flash;

// delta[b, h, t] = sum_d do * o in f32: one warp per (b, t, h) row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int T_, int Hq) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ seg,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int T_, int Hq,
                    int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [64][D + 1]
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
  load_tile<T, D>(q, b, q0, h, T_, Hq, qs);
  load_tile<T, D>(dout, b, q0, h, T_, Hq, dos);
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
    load_tile<T, D>(k, b, k0, hk, T_, Hkv, ks);
    load_tile<T, D>(v, b, k0, hk, T_, Hkv, vs);
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
    T* dst = dq + row_off(b, t, h, T_, Hq, D);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) dst[tx + 16 * jd] = from_f32<T>(acc[i][jd] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int T_, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [64][D + 1] this block's keys
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
  load_tile<T, D>(k, b, k0, hk, T_, Hkv, ks);
  load_tile<T, D>(v, b, k0, hk, T_, Hkv, vs);
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
      load_tile<T, D>(q, b, q0, h, T_, Hq, qs);
      load_tile<T, D>(dout, b, q0, h, T_, Hq, dos);
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
    T* dk_row = dk + row_off(b, t, hk, T_, Hkv, D);
    T* dv_row = dv + row_off(b, t, hk, T_, Hkv, D);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      dk_row[tx + 16 * jd] = from_f32<T>(dk_acc[i][jd] * scale);
      dv_row[tx + 16 * jd] = from_f32<T>(dv_acc[i][jd]);
    }
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, void* delta, int B, int T_, int Hq,
                 cudaStream_t st) {
  const int n_rows = B * T_ * Hq;
  const int rows_per_block = kThreads / 32;
  flash_delta_kernel<T, D><<<(n_rows + rows_per_block - 1) / rows_per_block, kThreads,
                             0, st>>>((const T*)o, (const T*)dout, (float*)delta, n_rows,
                                      T_, Hq);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* seg,
              const void* dout, const void* lse, const void* delta, void* dq, int B,
              int T_, int Hq, int Hkv, int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>(4, 1);
  cudaError_t e = allow_smem(flash_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + kTile - 1) / kTile, Hq, B);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, T_, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* seg,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv,
               int B, int T_, int Hq, int Hkv, int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>(4, 2);
  cudaError_t e = allow_smem(flash_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + kTile - 1) / kTile, Hkv, B);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, T_, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// Instantiate F<T, D> for the dtype code (0 = float32, 1 = bfloat16) and
// D in {64, 128}; anything else is refused.
#define POLYRL_DISPATCH(dtype, D, F, ...)                                    \
  do {                                                                       \
    if ((dtype) == 0 && (D) == 64) return F<float, 64>(__VA_ARGS__);         \
    if ((dtype) == 0 && (D) == 128) return F<float, 128>(__VA_ARGS__);       \
    if ((dtype) == 1 && (D) == 64) return F<__nv_bfloat16, 64>(__VA_ARGS__); \
    if ((dtype) == 1 && (D) == 128) return F<__nv_bfloat16, 128>(__VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

}  // namespace

extern "C" int polyrl_flash_attention_bwd_delta(const void* o, const void* dout,
                                                void* delta, int dtype, int B, int T_,
                                                int Hq, int D, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  POLYRL_DISPATCH(dtype, D, launch_delta, o, dout, delta, B, T_, Hq,
                  (cudaStream_t)stream);
}

extern "C" int polyrl_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* seg, const void* dout,
                                             const void* lse, const void* delta, void* dq,
                                             int dtype, int B, int T_, int Hq, int Hkv,
                                             int D, int causal, float scale, void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  POLYRL_DISPATCH(dtype, D, launch_dq, q, k, v, seg, dout, lse, delta, dq, B, T_, Hq, Hkv,
                  causal, scale, (cudaStream_t)stream);
}

extern "C" int polyrl_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* seg, const void* dout,
                                              const void* lse, const void* delta, void* dk,
                                              void* dv, int dtype, int B, int T_, int Hq,
                                              int Hkv, int D, int causal, float scale,
                                              void* stream) {
  if (B <= 0 || T_ <= 0) return 0;
  POLYRL_DISPATCH(dtype, D, launch_dkv, q, k, v, seg, dout, lse, delta, dk, dv, B, T_, Hq,
                  Hkv, causal, scale, (cudaStream_t)stream);
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
