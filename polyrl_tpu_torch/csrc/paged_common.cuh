// Shared device code of the paged decode-attention kernels
// (paged_attention.cu, grouped_paged_attention.cu).
//
// Layout: pools are head-major [Hkv, N, page_size, D] (page 0 = null page),
// q is [S, Hq, D] with the rep = Hq / Hkv query heads of kv-head h at
// columns h*rep .. h*rep+rep-1 (GQA). One block of kThreads threads owns
// R query rows of one kv head and walks pages, keeping an f32 online
// softmax (m, l, acc) in shared memory -- the same flash recurrence the
// TPU kernels keep in VMEM scratch across their sequential page grid axis.
// NEG_INF is finite (-FLT_MAX, float32 min as in the JAX code): with -inf
// an empty row's exp(m_prev - m_new) would be NaN.
//
// What bounds these kernels is the KV bytes they read, so each page's K and
// V tiles ([page_size, D] each) are staged whole into shared memory with
// 16-byte cp.async copies, double-buffered: the next page is in flight
// while the current one is attended. Tile rows are padded by 16 bytes so
// that threads reading different key rows hit different banks.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace polyrl {

constexpr float NEG_INF = -FLT_MAX;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 8;  // query rows a thread accumulates in registers
constexpr size_t kMaxSmem = 232448;  // per block on sm_90 (227 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from shared memory, widened to f32.
template <typename T> struct Vec {
  static constexpr int n = 16 / sizeof(T);
};
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory of one block: two stages of K and V page tiles,
// then the online-softmax state of R query rows.
template <typename T> struct Smem {
  T* tiles;      // [2 stages][K, V][ps][D + Vec<T>::n]
  float* q;      // [R, D] query rows, f32
  float* acc;    // [R, D] unnormalised output
  float* m;      // [R] running max
  float* l;      // [R] running denominator
  float* alpha;  // [R] rescale of the current page
  float* p;      // [R, ps] logits, then probabilities
};

template <typename T> __host__ __device__ inline size_t tile_bytes(int D, int ps) {
  return 4 * (size_t)ps * (D * sizeof(T) + 16);
}

template <typename T> inline size_t smem_bytes(int R, int D, int ps) {
  return tile_bytes<T>(D, ps) +
         sizeof(float) * (2 * (size_t)R * D + 3 * (size_t)R + (size_t)R * ps);
}

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* base, int R, int D, int ps) {
  Smem<T> st;
  st.tiles = reinterpret_cast<T*>(base);
  st.q = reinterpret_cast<float*>(base + tile_bytes<T>(D, ps));
  st.acc = st.q + (size_t)R * D;
  st.m = st.acc + (size_t)R * D;
  st.l = st.m + R;
  st.alpha = st.l + R;
  st.p = st.alpha + R;
  return st;
}

// Start the copy of one page's K and V rows (element offset `base` of the
// pools) into stage `stage`, as one cp.async group.
template <typename T>
__device__ __forceinline__ void issue_page(const T* __restrict__ kp,
                                           const T* __restrict__ vp, size_t base,
                                           int D, int ps, int stage, Smem<T> st) {
  constexpr int V = Vec<T>::n;
  const int rs = D + V, vecs = D / V;
  T* ks = st.tiles + (size_t)stage * 2 * ps * rs;
  T* vs = ks + (size_t)ps * rs;
  for (int i = threadIdx.x; i < ps * vecs; i += kThreads) {
    const int t = i / vecs, c = i - t * vecs;
    cp_async16(ks + t * rs + c * V, kp + base + (size_t)t * D + c * V);
    cp_async16(vs + t * rs + c * V, vp + base + (size_t)t * D + c * V);
  }
  cp_async_commit();
}

// Attend the R query rows in st.q to one staged page whose first position
// is pos0; positions >= limit are masked. Every thread of the block calls it.
template <typename T>
__device__ void attend_tile(int stage, int pos0, int limit, int R, int D, int ps,
                            float scale, Smem<T> st) {
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = D + V;
  const T* ks = st.tiles + (size_t)stage * 2 * ps * rs;
  const T* vs = ks + (size_t)ps * rs;
  const int n_chunks = (R + kRowChunk - 1) / kRowChunk;

  // 1. logits: one thread per (key row, chunk of kRowChunk query rows); the
  //    query rows are the same for neighbouring threads (broadcast reads)
  for (int w = tid; w < ps * n_chunks; w += kThreads) {
    const int t = w % ps, r0 = (w / ps) * kRowChunk;
    const int rn = min(kRowChunk, R - r0);
    const T* krow = ks + (size_t)t * rs;
    float dot[kRowChunk];
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j) dot[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += V) {
      float kv[V];
      load16(krow + d0, kv);
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) {
        if (j < rn) {
          const float* qr = st.q + (size_t)(r0 + j) * D + d0;
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            float qv[4];
            load16(qr + e, qv);
            dot[j] += qv[0] * kv[e] + qv[1] * kv[e + 1] + qv[2] * kv[e + 2] +
                      qv[3] * kv[e + 3];
          }
        }
      }
    }
    const bool ok = pos0 + t < limit;
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j)
      if (j < rn) st.p[(size_t)(r0 + j) * ps + t] = ok ? dot[j] * scale : NEG_INF;
  }
  __syncthreads();

  // 2. online-softmax update, one warp per query row
  for (int r = warp; r < R; r += kWarps) {
    float* pr = st.p + (size_t)r * ps;
    float mx = NEG_INF;
    for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_prev = st.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < ps; t += 32) {
      const float e = expf(pr[t] - m_new);
      pr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      st.alpha[r] = a;
      st.l[r] = a * st.l[r] + sum;
      st.m[r] = m_new;
    }
  }
  __syncthreads();

  // 3. acc[r, d] = alpha[r] * acc[r, d] + sum_t p[r, t] * v[t, d]: one
  //    thread per column d, kRowChunk rows in registers per pass
  for (int r0 = 0; r0 < R; r0 += kRowChunk) {
    const int rn = min(kRowChunk, R - r0);
    for (int d = tid; d < D; d += kThreads) {
      float a[kRowChunk];
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j)
        a[j] = j < rn ? st.acc[(size_t)(r0 + j) * D + d] * st.alpha[r0 + j] : 0.f;
#pragma unroll 4
      for (int t = 0; t < ps; ++t) {
        const float vv = to_f32(vs[(size_t)t * rs + d]);
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j)
          if (j < rn) a[j] += st.p[(size_t)(r0 + j) * ps + t] * vv;
      }
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j)
        if (j < rn) st.acc[(size_t)(r0 + j) * D + d] = a[j];
    }
  }
}

// Attend st.q's R rows over n_pages pages of kv head h: page p is
// page_row[min(col0 + p, ncols - 1)] and starts at position (col0 + p) * ps;
// positions >= limit are masked. Double-buffered: page p + 1 is copied
// while page p is attended. Every thread of the block calls it.
template <typename T>
__device__ void attend_pages(const T* __restrict__ kp, const T* __restrict__ vp,
                             const int* __restrict__ page_row, int col0, int n_pages,
                             int ncols, int h, int N, int limit, int R, int D, int ps,
                             float scale, Smem<T> st) {
  auto base_of = [&](int p) {
    const int page = min(max(page_row[min(col0 + p, ncols - 1)], 0), N - 1);
    return ((size_t)h * N + page) * ps * D;
  };
  if (n_pages <= 0) return;
  issue_page(kp, vp, base_of(0), D, ps, 0, st);
  for (int p = 0; p < n_pages; ++p) {
    if (p + 1 < n_pages) {
      issue_page(kp, vp, base_of(p + 1), D, ps, (p + 1) & 1, st);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    attend_tile(p & 1, (col0 + p) * ps, limit, R, D, ps, scale, st);
    __syncthreads();  // stage p & 1 is refilled in the next iteration
  }
}

// Load the rep query rows of (slot s, kv head h) into dst (f32).
template <typename T>
__device__ __forceinline__ void load_q_rows(const T* __restrict__ q, int s, int h,
                                            int Hq, int rep, int D, float* dst) {
  const T* src = q + ((size_t)s * Hq + (size_t)h * rep) * D;
  for (int i = threadIdx.x; i < rep * D; i += kThreads) dst[i] = to_f32(src[i]);
}

// out[r, d] = acc[r, d] / max(l[r], 1e-30) for the rep rows of (s, h).
template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, int s, int h, int Hq,
                                          int rep, int D, Smem<T> st) {
  T* dst = out + ((size_t)s * Hq + (size_t)h * rep) * D;
  for (int i = threadIdx.x; i < rep * D; i += kThreads)
    dst[i] = from_f32<T>(st.acc[i] / fmaxf(st.l[i / D], 1e-30f));
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed;
// more than a block can have is refused.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace polyrl
