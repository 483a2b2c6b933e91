// Paged decode attention: one query token per slot over its page-table row.
//
// Replaces: polyrl_tpu/ops/paged_attention.py:paged_attention_pallas
//           (_paged_attn_kernel) and, on the TPU's production path,
//           paged_attention_lib (JAX's bundled multi-page kernel).
// Computes: out[s, h*rep + r] = softmax(q . K^T * scale) V over positions
//   < max(seq_lens[s], 1) of the slot's pages; GQA with rep = Hq / Hkv;
//   f32 online softmax; bf16 (or the input type) output.
// Bound on the H100: the KV bytes read (about 1 flop per byte in bf16).
// Design: one block per (slot, kv head) -- S=64 x Hkv=8 = 512 blocks fill
//   132 SMs. The rep query rows sit in shared memory; the block loops over
//   the slot's ceil(max(len,1)/page_size) pages, staging each page's
//   [page_size, D] K and V tiles in shared memory with cp.async, the next
//   page in flight while the current one is attended (paged_common.cuh).
//   Splitting long rows over several blocks (flash-decoding), TMA and
//   mma/wgmma are later work.
#include "paged_common.cuh"

namespace {

using namespace polyrl;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp, const int* __restrict__ page_table,
                           const int* __restrict__ seq_lens, T* __restrict__ out, int Hq,
                           int Hkv, int N, int ps, int D, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, rep = Hq / Hkv;
  Smem<T> st = carve<T>(smem, rep, D, ps);
  load_q_rows(q, s, h, Hq, rep, D, st.q);
  for (int i = threadIdx.x; i < rep * D; i += kThreads) st.acc[i] = 0.f;
  for (int i = threadIdx.x; i < rep; i += kThreads) {
    st.m[i] = NEG_INF;
    st.l[i] = 0.f;
  }
  __syncthreads();
  const int len = max(seq_lens[s], 1);
  const int n_pages = min((len + ps - 1) / ps, P);
  attend_pages(kp, vp, page_table + (size_t)s * P, 0, n_pages, P, h, N, len, rep, D,
               ps, scale, st);
  store_out(out, s, h, Hq, rep, D, st);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* lens, void* out, int S, int Hq, int Hkv, int N, int ps, int D,
           int P, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(Hq / Hkv, D, ps);
  cudaError_t e = allow_smem(paged_attention_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  paged_attention_kernel<T><<<dim3(S, Hkv), kThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)pt, (const int*)lens,
      (T*)out, Hq, Hkv, N, ps, D, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D must be a multiple of
// 32 and at most 256 (checked by the Python wrapper).
extern "C" int polyrl_paged_attention(const void* q, const void* kp, const void* vp,
                                      const void* page_table, const void* seq_lens,
                                      void* out, int dtype, int S, int Hq, int Hkv,
                                      int N, int ps, int D, int P, float scale,
                                      void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(q, kp, vp, page_table, seq_lens, out, S, Hq, Hkv, N, ps, D, P, scale, st);
    case 1: return launch<__nv_bfloat16>(q, kp, vp, page_table, seq_lens, out, S, Hq, Hkv, N, ps, D, P, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
