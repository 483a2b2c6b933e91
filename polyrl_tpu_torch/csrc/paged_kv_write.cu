// Paged K/V write for one decode step: for each slot s, copy that token's
// K and V rows [Hkv, D] into pool[:, page[s], off[s], :], in place.
//
// Replaces: polyrl_tpu/ops/paged_attention.py:paged_kv_write_pallas
//           (_kv_write_kernel, one DMA pair per slot on the TPU).
// Bound on the H100: launch latency, not bytes -- a step at S=64, Hkv=8,
//   D=128 in bf16 moves ~0.5 MB, under a microsecond at 3.35 TB/s.
// Design: one block per slot; threads copy 16-byte vectors of the K and V
//   rows in one launch (K and V fused, as the TPU kernel fuses them), so
//   the cost is one small launch per layer per step.
// Duplicate targets: inactive slots arrive routed to the null page 0, so
//   several blocks may write the same page-0 row in any order. Nothing
//   attends page 0, so the order does not matter. Targets outside the pool
//   are dropped, as a JAX scatter drops them.
#include <cuda_runtime.h>

namespace {

__global__ void paged_kv_write_kernel(uint4* __restrict__ kpool, uint4* __restrict__ vpool,
                                      const int* __restrict__ page,
                                      const int* __restrict__ off,
                                      const uint4* __restrict__ kupd,
                                      const uint4* __restrict__ vupd, int Hkv, int N,
                                      int ps, int row_vecs) {
  const int s = blockIdx.x;
  const int pg = page[s];
  const int of = off[s];
  if (pg < 0 || pg >= N || of < 0 || of >= ps) return;
  for (int i = threadIdx.x; i < Hkv * row_vecs; i += blockDim.x) {
    const int h = i / row_vecs;
    const int c = i - h * row_vecs;
    const size_t dst = (((size_t)h * N + pg) * ps + of) * row_vecs + c;
    const size_t src = ((size_t)s * Hkv + h) * row_vecs + c;
    kpool[dst] = kupd[src];
    vpool[dst] = vupd[src];
  }
}

}  // namespace

// row_bytes = D * element size; must be a multiple of 16 and every pointer
// 16-byte aligned (the Python wrapper checks both). Returns cudaGetLastError().
extern "C" int polyrl_paged_kv_write(void* kpool, void* vpool, const void* page,
                                     const void* off, const void* kupd,
                                     const void* vupd, int S, int Hkv, int N, int ps,
                                     int row_bytes, void* stream) {
  if (S <= 0) return 0;
  const int row_vecs = row_bytes / 16;
  int threads = ((Hkv * row_vecs + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  paged_kv_write_kernel<<<S, threads, 0, (cudaStream_t)stream>>>(
      (uint4*)kpool, (uint4*)vpool, (const int*)page, (const int*)off,
      (const uint4*)kupd, (const uint4*)vupd, Hkv, N, ps, row_vecs);
  return (int)cudaGetLastError();
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
