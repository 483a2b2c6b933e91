// Paged decode attention: one query token per slot over its page-table row.
//
// Replaces: polyrl_tpu/ops/paged_attention.py:paged_attention_pallas
//           (_paged_attn_kernel) and, on the TPU's production path,
//           paged_attention_lib (JAX's bundled multi-page kernel).
// Computes: out[s, h*rep + r] = softmax(q . K^T * scale) V over positions
//   < max(seq_lens[s], 1) of the slot's pages; GQA with rep = Hq / Hkv;
//   f32 online softmax; bf16 (or the input type) output.
// Bound on the H100: the KV bytes read (about 1 flop per byte in bf16).
// Design (paged_common.cuh): each row is split into chunks of C page-table
//   columns; a persistent split kernel attends every (chunk, slot, kv head)
//   item -- in bf16 on the tensor cores, the rep query rows padded to the
//   mma's 16 -- and writes f32 partial stats; a combine kernel merges each
//   (slot, head)'s chunks in order. A 4,096-token row is 16 items of 256
//   positions, not one block walking 64 pages. Later work: TMA with a
//   producer warp, and one launch instead of two.
#include "paged_common.cuh"

// stats: f32 scratch of S * Hkv * ceil(P / C) * rep * (D + 2) values
// allocated by the caller. phases: 1 = split, 2 = combine, 3 = both.
extern "C" int polyrl_paged_attention(const void* q, const void* kp, const void* vp,
                                      const void* page_table, const void* seq_lens,
                                      void* stats, void* out, int dtype, int S, int Hq,
                                      int Hkv, int N, int ps, int D, int P, int C,
                                      int phases, float scale, void* stream) {
  polyrl::Plan p{};
  p.S = S, p.Hq = Hq, p.Hkv = Hkv, p.N = N, p.ps = ps, p.D = D, p.P = P, p.C = C;
  p.scale = scale;
  return polyrl::launch_attention(q, kp, vp, page_table, seq_lens, nullptr, nullptr, nullptr,
                                  stats, nullptr, out, dtype, p, phases,
                                  (cudaStream_t)stream);
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
