// Shared-prefix grouped decode attention.
//
// Replaces: polyrl_tpu/ops/paged_attention.py:grouped_paged_attention_pallas
//           (_grouped_prefix_kernel, the XLA gather between the phases, and
//           _grouped_suffix_kernel).
// Computes the same result as paged attention over each slot's full page
//   row, but reads each GRPO group's shared prompt pages once per group:
//   the group's G*rep stacked queries attend the prefix pages together,
//   each slot attends its own pages past the prefix, and the two are merged
//   by their log-sum-exp stats. Ungrouped slots reduce to paged attention.
// Bound on the H100: the KV bytes read -- the prefix once per group plus
//   each slot's own pages.
// Design (paged_common.cuh, shared with paged_attention.cu): one split
//   launch holds both kinds of work item -- (chunk, group, kv head, 16
//   stacked rows) over the prefix pages, on the tensor cores in bf16 (16
//   stacked rows at G 8, rep 2: exactly the mma's M), and (chunk, slot, kv
//   head) over each slot's own pages from column prefix_len / page_size --
//   so a 32-page prefix is spread over 8 items per kv head, not walked by
//   one block. The combine launch merges a seated slot's prefix partials
//   (its seat's rows) and then its own chunks; it finds the seat by
//   scanning the small [NG, G] table, so a -1 (empty) seat is never an
//   index. Two launches, as K2. Later work: TMA with a producer warp, and
//   one launch instead of two.
#include "paged_common.cuh"

// stats_s: f32 scratch of S * Hkv * ceil(P / C) * rep * (D + 2) values,
// stats_p: of NG * Hkv * ceil(P_pre / C) * G * rep * (D + 2), both allocated
// by the caller. phases: 1 = split, 2 = combine, 3 = both.
extern "C" int polyrl_grouped_paged_attention(
    const void* q, const void* kp, const void* vp, const void* page_table,
    const void* seq_lens, const void* group_slots, const void* group_prefix_pages,
    const void* group_prefix_lens, void* stats_s, void* stats_p, void* out, int dtype,
    int S, int Hq, int Hkv, int N, int ps, int D, int P, int NG, int G, int P_pre, int C,
    int phases, float scale, void* stream) {
  if (S > 0 && (NG <= 0 || G <= 0)) return (int)cudaErrorInvalidValue;
  polyrl::Plan p{};
  p.S = S, p.Hq = Hq, p.Hkv = Hkv, p.N = N, p.ps = ps, p.D = D, p.P = P, p.C = C;
  p.NG = NG, p.G = G, p.P_pre = P_pre;
  p.scale = scale;
  return polyrl::launch_attention(q, kp, vp, page_table, seq_lens, group_slots,
                                  group_prefix_pages, group_prefix_lens, stats_s, stats_p,
                                  out, dtype, p, phases, (cudaStream_t)stream);
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
