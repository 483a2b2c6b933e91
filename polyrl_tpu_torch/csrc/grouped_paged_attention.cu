// Shared-prefix grouped decode attention, two launches.
//
// Replaces: polyrl_tpu/ops/paged_attention.py:grouped_paged_attention_pallas
//           (_grouped_prefix_kernel, the XLA gather between the phases, and
//           _grouped_suffix_kernel).
// Computes the same result as paged attention over each slot's full page
//   row, but reads each GRPO group's shared prompt pages once per group:
//   phase 1 attends the group's G*rep stacked queries over the prefix
//   pages and writes f32 flash stats (m, l, unnormalised acc) to scratch
//   the wrapper allocates; phase 2 runs per slot over its own pages past
//   the prefix, with the online softmax initialised from its seat's stats
//   (ungrouped slots start from (NEG_INF, 0, 0) and reduce to the plain
//   kernel). The two-call split was a Mosaic constraint on the TPU; here it
//   is kept because the phases have different grids.
// Bound on the H100: the KV bytes read -- the prefix once per group plus
//   each slot's suffix pages.
// Design: both phases stage each page's K and V tiles in shared memory,
//   double-buffered (paged_common.cuh). Phase 1 is one block per (group,
//   kv head, block of up to kRows1 stacked rows), so each group's prefix
//   page is read once for up to kRows1 = 32 query rows (one block for
//   G*rep <= 32, as at G=8, rep=2); phase 2 is one block per (slot, kv
//   head). Phase 2 finds its seat by scanning the small [NG, G] table
//   itself, so -1 (empty) seats are never used as an index and no gather
//   launch sits between the phases.
#include "paged_common.cuh"

namespace {

using namespace polyrl;

constexpr int kRows1 = 32;  // stacked query rows per phase-1 block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_prefix_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ group_slots,
                          const int* __restrict__ prefix_pages,
                          const int* __restrict__ prefix_lens, float* __restrict__ m1,
                          float* __restrict__ l1, float* __restrict__ acc1, int S,
                          int Hq, int Hkv, int N, int ps, int D, int G, int P_pre,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, h = blockIdx.y, rep = Hq / Hkv;
  const int r_first = blockIdx.z * kRows1, R = min(kRows1, G * rep - r_first);
  Smem<T> st = carve<T>(smem, R, D, ps);
  // stacked query rows: row c*rep + j is head h*rep + j of seat c's slot;
  // empty seats (-1) get zero rows that no slot ever reads back
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = r_first + i / D, d = i % D;
    const int c = r / rep, j = r - c * rep;
    const int slot = group_slots[(size_t)g * G + c];
    st.q[i] = (slot >= 0 && slot < S)
                  ? to_f32(q[((size_t)slot * Hq + (size_t)h * rep + j) * D + d])
                  : 0.f;
    st.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < R; i += kThreads) {
    st.m[i] = NEG_INF;
    st.l[i] = 0.f;
  }
  __syncthreads();
  const int pre_len = prefix_lens[g];
  const int n_pages = min((max(pre_len, 0) + ps - 1) / ps, P_pre);
  attend_pages(kp, vp, prefix_pages + (size_t)g * P_pre, 0, n_pages, P_pre, h, N,
               pre_len, R, D, ps, scale, st);
  const size_t row0 = ((size_t)g * Hkv + h) * G * rep + r_first;
  for (int i = threadIdx.x; i < R * D; i += kThreads) acc1[row0 * D + i] = st.acc[i];
  for (int i = threadIdx.x; i < R; i += kThreads) {
    m1[row0 + i] = st.m[i];
    l1[row0 + i] = st.l[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_suffix_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ page_table,
                          const int* __restrict__ seq_lens,
                          const int* __restrict__ group_slots,
                          const int* __restrict__ prefix_lens,
                          const float* __restrict__ m1, const float* __restrict__ l1,
                          const float* __restrict__ acc1, T* __restrict__ out, int Hq,
                          int Hkv, int N, int ps, int D, int P, int NG, int G,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, rep = Hq / Hkv;
  Smem<T> st = carve<T>(smem, rep, D, ps);
  // this slot's seat: first (group, column) holding s; -1 seats never match
  int grp = -1, col = 0;
  for (int i = 0; i < NG * G; ++i) {
    if (group_slots[i] == s) {
      grp = i / G;
      col = i - grp * G;
      break;
    }
  }
  const int npre = grp >= 0 ? prefix_lens[grp] / ps : 0;
  load_q_rows(q, s, h, Hq, rep, D, st.q);
  const size_t row0 = grp >= 0 ? ((size_t)grp * Hkv + h) * G * rep + (size_t)col * rep : 0;
  for (int i = threadIdx.x; i < rep * D; i += kThreads)
    st.acc[i] = grp >= 0 ? acc1[row0 * D + i] : 0.f;
  for (int i = threadIdx.x; i < rep; i += kThreads) {
    st.m[i] = grp >= 0 ? m1[row0 + i] : NEG_INF;
    st.l[i] = grp >= 0 ? l1[row0 + i] : 0.f;
  }
  __syncthreads();
  const int len = max(seq_lens[s], 1);
  const int n_tot = (len + ps - 1) / ps;
  const int n_sfx = min(max(n_tot - npre, 1), P);  // an active slot owns >= 1 page
  attend_pages(kp, vp, page_table + (size_t)s * P, npre, n_sfx, P, h, N, len, rep, D,
               ps, scale, st);
  store_out(out, s, h, Hq, rep, D, st);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* lens, const void* gslots, const void* gpages,
           const void* glens, void* m1, void* l1, void* acc1, void* out, int S, int Hq,
           int Hkv, int N, int ps, int D, int P, int NG, int G, int P_pre, float scale,
           cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int R1 = G * rep, row_blocks = (R1 + kRows1 - 1) / kRows1;
  const size_t smem1 = smem_bytes<T>(R1 < kRows1 ? R1 : kRows1, D, ps);
  cudaError_t e = allow_smem(grouped_prefix_kernel<T>, smem1);
  if (e != cudaSuccess) return (int)e;
  grouped_prefix_kernel<T><<<dim3(NG, Hkv, row_blocks), kThreads, smem1, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)gslots, (const int*)gpages,
      (const int*)glens, (float*)m1, (float*)l1, (float*)acc1, S, Hq, Hkv, N, ps, D, G,
      P_pre, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = smem_bytes<T>(rep, D, ps);
  e = allow_smem(grouped_suffix_kernel<T>, smem2);
  if (e != cudaSuccess) return (int)e;
  grouped_suffix_kernel<T><<<dim3(S, Hkv), kThreads, smem2, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)pt, (const int*)lens,
      (const int*)gslots, (const int*)glens, (const float*)m1, (const float*)l1,
      (const float*)acc1, (T*)out, Hq, Hkv, N, ps, D, P, NG, G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. m1/l1 are [NG, Hkv, G*rep]
// and acc1 [NG, Hkv, G*rep, D] f32 scratch allocated by the caller.
extern "C" int polyrl_grouped_paged_attention(
    const void* q, const void* kp, const void* vp, const void* page_table,
    const void* seq_lens, const void* group_slots, const void* group_prefix_pages,
    const void* group_prefix_lens, void* m1, void* l1, void* acc1, void* out,
    int dtype, int S, int Hq, int Hkv, int N, int ps, int D, int P, int NG, int G,
    int P_pre, float scale, void* stream) {
  if (S <= 0) return 0;
  if (NG <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define POLYRL_GROUPED_LAUNCH(T)                                                       \
  launch<T>(q, kp, vp, page_table, seq_lens, group_slots, group_prefix_pages,          \
            group_prefix_lens, m1, l1, acc1, out, S, Hq, Hkv, N, ps, D, P, NG, G, P_pre, \
            scale, st)
  switch (dtype) {
    case 0: return POLYRL_GROUPED_LAUNCH(float);
    case 1: return POLYRL_GROUPED_LAUNCH(__nv_bfloat16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef POLYRL_GROUPED_LAUNCH
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
