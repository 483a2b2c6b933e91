// Fused decode prologue (K1 redesigned): for each slot s, the per-head
// RMSNorm (qk-norm) and RoPE of that token's q and k rows, the write of its
// K and V rows into pool[:, page[s], off[s], :], and q rotated as output,
// in one launch.
//
// Replaces: polyrl_tpu/ops/paged_attention.py:paged_kv_write_pallas
//           (_kv_write_kernel) together with the rms_norm and apply_rope of
//           q and k that feed it in polyrl_tpu/models/decoder.py's
//           forward_paged_decode (XLA fuses those around the Pallas write).
// Bound on the H100: launch latency, not bytes. At S 64, Hq 16, Hkv 8,
//   D 128 in bf16 the function reads and writes about 1.1 MB (0.32 us at
//   3.35 TB/s); the eager chain it replaces is about 36 launches a layer.
// Design: one block per slot and one warp per head row (the Hq q rows,
//   then the Hkv k rows; warps loop when there are more than 32 rows).
//   Lane l holds pair chunks c = l and l + 32: elements 2c, 2c+1 of the
//   first half of the row and the same of the second half, so each
//   rotate-half pair sits in one lane's registers and needs no shuffle;
//   the row's sum of squares is reduced with __shfl_xor_sync. The V rows
//   are copied by the whole block in 16-byte vectors.
// Rounding is the plain chain's: the norm in f32 (x * rsqrt(mean(x^2) +
//   eps), times the f32 weight) rounds to the activation type; RoPE runs in
//   f32 from that rounded value, each product rounded on its own (no FMA
//   contraction: PyTorch's eager kernels round each), and rounds again; K
//   and V are then converted to the pools' type. A null norm weight skips
//   that norm (Llama and Qwen2 have no qk-norm).
// Targets: inactive slots arrive routed to page 0, offset 0 and are written
//   there (nothing attends page 0, so the order of duplicate writes does not
//   matter); targets outside the pool are dropped, as a JAX scatter drops
//   them; q is returned for every slot. Nothing is read on the host, so the
//   launch can be captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxRowWarps = 32;
constexpr int kPairIters = 2;  // D <= 256: at most 64 pair chunks a half

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ typename Pair<T>::type from_f2(float2 v);
template <>
__device__ __forceinline__ float2 from_f2<float>(float2 v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat162 from_f2<__nv_bfloat16>(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);  // round to nearest even, as torch
}

// v rounded to T's precision and back to f32
template <typename T>
__device__ __forceinline__ float2 round_to(float2 v) {
  return to_f2(from_f2<T>(v));
}

template <typename T, typename P>
struct Args {
  T* q_out;
  P* kpool;
  P* vpool;
  const T* q;
  const T* k;
  const T* v;
  const T* q_norm;  // null: no qk-norm on q
  const T* k_norm;  // null: no qk-norm on k
  const float* cos;
  const float* sin;
  const int* page;
  const int* off;
  int Hq, Hkv, N, ps, D;
  float eps;
};

template <typename T, typename P>
__global__ void __launch_bounds__(kMaxRowWarps * 32)
    paged_kv_write_fused_kernel(Args<T, P> a) {
  using PT = typename Pair<T>::type;
  using PP = typename Pair<P>::type;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int half = a.D >> 1;
  const int chunks = a.D >> 2;  // pair chunks in each half
  const int pg = a.page[s];
  const int of = a.off[s];
  const bool write = pg >= 0 && pg < a.N && of >= 0 && of < a.ps;
  const float* cs = a.cos + (size_t)s * half;
  const float* sn = a.sin + (size_t)s * half;

  for (int r = threadIdx.x >> 5; r < a.Hq + a.Hkv; r += nwarps) {
    const bool is_q = r < a.Hq;  // uniform over the warp
    const int h = is_q ? r : r - a.Hq;
    if (!is_q && !write) continue;
    const T* src = is_q ? a.q + ((size_t)s * a.Hq + h) * a.D
                        : a.k + ((size_t)s * a.Hkv + h) * a.D;
    const T* w = is_q ? a.q_norm : a.k_norm;
    float2 x1[kPairIters], x2[kPairIters];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kPairIters; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        x1[i] = to_f2(*reinterpret_cast<const PT*>(src + 2 * c));
        x2[i] = to_f2(*reinterpret_cast<const PT*>(src + half + 2 * c));
        ss += x1[i].x * x1[i].x + x1[i].y * x1[i].y + x2[i].x * x2[i].x +
              x2[i].y * x2[i].y;
      }
    }
    if (w != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / a.D), a.eps));
#pragma unroll
      for (int i = 0; i < kPairIters; ++i) {
        const int c = lane + 32 * i;
        if (c < chunks) {
          const float2 w1 = to_f2(*reinterpret_cast<const PT*>(w + 2 * c));
          const float2 w2 = to_f2(*reinterpret_cast<const PT*>(w + half + 2 * c));
          x1[i] = round_to<T>(make_float2(__fmul_rn(__fmul_rn(x1[i].x, inv), w1.x),
                                          __fmul_rn(__fmul_rn(x1[i].y, inv), w1.y)));
          x2[i] = round_to<T>(make_float2(__fmul_rn(__fmul_rn(x2[i].x, inv), w2.x),
                                          __fmul_rn(__fmul_rn(x2[i].y, inv), w2.y)));
        }
      }
    }
    T* q_dst = is_q ? a.q_out + ((size_t)s * a.Hq + h) * a.D : nullptr;
    P* k_dst = is_q ? nullptr : a.kpool + (((size_t)h * a.N + pg) * a.ps + of) * a.D;
#pragma unroll
    for (int i = 0; i < kPairIters; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        const float2 cc = *reinterpret_cast<const float2*>(cs + 2 * c);
        const float2 sc = *reinterpret_cast<const float2*>(sn + 2 * c);
        const float2 o1 = make_float2(
            __fsub_rn(__fmul_rn(x1[i].x, cc.x), __fmul_rn(x2[i].x, sc.x)),
            __fsub_rn(__fmul_rn(x1[i].y, cc.y), __fmul_rn(x2[i].y, sc.y)));
        const float2 o2 = make_float2(
            __fadd_rn(__fmul_rn(x2[i].x, cc.x), __fmul_rn(x1[i].x, sc.x)),
            __fadd_rn(__fmul_rn(x2[i].y, cc.y), __fmul_rn(x1[i].y, sc.y)));
        const PT r1 = from_f2<T>(o1);
        const PT r2 = from_f2<T>(o2);
        if (is_q) {
          *reinterpret_cast<PT*>(q_dst + 2 * c) = r1;
          *reinterpret_cast<PT*>(q_dst + half + 2 * c) = r2;
        } else {
          *reinterpret_cast<PP*>(k_dst + 2 * c) = from_f2<P>(to_f2(r1));
          *reinterpret_cast<PP*>(k_dst + half + 2 * c) = from_f2<P>(to_f2(r2));
        }
      }
    }
  }

  if (!write) return;
  const T* v_src = a.v + (size_t)s * a.Hkv * a.D;
  if constexpr (std::is_same<T, P>::value) {
    constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
    const int row_vecs = a.D / kVec;
    for (int i = threadIdx.x; i < a.Hkv * row_vecs; i += blockDim.x) {
      const int h = i / row_vecs;
      const int c = i - h * row_vecs;
      reinterpret_cast<uint4*>(a.vpool + (((size_t)h * a.N + pg) * a.ps + of) * a.D)[c] =
          reinterpret_cast<const uint4*>(v_src + (size_t)h * a.D)[c];
    }
  } else {
    const int row_pairs = a.D / 2;
    for (int i = threadIdx.x; i < a.Hkv * row_pairs; i += blockDim.x) {
      const int h = i / row_pairs;
      const int c = i - h * row_pairs;
      reinterpret_cast<PP*>(a.vpool + (((size_t)h * a.N + pg) * a.ps + of) * a.D)[c] =
          from_f2<P>(to_f2(reinterpret_cast<const PT*>(v_src + (size_t)h * a.D)[c]));
    }
  }
}

template <typename T, typename P>
int launch(void* q_out, void* kpool, void* vpool, const void* q, const void* k,
           const void* v, const void* q_norm, const void* k_norm, const void* cos,
           const void* sin, const void* page, const void* off, int S, int Hq,
           int Hkv, int N, int ps, int D, float eps, cudaStream_t stream) {
  Args<T, P> a{(T*)q_out, (P*)kpool, (P*)vpool,
               (const T*)q, (const T*)k, (const T*)v,
               (const T*)q_norm, (const T*)k_norm,
               (const float*)cos, (const float*)sin,
               (const int*)page, (const int*)off,
               Hq, Hkv, N, ps, D, eps};
  const int rows = Hq + Hkv;
  const int warps = rows < kMaxRowWarps ? rows : kMaxRowWarps;
  paged_kv_write_fused_kernel<T, P><<<S, warps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// act_dtype (q, k, v, the norm weights and q_out) and pool_dtype: 0 f32,
// 1 bf16. D a multiple of 32, at most 256; every pointer 16-byte aligned
// (the Python wrapper checks both). q_norm / k_norm may be null. Returns
// cudaGetLastError().
extern "C" int polyrl_paged_kv_write_fused(
    void* q_out, void* kpool, void* vpool, const void* q, const void* k,
    const void* v, const void* q_norm, const void* k_norm, const void* cos,
    const void* sin, const void* page, const void* off, int act_dtype,
    int pool_dtype, int S, int Hq, int Hkv, int N, int ps, int D, float eps,
    void* stream) {
  if (S <= 0) return 0;
  if (D <= 0 || D % 32 || D > 256 || Hq <= 0 || Hkv <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
#define POLYRL_FUSED_LAUNCH(T, P)                                                  \
  return launch<T, P>(q_out, kpool, vpool, q, k, v, q_norm, k_norm, cos, sin, page, \
                      off, S, Hq, Hkv, N, ps, D, eps, st)
  if (act_dtype == 0 && pool_dtype == 0) POLYRL_FUSED_LAUNCH(float, float);
  if (act_dtype == 1 && pool_dtype == 1) POLYRL_FUSED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (act_dtype == 1 && pool_dtype == 0) POLYRL_FUSED_LAUNCH(__nv_bfloat16, float);
  if (act_dtype == 0 && pool_dtype == 1) POLYRL_FUSED_LAUNCH(float, __nv_bfloat16);
#undef POLYRL_FUSED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* polyrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
