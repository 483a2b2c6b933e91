// Shared device code of the training flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): layout, mask and the
// launch helpers both instances use. The bf16 instance's tensor-core
// helpers are in flash_mma.cuh, the f32 instance's CUDA-core helpers in
// flash_f32.cuh.
//
// Layout (the JAX package's, never transposed in memory): q, o, dq, do are
// [B, T, Hq, D]; k, v, dk, dv are [B, T, Hkv, D]; segment ids [B, T] int32;
// the LSE and delta = rowsum(dO * O) are f32 [B, Hq, T]. Query head h reads
// kv head h / rep (rep = Hq / Hkv) in place: KV is never repeated in memory.
//
// Mask (the TPU kernel's): key j is visible to query i when
// seg[i] == seg[j] and, if causal, j <= i. Pads carry segment 0, so pad
// rows attend pad keys and every row sees at least itself: no row is
// fully masked. Masked logits take the TPU kernel's finite mask value
// (-0.7 * f32 max) in the max, and a probability of exactly 0.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace polyrl_flash {

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr size_t kMaxSmem = 232448;  // per block on sm_90 (227 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Element offset of row t, head h, batch b of a [B, T, H, D] tensor.
__device__ __forceinline__ size_t row_off(int b, int t, int h, int T_, int H, int D) {
  return (((size_t)b * T_ + t) * H + h) * D;
}

// Query row qpos may see key row kpos (both inside [0, T)).
__device__ __forceinline__ bool visible(int qpos, int kpos, int T_, int seg_q, int seg_k,
                                        int causal) {
  return qpos < T_ && kpos < T_ && seg_q == seg_k && (!causal || kpos <= qpos);
}

// Allow `bytes` of dynamic shared memory, and ask for the SM's largest
// shared-memory carveout so that several blocks fit on one SM.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess || bytes <= 48 * 1024) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace polyrl_flash
