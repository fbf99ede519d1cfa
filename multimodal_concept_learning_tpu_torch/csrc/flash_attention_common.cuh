// Helpers shared by the K1 forward (flash_attention_fwd.cu) and backward
// (flash_attention_bwd.cu) kernels: fp32/bf16 element access, warp
// reductions, and the mask the descriptors define.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mcl_flash {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float x);
template <>
__device__ __forceinline__ void store_f<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Key `key` is attendable by query row `t` (at key position t + off) iff it
// lies below the row's kv length (which is <= Tk), is not in the future
// (causal) and is within the sliding window.  Rows t >= Tq attend nothing.
__device__ __forceinline__ bool attendable(int t, int key, int Tq, int kv_len, int off,
                                           int causal, int window) {
  if (t >= Tq || key >= kv_len) return false;
  const int qpos = t + off;
  if (causal && key > qpos) return false;
  if (window >= 0 && qpos - key >= window) return false;
  return true;
}

}  // namespace mcl_flash
