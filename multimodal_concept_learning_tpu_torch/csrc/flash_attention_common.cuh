// Helpers shared by the K1 forward (flash_attention_fwd.cu) and backward
// (flash_attention_bwd.cu, flash_attention_bwd_tc.cu) kernels: fp32/bf16
// element access, warp reductions, the mask the descriptors define, and the
// backward's parameters with the entry points of its bf16 pair.
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

// The backward's arguments: q [B, Tq, Hq, D], k/v [B, Tk, Hk, D] and the
// forward's o and lse; dout the output's cotangent.
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // dQ kernel only (delta)
  const void* dout;
  const float* lse;   // [B, Hq, Tq]
  float* delta;       // [B, Hq, Tq]: written by the dQ kernel, read by the dK/dV kernel
  void* dq;
  void* dk;
  void* dv;
  float* ds;          // nullable, [B, Hq, Tq, Tk]
  const float* bias;  // nullable
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  const int* kv_lens;  // nullable, [B]
  int B, Tq, Tk, Hq, Hk;
  float scale;
  int causal;
  int window;  // < 0: no sliding window
};

__device__ __forceinline__ float bias_at(const BwdParams& p, int b, int h, int t, int key) {
  return p.bias[b * p.bias_sb + h * p.bias_sh + (long long)t * p.bias_sq +
                (long long)key * p.bias_sk];
}

// The bf16 backward on the tensor cores (flash_attention_bwd_tc.cu), for
// head dims 64, 128 and 256: the dQ launch writes dq, delta and (ds
// non-null) dS; the dK/dV launch, after it on the same stream, reads delta.
// Each returns its launch's cudaError_t.
cudaError_t launch_bwd_dq_tc(const BwdParams& p, int D, cudaStream_t stream);
cudaError_t launch_bwd_dkv_tc(const BwdParams& p, int D, cudaStream_t stream);

}  // namespace mcl_flash
