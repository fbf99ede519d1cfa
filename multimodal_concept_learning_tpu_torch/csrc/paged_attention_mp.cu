// K4: one-token decode attention against a paged KV pool, block by block,
// with the next block's K/V copied while the current one computes; for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/
// paged_attention_mp_kernel.py:_mp_kernel (with _chunk_copies, pallas_call
// at :233).  Same function as K3 (csrc/paged_attention.cu): for batch row b
// and kv head h the CTA computes the whole GQA group of G = Hq / Hk heads,
//     o[b, hG+g] = softmax_i(q[b, hG+g] . K[i] * scale) V[i]
// over the row's tokens i < lens[b] (and (lens[b] - 1) - i < window when
// window >= 0), read through page_table[b, i / ps] from head-major pools
// [P, Hk, ps, D].  A row with lens[b] == 0 outputs zeros.
//
// The row is walked in blocks of `spb` segments of `seg` tokens; a segment
// is a contiguous run inside one page of one head (seg == ps: whole pages,
// spb = pages per block).  The wrapper picks them from the requested
// pages_per_block and the shared memory: two stages of K and V take
// 4 * spb * seg * D * sizeof(T) bytes, so bf16 pages of 16 tokens at D 256
// fit 6 pages a block beside the scores, fp32 only 3; where one page does
// not fit twice (fp32, 64-token pages, D 256) a page is copied in row ranges
// (seg < ps, spb = 1).  Results differ between schedules only by float32
// summation order.
//
// What bounds it: bytes, as K3 (2 * len * Hk * D elements of K/V per row and
// layer, 4 flops each).  The TPU kernel's reason to exist was the per-step
// cost of its sequential grid; here the point is to overlap: block c + 1's
// segments go to shared memory with 16-byte cp.async (one commit group per
// block, the counterpart of the TPU's per-block DMA semaphore) while block c
// computes scores, a float32 online softmax across blocks and the [G, D]
// float32 accumulator.  Masked tokens get probability exactly 0, and
// segments outside the attended range [start, len) are neither copied nor
// read.  At batch 8 and one kv head only 8 CTAs run, as in K3: splitting a
// row's blocks over CTAs (flash-decoding) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // <= kWarps: one warp per query head in the softmax
constexpr int kSmemLimit = 232448;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct MpParams {
  const void* q;          // [B, Hq, D] (the [B, 1, Hq, D] query)
  const void* k_pool;     // [P, Hk, ps, D], 16-byte aligned
  const void* v_pool;     // [P, Hk, ps, D], 16-byte aligned
  void* o;                // [B, Hq, D]
  const int* page_table;  // [B, NP]
  const int* lens;        // [B] attendable tokens including the new one
  int B, Hq, Hk, ps, NP;
  int window;
  float scale;
  int seg;  // tokens per copied segment; divides ps
  int spb;  // segments per block
};

size_t smem_bytes(int G, int D, int blk, size_t elem) {
  return 4 * (size_t)blk * D * elem + sizeof(float) * ((size_t)G * D + (size_t)G * blk + 3 * G);
}

// One CTA per (batch row, kv head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_mp_kernel(MpParams p) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static_assert(D % kVec == 0 && D <= kThreads, "head_dim");

  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.Hq / p.Hk;
  const int blk = p.seg * p.spb;
  const size_t stage_elems = 2 * (size_t)blk * D;  // K then V of one block
  T* stages = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + 2 * stage_elems * sizeof(T));  // [G][D]
  float* ss = qs + G * D;            // [G][blk] scores, then probabilities
  float* alpha_s = ss + G * blk;     // [G]
  float* m_s = alpha_s + G;          // [G] running max
  float* l_s = m_s + G;              // [G] running denominator

  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k_pool);
  const T* vp = static_cast<const T*>(p.v_pool);
  T* o = static_cast<T*>(p.o);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = p.lens[b];
  const int end = min(len, p.NP * p.ps);  // the page table's columns bound the row
  const int start = p.window >= 0 ? max(0, len - p.window) : 0;
  const size_t q_base = ((size_t)b * p.Hq + (size_t)h * G) * D;  // G consecutive heads

  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f(q[q_base + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  // copy block c's attended segments into stage `stage` (one commit group)
  auto issue = [&](int c, int stage) {
    T* kd = stages + stage * stage_elems;
    T* vd = kd + (size_t)blk * D;
    const int vec_per_seg = p.seg * D / kVec;
    for (int idx = tid; idx < p.spb * vec_per_seg; idx += kThreads) {
      const int j = idx / vec_per_seg;
      const int e = idx - j * vec_per_seg;
      const int t0 = (c * p.spb + j) * p.seg;  // the segment's first token
      if (t0 >= end || t0 + p.seg <= start) continue;
      const long long page = p.page_table[(size_t)b * p.NP + t0 / p.ps];
      const long long off = ((page * p.Hk + h) * p.ps + t0 % p.ps) * D + (long long)e * kVec;
      const size_t dst = (size_t)j * p.seg * D + (size_t)e * kVec;
      cp_async16(kd + dst, kp + off);
      cp_async16(vd + dst, vp + off);
    }
    cp_async_commit();
  };

  const int c0 = start / blk;
  const int c1 = start < end ? (end + blk - 1) / blk : c0;  // blocks [c0, c1)
  if (c0 < c1) issue(c0, 0);
  for (int c = c0; c < c1; ++c) {
    const int stage = (c - c0) & 1;
    if (c + 1 < c1)
      issue(c + 1, stage ^ 1);
    else
      cp_async_commit();  // an empty group, so that wait_group 1 always means block c
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = stages + stage * stage_elems;
    const T* vs = ks + (size_t)blk * D;
    const int lo = max(start, c * blk) - c * blk;  // attended tokens of the block: [lo, hi)
    const int hi = min(end, (c + 1) * blk) - c * blk;

    // scores: each warp takes tokens t = warp, warp + kWarps, ...; lanes across d
    for (int t = warp; t < blk; t += kWarps) {
      const bool ok = t >= lo && t < hi;
      float s[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
      if (ok) {
#pragma unroll
        for (int d = lane; d < D; d += 32) {
          const float kx = to_f(ks[(size_t)t * D + d]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < G) s[g] = fmaf(qs[g * D + d], kx, s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float x = warp_sum(s[g]);
          if (lane == 0) ss[g * blk + t] = ok ? x * p.scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax across blocks: one warp per query head
    if (warp < G) {
      const int g = warp;
      float mx = -INFINITY;
      for (int t = lane; t < blk; t += 32) mx = fmaxf(mx, ss[g * blk + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < blk; t += 32) {
        const float e = (t >= lo && t < hi) ? expf(ss[g * blk + t] - m_use) : 0.f;
        ss[g * blk + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P V over the attended tokens: thread tid owns column d = tid for all G heads
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int t = lo; t < hi; ++t) {
        const float vx = to_f(vs[(size_t)t * D + tid]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g] = fmaf(ss[g * blk + t], vx, acc[g]);
      }
    }
    __syncthreads();  // the stage is refilled two blocks on
  }
  cp_async_wait<0>();

  if (tid < D) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float l = l_s[g];
        o[q_base + (size_t)g * D + tid] = from_f<T>(l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const MpParams& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hk;
  const size_t smem = smem_bytes(G, D, p.seg * p.spb, sizeof(T));
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_mp_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  paged_mp_kernel<T, D><<<dim3(p.B, p.Hk), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const MpParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  seg divides ps; seg < ps only with
// spb == 1.  Returns the launch's cudaError_t.
extern "C" int mcl_paged_decode_attention_mp(const void* q, const void* k_pool,
                                             const void* v_pool, void* o, const int* page_table,
                                             const int* lens, int B, int Hq, int Hk, int ps,
                                             int NP, int D, int dtype, int window, float scale,
                                             int seg, int spb, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > kMaxGroup) return (int)cudaErrorInvalidValue;
  if (seg <= 0 || spb <= 0 || ps % seg != 0 || (seg < ps && spb != 1))
    return (int)cudaErrorInvalidValue;
  MpParams p{q, k_pool, v_pool, o, page_table, lens, B, Hq, Hk, ps, NP, window, scale, seg, spb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
