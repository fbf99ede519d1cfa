// K3: one-token decode attention against a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/
// paged_attention_kernel.py:_kernel (pallas_call at :133).  For each batch
// row b and kv head h the CTA computes the whole GQA group of G = Hq / Hk
// query heads (q head h * G + g, the grouped order of ops/attention.py):
//     o[b, hG+g] = softmax_i(q[b, hG+g] . K[i] * scale) V[i]
// over the row's tokens i < lens[b], read through page_table[b, i / ps] from
// pools [P, Hk, ps, D] (head-major: one page of one head is a contiguous
// [ps, D] block).  Sliding window: i is attended only if
// (lens[b] - 1) - i < window (window < 0: global); tokens before the window
// are never read.  A row with lens[b] == 0 outputs zeros.
//
// What bounds it: bytes.  Each step reads every live K/V token of every row
// once (2 * len * Hk * D elements per row and layer) and does 4 flops per
// element, far below the card's ~295 flops/byte balance point.  So the
// design keeps as many bytes in flight as it can and moves nothing else:
// the CTA walks the row in chunks of 32 tokens; for each chunk all 256
// threads first issue their 16-byte loads of the chunk's K and V rows (each
// token's row found through the page table, so any page size works), then
// stage them in shared memory as fp32; scores, an online softmax across
// chunks (running max and denominator per head) and the [G, D] fp32
// accumulator never leave the SM.  At batch 8 and one kv head only 8 CTAs
// run, far fewer than the 132 SMs: splitting a row's tokens over several
// CTAs (flash-decoding) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // tokens per step == warp width (one lane per token in the softmax)
constexpr int kMaxGroup = 8;  // <= kWarps: one warp per query head in the softmax

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

// 16 bytes of T (4 floats or 8 bf16) widened to fp32 in shared memory
template <typename T>
__device__ __forceinline__ void widen_store(float* dst, const uint4& raw);
template <>
__device__ __forceinline__ void widen_store<float>(float* dst, const uint4& raw) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
template <>
__device__ __forceinline__ void widen_store<__nv_bfloat16>(float* dst, const uint4& raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of shared memory before the token offsets (K, V chunks, q, scores,
// alpha/max/denominator), rounded up to an even count for 8-byte alignment
__host__ __device__ constexpr int smem_floats(int G, int D) {
  return (2 * kChunk * D + G * D + G * kChunk + 3 * G + 1) & ~1;
}

struct PagedParams {
  const void* q;       // [B, Hq, D] (the [B, 1, Hq, D] query)
  const void* k_pool;  // [P, Hk, ps, D], 16-byte aligned
  const void* v_pool;  // [P, Hk, ps, D], 16-byte aligned
  void* o;             // [B, Hq, D]
  const int* page_table;  // [B, NP]
  const int* lens;        // [B] attendable tokens including the new one
  int B, Hq, Hk, ps, NP;
  int window;
  float scale;
};

// One CTA per (batch row, kv head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(PagedParams p) {
  constexpr int kVec = 16 / sizeof(T);                        // elements per 16-byte load
  constexpr int kLoads = (kChunk * D / kVec + kThreads - 1) / kThreads;  // per thread, K or V
  static_assert(D % kVec == 0 && D <= kThreads, "head_dim");

  extern __shared__ float smem[];
  const int G = p.Hq / p.Hk;
  float* Ks = smem;                 // [kChunk][D]
  float* Vs = Ks + kChunk * D;      // [kChunk][D]
  float* qs = Vs + kChunk * D;      // [G][D]
  float* ss = qs + G * D;           // [G][kChunk] scores, then probabilities
  float* alpha_s = ss + G * kChunk;  // [G]
  float* m_s = alpha_s + G;         // [G] running max
  float* l_s = m_s + G;             // [G] running denominator
  long long* tok_off =              // [kChunk] element offset of each token's row, -1 = masked
      reinterpret_cast<long long*>(smem + smem_floats(G, D));

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
  int start = 0;
  if (p.window >= 0) start = max(0, len - p.window);  // first i with (len - 1) - i < window

  const size_t q_base = ((size_t)b * p.Hq + (size_t)h * G) * D;  // G consecutive heads
  for (int i = tid; i < G * D; i += kThreads) qs[i] = load_f(q + q_base + i);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  for (int t0 = start; t0 < end; t0 += kChunk) {
    if (tid < kChunk) {
      const int t = t0 + tid;
      long long off = -1;
      if (t < end) {
        const long long page = p.page_table[(size_t)b * p.NP + t / p.ps];
        off = ((page * p.Hk + h) * p.ps + t % p.ps) * D;
      }
      tok_off[tid] = off;
    }
    __syncthreads();

    // issue every 16-byte load of the chunk first, then widen into smem
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int v = tid + i * kThreads;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kChunk * D / kVec) {
        const long long off = tok_off[v / (D / kVec)];
        if (off >= 0) {
          const long long e = off + (v % (D / kVec)) * kVec;
          kr[i] = *reinterpret_cast<const uint4*>(kp + e);
          vr[i] = *reinterpret_cast<const uint4*>(vp + e);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int v = tid + i * kThreads;
      if (v < kChunk * D / kVec) {
        widen_store<T>(Ks + v * kVec, kr[i]);
        widen_store<T>(Vs + v * kVec, vr[i]);
      }
    }
    __syncthreads();

    // scores: each warp takes tokens c = warp, warp + kWarps, ...; lanes across d
    for (int c = warp; c < kChunk; c += kWarps) {
      float s[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) {
        const float kx = Ks[c * D + d];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) s[g] = fmaf(qs[g * D + d], kx, s[g]);
      }
      const bool ok = tok_off[c] >= 0;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float x = warp_sum(s[g]);
          if (lane == 0) ss[g * kChunk + c] = ok ? x * p.scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax across chunks: one warp per query head, one lane per token
    if (warp < G) {
      const int g = warp;
      const float x = ss[g * kChunk + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      const float e = expf(x - m_use);
      const float sum = warp_sum(e);
      ss[g * kChunk + lane] = e;
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P V: thread tid owns column d = tid for all G heads
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] *= alpha_s[g];
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        const float vx = Vs[c * D + tid];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g] = fmaf(ss[g * kChunk + c], vx, acc[g]);
      }
    }
    __syncthreads();
  }

  if (tid < D) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float l = l_s[g];
        store_f(o + q_base + (size_t)g * D + tid, l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hk;
  const size_t smem = sizeof(float) * smem_floats(G, D) + sizeof(long long) * kChunk;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, D><<<dim3(p.B, p.Hk), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const PagedParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int mcl_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                          void* o, const int* page_table, const int* lens, int B,
                                          int Hq, int Hk, int ps, int NP, int D, int dtype,
                                          int window, float scale, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > kMaxGroup) return (int)cudaErrorInvalidValue;
  PagedParams p{q, k_pool, v_pool, o, page_table, lens, B, Hq, Hk, ps, NP, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
