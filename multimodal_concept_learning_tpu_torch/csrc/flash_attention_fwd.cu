// K1 forward: fused attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/
// flash_attention.py:_fwd_kernel (pallas_call at :143).  Computes
//     o = softmax(q k^T * scale + bias + mask) v
// for q [B, Tq, Hq, D] and k, v [B, Tk, Hk, D] (fp32 or bf16, contiguous),
// with GQA read in place (q head h uses kv head h / (Hq / Hk), never a
// repeated copy), any T (the ragged last tile is masked), any scale, and
// masks built from descriptors instead of a materialised bias:
//   key c is attendable by query r iff  c < kv_lens[b]                (padding)
//                                    && c <= r + (Tk - Tq)           (causal)
//                                    && (r + Tk - Tq) - c < window   (sliding)
// An optional fp32 additive bias is read through four element strides (0 on
// broadcast axes).  A query row with no attendable key outputs zeros.
//
// What bounds it: at the serving shapes (ViT [8,197,12,64], LM prefill
// [8,261,4q/1kv,256]) the scores never leave the SM, so the kernel moves
// each K/V tile from device memory once per 32/64-query tile and is bound
// by its own arithmetic.  This first version keeps the arithmetic in fp32
// on the CUDA cores (smem-staged tiles, one online-softmax pass over 32-key
// tiles); moving the two products onto the tensor cores (wgmma/mma.sync in
// bf16) is the next step for speed.  exp is the accurate expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // keys per tile == warp width (one lane per key in the softmax)

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

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;  // nullable
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  const int* kv_lens;  // nullable, [B]
  int B, Tq, Tk, Hq, Hk;
  float scale;
  int causal;
  int window;  // < 0: no sliding window
};

// One CTA per (query tile of BQ rows, q head, batch row).
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][D]
  float* Ks = Qs + BQ * D;                  // [kBK][D + 1] (padded: conflict-free column reads)
  float* Vs = Ks + kBK * (D + 1);           // [kBK][D]
  float* Ss = Vs + kBK * D;                 // [BQ][kBK + 1] scores, then probabilities
  float* row_alpha = Ss + BQ * (kBK + 1);   // [BQ]
  float* row_m = row_alpha + BQ;            // [BQ] running max
  float* row_l = row_m + BQ;                // [BQ] running denominator

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const int off = p.Tk - p.Tq;  // causal offset: query r sits at key position r + off

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    Qs[i] = t < p.Tq ? load_f(q + ((size_t)(b * p.Tq + t) * p.Hq + h) * D + d) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }

  // keys this tile can reach at all; the per-element mask below is exact
  const int kv_len = p.kv_lens ? min(p.Tk, p.kv_lens[b]) : p.Tk;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, min(q0 + BQ, p.Tq) - 1 + off + 1);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, q0 + off - p.window + 1);
  k_lo = (k_lo / kBK) * kBK;

  // output ownership: column od, rows orow0 + i * kORS
  constexpr int kORS = kThreads / D;
  constexpr int kNO = BQ / kORS;
  const int od = tid % D;
  const int orow0 = tid / D;
  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;

  // score ownership: key column sc, rows srow0 + i * kSRS
  constexpr int kSRS = kThreads / kBK;
  constexpr int kNS = BQ / kSRS;
  const int sc = tid % kBK;
  const int srow0 = tid / kBK;

  __syncthreads();

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D, key = kt + c;
      float kx = 0.f, vx = 0.f;
      if (key < p.Tk) {
        const size_t idx = ((size_t)(b * p.Tk + key) * p.Hk + hk) * D + d;
        kx = load_f(k + idx);
        vx = load_f(v + idx);
      }
      Ks[c * (D + 1) + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    {
      float s[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) s[i] = 0.f;
      const float* kr = Ks + sc * (D + 1);
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < kNS; ++i) s[i] = fmaf(Qs[(srow0 + i * kSRS) * D + d], kd, s[i]);
      }
      const int key = kt + sc;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int r = srow0 + i * kSRS;
        const int t = q0 + r;
        const int qpos = t + off;
        bool ok = t < p.Tq && key < kv_len;
        if (p.causal) ok = ok && key <= qpos;
        if (p.window >= 0) ok = ok && qpos - key < p.window;
        float val = -INFINITY;
        if (ok) {
          val = s[i] * p.scale;
          if (p.bias)
            val += p.bias[b * p.bias_sb + h * p.bias_sh + (long long)t * p.bias_sq +
                          (long long)key * p.bias_sk];
        }
        Ss[r * (kBK + 1) + sc] = val;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const float x = Ss[r * (kBK + 1) + lane];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      const float e = expf(x - m_use);
      const float sum = warp_sum(e);
      Ss[r * (kBK + 1) + lane] = e;
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] *= row_alpha[orow0 + i * kORS];
    for (int c = 0; c < kBK; ++c) {
      const float vx = Vs[c * D + od];
#pragma unroll
      for (int i = 0; i < kNO; ++i) acc[i] = fmaf(Ss[(orow0 + i * kORS) * (kBK + 1) + c], vx, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    const int r = orow0 + i * kORS;
    const int t = q0 + r;
    if (t < p.Tq) {
      const float l = row_l[r];
      store_f(o + ((size_t)(b * p.Tq + t) * p.Hq + h) * D + od, l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * D + kBK * (D + 1) + kBK * D + BQ * (kBK + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, D, BQ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const FlashParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64, 64>(p, stream);
    case 128: return launch<T, 128, 64>(p, stream);
    case 256: return launch<T, 256, 32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int mcl_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const float* bias, long long bias_sb, long long bias_sh,
                                       long long bias_sq, long long bias_sk, const int* kv_lens,
                                       int B, int Tq, int Tk, int Hq, int Hk, int D, int dtype,
                                       float scale, int causal, int window, void* stream) {
  FlashParams p{q,       k,       v,       o,  bias, bias_sb, bias_sh, bias_sq, bias_sk,
                kv_lens, B,       Tq,      Tk, Hq,   Hk,      scale,   causal,  window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mcl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
