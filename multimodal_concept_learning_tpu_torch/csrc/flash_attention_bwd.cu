// K1 backward in float32: the gradient of fused attention on the CUDA cores
// (sm_90a).  bf16 inputs take the tensor-core pair of
// flash_attention_bwd_tc.cu instead; the entry points below dispatch by
// dtype and serve both.
//
// Replaces, for float32 inputs, the two Pallas TPU kernels of the custom VJP
// in multimodal_concept_learning_tpu/ops/flash_attention.py (_flash_bwd):
//   _dq_kernel  (:52, pallas_call at :206 / :221) -> flash_bwd_dq_kernel
//   _dkv_kernel (:76, pallas_call at :256)        -> flash_bwd_dkv_kernel
// Both recompute the probabilities from the forward's saved row logsumexp:
//   p     = exp(s * scale + bias - lse)      (0 where the mask forbids)
//   dp    = dO v^T
//   delta = rowsum(dO * O)
//   dS    = p * (dp - delta)
//   dQ    = dS k * scale,   dK = dS^T q * scale,   dV = p^T dO
// with the forward's contract (flash_attention_fwd.cu): q [B, Tq, Hq, D],
// k/v [B, Tk, Hk, D], any T (ragged tiles masked), any scale, GQA read in
// place, masks from the kv_lens / causal / window descriptors plus an
// optional fp32 bias read through four element strides.  A row with no
// attendable key has lse = +inf and contributes nothing.
//
// Differences from the TPU kernels, and why (both dtypes):
// - delta is computed once per query row, by the dQ kernel, and written to
//   a float32 [B, Hq, Tq] buffer that the dK/dV kernel (launched after it on
//   the same stream) reads; both TPU kernels recompute it.
// - GQA: dK/dV of kv head j sum over its Hq/Hk query heads inside one CTA
//   (a loop here, the warps' partial sums added in a fixed order in the
//   bf16 pair), never through a repeated K/V or atomics, so the gradients
//   are deterministic run to run.
// - dS (the bias cotangent, float32 [B, Hq, Tq, Tk]) is written only when
//   the caller passes a buffer for it; tiles the mask skips are never
//   written, so the caller zero-fills it.
//
// What bounds it: float32 products on the CUDA cores (no TF32: float32 runs
// must match the plain version to 1e-4).  Each CTA recomputes a [tile x
// tile] score block from smem-staged fp32 tiles and does three tile
// products per step; at batch 2 the grids are small (the dK/dV grid is
// ceil(Tk / BK) x Hk x B).  The float32 path runs in the parity checks, not
// on a bf16 training step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using mcl_flash::attendable;
using mcl_flash::bias_at;
using mcl_flash::BwdParams;
using mcl_flash::kThreads;
using mcl_flash::load_f;
using mcl_flash::store_f;
using mcl_flash::warp_sum;

// ---------------------------------------------------------------------------
// dQ (+ delta, + dS): one CTA per (query tile of BQ rows, q head, batch row),
// looping over key tiles of kBK keys.
// ---------------------------------------------------------------------------

constexpr int kBK = 32;  // keys per tile in the dQ kernel == warp width

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D]
  float* dOs = Qs + BQ * D;                // [BQ][D]
  float* Ks = dOs + BQ * D;                // [kBK][D + 1] (padded: conflict-free column reads)
  float* Vs = Ks + kBK * (D + 1);          // [kBK][D + 1]
  float* Ss = Vs + kBK * (D + 1);          // [BQ][kBK + 1]: dS of the tile
  float* lse_s = Ss + BQ * (kBK + 1);      // [BQ]
  float* delta_s = lse_s + BQ;             // [BQ]

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* o = static_cast<const float*>(p.o);
  const float* dout = static_cast<const float*>(p.dout);
  float* dq = static_cast<float*>(p.dq);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const int off = p.Tk - p.Tq;
  const size_t row_base = (size_t)b * p.Hq * p.Tq + (size_t)h * p.Tq;  // [B, Hq, Tq] index of row 0

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    float qx = 0.f, gx = 0.f;
    if (t < p.Tq) {
      const size_t idx = ((size_t)(b * p.Tq + t) * p.Hq + h) * D + d;
      qx = load_f(q + idx);
      gx = load_f(dout + idx);
    }
    Qs[i] = qx;
    dOs[i] = gx;
  }
  __syncthreads();
  // delta = rowsum(dO * O): one warp per row
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int t = q0 + r;
    float sum = 0.f;
    if (t < p.Tq) {
      const float* orow = o + ((size_t)(b * p.Tq + t) * p.Hq + h) * D;
      for (int d = lane; d < D; d += 32) sum = fmaf(dOs[r * D + d], load_f(orow + d), sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = t < p.Tq ? p.lse[row_base + t] : INFINITY;
      if (t < p.Tq) p.delta[row_base + t] = sum;
    }
  }

  // key tiles this query tile can reach at all (the per-element mask is exact)
  const int kv_len = p.kv_lens ? min(p.Tk, p.kv_lens[b]) : p.Tk;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, min(q0 + BQ, p.Tq) - 1 + off + 1);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, q0 + off - p.window + 1);
  k_lo = (k_lo / kBK) * kBK;

  // dQ ownership: column od, rows orow0 + i * kORS
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
      Vs[c * (D + 1) + d] = vx;
    }
    __syncthreads();

    {
      float s[kNS], dp[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) s[i] = dp[i] = 0.f;
      const float* kr = Ks + sc * (D + 1);
      const float* vr = Vs + sc * (D + 1);
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int r = srow0 + i * kSRS;
          s[i] = fmaf(Qs[r * D + d], kd, s[i]);
          dp[i] = fmaf(dOs[r * D + d], vd, dp[i]);
        }
      }
      const int key = kt + sc;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int r = srow0 + i * kSRS;
        const int t = q0 + r;
        float ds = 0.f;
        if (attendable(t, key, p.Tq, kv_len, off, p.causal, p.window)) {
          float logit = s[i] * p.scale;
          if (p.bias) logit += bias_at(p, b, h, t, key);
          const float prob = expf(logit - lse_s[r]);
          ds = prob * (dp[i] - delta_s[r]);
        }
        Ss[r * (kBK + 1) + sc] = ds;
        if (p.ds != nullptr && t < p.Tq && key < p.Tk)
          p.ds[(row_base + t) * p.Tk + key] = ds;
      }
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float kx = Ks[c * (D + 1) + od];
#pragma unroll
      for (int i = 0; i < kNO; ++i) acc[i] = fmaf(Ss[(orow0 + i * kORS) * (kBK + 1) + c], kx, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    const int t = q0 + orow0 + i * kORS;
    if (t < p.Tq) store_f(dq + ((size_t)(b * p.Tq + t) * p.Hq + h) * D + od, acc[i] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one CTA per (key tile of BK keys, kv head, batch row), looping over
// the group's query heads and over query tiles of kBQ rows.
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;  // query rows per tile in the dK/dV kernel == warp width

template <int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* Ks = smem;                        // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);           // [kBQ][D + 1]
  float* dOs = Qs + kBQ * (D + 1);         // [kBQ][D + 1]
  float* Ps = dOs + kBQ * (D + 1);         // [kBQ][BK + 1]: p of the tile
  float* Ds = Ps + kBQ * (BK + 1);         // [kBQ][BK + 1]: dS of the tile
  float* lse_s = Ds + kBQ * (BK + 1);      // [kBQ]
  float* delta_s = lse_s + kBQ;            // [kBQ]

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int j = blockIdx.y;  // kv head
  const int b = blockIdx.z;
  const int group = p.Hq / p.Hk;
  const int off = p.Tk - p.Tq;
  const int kv_len = p.kv_lens ? min(p.Tk, p.kv_lens[b]) : p.Tk;

  // accumulator ownership: column ad, keys arow0 + i * kARS
  constexpr int kARS = kThreads / D;
  constexpr int kNA = BK / kARS;
  const int ad = tid % D;
  const int arow0 = tid / D;
  float acc_k[kNA], acc_v[kNA];
#pragma unroll
  for (int i = 0; i < kNA; ++i) acc_k[i] = acc_v[i] = 0.f;

  // score ownership: query row sr (one lane per row), keys sc0 + i * kSCS
  constexpr int kSCS = kThreads / kBQ;
  constexpr int kNS = BK / kSCS;
  const int sr = tid % kBQ;
  const int sc0 = tid / kBQ;

  // query rows that can reach this key tile at all
  int q_lo = 0, q_hi = p.Tq;
  if (p.causal) q_lo = max(0, k0 - off);
  if (p.window >= 0) q_hi = min(q_hi, k0 + BK - 1 + p.window - off);
  q_lo = (q_lo / kBQ) * kBQ;
  if (k0 >= kv_len) q_hi = q_lo;  // the whole tile is padding: zero gradients

  if (q_lo < q_hi) {
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D, d = i % D, key = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (key < p.Tk) {
        const size_t idx = ((size_t)(b * p.Tk + key) * p.Hk + j) * D + d;
        kx = load_f(k + idx);
        vx = load_f(v + idx);
      }
      Ks[c * (D + 1) + d] = kx;
      Vs[c * (D + 1) + d] = vx;
    }
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = j * group + hh;
    const size_t row_base = (size_t)b * p.Hq * p.Tq + (size_t)h * p.Tq;
    for (int qt = q_lo; qt < q_hi; qt += kBQ) {
      __syncthreads();  // the previous step's readers of Qs/dOs/Ps/Ds are done
      for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, d = i % D, t = qt + r;
        float qx = 0.f, gx = 0.f;
        if (t < p.Tq) {
          const size_t idx = ((size_t)(b * p.Tq + t) * p.Hq + h) * D + d;
          qx = load_f(q + idx);
          gx = load_f(dout + idx);
        }
        Qs[r * (D + 1) + d] = qx;
        dOs[r * (D + 1) + d] = gx;
      }
      for (int r = tid; r < kBQ; r += kThreads) {
        const int t = qt + r;
        lse_s[r] = t < p.Tq ? p.lse[row_base + t] : INFINITY;
        delta_s[r] = t < p.Tq ? p.delta[row_base + t] : 0.f;
      }
      __syncthreads();

      {
        float s[kNS], dp[kNS];
#pragma unroll
        for (int i = 0; i < kNS; ++i) s[i] = dp[i] = 0.f;
        const float* qr = Qs + sr * (D + 1);
        const float* gr = dOs + sr * (D + 1);
        for (int d = 0; d < D; ++d) {
          const float qd = qr[d], gd = gr[d];
#pragma unroll
          for (int i = 0; i < kNS; ++i) {
            const int c = sc0 + i * kSCS;
            s[i] = fmaf(qd, Ks[c * (D + 1) + d], s[i]);
            dp[i] = fmaf(gd, Vs[c * (D + 1) + d], dp[i]);
          }
        }
        const int t = qt + sr;
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int c = sc0 + i * kSCS;
          const int key = k0 + c;
          float prob = 0.f, ds = 0.f;
          if (attendable(t, key, p.Tq, kv_len, off, p.causal, p.window)) {
            float logit = s[i] * p.scale;
            if (p.bias) logit += bias_at(p, b, h, t, key);
            prob = expf(logit - lse_s[sr]);
            ds = prob * (dp[i] - delta_s[sr]);
          }
          Ps[sr * (BK + 1) + c] = prob;
          Ds[sr * (BK + 1) + c] = ds;
        }
      }
      __syncthreads();

      for (int r = 0; r < kBQ; ++r) {
        const float gx = dOs[r * (D + 1) + ad];
        const float qx = Qs[r * (D + 1) + ad];
#pragma unroll
        for (int i = 0; i < kNA; ++i) {
          const int c = arow0 + i * kARS;
          acc_v[i] = fmaf(Ps[r * (BK + 1) + c], gx, acc_v[i]);
          acc_k[i] = fmaf(Ds[r * (BK + 1) + c], qx, acc_k[i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kNA; ++i) {
    const int key = k0 + arow0 + i * kARS;
    if (key < p.Tk) {
      const size_t idx = ((size_t)(b * p.Tk + key) * p.Hk + j) * D + ad;
      store_f(dk + idx, acc_k[i] * p.scale);
      store_f(dv + idx, acc_v[i]);
    }
  }
}

template <typename Kernel>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, size_t smem, const BwdParams& p,
                             cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int BQ>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * D + 2 * kBK * (D + 1) + BQ * (kBK + 1) + 2 * BQ);
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  return launch_with_smem(flash_bwd_dq_kernel<D, BQ>, grid, smem, p, stream);
}

template <int D, int BK>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * BK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * (BK + 1) + 2 * kBQ);
  const dim3 grid((p.Tk + BK - 1) / BK, p.Hk, p.B);
  return launch_with_smem(flash_bwd_dkv_kernel<D, BK>, grid, smem, p, stream);
}

cudaError_t dispatch_dq(const BwdParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_dq<64, 64>(p, stream);
    case 128: return launch_dq<128, 64>(p, stream);
    case 256: return launch_dq<256, 32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// 16-key tiles at d = 256 keep the dK and dV accumulators at 32 registers a
// thread and double the CTAs of the small training grids.
cudaError_t dispatch_dkv(const BwdParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_dkv<64, 32>(p, stream);
    case 128: return launch_dkv<128, 32>(p, stream);
    case 256: return launch_dkv<256, 16>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, float* ds, const float* bias, long long bias_sb,
                      long long bias_sh, long long bias_sq, long long bias_sk,
                      const int* kv_lens, int B, int Tq, int Tk, int Hq, int Hk, float scale,
                      int causal, int window) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv; p.ds = ds;
  p.bias = bias;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sq = bias_sq; p.bias_sk = bias_sk;
  p.kv_lens = kv_lens;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.Hq = Hq; p.Hk = Hk;
  p.scale = scale; p.causal = causal; p.window = window;
  return p;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels here), 1 = bfloat16 (the
// tensor-core pair, flash_attention_bwd_tc.cu).  Each returns its launch's
// cudaError_t.
// Writes dq [B,Tq,Hq,D], delta [B,Hq,Tq] (fp32) and, when ds is non-null,
// dS [B,Hq,Tq,Tk] (fp32; entries of skipped tiles are left as they were).
extern "C" int mcl_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, float* ds, const float* bias, long long bias_sb,
    long long bias_sh, long long bias_sq, long long bias_sk, const int* kv_lens, int B, int Tq,
    int Tk, int Hq, int Hk, int D, int dtype, float scale, int causal, int window,
    void* stream) {
  const BwdParams p = make_params(q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, ds, bias,
                                  bias_sb, bias_sh, bias_sq, bias_sk, kv_lens, B, Tq, Tk, Hq,
                                  Hk, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dq(p, D, s);
  if (dtype == 1) return (int)mcl_flash::launch_bwd_dq_tc(p, D, s);
  return (int)cudaErrorInvalidValue;
}

// Reads delta as the dQ kernel wrote it; writes dk, dv [B,Tk,Hk,D].
extern "C" int mcl_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const float* bias, long long bias_sb,
    long long bias_sh, long long bias_sq, long long bias_sk, const int* kv_lens, int B, int Tq,
    int Tk, int Hq, int Hk, int D, int dtype, float scale, int causal, int window,
    void* stream) {
  const BwdParams p = make_params(q, k, v, nullptr, dout, lse, const_cast<float*>(delta),
                                  nullptr, dk, dv, nullptr, bias, bias_sb, bias_sh, bias_sq,
                                  bias_sk, kv_lens, B, Tq, Tk, Hq, Hk, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dkv(p, D, s);
  if (dtype == 1) return (int)mcl_flash::launch_bwd_dkv_tc(p, D, s);
  return (int)cudaErrorInvalidValue;
}
