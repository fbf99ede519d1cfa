// The bf16 attention backward on the tensor cores (sm_90a): one kernel pair
// shared by K2 (attention_core.cu), K2-bd (attention_core_bd.cu) and K6
// (fused_attention_block.cu).  The kernels are instantiated once, in
// merged_bwd_tc.cu, behind mcl_bwd_tc::launch; the entry points include this
// header for BwdParams and that declaration.
//
// dqkv [B, T, 3*H*D] in the packed layout from qkv [B, T, 3*H*D] and dA
// [B, T, H*D] alone, over rows merged across samples (merged_tiles.cuh).
// Key c of a sample may be attended by its query r iff c is below the
// sample's key end (one past its last key below t_real that kv_mask keeps),
// kv_mask keeps c and, under causal, c <= r.  Two launches:
// 1. bwd_dq_tc_kernel: own rows are queries, staged rows each touched
//    sample's keys below its key end (under causal cut at the CTA's last
//    row of its last sample), with a kept flag per staged key.  Pass 1 takes
//    each row's max m, sum l and u = sum exp(s - m) dp online (u rescaled as
//    l is), so lse = m + log l and delta = u / l = rowsum(dP * P) with
//    float32 P (the TPU kernels' delta) come from one sweep of S = Q K^T
//    and dP = dA V^T; both go to a float32 workspace [2, H, B*T].  Pass 2
//    recomputes S and dP, forms dS = P (dP - delta) and accumulates dQ += dS K.
// 2. bwd_dkv_tc_kernel: own rows are keys, staged rows all T queries of each
//    touched sample with their lse and delta; S^T = K Q^T and dP^T = V dA^T
//    give P^T and dS^T, then dV += P^T dA and dK += dS^T Q.  A live key
//    attends the sample's queries (under causal those from its own token on);
//    a key at or past the key end or dropped by kv_mask has an empty range
//    and gets zero dK and dV, and a CTA whose keys are all such stages
//    nothing.
// Every product is mma.sync m16n8k16 (bf16 operands, fp32 accumulation)
// through the warp tiles of mma_tiles.cuh; each CTA writes only its own
// rows' gradient columns: no atomics and no [R, D] tile, so any number of
// rows.  A query row with no valid key gets lse = +inf and zero dQ, and adds
// nothing to any dK or dV.
//
// Compile-time choices (BwdCfg): a causal mask or none, a kv_mask or none,
// and where the scale D^-1/2 applies: before dS is rounded to bf16 (K2 and
// K2-bd: the TPU _bwd_kernel and _bwd_kernel_bd round dS * D^-1/2) or to the
// float32 products dQ and dK before their cast (K6: dS rounded unscaled).  P
// is rounded to bf16 before dV = P^T dA in all.
//
// Own rows come in 16-row slots of one sample each (a sample's last slot
// partial), 4 a CTA: bd_fwd_tc_kernel's grouping, so no warp straddles two
// samples and a CTA stages only the samples its slots touch (at T 50 a CTA
// is one whole sample).  The grouping takes any B and T.
//
// What bounds it: at the CLIP shapes the function moves 110-140 MB (qkv's
// live rows and dA read once, dqkv written once) against 1-5 GFLOP (1-5 us
// at the bf16 tensor cores' peak), so bytes; what is left above that is each
// CTA's chain of copies, two passes and stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "merged_tiles.cuh"  // MtPlan and the merged-row helpers; mma_tiles.cuh

namespace mcl_bwd_tc {

struct BwdParams {
  const __nv_bfloat16* qkv;  // [B, T, 3 * H * D]
  const __nv_bfloat16* da;   // [B, T, H * D]
  __nv_bfloat16* dqkv;       // [B, T, 3 * H * D]
  float* ws;                 // [2, H, B * T]: lse, then delta
  const int* kv_mask;        // [B, T], read only when masked
  int B, T, H, t_real;
  float scale;               // D^-1/2
};

// Both launches for head dim D (16, 32 or 64).  K6 (scale_first false)
// takes neither mask.  Returns the first failing launch's cudaError_t
// (cudaErrorInvalidValue for a null workspace or mask, or another head
// dim).  Defined in merged_bwd_tc.cu.
cudaError_t launch(const BwdParams& p, int D, bool causal, bool masked, bool scale_first,
                   cudaStream_t stream);

}  // namespace mcl_bwd_tc

namespace {

template <bool kCausal_, bool kMasked_, bool kScaleFirst_>
struct BwdCfg {
  static constexpr bool kCausal = kCausal_, kMasked = kMasked_, kScaleFirst = kScaleFirst_;
};

// The CTA's own rows: the samples they touch (b0 .. b0 + ns - 1), the last
// own merged row, and the warp's rows [wr0, wr0 + wrows) (wrows 0: idle).
struct BwdTile {
  int b0, ns, r_last, wr0, wrows;
};

// The own rows of CTA blockIdx.x: slots 4 * blockIdx.x .. + 3, warp w
// taking slot 4 * blockIdx.x + w (past the last slot: idle).
__device__ __forceinline__ BwdTile bwd_tile(const mcl_bwd_tc::BwdParams& p) {
  const int spp = (p.T + 15) / 16, n_slots = p.B * spp;
  const int slot0 = 4 * blockIdx.x, slot_last = min(slot0 + 3, n_slots - 1);
  const int slot = slot0 + threadIdx.x / 32, wt0 = (slot % spp) * 16;
  BwdTile t;
  t.b0 = slot0 / spp;
  t.ns = slot_last / spp - t.b0 + 1;
  t.r_last = (slot_last / spp) * p.T + min(p.T, (slot_last % spp) * 16 + 16) - 1;
  t.wr0 = (slot / spp) * p.T + wt0;
  t.wrows = slot < n_slots ? min(16, p.T - wt0) : 0;
  return t;
}

// The warp's rows [0, nrows) of one tensor's D columns (row r at base +
// (row0 + r) * stride) -> dst [16][kD + 8] by cp.async; rows past nrows are
// zero-filled.
template <int kD>
__device__ __forceinline__ void bwd_warp_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                              long long stride, int row0, int nrows) {
  constexpr int kC = kD / 8;
  for (int i = threadIdx.x % 32; i < 16 * kC; i += 32) {
    const int r = i / kC, c = (i % kC) * 8;
    const bool ok = r < nrows;
    cp_async16_or_zero(dst + r * (kD + 8) + c,
                       base + (ok ? (long long)(row0 + r) * stride + c : 0), ok);
  }
}

// dQ, lse and delta of the CTA's query rows (own: Q, dA; staged: K, V).
// Below D 64 a budget of 4 CTAs an SM: without one ptxas spills at D 16.
template <int kD, typename Cfg>
__global__ void __launch_bounds__(kMtThreads, kD < 64 ? 4 : 1)
    bwd_dq_tc_kernel(mcl_bwd_tc::BwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mt_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mt_smem);  // [kMtRows][kD + 8]; then dQ
  bf16* dAs = Qs + kMtRows * (kD + 8);          // [kMtRows][kD + 8]
  bf16* Ks = dAs + kMtRows * (kD + 8);          // [kMtChunk][kD + 8]
  bf16* Vs = Ks + kMtChunk * (kD + 8);          // [kMtChunk][kD + 8]
  __shared__ MtPlan pl;

  const BwdTile tl = bwd_tile(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, h = blockIdx.y;
  const int n_rows = p.B * p.T;
  const long long stride = 3LL * p.H * kD, ostride = (long long)p.H * kD;
  const bf16* qb = p.qkv + h * kD;
  const bf16* kb = qb + p.H * kD;
  const bf16* vb = kb + p.H * kD;
  const int* kvm = Cfg::kMasked ? p.kv_mask : nullptr;

  bf16* Qw = Qs + 16 * warp * (kD + 8);
  bf16* dAw = dAs + 16 * warp * (kD + 8);
  bwd_warp_rows<kD>(Qw, qb, stride, tl.wr0, tl.wrows);
  bwd_warp_rows<kD>(dAw, p.da + h * kD, ostride, tl.wr0, tl.wrows);
  mt_key_ends(pl, kvm, p.T, p.t_real, tl.b0, tl.ns);
  // causal: no key past the CTA's last row of its last sample
  const int last_tok = tl.r_last - (tl.b0 + tl.ns - 1) * p.T;
  mt_offsets(pl, tl.ns, [&](int i, int kend) {
    return Cfg::kCausal && i == tl.ns - 1 ? min(kend, last_tok + 1) : kend;
  });
  const int n_ch = (pl.seg[tl.ns] + kMtChunk - 1) / kMtChunk;

  // the thread's rows (lane / 4 and + 8 of the warp's) and their compacted key ranges
  int lo[2], hi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rr = lane / 4 + 8 * hr, r = tl.wr0 + rr;
    lo[hr] = kMtEmpty;
    hi[hr] = 0;
    if (rr < tl.wrows) {
      const int i = r / p.T - tl.b0, tok = r - (r / p.T) * p.T;
      lo[hr] = pl.seg[i];
      hi[hr] = Cfg::kCausal ? min(pl.seg[i + 1], lo[hr] + tok + 1) : pl.seg[i + 1];
    }
  }
  int wlo, whi;
  mt_warp_range(lo, hi, wlo, whi);

  int n = n_ch > 0 ? mt_chunk_rows(pl, tl.ns, tl.b0, p.T, 0, kvm) : 0;
  mt_stage<kD>(Ks, kb, stride, pl, n);
  mt_stage<kD>(Vs, vb, stride, pl, n);
  cp_async_commit();

  float s[kMtSub / 8][4], dp[kMtSub / 8][4];
  // pass 1: per row m, l = sum exp(s - m) and u = sum exp(s - m) dp, online
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  for (int c = 0; c < n_ch; ++c) {
    const int cb = c * kMtChunk;
    if (c > 0) {
      n = mt_chunk_rows(pl, tl.ns, tl.b0, p.T, cb, kvm);
      mt_stage<kD>(Ks, kb, stride, pl, n);
      mt_stage<kD>(Vs, vb, stride, pl, n);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int jhi = min(whi - cb, n);
    for (int j0 = max(wlo - cb, 0) / kMtSub * kMtSub; j0 < jhi; j0 += kMtSub) {
      warp_scores<kD, kMtSub>(s, Qw, Ks + j0 * (kD + 8));
      warp_scores<kD, kMtSub>(dp, dAw, Vs + j0 * (kD + 8));
      mt_mask(s, pl, j0, cb, lo, hi, p.scale);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMtSub / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
        float sl = 0.f, su = 0.f;
#pragma unroll
        for (int j = 0; j < kMtSub / 8; ++j) {
          const float w0 = __expf(s[j][2 * hr] - m_use), w1 = __expf(s[j][2 * hr + 1] - m_use);
          sl += w0 + w1;
          su += w0 * dp[j][2 * hr] + w1 * dp[j][2 * hr + 1];
        }
        const float f = __expf(m[hr] - m_use);
        l[hr] = l[hr] * f + sl;
        u[hr] = u[hr] * f + su;
        m[hr] = m_new;
      }
    }
  }
  float m_use[2], inv[2], delta[2];
  float* ws_lse = p.ws + (size_t)h * n_rows;
  float* ws_delta = p.ws + ((size_t)p.H + h) * n_rows;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    u[hr] = quad_sum(u[hr]);
    m_use[hr] = m[hr] == -INFINITY ? 0.f : m[hr];
    inv[hr] = l[hr] > 0.f ? 1.f / l[hr] : 0.f;  // a row with no valid key: P = 0
    delta[hr] = u[hr] * inv[hr];
    const int rr = lane / 4 + 8 * hr;
    if (lane % 4 == 0 && rr < tl.wrows) {
      ws_lse[tl.wr0 + rr] = l[hr] > 0.f ? m[hr] + logf(l[hr]) : INFINITY;
      ws_delta[tl.wr0 + rr] = delta[hr];
    }
  }

  // pass 2: P = exp(s - m) / l, dS = P (dP - delta) (times D^-1/2 under
  // kScaleFirst) rounded to bf16, dQ += dS K
  const float ds_scale = Cfg::kScaleFirst ? p.scale : 1.f;
  float dq[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  for (int c = 0; c < n_ch; ++c) {
    const int cb = c * kMtChunk;
    if (n_ch > 1) {
      n = mt_chunk_rows(pl, tl.ns, tl.b0, p.T, cb, kvm);
      mt_stage<kD>(Ks, kb, stride, pl, n);
      mt_stage<kD>(Vs, vb, stride, pl, n);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int jhi = min(whi - cb, n);
    for (int j0 = max(wlo - cb, 0) / kMtSub * kMtSub; j0 < jhi; j0 += kMtSub) {
      warp_scores<kD, kMtSub>(s, Qw, Ks + j0 * (kD + 8));
      warp_scores<kD, kMtSub>(dp, dAw, Vs + j0 * (kD + 8));
      mt_mask(s, pl, j0, cb, lo, hi, p.scale);
#pragma unroll
      for (int j = 0; j < kMtSub / 8; ++j) {  // rows lane / 4 (e 0, 1) and + 8 (e 2, 3)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          s[j][e] = __expf(s[j][e] - m_use[hr]) * inv[hr] * (dp[j][e] - delta[hr]) * ds_scale;
        }
      }
      uint32_t dsa[kMtSub / 16][4];
      probs_to_a<kMtSub>(dsa, s);
      warp_pv<kD, kMtSub>(dq, dsa, Ks + j0 * (kD + 8));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into Qs has landed before it takes dQ
  const float out_scale = Cfg::kScaleFirst ? 1.f : p.scale;
  const float sc[2] = {out_scale, out_scale};
  bf16* dq_rows = p.dqkv + (size_t)tl.wr0 * stride + h * kD;
  warp_store_rows<kD>(dq, sc, Qw, tl.wrows, [&](int r) { return dq_rows + (size_t)r * stride; });
}

// dK and dV of the CTA's key rows (own: K, V; staged: Q, dA, lse, delta).
// A budget of CTAs an SM: 4 below D 64, as the dQ pass (without one ptxas
// spills K6's at D 16), and 3 at D 64 (at most 168 registers: left to
// itself ptxas takes 183-188 there, 2 CTAs an SM, which cost 7-10% at the
// CLIP shapes on an H100).
template <int kD, typename Cfg>
__global__ void __launch_bounds__(kMtThreads, kD < 64 ? 4 : 3)
    bwd_dkv_tc_kernel(mcl_bwd_tc::BwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mt_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(mt_smem);  // [kMtRows][kD + 8]; then dK
  bf16* Vs = Ks + kMtRows * (kD + 8);           // [kMtRows][kD + 8]; then dV
  bf16* Qs = Vs + kMtRows * (kD + 8);           // [kMtChunk][kD + 8]
  bf16* dAs = Qs + kMtChunk * (kD + 8);         // [kMtChunk][kD + 8]
  float* lse_s = reinterpret_cast<float*>(dAs + kMtChunk * (kD + 8));  // [kMtChunk]
  float* delta_s = lse_s + kMtChunk;                                    // [kMtChunk]
  __shared__ MtPlan pl;

  const BwdTile tl = bwd_tile(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, h = blockIdx.y;
  const int n_rows = p.B * p.T;
  const long long stride = 3LL * p.H * kD, ostride = (long long)p.H * kD;
  const bf16* qb = p.qkv + h * kD;
  const bf16* kb = qb + p.H * kD;
  const bf16* vb = kb + p.H * kD;
  const bf16* dab = p.da + h * kD;
  const float* ws_lse = p.ws + (size_t)h * n_rows;
  const float* ws_delta = p.ws + ((size_t)p.H + h) * n_rows;

  // the thread's key rows: live below min(T, t_real) where kv_mask keeps them
  const int kend = min(p.T, p.t_real);
  bool live[2];
  int tok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rr = lane / 4 + 8 * hr, r = tl.wr0 + rr;
    tok[hr] = r - (r / p.T) * p.T;
    live[hr] = rr < tl.wrows && tok[hr] < kend && (!Cfg::kMasked || p.kv_mask[r] != 0);
  }
  // a CTA with no live key stages nothing: its dK and dV are zero
  const bool any_live = __syncthreads_or(live[0] || live[1]);
  if (any_live) {
    bwd_warp_rows<kD>(Ks + 16 * warp * (kD + 8), kb, stride, tl.wr0, tl.wrows);
    bwd_warp_rows<kD>(Vs + 16 * warp * (kD + 8), vb, stride, tl.wr0, tl.wrows);
  }
  mt_offsets(pl, tl.ns, [&](int, int) { return p.T; });  // every query row of each sample
  const int n_ch = any_live ? (pl.seg[tl.ns] + kMtChunk - 1) / kMtChunk : 0;

  // each live key's compacted query range: its sample's rows (under causal
  // from its own token on); an empty range otherwise
  int lo[2], hi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = (tl.wr0 + lane / 4 + 8 * hr) / p.T - tl.b0;
    lo[hr] = live[hr] ? pl.seg[i] + (Cfg::kCausal ? tok[hr] : 0) : kMtEmpty;
    hi[hr] = live[hr] ? pl.seg[i + 1] : 0;
  }
  int wlo, whi;
  mt_warp_range(lo, hi, wlo, whi);

  const bf16* Kw = Ks + 16 * warp * (kD + 8);
  const bf16* Vw = Vs + 16 * warp * (kD + 8);
  const float ds_scale = Cfg::kScaleFirst ? p.scale : 1.f;
  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  float s[kMtSub / 8][4], dp[kMtSub / 8][4];
  for (int c = 0; c < n_ch; ++c) {
    const int cb = c * kMtChunk;
    const int n = mt_chunk_rows(pl, tl.ns, tl.b0, p.T, cb, nullptr);
    mt_stage<kD>(Qs, qb, stride, pl, n);
    mt_stage<kD>(dAs, dab, ostride, pl, n);
    cp_async_commit();
    for (int j = threadIdx.x; j < n; j += kMtThreads) {
      lse_s[j] = ws_lse[pl.orow[j]];
      delta_s[j] = ws_delta[pl.orow[j]];
    }
    cp_async_wait<0>();
    __syncthreads();
    const int jhi = min(whi - cb, n);
    const int t4 = lane % 4;
    for (int j0 = max(wlo - cb, 0) / kMtSub * kMtSub; j0 < jhi; j0 += kMtSub) {
      warp_scores<kD, kMtSub>(s, Kw, Qs + j0 * (kD + 8));    // S^T
      warp_scores<kD, kMtSub>(dp, Vw, dAs + j0 * (kD + 8));  // dP^T
      mt_mask(s, pl, j0, cb, lo, hi, p.scale);
#pragma unroll
      for (int j = 0; j < kMtSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = min(j0 + 8 * j + 2 * t4 + (e & 1), n - 1);  // masked past n
          s[j][e] = __expf(s[j][e] - lse_s[q]);                    // lse = +inf: 0
          dp[j][e] = s[j][e] * (dp[j][e] - delta_s[q]) * ds_scale;
        }
      }
      uint32_t pa[kMtSub / 16][4], dsa[kMtSub / 16][4];
      probs_to_a<kMtSub>(pa, s);
      probs_to_a<kMtSub>(dsa, dp);
      warp_pv<kD, kMtSub>(dv, pa, dAs + j0 * (kD + 8));
      warp_pv<kD, kMtSub>(dk, dsa, Qs + j0 * (kD + 8));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into Ks and Vs has landed before they take dK, dV
  const float out_scale = Cfg::kScaleFirst ? 1.f : p.scale;
  const float sc[2] = {out_scale, out_scale}, one[2] = {1.f, 1.f};
  bf16* dk_rows = p.dqkv + (size_t)tl.wr0 * stride + p.H * kD + h * kD;
  warp_store_rows<kD>(dk, sc, Ks + 16 * warp * (kD + 8), tl.wrows,
                      [&](int r) { return dk_rows + (size_t)r * stride; });
  warp_store_rows<kD>(dv, one, Vs + 16 * warp * (kD + 8), tl.wrows,
                      [&](int r) { return dk_rows + (size_t)r * stride + p.H * kD; });
}

template <int kD, typename Cfg>
cudaError_t launch_bwd_tc(const mcl_bwd_tc::BwdParams& p, cudaStream_t stream) {
  const size_t el = sizeof(__nv_bfloat16) * (kD + 8);
  const size_t smem_dq = el * (2 * kMtRows + 2 * kMtChunk);
  const size_t smem_dkv = smem_dq + 2 * sizeof(float) * kMtChunk;
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_tc_kernel<kD, Cfg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv_tc_kernel<kD, Cfg>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const long long n_slots = (long long)p.B * ((p.T + 15) / 16);
  const dim3 grid((unsigned)((n_slots + 3) / 4), p.H);
  bwd_dq_tc_kernel<kD, Cfg><<<grid, kMtThreads, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_tc_kernel<kD, Cfg><<<grid, kMtThreads, smem_dkv, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
