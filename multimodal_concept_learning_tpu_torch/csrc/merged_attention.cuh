// Attention over rows merged across samples, shared by K2-bd
// (attention_core_bd.cu) and K6 (fused_attention_block.cu); K2
// (attention_core.cu) takes its tile helpers (load_rows, with_head_dim).
//
// Rows of consecutive samples of T tokens are merged: merged row r of a
// range that starts at a sample boundary is token r % T of sample r / T.
// Key c may be attended by query r iff both lie in the range, they belong
// to the same sample (the block-diagonal mask of the TPU kernels'
// _flat_mask / _block_mask), c's token is below that sample's key end (one
// past its last key below t_real that the mask keeps), c is not after r
// under causal, and the mask keeps c.  A row with no valid key gets a zero
// output, lse = +inf and no gradient.
//
// The float32 backward kernel (merged_bwd_kernel) is the one float32
// gradient routine of both pairs (bf16 takes the tensor-core pair of
// merged_bwd_tc.cuh), a template over kFused:
// - K2-bd (kFused = false): lse from the forward, delta = rowsum(dA * out)
//   as K2 has it, dS * D^-1/2 rounded to the compute dtype before dQ and dK;
// - K6 (kFused = true, the TPU _bwd_attn_kernel): only qkv and dA come in,
//   so lse and delta = rowsum(dP * P) are recomputed for every row first;
//   dS is rounded unscaled and D^-1/2 applied to dQ and dK in float32
//   before their cast.  P is rounded to the compute dtype before dV = P^T dA
//   in both.
// One CTA owns a head of `bblk` whole samples merged into R = bblk * T <=
// 640 rows and writes their dQ, dK and dV (no atomics): it walks 32-key
// tiles (dK, dV in registers) and, inside, the 32-query tiles that share a
// sample with the key tile; dQ accumulates in a [R, D] float32 tile in
// shared memory.  The head dim D is a template parameter (kHeadDims: 16
// and 64, the head dims of every ViT and CLIP preset, and 32, which no
// preset has); with_head_dim maps the runtime value to it.  Merging fills the 32-row tiles across sample boundaries
// (T = 50: one sample alone leaves 14 of 64 rows idle), at the price of the
// cross-sample entries of tiles that straddle two samples.  fp32 CUDA-core
// arithmetic: bound by its own arithmetic and shared-memory traffic, like K2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {  // internal linkage: each source that includes this compiles its own copy

using mcl_flash::kThreads;
using mcl_flash::load_f;
using mcl_flash::store_f;
using mcl_flash::warp_max;
using mcl_flash::warp_sum;

constexpr int kBK = 32;         // keys per tile == warp width
constexpr int kBQB = 32;        // backward queries per tile
constexpr int kMaxRows = 640;   // fp32 backward: dQ tile [R, D] fp32 in smem (D = 64: 160 KB)

// f(std::integral_constant<int, D>{}) for a head dim the kernels are built
// for (D divides the 256 threads and is a multiple of 16-byte loads);
// cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

struct MergedParams {
  const void* qkv;      // [B, T, 3 * H * D]
  const void* out;      // K2-bd backward: the forward's output [B, T, H * D]
  const void* dout;     // dA [B, T, H * D]
  const float* lse;     // K2-bd backward: the forward's lse [B, H, T]
  const int* kv_mask;   // nullable, [B, T]
  void* dqkv;           // [B, T, 3 * H * D]
  int B, T, H, t_real, causal;
  float scale;
  int bblk;             // backward: samples per CTA
};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

// value rounded to the storage type T and back (the TPU kernel's astype(cdt))
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [row0, row0 + nrows) of one head's D columns -> dst[r * ld + d] (fp32),
// 16-byte loads; rows at or past n_rows read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base, long long stride,
                                          int row0, int nrows, int n_rows) {
  constexpr int N = Vec<T>::N;
  constexpr int C = D / N;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * C; i += kThreads) {
    const int r = i / C, c = (i % C) * N, t = row0 + r;
    float v[N];
    if (t < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (size_t)t * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = load_f(e + j);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) dst[r * ld + c + j] = v[j];
  }
}

// s_kend[i] = the key end of sample sb + i, for i < ns.  Ends with a barrier.
__device__ __forceinline__ void sample_key_ends(const MergedParams& p, int sb, int ns,
                                                int* s_kend) {
  const int hi = min(p.T, p.t_real);
  for (int i = threadIdx.x; i < ns; i += kThreads) s_kend[i] = p.kv_mask == nullptr ? hi : 0;
  __syncthreads();
  if (p.kv_mask == nullptr) return;
  for (int i = threadIdx.x; i < ns * hi; i += kThreads) {
    const int s = i / hi, c = i % hi;
    if (p.kv_mask[(size_t)(sb + s) * p.T + c] != 0) atomicMax(&s_kend[s], c + 1);
  }
  __syncthreads();
}

// Key c valid for query r: both merged indices relative to `base_row` (a
// sample boundary), below n_rows; s_kend indexed by sample - s0.
__device__ __forceinline__ bool merged_valid(const MergedParams& p, int r, int c, int n_rows,
                                             size_t base_row, const int* s_kend, int s0) {
  if (r >= n_rows || c >= n_rows) return false;
  const int br = r / p.T, bc = c / p.T;
  if (br != bc) return false;
  const int tc = c - bc * p.T;
  if (tc >= s_kend[bc - s0]) return false;
  if (p.causal && tc > r - br * p.T) return false;
  return p.kv_mask == nullptr || p.kv_mask[base_row + c] != 0;
}

// Whether key c (< k_hi) can be valid for any row: its token below its
// sample's key end and kept by the mask.
__device__ __forceinline__ bool key_live(const MergedParams& p, int c, int k_hi, size_t base_row,
                                         const int* s_kend, int s0) {
  if (c >= k_hi) return false;
  const int bc = c / p.T;
  if (c - bc * p.T >= s_kend[bc - s0]) return false;
  return p.kv_mask == nullptr || p.kv_mask[base_row + c] != 0;
}

// The 32 x 32 tile's dot products of the thread: rows srow0 + i * 8 of Qs
// (and dAs) with key column sc of Ks (and Vs); every tile [32][kD + 1].
template <int kD, bool kDp>
__device__ __forceinline__ void tile_dots(const float* Qs, const float* Ks, const float* dAs,
                                          const float* Vs, int srow0, int sc, float (&s)[4],
                                          float (&dp)[4]) {
  constexpr int kSRS = kThreads / kBK;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
  const float* kr = Ks + sc * (kD + 1);
  const float* vr = Vs + sc * (kD + 1);
  for (int d = 0; d < kD; ++d) {
    const float kd = kr[d];
    const float vd = kDp ? vr[d] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = srow0 + i * kSRS;
      s[i] = fmaf(Qs[r * (kD + 1) + d], kd, s[i]);
      if (kDp) dp[i] = fmaf(dAs[r * (kD + 1) + d], vd, dp[i]);
    }
  }
}

// K6: lse and delta = rowsum(dP * P) of each of the R rows into lse_s and
// delta_s (float32), from qkv and dA alone.
template <int kD>
__device__ void merged_stats(const MergedParams& p, int R, size_t row0, const float* qb,
                             const float* kb, const float* vb, const float* dab, long long stride,
                             long long ostride,
                             const int* s_kend, float* Qs, float* dAs, float* Ks, float* Vs,
                             float* Ws, float* lse_s, float* delta_s) {
  constexpr int kSRS = kThreads / kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sc = tid % kBK, srow0 = tid / kBK;
  for (int qt = 0; qt < R; qt += kBQB) {
    const int q_last = min(qt + kBQB, R) - 1;
    const int sq0 = qt / p.T, sq1 = q_last / p.T;
    const int k_lo = sq0 * p.T;
    int k_hi = sq1 * p.T + s_kend[sq1];
    if (p.causal) k_hi = min(k_hi, q_last + 1);
    __syncthreads();  // the previous tile's readers are done
    load_rows<float, kD>(Qs, kD + 1, qb, stride, qt, kBQB, R);
    load_rows<float, kD>(dAs, kD + 1, dab, ostride, qt, kBQB, R);
    for (int r = tid; r < kBQB; r += kThreads) {
      if (qt + r < R) {
        lse_s[qt + r] = -INFINITY;  // running max, then lse
        delta_s[qt + r] = 0.f;      // running sum, then delta
      }
    }
    // pass 0: row max and sum (online); pass 1: delta += P * dP
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = k_lo; kt < k_hi; kt += kBK) {
        const bool live = tid < kBK && key_live(p, kt + tid, k_hi, row0, s_kend, 0);
        if (!__syncthreads_or(live)) continue;
        load_rows<float, kD>(Ks, kD + 1, kb, stride, kt, kBK, R);
        if (pass == 1) load_rows<float, kD>(Vs, kD + 1, vb, stride, kt, kBK, R);
        __syncthreads();
        float s[4], dp[4];
        if (pass == 0) {
          tile_dots<kD, false>(Qs, Ks, dAs, Vs, srow0, sc, s, dp);
        } else {
          tile_dots<kD, true>(Qs, Ks, dAs, Vs, srow0, sc, s, dp);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = srow0 + i * kSRS, t = qt + r;
          const bool ok = merged_valid(p, t, kt + sc, R, row0, s_kend, 0);
          float w;
          if (pass == 0) {
            w = ok ? s[i] * p.scale : -INFINITY;
          } else {
            w = ok ? expf(s[i] * p.scale - lse_s[t]) * dp[i] : 0.f;  // lse = +inf -> 0
          }
          Ws[r * (kBK + 1) + sc] = w;
        }
        __syncthreads();
        for (int r = warp; r < kBQB; r += kThreads / 32) {
          const int t = qt + r;
          const float x = Ws[r * (kBK + 1) + lane];
          if (pass == 0) {
            const float m_old = t < R ? lse_s[t] : 0.f;
            const float m_new = fmaxf(m_old, warp_max(x));
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float sum = warp_sum(expf(x - m_use));
            if (lane == 0 && t < R) {
              delta_s[t] = delta_s[t] * expf(m_old - m_use) + sum;
              lse_s[t] = m_new;
            }
          } else {
            const float sum = warp_sum(x);
            if (lane == 0 && t < R) delta_s[t] += sum;
          }
        }
      }
      __syncthreads();
      if (pass == 0) {
        for (int r = tid; r < kBQB; r += kThreads) {
          const int t = qt + r;
          if (t < R) {
            const float l = delta_s[t];
            lse_s[t] = l > 0.f ? lse_s[t] + logf(l) : INFINITY;
            delta_s[t] = 0.f;
          }
        }
      }
    }
  }
  __syncthreads();
}

template <bool kFused, int kD>
__global__ void __launch_bounds__(kThreads) merged_bwd_kernel(MergedParams p) {
  extern __shared__ float smem[];
  const int sb = blockIdx.y * p.bblk;  // the CTA's first sample
  const int ns = min(p.bblk, p.B - sb);
  const int R = ns * p.T;
  float* dQ = smem;                           // [R][kD] fp32 accumulator
  float* Qs = dQ + (size_t)R * kD;            // [kBQB][kD + 1]
  float* dAs = Qs + kBQB * (kD + 1);          // [kBQB][kD + 1]
  float* Ks = dAs + kBQB * (kD + 1);          // [kBK][kD + 1]
  float* Vs = Ks + kBK * (kD + 1);            // [kBK][kD + 1]
  float* Ps = Vs + kBK * (kD + 1);            // [kBQB][kBK + 1] P, rounded
  float* dSs = Ps + kBQB * (kBK + 1);         // [kBQB][kBK + 1] dS (* scale), rounded
  float* lse_s = dSs + kBQB * (kBK + 1);      // [R]
  float* delta_s = lse_s + R;                 // [R]
  int* s_kend = reinterpret_cast<int*>(delta_s + R);  // [bblk]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x;
  const long long stride = 3LL * p.H * kD, ostride = (long long)p.H * kD;
  const size_t row0 = (size_t)sb * p.T;
  const float* qb = static_cast<const float*>(p.qkv) + row0 * stride + h * kD;
  const float* kb = qb + p.H * kD;
  const float* vb = kb + p.H * kD;
  const float* dab = static_cast<const float*>(p.dout) + row0 * ostride + h * kD;
  float* dq_out = static_cast<float*>(p.dqkv) + row0 * stride + h * kD;
  float* dk_out = dq_out + p.H * kD;
  float* dv_out = dk_out + p.H * kD;

  sample_key_ends(p, sb, ns, s_kend);
  for (int i = tid; i < R * kD; i += kThreads) dQ[i] = 0.f;
  if constexpr (kFused) {
    merged_stats<kD>(p, R, row0, qb, kb, vb, dab, stride, ostride, s_kend, Qs, dAs, Ks, Vs, Ps,
                    lse_s, delta_s);
  } else {
    // delta = rowsum(dA * out), lse from the forward: one warp per row
    const float* ob = static_cast<const float*>(p.out) + row0 * ostride + h * kD;
    for (int t = warp; t < R; t += kThreads / 32) {
      float x = 0.f;
      for (int d = lane; d < kD; d += 32)
        x += load_f(dab + (size_t)t * ostride + d) * load_f(ob + (size_t)t * ostride + d);
      x = warp_sum(x);
      if (lane == 0) {
        const int b = sb + t / p.T;
        delta_s[t] = x;
        lse_s[t] = p.lse[((size_t)b * p.H + h) * p.T + t % p.T];
      }
    }
  }

  constexpr int kRS = kThreads / kD;  // dK/dV/dQ: column cd, rows crow0 + i * kRS
  constexpr int kNK = kBK / kRS;
  constexpr int kNQ = kBQB / kRS;
  const int cd = tid % kD, crow0 = tid / kD;
  constexpr int kSRS = kThreads / kBK;  // scores: key column sc, rows srow0 + i * kSRS
  const int sc = tid % kBK, srow0 = tid / kBK;
  const float ds_scale = kFused ? 1.f : p.scale;  // K2 rounds dS * scale, K6 dS
  const float out_scale = kFused ? p.scale : 1.f;

  for (int kt = 0; kt < R; kt += kBK) {
    float dk[kNK], dv[kNK];
#pragma unroll
    for (int i = 0; i < kNK; ++i) dk[i] = dv[i] = 0.f;
    // also the barrier after the previous tile's readers of Ks/Vs
    const bool live = tid < kBK && key_live(p, kt + tid, R, row0, s_kend, 0);
    if (__syncthreads_or(live)) {
      load_rows<float, kD>(Ks, kD + 1, kb, stride, kt, kBK, R);
      load_rows<float, kD>(Vs, kD + 1, vb, stride, kt, kBK, R);
      // the query tiles that share a sample with this key tile
      const int k_last = min(kt + kBK, R) - 1;
      const int q_lo = p.causal ? kt : (kt / p.T) * p.T;
      const int q_hi = min(R, (k_last / p.T + 1) * p.T);
      for (int qt = (q_lo / kBQB) * kBQB; qt < q_hi; qt += kBQB) {
        load_rows<float, kD>(Qs, kD + 1, qb, stride, qt, kBQB, R);
        load_rows<float, kD>(dAs, kD + 1, dab, ostride, qt, kBQB, R);
        __syncthreads();
        {
          float s[4], dp[4];
          tile_dots<kD, true>(Qs, Ks, dAs, Vs, srow0, sc, s, dp);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = srow0 + i * kSRS, t = qt + r;
            float pr = 0.f, ds = 0.f;
            if (merged_valid(p, t, kt + sc, R, row0, s_kend, 0)) {
              pr = expf(s[i] * p.scale - lse_s[t]);  // lse = +inf -> 0
              ds = pr * (dp[i] - delta_s[t]);
            }
            Ps[r * (kBK + 1) + sc] = pr;
            dSs[r * (kBK + 1) + sc] = ds * ds_scale;
          }
        }
        __syncthreads();
        // dV += P^T dA, dK += dS^T Q for this key tile; dQ += dS K
#pragma unroll
        for (int i = 0; i < kNK; ++i) {
          const int c = crow0 + i * kRS;
          float av = 0.f, ak = 0.f;
          for (int r = 0; r < kBQB; ++r) {
            av = fmaf(Ps[r * (kBK + 1) + c], dAs[r * (kD + 1) + cd], av);
            ak = fmaf(dSs[r * (kBK + 1) + c], Qs[r * (kD + 1) + cd], ak);
          }
          dv[i] += av;
          dk[i] += ak;
        }
#pragma unroll
        for (int i = 0; i < kNQ; ++i) {
          const int r = crow0 + i * kRS, t = qt + r;
          if (t < R) {
            float a = 0.f;
            for (int c = 0; c < kBK; ++c)
              a = fmaf(dSs[r * (kBK + 1) + c], Ks[c * (kD + 1) + cd], a);
            dQ[t * kD + cd] += a;
          }
        }
        __syncthreads();
      }
    }
    // keys no row may attend get zero gradients
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      const int key = kt + crow0 + i * kRS;
      if (key < R) {
        store_f(dk_out + (size_t)key * stride + cd, dk[i] * out_scale);
        store_f(dv_out + (size_t)key * stride + cd, dv[i]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * kD; i += kThreads)
    store_f(dq_out + (size_t)(i / kD) * stride + i % kD, dQ[i] * out_scale);
}

template <int kD>
size_t merged_bwd_smem(int rows, int bblk) {
  return sizeof(float) * ((size_t)rows * kD + 2 * kBQB * (kD + 1) + 2 * kBK * (kD + 1) +
                          2 * kBQB * (kBK + 1) + 2 * (size_t)rows) +
         sizeof(int) * (size_t)bblk;
}

template <bool kFused, int kD>
cudaError_t launch_merged_bwd(const MergedParams& p, cudaStream_t stream) {
  const size_t smem = merged_bwd_smem<kD>(p.bblk * p.T, p.bblk);
  cudaError_t err = cudaFuncSetAttribute(merged_bwd_kernel<kFused, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.B + p.bblk - 1) / p.bblk);
  merged_bwd_kernel<kFused, kD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
