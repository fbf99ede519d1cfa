// K2-bd: the token-major attention core on rows merged across samples
// (block-diagonal), forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels multimodal_concept_learning_tpu/ops/
// attention_core.py:_fwd_kernel_bd (:179) and _bwd_kernel_bd (:203), called
// through _core_call (pallas_call at :303, block_diag=True) under the custom
// VJP at :315-342 when MCL_ATTN_CORE_BD=1.
//
// The function is K2's (attention_core.cu): qkv [B, T, 3*H*D] -> out [B, T,
// H*D] per (sample, head), with the same masks, the same rounding (P cast to
// the compute dtype before P.V; backward dS * D^-1/2 cast before dQ and dK)
// and the same rows with no valid key (zero output, lse = +inf, no
// gradient).  Every row with a valid key equals K2's.  What differs is the
// tiling: the TPU kernels merge a block of samples into one [bblk*T,
// bblk*T] score tile per head with cross-sample entries masked, so the
// short sequences fill the matrix unit.  This port carries the idea, not
// the VMEM block: the forward runs one CTA per (64 rows merged across the
// whole batch, head), so no query row of a tile is idle (vision T = 50:
// 2,400 CTAs instead of K2's 3,072 with 22% of their rows idle; text T =
// 77: 2,464 instead of 4,096), and its keys are the span of the samples its
// rows touch, cross-sample keys masked; a 32-key tile no row may attend
// (past each caption's last valid key) is skipped.  The backward is
// merged_bwd_kernel<T, false> (merged_attention.cuh): a CTA per (head, bblk
// whole samples merged into <= 640 rows), no atomics.
//
// What bounds it: the same as K2, memory at the CLIP shapes (0.2-0.5 GFLOP
// a launch against 23-42 us of bytes at 3.35 TB/s).  This first version
// computes in fp32 on the CUDA cores and the merged tiles add cross-sample
// arithmetic (a 64-row tile over ~2.3 samples scores ~150 keys a row where
// K2 scores 64), so it is bound by its own arithmetic and shared-memory
// traffic, as K2 is; chip_smoke times the two side by side.

#include "merged_attention.cuh"

namespace {

constexpr int kBQ = 64;  // forward query rows per CTA

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) bd_fwd_kernel(MergedParams p, void* out_, float* lse) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kBQ][kD]
  float* Ks = Qs + kBQ * kD;                 // [kBK][kD + 1]
  float* Vs = Ks + kBK * (kD + 1);           // [kBK][kD]
  float* Ss = Vs + kBK * kD;                 // [kBQ][kBK + 1]
  float* row_m = Ss + kBQ * (kBK + 1);       // [kBQ]
  float* row_l = row_m + kBQ;                // [kBQ]
  int* s_kend = reinterpret_cast<int*>(row_l + kBQ);  // [kBQ + 1] samples a tile touches

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rows = p.B * p.T;
  const int r0 = blockIdx.x * kBQ, h = blockIdx.y;
  const int r_last = min(r0 + kBQ, n_rows) - 1;
  const int b0 = r0 / p.T, b1 = r_last / p.T;
  const long long stride = 3LL * p.H * kD;
  const T* qb = static_cast<const T*>(p.qkv) + h * kD;
  const T* kb = qb + p.H * kD;
  const T* vb = kb + p.H * kD;
  T* o = static_cast<T*>(out_);

  sample_key_ends(p, b0, b1 - b0 + 1, s_kend);
  load_rows<T, kD>(Qs, kD, qb, stride, r0, kBQ, n_rows);
  for (int r = tid; r < kBQ; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }
  // keys: from the first row's sample to the last sample's key end
  const int k_lo = b0 * p.T;
  int k_hi = b1 * p.T + s_kend[b1 - b0];
  if (p.causal) k_hi = min(k_hi, r_last + 1);

  constexpr int kORS = kThreads / kD;  // output: column od, rows orow0 + i * kORS
  constexpr int kNO = kBQ / kORS;
  const int od = tid % kD, orow0 = tid / kD;
  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
  constexpr int kSRS = kThreads / kBK;  // scores: key column sc, rows srow0 + i * kSRS
  constexpr int kNS = kBQ / kSRS;
  const int sc = tid % kBK, srow0 = tid / kBK;

  // pass 0: each row's max and sum over its valid keys (online);
  // pass 1: P = exp(s - max) / sum rounded to T, then acc += P V
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = k_lo; kt < k_hi; kt += kBK) {
      // skip a tile no row may attend; also the barrier after the last tile's readers
      const bool live = tid < kBK && key_live(p, kt + tid, k_hi, 0, s_kend, b0);
      if (!__syncthreads_or(live)) continue;
      load_rows<T, kD>(Ks, kD + 1, kb, stride, kt, kBK, n_rows);
      if (pass == 1) load_rows<T, kD>(Vs, kD, vb, stride, kt, kBK, n_rows);
      __syncthreads();
      {
        float s[kNS];
#pragma unroll
        for (int i = 0; i < kNS; ++i) s[i] = 0.f;
        const float* kr = Ks + sc * (kD + 1);
        for (int d = 0; d < kD; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int i = 0; i < kNS; ++i) s[i] = fmaf(Qs[(srow0 + i * kSRS) * kD + d], kd, s[i]);
        }
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int r = srow0 + i * kSRS;
          Ss[r * (kBK + 1) + sc] = merged_valid(p, r0 + r, kt + sc, n_rows, 0, s_kend, b0)
                                       ? s[i] * p.scale : -INFINITY;
        }
      }
      __syncthreads();
      // one warp per row, one lane per key
      for (int r = warp; r < kBQ; r += kThreads / 32) {
        const float x = Ss[r * (kBK + 1) + lane];
        if (pass == 0) {
          const float m_old = row_m[r];
          const float m_new = fmaxf(m_old, warp_max(x));
          const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
          const float sum = warp_sum(expf(x - m_use));
          if (lane == 0) {
            row_l[r] = row_l[r] * expf(m_old - m_use) + sum;
            row_m[r] = m_new;
          }
        } else {
          const float l = row_l[r];  // 0 on a row with no valid key: P = 0
          Ss[r * (kBK + 1) + lane] = l > 0.f ? round_to<T>(expf(x - row_m[r]) / l) : 0.f;
        }
      }
      if (pass == 1) {
        __syncthreads();
        for (int c = 0; c < kBK; ++c) {
          const float vx = Vs[c * kD + od];
#pragma unroll
          for (int i = 0; i < kNO; ++i)
            acc[i] = fmaf(Ss[(orow0 + i * kORS) * (kBK + 1) + c], vx, acc[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    const int t = r0 + orow0 + i * kORS;
    if (t < n_rows) store_f(o + (size_t)t * p.H * kD + h * kD + od, acc[i]);
  }
  if (lse != nullptr) {
    for (int r = tid; r < kBQ; r += kThreads) {
      const int t = r0 + r;
      if (t < n_rows) {
        const int b = t / p.T;
        const float l = row_l[r];
        lse[((size_t)b * p.H + h) * p.T + (t - b * p.T)] = l > 0.f ? row_m[r] + logf(l) : INFINITY;
      }
    }
  }
}

template <int kD>
size_t bd_fwd_smem() {
  return sizeof(float) * (kBQ * kD + kBK * (kD + 1) + kBK * kD + kBQ * (kBK + 1) + 2 * kBQ) +
         sizeof(int) * (kBQ + 1);
}

template <typename T, int kD>
cudaError_t launch_bd_fwd(const MergedParams& p, void* out, float* lse, cudaStream_t stream) {
  const size_t smem = bd_fwd_smem<kD>();
  cudaError_t err = cudaFuncSetAttribute(bd_fwd_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)p.B * p.T;
  const dim3 grid((unsigned)((n_rows + kBQ - 1) / kBQ), p.H);
  bd_fwd_kernel<T, kD><<<grid, kThreads, smem, stream>>>(p, out, lse);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int mcl_attention_core_bd_fwd(const void* qkv, void* out, float* lse,
                                         const int* kv_mask, int B, int T, int H, int D,
                                         int t_real, int causal, float scale, int dtype,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  MergedParams p{qkv, nullptr, nullptr, nullptr, kv_mask, nullptr, B, T, H, t_real, causal,
                 scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0 ? launch_bd_fwd<float, kD>(p, out, lse, s)
                      : launch_bd_fwd<__nv_bfloat16, kD>(p, out, lse, s);
  });
}

extern "C" int mcl_attention_core_bd_bwd(const void* qkv, const void* out, const void* dout,
                                         const float* lse, const int* kv_mask, void* dqkv, int B,
                                         int T, int H, int D, int t_real, int causal, float scale,
                                         int bblk, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || bblk <= 0 || (long long)bblk * T > kMaxRows || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  MergedParams p{qkv, out, dout, lse, kv_mask, dqkv, B, T, H, t_real, causal, scale, bblk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0 ? launch_merged_bwd<float, false, kD>(p, s)
                      : launch_merged_bwd<__nv_bfloat16, false, kD>(p, s);
  });
}
