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
// the VMEM block, at each kernel's own grain.
//
// What bounds it: the same as K2, memory at the CLIP shapes (0.2-0.5 GFLOP
// a launch against 15-24 us of bytes at 3.35 TB/s).
// - Forward, bf16 (bd_fwd_tc_kernel): the tensor cores, merged at the
//   grain of the mma's 16 rows.  A sample's rows form slots of 16 (its
//   last slot partial) and a CTA of 4 warps takes 4 consecutive slots, so
//   a CTA spans samples and a warp never does (text T = 77: 5 slots a
//   sample, 2,560 CTAs, 4% of rows idle, where K2 has 4,096 CTAs, half of
//   them holding 13 rows; vision T = 50: one sample a CTA, as K2).  The
//   keys staged are only each touched sample's live segment, compacted
//   (merged_tiles.cuh: tokens below its key end, cut at the CTA's last row
//   of it under causal): a text CTA over two 13-token captions stages <= 26
//   keys where the span of the two samples holds 154.  S = Q K^T and O +=
//   P V on mma.sync m16n8k16, two passes (the row max and sum online, then
//   P = bf16(exp(s - m) / l) before P.V, the TPU kernel's rounding), each
//   warp over the 32-key sub-tiles of its own sample; where the keys fit
//   one chunk (both CLIP shapes) V's copy overlaps pass 1 and pass 2
//   rereads shared memory only.  What is left is bytes and latency: q read
//   once, k and v of the live keys read by each CTA of their sample, out
//   written once.  (Merging 64 consecutive rows instead, as the fp32 kernel
//   does, makes the vision tiles straddle 2-3 samples: 1.5x the key bytes
//   and every straddling warp scoring two samples' keys, 19% slower there.)
// - Forward, fp32 (bd_fwd_kernel): the CUDA cores (no TF32), one CTA per
//   (64 rows merged across the whole batch, head), its keys the span of
//   the samples the rows touch, cross-sample keys masked, a 32-key tile no
//   row may attend skipped.
// - Backward, bf16: the tensor-core pair shared with K2 and K6
//   (merged_bwd_tc.cuh, K2's choices), so the same kernels as K2's: own rows
//   in 16-row slots of one sample each, 4 a CTA (bblk is not read), any T;
//   lse and delta = rowsum(dP * P) recomputed from qkv and dA (the
//   forward's out and lse are not taken) through a float32 workspace [2, H,
//   B*T] that the wrapper allocates.
// - Backward, fp32: merged_bwd_kernel<false> (merged_attention.cuh):
//   a CTA per (head, bblk whole samples merged into <= 640 rows), no
//   atomics, on the CUDA cores.

#include "merged_attention.cuh"
#include "merged_bwd_tc.cuh"  // the bf16 backward; merged_tiles.cuh

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

// bf16: one CTA per (4 slots of 16 rows, head), 4 warps on the tensor cores
// (the file's note; merged_tiles.cuh).  A budget of 4 CTAs an SM: without
// one ptxas spills at D 16.
template <int kD>
__global__ void __launch_bounds__(kMtThreads, 4) bd_fwd_tc_kernel(MergedParams p, void* out_,
                                                               float* lse) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mt_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mt_smem);  // [kMtRows][kD + 8]; then the output
  bf16* Ks = Qs + kMtRows * (kD + 8);           // [kMtChunk][kD + 8]
  bf16* Vs = Ks + kMtChunk * (kD + 8);          // [kMtChunk][kD + 8]
  __shared__ MtPlan pl;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, h = blockIdx.y;
  // slots: a sample's rows in groups of 16 (its last slot partial); warp w
  // owns slot 4 * blockIdx.x + w, rows [wr0, wr0 + wrows) of sample wb
  const int spp = (p.T + 15) / 16, n_slots = p.B * spp;
  const int slot0 = 4 * blockIdx.x, slot_last = min(slot0 + 3, n_slots - 1);
  const int b0 = slot0 / spp, ns = slot_last / spp - b0 + 1;
  const int slot = slot0 + warp, wb = slot / spp, wt0 = (slot % spp) * 16;
  const int wrows = slot < n_slots ? min(16, p.T - wt0) : 0;
  const int wr0 = wb * p.T + wt0;
  const long long stride = 3LL * p.H * kD;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + h * kD;
  const bf16* kb = qb + p.H * kD;
  const bf16* vb = kb + p.H * kD;

  bf16* Qw = Qs + 16 * warp * (kD + 8);  // the warp's Q rows, later its output rows
  for (int i = lane; i < 16 * (kD / 8); i += 32) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    const bool ok = r < wrows;
    cp_async16_or_zero(Qw + r * (kD + 8) + c, qb + (ok ? (long long)(wr0 + r) * stride + c : 0),
                       ok);
  }
  mt_key_ends(pl, p.kv_mask, p.T, p.t_real, b0, ns);
  // causal: no key past the CTA's last row of the sample (only the last sample is cut)
  const int last_tok = min(p.T, (slot_last % spp) * 16 + 16) - 1;
  mt_offsets(pl, ns, [&](int i, int kend) {
    return p.causal && i == ns - 1 ? min(kend, last_tok + 1) : kend;
  });
  const int n_other = pl.seg[ns];
  const int n_ch = (n_other + kMtChunk - 1) / kMtChunk;

  // the thread's rows (tokens wt0 + lane / 4 and + 8 of sample wb) and their
  // compacted key ranges
  int lo[2], hi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rr = lane / 4 + 8 * hr;
    lo[hr] = kMtEmpty;
    hi[hr] = 0;
    if (rr < wrows) {
      lo[hr] = pl.seg[wb - b0];
      hi[hr] = p.causal ? min(pl.seg[wb - b0 + 1], lo[hr] + wt0 + rr + 1) : pl.seg[wb - b0 + 1];
    }
  }
  int wlo, whi;
  mt_warp_range(lo, hi, wlo, whi);

  // group 1: Q and chunk 0's K; group 2: chunk 0's V when one chunk holds
  // every key (it lands while pass 1 runs), else empty
  int n = n_ch > 0 ? mt_chunk_rows(pl, ns, b0, p.T, 0, p.kv_mask) : 0;
  mt_stage<kD>(Ks, kb, stride, pl, n);
  cp_async_commit();
  if (n_ch == 1) mt_stage<kD>(Vs, vb, stride, pl, n);
  cp_async_commit();

  float s[kMtSub / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

  // pass 1: each row's max and sum over its valid keys (online)
  for (int c = 0; c < n_ch; ++c) {
    const int cb = c * kMtChunk;
    if (c > 0) {
      n = mt_chunk_rows(pl, ns, b0, p.T, cb, p.kv_mask);
      mt_stage<kD>(Ks, kb, stride, pl, n);
      cp_async_commit();
    }
    if (c == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int jhi = min(whi - cb, n);
    for (int j0 = max(wlo - cb, 0) / kMtSub * kMtSub; j0 < jhi; j0 += kMtSub) {
      warp_scores<kD, kMtSub>(s, Qw, Ks + j0 * (kD + 8));
      mt_mask(s, pl, j0, cb, lo, hi, p.scale);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMtSub / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kMtSub / 8; ++j)
          sum += __expf(s[j][2 * hr] - m_use) + __expf(s[j][2 * hr + 1] - m_use);
        l[hr] = l[hr] * __expf(m[hr] - m_use) + sum;
        m[hr] = m_new;
      }
    }
  }
  float m_use[2], inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    m_use[hr] = m[hr] == -INFINITY ? 0.f : m[hr];
    inv[hr] = l[hr] > 0.f ? 1.f / l[hr] : 0.f;  // a row with no valid key: P = 0
  }

  // pass 2: P = exp(s - m) / l rounded to bf16, then o += P V
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int c = 0; c < n_ch; ++c) {
    const int cb = c * kMtChunk;
    if (n_ch > 1) {
      n = mt_chunk_rows(pl, ns, b0, p.T, cb, p.kv_mask);
      mt_stage<kD>(Ks, kb, stride, pl, n);
      mt_stage<kD>(Vs, vb, stride, pl, n);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int jhi = min(whi - cb, n);
    for (int j0 = max(wlo - cb, 0) / kMtSub * kMtSub; j0 < jhi; j0 += kMtSub) {
      warp_scores<kD, kMtSub>(s, Qw, Ks + j0 * (kD + 8));
      mt_mask(s, pl, j0, cb, lo, hi, p.scale);
#pragma unroll
      for (int j = 0; j < kMtSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - m_use[e >> 1]) * inv[e >> 1];
      uint32_t pa[kMtSub / 16][4];
      probs_to_a<kMtSub>(pa, s);
      warp_pv<kD, kMtSub>(o, pa, Vs + j0 * (kD + 8));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into Qs has landed before it takes the output

  const float one[2] = {1.f, 1.f};
  bf16* o_rows = static_cast<bf16*>(out_) + (size_t)wr0 * p.H * kD + h * kD;
  warp_store_rows<kD>(o, one, Qw, wrows, [&](int r) { return o_rows + (size_t)r * p.H * kD; });
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = lane / 4 + 8 * hr;
      if (rr < wrows)
        lse[((size_t)wb * p.H + h) * p.T + wt0 + rr] = l[hr] > 0.f ? m[hr] + logf(l[hr]) : INFINITY;
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

template <int kD>
cudaError_t launch_bd_fwd_tc(const MergedParams& p, void* out, float* lse, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (kMtRows + 2 * kMtChunk) * (kD + 8);
  cudaError_t err = cudaFuncSetAttribute(bd_fwd_tc_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_slots = (long long)p.B * ((p.T + 15) / 16);
  const dim3 grid((unsigned)((n_slots + 3) / 4), p.H);
  bd_fwd_tc_kernel<kD><<<grid, kMtThreads, smem, stream>>>(p, out, lse);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  Returns the launch's cudaError_t.
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
                      : launch_bd_fwd_tc<kD>(p, out, lse, s);
  });
}

// dtype: 0 = float32 (merged_bwd_kernel over blocks of bblk samples,
// bblk * T <= 640, from the forward's out and lse; ws null), 1 = bfloat16
// (the shared tensor-core pair over 16-row slots, from qkv and dA alone:
// out and lse null, bblk not read; ws: float32 [2, H, B * T] scratch).
// Returns the first failing launch's cudaError_t.
extern "C" int mcl_attention_core_bd_bwd(const void* qkv, const void* out, const void* dout,
                                         const float* lse, const int* kv_mask, void* dqkv,
                                         float* ws, int B, int T, int H, int D, int t_real,
                                         int causal, float scale, int bblk, int dtype,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (out != nullptr || lse != nullptr) return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    const mcl_bwd_tc::BwdParams p{static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                                  static_cast<bf16*>(dqkv), ws, kv_mask, B, T, H, t_real, scale};
    return (int)mcl_bwd_tc::launch(p, D, causal != 0, kv_mask != nullptr, true, s);
  }
  if (bblk <= 0 || (long long)bblk * T > kMaxRows || out == nullptr || lse == nullptr ||
      ws != nullptr)
    return (int)cudaErrorInvalidValue;
  MergedParams p{qkv, out, dout, lse, kv_mask, dqkv, B, T, H, t_real, causal, scale, bblk};
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_merged_bwd<false, kD>(p, s);
  });
}
