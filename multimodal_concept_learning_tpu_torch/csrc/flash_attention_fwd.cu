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
// [8,261,4q/1kv,256]) the scores never leave the SM and the bytes (q, k, v
// read once, o written once) take 2-4 us at 3.35 TB/s, about as long as the
// products take at the tensor cores' peak; a kernel's own latency (tile
// loads, the softmax between the two products) is what it pays beyond that.
// The bf16 kernel takes ~0.025 ms at the LM shape and ~0.018 at the ViT's
// (H100, PERF.md), ~6-8x those bounds: at the LM shape 136 CTAs of 4 warps
// (about one an SM, 245 registers a thread at D 256) walk their key tiles
// with no other CTA to hide a tile's copy or its softmax; a dense decode
// step (one query a row) fills one warp of one CTA per batch row.
//
// Design, bf16 (flash_fwd_tc_kernel): FlashAttention-2's shape on mma.sync
// m16n8k16 with fp32 accumulation (mma_tiles.cuh).  A CTA of 4 warps owns a
// 64-row tile of (query, q head of the GQA group) pairs, 16 rows a warp, so
// the group's heads share every K/V tile the CTA loads (4x fewer K/V reads
// than a CTA per q head at gemma3's 4q/1kv).  K/V tiles (64 keys, 32 at
// D 256) are double-buffered with 16-byte cp.async into bf16 shared memory
// padded to D + 8 (ldmatrix without bank conflicts); Q stays in shared memory
// and is read by ldmatrix at every tile, which leaves the registers to the
// [16, D] fp32 output (128 a thread at D 256).  The online softmax runs in
// registers (row max and sum over the quad of lanes that holds a row);
// exp(s - m) is rounded to bf16 as the A operand of P.V, unnormalised, and O
// is divided by l in fp32 at the end (the plain version normalises first,
// then rounds; both stay inside the bf16 limit).  Key tiles outside the
// rows' [k_lo, k_hi) are skipped, the mask is applied per element, then the
// bias.  The output leaves through the warp's Q rows in shared memory as
// 16-byte stores.
//
// fp32 (flash_fwd_kernel): the CUDA cores, no TF32 (float32 runs must match
// the plain version to 1e-4): smem-staged fp32 tiles, one online-softmax
// pass over 32-key tiles, one CTA per (query tile, q head, batch row).
// exp is the accurate expf there.
//
// With a non-null lse pointer the kernel also writes each row's logsumexp
// (float32 [B, Hq, Tq]), which the backward kernels recompute the
// probabilities from (the TPU kernel's l_ref output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "mma_tiles.cuh"

namespace {

using mcl_flash::kThreads;
using mcl_flash::load_f;
using mcl_flash::store_f;
using mcl_flash::warp_max;
using mcl_flash::warp_sum;

constexpr int kBK = 32;  // keys per tile == warp width (one lane per key in the softmax)

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // nullable, [B, Hq, Tq]: row logsumexp for the backward
  const float* bias;  // nullable
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  const int* kv_lens;  // nullable, [B]
  int B, Tq, Tk, Hq, Hk;
  float scale;
  int causal;
  int window;  // < 0: no sliding window
};

// One CTA per (query tile of BQ rows, q head, batch row).
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][D]
  float* Ks = Qs + BQ * D;                  // [kBK][D + 1] (padded: conflict-free column reads)
  float* Vs = Ks + kBK * (D + 1);           // [kBK][D]
  float* Ss = Vs + kBK * D;                 // [BQ][kBK + 1] scores, then probabilities
  float* row_alpha = Ss + BQ * (kBK + 1);   // [BQ]
  float* row_m = row_alpha + BQ;            // [BQ] running max
  float* row_l = row_m + BQ;                // [BQ] running denominator

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* o = static_cast<float*>(p.o);

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
  // lse = m + log(l); a row with no attendable key gets +inf, which the
  // backward reads as p = exp(s - lse) = 0
  if (p.lse != nullptr) {
    for (int r = tid; r < BQ; r += kThreads) {
      const int t = q0 + r;
      if (t < p.Tq) {
        const float l = row_l[r];
        p.lse[((size_t)b * p.Hq + h) * p.Tq + t] = l > 0.f ? row_m[r] + logf(l) : INFINITY;
      }
    }
  }
}

constexpr int kTcThreads = 128;  // bf16 kernel: 4 warps x 16 rows
constexpr int kTcRows = 64;      // (query, q head) rows per CTA

// One CTA per (64 rows of (query, q head of the group), kv head, batch row):
// row rr is query rr / G, q head hk * G + rr % G.
template <int kD, int kBK>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(FlashParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][kD + 8]; then the output
  bf16* Ks = Qs + kTcRows * (kD + 8);            // 2 stages of [kBK][kD + 8]
  bf16* Vs = Ks + 2 * kBK * (kD + 8);            // 2 stages of [kBK][kD + 8]

  const int G = p.Hq / p.Hk, R = p.Tq * G;
  const int row0 = blockIdx.x * kTcRows, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = p.Tk - p.Tq;  // causal offset: query t sits at key position t + off
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* kbase = static_cast<const bf16*>(p.k) + ((size_t)b * p.Tk * p.Hk + hk) * kD;
  const bf16* vbase = static_cast<const bf16*>(p.v) + ((size_t)b * p.Tk * p.Hk + hk) * kD;
  const long long kv_stride = (long long)p.Hk * kD;
  auto row_offset = [&](int rr) {  // element offset of row rr in q and o
    return ((size_t)(b * p.Tq + rr / G) * p.Hq + hk * G + rr % G) * kD;
  };

  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kTcRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8, rr = row0 + r;
    const bool ok = rr < R;
    cp_async16_or_zero(Qs + r * (kD + 8) + c, q + (ok ? row_offset(rr) + c : 0), ok);
  }

  // the key range any row of the tile can reach; the per-element mask is exact
  const int t_first = row0 / G, t_last = (min(R, row0 + kTcRows) - 1) / G;
  const int kv_len = p.kv_lens ? min(p.Tk, p.kv_lens[b]) : p.Tk;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, t_last + off + 1);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, t_first + off - p.window + 1);
  k_lo = (k_lo / kBK) * kBK;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  auto load_kv = [&](int it) {  // key tile it into stage it % 2
    const int kt = k_lo + it * kBK, st = it & 1;
    async_rows<kD, kTcThreads>(Ks + st * kBK * (kD + 8), kbase + (size_t)kt * kv_stride,
                               kv_stride, kBK, k_hi - kt);
    async_rows<kD, kTcThreads>(Vs + st * kBK * (kD + 8), vbase + (size_t)kt * kv_stride,
                               kv_stride, kBK, k_hi - kt);
  };

  if (n_kt > 0) load_kv(0);
  cp_async_commit();  // with Q

  // the thread's two rows: rr = rw + lane / 4 and rw + lane / 4 + 8
  const int rw = row0 + 16 * warp;
  const bool active = rw < R;
  bf16* Qw = Qs + 16 * warp * (kD + 8);  // the warp's Q rows, later its output rows
  int tq[2];
  const float* brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rr = rw + lane / 4 + 8 * hr;
    tq[hr] = rr / G;  // >= Tq for rows past R: attendable() refuses them
    brow[hr] = p.bias == nullptr
                   ? nullptr
                   : p.bias + b * p.bias_sb + (long long)(hk * G + rr % G) * p.bias_sh +
                         (long long)tq[hr] * p.bias_sq;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
  for (int it = 0; it < n_kt; ++it) {
    if (it + 1 < n_kt) {
      load_kv(it + 1);  // into the stage the previous iteration read
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int kt = k_lo + it * kBK, st = it & 1;
      float s[kBK / 8][4];
      warp_scores<kD, kBK>(s, Qw, Ks + st * kBK * (kD + 8));
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, key = kt + 8 * j + 2 * (lane % 4) + (e & 1);
          float val = -INFINITY;
          if (mcl_flash::attendable(tq[hr], key, p.Tq, kv_len, off, p.causal, p.window)) {
            val = s[j][e] * p.scale;
            if (brow[hr] != nullptr) val += brow[hr][(long long)key * p.bias_sk];
          }
          s[j][e] = val;
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
        const float alpha = __expf(m[hr] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          s[j][2 * hr] = __expf(s[j][2 * hr] - m_use);
          s[j][2 * hr + 1] = __expf(s[j][2 * hr + 1] - m_use);
          sum += s[j][2 * hr] + s[j][2 * hr + 1];
        }
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[j][2 * hr] *= alpha;
          o[j][2 * hr + 1] *= alpha;
        }
        l[hr] = l[hr] * alpha + sum;
        m[hr] = m_new;
      }
      uint32_t pa[kBK / 16][4];
      probs_to_a<kBK>(pa, s);
      warp_pv<kD, kBK>(o, pa, Vs + st * kBK * (kD + 8));
    }
    __syncthreads();  // the stage this iteration read is free for the next load
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into Qs has landed before it takes the output
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    inv[hr] = l[hr] > 0.f ? 1.f / l[hr] : 0.f;  // a row with no attendable key: zeros
  }
  bf16* out = static_cast<bf16*>(p.o);
  warp_store_rows<kD>(o, inv, Qw, min(16, R - rw),
                      [&](int r) { return out + row_offset(rw + r); });
  // lse = m + log(l); a row with no attendable key gets +inf, which the
  // backward reads as p = exp(s - lse) = 0
  if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = rw + lane / 4 + 8 * hr;
      if (rr < R)
        p.lse[((size_t)b * p.Hq + hk * G + rr % G) * p.Tq + tq[hr]] =
            l[hr] > 0.f ? m[hr] + logf(l[hr]) : INFINITY;
    }
  }
}

template <int kD, int kBK>
cudaError_t launch_tc(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (kTcRows + 4 * kBK) * (kD + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<kD, kBK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq * (p.Hq / p.Hk) + kTcRows - 1) / kTcRows, p.Hk, p.B);
  flash_fwd_tc_kernel<kD, kBK><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const FlashParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_tc<64, 64>(p, stream);
    case 128: return launch_tc<128, 64>(p, stream);
    case 256: return launch_tc<256, 32>(p, stream);  // 32-key tiles: registers for O
    default: return cudaErrorInvalidValue;
  }
}

template <int D, int BQ>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * D + kBK * (D + 1) + kBK * D + BQ * (kBK + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<D, BQ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const FlashParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64, 64>(p, stream);
    case 128: return launch<128, 64>(p, stream);
    case 256: return launch<256, 32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  Returns the launch's cudaError_t.
extern "C" int mcl_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       float* lse, const float* bias, long long bias_sb, long long bias_sh,
                                       long long bias_sq, long long bias_sk, const int* kv_lens,
                                       int B, int Tq, int Tk, int Hq, int Hk, int D, int dtype,
                                       float scale, int causal, int window, void* stream) {
  FlashParams p{q,       k,  v,  o,  lse,   bias,   bias_sb, bias_sh, bias_sq,
                bias_sk, kv_lens, B, Tq, Tk, Hq, Hk, scale,   causal,  window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d(p, D, s);
  if (dtype == 1) return (int)dispatch_tc(p, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mcl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
