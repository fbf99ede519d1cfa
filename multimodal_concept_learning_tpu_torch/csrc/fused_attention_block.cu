// K6: the fused pre-LN attention sublayer, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels multimodal_concept_learning_tpu/ops/
// fused_attention_block.py:_fwd_kernel (:86, pallas_call at :200) and
// _bwd_attn_kernel (:106, pallas_call at :261), under the custom VJP at
// :170-304 (ViTConfig.fused_attention=True).
//
//   y = x + attn(LN(x) Wqkv + bqkv) Wo + bo
//
// x [B, T, W] in the compute dtype (fp32 or bf16); Wqkv [W, 3*H*D], bqkv,
// Wo [H*D, W] and bo already cast to it (ops/fused_attention_block.py); the
// head dim D is a template parameter, built for 16, 32 and 64
// (with_head_dim, merged_attention.cuh);
// LN in fp32 with the rounded scale and bias and the given eps; qkv =
// fp32(LN->T . Wqkv) + bqkv rounded to T; softmax over each sample's own
// keys below t_real with P rounded to T before P.V; attn rounded to T; y =
// fp32(attn . Wo) + bo + x rounded to T.  Outputs y and attn (the
// backward's residual, which the TPU kernel also writes).
//
// Forward, two launches:
// 1. fused_attn_kernel, one CTA per (head, sample): the row statistics of
//    the sample's x in fp32, then K and V of that head for all T rows and Q
//    of each 64-row query tile, each a [64, D or 2D] product streamed over
//    the W-deep reduction in 32-wide chunks with LN applied on the fly, into
//    shared memory; then the attention of each query tile over the
//    sample's keys (two passes over 32-key tiles, as K2), written
//    token-major.  LN(x) and qkv never reach device memory (the point of the
//    TPU kernel); K and V of a sample stay in shared memory, so T <= 320.
// 2. out_proj_kernel: y = attn . Wo + bo + x, a 64 x 128 tiled product with
//    the bias and residual in its epilogue.
// Backward (the TPU _bwd_attn_kernel): dqkv from the recomputed qkv and dA
// alone; lse and delta = rowsum(dP*P) recomputed for every row, dS rounded
// unscaled, D^-1/2 applied to dQ and dK in fp32 before their cast, P
// rounded before dV = P^T dA, no atomics.  The rest of the backward is
// plain tensor code, as the TPU keeps it in XLA.
// - bf16: the tensor-core pair shared with K2 and K2-bd (merged_bwd_tc.cuh,
//   K6's choices: no mask, the scale after the products), over 16-row
//   slots of one sample each, 4 a CTA (bblk is not read):
//   bwd_dq_tc_kernel takes lse and delta online into a float32 workspace
//   [2, H, B*T] and accumulates dQ, bwd_dkv_tc_kernel dK and dV; any T.
// - fp32: merged_bwd_kernel<true> (merged_attention.cuh) on the
//   CUDA cores: a CTA per (head, bblk samples <= 640 rows), dQ in a [R, D]
//   fp32 shared-memory tile.
//
// What bounds it: at the vision path's shape (x [256, 50, 768], 12 heads)
// the projections are 62.4 GFLOP a forward, ~0.063 ms at the bf16 tensor
// cores' peak, against ~0.02 ms of bytes (x, the weights, y and attn), so
// the bound is operations.  The bf16 path runs both products (qkv and the
// output projection, 97% of the operations) on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulation), from bf16 operand tiles
// in shared memory, one 32-deep chunk at a time with no overlap of loads
// and products; its attention and the fp32 path stay fp32 FMA on the CUDA
// cores (no TF32).  wgmma with TMA-fed, multi-stage operand tiles is the
// step after.  The bf16 backward is bound by bytes (qkv and dA read, dqkv
// written: 0.041 ms at the vision shape; its 4.9 GFLOP take 0.005 ms at
// peak): each launch reads its own rows once and the staged rows of the
// samples its tiles touch, mostly from L2.

#include <type_traits>

#include "merged_attention.cuh"
#include "merged_bwd_tc.cuh"  // the bf16 backward; merged_tiles.cuh, mma_tiles.cuh

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;       // query rows per tile; rows per projection chunk
constexpr int kBD = 32;       // reduction chunk of the products
constexpr int kMaxT = 320;    // K and V of one sample and head in shared memory
constexpr int kBN = 128;      // out_proj columns per CTA
constexpr int kLdH = kBD + 8;  // bf16 operand rows, padded: conflict-free fragment loads

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The warp's [16 rows from m0] x [NJ * 8 columns from n0] block of one
// 32-deep chunk: acc[j] += A[m0.., :] . B[:, n0 + 8j..]; As [64][kLdH] and
// Bs [columns][kLdH], both k-contiguous bf16 (the mma fragment layouts).
template <int NJ>
__device__ __forceinline__ void mma_chunk(float (&acc)[NJ][4], const bf16* As, const bf16* Bs,
                                          int m0, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kBD; k0 += 16) {
    const bf16* ap = As + (m0 + g) * kLdH + k0 + 2 * t;
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * kLdH), ld32(ap + 8), ld32(ap + 8 * kLdH + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* bp = Bs + (n0 + 8 * j + g) * kLdH + k0 + 2 * t;
      const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
      mma_bf16(acc[j], a, b);
    }
  }
}

struct FusedParams {
  const void* x;
  const void* lns;
  const void* lnb;
  const void* wqkv;
  const void* bqkv;
  const void* wo;
  const void* bo;
  void* y;
  void* attn;
  int B, T, W, H, D, t_real;
  float eps, scale;
};

// bf16: project()'s product on the tensor cores (mma.sync m16n8k16, fp32
// accumulation); the operands are the same bf16 values.  Warp w computes
// rows (w % 4) * 16.. and half the columns.
template <int kD, int NG>
__device__ void project_mma(const FusedParams& p, const bf16* xb, const float* mu,
                            const float* rs, float* As_f, float* Bs_f, int row0,
                            const int (&col)[NG], float* const (&dst)[NG], int dst_rows) {
  constexpr int NCOL = NG * kD;
  constexpr int NJ = NCOL / 16;
  bf16* As = reinterpret_cast<bf16*>(As_f);  // [kBQ][kLdH] LN(x) chunk
  bf16* Bs = reinterpret_cast<bf16*>(Bs_f);  // [NCOL][kLdH] weight chunk, transposed
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = (warp % 4) * 16, n0 = (warp / 4) * (NCOL / 2);
  const int hd3 = 3 * p.H * kD;
  const bf16* w = static_cast<const bf16*>(p.wqkv);
  const bf16* lns = static_cast<const bf16*>(p.lns);
  const bf16* lnb = static_cast<const bf16*>(p.lnb);
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int d0 = 0; d0 < p.W; d0 += kBD) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kBQ * kBD; i += kThreads) {
      const int r = i / kBD, dd = i % kBD, t = row0 + r, d = d0 + dd;
      float v = 0.f;
      if (t < p.T) {
        const float xhat = (__bfloat162float(xb[(size_t)t * p.W + d]) - mu[t]) * rs[t];
        v = xhat * __bfloat162float(lns[d]) + __bfloat162float(lnb[d]);
      }
      As[r * kLdH + dd] = __float2bfloat16(v);
    }
    for (int i = tid; i < kBD * NCOL; i += kThreads) {
      const int dd = i / NCOL, c = i % NCOL;
      Bs[c * kLdH + dd] = w[(size_t)(d0 + dd) * hd3 + col[c / kD] + c % kD];
    }
    __syncthreads();
    mma_chunk<NJ>(acc, As, Bs, m0, n0);
  }
  const bf16* bias = static_cast<const bf16*>(p.bqkv);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e / 2), c = n0 + 8 * j + 2 * t4 + e % 2;
      const int grp = c / kD, cc = c % kD;
      if (r < dst_rows)
        dst[grp][r * (kD + 1) + cc] =
            row0 + r < p.T ? round_to<bf16>(acc[j][e] + __bfloat162float(bias[col[grp] + cc]))
                           : 0.f;
    }
  }
}

// fp32: project()'s product in FMA on the CUDA cores; thread (ty, tx) owns
// rows ty + 8 i and columns tx + 32 j below NCOL
template <typename T, int kD, int NG>
__device__ void project_fma(const FusedParams& p, const T* xb, const float* mu, const float* rs,
                            float* As, float* Bs, int row0, const int (&col)[NG],
                            float* const (&dst)[NG], int dst_rows) {
  constexpr int NCOL = NG * kD;
  constexpr int NJ = (NCOL + 31) / 32;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int hd3 = 3 * p.H * kD;
  const T* w = static_cast<const T*>(p.wqkv);
  const T* lns = static_cast<const T*>(p.lns);
  const T* lnb = static_cast<const T*>(p.lnb);
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < p.W; d0 += kBD) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kBQ * kBD; i += kThreads) {
      const int r = i / kBD, dd = i % kBD, t = row0 + r, d = d0 + dd;
      float v = 0.f;
      if (t < p.T) {
        const float xhat = (load_f(xb + (size_t)t * p.W + d) - mu[t]) * rs[t];
        v = round_to<T>(xhat * load_f(lns + d) + load_f(lnb + d));
      }
      As[r * (kBD + 1) + dd] = v;
    }
    for (int i = tid; i < kBD * NCOL; i += kThreads) {
      const int dd = i / NCOL, c = i % NCOL;
      Bs[dd * NCOL + c] = load_f(w + (size_t)(d0 + dd) * hd3 + col[c / kD] + c % kD);
    }
    __syncthreads();
    for (int dd = 0; dd < kBD; ++dd) {
      float a[8], b[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 8 * i) * (kBD + 1) + dd];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = tx + 32 * j < NCOL ? Bs[dd * NCOL + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  const T* bias = static_cast<const T*>(p.bqkv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= dst_rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 32 * j, g = c / kD, cc = c % kD;
      if (c >= NCOL) continue;
      dst[g][r * (kD + 1) + cc] =
          row0 + r < p.T ? round_to<T>(acc[i][j] + load_f(bias + col[g] + cc)) : 0.f;
    }
  }
}

// Columns [col[g], col[g] + D) of the packed qkv for rows [row0, row0 + 64)
// of one sample (NG column groups), LN applied to x on the fly:
// dst[g][(r - row0) * (kD + 1) + c] = round_T(fp32(LN(x)->T . Wqkv) + bqkv)
// for the first dst_rows local rows (zero past T).  fp32: FMA on the CUDA
// cores; bf16: project_mma.
template <typename T, int kD, int NG>
__device__ void project(const FusedParams& p, const T* xb, const float* mu, const float* rs,
                        float* As, float* Bs, int row0, const int (&col)[NG],
                        float* const (&dst)[NG], int dst_rows) {
  if constexpr (std::is_same<T, bf16>::value) {
    project_mma<kD, NG>(p, xb, mu, rs, As, Bs, row0, col, dst, dst_rows);
  } else {
    project_fma<T, kD, NG>(p, xb, mu, rs, As, Bs, row0, col, dst, dst_rows);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) fused_attn_kernel(FusedParams p) {
  extern __shared__ float smem[];
  const int T_ = p.T;
  float* mu = smem;                          // [T]
  float* rs = mu + T_;                       // [T]
  float* Ks = rs + T_;                       // [T][kD + 1]
  float* Vs = Ks + T_ * (kD + 1);            // [T][kD + 1]
  float* Qs = Vs + T_ * (kD + 1);            // [kBQ][kD + 1]
  float* Ss = Qs + kBQ * (kD + 1);           // [kBQ][kBK + 1]
  float* row_m = Ss + kBQ * (kBK + 1);       // [kBQ]
  float* row_l = row_m + kBQ;                // [kBQ]
  float* As = row_l + kBQ;                   // [kBQ][kBD + 1] LN(x) chunk
  float* Bs = As + kBQ * (kBD + 1);          // [kBD][2 * kD] weight chunk

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hd = p.H * kD;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * T_ * p.W;

  // row statistics in fp32 (the JAX _ln_forward): one warp per row
  for (int t = warp; t < T_; t += kThreads / 32) {
    const T* xr = xb + (size_t)t * p.W;
    float s = 0.f;
    for (int d = lane; d < p.W; d += 32) s += load_f(xr + d);
    const float m = warp_sum(s) / (float)p.W;
    float v = 0.f;
    for (int d = lane; d < p.W; d += 32) {
      const float e = load_f(xr + d) - m;
      v = fmaf(e, e, v);
    }
    v = warp_sum(v) / (float)p.W;
    if (lane == 0) {
      mu[t] = m;
      rs[t] = rsqrtf(v + p.eps);
    }
  }
  // K and V of head h for all T rows (project starts with a barrier)
  {
    const int col[2] = {hd + h * kD, 2 * hd + h * kD};
    for (int row0 = 0; row0 < T_; row0 += kBQ) {
      float* const dst[2] = {Ks + row0 * (kD + 1), Vs + row0 * (kD + 1)};
      project<T, kD, 2>(p, xb, mu, rs, As, Bs, row0, col, dst, min(kBQ, T_ - row0));
    }
  }

  const int k_hi = min(T_, p.t_real);
  constexpr int kORS = kThreads / kD;  // output: column od, rows orow0 + i * kORS
  constexpr int kNO = kBQ / kORS;
  const int od = tid % kD, orow0 = tid / kD;
  constexpr int kSRS = kThreads / kBK;  // scores: key column sc, rows srow0 + i * kSRS
  constexpr int kNS = kBQ / kSRS;
  const int sc = tid % kBK, srow0 = tid / kBK;
  T* attn = static_cast<T*>(p.attn);

  for (int q0 = 0; q0 < T_; q0 += kBQ) {
    {
      const int col[1] = {h * kD};
      float* const dst[1] = {Qs};
      project<T, kD, 1>(p, xb, mu, rs, As, Bs, q0, col, dst, kBQ);
    }
    for (int r = tid; r < kBQ; r += kThreads) {
      row_m[r] = -INFINITY;
      row_l[r] = 0.f;
    }
    float acc[kNO];
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
    __syncthreads();
    // pass 0: each row's max and sum (online); pass 1: P rounded to T, acc += P V
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = 0; kt < k_hi; kt += kBK) {
        const int nk = min(kBK, k_hi - kt);
        {
          float s[kNS];
#pragma unroll
          for (int i = 0; i < kNS; ++i) s[i] = 0.f;
          const float* kr = Ks + min(kt + sc, T_ - 1) * (kD + 1);
          for (int d = 0; d < kD; ++d) {
            const float kd = kr[d];
#pragma unroll
            for (int i = 0; i < kNS; ++i)
              s[i] = fmaf(Qs[(srow0 + i * kSRS) * (kD + 1) + d], kd, s[i]);
          }
#pragma unroll
          for (int i = 0; i < kNS; ++i)
            Ss[(srow0 + i * kSRS) * (kBK + 1) + sc] = sc < nk ? s[i] * p.scale : -INFINITY;
        }
        __syncthreads();
        for (int r = warp; r < kBQ; r += kThreads / 32) {
          const float x = Ss[r * (kBK + 1) + lane];
          if (pass == 0) {
            const float m_old = row_m[r];
            const float m_new = fmaxf(m_old, warp_max(x));
            const float sum = warp_sum(expf(x - m_new));
            if (lane == 0) {
              row_l[r] = row_l[r] * expf(m_old - m_new) + sum;
              row_m[r] = m_new;
            }
          } else {
            Ss[r * (kBK + 1) + lane] = round_to<T>(expf(x - row_m[r]) / row_l[r]);
          }
        }
        __syncthreads();
        if (pass == 1) {
          for (int c = 0; c < nk; ++c) {
            const float vx = Vs[(kt + c) * (kD + 1) + od];
#pragma unroll
            for (int i = 0; i < kNO; ++i)
              acc[i] = fmaf(Ss[(orow0 + i * kORS) * (kBK + 1) + c], vx, acc[i]);
          }
          __syncthreads();
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      const int t = q0 + orow0 + i * kORS;
      if (t < T_) store_f(attn + ((size_t)b * T_ + t) * hd + h * kD + od, acc[i]);
    }
  }
}

// bf16: out_proj_kernel's product on the tensor cores (mma.sync)
__device__ void out_proj_mma(const FusedParams& p) {
  __shared__ __align__(16) bf16 As[kBQ * kLdH];  // attn rows, k-contiguous
  __shared__ __align__(16) bf16 Bs[kBN * kLdH];  // Wo columns, k-contiguous
  constexpr int NJ = kBN / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBQ;
  const int wm = (warp % 4) * 16, wn = (warp / 4) * (kBN / 2);
  const int M = p.B * p.T, K = p.H * p.D;
  const bf16* a = static_cast<const bf16*>(p.attn);
  const bf16* w = static_cast<const bf16*>(p.wo);
  const bf16 zero = __float2bfloat16(0.f);
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBD) {
    __syncthreads();
    for (int i = tid; i < kBQ * kBD; i += kThreads) {
      const int r = i / kBD, kk = i % kBD, m = m0 + r;
      As[r * kLdH + kk] = m < M && k0 + kk < K ? a[(size_t)m * K + k0 + kk] : zero;
    }
    for (int i = tid; i < kBD * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN, n = n0 + c;
      Bs[c * kLdH + kk] = n < p.W && k0 + kk < K ? w[(size_t)(k0 + kk) * p.W + n] : zero;
    }
    __syncthreads();
    mma_chunk<NJ>(acc, As, Bs, wm, wn);
  }
  const bf16* bo = static_cast<const bf16*>(p.bo);
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* y = static_cast<bf16*>(p.y);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + 8 * (e / 2), n = n0 + wn + 8 * j + 2 * t4 + e % 2;
      if (m < M && n < p.W) {
        const size_t at = (size_t)m * p.W + n;
        y[at] = __float2bfloat16((acc[j][e] + __bfloat162float(bo[n])) +
                                 __bfloat162float(x[at]));
      }
    }
  }
}

// fp32: out_proj_kernel's product in FMA on the CUDA cores
template <typename T>
__device__ void out_proj_fma(const FusedParams& p) {
  __shared__ float As[kBQ][kBD + 1];
  __shared__ float Bs[kBD][kBN];
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBQ;
  const int M = p.B * p.T, K = p.H * p.D;
  const T* a = static_cast<const T*>(p.attn);
  const T* w = static_cast<const T*>(p.wo);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBD) {
    __syncthreads();
    for (int i = tid; i < kBQ * kBD; i += kThreads) {
      const int r = i / kBD, kk = i % kBD, m = m0 + r;
      As[r][kk] = m < M && k0 + kk < K ? load_f(a + (size_t)m * K + k0 + kk) : 0.f;
    }
    for (int i = tid; i < kBD * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN, n = n0 + c;
      Bs[kk][c] = n < p.W && k0 + kk < K ? load_f(w + (size_t)(k0 + kk) * p.W + n) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kBD; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[ty + 8 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  const T* bo = static_cast<const T*>(p.bo);
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n < p.W) {
        const size_t at = (size_t)m * p.W + n;
        store_f(y + at, (acc[i][j] + load_f(bo + n)) + load_f(x + at));
      }
    }
  }
}

// y[m, n] = round_T(fp32(attn[m, :] . Wo[:, n]) + bo[n] + x[m, n])
template <typename T>
__global__ void __launch_bounds__(kThreads) out_proj_kernel(FusedParams p) {
  if constexpr (std::is_same<T, bf16>::value) {
    out_proj_mma(p);
  } else {
    out_proj_fma<T>(p);
  }
}

template <int kD>
size_t fused_attn_smem(int T) {
  return sizeof(float) * (2 * (size_t)T + 2 * (size_t)T * (kD + 1) + kBQ * (kD + 1) +
                          kBQ * (kBK + 1) + 2 * kBQ + kBQ * (kBD + 1) + kBD * 2 * kD);
}

template <typename T, int kD>
cudaError_t launch_fused_fwd(const FusedParams& p, cudaStream_t stream) {
  const size_t smem = fused_attn_smem<kD>(p.T);
  cudaError_t err = cudaFuncSetAttribute(fused_attn_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_attn_kernel<T, kD><<<dim3(p.H, p.B), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long M = (long long)p.B * p.T;
  const dim3 grid((p.W + kBN - 1) / kBN, (unsigned)((M + kBQ - 1) / kBQ));
  out_proj_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the first failing launch's cudaError_t.
extern "C" int mcl_fused_attention_fwd(const void* x, const void* lns, const void* lnb,
                                       const void* wqkv, const void* bqkv, const void* wo,
                                       const void* bo, void* y, void* attn, int B, int T, int W,
                                       int H, int D, int t_real, float eps, float scale,
                                       int dtype, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || H <= 0 || W <= 0 || W % kBD || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  FusedParams p{x, lns, lnb, wqkv, bqkv, wo, bo, y, attn, B, T, W, H, D, t_real, eps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0 ? launch_fused_fwd<float, kD>(p, s)
                      : launch_fused_fwd<__nv_bfloat16, kD>(p, s);
  });
}

// dtype: 0 = float32 (merged_bwd_kernel on the CUDA cores over blocks of
// bblk samples, bblk * T <= 640; ws null), 1 = bfloat16 (the shared
// tensor-core pair over 16-row slots; bblk not read; ws: float32 [2, H,
// B * T] scratch).  Returns the first failing launch's cudaError_t.
extern "C" int mcl_fused_attention_bwd(const void* qkv, const void* da, void* dqkv, float* ws,
                                       int B, int T, int H, int D, int t_real, float scale,
                                       int bblk, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const mcl_bwd_tc::BwdParams p{static_cast<const bf16*>(qkv), static_cast<const bf16*>(da),
                                  static_cast<bf16*>(dqkv), ws, nullptr, B, T, H, t_real, scale};
    return (int)mcl_bwd_tc::launch(p, D, false, false, false, s);
  }
  if (bblk <= 0 || (long long)bblk * T > kMaxRows || ws != nullptr)
    return (int)cudaErrorInvalidValue;
  MergedParams p{qkv, nullptr, da, nullptr, nullptr, dqkv, B, T, H, t_real, 0, scale, bblk};
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_merged_bwd<true, kD>(p, s);
  });
}
