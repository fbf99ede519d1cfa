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
// What bounds the forward: at the vision path's shape (x [256, 50, 768], 12
// heads) the projections are 62.4 GFLOP, ~0.063 ms at the bf16 tensor
// cores' peak, against ~0.02 ms of bytes (x, the weights, y and attn), so
// the bound is operations.
//
// bf16 forward, three launches, every product on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation):
// 1. k6_ln_stats_kernel: each row's LN mean and 1/sqrt(var + eps) in fp32,
//    once a row (not once a head), into a float32 workspace [2, B*T].
// 2. k6_qkv_attn_tc_kernel, one CTA per (head, block of bblk whole samples,
//    bblk * T <= 128 rows; one sample past 128 rows): the qkv projection of
//    the head's 3D columns for the block's rows, in passes of 128 rows, then
//    the attention; LN(x) and qkv stay in shared memory.  So the head's
//    W x 3D weight slice streams once a block of samples (the vision shape:
//    2 samples, 1,536 CTAs) rather than once a sample.  The projection runs
//    over a 3-stage cp.async ring of 64-deep chunks (32 where T past 128
//    rows leaves too little shared memory; the plan picks): x rows
//    [128][64] and the weight rows [64][3D], read by ldmatrix.trans, with
//    the loads of chunk k+2 in flight during chunk k.  After its products on
//    chunk k each thread applies LN to the x pieces of chunk k+1 that it
//    copied (its own copies are visible to it once they land; the LN scale
//    and bias sit in shared memory), so there is one barrier a chunk and the
//    LN pass overlaps other warps' products.  D 64: 12 warps, warp tile 32
//    x 64; D 32: 16 warps, 16 x 48; D 16: 8 warps, 16 x 48 (mma.sync
//    m16n8k16, the tile routine warp_chunk_mma that the output projection
//    shares).  The attention takes (sample, 16-row slot) items a warp: S =
//    Q K^T by mma over 64-key blocks, the exact row max and sum (one pass
//    when the keys fit one block, as T 50 does; else the scores are
//    recomputed), P = exp(s - max) / sum rounded to bf16 as A fragments,
//    P.V by mma; K and V rows past a sample's keys are read clamped to its
//    last key and masked (P = 0).
// 3. k6_out_proj_tc_kernel: y = attn . Wo + bo + x, 128 x 128 tiles over a
//    3-stage ring of 64-deep chunks, 8 warps (warp tile 64 x 32, 2 CTAs an
//    SM); the bias in registers, then x added and y written by 16-byte rows
//    through shared memory.  attn is written anyway as the backward's
//    residual.
// What holds it back (patched copies of this source timed on an H100 at
// the vision shape): not the products.  Without them the qkv-attention
// kernel kept 70-90% of its time (by version): one CTA an SM streams its x
// rows (every head re-reads them, LN included) and the head's weights from
// L2, then attends with no projection to overlap.  A 4-stage ring, 192-row
// passes (a third less weight traffic) and wgmma for the qkv product each
// moved that kernel by less than 3%; wgmma for the output projection was
// slower than mma.sync.
//
// fp32 forward (no TF32, on the CUDA cores): fused_attn_kernel, one CTA per
// (head, sample), LN on the fly into each 32-wide chunk of a [64, D or 2D]
// FMA product, the attention in two passes over 32-key tiles; then
// out_proj_kernel (64 x 128 FMA tiles).
//
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
// The bf16 backward is bound by bytes (qkv and dA read, dqkv written:
// 0.041 ms at the vision shape; its 4.9 GFLOP take 0.005 ms at peak).

#include "merged_attention.cuh"
#include "merged_bwd_tc.cuh"  // the bf16 backward; merged_tiles.cuh, mma_tiles.cuh

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;     // fp32: query rows per tile; rows per projection chunk
constexpr int kBD = 32;     // reduction chunk of the products
constexpr int kMaxT = 320;  // rows of one sample's Q, K and V in shared memory
constexpr int kBN = 128;    // fp32 out_proj columns per CTA

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
  float* stats;  // bf16: the LN statistics [2, B * T]
  int B, T, W, H, D, t_real;
  float eps, scale;
  int bblk;  // bf16: samples a CTA of the qkv-attention kernel
};

// ---------------------------------------------------------------- bf16

constexpr int kPassRows = 128;  // projection rows a pass
constexpr int kSmemPerBlock = 232448;  // shared memory one block may use on sm_90 (227 KB)
constexpr int kStatsThreads = 256;
constexpr int kOutThreads = 256;  // 8 warps as 2 x 4, warp tile 64 x 32
constexpr int kOutM = 128, kOutN = 128, kOutBK = 64, kOutStages = 3;
constexpr int kLdOutA = kOutBK + 8, kLdOutB = kOutN + 8;  // ldmatrix rows 16 B apart mod 128

// acc[m][j] += A[16 rows from 16 m][kBK] . B[kBK][8 columns from 8 j] over one
// chunk.  As: the warp's first row (row-major, stride lda), Bs: its first
// column ([k][n], stride ldb, B fragments by ldmatrix.trans).  Rows past the
// valid ones are zero-filled and computed (no branch in the chain).
template <int kMT, int kNJ, int kBK>
__device__ __forceinline__ void warp_chunk_mma(float (&acc)[kMT][kNJ][4], const bf16* As, int lda,
                                               const bf16* Bs, int ldb) {
  static_assert(kNJ % 2 == 0, "B fragments come two n-tiles an ldmatrix");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t b[kNJ / 2][4];
#pragma unroll
    for (int jj = 0; jj < kNJ / 2; ++jj)
      ldmatrix_x4_trans(b[jj], Bs + (ks + lane % 8 + 8 * ((lane / 8) % 2)) * ldb + 16 * jj +
                                   8 * (lane / 16));
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (16 * m + lane % 16) * lda + ks + 8 * (lane / 16));
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const uint32_t bj[2] = {b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]};
        mma_bf16(acc[m][j], a, bj);
      }
    }
  }
}

__global__ void __launch_bounds__(kStatsThreads) k6_ln_stats_kernel(FusedParams p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int M = p.B * p.T;
  const int row = blockIdx.x * (kStatsThreads / 32) + warp;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.x) + (size_t)row * p.W);
  const int n = p.W / 8;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) {
    const uint4 v = xr[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) s += __low2float(h[j]) + __high2float(h[j]);
  }
  const float m = warp_sum(s) / (float)p.W;
  float var = 0.f;
  for (int i = lane; i < n; i += 32) {
    const uint4 v = xr[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e0 = __low2float(h[j]) - m, e1 = __high2float(h[j]) - m;
      var = fmaf(e0, e0, fmaf(e1, e1, var));
    }
  }
  var = warp_sum(var) / (float)p.W;
  if (lane == 0) {
    p.stats[row] = m;
    p.stats[M + row] = rsqrtf(var + p.eps);
  }
}

// The qkv-attention kernel's shape: kD 64 takes 12 warps as 4 x 3 (warp
// tile 32 x 64), kD 32 16 warps as 8 x 2 (16 x 48), kD 16 8 warps as 8 x 1
// (16 x 48); chunks kBK deep in a ring of 3 (the plan takes 64 where the
// shared memory allows it, else 32).
template <int kD>
struct QkvShape {
  static constexpr int kWN = kD == 64 ? 3 : kD / 16, kWM = kD == 64 ? 4 : 8;
  static constexpr int kWarps = kWM * kWN, kThreads = 32 * kWarps;
  static constexpr int kMTW = kPassRows / 16 / kWM, kNJ = 3 * kD / kWN / 8;
  static constexpr int kStages = 3;
};

// Shared memory of k6_qkv_attn_tc_kernel (mirror: ops/fused_attention_block.py:k6_fwd_plan)
template <int kD>
__host__ __device__ constexpr int qkv_attn_smem(int rows, int width, int bk) {
  return 4 * width                                                        // LN scale, bias
         + 8 * ((rows + 3) / 4 * 4)                                       // mean, 1/std
         + 3 * rows * (kD + 8) * 2                                        // Q, K, V
         + QkvShape<kD>::kStages * (kPassRows * (bk + 8) + bk * (3 * kD + 8)) * 2;  // the ring
}

template <int kD, int kBK>
__global__ void __launch_bounds__(QkvShape<kD>::kThreads, 1) k6_qkv_attn_tc_kernel(FusedParams p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  using Sh = QkvShape<kD>;
  constexpr int kThreads = Sh::kThreads, kMTW = Sh::kMTW, kNJ = Sh::kNJ, kS = Sh::kStages;
  constexpr int kN = 3 * kD, kLdB = kN + 8, kLd = kD + 8, kLdA = kBK + 8;
  constexpr int kStageA = kPassRows * kLdA, kStage = kStageA + kBK * kLdB;
  constexpr int kAC = kBK / 8;                       // 16-byte pieces of an x row's chunk
  constexpr int kAP = (kPassRows * kAC + kThreads - 1) / kThreads;  // x pieces a thread
  constexpr int kBC = kD / 8;                        // pieces of a head's row segment
  constexpr int kBP = (kBK * 3 * kBC + kThreads - 1) / kThreads;  // weight pieces a thread
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.x, b0 = blockIdx.y * p.bblk;
  const int ns = min(p.bblk, p.B - b0), T = p.T, rows = ns * T;
  const int ralloc = p.bblk * T;
  const size_t grow0 = (size_t)b0 * T;  // global row of the block's first row
  const int M = p.B * T, hd = p.H * kD;

  bf16* gs = reinterpret_cast<bf16*>(tc_smem);  // LN scale [W], then bias [W]
  float* mu = reinterpret_cast<float*>(gs + 2 * p.W);
  float* rs = mu + (ralloc + 3) / 4 * 4;
  bf16* Qs = reinterpret_cast<bf16*>(rs + (ralloc + 3) / 4 * 4);
  bf16* Ks = Qs + ralloc * kLd;
  bf16* Vs = Ks + ralloc * kLd;
  bf16* ring = Vs + ralloc * kLd;

  for (int i = tid; i < rows; i += kThreads) {
    mu[i] = p.stats[grow0 + i];
    rs[i] = p.stats[M + grow0 + i];
  }
  for (int i = tid; i < p.W / 8; i += kThreads) {
    reinterpret_cast<uint4*>(gs)[i] = reinterpret_cast<const uint4*>(p.lns)[i];
    reinterpret_cast<uint4*>(gs + p.W)[i] = reinterpret_cast<const uint4*>(p.lnb)[i];
  }
  __syncthreads();

  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.wqkv);
  const bf16* bias = static_cast<const bf16*>(p.bqkv);
  const int nk = p.W / kBK;
  const int wm = warp / Sh::kWN, wn = warp % Sh::kWN;
  // a thread's x pieces: one column, rows a_row0 + j * kAR below kPassRows (j < kAP)
  constexpr int kAR = kThreads / kAC;
  static_assert(kThreads % kAC == 0, "a thread's x pieces share one column");
  const int a_col = (tid % kAC) * 8, a_row0 = tid / kAC;

  for (int pr0 = 0; pr0 < rows; pr0 += kPassRows) {
    const int pvalid = min(kPassRows, rows - pr0);
    // chunk c's x rows and weight rows (row kr, segment q/k/v, 8 columns from
    // cc).  Its loops and the LN pass's stay rolled: unrolled, D 64 spills.
    auto stage = [&](int c) {
      bf16* st = ring + (c % kS) * kStage;
      const bf16* xa = x + (grow0 + pr0 + a_row0) * p.W + c * kBK + a_col;
#pragma unroll 1
      for (int j = 0; j < kAP; ++j) {
        if (a_row0 + j * kAR >= kPassRows) break;
        const bool ok = a_row0 + j * kAR < pvalid;
        cp_async16_or_zero(st + (a_row0 + j * kAR) * kLdA + a_col,
                           xa + (ok ? (size_t)j * kAR * p.W : 0), ok);
      }
      const bf16* wb = w + (size_t)c * kBK * 3 * hd + h * kD;
#pragma unroll 1
      for (int j = 0; j < kBP; ++j) {
        const int i = tid + j * kThreads, kr = i / (3 * kBC), seg = (i / kBC) % 3;
        const int cc = (i % kBC) * 8;
        if (i < kBK * 3 * kBC)
          cp_async16(st + kStageA + kr * kLdB + seg * kD + cc, wb + kr * 3 * hd + seg * hd + cc);
      }
    };
    // LN on the x pieces of chunk c this thread copied (visible to it once they land)
    auto transform = [&](int c) {
      bf16* st = ring + (c % kS) * kStage;
      const uint4 gv = *reinterpret_cast<const uint4*>(gs + c * kBK + a_col);
      const uint4 bv = *reinterpret_cast<const uint4*>(gs + p.W + c * kBK + a_col);
      const __nv_bfloat162* gg = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* bb = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll 1
      for (int j = 0; j < kAP; ++j) {
        const int r = a_row0 + j * kAR;
        if (r >= pvalid) break;
        uint4* piece = reinterpret_cast<uint4*>(st + r * kLdA + a_col);
        const uint4 v = *piece;
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float m = mu[pr0 + r], sd = rs[pr0 + r];
        uint4 o;
        uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = (__low2float(xv[e]) - m) * sd * __low2float(gg[e]) + __low2float(bb[e]);
          const float hi =
              (__high2float(xv[e]) - m) * sd * __high2float(gg[e]) + __high2float(bb[e]);
          ov[e] = pack_bf16(lo, hi);
        }
        *piece = o;
      }
    };
    float acc[kMTW][kNJ][4];
#pragma unroll
    for (int m = 0; m < kMTW; ++m)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    // chunk k + 1 is transformed while chunk k is multiplied, one barrier a chunk
#pragma unroll
    for (int c = 0; c < kS - 1; ++c) {
      if (c < nk) stage(c);
      cp_async_commit();
    }
    cp_async_wait<kS - 2>();
    transform(0);
    __syncthreads();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + kS - 1 < nk) stage(kc + kS - 1);  // into chunk kc - 1's slot
      cp_async_commit();
      const bf16* st = ring + (kc % kS) * kStage;
      warp_chunk_mma<kMTW, kNJ, kBK>(acc, st + wm * kMTW * 16 * kLdA, kLdA,
                                     st + kStageA + wn * 8 * kNJ, kLdB);
      if (kc + 1 < nk) {
        cp_async_wait<kS - 2>();
        transform(kc + 1);
      }
      __syncthreads();  // chunk kc + 1 is LN(x); every warp is done with chunk kc
    }
    // qkv = round(fp32 product + bqkv) into Q, K, V
#pragma unroll
    for (int m = 0; m < kMTW; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * kMTW * 16 + 16 * m + g + 8 * hh;
        if (r >= pvalid) continue;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int col = wn * 8 * kNJ + 8 * j + 2 * t4, seg = col / kD, cc = col % kD;
          const __nv_bfloat162 bv =
              *reinterpret_cast<const __nv_bfloat162*>(bias + seg * hd + h * kD + cc);
          bf16* dst = (seg == 0 ? Qs : seg == 1 ? Ks : Vs) + (pr0 + r) * kLd + cc;
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[m][j][2 * hh] + __low2float(bv),
                                                        acc[m][j][2 * hh + 1] + __high2float(bv));
        }
      }
    }
  }
  __syncthreads();  // Q, K and V of every row

  // attention: (sample, 16-row slot) items, 64-key blocks
  const int k_hi = min(T, p.t_real);
  const int slots = (T + 15) / 16;
  const int nkb = k_hi > 0 ? (k_hi + 63) / 64 : 0;
  bf16* slab = ring + warp * 16 * kLd;  // the ring is free: each warp's output rows
  bf16* attn = static_cast<bf16*>(p.attn);
  for (int it = warp; it < ns * slots; it += Sh::kWarps) {
    const int smp = it / slots, q0 = (it % slots) * 16, base = smp * T;
    const int last_key = base + k_hi - 1;  // K, V rows past it are read clamped (masked)
    const bf16* qa_row = Qs + min(base + q0 + lane % 16, rows - 1) * kLd + 8 * (lane / 16);
    float sc[8][4];
    auto scores = [&](int kb0) {  // Q fragments loaded a 16-column step at a time (registers)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qa_row + 16 * kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (kb0 + 16 * jj >= k_hi) break;
          const int krow = min(base + kb0 + 16 * jj + lane % 8 + 8 * (lane / 16), last_key);
          uint32_t b[4];
          ldmatrix_x4(b, Ks + krow * kLd + 16 * kk + 8 * ((lane / 8) % 2));
          const uint32_t lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
          mma_bf16(sc[2 * jj], qa, lo);
          mma_bf16(sc[2 * jj + 1], qa, hi);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = kb0 + 8 * j + 2 * t4 + (e & 1) < k_hi ? sc[j][e] * p.scale : -INFINITY;
    };
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    for (int kb = 0; kb < nkb; ++kb) {  // the exact row max and sum
      scores(64 * kb);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float bm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) bm = fmaxf(bm, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float m_new = fmaxf(mx[r], quad_max(bm));
        float bs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) bs += __expf(sc[j][2 * r] - m_new) + __expf(sc[j][2 * r + 1] - m_new);
        sum[r] = sum[r] * __expf(mx[r] - m_new) + quad_sum(bs);
        mx[r] = m_new;
      }
    }
    float o[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      const int kb0 = 64 * kb;
      if (nkb > 1) scores(kb0);  // one block: its scores are still in sc
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kb0 + 16 * c >= k_hi) break;
        // P of keys 16c.. (score tiles 2c, 2c + 1) rounded to bf16: an A fragment
        float pr[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[j][e] = __expf(sc[2 * c + j][e] - mx[e >> 1]) / sum[e >> 1];
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
        const int vrow = min(base + kb0 + 16 * c + lane % 8 + 8 * ((lane / 8) % 2), last_key);
#pragma unroll
        for (int n0 = 0; n0 < kD; n0 += 16) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + vrow * kLd + n0 + 8 * (lane / 16));
          const uint32_t lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
          mma_bf16(o[n0 / 8], pa, lo);
          mma_bf16(o[n0 / 8 + 1], pa, hi);
        }
      }
    }
    const float one[2] = {1.f, 1.f};
    __syncwarp();  // the slab's previous readers are done
    warp_store_rows<kD>(o, one, slab, min(16, T - q0), [&](int r) {
      return attn + (grow0 + base + q0 + r) * hd + h * kD;
    });
  }
}

// y = round(fp32(attn . Wo) + bo + x), 128 x 128 tiles, 64-deep chunks
__global__ void __launch_bounds__(kOutThreads) k6_out_proj_tc_kernel(FusedParams p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int kStageA = kOutM * kLdOutA, kStage = kStageA + kOutBK * kLdOutB;
  constexpr int kMTW = 4, kNJ = 4;
  constexpr int kAC = kOutBK / 8, kAP = kOutM * kAC / kOutThreads;
  constexpr int kBC = kOutN / 8, kBP = kOutBK * kBC / kOutThreads;
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kOutN, m0 = blockIdx.y * kOutM;
  const int M = p.B * p.T, K = p.H * p.D, N = p.W;
  const int wm = warp / 4, wn = warp % 4;
  const bf16* a = static_cast<const bf16*>(p.attn);
  const bf16* w = static_cast<const bf16*>(p.wo);
  const int nk = (K + kOutBK - 1) / kOutBK;
  const int a_col = (tid % kAC) * 8, a_row0 = tid / kAC, b_col = (tid % kBC) * 8,
            b_row0 = tid / kBC;
  // chunk c: rows past M, k past K and columns past N read as zero
  auto stage = [&](int c) {
    bf16* st = ring + (c % kOutStages) * kStage;
    const int k0 = c * kOutBK;
#pragma unroll
    for (int j = 0; j < kAP; ++j) {
      const int r = a_row0 + j * (kOutThreads / kAC);
      const bool ok = m0 + r < M && k0 + a_col < K;
      cp_async16_or_zero(st + r * kLdOutA + a_col, a + (ok ? (size_t)(m0 + r) * K + k0 + a_col : 0),
                         ok);
    }
#pragma unroll
    for (int j = 0; j < kBP; ++j) {
      const int kr = b_row0 + j * (kOutThreads / kBC);
      const bool ok = k0 + kr < K && n0 + b_col < N;
      cp_async16_or_zero(st + kStageA + kr * kLdOutB + b_col,
                         w + (ok ? (size_t)(k0 + kr) * N + n0 + b_col : 0), ok);
    }
  };
  float acc[kMTW][kNJ][4];
#pragma unroll
  for (int m = 0; m < kMTW; ++m)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kOutStages - 1; ++c) {
    if (c < nk) stage(c);
    cp_async_commit();
  }
  cp_async_wait<kOutStages - 2>();
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + kOutStages - 1 < nk) stage(kc + kOutStages - 1);  // into chunk kc - 1's slot
    cp_async_commit();
    const bf16* st = ring + (kc % kOutStages) * kStage;
    warp_chunk_mma<kMTW, kNJ, kOutBK>(acc, st + wm * 64 * kLdOutA, kLdOutA,
                                      st + kStageA + wn * 32, kLdOutB);
    cp_async_wait<kOutStages - 2>();
    __syncthreads();  // chunk kc + 1 landed; every warp is done with chunk kc's slot
  }
  // acc + bo as float32 through shared memory (the ring is free), then y =
  // round(that + x) by rows of 8 columns: 16-byte loads of x, stores of y
  constexpr int kLdY = kOutN + 4;
  float* ys = reinterpret_cast<float*>(tc_smem);
  const bf16* bo = static_cast<const bf16*>(p.bo);
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int c = wn * 32 + 8 * j + 2 * t4;
    const __nv_bfloat162 bv = n0 + c < N ? *reinterpret_cast<const __nv_bfloat162*>(bo + n0 + c)
                                         : __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kMTW; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(ys + (wm * 64 + 16 * m + g + 8 * hh) * kLdY + c) =
            make_float2(acc[m][j][2 * hh] + __low2float(bv), acc[m][j][2 * hh + 1] + __high2float(bv));
  }
  __syncthreads();
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* y = static_cast<bf16*>(p.y);
  for (int i = tid; i < kOutM * (kOutN / 8); i += kOutThreads) {
    const int r = i / (kOutN / 8), c = (i % (kOutN / 8)) * 8;
    if (m0 + r >= M || n0 + c >= N) continue;
    const size_t at = (size_t)(m0 + r) * N + n0 + c;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
    const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const float* yr = ys + r * kLdY + c;
    uint4 o;
    uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ov[e] = pack_bf16(yr[2 * e] + __low2float(xh[e]), yr[2 * e + 1] + __high2float(xh[e]));
    *reinterpret_cast<uint4*>(y + at) = o;
  }
}

// the ring, which the epilogue's float32 tile [128][132] reuses
constexpr int out_proj_smem() { return kOutStages * (kOutM * kLdOutA + kOutBK * kLdOutB) * 2; }
static_assert(out_proj_smem() >= kOutM * (kOutN + 4) * 4, "the output tile fits the ring");

template <int kD, int kBK>
cudaError_t launch_qkv_attn(const FusedParams& p, cudaStream_t stream) {
  const int smem = qkv_attn_smem<kD>(p.bblk * p.T, p.W, kBK);
  cudaError_t err = cudaFuncSetAttribute(k6_qkv_attn_tc_kernel<kD, kBK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k6_qkv_attn_tc_kernel<kD, kBK>
      <<<dim3(p.H, (p.B + p.bblk - 1) / p.bblk), QkvShape<kD>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// bk: the qkv-attention kernel's chunk depth (64 or 32, the plan's)
template <int kD>
cudaError_t launch_fused_fwd_tc(const FusedParams& p, int bk, cudaStream_t stream) {
  const int M = p.B * p.T;
  k6_ln_stats_kernel<<<(M + kStatsThreads / 32 - 1) / (kStatsThreads / 32), kStatsThreads, 0,
                       stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = bk == 64 ? launch_qkv_attn<kD, 64>(p, stream) : launch_qkv_attn<kD, 32>(p, stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k6_out_proj_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_proj_smem());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + kOutN - 1) / kOutN, (M + kOutM - 1) / kOutM);
  k6_out_proj_tc_kernel<<<grid, kOutThreads, out_proj_smem(), stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32

// Columns [col[g], col[g] + D) of the packed qkv for rows [row0, row0 + 64)
// of one sample (NG column groups), LN applied to x on the fly:
// dst[g][(r - row0) * (kD + 1) + c] = fp32(LN(x) . Wqkv) + bqkv for the
// first dst_rows local rows (zero past T).  Thread (ty, tx) owns rows
// ty + 8 i and columns tx + 32 j below NCOL.
template <int kD, int NG>
__device__ void project_fma(const FusedParams& p, const float* xb, const float* mu,
                            const float* rs, float* As, float* Bs, int row0, const int (&col)[NG],
                            float* const (&dst)[NG], int dst_rows) {
  constexpr int NCOL = NG * kD;
  constexpr int NJ = (NCOL + 31) / 32;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int hd3 = 3 * p.H * kD;
  const float* w = static_cast<const float*>(p.wqkv);
  const float* lns = static_cast<const float*>(p.lns);
  const float* lnb = static_cast<const float*>(p.lnb);
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
        const float xhat = (xb[(size_t)t * p.W + d] - mu[t]) * rs[t];
        v = xhat * lns[d] + lnb[d];
      }
      As[r * (kBD + 1) + dd] = v;
    }
    for (int i = tid; i < kBD * NCOL; i += kThreads) {
      const int dd = i / NCOL, c = i % NCOL;
      Bs[dd * NCOL + c] = w[(size_t)(d0 + dd) * hd3 + col[c / kD] + c % kD];
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
  const float* bias = static_cast<const float*>(p.bqkv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= dst_rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 32 * j, g = c / kD, cc = c % kD;
      if (c >= NCOL) continue;
      dst[g][r * (kD + 1) + cc] = row0 + r < p.T ? acc[i][j] + bias[col[g] + cc] : 0.f;
    }
  }
}

template <int kD>
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
  const float* xb = static_cast<const float*>(p.x) + (size_t)b * T_ * p.W;

  // row statistics in fp32 (the JAX _ln_forward): one warp per row
  for (int t = warp; t < T_; t += kThreads / 32) {
    const float* xr = xb + (size_t)t * p.W;
    float s = 0.f;
    for (int d = lane; d < p.W; d += 32) s += xr[d];
    const float m = warp_sum(s) / (float)p.W;
    float v = 0.f;
    for (int d = lane; d < p.W; d += 32) {
      const float e = xr[d] - m;
      v = fmaf(e, e, v);
    }
    v = warp_sum(v) / (float)p.W;
    if (lane == 0) {
      mu[t] = m;
      rs[t] = rsqrtf(v + p.eps);
    }
  }
  // K and V of head h for all T rows (project_fma starts with a barrier)
  {
    const int col[2] = {hd + h * kD, 2 * hd + h * kD};
    for (int row0 = 0; row0 < T_; row0 += kBQ) {
      float* const dst[2] = {Ks + row0 * (kD + 1), Vs + row0 * (kD + 1)};
      project_fma<kD, 2>(p, xb, mu, rs, As, Bs, row0, col, dst, min(kBQ, T_ - row0));
    }
  }

  const int k_hi = min(T_, p.t_real);
  constexpr int kORS = kThreads / kD;  // output: column od, rows orow0 + i * kORS
  constexpr int kNO = kBQ / kORS;
  const int od = tid % kD, orow0 = tid / kD;
  constexpr int kSRS = kThreads / kBK;  // scores: key column sc, rows srow0 + i * kSRS
  constexpr int kNS = kBQ / kSRS;
  const int sc = tid % kBK, srow0 = tid / kBK;
  float* attn = static_cast<float*>(p.attn);

  for (int q0 = 0; q0 < T_; q0 += kBQ) {
    {
      const int col[1] = {h * kD};
      float* const dst[1] = {Qs};
      project_fma<kD, 1>(p, xb, mu, rs, As, Bs, q0, col, dst, kBQ);
    }
    for (int r = tid; r < kBQ; r += kThreads) {
      row_m[r] = -INFINITY;
      row_l[r] = 0.f;
    }
    float acc[kNO];
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
    __syncthreads();
    // pass 0: each row's max and sum (online); pass 1: acc += P V
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
            Ss[r * (kBK + 1) + lane] = expf(x - row_m[r]) / row_l[r];
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
      if (t < T_) attn[((size_t)b * T_ + t) * hd + h * kD + od] = acc[i];
    }
  }
}

// y[m, n] = fp32(attn[m, :] . Wo[:, n]) + bo[n] + x[m, n], FMA on the CUDA cores
__global__ void __launch_bounds__(kThreads) out_proj_kernel(FusedParams p) {
  __shared__ float As[kBQ][kBD + 1];
  __shared__ float Bs[kBD][kBN];
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBQ;
  const int M = p.B * p.T, K = p.H * p.D;
  const float* a = static_cast<const float*>(p.attn);
  const float* w = static_cast<const float*>(p.wo);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBD) {
    __syncthreads();
    for (int i = tid; i < kBQ * kBD; i += kThreads) {
      const int r = i / kBD, kk = i % kBD, m = m0 + r;
      As[r][kk] = m < M && k0 + kk < K ? a[(size_t)m * K + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kBD * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN, n = n0 + c;
      Bs[kk][c] = n < p.W && k0 + kk < K ? w[(size_t)(k0 + kk) * p.W + n] : 0.f;
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
  const float* bo = static_cast<const float*>(p.bo);
  const float* x = static_cast<const float*>(p.x);
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n < p.W) {
        const size_t at = (size_t)m * p.W + n;
        y[at] = (acc[i][j] + bo[n]) + x[at];
      }
    }
  }
}

template <int kD>
size_t fused_attn_smem(int T) {
  return sizeof(float) * (2 * (size_t)T + 2 * (size_t)T * (kD + 1) + kBQ * (kD + 1) +
                          kBQ * (kBK + 1) + 2 * kBQ + kBQ * (kBD + 1) + kBD * 2 * kD);
}

template <int kD>
cudaError_t launch_fused_fwd_fp32(const FusedParams& p, cudaStream_t stream) {
  const size_t smem = fused_attn_smem<kD>(p.T);
  cudaError_t err = cudaFuncSetAttribute(fused_attn_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_attn_kernel<kD><<<dim3(p.H, p.B), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long M = (long long)p.B * p.T;
  const dim3 grid((p.W + kBN - 1) / kBN, (unsigned)((M + kBQ - 1) / kBQ));
  out_proj_kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (ws null; bblk not read), 1 = bfloat16 (ws: float32
// [2, B * T] for the LN statistics; bblk samples a CTA of the qkv-attention
// kernel, bblk * T <= 128 or bblk 1, and its chunk depth as
// ops/fused_attention_block.py:k6_fwd_plan gives them).  Returns the first
// failing launch's cudaError_t.
extern "C" int mcl_fused_attention_fwd(const void* x, const void* lns, const void* lnb,
                                       const void* wqkv, const void* bqkv, const void* wo,
                                       const void* bo, void* y, void* attn, float* ws, int B,
                                       int T, int W, int H, int D, int t_real, float eps,
                                       float scale, int bblk, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || H <= 0 || W <= 0 || W % kBD || dtype < 0 || dtype > 1 ||
      (dtype == 1) != (ws != nullptr) ||
      (dtype == 1 && (bblk <= 0 || (bblk > 1 && bblk * T > kPassRows))))
    return (int)cudaErrorInvalidValue;
  FusedParams p{x, lns, lnb, wqkv, bqkv, wo, bo, y, attn, ws, B, T, W, H, D, t_real, eps, scale,
                bblk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 0) return launch_fused_fwd_fp32<kD>(p, s);
    // 64-deep chunks where the width and the shared memory allow them
    const int bk = W % 64 == 0 && qkv_attn_smem<kD>(bblk * T, W, 64) <= kSmemPerBlock ? 64 : 32;
    return launch_fused_fwd_tc<kD>(p, bk, s);
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
