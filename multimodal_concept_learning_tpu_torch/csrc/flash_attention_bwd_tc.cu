// K1 backward in bf16 on the tensor cores (sm_90a): the dQ and dK/dV pair.
//
// Replaces, for bf16 inputs, the two Pallas TPU kernels of the custom VJP in
// multimodal_concept_learning_tpu/ops/flash_attention.py (_flash_bwd):
//   _dq_kernel  (:52, pallas_call at :206 / :221) -> flash_bwd_dq_tc_kernel
//   _dkv_kernel (:76, pallas_call at :256)        -> flash_bwd_dkv_tc_kernel
// with the contract of flash_attention_bwd.cu (whose CUDA-core kernels keep
// float32): q [B, Tq, Hq, D], k/v [B, Tk, Hk, D], the forward's o and lse,
// GQA read in place, masks from the kv_lens / causal / window descriptors,
// an optional float32 bias through four strides, dS [B, Hq, Tq, Tk] float32
// when asked for, a row with lse = +inf contributing nothing, any T, D 64,
// 128 and 256.  Arithmetic:
//   p = exp(s * scale + bias - lse),  dp = dO v^T,  delta = rowsum(dO * O),
//   dS = p (dp - delta),  dQ = dS k * scale,  dK = dS^T q * scale,  dV = p^T dO.
// Every product is mma.sync m16n8k16 with bf16 operands and fp32
// accumulation (mma_tiles.cuh).  So p is rounded to bf16 before p^T dO and
// dS before dS k and dS^T q, where the TPU kernels keep both in float32;
// the scale multiplies the float32 products, as the TPU kernels do.
// delta comes from o, as the TPU kernels compute it (not rowsum(dP * P)).
//
// What bounds it: at the MLLM training shape [2, 221, 4q/1kv, 256] (causal,
// kv_lens) the pair moves ~1.8 MB and does ~0.5 GFLOP: 0.5-0.6 us of bytes
// at 3.35 TB/s against 0.5 us of products at 989 TFLOP/s.  What costs time
// is latency: each warp's chain of tile copies, products over D = 256 and
// softmax steps, and a grid that a batch of 2 with one kv head keeps small.
// So the design spreads the work over as many warps as the card holds, and
// sums partial results in a fixed order (no atomics: two calls give the
// same bits):
// - dQ (one launch, before dK/dV): a CTA owns 64 rows of (query, q head of
//   the group) pairs, so the group's heads share every K/V tile it stages
//   (64 keys, double-buffered by cp.async), and kW of D's columns (at D 256 half:
//   each slice recomputes S and dP over all of D, for twice the CTAs).
//   Its 8 warps are 4 row slots of 16 x 2 halves of each staged key tile;
//   a cluster of 2 CTAs (thread block clusters) splits the row tile's key
//   tiles between them.  The halves add through shared memory, the two
//   CTAs through distributed shared memory, into the first.  The first
//   column slice writes delta (fp32, from the global o and dO) and dS.
// - dK/dV: a CTA owns 16 keys of one kv head and kW columns of dK and dV
//   (kW = 128: at D 256 two CTAs a key tile, each recomputing S^T and dP^T
//   over all of D).  The (q head of the group, 16-query tile) items are
//   split over the 12 warps of a cluster of 2 CTAs; each warp stages its
//   own items' Q, dO, lse and delta, the next while it works on one.  The
//   warps add through shared memory, the two CTAs through distributed
//   shared memory.
// At the training shape each launch is 14 x 2 x 2 clusters of 2 = 112 CTAs.
// P^T and dS^T come out of S^T = K Q^T in the C layout whose pairs of
// 8-column tiles are the A operand of P^T dO and dS^T Q, so neither goes
// through shared memory; dO and Q are read as the B operand by ldmatrix
// .trans.  S and dP (S^T and dP^T) are computed in one interleaved sweep
// over D with each step's fragments loaded a step ahead.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "mma_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mcl_flash::attendable;
using mcl_flash::bias_at;
using mcl_flash::BwdParams;

constexpr int kThreadsTc = 256;  // dQ: 8 warps
constexpr int kWarpsKv = 6;      // dK/dV: warps a CTA (each with two stages of its items)
constexpr int kCluster = 2;  // CTAs that share a row tile (dQ) or a key tile (dK/dV)
constexpr int kRowsTc = 64;  // dQ: (query, q head) rows a CTA, 16 a row slot
constexpr int kBK = 32;      // dQ: keys of a staged tile each half of the warps takes
constexpr int kKeysTc = 16;  // dK/dV: keys a CTA
constexpr int kItemQ = 16;   // dK/dV: queries an item

// 4 bytes from src, or 4 zero bytes (src not read) when !valid, by cp.async
__device__ __forceinline__ void cp_async4_or_zero(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// s = A1[16 rows] . B1[kN rows]^T and t = A2 . B2^T over kD, interleaved:
// warp_scores for two products at once (A* at the warp's first row, B* at
// the tile's first row, all of stride kD + 8).  The fragments of step k0 +
// 16 are loaded before the products of step k0 are issued, in registers of
// their own, so that no product waits for the load just before it.
template <int kD, int kN>
__device__ __forceinline__ void warp_scores_pair(float (&s)[kN / 8][4], float (&t)[kN / 8][4],
                                                 const bf16* A1, const bf16* B1, const bf16* A2,
                                                 const bf16* B2) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
  const int ao = (lane % 16) * (kD + 8) + 8 * (lane / 16);
  const int bo = (lane % 8 + 8 * (lane / 16)) * (kD + 8) + 8 * ((lane / 8) % 2);
  uint32_t a[2][2][4], b[2][2][kN / 16][4];  // [buffer][product][n0 / 16][fragment]
  auto load = [&](int buf, int k0) {
    ldmatrix_x4(a[buf][0], A1 + ao + k0);
    ldmatrix_x4(a[buf][1], A2 + ao + k0);
#pragma unroll
    for (int n = 0; n < kN / 16; ++n) {
      ldmatrix_x4(b[buf][0][n], B1 + bo + 16 * n * (kD + 8) + k0);
      ldmatrix_x4(b[buf][1][n], B2 + bo + 16 * n * (kD + 8) + k0);
    }
  };
  load(0, 0);
#pragma unroll
  for (int k0 = 0; k0 < kD; k0 += 16) {
    const int cur = (k0 / 16) & 1;
    if (k0 + 16 < kD) load(cur ^ 1, k0 + 16);
#pragma unroll
    for (int n = 0; n < kN / 16; ++n) {
      const uint32_t b1_lo[2] = {b[cur][0][n][0], b[cur][0][n][1]};
      const uint32_t b1_hi[2] = {b[cur][0][n][2], b[cur][0][n][3]};
      const uint32_t b2_lo[2] = {b[cur][1][n][0], b[cur][1][n][1]};
      const uint32_t b2_hi[2] = {b[cur][1][n][2], b[cur][1][n][3]};
      mma_bf16(s[2 * n], a[cur][0], b1_lo);
      mma_bf16(t[2 * n], a[cur][1], b2_lo);
      mma_bf16(s[2 * n + 1], a[cur][0], b1_hi);
      mma_bf16(t[2 * n + 1], a[cur][1], b2_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ, delta (and dS): a cluster of kCluster CTAs per (64 rows of (query, q
// head of the group), kv head x column slice, batch row); row rr is query
// rr / G, q head hk * G + rr % G.
// ---------------------------------------------------------------------------
template <int kD, int kNC>
__global__ void __launch_bounds__(kThreadsTc) flash_bwd_dq_tc_kernel(BwdParams p) {
  constexpr int kW = kD / kNC;    // dQ columns of this CTA
  constexpr int kTile = 2 * kBK;  // keys a stage: kBK for each half of the warps
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(dq_smem);  // [kRowsTc][kD + 8]; then dQ
  bf16* dOs = Qs + kRowsTc * (kD + 8);           // [kRowsTc][kD + 8]
  bf16* Ks = dOs + kRowsTc * (kD + 8);           // 2 stages of [kTile][kD + 8]
  bf16* Vs = Ks + 2 * kTile * (kD + 8);          // 2 stages of [kTile][kD + 8]

  const int G = p.Hq / p.Hk, R = p.Tq * G;
  // rank crank of the cluster takes every kCluster-th key tile of the rows
  const int crank = blockIdx.x % kCluster;
  const int row0 = blockIdx.x / kCluster * kRowsTc, hk = blockIdx.y / kNC, cs = blockIdx.y % kNC;
  const int b = blockIdx.z;
  // warp w: rows of slot w % 4, keys kBK * (w / 4) .. of each staged tile
  const int warp = threadIdx.x / 32 % 4, half = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int off = p.Tk - p.Tq;  // causal offset: query t sits at key position t + off
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* o = static_cast<const bf16*>(p.o);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const bf16* kbase = static_cast<const bf16*>(p.k) + ((size_t)b * p.Tk * p.Hk + hk) * kD;
  const bf16* vbase = static_cast<const bf16*>(p.v) + ((size_t)b * p.Tk * p.Hk + hk) * kD;
  const long long kv_stride = (long long)p.Hk * kD;
  auto row_offset = [&](int rr) {  // element offset of row rr in q, o, dout and dq
    return ((size_t)(b * p.Tq + rr / G) * p.Hq + hk * G + rr % G) * kD;
  };

  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kRowsTc * kChunks; i += kThreadsTc) {
    const int r = i / kChunks, c = (i % kChunks) * 8, rr = row0 + r;
    const bool ok = rr < R;
    const size_t at = ok ? row_offset(rr) + c : 0;
    cp_async16_or_zero(Qs + r * (kD + 8) + c, q + at, ok);
    cp_async16_or_zero(dOs + r * (kD + 8) + c, dout + at, ok);
  }

  // the key range any row of the tile can reach; the per-element mask is exact
  const int t_first = row0 / G, t_last = (min(R, row0 + kRowsTc) - 1) / G;
  const int kv_len = p.kv_lens ? min(p.Tk, p.kv_lens[b]) : p.Tk;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, t_last + off + 1);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, t_first + off - p.window + 1);
  k_lo = (k_lo / kTile) * kTile;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + kTile - 1) / kTile : 0;
  const int n_own = n_kt > crank ? (n_kt - crank + kCluster - 1) / kCluster : 0;
  auto load_kv = [&](int li) {  // the CTA's key tile li into stage li % 2
    const int kt = k_lo + (crank + li * kCluster) * kTile, st = li & 1;
    async_rows<kD, kThreadsTc>(Ks + st * kTile * (kD + 8), kbase + (size_t)kt * kv_stride,
                               kv_stride, kTile, k_hi - kt);
    async_rows<kD, kThreadsTc>(Vs + st * kTile * (kD + 8), vbase + (size_t)kt * kv_stride,
                               kv_stride, kTile, k_hi - kt);
  };
  if (n_own > 0) load_kv(0);
  cp_async_commit();  // with Q and dO

  // the thread's two rows: rr = rw + lane / 4 and rw + lane / 4 + 8
  const int rw = row0 + 16 * warp;
  const bool active = rw < R;
  bf16* Qw = Qs + 16 * warp * (kD + 8);  // the warp's Q rows, later its dQ rows
  const bf16* dOw = dOs + 16 * warp * (kD + 8);
  int tq[2], hq[2];
  float lse[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rr = rw + lane / 4 + 8 * hr;
    tq[hr] = rr / G;  // >= Tq for rows past R: attendable() refuses them
    hq[hr] = hk * G + rr % G;
    lse[hr] = rr < R ? p.lse[((size_t)b * p.Hq + hq[hr]) * p.Tq + tq[hr]] : INFINITY;
  }
  // delta = rowsum(dO * O) in fp32 from global memory while the tiles land:
  // lanes 2r and 2r + 1 of both halves' warps take row r, every fourth
  // 8-element chunk each, so that a lane's loads do not wait on one another;
  // the partial sums meet in shared memory, added in a fixed order
  __shared__ float delta_part[2][kRowsTc];
  {
    const int rr = rw + lane / 2;
    float sum = 0.f;
    if (rr < R) {
      const size_t at = row_offset(rr) + 8 * (2 * (lane % 2) + half);
#pragma unroll
      for (int c = 0; c < kD; c += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(dout + at + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
          sum = fmaf(gf.x, of.x, sum);
          sum = fmaf(gf.y, of.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (lane % 2 == 0) delta_part[half][16 * warp + lane / 2] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * warp + lane / 4 + 8 * hr;
    delta[hr] = delta_part[0][r] + delta_part[1][r];
  }
  if (active && cs == 0 && half == 0 && crank == 0 && lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (rw + lane / 4 + 8 * hr < R)
        p.delta[((size_t)b * p.Hq + hq[hr]) * p.Tq + tq[hr]] = delta[hr];
  }
  float* ds_rows[2] = {nullptr, nullptr};  // dS: the first column slice, each warp its keys
  if (p.ds != nullptr && cs == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (tq[hr] < p.Tq) ds_rows[hr] = p.ds + (((size_t)b * p.Hq + hq[hr]) * p.Tq + tq[hr]) * p.Tk;
  }

  float dq[kW / 8][4];
#pragma unroll
  for (int j = 0; j < kW / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  for (int it = 0; it < n_own; ++it) {
    if (it + 1 < n_own) {
      load_kv(it + 1);  // into the stage the previous iteration read
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt = k_lo + (crank + it * kCluster) * kTile + half * kBK;
    if (active && kt < k_hi) {
      const int st_off = (it & 1) * kTile * (kD + 8) + half * kBK * (kD + 8);
      const bf16* Kt = Ks + st_off;
      float s[kBK / 8][4], dp[kBK / 8][4];
      warp_scores_pair<kD, kBK>(s, dp, Qw, Kt, dOw, Vs + st_off);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // branch-free but for the bias
          const int hr = e >> 1, key = kt + 8 * j + 2 * (lane % 4) + (e & 1);
          const bool ok = attendable(tq[hr], key, p.Tq, kv_len, off, p.causal, p.window);
          float logit = s[j][e] * p.scale;
          if (p.bias != nullptr && ok) logit += bias_at(p, b, hq[hr], tq[hr], key);
          s[j][e] = ok ? __expf(logit - lse[hr]) * (dp[j][e] - delta[hr]) : 0.f;
        }
        if (ds_rows[0] != nullptr || ds_rows[1] != nullptr) {
          const int key = kt + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            if (ds_rows[hr] == nullptr) continue;
            if (key < p.Tk) ds_rows[hr][key] = s[j][2 * hr];
            if (key + 1 < p.Tk) ds_rows[hr][key + 1] = s[j][2 * hr + 1];
          }
        }
      }
      uint32_t dsa[kBK / 16][4];
      probs_to_a<kBK>(dsa, s);  // dS rounded to bf16
      warp_pv<kD, kBK, kW>(dq, dsa, Kt + cs * kW);
    }
    __syncthreads();  // the stage this iteration read is free for the next load
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into Qs has landed before it takes dQ
  // partial sums through the key stages, added in a fixed order: the second
  // half's into the first's, then rank 1's into rank 0's
  constexpr int kRS = kW + 4;
  float* red = reinterpret_cast<float*>(Ks) + warp * 16 * kRS;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < kW / 8; ++j) {
      *reinterpret_cast<float2*>(red + g * kRS + 8 * j + t2) = make_float2(dq[j][0], dq[j][1]);
      *reinterpret_cast<float2*>(red + (g + 8) * kRS + 8 * j + t2) =
          make_float2(dq[j][2], dq[j][3]);
    }
  };
  auto add = [&](const float* from) {
#pragma unroll
    for (int j = 0; j < kW / 8; ++j) {
      const float2 lo = *reinterpret_cast<const float2*>(from + g * kRS + 8 * j + t2);
      const float2 hi = *reinterpret_cast<const float2*>(from + (g + 8) * kRS + 8 * j + t2);
      dq[j][0] += lo.x;
      dq[j][1] += lo.y;
      dq[j][2] += hi.x;
      dq[j][3] += hi.y;
    }
  };
  if (half == 1 && active) put();
  __syncthreads();
  if (half == 0 && active) add(red);
  __syncthreads();  // red is free again
  cg::cluster_group cluster = cg::this_cluster();
  if (half == 0 && active) put();
  cluster.sync();
  if (crank == 0 && half == 0 && active)
    for (int rk = 1; rk < kCluster; ++rk) add(cluster.map_shared_rank(red, rk));
  cluster.sync();  // the other ranks' shared memory outlives rank 0's reads
  if (half == 1 || crank != 0 || !active) return;
  const float sc[2] = {p.scale, p.scale};
  bf16* out = static_cast<bf16*>(p.dq);
  warp_store_rows<kD, kW>(dq, sc, Qw, min(16, R - rw),
                          [&](int r) { return out + row_offset(rw + r) + cs * kW; });
}

// ---------------------------------------------------------------------------
// dK, dV: a cluster of kCluster CTAs per (16 keys, kv head x column slice of
// kW, batch row).
// ---------------------------------------------------------------------------
template <int kD>
__host__ __device__ constexpr size_t dkv_item_bytes() {  // a warp's two stages of Q and dO
  return 2 * 2 * kItemQ * (kD + 8) * sizeof(bf16);
}

template <int kD, int kW>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  constexpr size_t kv = 2 * kKeysTc * (kD + 8) * sizeof(bf16);
  constexpr size_t items = kWarpsKv * (dkv_item_bytes<kD>() + 2 * 2 * kItemQ * sizeof(float));
  constexpr size_t red = 2 * kWarpsKv * kKeysTc * (kW + 4) * sizeof(float);
  return kv + (items > red ? items : red);
}

template <int kD, int kW>
__global__ void __launch_bounds__(32 * kWarpsKv) flash_bwd_dkv_tc_kernel(BwdParams p) {
  constexpr int kWarps = kWarpsKv, kThreads = 32 * kWarps;
  constexpr int kNC = kD / kW;
  constexpr int kRS = kW + 4;  // row stride of the reduction buffer (floats)
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(dkv_smem);  // [kKeysTc][kD + 8]
  bf16* Vs = Ks + kKeysTc * (kD + 8);             // [kKeysTc][kD + 8]
  unsigned char* work = reinterpret_cast<unsigned char*>(Vs + kKeysTc * (kD + 8));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's stages: [2][Q, dO][kItemQ][kD + 8]; then every warp's
  // [2][lse, delta][kItemQ]
  bf16* Iw = reinterpret_cast<bf16*>(work + warp * dkv_item_bytes<kD>());
  float* stats = reinterpret_cast<float*>(work + kWarps * dkv_item_bytes<kD>()) +
                 warp * 2 * 2 * kItemQ;
  float* red = reinterpret_cast<float*>(work);  // after the loop: [dK, dV][warps][16][kRS]

  const int G = p.Hq / p.Hk;
  // rank crank of the cluster takes every kCluster-th group of kWarps items
  const int crank = blockIdx.x % kCluster;
  const int k0 = blockIdx.x / kCluster * kKeysTc, j = blockIdx.y / kNC, cs = blockIdx.y % kNC;
  const int b = blockIdx.z;
  const int off = p.Tk - p.Tq;
  const int kv_len = p.kv_lens ? min(p.Tk, p.kv_lens[b]) : p.Tk;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const long long kv_stride = (long long)p.Hk * kD;

  // query rows that can reach this key tile at all
  int q_lo = 0, q_hi = p.Tq;
  if (p.causal) q_lo = max(0, k0 - off);
  if (p.window >= 0) q_hi = min(q_hi, k0 + kKeysTc - 1 + p.window - off);
  q_lo = (q_lo / kItemQ) * kItemQ;
  if (k0 >= kv_len) q_hi = q_lo;  // the whole tile is padding: zero gradients
  const int n_items = q_hi > q_lo ? G * ((q_hi - q_lo + kItemQ - 1) / kItemQ) : 0;

  if (n_items > 0) {
    const size_t at = ((size_t)b * p.Tk + k0) * kv_stride + (size_t)j * kD;
    async_rows<kD, kThreads>(Ks, static_cast<const bf16*>(p.k) + at, kv_stride, kKeysTc,
                               kv_len - k0);
    async_rows<kD, kThreads>(Vs, static_cast<const bf16*>(p.v) + at, kv_stride, kKeysTc,
                               kv_len - k0);
  }
  // item i: q head j * G + i % G, queries qt .. qt + 15 with qt = q_lo + (i / G) * 16
  auto load_item = [&](int i, int st) {  // into stage st
    const int h = j * G + i % G, qt = q_lo + (i / G) * kItemQ;
    bf16* Qt = Iw + st * 2 * kItemQ * (kD + 8);
    bf16* dOt = Qt + kItemQ * (kD + 8);
    float* lse_s = stats + st * 2 * kItemQ;
    float* delta_s = lse_s + kItemQ;
    constexpr int kChunks = kD / 8;
    for (int x = lane; x < kItemQ * kChunks; x += 32) {
      const int r = x / kChunks, c = (x % kChunks) * 8, t = qt + r;
      const bool ok = t < p.Tq;
      const size_t at = ok ? ((size_t)(b * p.Tq + t) * p.Hq + h) * kD + c : 0;
      cp_async16_or_zero(Qt + r * (kD + 8) + c, q + at, ok);
      cp_async16_or_zero(dOt + r * (kD + 8) + c, dout + at, ok);
    }
    if (lane < kItemQ) {  // zero past Tq: those columns are masked
      const int t = qt + lane;
      const bool ok = t < p.Tq;
      const size_t at = ok ? ((size_t)b * p.Hq + h) * p.Tq + t : 0;
      cp_async4_or_zero(lse_s + lane, p.lse + at, ok);
      cp_async4_or_zero(delta_s + lane, p.delta + at, ok);
    }
  };
  const int i0 = crank * kWarps + warp, i_step = kWarps * kCluster;
  if (i0 < n_items) load_item(i0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K, V and every warp's first item have landed

  float dk[kW / 8][4], dv[kW / 8][4];
#pragma unroll
  for (int c = 0; c < kW / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;
  int it = 0;
  for (int i = i0; i < n_items; i += i_step, ++it) {
    const int st = it & 1;
    const bool next = i + i_step < n_items;
    if (next) {
      load_item(i + i_step, st ^ 1);  // the stage the previous item read
      cp_async_commit();
    }
    const int h = j * G + i % G, qt = q_lo + (i / G) * kItemQ;
    const bf16* Qt = Iw + st * 2 * kItemQ * (kD + 8);
    const bf16* dOt = Qt + kItemQ * (kD + 8);
    const float* lse_s = stats + st * 2 * kItemQ;
    const float* delta_s = lse_s + kItemQ;
    // the lse and delta of the thread's query columns 8c + 2(lane % 4) + {0, 1}
    float2 lse2[kItemQ / 8], delta2[kItemQ / 8];
#pragma unroll
    for (int c = 0; c < kItemQ / 8; ++c) {
      lse2[c] = *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * (lane % 4));
      delta2[c] = *reinterpret_cast<const float2*>(delta_s + 8 * c + 2 * (lane % 4));
    }
    float s[kItemQ / 8][4], dp[kItemQ / 8][4];  // S^T, dP^T: rows keys, columns queries
    warp_scores_pair<kD, kItemQ>(s, dp, Ks, Qt, Vs, dOt);
#pragma unroll
    for (int c = 0; c < kItemQ / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // branch-free but for the bias
        const int key = k0 + lane / 4 + 8 * (e >> 1), qc = 8 * c + 2 * (lane % 4) + (e & 1);
        const int t = qt + qc;
        const bool ok = attendable(t, key, p.Tq, kv_len, off, p.causal, p.window);
        float logit = s[c][e] * p.scale;
        if (p.bias != nullptr && ok) logit += bias_at(p, b, h, t, key);
        const float prob = ok ? __expf(logit - (e & 1 ? lse2[c].y : lse2[c].x)) : 0.f;
        s[c][e] = prob;
        dp[c][e] = prob * (dp[c][e] - (e & 1 ? delta2[c].y : delta2[c].x));
      }
    }
    uint32_t pa[kItemQ / 16][4], dsa[kItemQ / 16][4];
    probs_to_a<kItemQ>(pa, s);    // P^T rounded to bf16
    probs_to_a<kItemQ>(dsa, dp);  // dS^T rounded to bf16
    warp_pv<kD, kItemQ, kW>(dv, pa, dOt + cs * kW);
    warp_pv<kD, kItemQ, kW>(dk, dsa, Qt + cs * kW);
    if (next) cp_async_wait<0>();
    __syncwarp();  // the next item has landed; this one's stage is free
  }
  __syncthreads();  // every warp is done with its item before the reduction takes them

  // the warps' partial sums, added in warp order into warp 0's slots
  const int g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int c = 0; c < kW / 8; ++c) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* rk = red + (warp * kKeysTc + g + 8 * hr) * kRS + 8 * c + t2;
      float* rv = rk + kWarps * kKeysTc * kRS;
      rk[0] = dk[c][2 * hr];
      rk[1] = dk[c][2 * hr + 1];
      rv[0] = dv[c][2 * hr];
      rv[1] = dv[c][2 * hr + 1];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < kKeysTc * kW; x += kThreads) {
    const int r = x / kW, c = x % kW;
    float sk = red[r * kRS + c], sv = red[(kWarps * kKeysTc + r) * kRS + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      sk += red[(w * kKeysTc + r) * kRS + c];
      sv += red[((kWarps + w) * kKeysTc + r) * kRS + c];
    }
    red[r * kRS + c] = sk;
    red[(kWarps * kKeysTc + r) * kRS + c] = sv;
  }
  // rank 0 adds the other ranks' sums (read from their shared memory) in
  // rank order and writes dK and dV
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (crank == 0) {
    bf16* dk_out = static_cast<bf16*>(p.dk);
    bf16* dv_out = static_cast<bf16*>(p.dv);
    for (int x = threadIdx.x; x < kKeysTc * kW; x += kThreads) {
      const int r = x / kW, c = x % kW, key = k0 + r;
      if (key >= p.Tk) continue;
      float sk = red[r * kRS + c], sv = red[(kWarps * kKeysTc + r) * kRS + c];
#pragma unroll
      for (int rk = 1; rk < kCluster; ++rk) {
        const float* other = cluster.map_shared_rank(red, rk);
        sk += other[r * kRS + c];
        sv += other[(kWarps * kKeysTc + r) * kRS + c];
      }
      const size_t at = ((size_t)b * p.Tk + key) * kv_stride + (size_t)j * kD + cs * kW + c;
      dk_out[at] = __float2bfloat16(sk * p.scale);
      dv_out[at] = __float2bfloat16(sv);
    }
  }
  cluster.sync();  // the other ranks' shared memory outlives rank 0's reads
}

// kernel<<<grid, threads, smem, stream>>>(p) in clusters of kCluster CTAs along x
template <typename Kernel>
cudaError_t launch_clusters(Kernel kernel, dim3 grid, int threads, size_t smem,
                            const BwdParams& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

template <int kD, int kNC>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kRowsTc + 4 * 2 * kBK) * (kD + 8);
  const dim3 grid((p.Tq * (p.Hq / p.Hk) + kRowsTc - 1) / kRowsTc * kCluster, p.Hk * kNC, p.B);
  return launch_clusters(flash_bwd_dq_tc_kernel<kD, kNC>, grid, kThreadsTc, smem, p, stream);
}

template <int kD, int kW>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.Tk + kKeysTc - 1) / kKeysTc * kCluster, p.Hk * (kD / kW), p.B);
  return launch_clusters(flash_bwd_dkv_tc_kernel<kD, kW>, grid, 32 * kWarpsKv,
                         dkv_smem_bytes<kD, kW>(), p, stream);
}

}  // namespace

namespace mcl_flash {

// Column slices of at most 128: dQ's accumulator takes 64 registers a
// thread, dK's and dV's 128.
cudaError_t launch_bwd_dq_tc(const BwdParams& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_dq<64, 1>(p, stream);
    case 128: return launch_dq<128, 1>(p, stream);
    case 256: return launch_dq<256, 2>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bwd_dkv_tc(const BwdParams& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_dkv<64, 64>(p, stream);
    case 128: return launch_dkv<128, 128>(p, stream);
    case 256: return launch_dkv<256, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mcl_flash
