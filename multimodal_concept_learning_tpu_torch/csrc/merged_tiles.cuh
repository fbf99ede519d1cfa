// Tensor-core attention tiles over rows merged across samples (bf16,
// sm_90a), shared by K2-bd's forward (attention_core_bd.cu) and the
// backward pair of K2, K2-bd and K6 (merged_bwd_tc.cuh).
//
// A CTA of 4 warps owns up to 64 "own" rows of one or more samples, 16 a
// warp in 16-row slots of one sample each (K2-bd's forward, the backward
// pair; a sample's last slot partial), and attends the "other" rows of the
// samples its own rows touch: keys for a forward or a dQ pass, queries for
// a dK/dV pass.  Only a segment of each touched sample's other rows is
// staged, compacted: sample b0 + i gives its rows [(b0 + i) T, (b0 + i) T +
// len_i) at compacted offsets seg[i] .. seg[i + 1], len_i chosen by the
// kernel (a caption's key end; T; t_real).  An own row attends the compacted range of its own
// sample (cut further under causal), and a flag per staged row drops the
// rows kv_mask drops; every other entry is masked to -inf per element of
// the C fragment.  So a CTA of text rows over two 13-token captions stages
// one 32-row sub-tile of keys, where the span of the two samples holds
// 154, and a CTA of vision rows (T 50: its 4 slots are one sample) stages
// that sample's 50.  Other rows are staged kMtChunk at a time (bf16 rows
// of stride D + 8, by cp.async, zero-filled up to a whole sub-tile), and
// each warp walks only the 32-row sub-tiles that its own rows' ranges
// reach.
//
// Products: mma.sync m16n8k16 with fp32 accumulation through the warp
// tiles of mma_tiles.cuh (warp_scores for S-shaped products, warp_pv for
// P.V-shaped ones, probs_to_a to turn a C fragment into an A fragment).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kMtThreads = 128;  // 4 warps x 16 own rows
constexpr int kMtRows = 64;      // own rows a CTA
constexpr int kMtSub = 32;       // other rows a sub-tile: the n of S, the k of P.V
constexpr int kMtChunk = 160;    // other rows staged at a time (text: <= 2 x 77)
constexpr int kMtSamples = kMtRows;  // samples 64 rows can touch (T = 1)
constexpr int kMtEmpty = 1 << 30;    // lo of an empty range

struct MtPlan {  // in shared memory
  int seg[kMtSamples + 1];      // compacted offset of each touched sample; seg[ns] = total
  int orow[kMtChunk];           // merged row of each staged other row (-1: past the chunk)
  unsigned char ook[kMtChunk];  // the staged row may be attended (kv_mask)
};

// pl.seg[i] = the key end of sample b0 + i for i < ns: one past its last
// key below min(T, t_real) that kv_mask keeps (no mask: min(T, t_real)).
// Needs a barrier before pl.seg is read.
__device__ __forceinline__ void mt_key_ends(MtPlan& pl, const int* kv_mask, int T, int t_real,
                                            int b0, int ns) {
  const int hi = max(0, min(T, t_real));
  for (int i = threadIdx.x; i < ns; i += kMtThreads) pl.seg[i] = kv_mask == nullptr ? hi : 0;
  if (kv_mask == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < ns * hi; i += kMtThreads) {
    const int s = i / hi, c = i % hi;
    if (kv_mask[(size_t)(b0 + s) * T + c] != 0) atomicMax(&pl.seg[s], c + 1);
  }
}

// pl.seg[0..ns] as offsets: segment i has length len(i, pl.seg[i]) (the
// value the caller left there).  Barriers before and after.
template <typename Len>
__device__ __forceinline__ void mt_offsets(MtPlan& pl, int ns, Len len) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < ns; ++i) {
      const int n = len(i, pl.seg[i]);
      pl.seg[i] = acc;
      acc += n;
    }
    pl.seg[ns] = acc;
  }
  __syncthreads();
}

// The merged rows of compacted other rows [cb, cb + n), n = min(kMtChunk,
// total - cb), into pl.orow / pl.ook, filled with -1 / 0 up to a whole
// sub-tile.  Starts and ends with a barrier (the previous chunk's readers
// are done before it is overwritten).  Returns n.
__device__ __forceinline__ int mt_chunk_rows(MtPlan& pl, int ns, int b0, int T, int cb,
                                             const int* kv_mask) {
  __syncthreads();
  const int n = min(kMtChunk, pl.seg[ns] - cb);
  const int fill = (n + kMtSub - 1) / kMtSub * kMtSub;
  for (int j = threadIdx.x; j < fill; j += kMtThreads) {
    int row = -1;
    bool keep = false;
    if (j < n) {
      const int g = cb + j;
      int lo = 0, hi = ns;  // the last segment starting at or before g
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (pl.seg[mid] <= g) lo = mid; else hi = mid;
      }
      row = (b0 + lo) * T + (g - pl.seg[lo]);
      keep = kv_mask == nullptr || kv_mask[row] != 0;
    }
    pl.orow[j] = row;
    pl.ook[j] = keep;
  }
  __syncthreads();
  return n;
}

// The staged rows' D columns of one tensor (row r at src + r * stride) ->
// dst [fill][kD + 8] by cp.async; rows past the chunk are zero-filled.
template <int kD>
__device__ __forceinline__ void mt_stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         long long stride, const MtPlan& pl, int n) {
  constexpr int kC = kD / 8;
  const int fill = (n + kMtSub - 1) / kMtSub * kMtSub;
  for (int i = threadIdx.x; i < fill * kC; i += kMtThreads) {
    const int j = i / kC, c = (i % kC) * 8;
    const int row = pl.orow[j];
    cp_async16_or_zero(dst + j * (kD + 8) + c, src + (row >= 0 ? (long long)row * stride + c : 0),
                       row >= 0);
  }
}

// The union [wlo, whi) of the warp's rows' ranges (an empty range has lo
// >= hi and adds nothing).
__device__ __forceinline__ void mt_warp_range(const int (&lo)[2], const int (&hi)[2], int& wlo,
                                              int& whi) {
  wlo = __reduce_min_sync(0xffffffffu, min(lo[0], lo[1]));
  whi = __reduce_max_sync(0xffffffffu, max(hi[0], hi[1]));
}

// s (C layout, 16 own rows x kMtSub staged rows from j0, chunk-relative)
// scaled, with every entry outside its row's range [lo - cb, hi - cb) or on
// a dropped row at -inf.
__device__ __forceinline__ void mt_mask(float (&s)[kMtSub / 8][4], const MtPlan& pl, int j0,
                                        int cb, const int (&lo)[2], const int (&hi)[2],
                                        float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kMtSub / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j0 + 8 * j + 2 * t4 + (e & 1), g = cb + c, r = e >> 1;
      s[j][e] = g >= lo[r] && g < hi[r] && pl.ook[c] ? s[j][e] * scale : -INFINITY;
    }
  }
}

}  // namespace
