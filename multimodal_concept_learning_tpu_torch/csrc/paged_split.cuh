// What K3 (paged_attention.cu) and K4 (paged_attention_mp.cu) share: the
// split of one (batch row, kv head)'s attended tokens over the CTAs of a
// thread block cluster, the per-token score / online softmax / P V step of a
// lane group, and the fixed-order merges.
//
// Both kernels launch a grid (S, B, Hk) in clusters of (S, 1, 1): the S CTAs
// of a cluster take S contiguous runs of the row's attended range
// [start, end), each run a whole number of the kernel's units (K3: 32-token
// chunks counted from `start`; K4: `seg`-token segments at multiples of
// `seg`, so that each stays inside one page).  S comes from the shapes alone
// (ops/paged_attention_kernel.py:paged_split_plan); each CTA works out its
// run from lens[b] on the device, so the grid never depends on lens and the
// wrapper never reads it.  A run may be empty (a short row, a row of length
// 0, a rank past `end`).
//
// Inside a CTA, lane groups of kL lanes (one token row: kL x kP 16-byte
// pieces) take tokens in turn, kU at a time, and each keeps its own float32
// online softmax over the G heads in registers (running max m, denominator
// l, accumulator acc over its lanes' kE columns): no barrier between
// tokens.  At the end the CTA merges its groups' states in group order in
// shared memory; then (S > 1) each CTA pushes its partial to the CTAs that
// own each slice of the [G, D] output (distributed shared memory, 16-byte
// stores), one cluster barrier, and each owner merges the S partials of its
// slice in rank order and writes acc / l, or exact zeros where l == 0.  A
// partial of an empty run has m = -inf, l = 0, acc = 0 and adds nothing.
// Fixed orders everywhere, so two calls give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mcl_paged {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;   // q heads per kv head
constexpr int kMaxSplit = 16;  // cluster size: 8 portable, 16 with the non-portable attribute

// How a token row of D elements of T maps onto lanes.
template <typename T, int D>
struct RowTile {
  static constexpr int kVec = 16 / sizeof(T);          // elements a 16-byte piece
  static constexpr int kPieces = D / kVec;             // pieces a row
  static constexpr int kL = kPieces < 32 ? kPieces : 32;  // lanes a token
  static constexpr int kP = kPieces / kL;              // pieces a lane
  static constexpr int kE = kP * kVec;                 // columns a lane
  static constexpr int kGroups = 32 / kL;              // lane groups a warp
  static constexpr int kNG = kWarps * kGroups;         // lane groups a CTA
  static_assert(D % kVec == 0 && kPieces % kL == 0, "head_dim");
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a 16-byte piece of T widened to fp32
template <typename T>
__device__ __forceinline__ void widen(float* dst, const uint4& raw);
template <>
__device__ __forceinline__ void widen<float>(float* dst, const uint4& raw) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(float* dst, const uint4& raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The tokens row b attends: i in [start, end) with i < len, (len - 1) - i <
// window when window >= 0, and i inside the page table's NP * ps columns.
__device__ __forceinline__ void attended(int len, int window, int limit, int& start, int& end) {
  end = min(len, limit);
  start = window >= 0 ? max(0, len - window) : 0;
}

// Rank `rank`'s run [lo, hi) of [start, end) in `unit`-token pieces counted
// from `start` (K3's chunks): ceil(n / S) tokens rounded up to whole units.
__device__ __forceinline__ void run_from_start(int start, int end, int unit, int S, int rank,
                                               int& lo, int& hi) {
  const int n = max(0, end - start);
  const int per = ((n + S - 1) / S + unit - 1) / unit * unit;
  lo = min(end, start + rank * per);
  hi = min(end, lo + per);
}

// Rank `rank`'s run in whole `unit`-token pieces at multiples of `unit`
// (K4's segments): the pieces [u0, u1) that [start, end) touches, ceil of
// their count over S a rank; [lo, hi) in tokens, cut to [start, end).
__device__ __forceinline__ void run_aligned(int start, int end, int unit, int S, int rank,
                                            int& lo, int& hi) {
  const int u0 = start / unit;
  const int u1 = start < end ? (end + unit - 1) / unit : u0;
  const int per = (u1 - u0 + S - 1) / S;
  lo = min(end, max(start, (u0 + rank * per) * unit));
  hi = min(end, (u0 + (rank + 1) * per) * unit);
  if (hi < lo) hi = lo;
}

// Output elements [G][D] a cluster rank owns: a multiple of 4 (16-byte pushes).
__host__ __device__ constexpr int slice_of(int G, int D, int S) {
  return ((G * D + S - 1) / S + 3) / 4 * 4;
}

// Shared memory, in floats: the CTA merge (every group's acc [kNG][G][D],
// then m and l [kNG][G], then the CTA's m and l [G]); the receive buffer of
// the cluster merge (S slices, then S x G (m, l) pairs).
template <typename T, int D>
__host__ __device__ constexpr int merge_floats(int G) {
  return (RowTile<T, D>::kNG * G * (D + 2) + 2 * G + 3) / 4 * 4;  // 16-byte multiple
}
__host__ __device__ constexpr int recv_floats(int G, int D, int S) {
  return S > 1 ? S * slice_of(G, D, S) + 2 * S * G : 0;
}

// One lane's share of its group's online softmax over the G <= kG heads.
template <typename T, int D, int kG>
struct GroupState {
  using Tile = RowTile<T, D>;
  static constexpr int kE = Tile::kE;
  static constexpr int kP = Tile::kP;
  static constexpr int kU = kG * kE <= 32 ? 4 : 2;  // tokens in flight a group
  float q[kG][kE];  // q * scale, this lane's columns
  float m[kG], l[kG], acc[kG][kE];

  // qg: the group's [G][D] query rows (16-byte aligned); sub: lane in group
  __device__ __forceinline__ void init(const T* qg, int G, int sub, float scale) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (g < G) raw = *reinterpret_cast<const uint4*>(qg + g * D + sub * kE + p * Tile::kVec);
        widen<T>(&q[g][p * Tile::kVec], raw);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        q[g][e] *= scale;
        acc[g][e] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
  }

  // kU tokens of the group: their K and V pieces and whether each is
  // attended; every lane of the warp calls this together
  __device__ __forceinline__ void update(const uint4 (&kr)[kU][kP], const uint4 (&vr)[kU][kP],
                                         const bool (&ok)[kU], int G) {
    float s[kU][kG];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float k[kE];
#pragma unroll
      for (int p = 0; p < kP; ++p) widen<T>(&k[p * Tile::kVec], kr[u][p]);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) x = fmaf(q[g][e], k[e], x);
        s[u][g] = x;
      }
    }
#pragma unroll
    for (int o = Tile::kL / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    float v[kU][kE];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int p = 0; p < kP; ++p) widen<T>(&v[u][p * Tile::kVec], vr[u][p]);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float m_use = mx == -INFINITY ? 0.f : mx;  // nothing attended yet
      const float alpha = expf(m[g] - m_use);
      float pu[kU];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        pu[u] = ok[u] ? expf(s[u][g] - m_use) : 0.f;
        sum += pu[u];
      }
      l[g] = fmaf(l[g], alpha, sum);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kU; ++u) a = fmaf(pu[u], v[u][e], a);
        acc[g][e] = a;
      }
      m[g] = mx;
    }
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The end of both kernels: every lane's group state st (gi: its group, sub:
// its lane in the group) merged into out [G][D] (the group of heads of this
// (row, kv head)).  smem_merge: merge_floats<T, D>(G) floats, free to use;
// recv: recv_floats(G, D, S) floats no one else uses.  With S > 1 the caller
// did cluster_arrive_relaxed() at its start.
template <typename T, int D, int kG>
__device__ __forceinline__ void finish(const GroupState<T, D, kG>& st, int gi, int sub,
                                       float* smem_merge, float* recv, int G, int S, T* out) {
  using Tile = RowTile<T, D>;
  constexpr int kE = Tile::kE;
  constexpr int kNG = Tile::kNG;
  const int E = G * D;
  float* acc_s = smem_merge;                 // [kNG][G][D]
  float* m_s = acc_s + kNG * E;              // [kNG][G]
  float* l_s = m_s + kNG * G;                // [kNG][G]
  float* cta_ml = l_s + kNG * G;             // [G] (m, l) of the CTA
  const int tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int e = 0; e < kE; e += 4)
      *reinterpret_cast<float4*>(acc_s + (gi * G + g) * D + sub * kE + e) =
          make_float4(st.acc[g][e], st.acc[g][e + 1], st.acc[g][e + 2], st.acc[g][e + 3]);
    if (sub == 0) {
      m_s[gi * G + g] = st.m[g];
      l_s[gi * G + g] = st.l[g];
    }
  }
  __syncthreads();

  // the CTA's partial, 4 neighbouring columns a thread, groups in order
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int slice = slice_of(G, D, S);
  if (S > 1) cluster_wait();  // every CTA of the cluster runs: remote stores are safe
  for (int e0 = 4 * tid; e0 < E; e0 += 4 * kThreads) {
    const int g = e0 / D;
    float mx = -INFINITY, l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < kNG; ++i) mx = fmaxf(mx, m_s[i * G + g]);
    for (int i = 0; i < kNG; ++i) {
      const float mi = m_s[i * G + g];
      if (mi == -INFINITY) continue;  // a group that attended nothing
      const float w = expf(mi - mx);
      const float4 x = *reinterpret_cast<const float4*>(acc_s + i * E + e0);
      l = fmaf(w, l_s[i * G + g], l);
      a[0] = fmaf(w, x.x, a[0]);
      a[1] = fmaf(w, x.y, a[1]);
      a[2] = fmaf(w, x.z, a[2]);
      a[3] = fmaf(w, x.w, a[3]);
    }
    if (S == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[e0 + j] = from_f<T>(l > 0.f ? a[j] / l : 0.f);
      continue;
    }
    if (e0 % D == 0) {
      cta_ml[2 * g] = mx;
      cta_ml[2 * g + 1] = l;
    }
    const int owner = e0 / slice;
    float* dst = cg::this_cluster().map_shared_rank(recv, owner);
    *reinterpret_cast<float4*>(dst + rank * slice + e0 - owner * slice) =
        make_float4(a[0], a[1], a[2], a[3]);
  }
  if (S == 1) return;
  __syncthreads();  // cta_ml written
  for (int i = tid; i < S * G; i += kThreads) {
    const int owner = i / G, g = i % G;
    float* dst = cg::this_cluster().map_shared_rank(recv, owner);
    *reinterpret_cast<float2*>(dst + S * slice + 2 * (rank * G + g)) =
        make_float2(cta_ml[2 * g], cta_ml[2 * g + 1]);
  }
  cg::this_cluster().sync();  // every push done (release) and visible here (acquire)

  // this rank's slice of the output, the S partials in rank order
  const float* ml = recv + S * slice;
  for (int i = tid; i < slice; i += kThreads) {
    const int e = rank * slice + i;
    if (e >= E) break;
    const int g = e / D;
    float mx = -INFINITY, l = 0.f, a = 0.f;
    for (int r = 0; r < S; ++r) mx = fmaxf(mx, ml[2 * (r * G + g)]);
    for (int r = 0; r < S; ++r) {
      const float mr = ml[2 * (r * G + g)];
      if (mr == -INFINITY) continue;  // an empty run adds nothing
      const float w = expf(mr - mx);
      l = fmaf(w, ml[2 * (r * G + g) + 1], l);
      a = fmaf(w, recv[r * slice + i], a);
    }
    out[e] = from_f<T>(l > 0.f ? a / l : 0.f);
  }
}

// Launch `kernel` over a grid (S, B, Hk) in clusters of (S, 1, 1) with
// `smem` bytes of dynamic shared memory; the launch's error, if any.
template <typename Params>
cudaError_t launch_split(void (*kernel)(Params), const Params& p, int S, int B, int Hk,
                         size_t smem, cudaStream_t stream) {
  if (S < 1 || S > kMaxSplit) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && S > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S, (unsigned)B, (unsigned)Hk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace mcl_paged
