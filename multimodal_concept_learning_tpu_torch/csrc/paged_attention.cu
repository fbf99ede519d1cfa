// K3: one-token decode attention against a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/
// paged_attention_kernel.py:_kernel (pallas_call at :133).  For each batch
// row b and kv head h it computes the whole GQA group of G = Hq / Hk
// query heads (q head h * G + g, the grouped order of ops/attention.py):
//     o[b, hG+g] = softmax_i(q[b, hG+g] . K[i] * scale) V[i]
// over the row's tokens i < lens[b], read through page_table[b, i / ps] from
// pools [P, Hk, ps, D] (head-major: one page of one head is a contiguous
// [ps, D] block).  Sliding window: i is attended only if
// (lens[b] - 1) - i < window (window < 0: global); tokens before the window
// are never read.  A row with lens[b] == 0 outputs zeros.
//
// What bounds it: bytes.  Each step reads every live K/V token of every row
// once (2 * len * Hk * D elements per row and layer) and does 4 flops per
// element, far below the card's ~295 flops/byte balance point.  At decode
// sizes the bytes are few (gemma3-1b, batch 8, window 512: 1.4 MB, ~0.4 us
// at full rate), so what the card waits on is latency: the first design ran
// one CTA per (row, kv head), 8 CTAs on 132 SMs, each walking its row in a
// chain of dependent 32-token steps (page table, loads, widen, scores,
// softmax, P V, four barriers), ~6.6 us a step.  This design
// (csrc/paged_split.cuh):
//
// - splits each (row, kv head) over a thread block cluster of S CTAs: grid
//   (S, B, Hk), S from the shapes alone (ops/paged_attention_kernel.py:
//   paged_split_plan); each CTA takes a run of whole 32-token chunks of the
//   row's attended range, worked out from lens[b] on the device;
// - reads the page ids of its run once, at the start (kPageBuf of them;
//   a longer run reads the rest from the table as it goes);
// - lets each lane group (one token row: 32 lanes x 16 bytes at D 256 in
//   bf16) take tokens in turn, kU at a time, all their 16-byte K and V loads
//   issued before any arithmetic, and keep its own float32 online softmax in
//   registers: no barrier from the first load to the end of the run;
// - merges the groups in shared memory and the S CTAs through distributed
//   shared memory, in fixed orders (two calls give the same bits).

#include "paged_split.cuh"

namespace {

using namespace mcl_paged;

constexpr int kChunk = 32;     // a run is a whole number of these (paged_split_plan's unit)
constexpr int kPageBuf = 512;  // page ids of the run read at the start

struct PagedParams {
  const void* q;       // [B, Hq, D] (the [B, 1, Hq, D] query), 16-byte aligned
  const void* k_pool;  // [P, Hk, ps, D], 16-byte aligned
  const void* v_pool;  // [P, Hk, ps, D], 16-byte aligned
  void* o;             // [B, Hq, D]
  const int* page_table;  // [B, NP]
  const int* lens;        // [B] attendable tokens including the new one
  int B, Hq, Hk, ps, NP;
  int window;
  float scale;
  int S;  // CTAs a (row, kv head): the cluster size, gridDim.x
};

template <typename T, int D>
__host__ __device__ constexpr int smem_floats(int G, int S) {
  return merge_floats<T, D>(G) + recv_floats(G, D, S);
}

// One cluster per (batch row, kv head); rank blockIdx.x of it takes one run.
// kG >= G bounds the heads a lane holds.
template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(PagedParams p) {
  using Tile = RowTile<T, D>;
  using State = GroupState<T, D, kG>;
  constexpr int kU = State::kU;
  constexpr int kP = Tile::kP;
  constexpr int kNG = Tile::kNG;

  extern __shared__ __align__(16) float smem[];
  const int G = p.Hq / p.Hk;
  float* merge = smem;                                 // merge_floats
  float* recv = merge + merge_floats<T, D>(G);         // recv_floats
  int* pages = reinterpret_cast<int*>(recv + recv_floats(G, D, p.S));  // [kPageBuf]
  if (p.S > 1) cluster_arrive_relaxed();  // matched by the wait before the first push

  const T* kp = static_cast<const T*>(p.k_pool);
  const T* vp = static_cast<const T*>(p.v_pool);
  const int rank = blockIdx.x;  // == the cluster rank: clusters span gridDim.x
  const int b = blockIdx.y;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gi = warp * Tile::kGroups + lane / Tile::kL;  // this lane's group
  const int sub = lane % Tile::kL;                        // its lane in the group
  const size_t q_base = ((size_t)b * p.Hq + (size_t)h * G) * D;  // G consecutive heads

  int start, end, lo, hi;
  attended(p.lens[b], p.window, p.NP * p.ps, start, end);
  run_from_start(start, end, kChunk, p.S, rank, lo, hi);
  const int pb = lo / p.ps;  // first table column of the run
  if (lo < hi) {
    const int n = min(kPageBuf, (hi - 1) / p.ps - pb + 1);
    for (int i = tid; i < n; i += kThreads) pages[i] = p.page_table[(size_t)b * p.NP + pb + i];
  }
  State st;
  st.init(static_cast<const T*>(p.q) + q_base, G, sub, p.scale);
  __syncthreads();  // the page ids

  // group gi takes tokens lo + gi + kNG * j; a warp's first group leads
  const int lead = lo + warp * Tile::kGroups;
  for (int t0 = 0; lead + t0 < hi; t0 += kNG * kU) {
    uint4 kr[kU][kP], vr[kU][kP];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = lo + gi + t0 + u * kNG;
      ok[u] = t < hi;
#pragma unroll
      for (int c = 0; c < kP; ++c) kr[u][c] = vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const int col = t / p.ps;
        const long long page =
            col - pb < kPageBuf ? pages[col - pb] : p.page_table[(size_t)b * p.NP + col];
        const long long e = ((page * p.Hk + h) * p.ps + t % p.ps) * D + sub * Tile::kE;
#pragma unroll
        for (int c = 0; c < kP; ++c) {
          kr[u][c] = *reinterpret_cast<const uint4*>(kp + e + c * Tile::kVec);
          vr[u][c] = *reinterpret_cast<const uint4*>(vp + e + c * Tile::kVec);
        }
      }
    }
    st.update(kr, vr, ok, G);
  }
  finish<T, D, kG>(st, gi, sub, merge, recv, G, p.S, static_cast<T*>(p.o) + q_base);
}

template <typename T, int D, int kG>
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hk;
  const size_t smem = sizeof(float) * smem_floats<T, D>(G, p.S) + sizeof(int) * kPageBuf;
  return launch_split(paged_decode_kernel<T, D, kG>, p, p.S, p.B, p.Hk, smem, stream);
}

template <typename T, int D>
cudaError_t dispatch_g(const PagedParams& p, cudaStream_t stream) {
  return p.Hq / p.Hk <= 4 ? launch<T, D, 4>(p, stream) : launch<T, D, 8>(p, stream);
}

template <typename T>
cudaError_t dispatch_d(const PagedParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return dispatch_g<T, 64>(p, stream);
    case 128: return dispatch_g<T, 128>(p, stream);
    case 256: return dispatch_g<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; splits: CTAs a (row, kv head), 1-16.
// Returns the launch's cudaError_t.
extern "C" int mcl_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                          void* o, const int* page_table, const int* lens, int B,
                                          int Hq, int Hk, int ps, int NP, int D, int dtype,
                                          int window, float scale, int splits, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > kMaxGroup) return (int)cudaErrorInvalidValue;
  PagedParams p{q, k_pool, v_pool, o, page_table, lens, B, Hq, Hk, ps, NP, window, scale, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
