// K4: one-token decode attention against a paged KV pool, block by block,
// with the next block's K/V copied while the current one computes; for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/
// paged_attention_mp_kernel.py:_mp_kernel (with _chunk_copies, pallas_call
// at :233).  Same function as K3 (csrc/paged_attention.cu): for batch row b
// and kv head h the whole GQA group of G = Hq / Hk heads,
//     o[b, hG+g] = softmax_i(q[b, hG+g] . K[i] * scale) V[i]
// over the row's tokens i < lens[b] (and (lens[b] - 1) - i < window when
// window >= 0), read through page_table[b, i / ps] from head-major pools
// [P, Hk, ps, D].  A row with lens[b] == 0 outputs zeros.
//
// Rows are copied in segments of `seg` tokens, a contiguous run inside one
// page of one head (seg == ps: whole pages), `spb` segments a block.  The
// wrapper picks them from the requested pages_per_block and the shared
// memory: two stages of K and V take 4 * spb * seg * D * sizeof(T) bytes,
// so bf16 pages of 16 tokens at D 256 fit 6 pages a block beside the
// cluster merge's receive buffer, fp32 only 3; where one page does not fit
// twice (fp32, 64-token pages, D 256) a page is copied in row ranges
// (seg < ps, spb = 1).  Results differ between schedules only by float32
// summation order.
//
// What bounds it: bytes, as K3 (2 * len * Hk * D elements of K/V per row and
// layer, 4 flops each), and at decode sizes the latency of a row's chain of
// dependent steps.  As K3, each (row, kv head) is split over a thread block
// cluster of S CTAs (csrc/paged_split.cuh; S from the shapes alone); here a
// CTA's run is a whole number of segments at multiples of seg.  Inside its
// run a CTA keeps what sets K4 apart: block c + 1's segments go to shared
// memory with 16-byte cp.async (one commit group per block, the counterpart
// of the TPU's per-block DMA semaphore) while block c computes.  A block is
// computed as K3 computes its tokens, by lane groups that each keep a
// float32 online softmax in registers, reading their rows from the stage;
// masked tokens get probability exactly 0, and segments outside the
// attended range are neither copied nor read.  The groups, then the S CTAs,
// are merged in fixed orders (K3's code).

#include "mma_tiles.cuh"  // cp_async16, cp_async_commit, cp_async_wait
#include "paged_split.cuh"

namespace {

using namespace mcl_paged;

constexpr int kSmemLimit = 232448;

struct MpParams {
  const void* q;          // [B, Hq, D] (the [B, 1, Hq, D] query), 16-byte aligned
  const void* k_pool;     // [P, Hk, ps, D], 16-byte aligned
  const void* v_pool;     // [P, Hk, ps, D], 16-byte aligned
  void* o;                // [B, Hq, D]
  const int* page_table;  // [B, NP]
  const int* lens;        // [B] attendable tokens including the new one
  int B, Hq, Hk, ps, NP;
  int window;
  float scale;
  int seg;  // tokens per copied segment; divides ps
  int spb;  // segments per block
  int S;    // CTAs a (row, kv head): the cluster size, gridDim.x
};

// Shared memory: two stages of K and V for `blk` tokens, overlaid after the
// last block by the CTA merge, then the cluster merge's receive buffer (the
// host mirror is ops/paged_attention_mp_kernel.py:_smem, at S 16)
template <typename T, int D>
__host__ __device__ size_t smem_bytes(int G, int blk, int S) {
  const size_t stages = 4 * (size_t)blk * D * sizeof(T);
  const size_t merge = sizeof(float) * merge_floats<T, D>(G);
  return (stages > merge ? stages : merge) + sizeof(float) * recv_floats(G, D, S);
}

// One cluster per (batch row, kv head); rank blockIdx.x of it takes one run.
// kG >= G bounds the heads a lane holds.
template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads) paged_mp_kernel(MpParams p) {
  using Tile = RowTile<T, D>;
  using State = GroupState<T, D, kG>;
  constexpr int kVec = Tile::kVec;  // elements per 16-byte copy
  constexpr int kU = State::kU;
  constexpr int kP = Tile::kP;
  constexpr int kNG = Tile::kNG;

  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.Hq / p.Hk;
  const int blk = p.seg * p.spb;
  const size_t stage_elems = 2 * (size_t)blk * D;  // K then V of one block
  T* stages = reinterpret_cast<T*>(smem);
  const size_t front = smem_bytes<T, D>(G, blk, 1);  // stages or the merge, whichever is larger
  float* recv = reinterpret_cast<float*>(smem + front);
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
  run_aligned(start, end, p.seg, p.S, rank, lo, hi);  // this CTA's tokens

  // blocks of spb segments from the run's first segment: block c covers
  // tokens [t_blk + c * blk, t_blk + (c + 1) * blk)
  const int t_blk = lo / p.seg * p.seg;
  const int nblk = lo < hi ? (hi - t_blk + blk - 1) / blk : 0;

  // copy block c's attended segments into stage `stage` (one commit group)
  auto issue = [&](int c, int stage) {
    T* kd = stages + stage * stage_elems;
    T* vd = kd + (size_t)blk * D;
    const int vec_per_seg = p.seg * D / kVec;
    for (int idx = tid; idx < p.spb * vec_per_seg; idx += kThreads) {
      const int j = idx / vec_per_seg;
      const int e = idx - j * vec_per_seg;
      const int t0 = t_blk + c * blk + j * p.seg;  // the segment's first token
      if (t0 >= hi || t0 + p.seg <= lo) continue;
      const long long page = p.page_table[(size_t)b * p.NP + t0 / p.ps];
      const long long off = ((page * p.Hk + h) * p.ps + t0 % p.ps) * D + (long long)e * kVec;
      const size_t dst = (size_t)j * p.seg * D + (size_t)e * kVec;
      cp_async16(kd + dst, kp + off);
      cp_async16(vd + dst, vp + off);
    }
    cp_async_commit();
  };

  if (nblk > 0) issue(0, 0);
  State st;
  st.init(static_cast<const T*>(p.q) + q_base, G, sub, p.scale);
  for (int c = 0; c < nblk; ++c) {
    const int stage = c & 1;
    if (c + 1 < nblk)
      issue(c + 1, stage ^ 1);
    else
      cp_async_commit();  // an empty group, so that wait_group 1 always means block c
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = stages + stage * stage_elems;
    const T* vs = ks + (size_t)blk * D;
    const int base = t_blk + c * blk;
    const int b_lo = max(lo, base) - base;  // attended tokens of the block: [b_lo, b_hi)
    const int b_hi = min(hi, base + blk) - base;

    // group gi takes tokens b_lo + gi + kNG * j of the block; a warp's first group leads
    const int lead = b_lo + warp * Tile::kGroups;
    for (int t0 = 0; lead + t0 < b_hi; t0 += kNG * kU) {
      uint4 kr[kU][kP], vr[kU][kP];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = b_lo + gi + t0 + u * kNG;
        ok[u] = t < b_hi;
        const size_t at = (size_t)(ok[u] ? t : b_lo) * D + sub * Tile::kE;
#pragma unroll
        for (int c2 = 0; c2 < kP; ++c2) {
          kr[u][c2] = *reinterpret_cast<const uint4*>(ks + at + c2 * kVec);
          vr[u][c2] = *reinterpret_cast<const uint4*>(vs + at + c2 * kVec);
        }
      }
      st.update(kr, vr, ok, G);
    }
    __syncthreads();  // the stage is refilled two blocks on
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy or reader left in the stages: the merge overlays them
  finish<T, D, kG>(st, gi, sub, reinterpret_cast<float*>(smem), recv, G, p.S,
                   static_cast<T*>(p.o) + q_base);
}

template <typename T, int D, int kG>
cudaError_t launch(const MpParams& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hk;
  const size_t smem = smem_bytes<T, D>(G, p.seg * p.spb, p.S);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  return launch_split(paged_mp_kernel<T, D, kG>, p, p.S, p.B, p.Hk, smem, stream);
}

template <typename T, int D>
cudaError_t dispatch_g(const MpParams& p, cudaStream_t stream) {
  return p.Hq / p.Hk <= 4 ? launch<T, D, 4>(p, stream) : launch<T, D, 8>(p, stream);
}

template <typename T>
cudaError_t dispatch_d(const MpParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return dispatch_g<T, 64>(p, stream);
    case 128: return dispatch_g<T, 128>(p, stream);
    case 256: return dispatch_g<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  seg divides ps; seg < ps only with
// spb == 1; splits: CTAs a (row, kv head), 1-16.  Returns the launch's
// cudaError_t.
extern "C" int mcl_paged_decode_attention_mp(const void* q, const void* k_pool,
                                             const void* v_pool, void* o, const int* page_table,
                                             const int* lens, int B, int Hq, int Hk, int ps,
                                             int NP, int D, int dtype, int window, float scale,
                                             int seg, int spb, int splits, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > kMaxGroup) return (int)cudaErrorInvalidValue;
  if (seg <= 0 || spb <= 0 || ps % seg != 0 || (seg < ps && spb != 1))
    return (int)cudaErrorInvalidValue;
  MpParams p{q,  k_pool, v_pool, o,     page_table, lens, B,   Hq,
             Hk, ps,     NP,     window, scale,     seg,  spb, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, s);
  return (int)cudaErrorInvalidValue;
}
