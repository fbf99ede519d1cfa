// K5: decode-shaped matrix product against int4 weights, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/int4.py:
// _kernel (via _int4_matmul_kernel, pallas_call at :145).  It computes
//     out[r, n] = sum_k bf16(x[r, k]) * bf16(code[k, n] * scale[k / group, n])
// in float32, for x [rows, in] (float32 or bf16, rows <= 64 on the decode
// path) and the packed layout of ops/int4.py: packed int8 [in/2, out], the
// low nibble of packed[i, n] holding code[i, n] and the high nibble
// code[i + in/2, n] (sign-extended 4-bit codes); scale bf16 [in/group, out].
// The dequantized weight is the 4-bit code times the bf16 scale, exact
// before its one rounding to bf16: the same bf16 weight as both JAX paths.
// The float32 sums are written as float32, or rounded once to bf16 (the
// wrapper's cast of the result to x's dtype, done in the epilogue).
//
// What bounds it: bytes.  At 8 rows each packed byte feeds 32 flops, far
// below the card's ~295 flops/byte balance, so the packed weight has to
// stream from device memory once at the full rate (4.2 MB: 1.3 us for
// gate/up_proj) and everything else stays on the SM.  The first version
// walked all in/2 packed rows in one CTA per 64-column stripe (4 to 108
// CTAs on gemma3-1b's shapes, one an SM) with few loads in flight, so its
// time followed that walk, not the bytes.  This design:
//
// - Split-K in thread block clusters, so every shape fills the card.  A
//   CTA owns kNC output columns (64, 32, 16 or 8) and a run of 16-row units
//   of the packed rows (each unit feeds one 16-deep mma step from its low
//   nibbles and one from its high nibbles); the CTAs of one stripe form a
//   cluster of 1-16 that splits the units evenly.  The wrapper's plan
//   (ops/int4.py:k5_plan) picks the widest stripe and smallest cluster
//   giving >= 264 CTAs (2 an SM) with <= 16 units (256 packed rows) a CTA:
//   gemma3-1b's q/k/v/o/gate/up/down at 8 rows launch 512/512/512/288/
//   432/432/288 CTAs.
// - Every load of a CTA's slice in flight at once: its packed rows, the
//   scale rows they need and the x columns go to shared memory by 16-byte
//   cp.async (8-byte for 8-column stripes), all issued before the first
//   wait; x in float32 is rounded to bf16 on the way (plain loads).
// - The product on the tensor cores: mma.sync m16n8k16 bf16 with fp32
//   accumulation, x padded to 16-row tiles.  A warp takes (unit, nibble
//   half) items; ldmatrix.trans reads 2 x 2 packed bytes a lane (rows 2t,
//   2t + 1 of two neighbouring columns), and the B fragments are made in
//   registers: (nibble ^ 8) | 0x4300 is the bf16 128 + code + 8, minus 136
//   (exact) is the code, times the scale pair (fma.rn.bf16x2, one
//   rounding) is the weight.  Each ldmatrix's even and odd columns make two
//   n-tiles, so a lane's C fragments hold 4 neighbouring columns.
// - A deterministic reduction, no atomics, one cluster barrier: the 4
//   warps' partial sums are added in warp order in shared memory, then each
//   CTA stores its sums into the receive buffer of the rank that owns them
//   (distributed shared memory, 16-byte stores, a slot per rank); after the
//   barrier each rank adds its elements' slots in rank order.  Two calls
//   give the same bits.
// Chunks of more than 16 units (in > 512 with one CTA a stripe; not a
// gemma3 shape) are staged one after another without overlap.  The
// staging, the reduction and the launch are int4_split.cuh's, which the
// variants K5v3a and K5v3b (int4_matmul_v3.cu) share.
//
// What holds it back (patched copies of this source timed on an H100, bf16,
// weights cold): a fixed ~5 us a launch at the small shapes (an empty
// launch of the same grid 1.5 us, the loads' round trip 1.4 us, the
// reduction and its cluster barrier the rest), and at gate/up/down a load
// phase near 1.3 TB/s with 64-byte pieces of each packed row.  Fewer,
// wider CTAs measured faster (gate/up 9.1 us as 216 CTAs of 128 columns
// against 9.8 as 432 of 64; q_proj 5.25 us as 128 CTAs against 5.5 as 512)
// but break the 2-CTAs-an-SM rule the plan keeps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_split.cuh"  // staging, cluster reduction, launch; mma_tiles.cuh's primitives

namespace {

// Two weights as a bf16 pair: the codes of code2 (int4_split.cuh) times the
// scale pair s2 (+ -0.0), rounded once, as JAX's code * scale.
__device__ __forceinline__ uint32_t dequant2(uint32_t xr, int sh, uint32_t s2) {
  return fma_bf16x2(code2(xr, sh), s2, 0x80008000u);
}

__device__ __forceinline__ uint32_t lo_pair(uint32_t s) { return (s & 0xFFFFu) * 0x10001u; }
__device__ __forceinline__ uint32_t hi_pair(uint32_t s) { return (s >> 16) * 0x10001u; }

// One CTA: columns [n0, n0 + kNC) over units [ub, ue) of the packed rows,
// its cluster's sum written by rank slices.  kMT: 16-row tiles of x.
template <int kMT, int kNC>
__global__ void __launch_bounds__(kThreads) int4_tc_kernel(Int4Params p, int cs, int stage_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNT = kNC / 8;  // n-tiles
  constexpr int kLdP = packed_stride(kNC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int stripe = blockIdx.x / cs;
  const int n0 = stripe * kNC;
  const int half = p.d_in / 2;
  const int units = half / kUnit;
  const int ub = (int)((long long)rank * units / cs), ue = (int)((long long)(rank + 1) * units / cs);
  const int xrows = 16 * kMT;
  // the cluster's CTAs must all run before one writes another's shared
  // memory: arrive now, wait just before the first remote store
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int c0 = ub; c0 < ue; c0 += kChunkUnits) {
    const int nu = min(kChunkUnits, ue - c0);
    const int ldx = nu * kUnit + 8;  // x tile row stride, elements
    const Chunk ch = chunk_layout<kNC>(smem, p, c0, nu);
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(ch.rest);  // [2][xrows][ldx]
    __syncthreads();  // the previous chunk's readers are done
    stage_packed_scale<kNC>(ch, p, n0, c0, nu);
    stage_x_bf16<kMT>(Xs, p, c0, nu);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // items (unit, nibble half), warp-strided
    for (int it = warp; it < 2 * nu; it += kWarps) {
      const int u = it / 2, h = it % 2;
      const int srow = (c0 + u) * kUnit + h * half;  // the item's first k
      const __nv_bfloat16* sc = scale_row<kNC>(ch, p, nu, h, srow);
      uint32_t a[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        ldmatrix_x4(a[m], Xs + (h * xrows + 16 * m + lane % 16) * ldx + u * kUnit + 8 * (lane / 16));
      const uint8_t* pt = ch.Ps + u * kUnit * kLdP;
      if constexpr (kNC == 8) {
        // lane (g, t): column g, rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)
        const uint8_t* pc = pt + g;
        const uint32_t r0 = (uint32_t)pc[(2 * t) * kLdP] | ((uint32_t)pc[(2 * t + 1) * kLdP] << 16);
        const uint32_t r1 =
            (uint32_t)pc[(2 * t + 8) * kLdP] | ((uint32_t)pc[(2 * t + 9) * kLdP] << 16);
        const uint32_t s2 = (uint32_t)reinterpret_cast<const uint16_t*>(sc)[g] * 0x10001u;
        const int sh = 4 * h;
        const uint32_t b[2] = {dequant2(r0 ^ 0x88888888u, sh, s2), dequant2(r1 ^ 0x88888888u, sh, s2)};
#pragma unroll
        for (int m = 0; m < kMT; ++m) mma_bf16(acc[m][0], a[m], b);
      } else {
        // 16 columns a block: ldmatrix.trans gives lane (g, t) the bytes of
        // rows 2t, 2t + 1 (+ 8) at columns 2g, 2g + 1; even columns make
        // n-tile 2 blk, odd ones 2 blk + 1
        constexpr int kBlocks = kNC / 16;
        uint32_t r[kBlocks][2];
        if constexpr (kNC == 16) {
          ldmatrix_x2_trans(r[0], pt + (lane % 16) * kLdP);
        } else {
#pragma unroll
          for (int j = 0; j < kNC / 32; ++j) {
            uint32_t q[4];
            ldmatrix_x4_trans(q, pt + (lane % 8 + 8 * ((lane / 8) % 2)) * kLdP + 32 * j +
                                     16 * (lane / 16));
            r[2 * j][0] = q[0];
            r[2 * j][1] = q[1];
            r[2 * j + 1][0] = q[2];
            r[2 * j + 1][1] = q[3];
          }
        }
        const int sh = 4 * h;
#pragma unroll
        for (int blk = 0; blk < kBlocks; ++blk) {
          const uint32_t s = *reinterpret_cast<const uint32_t*>(sc + 16 * blk + 2 * g);
          const uint32_t x0 = r[blk][0] ^ 0x88888888u, x1 = r[blk][1] ^ 0x88888888u;
          const uint32_t be[2] = {dequant2(x0, sh, lo_pair(s)), dequant2(x1, sh, lo_pair(s))};
          const uint32_t bo[2] = {dequant2(x0, sh + 8, hi_pair(s)),
                                  dequant2(x1, sh + 8, hi_pair(s))};
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_bf16(acc[m][2 * blk], a[m], be);
            mma_bf16(acc[m][2 * blk + 1], a[m], bo);
          }
        }
      }
    }
  }
  cluster_reduce_store<kMT, kNC>(acc, smem, stage_cap, rank, cs, p, n0);
}

template <int kMT, int kNC>
struct Launch {
  static cudaError_t run(const Int4Params& p, int cs, cudaStream_t stream) {
    const int units = p.d_in / 2 / kUnit;
    const int per = (units + cs - 1) / cs;
    const int chunk = per < kChunkUnits ? per : kChunkUnits;
    const int st = (max(stage_bytes(kMT, kNC, chunk), red_bytes(kMT, kNC)) + 15) / 16 * 16;
    return launch_clustered<kMT, kNC>(int4_tc_kernel<kMT, kNC>, p, cs, st, stream);
  }
};

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; out_dtype: 0 = float32, 1 = bfloat16
// [rows, d_out].  nc (8, 16, 32, 64; nc * tiles of 16 rows <= 64) and cs
// (1, 2, 4, 8, 16 <= in/32) are the plan of ops/int4.py:k5_plan.  Needs
// rows <= 64, group % 16 == 0, d_in % (2 * group) == 0, d_out % 16 == 0,
// 16-byte aligned x, packed and scale.  Returns the launch's cudaError_t.
extern "C" int mcl_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                               int rows, int d_in, int d_out, int group, int x_dtype,
                               int out_dtype, int nc, int cs, void* stream) {
  if (rows < 0 || rows > 64 || group <= 0 || group % kUnit != 0 || d_in % (2 * group) != 0 ||
      d_out <= 0 || d_out % 16 != 0 || x_dtype < 0 || x_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0 || cs > d_in / 32)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Int4Params p{x,     static_cast<const int8_t*>(packed),
                     static_cast<const __nv_bfloat16*>(scale),
                     out,   rows, d_in, d_out, group, x_dtype, out_dtype};
  return (int)dispatch_shape<Launch>(p, nc, cs, static_cast<cudaStream_t>(stream));
}
