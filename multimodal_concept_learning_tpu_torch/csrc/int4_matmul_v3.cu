// K5v3a and K5v3b: the two A/B variants of the int4 decode matmul (K5),
// hand-written for Hopper (sm_90a) on K5's design.
//
// Replace the Pallas TPU kernels scripts/bench_int4_kernel.py:_kernel_v3a
// (:49, pallas_call at :89) and _kernel_v3b (:66, pallas_call at :113; its
// activation quantization, XLA code outside the kernel at :108-112, runs
// inside this one).  Both read K5's storage (ops/int4.py): packed int8
// [in/2, out], the low nibble of packed[i, n] holding code[i, n] and the
// high nibble code[i + in/2, n] (sign-extended 4-bit codes -8..7); scale
// bf16 [in/64, out], one scale per group g of 64 input rows.  For x
// [rows, in], float32 or bf16, rows <= 64 (a decode step), out in x's dtype:
//
//   v3a: out[r, n] = sum_g scale[g, n] * fp32(sum_{k in g} bf16(x[r, k]) * code[k, n])
//        the inner sum a bf16 product of the UNSCALED codes (exact in bf16)
//        accumulated in fp32, the group scale applied to each group's sum.
//        (K5 rounds code * scale to bf16 before one product: another
//        rounding, so v3a is held to its own plain version.)
//   v3b: out[r, n] = sum_g (fp32(sum_{k in g} xq[r, k] * code[k, n]) * sx[r, g]) * scale[g, n]
//        sx = max(max_{k in g} |x[r, k]|, 1e-8) / 127 and xq = clip(rint(x / sx),
//        -127, 127) per (row, group), x taken in float32 exactly as given;
//        the inner sum int8 x int8 in int32.  The quantization is bitwise
//        the plain version's (ops/int4.py:quantize_activations_int8): IEEE
//        division results (div_rn), round half to even (rintf); one xq off
//        by one would move the output by more than the float32 limit.
//
// What bounds them: bytes, as K5.  At 8 rows each packed byte feeds 16
// multiply-adds, far below the card's ~295 flops/byte balance (bf16) or
// ~590 (int8); the packed weight must stream from device memory once.
//
// Design: K5's frame (int4_split.cuh): split-K over thread block clusters
// of 1-16 CTAs a stripe of kNC columns (the plan, ops/int4.py:v3_plan,
// from the shapes alone: >= 264 CTAs where the shapes allow), every load of
// a CTA's slice issued by cp.async before the first wait, a fixed-order
// reduction through distributed shared memory under one cluster barrier,
// the cast to x's dtype in the epilogue: one launch a call, two calls give
// the same bits.  What differs from K5:
// - A rank owns whole groups: runs of 64-row blocks of the packed rows
//   (each block is group b in its low nibbles and group b + in/128 in its
//   high nibbles), so a warp's item is (group, nibble half).  It
//   accumulates the group's k-steps in a fresh fragment, then scales that
//   fragment once in float32 (x scale; v3b: x sx x scale, in that order)
//   and adds it to its running sum.
// - v3a: K5's fragments without the scale: ldmatrix.trans gives a lane 2 x
//   2 packed bytes (rows 2t, 2t + 1 of columns 2g, 2g + 1); (nibble ^ 8) |
//   0x4300 is the bf16 128 + code + 8, and one fma.rn.bf16x2 by 1.0 and
//   -136 gives the code exactly; 4 m16n8k16 steps a group.
// - v3b: m16n8k32 s8, 2 steps a group.  A lane's B register must hold 4 k
//   of one column, but a column's packed bytes are out apart.  Bytes are
//   not transposed: the sum over k does not care about order.  One
//   ldmatrix.x4.trans gives a lane rows 2t, 2t + 1 (+ 8, 16, 24) of columns
//   2g, 2g + 1; a byte permute makes [rows 2t, 2t + 1, 2t + 8, 2t + 9] of
//   column 2g (and of 2g + 1), and the x tile is staged in that k-order
//   (slot 4t + i of a 16-deep half holds packed row 2t + (i & 1) + 8 (i >>
//   1)).  The codes come by byte-wise SIMD on 4 bytes at a time:
//   __vsub4(((v >> 4h) & 0x0F0F0F0F) ^ 0x08080808, 0x08080808).
// - v3b quantizes inside the kernel: each CTA stages the raw x columns of
//   its own groups by cp.async (the first commit group, ahead of the
//   packed rows), then 4 lanes a (row, group) take one max by shuffles and
//   write sx and xq (in the k-order above) to shared memory while the
//   packed rows are still in flight.  Redundant across stripes, but x is
//   only rows x in values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_split.cuh"  // staging, cluster reduction, launch; mma_tiles.cuh's primitives

namespace {

constexpr int kGroup = 64;                   // input rows a scale group
constexpr int kGroupUnits = kGroup / kUnit;  // 16-row units a group
// CTAs an SM the registers must allow: 4 (<= 128 registers a thread), so
// that the plan's 432 CTAs at gate/up_proj run in one wave (with 3 an SM,
// ptxas's choice without the bound, up_proj took 1.35x as long); 3 for 2
// row tiles of 32 columns (rows 17-32 only), which spill under 128
__host__ __device__ constexpr int min_blocks(int mt, int nc) { return mt == 2 && nc == 32 ? 3 : 4; }

// c += a . b, m16n8k32, int8 operands, int32 accumulation
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four int8 codes from the low (h 0) or high (h 1) nibbles of 4 packed bytes
__device__ __forceinline__ uint32_t codes4(uint32_t v, int h) {
  return __vsub4(((v >> (4 * h)) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ float bf16_lo(uint32_t s) { return __uint_as_float(s << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t s) { return __uint_as_float(s & 0xFFFF0000u); }

// a / b rounded to float32 exactly as IEEE division (__fdiv_rn) rounds
// it, for normal b and finite a, with no call to a slow path (whose ABI
// would save the live accumulators around it).  The exact quotient of two
// float32 values is never a float32 midpoint, nor within 2^-49 (relative)
// of one: a - b mid is a nonzero multiple of 2^(e_b + e_mid), and b mid has
// at most 49 significant bits.  So any approximation closer than that
// rounds to the same float32: here a double quotient by b's reciprocal
// (refined once for all of a group's values) and one residual correction,
// within ~2^-52.
struct Divisor {
  double b, r;  // b and 1/b to double precision
};

__device__ __forceinline__ Divisor divisor(float b) {
  const double bd = b;
  double r = __fdividef(1.f, b);  // within 2 ulp of float32
  r = fma(r, fma(-bd, r, 1.0), r);
  r = fma(r, fma(-bd, r, 1.0), r);
  return {bd, r};
}

__device__ __forceinline__ float div_rn(float a, const Divisor& d) {
  const double ad = a, q = ad * d.r;
  return __double2float_rn(fma(fma(-d.b, q, ad), d.r, q));
}

// ldmatrix on 32-bit shared-memory addresses: the item loops keep their
// tile bases as such (fewer registers than generic pointers)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// n-tiles of one 16-column block (one for an 8-column stripe)
template <int kNC>
constexpr int kBlockTiles = kNC == 8 ? 1 : 2;

// acc += the fresh fragments part of block blk, each times its row factor
// rs[m][hh] (rows 16m + g + 8hh) and then its column's scale from the
// item's scale row at shared address sc.  For kNC >= 16 n-tile 2 blk (even columns) and
// 2 blk + 1 (odd ones) hold columns 16 blk + 4t + {0, 2} and + {1, 3}; for
// kNC 8 the n-tile holds columns 2t and 2t + 1.
template <int kMT, int kNC, typename T>
__device__ __forceinline__ void add_scaled(float (&acc)[kMT][kNC / 8][4],
                                           const T (&part)[kMT][kBlockTiles<kNC>][4],
                                           const float (&rs)[kMT][2], uint32_t sc, int blk) {
  const int t = threadIdx.x % 4;
  if constexpr (kNC == 8) {
    const uint32_t s = lds32(sc + 4 * t);
    const float s0 = bf16_lo(s), s1 = bf16_hi(s);
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      acc[m][0][0] += ((float)part[m][0][0] * rs[m][0]) * s0;
      acc[m][0][1] += ((float)part[m][0][1] * rs[m][0]) * s1;
      acc[m][0][2] += ((float)part[m][0][2] * rs[m][1]) * s0;
      acc[m][0][3] += ((float)part[m][0][3] * rs[m][1]) * s1;
    }
  } else {
    const uint2 s = lds64(sc + 32 * blk + 8 * t);
    const float c0 = bf16_lo(s.x), c1 = bf16_hi(s.x), c2 = bf16_lo(s.y), c3 = bf16_hi(s.y);
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float r = rs[m][hh];
        acc[m][2 * blk][2 * hh] += ((float)part[m][0][2 * hh] * r) * c0;
        acc[m][2 * blk][2 * hh + 1] += ((float)part[m][0][2 * hh + 1] * r) * c2;
        acc[m][2 * blk + 1][2 * hh] += ((float)part[m][1][2 * hh] * r) * c1;
        acc[m][2 * blk + 1][2 * hh + 1] += ((float)part[m][1][2 * hh + 1] * r) * c3;
      }
    }
  }
}

// This rank's units [ub, ue): whole groups, rank q of cs taking groups
// [q G / cs, (q + 1) G / cs) of the G = in/128 groups a half.
__device__ __forceinline__ int2 rank_units(const Int4Params& p, int rank, int cs) {
  const int groups = p.d_in / 2 / kGroup;
  return make_int2(rank * groups / cs * kGroupUnits, (rank + 1) * groups / cs * kGroupUnits);
}

template <int kMT, int kNC>
__global__ void __launch_bounds__(kThreads, min_blocks(kMT, kNC)) v3a_tc_kernel(Int4Params p, int cs, int stage_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNT = kNC / 8;
  constexpr int kLdP = packed_stride(kNC);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = blockIdx.x / cs * kNC;
  const int xrows = 16 * kMT;
  const int2 run = rank_units(p, rank, cs);
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  float rs[kMT][2];  // v3a has no row factor: x 1.0 is exact
#pragma unroll
  for (int m = 0; m < kMT; ++m) rs[m][0] = rs[m][1] = 1.f;

  for (int c0 = run.x; c0 < run.y; c0 += kChunkUnits) {
    const int nu = min(kChunkUnits, run.y - c0);
    const int ldx = nu * kUnit + 8;
    const Chunk ch = chunk_layout<kNC>(smem, p, c0, nu);
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(ch.rest);  // [2][xrows][ldx]
    __syncthreads();  // the previous chunk's readers are done
    stage_packed_scale<kNC>(ch, p, n0, c0, nu);
    stage_x_bf16<kMT>(Xs, p, c0, nu);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // items (group, nibble half), warp-strided; a 16-column block at a time.
    // The tiles by 32-bit shared addresses: the item's scale row is row
    // h (nu + 1) + gi of Ss (chunk_layout: group gi of the chunk's half h).
    const uint32_t xs = smem_addr(Xs), ps = smem_addr(ch.Ps), ss = smem_addr(ch.Ss);
    for (int it = warp; it < 2 * (nu / kGroupUnits); it += kWarps) {
      const int gi = it / 2, h = it % 2, sh = 4 * h;
      const uint32_t sc = ss + 2 * (h * (nu + 1) + gi) * kNC;
      // the group's x columns (lane row lane % 16, 8 (lane / 16) on) and
      // packed rows (lane row lane % 16)
      const uint32_t xa = xs + 2 * ((h * xrows + lane % 16) * ldx + gi * kGroup + 8 * (lane / 16));
      const uint32_t pb = ps + (gi * kGroup + lane % 16) * kLdP;
#pragma unroll
      for (int blk = 0; blk < kNC / 8 / kBlockTiles<kNC>; ++blk) {
        float part[kMT][kBlockTiles<kNC>][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int j = 0; j < kBlockTiles<kNC>; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
        for (int uu = 0; uu < kGroupUnits; ++uu) {
          const int u = gi * kGroupUnits + uu;
          uint32_t a[kMT][4];
#pragma unroll
          for (int m = 0; m < kMT; ++m) ldsm_x4(a[m], xa + 2 * (16 * m * ldx + uu * kUnit));
          if constexpr (kNC == 8) {
            // lane (g, t): column g, rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)
            const uint8_t* pc = smem + u * kUnit * kLdP + g;  // ch.Ps
            const uint32_t r0 =
                (uint32_t)pc[(2 * t) * kLdP] | ((uint32_t)pc[(2 * t + 1) * kLdP] << 16);
            const uint32_t r1 =
                (uint32_t)pc[(2 * t + 8) * kLdP] | ((uint32_t)pc[(2 * t + 9) * kLdP] << 16);
            const uint32_t b[2] = {code2(r0 ^ 0x88888888u, sh), code2(r1 ^ 0x88888888u, sh)};
#pragma unroll
            for (int m = 0; m < kMT; ++m) mma_bf16(part[m][0], a[m], b);
          } else {
            // ldmatrix.trans gives lane (g, t) the bytes of rows 2t, 2t + 1
            // (+ 8) at the block's columns 2g, 2g + 1
            uint32_t r[2];
            ldsm_x2_trans(r, pb + uu * kUnit * kLdP + 16 * blk);
            const uint32_t x0 = r[0] ^ 0x88888888u, x1 = r[1] ^ 0x88888888u;
            const uint32_t be[2] = {code2(x0, sh), code2(x1, sh)};
            const uint32_t bo[2] = {code2(x0, sh + 8), code2(x1, sh + 8)};
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              mma_bf16(part[m][0], a[m], be);
              mma_bf16(part[m][1], a[m], bo);
            }
          }
        }
        add_scaled<kMT, kNC>(acc, part, rs, sc, blk);
      }
    }
  }
  cluster_reduce_store<kMT, kNC>(acc, smem, stage_cap, rank, cs, p, n0);
}

// v3b's staging of a chunk of nu units after the packed and scale rows:
// the raw x columns Xr [2][16 mt][nu 16] (float32-sized), then xq Xq
// [2][16 mt][nu 16 + 16] int8 in the k-order of the B fragments, then sx
// Sx [2][nu / 4][16 mt] float32 (the host mirror is ops/int4.py:v3_smem_bytes)
__host__ __device__ constexpr int v3b_stage_bytes(int mt, int nc, int units) {
  return units * kUnit * packed_stride(nc) + 2 * (units + 1) * nc * 2 +
         2 * 16 * mt * units * kUnit * 4 + 2 * 16 * mt * (units * kUnit + 16) +
         2 * (units / kGroupUnits) * 16 * mt * 4;
}

// the slot of packed row p (0..31 within a 32-deep k-step) in the k-order
// of the s8 fragments: slot 4t + i of each 16-deep half holds row 2t +
// (i & 1) + 8 (i >> 1)
__host__ __device__ constexpr int s8_slot(int p) {
  return (p & 16) + 4 * ((p & 7) >> 1) + (p & 1) + 2 * ((p >> 3) & 1);
}

template <int kMT, int kNC>
__global__ void __launch_bounds__(kThreads, min_blocks(kMT, kNC)) v3b_tc_kernel(Int4Params p, int cs, int stage_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNT = kNC / 8;
  constexpr int kLdP = packed_stride(kNC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = blockIdx.x / cs * kNC;
  const int half = p.d_in / 2;
  const int xrows = 16 * kMT;
  const int esize = p.x_bf16 ? 2 : 4;
  const int2 run = rank_units(p, rank, cs);
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int c0 = run.x; c0 < run.y; c0 += kChunkUnits) {
    const int nu = min(kChunkUnits, run.y - c0);
    const int ng = nu / kGroupUnits;  // groups a half in this chunk
    const int klen = nu * kUnit, ldq = klen + 16;
    const Chunk ch = chunk_layout<kNC>(smem, p, c0, nu);
    unsigned char* Xr = ch.rest;                           // [2][xrows][klen], x's dtype
    int8_t* Xq = reinterpret_cast<int8_t*>(Xr + 2 * xrows * klen * 4);  // [2][xrows][ldq]
    float* Sx = reinterpret_cast<float*>(Xq + 2 * xrows * ldq);        // [2][ng][xrows]
    __syncthreads();  // the previous chunk's readers are done
    // commit group 1: the raw x columns of both halves (rows < p.rows)
    {
      const int kc = klen * esize / 16;  // 16-byte chunks a row and half
      const unsigned char* x = static_cast<const unsigned char*>(p.x);
      for (int i = tid; i < 2 * p.rows * kc; i += kThreads) {
        const int h = i / (p.rows * kc), rem = i % (p.rows * kc), r = rem / kc;
        const int c = (rem % kc) * 16;  // bytes
        cp_async16(Xr + (size_t)(h * xrows + r) * klen * esize + c,
                   x + ((size_t)r * p.d_in + h * half + c0 * kUnit) * esize + c);
      }
    }
    cp_async_commit();
    // commit group 2: the packed rows and scale rows
    stage_packed_scale<kNC>(ch, p, n0, c0, nu);
    cp_async_commit();
    // x rows past p.rows: xq and sx zero
    for (int i = tid; i < 2 * (xrows - p.rows) * (ldq / 16); i += kThreads) {
      const int h = i / ((xrows - p.rows) * (ldq / 16)), rem = i % ((xrows - p.rows) * (ldq / 16));
      const int r = p.rows + rem / (ldq / 16), c = (rem % (ldq / 16)) * 16;
      *reinterpret_cast<uint4*>(Xq + (h * xrows + r) * ldq + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < 2 * ng * (xrows - p.rows); i += kThreads) {
      const int hg = i / (xrows - p.rows), r = p.rows + i % (xrows - p.rows);
      Sx[hg * xrows + r] = 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    // quantize: 4 lanes a (half, row, group), 16 consecutive k a lane, 32
    // groups a pass (each pass one chain of dependent steps a thread)
    {
      const int pairs = 2 * p.rows * ng, l4 = lane % 4;
      for (int base = 0; base < pairs; base += 8 * kWarps) {
        const int pr = base + 8 * warp + lane / 4;
        const bool ok = pr < pairs;
        const int h = ok ? pr / (p.rows * ng) : 0, r = ok ? pr / ng % p.rows : 0, gi = pr % ng;
        float v[16];
        const size_t at = (size_t)(h * xrows + r) * klen + gi * kGroup + 16 * l4;  // elements
        if (!ok) {
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = 0.f;
        } else if (p.x_bf16) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint4 w = *reinterpret_cast<const uint4*>(Xr + at * 2 + 16 * c);
            const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              v[8 * c + 2 * i] = bf16_lo(ws[i]);
              v[8 * c + 2 * i + 1] = bf16_hi(ws[i]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(Xr + at * 4 + 16 * c);
            v[4 * c] = a.x, v[4 * c + 1] = a.y, v[4 * c + 2] = a.z, v[4 * c + 3] = a.w;
          }
        }
        float mx = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) mx = fmaxf(mx, fabsf(v[i]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (ok) {
          const float sx = div_rn(fmaxf(mx, 1e-8f), Divisor{127.0, 1.0 / 127.0});
          const Divisor d = divisor(sx);
          // group-relative rows 16 l4 + i: 32-deep step l4 / 2, slots s8_slot
          int8_t* dst = Xq + (h * xrows + r) * ldq + gi * kGroup + 32 * (l4 / 2);
          const int p0 = 16 * (l4 % 2);
          // four values at a time: more quotient chains in flight hold too
          // many registers beside the live accumulators (spills at 1 x 64)
#pragma unroll 2
          for (int i = 0; i < 16; i += 2) {
            const float q0 = fminf(fmaxf(rintf(div_rn(v[i], d)), -127.f), 127.f);
            const float q1 = fminf(fmaxf(rintf(div_rn(v[i + 1], d)), -127.f), 127.f);
            // rows p0 + i, p0 + i + 1 sit in neighbouring slots
            *reinterpret_cast<uint16_t*>(dst + s8_slot(p0 + i)) =
                (uint16_t)(((int)q0 & 0xFF) | (((int)q1 & 0xFF) << 8));
          }
          if (l4 == 0) Sx[(h * ng + gi) * xrows + r] = sx;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // items (group, nibble half), warp-strided: 2 m16n8k32 steps each, a
    // 16-column block at a time; the tiles by 32-bit shared addresses, as v3a's
    const uint32_t xqs = smem_addr(Xq), ps = smem_addr(ch.Ps), ss = smem_addr(ch.Ss);
    const uint32_t sxs = smem_addr(Sx);
    for (int it = warp; it < 2 * ng; it += kWarps) {
      const int gi = it / 2, h = it % 2;
      const uint32_t sc = ss + 2 * (h * (nu + 1) + gi) * kNC;
      float rs[kMT][2];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const uint32_t at = sxs + 4 * ((h * ng + gi) * xrows + 16 * m + g);
        rs[m][0] = __uint_as_float(lds32(at));
        rs[m][1] = __uint_as_float(lds32(at + 32));
      }
      // the group's xq (lane row lane % 16, bytes 16 (lane / 16) on) and
      // packed rows (lane row lane: matrix lane / 8 of the x4.trans)
      const uint32_t qa = xqs + (h * xrows + lane % 16) * ldq + gi * kGroup + 16 * (lane / 16);
      const uint32_t pb = ps + (gi * kGroup + lane) * kLdP;
#pragma unroll
      for (int blk = 0; blk < kNC / 8 / kBlockTiles<kNC>; ++blk) {
        int part[kMT][kBlockTiles<kNC>][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int j = 0; j < kBlockTiles<kNC>; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][j][e] = 0;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k0 = gi * kGroup + 32 * kk;  // chunk-relative first packed row
          uint32_t a[kMT][4];
#pragma unroll
          for (int m = 0; m < kMT; ++m) ldsm_x4(a[m], qa + 16 * m * ldq + 32 * kk);
          if constexpr (kNC == 8) {
            // lane (g, t): column g, rows 2t, 2t + 1, 2t + 8, 2t + 9 (b0) and + 16 (b1)
            const uint8_t* pc = smem + k0 * kLdP + g;  // ch.Ps
            uint32_t w[2];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const uint8_t* pr = pc + (16 * s + 2 * t) * kLdP;
              w[s] = (uint32_t)pr[0] | ((uint32_t)pr[kLdP] << 8) |
                     ((uint32_t)pr[8 * kLdP] << 16) | ((uint32_t)pr[9 * kLdP] << 24);
            }
            const uint32_t b[2] = {codes4(w[0], h), codes4(w[1], h)};
#pragma unroll
            for (int m = 0; m < kMT; ++m) mma_s8(part[m][0], a[m], b);
          } else {
            // matrix j of the x4.trans holds rows 8j .. 8j + 7; lane (g, t)
            // gets rows 8j + 2t, + 1 of the block's columns 2g, 2g + 1
            uint32_t q[4];
            ldsm_x4_trans(q, pb + 32 * kk * kLdP + 16 * blk);
            const uint32_t be[2] = {codes4(__byte_perm(q[0], q[1], 0x6420), h),
                                    codes4(__byte_perm(q[2], q[3], 0x6420), h)};
            const uint32_t bo[2] = {codes4(__byte_perm(q[0], q[1], 0x7531), h),
                                    codes4(__byte_perm(q[2], q[3], 0x7531), h)};
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              mma_s8(part[m][0], a[m], be);
              mma_s8(part[m][1], a[m], bo);
            }
          }
        }
        add_scaled<kMT, kNC>(acc, part, rs, sc, blk);
      }
    }
  }
  cluster_reduce_store<kMT, kNC>(acc, smem, stage_cap, rank, cs, p, n0);
}

int chunk_units(const Int4Params& p, int cs) {
  const int groups = p.d_in / 2 / kGroup;
  const int per = (groups + cs - 1) / cs * kGroupUnits;
  return per < kChunkUnits ? per : kChunkUnits;
}

template <int kMT, int kNC>
struct LaunchV3a {
  static cudaError_t run(const Int4Params& p, int cs, cudaStream_t stream) {
    const int st =
        (max(stage_bytes(kMT, kNC, chunk_units(p, cs)), red_bytes(kMT, kNC)) + 15) / 16 * 16;
    return launch_clustered<kMT, kNC>(v3a_tc_kernel<kMT, kNC>, p, cs, st, stream);
  }
};

template <int kMT, int kNC>
struct LaunchV3b {
  static cudaError_t run(const Int4Params& p, int cs, cudaStream_t stream) {
    const int st =
        (max(v3b_stage_bytes(kMT, kNC, chunk_units(p, cs)), red_bytes(kMT, kNC)) + 15) / 16 * 16;
    return launch_clustered<kMT, kNC>(v3b_tc_kernel<kMT, kNC>, p, cs, st, stream);
  }
};

// The shapes both variants take: rows <= 64, group 64, d_in % 128 == 0,
// d_out % 16 == 0, a cluster of 1, 2, 4, 8 or 16 CTAs with at least one
// group a half each.
bool bad_shape(int rows, int d_in, int d_out, int group, int x_dtype, int cs) {
  return rows < 0 || rows > 64 || group != kGroup || d_in <= 0 || d_in % (2 * kGroup) != 0 ||
         d_out <= 0 || d_out % 16 != 0 || x_dtype < 0 || x_dtype > 1 || cs < 1 ||
         cs > kMaxCluster || (cs & (cs - 1)) != 0 || cs > d_in / (2 * kGroup);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; out [rows, d_out] in x's dtype.  nc
// (8, 16, 32, 64; nc * tiles of 16 rows <= 64) and cs are the plan of
// ops/int4.py:v3_plan.  Needs 16-byte aligned x, packed and scale (the
// shapes: bad_shape).  Returns the launch's cudaError_t.
extern "C" int mcl_int4_matmul_v3a(const void* x, const void* packed, const void* scale, void* out,
                                   int rows, int d_in, int d_out, int group, int x_dtype, int nc,
                                   int cs, void* stream) {
  if (bad_shape(rows, d_in, d_out, group, x_dtype, cs)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Int4Params p{x,   static_cast<const int8_t*>(packed),
                     static_cast<const __nv_bfloat16*>(scale),
                     out, rows, d_in, d_out, group, x_dtype, x_dtype};
  return (int)dispatch_shape<LaunchV3a>(p, nc, cs, static_cast<cudaStream_t>(stream));
}

// As mcl_int4_matmul_v3a; x is quantized to int8 per (row, group) inside
// the kernel.
extern "C" int mcl_int4_matmul_v3b(const void* x, const void* packed, const void* scale, void* out,
                                   int rows, int d_in, int d_out, int group, int x_dtype, int nc,
                                   int cs, void* stream) {
  if (bad_shape(rows, d_in, d_out, group, x_dtype, cs)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Int4Params p{x,   static_cast<const int8_t*>(packed),
                     static_cast<const __nv_bfloat16*>(scale),
                     out, rows, d_in, d_out, group, x_dtype, x_dtype};
  return (int)dispatch_shape<LaunchV3b>(p, nc, cs, static_cast<cudaStream_t>(stream));
}
