// The split-K frame of the int4 decode products (sm_90a): K5
// (int4_matmul.cu) and its A/B variants K5v3a and K5v3b
// (int4_matmul_v3.cu) share it.
//
// Storage (ops/int4.py): packed int8 [in/2, out], the low nibble of
// packed[i, n] holding code[i, n] and the high nibble code[i + in/2, n]
// (sign-extended 4-bit codes); scale bf16 [in/group, out].  x [rows, in],
// rows <= 64, float32 or bf16; out [rows, out] float32 or bf16.
//
// A CTA of 128 threads owns kNC output columns (64, 32, 16 or 8) and a run
// of 16-row units of the packed rows (each unit feeds one 16-deep k-step
// from its low nibbles and one from its high nibbles); the CTAs of one
// stripe form a thread block cluster of 1-16 that splits the units.  What
// is shared:
// - the staging of a chunk of units: its packed rows, the scale rows they
//   need (both halves) and, for the bf16 products, the x columns of both
//   halves rounded to bf16, all by cp.async issued before the first wait
//   (x in float32 by plain loads, rounded on the way);
// - the reduction: the 4 warps' float32 sums (C fragments of m16n8 tiles;
//   for kNC >= 16 n-tile 2 blk holds the even columns of the 16-column
//   block blk and n-tile 2 blk + 1 the odd ones, as ldmatrix.trans of the
//   packed bytes gives them) are added in warp order in shared memory,
//   each CTA pushes 16-byte slices to their owner ranks through
//   distributed shared memory, and after one cluster barrier each owner
//   adds its slots in rank order and writes its elements once, rounded to
//   the output dtype.  No atomics: two calls give the same bits;
// - the clustered launch (cudaLaunchKernelEx with a cluster attribute).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"  // ldmatrix_x4(_trans), pack_bf16, cp_async16_or_zero, commit/wait

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 16;        // packed rows a unit (one mma k-step a nibble half)
constexpr int kChunkUnits = 16;  // units staged at once
constexpr int kMaxCluster = 16;

// packed tile row stride, bytes: ldmatrix rows 16 bytes apart modulo 128
__host__ __device__ constexpr int packed_stride(int nc) { return nc <= 16 ? nc : nc + 16; }

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two codes as a bf16 pair: the nibbles at bits sh..sh+3 and 16+sh.. of xr
// (packed bytes with every nibble's top bit flipped: code + 8).  0x4300 | u
// is the bf16 128 + u; x 1.0 + -136 (exact) is the code.
__device__ __forceinline__ uint32_t code2(uint32_t xr, int sh) {
  const uint32_t u = ((xr >> sh) & 0x000F000Fu) | 0x43004300u;
  return fma_bf16x2(u, 0x3F803F80u, 0xC308C308u);
}

struct Int4Params {
  const void* x;
  const int8_t* packed;
  const __nv_bfloat16* scale;
  void* out;
  int rows, d_in, d_out, group, x_bf16, out_bf16;
};

// One staged chunk of units [c0, c0 + nu): the packed rows Ps [nu 16][ldp],
// the scale rows Ss of the low half's groups g_lo .. (n_lo rows) then, from
// row nu + 1, the high half's g_hi .. (n_hi rows), and the shared memory
// that follows them (bf16 x columns, or a variant's own staging).
struct Chunk {
  uint8_t* Ps;
  __nv_bfloat16* Ss;
  unsigned char* rest;
  int g_lo, g_hi, n_lo, n_hi;
};

template <int kNC>
__device__ __forceinline__ Chunk chunk_layout(unsigned char* smem, const Int4Params& p, int c0,
                                              int nu) {
  constexpr int kLdP = packed_stride(kNC);
  const int half = p.d_in / 2;
  Chunk ch;
  ch.Ps = smem;
  ch.Ss = reinterpret_cast<__nv_bfloat16*>(ch.Ps + nu * kUnit * kLdP);
  ch.rest = reinterpret_cast<unsigned char*>(ch.Ss + 2 * (nu + 1) * kNC);
  ch.g_lo = c0 * kUnit / p.group;
  ch.g_hi = (half + c0 * kUnit) / p.group;
  ch.n_lo = ((c0 + nu) * kUnit - 1) / p.group - ch.g_lo + 1;
  ch.n_hi = (half + (c0 + nu) * kUnit - 1) / p.group - ch.g_hi + 1;
  return ch;
}

// The scale row of the item whose first k is srow (the item lies in one group).
template <int kNC>
__device__ __forceinline__ const __nv_bfloat16* scale_row(const Chunk& ch, const Int4Params& p,
                                                          int nu, int h, int srow) {
  return ch.Ss + (h * (nu + 1) + srow / p.group - (h ? ch.g_hi : ch.g_lo)) * kNC;
}

// cp.async of the chunk's packed rows and scale rows (no commit)
template <int kNC>
__device__ __forceinline__ void stage_packed_scale(const Chunk& ch, const Int4Params& p, int n0,
                                                   int c0, int nu) {
  constexpr int kLdP = packed_stride(kNC);
  const int tid = threadIdx.x;
  if constexpr (kNC == 8) {
    for (int i = tid; i < nu * kUnit; i += kThreads)
      cp_async8(ch.Ps + i * kLdP, p.packed + (size_t)(c0 * kUnit + i) * p.d_out + n0);
  } else {
    constexpr int kC = kNC / 16;
    for (int i = tid; i < nu * kUnit * kC; i += kThreads) {
      const int r = i / kC, c = (i % kC) * 16;
      const bool ok = n0 + c < p.d_out;  // d_out % 16 == 0: a chunk is all in or all out
      cp_async16_or_zero(ch.Ps + r * kLdP + c,
                         p.packed + (ok ? (size_t)(c0 * kUnit + r) * p.d_out + n0 + c : 0), ok);
    }
  }
  constexpr int kC = kNC / 8;  // 16-byte chunks a scale row
  for (int i = tid; i < (ch.n_lo + ch.n_hi) * kC; i += kThreads) {
    const int r = i / kC, c = (i % kC) * 8;
    const bool hi = r >= ch.n_lo;
    const int rr = hi ? r - ch.n_lo : r, grp = (hi ? ch.g_hi : ch.g_lo) + rr;
    const bool ok = n0 + c < p.d_out;
    cp_async16_or_zero(ch.Ss + ((hi ? nu + 1 : 0) + rr) * kNC + c,
                       p.scale + (ok ? (size_t)grp * p.d_out + n0 + c : 0), ok);
  }
}

// x columns of both halves as bf16, Xs [2][16 kMT][nu 16 + 8], rows past
// p.rows zero: cp.async for bf16 x, plain loads rounded to bf16 for float32
template <int kMT>
__device__ __forceinline__ void stage_x_bf16(__nv_bfloat16* Xs, const Int4Params& p, int c0,
                                             int nu) {
  const int half = p.d_in / 2, xrows = 16 * kMT, ldx = nu * kUnit + 8;
  const int kc = nu * kUnit / 8;  // 8-element chunks a row and half
  for (int i = threadIdx.x; i < 2 * xrows * kc; i += kThreads) {
    const int h = i / (xrows * kc), rem = i % (xrows * kc), r = rem / kc, c = (rem % kc) * 8;
    __nv_bfloat16* dst = Xs + (h * xrows + r) * ldx + c;
    const size_t at = (size_t)r * p.d_in + h * half + c0 * kUnit + c;
    if (p.x_bf16) {
      cp_async16_or_zero(dst, static_cast<const __nv_bfloat16*>(p.x) + (r < p.rows ? at : 0),
                         r < p.rows);
    } else {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (r < p.rows) {
        const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p.x) + at);
        a = src[0];
        b = src[1];
      }
      uint4 v;
      v.x = pack_bf16(a.x, a.y);
      v.y = pack_bf16(a.z, a.w);
      v.z = pack_bf16(b.x, b.y);
      v.w = pack_bf16(b.z, b.w);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

// bf16 staging of a chunk of nu units (packed rows, scale rows of both
// halves, bf16 x columns of both halves)
__host__ __device__ constexpr int stage_bytes(int mt, int nc, int units) {
  return units * kUnit * packed_stride(nc)                 // packed rows
         + 2 * (units + 1) * nc * 2                        // scale rows of both halves
         + 2 * 16 * mt * (units * kUnit + 8) * 2;          // x columns of both halves, bf16
}
// the 4 warps' float32 sums [4][16 mt][nc] (over the staging), then the
// receive buffer: cs ranks x (16 mt nc / cs) floats
__host__ __device__ constexpr int red_bytes(int mt, int nc) { return kWarps * 16 * mt * nc * 4; }
__host__ __device__ constexpr int recv_bytes(int mt, int nc) { return 16 * mt * nc * 4; }

// The cluster's sum of acc (each warp's C fragments over [16 kMT][kNC]),
// written by rank slices to out rows [0, p.rows), columns n0..: the 4 warps'
// partial sums are added in warp order in shared memory (the staging is
// dead), then each CTA pushes its sums of the valid rows to the rank that
// owns them (rank q: elements [q S, (q + 1) S) of the row-major [16 kMT][kNC]
// tile, S = 16 kMT kNC / cs) into slot `rank` of that rank's receive buffer
// [cs][S] at smem + stage_cap, 4 elements a store; after one cluster barrier
// each rank adds its elements' cs slots in rank order.  The kernel must have
// arrived at the cluster barrier (barrier.cluster.arrive) before its first
// load, so that every CTA runs before one writes another's shared memory.
template <int kMT, int kNC>
__device__ __forceinline__ void cluster_reduce_store(const float (&acc)[kMT][kNC / 8][4],
                                                     unsigned char* smem, int stage_cap, int rank,
                                                     int cs, const Int4Params& p, int n0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  constexpr int kE = 16 * kMT * kNC;
  const int S = kE / cs;
  __syncthreads();  // the last chunk's readers are done: red overlays the staging
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][kE]
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = red + warp * kE + (16 * m + g + 8 * hh) * kNC;
      if constexpr (kNC == 8) {
        *reinterpret_cast<float2*>(row + 2 * t) = make_float2(acc[m][0][2 * hh], acc[m][0][2 * hh + 1]);
      } else {
#pragma unroll
        for (int blk = 0; blk < kNC / 16; ++blk)
          *reinterpret_cast<float4*>(row + 16 * blk + 4 * t) =
              make_float4(acc[m][2 * blk][2 * hh], acc[m][2 * blk + 1][2 * hh],
                          acc[m][2 * blk][2 * hh + 1], acc[m][2 * blk + 1][2 * hh + 1]);
      }
    }
  }
  __syncthreads();
  float* recv = reinterpret_cast<float*>(smem + stage_cap);  // [cs][S]
  cg::cluster_group cluster = cg::this_cluster();
  if (cs > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = 4 * tid; e < p.rows * kNC; e += 4 * kThreads) {
    float4 v = *reinterpret_cast<const float4*>(red + e);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(red + w * kE + e);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    float* dst = cs > 1 ? cluster.map_shared_rank(recv, e / S) : recv;
    *reinterpret_cast<float4*>(dst + (size_t)rank * S + e % S) = v;
  }
  if (cs > 1) cluster.sync();  // release the pushes, acquire the others'
  else __syncthreads();
  for (int l = 4 * tid; l < S; l += 4 * kThreads) {
    const int e = rank * S + l, row = e / kNC, col = e % kNC;
    if (row >= p.rows || n0 + col >= p.d_out) continue;
    float4 v = *reinterpret_cast<const float4*>(recv + l);
    for (int q = 1; q < cs; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(recv + (size_t)q * S + l);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const size_t at = (size_t)row * p.d_out + n0 + col;
    if (p.out_bf16) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at);
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) = v;
    }
  }
}

// Launch kernel(p, cs, st) over d_out / kNC stripes of cs CTAs, each stripe
// a cluster, with st bytes of staging and the receive buffer after it.
template <int kMT, int kNC>
cudaError_t launch_clustered(void (*kernel)(Int4Params, int, int), const Int4Params& p, int cs,
                             int st, cudaStream_t stream) {
  const size_t smem = st + recv_bytes(kMT, kNC);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.d_out + kNC - 1) / kNC * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p, cs, st);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// The (row tiles, stripe width) instantiation of a launch: kMT 1, 2 or 4 by
// rows; nc 8, 16, 32 or 64 with nc x 16 kMT <= 1024 (64 accumulators a thread).
template <template <int, int> class Launch>
cudaError_t dispatch_shape(const Int4Params& p, int nc, int cs, cudaStream_t s) {
  auto width = [&](auto mt) -> cudaError_t {
    constexpr int kMT = decltype(mt)::value;
    switch (nc) {
      case 8: return Launch<kMT, 8>::run(p, cs, s);
      case 16: return Launch<kMT, 16>::run(p, cs, s);
      case 32:
        if constexpr (kMT <= 2) return Launch<kMT, 32>::run(p, cs, s);
        break;
      case 64:
        if constexpr (kMT == 1) return Launch<kMT, 64>::run(p, cs, s);
        break;
    }
    return cudaErrorInvalidValue;
  };
  if (p.rows <= 16) return width(std::integral_constant<int, 1>());
  if (p.rows <= 32) return width(std::integral_constant<int, 2>());
  return width(std::integral_constant<int, 4>());
}

}  // namespace
