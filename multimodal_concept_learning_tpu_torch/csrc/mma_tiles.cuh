// Tensor-core and async-copy primitives shared by the port's kernels
// (sm_90a), and the warp-level attention tiles built from them.
//
// Primitives: the m16n8k16 bf16 product with fp32 accumulation (mma_bf16),
// ldmatrix (x4, x4.trans), bf16 pair packing, and 16-byte cp.async with its
// commit/wait helpers.  Users: K1 and K2 forward (flash_attention_fwd.cu,
// attention_core.cu), K6 (fused_attention_block.cu), K5v3a
// (int4_matmul_v3.cu), K4 (paged_attention_mp.cu).
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g + 8, same k),
//     a2 (row g, k 2t + 8..), a3 (row g + 8, k 2t + 8..);
//   B (16 x 8, k-major per column): b0 (k 2t..2t+1, column g), b1 (k 2t + 8..);
//   C (16 x 8, fp32): c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8).
// The C layout of two neighbouring 8-column tiles is the A layout of one
// 16-deep chunk, so scores become the A operand of P.V in registers.
//
// The attention tiles read bf16 row-major tiles from shared memory whose
// row stride is the width plus 8 elements: the 8 rows of each ldmatrix
// phase then start 16 bytes apart modulo 128 and hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // internal linkage: each source that includes this compiles its own copy

// c += a . b, one m16n8k16 bf16 tensor-core product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives row l / 4, elements 2(l % 4) and
// 2(l % 4) + 1 of each matrix (.trans: column l / 4, rows 2(l % 4), + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// (lo, hi) rounded to bf16 (nearest even) in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// 16 bytes from src, or 16 zero bytes (src not read) when !valid
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- warp-level attention tiles (bf16 tiles in shared memory, stride width + 8)

// rows [0, nrows) of a [rows, kD] bf16 tile whose row r starts at
// src + r * stride (elements) -> dst [rows][kD + 8], by cp.async over the
// CTA's kN threads; rows at or past `valid` are zero-filled.
template <int kD, int kN>
__device__ __forceinline__ void async_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int nrows, int valid) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < nrows * kChunks; i += kN) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16_or_zero(dst + r * (kD + 8) + c, src + (ok ? r * stride + c : 0), ok);
  }
}

// s[j] = Q[16 rows] . K[8 keys from 8j]^T over kD, for kBK keys: Qs points at
// the warp's first row, Ks at the tile's first key, both stride kD + 8.
template <int kD, int kBK>
__device__ __forceinline__ void warp_scores(float (&s)[kBK / 8][4], const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const __nv_bfloat16* qa = Qs + (lane % 16) * (kD + 8) + 8 * (lane / 16);
  const __nv_bfloat16* kb = Ks + (lane % 8 + 8 * (lane / 16)) * (kD + 8) + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int k0 = 0; k0 < kD; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + k0);
#pragma unroll
    for (int n0 = 0; n0 < kBK; n0 += 16) {
      uint32_t b[4];  // b0, b1 of keys n0..n0+7, then of keys n0+8..n0+15
      ldmatrix_x4(b, kb + n0 * (kD + 8) + k0);
      const uint32_t b_lo[2] = {b[0], b[1]}, b_hi[2] = {b[2], b[3]};
      mma_bf16(s[n0 / 8], a, b_lo);
      mma_bf16(s[n0 / 8 + 1], a, b_hi);
    }
  }
}

// o[j] += P[16 rows, kBK keys] . V[kBK keys, 8 columns from 8j]; p holds the
// probabilities as A fragments (one per 16 keys), Vs the tile's first key.
template <int kD, int kBK>
__device__ __forceinline__ void warp_pv(float (&o)[kD / 8][4], const uint32_t (&p)[kBK / 16][4],
                                        const __nv_bfloat16* Vs) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* vb = Vs + (lane % 8 + 8 * ((lane / 8) % 2)) * (kD + 8) + 8 * (lane / 16);
#pragma unroll
  for (int c = 0; c < kBK / 16; ++c) {
#pragma unroll
    for (int n0 = 0; n0 < kD; n0 += 16) {
      uint32_t b[4];  // b0, b1 of columns n0..n0+7, then of columns n0+8..n0+15
      ldmatrix_x4_trans(b, vb + 16 * c * (kD + 8) + n0);
      const uint32_t b_lo[2] = {b[0], b[1]}, b_hi[2] = {b[2], b[3]};
      mma_bf16(o[n0 / 8], p[c], b_lo);
      mma_bf16(o[n0 / 8 + 1], p[c], b_hi);
    }
  }
}

// The A fragments of P.V from probabilities in the C layout of the scores:
// keys 16c..16c+15 are score tiles 2c and 2c + 1, rounded to bf16.
template <int kBK>
__device__ __forceinline__ void probs_to_a(uint32_t (&p)[kBK / 16][4], const float (&s)[kBK / 8][4]) {
#pragma unroll
  for (int c = 0; c < kBK / 16; ++c) {
    p[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
    p[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
    p[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
    p[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
  }
}

// max and sum over the quad of lanes (4g .. 4g + 3) that holds one row of C
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The warp's [16, kD] fp32 accumulator (C layout, rows scaled by inv[0] for
// row g and inv[1] for row g + 8) as bf16 rows into its own smem slab
// [16][kD + 8], then each row r < nrows to dst_row(r) with 16-byte stores.
template <int kD, typename RowPtr>
__device__ __forceinline__ void warp_store_rows(const float (&o)[kD / 8][4], const float (&inv)[2],
                                                __nv_bfloat16* slab, int nrows, RowPtr dst_row) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(slab + g * (kD + 8) + 8 * j + 2 * t) =
        pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(slab + (g + 8) * (kD + 8) + 8 * j + 2 * t) =
        pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = kD / 8;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (r < nrows)
      *reinterpret_cast<uint4*>(dst_row(r) + c) =
          *reinterpret_cast<const uint4*>(slab + r * (kD + 8) + c);
  }
}

}  // namespace
