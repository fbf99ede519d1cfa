// K5v3a and K5v3b: the two A/B variants of the int4 decode matmul (K5),
// hand-written for Hopper (sm_90a) on the tensor cores.
//
// Replace the Pallas TPU kernels scripts/bench_int4_kernel.py:_kernel_v3a
// (:49, pallas_call at :89) and _kernel_v3b (:66, pallas_call at :113).
// Both read K5's storage (ops/int4.py): packed int8 [in/2, out], the low
// nibble of packed[i, n] holding code[i, n] and the high nibble
// code[i + in/2, n] (sign-extended 4-bit codes -8..7); scale bf16
// [in/64, out], one scale per group g of 64 input rows.  For x [rows, in],
// rows <= 64 (a decode step):
//
//   v3a: out[r, n] = sum_g scale[g, n] * (sum_{k in g} bf16(x[r, k]) * code[k, n])
//        the inner sum a bf16 product of the UNSCALED codes (exact in bf16)
//        accumulated in fp32, the group scale applied to each group's fp32
//        sum.  (K5 rounds code * scale to bf16 before one product: another
//        rounding, so v3a is held to its own plain version.)
//   v3b: out[r, n] = sum_g (fp32(sum_{k in g} xq[r, k] * code[k, n]) * sx[r, g]) * scale[g, n]
//        xq int8 [rows, in] and sx fp32 [rows, in/64] the per-(row, group)
//        quantization of x, done outside the kernel (ops/int4.py, plain
//        tensor ops, as XLA code does it in the JAX script); the inner sum
//        int8 x int8 in int32.
//
// What bounds them: bytes, as K5.  At 8 rows each packed byte feeds 16
// multiply-adds, far below the card's ~295 flops/byte balance (bf16) or
// ~590 (int8); the packed weight must stream from device memory once.
//
// Design.  A CTA owns a stripe of 64 output columns and a range of packed
// row blocks (split-K: each block of 64 packed rows carries group b in its
// low nibbles and group b + in/128 in its high nibbles); enough splits are
// taken that ~2 CTAs run per SM, and a second launch sums the splits' fp32
// partials in order.  Per block, the 256 threads stage the packed tile (64
// x 64 bytes, one 16-byte load each) and both groups' x columns (padded to
// 16-row tiles, rounded to bf16 or int8 as given) in shared memory.  Warp w
// owns columns 8w..8w+7: it unpacks its B fragments from the packed tile
// and runs mma.sync m16n8k16 bf16 (v3a) or m16n8k32 s8 (v3b) over the 64-deep
// group for each 16-row tile of x, then scales the group's accumulator
// fragment and adds it to its running sum in registers.  Simple first
// version: no cp.async pipelining of the next block's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"  // mma_bf16, pack_bf16 (int4 codes are exact in bf16)

namespace {

constexpr int kThreads = 256;       // 8 warps; warp w owns stripe columns 8w..8w+7
constexpr int kGroup = 64;          // input rows per scale group (= packed rows per block)
constexpr int kStripe = 64;         // output columns per CTA
constexpr int kMaxRows = 64;        // rows of x: at most 4 tiles of 16
constexpr int kLdP = kStripe + 16;  // packed tile row stride, bytes (16-byte rows, spread banks)
constexpr int kLdX = kGroup + 8;    // bf16 x tile row stride, elements
constexpr int kLdQ = kGroup + 16;   // int8 x tile row stride, bytes

__device__ __forceinline__ int lo_code(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int hi_code(int b) { return (((b >> 4) & 0xF) ^ 8) - 8; }

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_s8(int c0, int c1, int c2, int c3) {
  return (uint32_t)(c0 & 0xFF) | ((uint32_t)(c1 & 0xFF) << 8) | ((uint32_t)(c2 & 0xFF) << 16) |
         ((uint32_t)(c3 & 0xFF) << 24);
}

// c += a . b, m16n8k32, int8 operands, int32 accumulation
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// packed rows [r0, r0 + 64) of the stripe's 64 columns -> Ps [64][kLdP];
// columns at or past d_out (a multiple of 16) read as zero
__device__ __forceinline__ void load_packed(uint8_t* Ps, const int8_t* packed, int r0, int n0,
                                            int d_out) {
  const int row = threadIdx.x / 4, chunk = threadIdx.x % 4, col = n0 + 16 * chunk;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (col < d_out) v = *reinterpret_cast<const uint4*>(packed + (size_t)(r0 + row) * d_out + col);
  *reinterpret_cast<uint4*>(Ps + row * kLdP + 16 * chunk) = v;
}

// the split's fp32 partial sums -> dst (rows of the split at blockIdx.y)
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[4][4], int mt, int rows,
                                          int d_out, int col) {
  const int g = (threadIdx.x % 32) / 4;
  float* base = dst + (size_t)blockIdx.y * rows * d_out;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m >= mt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      if (r < rows) {
        base[(size_t)r * d_out + col] = acc[m][2 * h];
        base[(size_t)r * d_out + col + 1] = acc[m][2 * h + 1];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    v3a_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
               const __nv_bfloat16* __restrict__ scale, float* __restrict__ dst, int rows,
               int d_in, int d_out, int per_split) {
  __shared__ __align__(16) uint8_t Ps[kGroup * kLdP];
  __shared__ __align__(16) __nv_bfloat16 Xs[2][kMaxRows * kLdX];  // the block's two groups
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kStripe;
  const int nb = d_in / 2 / kGroup;  // packed row blocks
  const int blk0 = blockIdx.y * per_split, blk1 = min(nb, blk0 + per_split);
  const int mt = (rows + 15) / 16;
  const int xrows = 16 * mt;
  const int col = n0 + 8 * warp + 2 * t;  // this lane's two output columns
  const bool has_cols = n0 + 8 * warp < d_out;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  for (int blk = blk0; blk < blk1; ++blk) {
    __syncthreads();  // the previous block's readers are done
    load_packed(Ps, packed, blk * kGroup, n0, d_out);
    for (int i = tid; i < 2 * xrows * kGroup; i += kThreads) {
      const int h = i / (xrows * kGroup), rem = i - h * xrows * kGroup;
      const int r = rem / kGroup, k = rem - r * kGroup;
      const float v = r < rows ? to_f(x[(size_t)r * d_in + (blk + h * nb) * kGroup + k]) : 0.f;
      Xs[h][r * kLdX + k] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    if (!has_cols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // low nibbles: group blk; high nibbles: group blk + nb
      float accg[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accg[m][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kGroup; ks += 16) {
        const uint8_t* pp = Ps + (ks + 2 * t) * kLdP + 8 * warp + g;  // k = ks + 2t, column g
        const int p0 = (int8_t)pp[0], p1 = (int8_t)pp[kLdP];
        const int p8 = (int8_t)pp[8 * kLdP], p9 = (int8_t)pp[9 * kLdP];
        const uint32_t b[2] = {
            h == 0 ? pack_bf16(lo_code(p0), lo_code(p1)) : pack_bf16(hi_code(p0), hi_code(p1)),
            h == 0 ? pack_bf16(lo_code(p8), lo_code(p9)) : pack_bf16(hi_code(p8), hi_code(p9))};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m >= mt) break;
          const __nv_bfloat16* ap = Xs[h] + (16 * m + g) * kLdX + ks + 2 * t;
          const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * kLdX), ld32(ap + 8),
                                 ld32(ap + 8 * kLdX + 8)};
          mma_bf16(accg[m], a, b);
        }
      }
      const int grp = blk + h * nb;
      const __nv_bfloat162 s2 =
          *reinterpret_cast<const __nv_bfloat162*>(scale + (size_t)grp * d_out + col);
      const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[m][0] += accg[m][0] * s0;
        acc[m][1] += accg[m][1] * s1;
        acc[m][2] += accg[m][2] * s0;
        acc[m][3] += accg[m][3] * s1;
      }
    }
  }
  if (has_cols) store_acc(dst, acc, mt, rows, d_out, col);
}

__global__ void __launch_bounds__(kThreads)
    v3b_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ packed, const __nv_bfloat16* __restrict__ scale,
               float* __restrict__ dst, int rows, int d_in, int d_out, int per_split) {
  __shared__ __align__(16) uint8_t Ps[kGroup * kLdP];
  __shared__ __align__(16) int8_t Xq[2][kMaxRows * kLdQ];  // the block's two groups of xq
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kStripe;
  const int nb = d_in / 2 / kGroup;
  const int n_groups = 2 * nb;
  const int blk0 = blockIdx.y * per_split, blk1 = min(nb, blk0 + per_split);
  const int mt = (rows + 15) / 16;
  const int xrows = 16 * mt;
  const int col = n0 + 8 * warp + 2 * t;
  const bool has_cols = n0 + 8 * warp < d_out;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  for (int blk = blk0; blk < blk1; ++blk) {
    __syncthreads();
    load_packed(Ps, packed, blk * kGroup, n0, d_out);
    // both groups' xq, 4 bytes a thread (d_in and the group offsets are multiples of 64)
    for (int i = tid; i < 2 * xrows * (kGroup / 4); i += kThreads) {
      const int h = i / (xrows * (kGroup / 4)), rem = i - h * xrows * (kGroup / 4);
      const int r = rem / (kGroup / 4), k = 4 * (rem - r * (kGroup / 4));
      const uint32_t v =
          r < rows ? ld32(xq + (size_t)r * d_in + (blk + h * nb) * kGroup + k) : 0u;
      *reinterpret_cast<uint32_t*>(Xq[h] + r * kLdQ + k) = v;
    }
    __syncthreads();
    if (!has_cols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int accg[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accg[m][e] = 0;
#pragma unroll
      for (int ks = 0; ks < kGroup; ks += 32) {
        const uint8_t* pp = Ps + (ks + 4 * t) * kLdP + 8 * warp + g;  // k = ks + 4t.., column g
        int c[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = (int8_t)pp[((i & 3) + 16 * (i >> 2)) * kLdP];
          c[i] = h == 0 ? lo_code(p) : hi_code(p);
        }
        const uint32_t b[2] = {pack_s8(c[0], c[1], c[2], c[3]), pack_s8(c[4], c[5], c[6], c[7])};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m >= mt) break;
          const int8_t* ap = Xq[h] + (16 * m + g) * kLdQ + ks + 4 * t;
          const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * kLdQ), ld32(ap + 16),
                                 ld32(ap + 8 * kLdQ + 16)};
          mma_s8(accg[m], a, b);
        }
      }
      const int grp = blk + h * nb;
      const __nv_bfloat162 s2 =
          *reinterpret_cast<const __nv_bfloat162*>(scale + (size_t)grp * d_out + col);
      const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= mt) break;
        const int r0 = 16 * m + g, r1 = r0 + 8;
        const float x0 = r0 < rows ? sx[(size_t)r0 * n_groups + grp] : 0.f;
        const float x1 = r1 < rows ? sx[(size_t)r1 * n_groups + grp] : 0.f;
        acc[m][0] += ((float)accg[m][0] * x0) * s0;
        acc[m][1] += ((float)accg[m][1] * x0) * s1;
        acc[m][2] += ((float)accg[m][2] * x1) * s0;
        acc[m][3] += ((float)accg[m][3] * x1) * s1;
      }
    }
  }
  if (has_cols) store_acc(dst, acc, mt, rows, d_out, col);
}

// out[i] = sum over the splits of partial[s][i], in split order
__global__ void sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  out[i] = s;
}

bool bad_shape(int rows, int d_in, int d_out, int group, int splits, int per_split) {
  const int nb = d_in / 2 / kGroup;
  return rows < 0 || rows > kMaxRows || group != kGroup || d_in % (2 * kGroup) != 0 ||
         d_out % 16 != 0 || d_out <= 0 || splits <= 0 || per_split <= 0 ||
         (long long)splits * per_split < nb || (long long)(splits - 1) * per_split >= nb;
}

// After the first kernel (writing `partial` when splits > 1, else `out`):
// the sum over the splits.
cudaError_t finish(float* out, const float* partial, int rows, int d_out, int splits,
                   cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = rows * d_out;
  sum_splits_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, out, splits,
                                                                         n);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; out float32 [rows, d_out]; partial
// float32 [splits, rows, d_out] (unused when splits == 1).  Needs rows <= 64,
// group 64, d_in % 128 == 0, d_out % 16 == 0, 16-byte aligned packed, and
// splits * per_split covering the in/128 packed row blocks with none empty.
// Returns the first failing launch's cudaError_t.
extern "C" int mcl_int4_matmul_v3a(const void* x, const void* packed, const void* scale, void* out,
                                   void* partial, int rows, int d_in, int d_out, int group,
                                   int splits, int per_split, int x_dtype, void* stream) {
  if (bad_shape(rows, d_in, d_out, group, splits, per_split) || x_dtype < 0 || x_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  const dim3 grid((d_out + kStripe - 1) / kStripe, splits);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale);
  if (x_dtype == 0) {
    v3a_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), p, sc, dst, rows,
                                                d_in, d_out, per_split);
  } else {
    v3a_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), p, sc, dst, rows, d_in, d_out, per_split);
  }
  return (int)finish(static_cast<float*>(out), static_cast<const float*>(partial), rows, d_out,
                     splits, s);
}

// xq int8 [rows, d_in] and sx float32 [rows, d_in / 64]: x quantized per
// (row, group).  Otherwise as mcl_int4_matmul_v3a.
extern "C" int mcl_int4_matmul_v3b(const void* xq, const void* sx, const void* packed,
                                   const void* scale, void* out, void* partial, int rows,
                                   int d_in, int d_out, int group, int splits, int per_split,
                                   void* stream) {
  if (bad_shape(rows, d_in, d_out, group, splits, per_split)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  const dim3 grid((d_out + kStripe - 1) / kStripe, splits);
  v3b_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(packed), static_cast<const __nv_bfloat16*>(scale), dst, rows,
      d_in, d_out, per_split);
  return (int)finish(static_cast<float*>(out), static_cast<const float*>(partial), rows, d_out,
                     splits, s);
}
