// K5: decode-shaped matrix product against int4 weights, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel multimodal_concept_learning_tpu/ops/int4.py:
// _kernel (via _int4_matmul_kernel, pallas_call at :145).  It computes
//     out[r, n] = sum_k bf16(x[r, k]) * bf16(code[k, n] * scale[k / group, n])
// in float32, for x [rows, in] (float32 or bf16, rows <= 64 on the decode
// path) and the packed layout of ops/int4.py: packed int8 [in/2, out], the
// low nibble of packed[i, n] holding code[i, n] and the high nibble
// code[i + in/2, n] (sign-extended 4-bit codes); scale bf16 [in/group, out].
// The dequantized weight is the 4-bit code times the bf16 scale, exact in
// float32 and rounded to bf16 once: the same bf16 weight as both JAX paths.
//
// What bounds it: bytes.  At 8 rows each packed byte feeds 16 multiply-adds,
// far below the card's ~295 flops/byte balance, so the kernel streams the
// packed weight from device memory exactly once per 8 rows and keeps
// everything else on the SM: one CTA owns a stripe of 64 output columns;
// its 256 threads are 4 lanes across the stripe (16 columns each, one
// 16-byte load = 16 columns x two nibble rows i and i + in/2) by 64 slices
// of the packed rows, so a warp's loads cover 8 rows x 64 contiguous bytes
// and the 64 slices of one iteration share one scale row (a broadcast).  x
// sits in shared memory as bf16, transposed [in][8], so one 16-byte read
// gives a k's 8 rows.  Each thread accumulates 8 rows x 16 columns in float32
// registers; lanes of a column group are summed with warp shuffles, warps
// through 16 KB of shared memory.  Rows are taken 8 at a time; 64 rows read
// the stripe 8 times (the later passes hit L2).  At out = 256 (k/v
// projections) only 4 CTAs run: split-K across CTAs, or mma.sync / wgmma
// with x padded to 16 rows, are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;                       // rows of x per pass
constexpr int kCols = 16;                         // output columns per thread (16 packed bytes)
constexpr int kColThreads = 4;                    // lanes across the stripe
constexpr int kStripe = kCols * kColThreads;      // 64 output columns per CTA
constexpr int kSlices = kThreads / kColThreads;   // packed rows in flight per CTA

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                       const __nv_bfloat16* __restrict__ scale, float* __restrict__ out, int rows,
                       int d_in, int d_out, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [d_in][kRowTile]
  float* red = reinterpret_cast<float*>(smem + (size_t)d_in * kRowTile * sizeof(__nv_bfloat16));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cg = lane % kColThreads;
  const int slice = warp * (32 / kColThreads) + lane / kColThreads;
  const int col0 = blockIdx.x * kStripe + cg * kCols;
  const bool has_cols = col0 < d_out;  // d_out % 16 == 0: a column group is all in or all out
  const int half = d_in / 2;

  for (int r0 = 0; r0 < rows; r0 += kRowTile) {
    const int nr = min(kRowTile, rows - r0);
    // x tile, transposed and rounded to bf16; rows past nr are zero
    for (int e = tid; e < d_in * kRowTile; e += kThreads) {
      const int r = e / d_in;
      const int k = e - r * d_in;
      const float v = r < nr ? to_f(x[(size_t)(r0 + r) * d_in + k]) : 0.f;
      xs[k * kRowTile + r] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    float acc[kRowTile][kCols];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

    if (has_cols) {
#pragma unroll 2
      for (int i = slice; i < half; i += kSlices) {
        const uint4 p4 = *reinterpret_cast<const uint4*>(packed + (size_t)i * d_out + col0);
        const int8_t* pb = reinterpret_cast<const int8_t*>(&p4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // low nibbles: row i; high nibbles: row i + half
          const int k = i + h * half;
          const uint4* sp =
              reinterpret_cast<const uint4*>(scale + (size_t)(k / group) * d_out + col0);
          const uint4 s4[2] = {sp[0], sp[1]};
          const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(s4);
          const uint4 x4 = *reinterpret_cast<const uint4*>(xs + (size_t)k * kRowTile);
          const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x4);
          float xv[kRowTile];
#pragma unroll
          for (int j = 0; j < kRowTile / 2; ++j) {
            const float2 f = __bfloat1622float2(xh[j]);
            xv[2 * j] = f.x;
            xv[2 * j + 1] = f.y;
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int byte = pb[c];  // sign-extended, as the JAX unpack reads it
            const int code = h == 0 ? ((byte & 0xF) ^ 8) - 8 : (((byte >> 4) & 0xF) ^ 8) - 8;
            const float w = bf16_round((float)code * __bfloat162float(sb[c]));
#pragma unroll
            for (int r = 0; r < kRowTile; ++r) acc[r][c] = fmaf(xv[r], w, acc[r][c]);
          }
        }
      }
    }

    // sum the 8 slices of a warp that share a column group (lanes cg, cg+4, ...)
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float v = acc[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][c] = v;
      }
    if (lane < kColThreads) {
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          red[(warp * kRowTile + r) * kStripe + cg * kCols + c] = acc[r][c];
    }
    __syncthreads();
    for (int e = tid; e < kRowTile * kStripe; e += kThreads) {
      const int r = e / kStripe;
      const int c = e - r * kStripe;
      const int col = blockIdx.x * kStripe + c;
      if (r < nr && col < d_out) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[(w * kRowTile + r) * kStripe + c];
        out[(size_t)(r0 + r) * d_out + col] = s;
      }
    }
    __syncthreads();  // xs and red are rewritten by the next row tile
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int rows,
                   int d_in, int d_out, int group, cudaStream_t stream) {
  const size_t smem = (size_t)d_in * kRowTile * sizeof(__nv_bfloat16) +
                      sizeof(float) * kWarps * kRowTile * kStripe;
  cudaError_t err = cudaFuncSetAttribute(int4_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int stripes = (d_out + kStripe - 1) / kStripe;
  int4_matmul_kernel<T><<<stripes, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(out), rows, d_in, d_out,
      group);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; out is float32 [rows, d_out].  Needs
// d_in % (2 * group) == 0, d_out % 16 == 0, 16-byte aligned packed and scale.
// Returns the launch's cudaError_t.
extern "C" int mcl_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                               int rows, int d_in, int d_out, int group, int x_dtype,
                               void* stream) {
  if (rows < 0 || group <= 0 || d_in % (2 * group) != 0 || d_out % kCols != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return (int)launch<float>(x, packed, scale, out, rows, d_in, d_out, group, s);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16>(x, packed, scale, out, rows, d_in, d_out, group, s);
  return (int)cudaErrorInvalidValue;
}
