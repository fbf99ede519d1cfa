// Multi-tensor AdamW: the optimizer's gradient accumulation, squared global
// norm and update (parallel/optimizer.py) over every trained tensor in one
// launch each, or in a few where the tensor list is longer than one launch's
// parameter space holds.
//
// Replaces no TPU kernel: on the TPU, XLA fuses optax's chain
// (MultiSteps(chain(clip_by_global_norm, adamw))) over all leaves itself.
// Added because per-tensor dispatch set the pace of the train step on this
// card: about 20 PyTorch ops a tensor, some 8,000 launches an update at 15-20
// us of host time each, against microseconds of device time each.
//
// Bound: bytes.  The update reads the gradient, mu, nu and the target (the
// float32 master or the parameter) and writes mu, nu and the target, and the
// bf16 parameter beside a master: 28 bytes a float32 value, 32 where the
// gradient is the accumulator it then zeroes.  The accumulation reads the
// gradient and the accumulator and writes the accumulator (12 bytes a
// float32 value); the norm reads the gradient (4), and sums its squares in
// float64.
//
// Design.  The host packs one row of int64 a tensor (pointers, element
// count, dtype; ``kCols`` columns) and passes up to ``kMaxTensors`` rows a
// launch by value, in the kernel's parameter space (CUDA 12.1 or later:
// 32,764 bytes), so a launch needs no copy to the device and nothing is
// allocated a step.  Each tensor is cut into tiles of ``kTile`` elements;
// a fixed grid of at most ``kMaxBlocks`` blocks walks the tiles of all
// tensors, a block finding a tile's tensor by a binary search over the
// tiles' prefix sums.  A thread loads its ``kIlp`` elements of every stream
// before it computes, so loads stay in flight.
//
// Numbers.  Per element the arithmetic is the per-tensor PyTorch chain's, op
// for op, in explicitly rounded intrinsics so that nothing is contracted into
// an FMA: where clipping does not engage, mu, nu, the masters, the
// parameters and the accumulators come out bitwise those of the per-tensor
// path on the card.  PyTorch's CUDA division by a host scalar multiplies by
// the scalar's float reciprocal, and so does this file (the bias
// corrections, the accumulation's 1 / (n + 1)); bf16 values are rounded
// after each operation, as PyTorch's bf16 ops round.  The norm writes one
// float64 partial sum a block into a scratch buffer; one block then sums the
// partials in a fixed order, so a run is deterministic, and rounds the sum
// to float32 once.  The per-tensor path sums in float32 and lands a few
// float32 steps away; where clipping engages, that gap alone separates the
// two paths' states.  The update reads the squared norm from device memory
// and applies optax's clip ``norm < max_norm ? g : (g / norm) * max_norm``
// itself: no host sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxTensors = 512;  // rows a launch takes (ops/multi_tensor_adamw.py: MAX_TENSORS)
constexpr int kThreads = 256;
constexpr int kIlp = 4;
constexpr int kTile = kThreads * kIlp;  // elements a tile
constexpr int kMaxBlocks = 4 * 132;     // a launch's grid at most: four blocks an SM
constexpr int kSumThreads = 1024;
// the host table's columns (ops/multi_tensor_adamw.py: COLUMNS)
enum Col { kGrad, kParam, kMaster, kMu, kNu, kAcc, kNumel, kDtype, kCols };

struct Table {
  const void* grad[kMaxTensors];  // null: no gradient (zeros)
  void* param[kMaxTensors];
  float* master[kMaxTensors];  // null: no master (the parameter is the target)
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  void* acc[kMaxTensors];
  long long numel[kMaxTensors];
  int tile0[kMaxTensors + 1];  // tiles of the rows before row i
  unsigned char bf16[kMaxTensors];  // the parameter's (and gradient's, accumulator's) dtype
  int count;
};

struct Hyper {
  const float* sq_norm;  // null: no clipping
  float max_norm, b1, b2, one_minus_b1, one_minus_b2, inv_bc1, inv_bc2, eps, weight_decay,
      step_size;
  int from_acc;  // the gradient is the accumulator, zeroed once read
};

static_assert(sizeof(Table) + sizeof(Hyper) <= 32764, "a launch's parameters exceed 32,764 bytes");

template <bool kBf16>
using Elem = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool kBf16>
__device__ __forceinline__ Elem<kBf16> from_float(float x) {
  if constexpr (kBf16) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// x as an op of the element's dtype leaves it: rounded to bf16 for bf16
template <bool kBf16>
__device__ __forceinline__ float rounded(float x) {
  return to_float(from_float<kBf16>(x));
}

// the row whose tiles hold ``tile``: tile0[row] <= tile < tile0[row + 1]
__device__ __forceinline__ int find_row(const Table& t, int tile) {
  int lo = 0, hi = t.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.tile0[mid] <= tile) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// acc <- acc + (g - acc) * inv over one tile, each op rounded to the dtype
template <bool kBf16>
__device__ __forceinline__ void accumulate_tile(const Table& t, int row, long long base,
                                                float inv) {
  using T = Elem<kBf16>;
  const long long n = t.numel[row];
  const T* g = static_cast<const T*>(t.grad[row]);
  T* acc = static_cast<T*>(t.acc[row]);
  float gv[kIlp], av[kIlp];
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long e = base + k * kThreads + threadIdx.x;
    gv[k] = (g != nullptr && e < n) ? to_float(g[e]) : 0.f;
    av[k] = e < n ? to_float(acc[e]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long e = base + k * kThreads + threadIdx.x;
    if (e < n) {
      const float d = rounded<kBf16>(__fsub_rn(gv[k], av[k]));
      const float q = rounded<kBf16>(__fmul_rn(d, inv));
      acc[e] = from_float<kBf16>(__fadd_rn(av[k], q));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(const __grid_constant__ Table t, float inv) {
  const int tiles = t.tile0[t.count];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = find_row(t, tile);
    const long long base = static_cast<long long>(tile - t.tile0[row]) * kTile;
    if (t.bf16[row]) {
      accumulate_tile<true>(t, row, base, inv);
    } else {
      accumulate_tile<false>(t, row, base, inv);
    }
  }
}

// the block's sum of ``v``, in a fixed order; the result on thread 0
template <int kBlock>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warps[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kBlock / 32 ? warps[threadIdx.x] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// s + the tile's g^2, in float64: a float32 square is exact in it, and a
// thread's chain of some thousand adds loses nothing a float32 result keeps
template <bool kBf16>
__device__ __forceinline__ double sq_tile(const void* src, long long n, long long base, double s) {
  using T = Elem<kBf16>;
  const T* g = static_cast<const T*>(src);
  double gv[kIlp];
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long e = base + k * kThreads + threadIdx.x;
    gv[k] = e < n ? static_cast<double>(to_float(g[e])) : 0.0;
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) s = __dadd_rn(s, __dmul_rn(gv[k], gv[k]));
  return s;
}

// one float64 partial sum of g^2 a block, into partials[blockIdx.x]
__global__ void __launch_bounds__(kThreads)
    sq_norm_kernel(const __grid_constant__ Table t, int from_acc, double* partials) {
  const int tiles = t.tile0[t.count];
  double s = 0.0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = find_row(t, tile);
    const void* src = from_acc ? t.acc[row] : t.grad[row];
    if (src == nullptr) continue;  // no gradient: zeros
    const long long base = static_cast<long long>(tile - t.tile0[row]) * kTile;
    s = t.bf16[row] ? sq_tile<true>(src, t.numel[row], base, s)
                    : sq_tile<false>(src, t.numel[row], base, s);
  }
  s = block_sum<kThreads>(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// out = the sum of partials[0..n) rounded to float32: each thread's strided
// run in order, then the block's fixed tree, in float64
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const double* partials, int n, float* out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s = __dadd_rn(s, partials[i]);
  s = block_sum<kSumThreads>(s);
  if (threadIdx.x == 0) *out = __double2float_rn(s);
}

template <bool kBf16, bool kMaster>
__device__ __forceinline__ void update_tile(const Table& t, int row, long long base,
                                            const Hyper& h, bool clip, float norm) {
  using T = Elem<kBf16>;
  const long long n = t.numel[row];
  const T* g = static_cast<const T*>(h.from_acc ? t.acc[row] : t.grad[row]);
  T* acc = static_cast<T*>(t.acc[row]);
  T* p = static_cast<T*>(t.param[row]);
  float* master = t.master[row];
  float* mu = t.mu[row];
  float* nu = t.nu[row];
  float gv[kIlp], mv[kIlp], vv[kIlp], tv[kIlp];
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long e = base + k * kThreads + threadIdx.x;
    gv[k] = (g != nullptr && e < n) ? to_float(g[e]) : 0.f;
    mv[k] = e < n ? mu[e] : 0.f;
    vv[k] = e < n ? nu[e] : 0.f;
    if constexpr (kMaster) {
      tv[k] = e < n ? master[e] : 0.f;
    } else {
      tv[k] = e < n ? to_float(p[e]) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long e = base + k * kThreads + threadIdx.x;
    if (e >= n) continue;
    float gk = gv[k];
    if (clip) gk = __fmul_rn(__fdiv_rn(gk, norm), h.max_norm);
    // mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * (g * g) + b2 * nu
    const float m = __fadd_rn(__fmul_rn(h.one_minus_b1, gk), __fmul_rn(h.b1, mv[k]));
    const float v = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(gk, gk)), __fmul_rn(h.b2, vv[k]));
    // (mu / bc1) / (sqrt(nu / bc2) + eps), + weight_decay * target, * -lr
    float u = __fdiv_rn(__fmul_rn(m, h.inv_bc1),
                        __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps));
    u = __fmul_rn(__fadd_rn(u, __fmul_rn(h.weight_decay, tv[k])), h.step_size);
    const float target = __fadd_rn(tv[k], u);
    mu[e] = m;
    nu[e] = v;
    if constexpr (kMaster) master[e] = target;
    p[e] = from_float<kBf16>(target);
    if (h.from_acc) acc[e] = from_float<kBf16>(0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ Table t, const Hyper h) {
  float norm = 0.f;
  bool clip = false;
  if (h.sq_norm != nullptr) {
    norm = __fsqrt_rn(*h.sq_norm);
    clip = !(norm < h.max_norm);
  }
  const int tiles = t.tile0[t.count];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = find_row(t, tile);
    const long long base = static_cast<long long>(tile - t.tile0[row]) * kTile;
    const bool master = t.master[row] != nullptr;
    if (t.bf16[row]) {
      if (master) {
        update_tile<true, true>(t, row, base, h, clip, norm);
      } else {
        update_tile<true, false>(t, row, base, h, clip, norm);
      }
    } else if (master) {
      update_tile<false, true>(t, row, base, h, clip, norm);
    } else {
      update_tile<false, false>(t, row, base, h, clip, norm);
    }
  }
}

// Fills ``t`` from ``count`` host rows; returns the tiles, or -1 for a table
// the kernels do not take.
long long fill(Table& t, const long long* rows, int count) {
  if (rows == nullptr || count < 0 || count > kMaxTensors) return -1;
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + static_cast<long long>(i) * kCols;
    if (r[kNumel] < 0 || (r[kDtype] != 0 && r[kDtype] != 1)) return -1;
    t.grad[i] = reinterpret_cast<const void*>(r[kGrad]);
    t.param[i] = reinterpret_cast<void*>(r[kParam]);
    t.master[i] = reinterpret_cast<float*>(r[kMaster]);
    t.mu[i] = reinterpret_cast<float*>(r[kMu]);
    t.nu[i] = reinterpret_cast<float*>(r[kNu]);
    t.acc[i] = reinterpret_cast<void*>(r[kAcc]);
    t.numel[i] = r[kNumel];
    t.bf16[i] = static_cast<unsigned char>(r[kDtype]);
    t.tile0[i] = static_cast<int>(tiles);
    tiles += (r[kNumel] + kTile - 1) / kTile;
    if (tiles > INT_MAX) return -1;
  }
  t.tile0[count] = static_cast<int>(tiles);
  t.count = count;
  return tiles;
}

int grid_of(long long tiles, int most) {
  return static_cast<int>(tiles < most ? tiles : most);
}

}  // namespace

// acc <- acc + (g - acc) / (n_seen + 1) over ``count`` rows (a null
// gradient counts as zeros).  Returns the launch's cudaError_t.
extern "C" int mcl_multi_tensor_accumulate(const long long* rows, int count, int n_seen,
                                           void* stream) {
  Table t;
  const long long tiles = fill(t, rows, count);
  if (tiles < 0 || n_seen < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const float inv = 1.0f / static_cast<float>(n_seen + 1);  // PyTorch's reciprocal of the scalar
  accumulate_kernel<<<grid_of(tiles, kMaxBlocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, inv);
  return static_cast<int>(cudaGetLastError());
}

// partials[b] = block b's float64 sum of g^2 (the accumulators' where
// from_acc), for a grid of at most ``slots`` blocks; slots past the grid are
// not written.
extern "C" int mcl_multi_tensor_sq_norm(const long long* rows, int count, int from_acc,
                                        double* partials, int slots, void* stream) {
  Table t;
  const long long tiles = fill(t, rows, count);
  if (tiles < 0 || partials == nullptr || slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  sq_norm_kernel<<<grid_of(tiles, slots < kMaxBlocks ? slots : kMaxBlocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(t, from_acc, partials);
  return static_cast<int>(cudaGetLastError());
}

// *out = partials[0] + ... + partials[n - 1] in float64, in a fixed order,
// rounded to float32.
extern "C" int mcl_multi_tensor_sum(const double* partials, int n, float* out, void* stream) {
  if (partials == nullptr || out == nullptr || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sum_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, n, out);
  return static_cast<int>(cudaGetLastError());
}

// One AdamW update over ``count`` rows: the gradient (the accumulator,
// zeroed, where from_acc) clipped by sqrt(*sq_norm) against max_norm unless
// sq_norm is null, then the moments, the bias-corrected step, decoupled
// weight decay and step_size (-lr) into the target (the master, its bf16
// rounding into the parameter; or the parameter).
extern "C" int mcl_multi_tensor_adamw(const long long* rows, int count, int from_acc,
                                      const float* sq_norm, float max_norm, float b1, float b2,
                                      float one_minus_b1, float one_minus_b2, float bc1,
                                      float bc2, float eps, float weight_decay, float step_size,
                                      void* stream) {
  Table t;
  const long long tiles = fill(t, rows, count);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  // PyTorch divides by a host scalar as a multiplication by its float reciprocal
  const Hyper h{sq_norm,     max_norm,    b1,  b2,           one_minus_b1, one_minus_b2,
                1.0f / bc1,  1.0f / bc2,  eps, weight_decay, step_size,    from_acc};
  adamw_kernel<<<grid_of(tiles, kMaxBlocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, h);
  return static_cast<int>(cudaGetLastError());
}
