// K2: token-major attention core on the packed qkv projection output,
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels multimodal_concept_learning_tpu/ops/
// attention_core.py:_fwd_kernel (:104) and _bwd_kernel (:123), called through
// _core_call (pallas_call at :303) under the custom VJP at :315-342.
//
//   qkv [B, T, 3*H*D] (fp32 or bf16, contiguous): column part*H*D + h*D + d
//   holds part q/k/v of head h; D is a template parameter, built for 16, 32
//   and 64 (with_head_dim, merged_attention.cuh).  Forward: out [B, T, H*D] =
//   softmax(q k^T * scale, masked) v, per (sample, head), token-major; with a
//   non-null lse pointer also the row logsumexp [B, H, T] fp32.  Backward:
//   dqkv [B, T, 3*H*D] in the same packed layout, from (qkv, out, dA, lse)
//   in fp32 and from (qkv, dA) in bf16.
//   Key c is valid for query r iff c < t_real, kv_mask[b, c] != 0 (when a
//   mask is given) and, under causal, c <= r.  A row with no valid key gets
//   a zero output, lse = +inf and no gradient (the TPU kernel averages it
//   uniformly; no row of the CLIP path is such a row).
//
// What bounds it: at the CLIP path's shapes (vision [256, 50, 12 x 64],
// text [256, 77, 8 x 64], bf16) the arithmetic is ~2*2*T*T*D per (sample,
// head): 0.2-0.5 GFLOP a launch, ~0.5 us at the tensor cores' peak, while the
// bytes (qkv in, out written; the backward reads dA and writes dqkv) take
// 23-42 us at 3.35 TB/s, so the bound is memory.  The bf16
// forward runs at ~1.7x that bound at the vision shape and ~3.4x at the
// text shape (H100, PERF.md): what is left is latency, each CTA's chain of
// mask scan, tile copies, two passes and the store, with 4 CTAs an SM (128
// registers a thread); the text tower's CTAs move few bytes each.
//
// Design.  Each CTA reads its head's D contiguous columns straight from the
// packed rows (row stride 3*H*D) with 16-byte loads and writes token-major,
// so no relayout happens on either side.
// - Forward, bf16 (core_fwd_tc_kernel): the tensor cores.  One CTA of 4
//   warps per (64-query tile, head, sample), each warp 16 query rows.  Q, K
//   and V tiles of 64 rows go to bf16 shared memory with 16-byte cp.async
//   (rows padded to D + 8: ldmatrix is free of bank conflicts); S = Q K^T
//   and O += P V are mma.sync m16n8k16 with fp32 accumulation (mma_tiles.cuh).
//   Two passes over 64-key tiles keep the TPU kernel's rounding, which needs
//   each row's max m and sum l before P is formed: pass 1 takes them online
//   (reduced over the quad of lanes that holds a row), pass 2 recomputes S
//   and forms P = bf16(exp(s - m) / l) straight in the A-fragment layout.
//   Where the keys fit one tile (both CLIP shapes), V's copy overlaps pass 1
//   and pass 2 reuses the K tile; the output leaves through the warp's Q
//   rows in shared memory as 16-byte stores.  What is left is bytes: qkv's
//   q, k and v columns read once, out written once.
// - Forward, fp32 (core_fwd_kernel): CUDA cores, no TF32 (float32 runs must
//   match the plain version to 1e-4): one CTA per (64-query tile, head,
//   sample), two passes over 32-key tiles with scores in fp32 smem.
// - Backward, bf16: the tensor-core pair shared with K2-bd and K6
//   (merged_bwd_tc.cuh, K2's choices: causal or not, kv_mask or not, dS *
//   D^-1/2 rounded to bf16), over 16-row slots of one sample each, 4 a CTA.
//   bwd_dq_tc_kernel takes lse and delta = rowsum(dP * P) (the TPU kernel's,
//   float32 P) online and writes them to a float32 workspace [2, H, B*T]
//   that the wrapper allocates; bwd_dkv_tc_kernel owns key rows.  It takes
//   neither the forward's out nor its lse (so a bf16 forward for training
//   writes no lse), and any T.
// - Backward, fp32 (core_bwd_kernel): the CUDA cores (no TF32), bound
//   by its own arithmetic and shared-memory traffic.  One CTA per (head,
//   sample) owns all three gradient slices of its head, so no atomics and
//   no second pass: it loops over 32-key tiles (dK, dV in registers) and,
//   inside, over 32-query tiles, recomputing P = exp(s - lse) once per
//   (query tile, key tile); dQ accumulates in a [T, D] fp32 smem tile (T <=
//   640) written at the end.  delta = rowsum(dA * out) stands in for
//   rowsum(dP * P) (equal in exact arithmetic).
// - A sample's last valid key (from kv_mask and t_real) bounds the key loop:
//   the text tower's captions fill ~13 of 77 positions.

#include "merged_attention.cuh"  // kBK, kBQB, load_rows, with_head_dim
#include "merged_bwd_tc.cuh"     // the bf16 backward; mma_tiles.cuh: the warp attention tiles

namespace {

constexpr int kBQ = 64;                   // forward queries per CTA
constexpr int kMaxTBwd = kMaxRows;        // fp32 backward: dQ tile [T, D] fp32 in smem

struct CoreParams {
  const void* qkv;
  void* out;
  const void* dout;  // backward only
  float* lse;        // forward: nullable output; backward: input
  const int* kv_mask;  // nullable, [B, T]
  void* dqkv;        // backward only
  int B, T, H, t_real, causal;
  float scale;
};

// The number of keys any row of sample b may attend: one past the last key
// below t_real that the mask keeps.  Every thread of the CTA returns it.
__device__ __forceinline__ int key_end(const CoreParams& p, int b, int* s_end) {
  const int hi = min(p.T, p.t_real);
  if (p.kv_mask == nullptr) return hi;
  if (threadIdx.x == 0) *s_end = 0;
  __syncthreads();
  int mine = 0;
  for (int c = threadIdx.x; c < hi; c += blockDim.x)
    if (p.kv_mask[(size_t)b * p.T + c] != 0) mine = c + 1;
  if (mine > 0) atomicMax(s_end, mine);
  __syncthreads();
  return *s_end;
}

__device__ __forceinline__ bool key_valid(const CoreParams& p, int b, int r, int c, int k_end) {
  if (r >= p.T || c >= k_end) return false;
  if (p.causal && c > r) return false;
  return p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.T + c] != 0;
}

template <int kD>
__global__ void __launch_bounds__(kThreads) core_fwd_kernel(CoreParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kBQ][kD]
  float* Ks = Qs + kBQ * kD;                 // [kBK][kD + 1]
  float* Vs = Ks + kBK * (kD + 1);           // [kBK][kD]
  float* Ss = Vs + kBK * kD;                 // [kBQ][kBK + 1]
  float* row_m = Ss + kBQ * (kBK + 1);       // [kBQ]
  float* row_l = row_m + kBQ;                // [kBQ]
  __shared__ int s_end;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const long long stride = 3LL * p.H * kD;
  const float* qb = static_cast<const float*>(p.qkv) + (size_t)b * p.T * stride + h * kD;
  const float* kb = qb + p.H * kD;
  const float* vb = kb + p.H * kD;
  float* o = static_cast<float*>(p.out);

  const int k_end = key_end(p, b, &s_end);
  load_rows<float, kD>(Qs, kD, qb, stride, q0, kBQ, p.T);
  for (int r = tid; r < kBQ; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }
  int k_hi = k_end;
  if (p.causal) k_hi = min(k_hi, min(q0 + kBQ, p.T));

  constexpr int kORS = kThreads / kD;  // output: column od, rows orow0 + i * kORS
  constexpr int kNO = kBQ / kORS;
  const int od = tid % kD, orow0 = tid / kD;
  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
  constexpr int kSRS = kThreads / kBK;  // scores: key column sc, rows srow0 + i * kSRS
  constexpr int kNS = kBQ / kSRS;
  const int sc = tid % kBK, srow0 = tid / kBK;
  __syncthreads();

  // pass 0: each row's max and sum over its valid keys (online);
  // pass 1: P = exp(s - max) / sum, then acc += P V
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < k_hi; kt += kBK) {
      load_rows<float, kD>(Ks, kD + 1, kb, stride, kt, kBK, p.T);
      if (pass == 1) load_rows<float, kD>(Vs, kD, vb, stride, kt, kBK, p.T);
      __syncthreads();
      {
        float s[kNS];
#pragma unroll
        for (int i = 0; i < kNS; ++i) s[i] = 0.f;
        const float* kr = Ks + sc * (kD + 1);
        for (int d = 0; d < kD; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int i = 0; i < kNS; ++i) s[i] = fmaf(Qs[(srow0 + i * kSRS) * kD + d], kd, s[i]);
        }
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int r = srow0 + i * kSRS;
          Ss[r * (kBK + 1) + sc] =
              key_valid(p, b, q0 + r, kt + sc, k_end) ? s[i] * p.scale : -INFINITY;
        }
      }
      __syncthreads();
      // one warp per row, one lane per key
      for (int r = warp; r < kBQ; r += kThreads / 32) {
        const float x = Ss[r * (kBK + 1) + lane];
        if (pass == 0) {
          const float m_old = row_m[r];
          const float m_new = fmaxf(m_old, warp_max(x));
          const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
          const float sum = warp_sum(expf(x - m_use));
          if (lane == 0) {
            row_l[r] = row_l[r] * expf(m_old - m_use) + sum;
            row_m[r] = m_new;
          }
        } else {
          const float l = row_l[r];  // 0 on a row with no valid key: P = 0
          Ss[r * (kBK + 1) + lane] = l > 0.f ? expf(x - row_m[r]) / l : 0.f;
        }
      }
      __syncthreads();
      if (pass == 1) {
        for (int c = 0; c < kBK; ++c) {
          const float vx = Vs[c * kD + od];
#pragma unroll
          for (int i = 0; i < kNO; ++i)
            acc[i] = fmaf(Ss[(orow0 + i * kORS) * (kBK + 1) + c], vx, acc[i]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    const int r = orow0 + i * kORS, t = q0 + r;
    if (t < p.T) store_f(o + ((size_t)b * p.T + t) * p.H * kD + h * kD + od, acc[i]);
  }
  if (p.lse != nullptr) {
    for (int r = tid; r < kBQ; r += kThreads) {
      const int t = q0 + r;
      if (t < p.T) {
        const float l = row_l[r];
        p.lse[((size_t)b * p.H + h) * p.T + t] = l > 0.f ? row_m[r] + logf(l) : INFINITY;
      }
    }
  }
}

constexpr int kTcThreads = 128;  // bf16 forward: 4 warps x 16 query rows
constexpr int kTcRows = 64;      // query rows per CTA
constexpr int kTcKeys = 64;      // keys per tile

// S of the warp's 16 rows against key tile kt, scaled, with every key the
// row may not attend at -inf: row < T is not checked (rows past T are never
// written); kok[c] says key kt + c is below the key end and kept by the mask.
__device__ __forceinline__ void core_mask(float (&s)[kTcKeys / 8][4], const CoreParams& p,
                                          const unsigned char* kok, int kt, int row_a) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t4 + (e & 1), row = row_a + (e >> 1) * 8;
      const bool ok = kok[c] && (!p.causal || kt + c <= row);
      s[j][e] = ok ? s[j][e] * p.scale : -INFINITY;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads) core_fwd_tc_kernel(CoreParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);        // [kTcRows][kD + 8]; then the output
  bf16* Ks = Qs + kTcRows * (kD + 8);                  // [kTcKeys][kD + 8]
  bf16* Vs = Ks + kTcKeys * (kD + 8);                  // [kTcKeys][kD + 8]
  unsigned char* kok = reinterpret_cast<unsigned char*>(Vs + kTcKeys * (kD + 8));  // [kTcKeys]
  __shared__ int s_end;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTcRows, h = blockIdx.y, b = blockIdx.z;
  const long long stride = 3LL * p.H * kD;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (size_t)b * p.T * stride + h * kD;
  const bf16* kb = qb + p.H * kD;
  const bf16* vb = kb + p.H * kD;

  // group 1: Q (issued before the key end is known) and the first K tile;
  // group 2: the first V tile when the keys fit one tile (it lands while
  // pass 1 runs), else empty
  async_rows<kD, kTcThreads>(Qs, qb + (size_t)q0 * stride, stride, kTcRows, p.T - q0);
  const int k_end = key_end(p, b, &s_end);
  int k_hi = k_end;
  if (p.causal) k_hi = min(k_hi, min(q0 + kTcRows, p.T));
  const int n_kt = (k_hi + kTcKeys - 1) / kTcKeys;
  auto flags = [&](int kt) {  // kok for key tile kt
    if (threadIdx.x < kTcKeys) {
      const int c = kt + threadIdx.x;
      kok[threadIdx.x] = c < k_hi && (p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.T + c] != 0);
    }
  };

  if (n_kt > 0) async_rows<kD, kTcThreads>(Ks, kb, stride, kTcKeys, k_hi);
  cp_async_commit();
  if (n_kt == 1) async_rows<kD, kTcThreads>(Vs, vb, stride, kTcKeys, k_hi);
  cp_async_commit();

  const int r0 = q0 + 16 * warp, row_a = r0 + lane / 4;  // the thread's rows: row_a, row_a + 8
  const bool active = r0 < p.T;
  bf16* Qw = Qs + 16 * warp * (kD + 8);  // the warp's Q rows, later its output rows
  float s[kTcKeys / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

  // pass 1: each row's max and sum over its valid keys (online)
  for (int it = 0; it < n_kt; ++it) {
    const int kt = it * kTcKeys;
    if (it > 0) {
      __syncthreads();  // the previous tile's readers are done
      async_rows<kD, kTcThreads>(Ks, kb + (size_t)kt * stride, stride, kTcKeys, k_hi - kt);
      cp_async_commit();
    }
    flags(kt);
    if (it == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!active) continue;
    warp_scores<kD, kTcKeys>(s, Qw, Ks);
    core_mask(s, p, kok, kt, row_a);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked so far
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j)
        sum += __expf(s[j][2 * hr] - m_use) + __expf(s[j][2 * hr + 1] - m_use);
      l[hr] = l[hr] * __expf(m[hr] - m_use) + sum;
      m[hr] = m_new;
    }
  }
  float m_use[2], inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    m_use[hr] = m[hr] == -INFINITY ? 0.f : m[hr];
    inv[hr] = l[hr] > 0.f ? 1.f / l[hr] : 0.f;  // a row with no valid key: P = 0
  }

  // pass 2: P = exp(s - m) / l rounded to bf16, then o += P V
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int it = 0; it < n_kt; ++it) {
    const int kt = it * kTcKeys;
    if (n_kt > 1) {
      __syncthreads();
      async_rows<kD, kTcThreads>(Ks, kb + (size_t)kt * stride, stride, kTcKeys, k_hi - kt);
      async_rows<kD, kTcThreads>(Vs, vb + (size_t)kt * stride, stride, kTcKeys, k_hi - kt);
      cp_async_commit();
      flags(kt);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    warp_scores<kD, kTcKeys>(s, Qw, Ks);
    core_mask(s, p, kok, kt, row_a);
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - m_use[e >> 1]) * inv[e >> 1];
    uint32_t pa[kTcKeys / 16][4];
    probs_to_a<kTcKeys>(pa, s);
    warp_pv<kD, kTcKeys>(o, pa, Vs);
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy into Qs has landed before it takes the output
  if (!active) return;

  const float one[2] = {1.f, 1.f};
  bf16* out = static_cast<bf16*>(p.out) + ((size_t)b * p.T + r0) * p.H * kD + h * kD;
  warp_store_rows<kD>(o, one, Qw, min(16, p.T - r0),
                      [&](int r) { return out + (size_t)r * p.H * kD; });
  if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = row_a + 8 * hr;
      if (t < p.T)
        p.lse[((size_t)b * p.H + h) * p.T + t] = l[hr] > 0.f ? m[hr] + logf(l[hr]) : INFINITY;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) core_bwd_kernel(CoreParams p) {
  extern __shared__ float smem[];
  float* dQ = smem;                           // [T][kD] fp32 accumulator
  float* Qs = dQ + (size_t)p.T * kD;          // [kBQB][kD + 1]
  float* dAs = Qs + kBQB * (kD + 1);          // [kBQB][kD + 1]
  float* Ks = dAs + kBQB * (kD + 1);          // [kBK][kD + 1]
  float* Vs = Ks + kBK * (kD + 1);            // [kBK][kD + 1]
  float* Ps = Vs + kBK * (kD + 1);            // [kBQB][kBK + 1] P, rounded
  float* dSs = Ps + kBQB * (kBK + 1);         // [kBQB][kBK + 1] dS * scale, rounded
  float* lse_s = dSs + kBQB * (kBK + 1);      // [T]
  float* delta_s = lse_s + p.T;               // [T]
  __shared__ int s_end;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long stride = 3LL * p.H * kD, ostride = (long long)p.H * kD;
  const float* qb = static_cast<const float*>(p.qkv) + (size_t)b * p.T * stride + h * kD;
  const float* kb = qb + p.H * kD;
  const float* vb = kb + p.H * kD;
  const float* ob = static_cast<const float*>(p.out) + (size_t)b * p.T * ostride + h * kD;
  const float* dab = static_cast<const float*>(p.dout) + (size_t)b * p.T * ostride + h * kD;
  float* dq_out = static_cast<float*>(p.dqkv) + (size_t)b * p.T * stride + h * kD;
  float* dk_out = dq_out + p.H * kD;
  float* dv_out = dk_out + p.H * kD;

  const int k_end = key_end(p, b, &s_end);
  for (int i = tid; i < p.T * kD; i += kThreads) dQ[i] = 0.f;
  // delta = rowsum(dA * out), lse: one warp per row
  for (int t = warp; t < p.T; t += kThreads / 32) {
    float x = 0.f;
    for (int d = lane; d < kD; d += 32)
      x += load_f(dab + (size_t)t * ostride + d) * load_f(ob + (size_t)t * ostride + d);
    x = warp_sum(x);
    if (lane == 0) {
      delta_s[t] = x;
      lse_s[t] = p.lse[((size_t)b * p.H + h) * p.T + t];
    }
  }

  constexpr int kRS = kThreads / kD;  // dK/dV/dQ: column cd, rows crow0 + i * kRS
  constexpr int kNK = kBK / kRS;
  constexpr int kNQ = kBQB / kRS;
  const int cd = tid % kD, crow0 = tid / kD;
  constexpr int kSRS = kThreads / kBK;  // scores: key column sc, rows srow0 + i * kSRS
  constexpr int kNS = kBQB / kSRS;
  const int sc = tid % kBK, srow0 = tid / kBK;

  for (int kt = 0; kt < p.T; kt += kBK) {
    float dk[kNK], dv[kNK];
#pragma unroll
    for (int i = 0; i < kNK; ++i) dk[i] = dv[i] = 0.f;
    if (kt < k_end) {
      __syncthreads();  // the previous tile's readers are done with Ks/Vs
      load_rows<float, kD>(Ks, kD + 1, kb, stride, kt, kBK, p.T);
      load_rows<float, kD>(Vs, kD + 1, vb, stride, kt, kBK, p.T);
      const int q_lo = p.causal ? (kt / kBQB) * kBQB : 0;
      for (int qt = q_lo; qt < p.T; qt += kBQB) {
        load_rows<float, kD>(Qs, kD + 1, qb, stride, qt, kBQB, p.T);
        load_rows<float, kD>(dAs, kD + 1, dab, ostride, qt, kBQB, p.T);
        __syncthreads();
        {
          float s[kNS], dp[kNS];
#pragma unroll
          for (int i = 0; i < kNS; ++i) s[i] = dp[i] = 0.f;
          const float* kr = Ks + sc * (kD + 1);
          const float* vr = Vs + sc * (kD + 1);
          for (int d = 0; d < kD; ++d) {
            const float kd = kr[d], vd = vr[d];
#pragma unroll
            for (int i = 0; i < kNS; ++i) {
              const int r = srow0 + i * kSRS;
              s[i] = fmaf(Qs[r * (kD + 1) + d], kd, s[i]);
              dp[i] = fmaf(dAs[r * (kD + 1) + d], vd, dp[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < kNS; ++i) {
            const int r = srow0 + i * kSRS, t = qt + r;
            float pr = 0.f, ds = 0.f;
            if (key_valid(p, b, t, kt + sc, k_end)) {
              pr = expf(s[i] * p.scale - lse_s[t]);  // lse = +inf -> 0
              ds = pr * (dp[i] - delta_s[t]);
            }
            Ps[r * (kBK + 1) + sc] = pr;
            dSs[r * (kBK + 1) + sc] = ds * p.scale;
          }
        }
        __syncthreads();
        // dV += P^T dA, dK += dS^T Q for this key tile; dQ += dS K
#pragma unroll
        for (int i = 0; i < kNK; ++i) {
          const int c = crow0 + i * kRS;
          float av = 0.f, ak = 0.f;
          for (int r = 0; r < kBQB; ++r) {
            av = fmaf(Ps[r * (kBK + 1) + c], dAs[r * (kD + 1) + cd], av);
            ak = fmaf(dSs[r * (kBK + 1) + c], Qs[r * (kD + 1) + cd], ak);
          }
          dv[i] += av;
          dk[i] += ak;
        }
#pragma unroll
        for (int i = 0; i < kNQ; ++i) {
          const int r = crow0 + i * kRS, t = qt + r;
          if (t < p.T) {
            float a = 0.f;
            for (int c = 0; c < kBK; ++c) a = fmaf(dSs[r * (kBK + 1) + c], Ks[c * (kD + 1) + cd], a);
            dQ[t * kD + cd] += a;
          }
        }
        __syncthreads();
      }
    }
    // keys past the sample's last valid key get zero gradients
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      const int key = kt + crow0 + i * kRS;
      if (key < p.T) {
        store_f(dk_out + (size_t)key * stride + cd, dk[i]);
        store_f(dv_out + (size_t)key * stride + cd, dv[i]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < p.T * kD; i += kThreads)
    store_f(dq_out + (size_t)(i / kD) * stride + i % kD, dQ[i]);
}

template <int kD>
size_t fwd_smem() {
  return sizeof(float) * (kBQ * kD + kBK * (kD + 1) + kBK * kD + kBQ * (kBK + 1) + 2 * kBQ);
}

template <int kD>
size_t bwd_smem(int T) {
  return sizeof(float) * ((size_t)T * kD + 2 * kBQB * (kD + 1) + 2 * kBK * (kD + 1) +
                          2 * kBQB * (kBK + 1) + 2 * (size_t)T);
}

template <int kD>
cudaError_t launch_fwd(const CoreParams& p, cudaStream_t stream) {
  const size_t smem = fwd_smem<kD>();
  cudaError_t err = cudaFuncSetAttribute(core_fwd_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  core_fwd_kernel<kD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_fwd_tc(const CoreParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (kTcRows + 2 * kTcKeys) * (kD + 8) + kTcKeys;
  cudaError_t err = cudaFuncSetAttribute(core_fwd_tc_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kTcRows - 1) / kTcRows, p.H, p.B);
  core_fwd_tc_kernel<kD><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_bwd(const CoreParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem<kD>(p.T);
  cudaError_t err = cudaFuncSetAttribute(core_bwd_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  core_bwd_kernel<kD><<<dim3(p.H, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  Returns the launch's cudaError_t.
extern "C" int mcl_attention_core_fwd(const void* qkv, void* out, float* lse, const int* kv_mask,
                                      int B, int T, int H, int D, int t_real, int causal,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  CoreParams p{qkv, out, nullptr, lse, kv_mask, nullptr, B, T, H, t_real, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0 ? launch_fwd<kD>(p, s) : launch_fwd_tc<kD>(p, s);
  });
}

// dtype: 0 = float32 (core_bwd_kernel, from the forward's out and lse; T <=
// 640; ws null), 1 = bfloat16 (the shared tensor-core pair, from qkv and dA
// alone: out and lse null; ws: float32 [2, H, B * T] scratch).  Returns the
// first failing launch's cudaError_t.
extern "C" int mcl_attention_core_bwd(const void* qkv, const void* out, const void* dout,
                                      const float* lse, const int* kv_mask, void* dqkv,
                                      float* ws, int B, int T, int H, int D, int t_real,
                                      int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (out != nullptr || lse != nullptr) return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    const mcl_bwd_tc::BwdParams p{static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                                  static_cast<bf16*>(dqkv), ws, kv_mask, B, T, H, t_real, scale};
    return (int)mcl_bwd_tc::launch(p, D, causal != 0, kv_mask != nullptr, true, s);
  }
  if (T > kMaxTBwd || out == nullptr || lse == nullptr || ws != nullptr)
    return (int)cudaErrorInvalidValue;
  CoreParams p{qkv, const_cast<void*>(out), dout, const_cast<float*>(lse), kv_mask, dqkv, B, T,
               H, t_real, causal, scale};
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_bwd<kD>(p, s);
  });
}
