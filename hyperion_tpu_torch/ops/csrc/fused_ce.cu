// Fused softmax cross-entropy for Hopper (sm_90a): the forward (per-row
// loss and log-sum-exp) and the backward (dlogits), over [N, V] logits
// that may be a row-strided view.
//
// Replaces: hyperion_tpu/ops/pallas/fused_ce.py
//   * forward: `fused_softmax_xent` / `fused_softmax_xent_fwd_only` ->
//     `_run_forward` -> `_fwd_kernel`;
//   * backward: `_bwd` -> `_bwd_kernel`.
//
// Bound on the H100: bytes. The forward reads the logits once (~4 flops
// an element: max, subtract, exp, add) and writes two floats a row; the
// backward reads them once and writes dlogits once. At the language_ddp
// train step ([32*127, 50257] fp32 read, [32*128, 50257] written) that
// is 817 MB, 0.244 ms, forward and 1.64 GB, 0.490 ms, backward at
// 3.35 TB/s; at the seq-4096 step ([8*4095, 50257] read, [8*4096,
// 50257] written) 6.58 GB forward and 13.17 GB, 3.932 ms, backward.
//
// Design:
//   * Rows are addressed as [B, R, V] with element strides (sb, sr, 1),
//     so the [B, T-1, V] view `logits[:, :-1]` of the model's [B, T, V]
//     output is read in place: the contiguous [B*(T-1), V] copy is never
//     made. B = 1 covers a plain [N, V] array.
//   * The forward is one block per row streaming the vocab with an online
//     max and a rescaled sum (the reference's m/l scratch, carried in
//     registers per thread): each thread loads 8 strided elements, takes
//     their max, rescales its sum once and adds 8 exponentials, so there
//     is about one expf an element. Thread partials merge in a block
//     reduction of (max, sum) pairs. The ragged vocab tail (50257 =
//     24 * 2048 + 1105) is a bound check, not the reference's `_pad` to
//     51200 columns, which would copy the whole array. The target logit
//     is one load by thread 0 — the value the reference's iota == target
//     sum picks. lse = m + log(max(l, 1e-37)), loss = lse - logit[t].
//   * The backward writes (exp(x - lse) - [j == t]) * g in fp32, cast
//     once to the logits' dtype, one block per destination row. The
//     destination has row strides of its own and may have more rows a
//     batch than the source (Rd >= R): rows r >= R are written zero. So
//     the loss over `logits[:, :-1]` gets the gradient of the whole
//     [B, T, V] logits from one launch, the last position zero, and
//     autograd runs no slice backward (a zero-fill and a copy of the
//     step's largest tensor) after it.
//   * What bounds it is bytes in flight. A row of the full layout and
//     its view share their offset (b*T + t)*V, so source and destination
//     sit alike against the 16-byte grid even where V is odd: a scalar
//     head of at most 3 fp32 or 7 bf16 elements reaches the grid, a
//     scalar tail follows the last whole 16 bytes, and the body between
//     streams through the TMA engine as 1-D bulk copies, no tensor map:
//     a ring of kStages = 4 stages of 16 KB in shared memory, each loaded
//     by one `cp.async.bulk` counted on its mbarrier, turned into dlogits
//     in place by the block (16 bytes a thread a step), and written back
//     by one bulk store. Thread 0 refills the stage of the chunk before
//     once that chunk's store has read it, so three 16 KB loads a block
//     stay in flight while the block computes (three blocks an SM: the
//     ring is 64 KB). Timed in turns on an H100, this ran 6 % faster
//     than 16-byte register loads with the next 64 bytes a thread in
//     flight, and faster than rings of 3, 6 or 8 stages or of 4 and 8 KB
//     stages (PERF.md). A row whose source and destination sit
//     differently against the grid (the public backward's contiguous
//     output of a strided view) takes the scalar loop: kChunk strided
//     loads, then their stores.
// Targets arrive int32 and in [0, V): the wrapper checks both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // elements a thread holds between rescales

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// (m, s) <- merge of two online-softmax partials: a partial with no
// elements is (-inf, 0) and contributes nothing.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - M)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - M));
  m = M;
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, int64_t n, int R,
                                            int64_t sb, int64_t sr) {
  return base + (n / R) * sb + (n % R) * sr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              float* __restrict__ loss, float* __restrict__ lse, int R, int V,
              int64_t sb, int64_t sr) {
  const int64_t n = blockIdx.x;
  const T* xr = row_ptr(logits, n, R, sb, sr);

  float m = -INFINITY, s = 0.f;
  for (int base = threadIdx.x; base < V; base += kThreads * kChunk) {
    float v[kChunk];
    float cm = -INFINITY;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int j = base + k * kThreads;
      v[k] = j < V ? to_float(xr[j]) : -INFINITY;
      cm = fmaxf(cm, v[k]);
    }
    if (cm > m) {
      s = m == -INFINITY ? 0.f : s * expf(m - cm);
      m = cm;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (v[k] != -INFINITY) s += expf(v[k] - m);
    }
  }

  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float pm[kThreads / 32], ps[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    pm[warp] = m;
    ps[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? pm[lane] : -INFINITY;
    s = lane < kThreads / 32 ? ps[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(fmaxf(s, 1e-37f));
      lse[n] = l;
      loss[n] = l - to_float(xr[targets[n]]);
    }
  }
}

// dlogits of one element, the reference's `_bwd_kernel` arithmetic
__device__ __forceinline__ float grad_of(float x, bool hit, float l, float gn) {
  return (expf(x - l) - (hit ? 1.f : 0.f)) * gn;
}

// 16 bytes of T (4 fp32 or 8 bf16) from and to fp32
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return raw;
}

constexpr int kStages = 4;        // bulk-copy ring stages a block
constexpr int kChunkVecs = 1024;  // 16-byte vectors a stage: 16 KB
constexpr int kRingBytes = kStages * (kChunkVecs * 16 + 8);  // and mbarriers

// the 16-byte vector of dlogits for the vector `raw` of logits that
// starts at column j0
template <typename T>
__device__ __forceinline__ uint4 grad16(const uint4& raw, int j0, int t, float l,
                                        float gn) {
  float v[16 / sizeof(T)];
  unpack16(raw, v);
#pragma unroll
  for (int e = 0; e < 16 / int(sizeof(T)); ++e) v[e] = grad_of(v[e], j0 + e == t, l, gn);
  return pack16(v);
}

// elements before the first 16-byte boundary of p (at most V)
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int V) {
  const int bytes = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  return min(bytes / static_cast<int>(sizeof(T)), V);
}

template <typename T>
__device__ void zero_row(T* __restrict__ dr, int V) {
  constexpr int kVec = 16 / sizeof(T);
  const int h = head_of(dr, V);
  const int nv = (V - h) / kVec, tail = h + nv * kVec;
  if (threadIdx.x < h) dr[threadIdx.x] = from_float<T>(0.f);
  if (threadIdx.x < V - tail) dr[tail + threadIdx.x] = from_float<T>(0.f);
  uint4* dv = reinterpret_cast<uint4*>(dr + h);
  for (int i = threadIdx.x; i < nv; i += kThreads) __stcs(dv + i, make_uint4(0, 0, 0, 0));
}

// source and destination off the grid by different amounts: scalar
// accesses, kChunk loads in flight before the first store
template <typename T>
__device__ void scalar_row(const T* __restrict__ xr, T* __restrict__ dr, int V, int t,
                           float l, float gn) {
  for (int base = threadIdx.x; base < V; base += kThreads * kChunk) {
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int j = base + k * kThreads;
      v[k] = j < V ? to_float(xr[j]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int j = base + k * kThreads;
      if (j < V) dr[j] = from_float<T>(grad_of(v[k], j == t, l, gn));
    }
  }
}

// One block per destination row (b, r) of B x Rd rows at b*dsb + r*dsr:
// rows r < R are dlogits of source row (b, r) (at b*sb + r*sr; targets,
// lse and g at b*R + r), rows r >= R zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, int R, int V, int64_t sb, int64_t sr,
              int Rd, int64_t dsb, int64_t dsr) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t b = blockIdx.x / Rd;
  const int r = static_cast<int>(blockIdx.x % Rd);
  T* dr = dlogits + b * dsb + r * dsr;
  if (r >= R) {
    zero_row(dr, V);
    return;
  }
  const T* xr = logits + b * sb + r * sr;
  const int64_t n = b * R + r;
  const float l = lse[n], gn = g[n];
  const int t = targets[n];
  if (((reinterpret_cast<uintptr_t>(xr) ^ reinterpret_cast<uintptr_t>(dr)) & 15) != 0) {
    scalar_row(xr, dr, V, t, l, gn);
    return;
  }
  const int h = head_of(dr, V);
  const int nv = (V - h) / kVec, tail = h + nv * kVec;
  if (threadIdx.x < h) {
    const int j = threadIdx.x;
    dr[j] = from_float<T>(grad_of(to_float(xr[j]), j == t, l, gn));
  }
  if (threadIdx.x < V - tail) {
    const int j = tail + threadIdx.x;
    dr[j] = from_float<T>(grad_of(to_float(xr[j]), j == t, l, gn));
  }
  const uint4* xv = reinterpret_cast<const uint4*>(xr + h);
  uint4* dv = reinterpret_cast<uint4*>(dr + h);
  const int chunks = (nv + kChunkVecs - 1) / kChunkVecs;
  if (chunks == 0) return;
  extern __shared__ __align__(128) unsigned char smem[];
  uint4(*ring)[kChunkVecs] = reinterpret_cast<uint4(*)[kChunkVecs]>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kChunkVecs * 16);
  auto load = [&](int c) {  // thread 0: chunk c into its stage
    const uint32_t bytes = min(kChunkVecs, nv - c * kChunkVecs) * 16;
    sm90::mbar_arrive_expect_tx(&full[c % kStages], bytes);
    sm90::bulk_load(ring[c % kStages], xv + c * kChunkVecs, bytes, &full[c % kStages]);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    for (int c = 0; c < min(kStages, chunks); ++c) load(c);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    const int here = min(kChunkVecs, nv - c * kChunkVecs);
    sm90::mbar_wait(&full[s], (c / kStages) & 1);
    for (int i = threadIdx.x; i < here; i += kThreads) {
      ring[s][i] = grad16<T>(ring[s][i], h + (c * kChunkVecs + i) * kVec, t, l, gn);
    }
    sm90::fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      sm90::bulk_store(dv + c * kChunkVecs, ring[s], here * 16);
      sm90::bulk_commit();
      // refill the stage of chunk c-1 once its store has read it
      if (c >= 1 && c - 1 + kStages < chunks) {
        sm90::bulk_wait_read<1>();
        load(c - 1 + kStages);
      }
    }
  }
  if (threadIdx.x == 0) sm90::bulk_wait_read<0>();  // the ring outlives its reads
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits: B*R rows of V elements, row
// (b, r) at element offset b*sb + r*sr, unit stride along V; targets:
// [B*R] int32 in [0, V); loss, lse: [B*R] fp32.
extern "C" int hyperion_fused_ce_fwd(const void* logits, const void* targets,
                                     void* loss, void* lse, int B, int R, int V,
                                     long long sb, long long sr, int dtype,
                                     void* stream) {
  const long long rows = static_cast<long long>(B) * R;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(rows));
  const int* t = static_cast<const int*>(targets);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), t, static_cast<float*>(loss),
        static_cast<float*>(lse), R, V, sb, sr);
  } else if (dtype == 1) {
    ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), t,
        static_cast<float*>(loss), static_cast<float*>(lse), R, V, sb, sr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus lse, g: [B*R] fp32, and dlogits: B x Rd rows
// (Rd >= R) in the logits' dtype, row (b, r) at element offset
// b*dsb + r*dsr, unit stride along V; rows r >= R are written zero.
extern "C" int hyperion_fused_ce_bwd(const void* logits, const void* targets,
                                     const void* lse, const void* g,
                                     void* dlogits, int B, int R, int V,
                                     long long sb, long long sr, int Rd,
                                     long long dsb, long long dsr, int dtype,
                                     void* stream) {
  if (Rd < R || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * Rd;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(rows));
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  // the ring is above 48 KB: dynamic shared memory, opted in
  cudaError_t e = cudaSuccess;
  if (dtype == 0) {
    e = cudaFuncSetAttribute(ce_bwd_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ce_bwd_kernel<float><<<grid, kThreads, kRingBytes, s>>>(
        static_cast<const float*>(logits), t, l, gp,
        static_cast<float*>(dlogits), R, V, sb, sr, Rd, dsb, dsr);
  } else if (dtype == 1) {
    e = cudaFuncSetAttribute(ce_bwd_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ce_bwd_kernel<__nv_bfloat16><<<grid, kThreads, kRingBytes, s>>>(
        static_cast<const __nv_bfloat16*>(logits), t, l, gp,
        static_cast<__nv_bfloat16*>(dlogits), R, V, sb, sr, Rd, dsb, dsr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
