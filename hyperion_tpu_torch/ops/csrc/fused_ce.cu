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
// train step ([32*127, 50257] fp32) that is 817 MB, 0.244 ms, forward and
// 1.63 GB, 0.488 ms, backward at 3.35 TB/s.
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
//   * The backward is one block per row writing (exp(x - lse) - [j == t])
//     * g in fp32, cast once to the logits' dtype, into a contiguous
//     [B, R, V] output; each thread has 8 strided loads in flight before
//     its first store.
// Targets arrive int32 and in [0, V): the wrapper checks both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, int R, int V, int64_t sb, int64_t sr) {
  const int64_t n = blockIdx.x;
  const T* xr = row_ptr(logits, n, R, sb, sr);
  T* dr = dlogits + n * V;
  const float l = lse[n], gn = g[n];
  const int t = targets[n];
  // kChunk loads in flight before the first store, as in the forward
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
      if (j < V) dr[j] = from_float<T>((expf(v[k] - l) - (j == t ? 1.f : 0.f)) * gn);
    }
  }
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

// As the forward, plus lse, g: [B*R] fp32 and dlogits: [B*R, V]
// contiguous in the logits' dtype.
extern "C" int hyperion_fused_ce_bwd(const void* logits, const void* targets,
                                     const void* lse, const void* g,
                                     void* dlogits, int B, int R, int V,
                                     long long sb, long long sr, int dtype,
                                     void* stream) {
  const long long rows = static_cast<long long>(B) * R;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(rows));
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0) {
    ce_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), t, l, gp,
        static_cast<float*>(dlogits), R, V, sb, sr);
  } else if (dtype == 1) {
    ce_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), t, l, gp,
        static_cast<__nv_bfloat16*>(dlogits), R, V, sb, sr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
