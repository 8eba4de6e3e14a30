// Row-wise norms for Hopper (sm_90a): RMSNorm and LayerNorm, fp32
// statistics, one cast back to x's dtype.
//
// Replaces: hyperion_tpu/ops/pallas/fused_norm.py
//   * `fused_rmsnorm` -> `_row_blocked_call` -> `_rms_kernel`;
//   * `fused_layernorm` -> `_forward` -> `_row_blocked_call` -> `_kernel`
//     (with residual) / `_kernel_no_res` (without): one kernel here, the
//     residual pointer may be null.
//
// Bound on the H100: bytes. Per row each reads d inputs (2d with a
// residual) and writes d outputs, doing ~4 (RMS) or ~9 (Layer) flops an
// element, far below the ~295 flops per byte the card needs before
// compute could matter. The least time is the bytes moved over
// 3.35 TB/s: a [4096, 256] bf16 LayerNorm moves 4.2 MB, ~1.3 us.
//
// Design: one block per row, so a row's sums are block reductions (warp
// shuffles, then one shared-memory step) and no row crosses blocks.
// Loads are coalesced: thread i touches elements i, i + blockDim, ...
//   * RMSNorm: pass 1 sums squares in fp32; pass 2 re-reads x (from
//     L1/L2: a 4096-wide bf16 row is 8 KB) and writes y.
//   * LayerNorm: pass 1 stages x (+ residual) in fp32 in shared memory
//     (d floats, at most 64 KB for d = 16384) and sums it; pass 2 sums
//     squared deviations from the mean over the staged row — the
//     reference's two-pass variance, not E[x^2] - E[x]^2; pass 3 writes
//     (x - mean) * rsqrt(var + eps) * w + b. HBM sees each input once.
// Vectorised 16-byte loads and several rows a block for narrow rows
// (d = 256 leaves most of a 256-thread block's time in its two
// reductions) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Sum of `v` over the block, returned to every thread. Safe to call
// back to back: the trailing barrier keeps the next call's writes off
// the shared slots until every thread has read this one's total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float v = to_float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float r = 1.f / sqrtf(block_sum(ss) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_float<T>(to_float(xr[i]) * r * w[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ w, const float* __restrict__ b,
                 T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];  // d floats: x (+ residual) in fp32
  const int64_t r = blockIdx.x;
  const T* xr = x + r * d;
  const T* rr = res == nullptr ? nullptr : res + r * d;
  T* yr = y + r * d;

  // each thread reads back only the slots it wrote, so the staging
  // needs no barrier of its own
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float v = to_float(xr[i]);
    if (rr != nullptr) v += to_float(rr[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s) / (float)d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = row[i] - mean;
    ss = fmaf(c, c, ss);
  }
  const float inv = 1.f / sqrtf(block_sum(ss) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    // rounded op by op, as the reference's (x - mean) * inv * w + b is:
    // no fused multiply-add where the output cancels towards zero
    const float t = __fmul_rn(__fmul_rn(row[i] - mean, inv), w[i]);
    yr[i] = from_float<T>(__fadd_rn(t, b[i]));
  }
}

template <typename T>
cudaError_t launch_layernorm(const void* x, const void* res, const void* w,
                             const void* b, void* y, long long rows, int d,
                             float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    cudaError_t e = cudaFuncSetAttribute(
        layernorm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  layernorm_kernel<T><<<dim3(static_cast<unsigned>(rows)), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: [rows, d] contiguous; w: [d] fp32.
extern "C" int hyperion_fused_rmsnorm(const void* x, const void* w, void* y,
                                      long long rows, int d, float eps,
                                      int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(rows));
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(y), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. x, residual (may be null), y:
// [rows, d] contiguous in dtype; w, b: [d] fp32; d <= 16384.
extern "C" int hyperion_fused_layernorm(const void* x, const void* residual,
                                        const void* w, const void* b, void* y,
                                        long long rows, int d, float eps,
                                        int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch_layernorm<float>(x, residual, w, b, y, rows, d, eps, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_layernorm<__nv_bfloat16>(
        x, residual, w, b, y, rows, d, eps, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
