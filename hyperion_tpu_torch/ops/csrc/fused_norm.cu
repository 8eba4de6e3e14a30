// Row-wise norms for Hopper (sm_90a): RMSNorm and LayerNorm, fp32
// statistics, one cast back to x's dtype.
//
// Replaces: hyperion_tpu/ops/pallas/fused_norm.py
//   * `fused_rmsnorm` -> `_row_blocked_call` -> `_rms_kernel`;
//   * `fused_layernorm` -> `_forward` -> `_row_blocked_call` -> `_kernel`
//     (with residual) / `_kernel_no_res` (without): two kernels here by
//     row width (below), each taking a null residual pointer.
//
// Bound on the H100: bytes. Per row each reads d inputs (2d with a
// residual) and writes d outputs, doing ~4 (RMS) or ~9 (Layer) flops an
// element, far below the ~295 flops per byte the card needs before
// compute could matter. The least time is the bytes moved over
// 3.35 TB/s: a [4096, 256] bf16 LayerNorm moves 4.2 MB, ~1.3 us.
//
// Design.
//   * RMSNorm: one block per row, so a row's sum of squares is a block
//     reduction (warp shuffles, then one shared-memory step); pass 1 sums
//     squares in fp32, pass 2 re-reads x (from L1/L2: a 4096-wide bf16 row
//     is 8 KB) and writes y.
//   * LayerNorm, rows up to 1024 wide of whole 16-byte chunks, every
//     pointer 16-byte aligned (`layernorm_warp_kernel`; language_ddp's
//     [4096, 256]): one warp per row, 8 rows a 256-thread block. Each lane
//     loads its 16-byte chunks of x (and the residual, added as it
//     arrives), coalesced across the warp, and keeps them in fp32
//     registers (at most 32 a lane); the mean and then the squared
//     deviations from it — the reference's two-pass variance, not
//     E[x^2] - E[x]^2 — are summed with warp shuffles alone: no shared
//     memory, no block barrier. w and b come as 16-byte loads (the same
//     columns every row, so from L1), y goes out as 16-byte stores. At
//     d = 256 a lane holds one chunk (8 bf16) and HBM sees each byte once.
//   * LayerNorm, any other call (`layernorm_kernel`: wider rows up to
//     16384, widths of no whole 16-byte chunk, misaligned views): one block
//     per row; pass 1 stages x (+ residual) in fp32 in shared memory (d
//     floats, at most 64 KB) and sums it, pass 2 sums squared deviations
//     over the staged row, pass 3 writes (x - mean) * rsqrt(var + eps) * w
//     + b. Its two block reductions dominate at narrow widths, which is why
//     narrow rows take the warp kernel.
// Both LayerNorm kernels round the output op by op (__fmul_rn, __fadd_rn),
// then cast once, as the reference does.

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

// ------------------------------------------------- LayerNorm, a warp a row

constexpr int kWarpMaxD = 1024;  // widest row the warp kernel holds in registers
constexpr int kRowsPerBlock = kThreads / 32;

// 16 bytes of T (8 bf16 or 4 fp32) to and from fp32
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp a row, kRowsPerBlock rows a block. Lane `lane` holds the row's
// 16-byte chunks lane, lane + 32, ... (at most kChunks) in fp32 registers:
// every load and store is one coalesced 16-byte access a lane, and both
// sums are warp shuffles, with no shared memory and no block barrier.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
layernorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const float* __restrict__ w, const float* __restrict__ b,
                      T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // a whole warp: the shuffles below stay full
  const int n = d / kVec;  // chunks a row
  const T* xr = x + r * d;
  const T* rr = res == nullptr ? nullptr : res + r * d;
  T* yr = y + r * d;

  float v[kChunks][kVec];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch < n) {
      load16(xr + ch * kVec, v[i]);
      if (rr != nullptr) {
        float t[kVec];
        load16(rr + ch * kVec, t);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[i][e] += t[e];
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += v[i][e];
    }
  }
  const float mean = warp_sum(s) / (float)d;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float c = v[i][e] - mean;
        ss = fmaf(c, c, ss);
      }
    }
  }
  const float inv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch < n) {
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + ch * kVec + e);
        const float4 b4 = *reinterpret_cast<const float4*>(b + ch * kVec + e);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // rounded op by op, as in layernorm_kernel
          const float t = __fmul_rn(__fmul_rn(v[i][e + f] - mean, inv), wv[f]);
          out[e + f] = __fadd_rn(t, bv[f]);
        }
      }
      store16(yr + ch * kVec, out);
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the warp kernel takes rows of whole 16-byte chunks, up to kWarpMaxD
// wide, with every pointer 16-byte aligned (a null residual is); any
// other call takes layernorm_kernel
template <typename T>
bool warp_path(const void* x, const void* res, const void* w, const void* b,
               const void* y, int d) {
  return d % (16 / sizeof(T)) == 0 && d <= kWarpMaxD && aligned16(x) &&
         aligned16(res) && aligned16(w) && aligned16(b) && aligned16(y);
}

template <typename T, int kChunks>
cudaError_t launch_layernorm_warp(const void* x, const void* res,
                                  const void* w, const void* b, void* y,
                                  long long rows, int d, float eps,
                                  cudaStream_t s) {
  constexpr int kMax = kWarpMaxD / (32 * (16 / sizeof(T)));
  const int chunks = (d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
  if constexpr (kChunks < kMax) {
    if (chunks > kChunks) {
      return launch_layernorm_warp<T, 2 * kChunks>(x, res, w, b, y, rows, d,
                                                   eps, s);
    }
  }
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layernorm_warp_kernel<T, kChunks><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

// ------------------------------------------- LayerNorm, a block a row

template <typename T>
cudaError_t launch_layernorm(const void* x, const void* res, const void* w,
                             const void* b, void* y, long long rows, int d,
                             float eps, cudaStream_t s) {
  if (warp_path<T>(x, res, w, b, y, d)) {
    return launch_layernorm_warp<T, 1>(x, res, w, b, y, rows, d, eps, s);
  }
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
// [rows, d] contiguous in dtype; w, b: [d] fp32; d <= 16384. Launches
// layernorm_warp_kernel where hyperion_layernorm_path says so, else
// layernorm_kernel.
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

// Which LayerNorm kernel hyperion_fused_layernorm launches for these
// arguments: 1 the warp-a-row kernel, 0 the block-a-row kernel, -1 an
// unknown dtype.
extern "C" int hyperion_layernorm_path(const void* x, const void* residual,
                                       const void* w, const void* b,
                                       const void* y, int d, int dtype) {
  if (dtype == 0) return warp_path<float>(x, residual, w, b, y, d) ? 1 : 0;
  if (dtype == 1) return warp_path<__nv_bfloat16>(x, residual, w, b, y, d) ? 1 : 0;
  return -1;
}
