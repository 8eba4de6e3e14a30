// Row-wise norms for Hopper (sm_90a): RMSNorm (forward and backward) and
// LayerNorm, fp32 statistics, one cast back to x's dtype.
//
// Replaces: hyperion_tpu/ops/pallas/fused_norm.py
//   * `fused_rmsnorm` -> `_row_blocked_call` -> `_rms_kernel`: three
//     kernels here by row width and alignment (below);
//   * its gradient `_rms_bwd`, the `jax.vjp` of `_rms_reference` (no
//     Pallas there; XLA fuses it): `rmsnorm_bwd_kernel`, plus
//     `rmsnorm_dw_kernel` when the weight needs a gradient;
//   * `fused_layernorm` -> `_forward` -> `_row_blocked_call` -> `_kernel`
//     (with residual) / `_kernel_no_res` (without): two kernels here by
//     row width (below), each taking a null residual pointer.
//
// Bound on the H100: bytes. Per row the forwards read d inputs (2d with a
// residual) and write d outputs; the RMSNorm backward reads x and g and
// writes dx. Each does a handful of flops an element, far below the ~295
// flops per byte the card needs before compute could matter. The least
// time is the bytes moved over 3.35 TB/s: a [4096, 4096] bf16 RMSNorm
// moves 67 MB, ~20 us; its backward 101 MB, ~29 us.
//
// Design.
//   * RMSNorm forward, rows of whole 16-byte chunks with 16-byte-aligned
//     pointers (d % 8 == 0 in bf16, d % 4 == 0 in fp32): one HBM pass.
//     Each lane loads its 16-byte chunks of x once and keeps them in fp32
//     registers through the reduction; the weight's 16-byte loads are
//     issued with them, so they overlap the reduction; y goes out as
//     16-byte stores.
//       - Rows up to 1024 wide (`rmsnorm_warp_kernel`): a warp a row, 8
//         rows a block, the sum of squares by shuffles alone.
//       - Wider rows up to 16384 (`rmsnorm_block_kernel`): a block a row,
//         sized to the width (`lane_chunks`: at most kRmsBlockThreads
//         threads, so at most 8 chunks a lane in bf16 and 16 in fp32), the
//         warps' sums joined in one shared-memory step (`block_allsum`: one
//         barrier).
//     Other widths and misaligned views take `rmsnorm_kernel` (a block a
//     row, scalar loads, x read twice). `hyperion_rmsnorm_path` names the
//     kernel a call takes.
//   * RMSNorm backward (`rmsnorm_bwd_kernel`), with r = rsqrt(mean(x^2) +
//     eps), in fp32:
//         dx = r (w g) - x r^3 sum(w g x) / d        (one cast to x's dtype)
//         dw = sum over rows of g (x r)              (only when asked)
//     One pass: a row's x and g come in 16-byte loads and stay in
//     registers; sum(x^2) and sum(w g x) share one block reduction; dx is
//     written once. r is recomputed from x, so the forward saves nothing
//     new. For dw, block b takes a fixed range of rows and leaves its
//     partial sums in an fp32 [blocks, d] scratch, which
//     `rmsnorm_dw_kernel` adds up in a fixed order: no atomics, so reruns
//     are bit-identical. Other widths and misaligned views take
//     `rmsnorm_bwd_scalar_kernel` (scalar loads, x and g read twice, the
//     dw partials kept in the scratch row itself).
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
// Every kernel rounds the output op by op (__fmul_rn, __fadd_rn,
// __fsub_rn: no fused multiply-add), then casts once, as the reference
// does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16384;     // widest row any kernel here takes
constexpr int kWarpMaxD = 1024;  // widest row a warp-a-row kernel holds in registers
constexpr int kRowsPerBlock = kThreads / 32;
// target threads of a block-a-row RMSNorm block: the forward; the
// backward for dx alone (a block a row) and with dw (a block over a
// range of rows)
constexpr int kRmsBlockThreads = 256;
constexpr int kRmsBwdThreads = 256;
constexpr int kRmsBwdDwThreads = 512;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums of v[0..N) over the block, returned to every thread, with one
// barrier: each warp leaves its sums in `slots`, then every thread adds
// the warps' slots in warp order, so all threads (and every rerun) get the
// same bits. The slots may be written again only after a later barrier: a
// caller that reduces once a row alternates two slot sets.
template <int N>
__device__ __forceinline__ void block_allsum(float (&v)[N], float (*slots)[N]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) slots[warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.f;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += slots[i][k];
  }
}

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
// N fp32 values (N a multiple of 4) as 16-byte loads and stores
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + e);
    v[e] = f.x; v[e + 1] = f.y; v[e + 2] = f.z; v[e + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    *reinterpret_cast<float4*>(p + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline int round_warps(int t) { return (t + 31) / 32 * 32; }

// Most threads a block may have when each thread holds `floats` live fp32
// values in registers: 1024 threads leave 64 registers a thread, 512 leave
// 128, 256 leave 255.
__host__ __device__ constexpr int threads_bound(int floats) {
  return floats <= 40 ? 1024 : floats <= 96 ? 512 : 256;
}

// Chunks a lane for a block-a-row kernel over rows of n 16-byte chunks
// of `vec` elements, holding `per_elem` live floats an element: the
// fewest (a power of two) that keep the block within `target` threads
// and within threads_bound.
inline int lane_chunks(int n, int vec, int per_elem, int target) {
  int c = 1;
  for (;;) {
    const int t = round_warps((n + c - 1) / c);
    const int cap = threads_bound(per_elem * vec * c);
    if (t <= (target < cap ? target : cap)) return c;
    c *= 2;
  }
}

// the most chunks a lane can need: a kMaxD row over 256 threads
template <typename T>
constexpr int kMaxChunks = kMaxD / (256 * static_cast<int>(16 / sizeof(T)));

// ---------------------------------------------------------------- RMSNorm

// Any width or alignment: a block a row, scalar loads; pass 1 sums
// squares in fp32, pass 2 re-reads x (from L1/L2) and writes y.
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
    yr[i] = from_float<T>(__fmul_rn(__fmul_rn(to_float(xr[i]), r), w[i]));
  }
}

// One warp a row, kRowsPerBlock rows a block; lane `lane` holds the row's
// 16-byte chunks lane, lane + 32, ... (at most kChunks) and the weight's
// matching columns in fp32 registers.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // a whole warp: the shuffles below stay full
  const int n = d / kVec;
  const T* xr = x + r * d;
  T* yr = y + r * d;

  float v[kChunks][kVec], wv[kChunks][kVec];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch < n) {
      load16(xr + ch * kVec, v[i]);
      load_f32(w + ch * kVec, wv[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
  const float r_inv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch < n) {
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        out[e] = __fmul_rn(__fmul_rn(v[i][e], r_inv), wv[i][e]);
      }
      store16(yr + ch * kVec, out);
    }
  }
}

// One block a row; thread t holds the row's 16-byte chunks t, t +
// blockDim.x, ... (at most kChunks) and the weight's matching columns.
template <typename T, int kChunks>
__global__ void __launch_bounds__(threads_bound(2 * kChunks * static_cast<int>(16 / sizeof(T))))
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ y, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float slots[32][1];
  const int n = d / kVec;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float v[kChunks][kVec], wv[kChunks][kVec];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = threadIdx.x + i * blockDim.x;
    if (ch < n) {
      load16(xr + ch * kVec, v[i]);
      load_f32(w + ch * kVec, wv[i]);
    }
  }
  float ss[1] = {0.f};
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (threadIdx.x + i * blockDim.x < n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss[0] = fmaf(v[i][e], v[i][e], ss[0]);
    }
  }
  block_allsum<1>(ss, slots);
  const float r_inv = 1.f / sqrtf(ss[0] / (float)d + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = threadIdx.x + i * blockDim.x;
    if (ch < n) {
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        out[e] = __fmul_rn(__fmul_rn(v[i][e], r_inv), wv[i][e]);
      }
      store16(yr + ch * kVec, out);
    }
  }
}

// The backward over rows [blockIdx.x * rpb, + rpb) of whole 16-byte
// chunks, a block a row at a time: thread t holds chunks t, t +
// blockDim.x, ... of x and w g (and g itself only for dw).
// dx may be null (no dx wanted); with kDw the block's partial dw over its
// rows goes to row blockIdx.x of dw_part.
template <typename T, int kChunks, bool kDw>
__global__ void __launch_bounds__(
    threads_bound((kDw ? 4 : 2) * kChunks * static_cast<int>(16 / sizeof(T))))
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ dw_part, long long rows, int rpb, int d,
                   float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float slots[2][32][2];
  const int n = d / kVec;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;

  float acc[kDw ? kChunks : 1][kVec];
  if constexpr (kDw) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
    }
  }
  int buf = 0;
  for (long long r = r0; r < r1; ++r, buf ^= 1) {
    const T* xr = x + r * d;
    const T* gr = g + r * d;
    // the weight comes again each row (from L1 after the first), so a
    // thread keeps w g, not w and g, through the reduction
    float xv[kChunks][kVec], gv[kChunks][kVec], wg[kChunks][kVec];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = threadIdx.x + i * blockDim.x;
      if (ch < n) {
        load16(xr + ch * kVec, xv[i]);
        load16(gr + ch * kVec, gv[i]);
        load_f32(w + ch * kVec, wg[i]);
      }
    }
    float sums[2] = {0.f, 0.f};  // sum(x^2), sum(w g x)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (threadIdx.x + i * blockDim.x < n) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          wg[i][e] = __fmul_rn(wg[i][e], gv[i][e]);
          sums[0] = fmaf(xv[i][e], xv[i][e], sums[0]);
          sums[1] = fmaf(wg[i][e], xv[i][e], sums[1]);
        }
      }
    }
    block_allsum<2>(sums, slots[buf]);
    const float r_inv = 1.f / sqrtf(sums[0] / (float)d + eps);
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(r_inv, r_inv), r_inv),
                              sums[1] / (float)d);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = threadIdx.x + i * blockDim.x;
      if (ch < n) {
        if (dx != nullptr) {
          float out[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            out[e] = __fsub_rn(__fmul_rn(r_inv, wg[i][e]), __fmul_rn(xv[i][e], c));
          }
          store16(dx + r * d + ch * kVec, out);
        }
        if constexpr (kDw) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[i][e] = __fadd_rn(acc[i][e],
                                  __fmul_rn(gv[i][e], __fmul_rn(xv[i][e], r_inv)));
          }
        }
      }
    }
  }
  if constexpr (kDw) {
    float* part = dw_part + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = threadIdx.x + i * blockDim.x;
      if (ch < n) store_f32(part + ch * kVec, acc[i]);
    }
  }
}

// The backward for any width or alignment, scalar loads: per row, pass 1
// sums x^2 and w g x, pass 2 re-reads x and g (from L1/L2) and writes dx;
// each thread adds its columns' dw terms into its own slots of the
// block's scratch row (first row: written), the same order as
// rmsnorm_bwd_kernel's registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ dw_part, long long rows, int rpb,
                          int d, float eps) {
  __shared__ float slots[2][32][2];
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  float* part = dw_part == nullptr
      ? nullptr : dw_part + static_cast<long long>(blockIdx.x) * d;
  int buf = 0;
  for (long long r = r0; r < r1; ++r, buf ^= 1) {
    const T* xr = x + r * d;
    const T* gr = g + r * d;
    float sums[2] = {0.f, 0.f};
    for (int j = threadIdx.x; j < d; j += kThreads) {
      const float xv = to_float(xr[j]);
      sums[0] = fmaf(xv, xv, sums[0]);
      sums[1] = fmaf(__fmul_rn(w[j], to_float(gr[j])), xv, sums[1]);
    }
    block_allsum<2>(sums, slots[buf]);
    const float r_inv = 1.f / sqrtf(sums[0] / (float)d + eps);
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(r_inv, r_inv), r_inv),
                              sums[1] / (float)d);
    for (int j = threadIdx.x; j < d; j += kThreads) {
      const float xv = to_float(xr[j]);
      const float gv = to_float(gr[j]);
      if (dx != nullptr) {
        dx[r * d + j] = from_float<T>(
            __fsub_rn(__fmul_rn(r_inv, __fmul_rn(w[j], gv)), __fmul_rn(xv, c)));
      }
      if (part != nullptr) {
        const float t = __fmul_rn(gv, __fmul_rn(xv, r_inv));
        part[j] = r == r0 ? t : __fadd_rn(part[j], t);
      }
    }
  }
}

// dw[j] = the sum over b of dw_part[b][j], b in a fixed order: a block
// takes 32 columns, its 8 warps rows b = warp, warp + 8, ..., then warp
// 0 adds the 8 sums in warp order.
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, float* __restrict__ dw,
                  int blocks, int d) {
  __shared__ float sums[kThreads / 32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < d) {
    for (int b = warp; b < blocks; b += kThreads / 32) {
      acc += dw_part[static_cast<long long>(b) * d + col];
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += sums[i][lane];
    dw[col] = t;
  }
}

__global__ void empty_kernel() {}

// 2: rmsnorm_block_kernel, 1: rmsnorm_warp_kernel (rows of whole 16-byte
// chunks, every pointer 16-byte aligned, wider or not than kWarpMaxD),
// 0: rmsnorm_kernel
template <typename T>
int rms_path(const void* x, const void* w, const void* y, int d) {
  if (d % (16 / sizeof(T)) != 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(y)) {
    return 0;
  }
  return d <= kWarpMaxD ? 1 : 2;
}

// 1: rmsnorm_bwd_kernel (16-byte chunks; a null dx is aligned), 0: the
// scalar kernel
template <typename T>
int rms_bwd_path(const void* x, const void* w, const void* g, const void* dx,
                 int d) {
  return d % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(w) &&
         aligned16(g) && aligned16(dx);
}

template <typename T, int kChunks>
cudaError_t launch_rms_warp(const void* x, const void* w, void* y,
                            long long rows, int d, float eps, cudaStream_t s) {
  constexpr int kMax = kWarpMaxD / (32 * (16 / sizeof(T)));
  const int chunks = (d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
  if constexpr (kChunks < kMax) {
    if (chunks > kChunks) {
      return launch_rms_warp<T, 2 * kChunks>(x, w, y, rows, d, eps, s);
    }
  }
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  rmsnorm_warp_kernel<T, kChunks><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, int kChunks>
cudaError_t launch_rms_block(const void* x, const void* w, void* y,
                             long long rows, int d, float eps, int chunks,
                             cudaStream_t s) {
  if constexpr (kChunks < kMaxChunks<T>) {
    if (chunks > kChunks) {
      return launch_rms_block<T, 2 * kChunks>(x, w, y, rows, d, eps, chunks, s);
    }
  }
  const int n = d / static_cast<int>(16 / sizeof(T));
  const int threads = round_warps((n + kChunks - 1) / kChunks);
  rmsnorm_block_kernel<T, kChunks><<<static_cast<unsigned>(rows), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rmsnorm(const void* x, const void* w, void* y,
                           long long rows, int d, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  switch (rms_path<T>(x, w, y, d)) {
    case 1:
      return launch_rms_warp<T, 1>(x, w, y, rows, d, eps, s);
    case 2:
      return launch_rms_block<T, 1>(
          x, w, y, rows, d, eps, lane_chunks(d / kVec, kVec, 2, kRmsBlockThreads),
          s);
    default:
      rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<T*>(y), d, eps);
      return cudaGetLastError();
  }
}

template <typename T, int kChunks, bool kDw>
cudaError_t launch_rms_bwd_vec(const void* x, const void* w, const void* g,
                               void* dx, float* dw_part, long long rows,
                               int rpb, int d, float eps, int chunks,
                               cudaStream_t s) {
  if constexpr (kChunks < kMaxChunks<T>) {
    if (chunks > kChunks) {
      return launch_rms_bwd_vec<T, 2 * kChunks, kDw>(
          x, w, g, dx, dw_part, rows, rpb, d, eps, chunks, s);
    }
  }
  const int n = d / static_cast<int>(16 / sizeof(T));
  const int threads = round_warps((n + kChunks - 1) / kChunks);
  const unsigned grid = static_cast<unsigned>((rows + rpb - 1) / rpb);
  rmsnorm_bwd_kernel<T, kChunks, kDw><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, rows, rpb, d,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rmsnorm_bwd(const void* x, const void* w, const void* g,
                               void* dx, float* dw_part, float* dw,
                               long long rows, int rpb, int d, float eps,
                               cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool want_dw = dw != nullptr;
  const unsigned grid = static_cast<unsigned>((rows + rpb - 1) / rpb);
  cudaError_t e;
  if (rms_bwd_path<T>(x, w, g, dx, d)) {
    const int chunks =
        lane_chunks(d / kVec, kVec, want_dw ? 4 : 2,
                    want_dw ? kRmsBwdDwThreads : kRmsBwdThreads);
    e = want_dw
        ? launch_rms_bwd_vec<T, 1, true>(x, w, g, dx, dw_part, rows, rpb, d,
                                         eps, chunks, s)
        : launch_rms_bwd_vec<T, 1, false>(x, w, g, dx, nullptr, rows, rpb, d,
                                          eps, chunks, s);
  } else {
    rmsnorm_bwd_scalar_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const T*>(g), static_cast<T*>(dx),
        want_dw ? dw_part : nullptr, rows, rpb, d, eps);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || !want_dw) return e;
  rmsnorm_dw_kernel<<<static_cast<unsigned>((d + 31) / 32), kThreads, 0, s>>>(
      dw_part, dw, static_cast<int>(grid), d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- LayerNorm

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

// dtype: 0 = float32, 1 = bfloat16. x, y: [rows, d] contiguous; w: [d]
// fp32; d <= 16384. Launches the kernel hyperion_rmsnorm_path names.
extern "C" int hyperion_fused_rmsnorm(const void* x, const void* w, void* y,
                                      long long rows, int d, float eps,
                                      int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_rmsnorm<float>(x, w, y, rows, d, eps, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch_rmsnorm<__nv_bfloat16>(x, w, y, rows, d, eps, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which RMSNorm forward kernel hyperion_fused_rmsnorm launches for these
// arguments: 2 rmsnorm_block_kernel, 1 rmsnorm_warp_kernel, 0
// rmsnorm_kernel, -1 an unknown dtype.
extern "C" int hyperion_rmsnorm_path(const void* x, const void* w,
                                     const void* y, int d, int dtype) {
  if (dtype == 0) return rms_path<float>(x, w, y, d);
  if (dtype == 1) return rms_path<__nv_bfloat16>(x, w, y, d);
  return -1;
}

// The RMSNorm backward. dtype: 0 = float32, 1 = bfloat16. x, g, dx:
// [rows, d] contiguous in dtype, dx null when no dx is wanted; w: [d]
// fp32; d <= 16384. Block b takes rows [b * rows_per_block, + rows_per_block).
// dw: [d] fp32, or null when no dw is wanted; then dw_part is an fp32
// scratch of [ceil(rows / rows_per_block), d], fully written before it is
// read.
extern "C" int hyperion_rmsnorm_bwd(const void* x, const void* w,
                                    const void* g, void* dx, void* dw_part,
                                    void* dw, long long rows,
                                    int rows_per_block, int d, float eps,
                                    int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kMaxD || rows_per_block <= 0 ||
      (dw != nullptr && dw_part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 0) {
    return static_cast<int>(launch_rmsnorm_bwd<float>(
        x, w, g, dx, part, dwf, rows, rows_per_block, d, eps, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_rmsnorm_bwd<__nv_bfloat16>(
        x, w, g, dx, part, dwf, rows, rows_per_block, d, eps, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which RMSNorm backward kernel hyperion_rmsnorm_bwd launches: 1
// rmsnorm_bwd_kernel, 0 rmsnorm_bwd_scalar_kernel, -1 an unknown dtype.
extern "C" int hyperion_rmsnorm_bwd_path(const void* x, const void* w,
                                         const void* g, const void* dx, int d,
                                         int dtype) {
  if (dtype == 0) return rms_bwd_path<float>(x, w, g, dx, d);
  if (dtype == 1) return rms_bwd_path<__nv_bfloat16>(x, w, g, dx, d);
  return -1;
}

// An empty kernel of `blocks` x `threads`: the launch floor a small
// kernel's time is read against.
extern "C" int hyperion_norm_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
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
