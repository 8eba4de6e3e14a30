// Weight-only int8 inference for Hopper (sm_90a): the per-row symmetric
// quantizer and the int8 x int8 -> int32 product with its dequant
// epilogue.
//
// Replaces no Pallas kernel. The reference computes these in XLA:
// `quantize_int8` (hyperion_tpu/precision/quant.py:47-62) as fused
// elementwise ops and `int8_matmul` (:69-85) as a `dot_general` into
// int32 with the dequant multiply fused into its output. The port needs
// kernels of its own because the library's int8 product (`torch._int_mm`)
// refuses M <= 16, which is every decode step, and would write the int32
// product to device memory before a separate epilogue read it back.
//
//  * quantize_rows_kernel: a block a row of x [rows, K] (fp32, bf16 or
//    fp16, contiguous along K). The row's fp32 amax (a max, so the order
//    of the reduction cannot change it), then scale = max(amax, 1e-8) /
//    127 and q = clip(rint(x / scale), -127, 127), both true IEEE
//    divisions and round-half-to-even, as the plain version and the
//    reference compute them: the bits are the same. Bound: bytes (the
//    row read twice, the second time from L1/L2; one int8 write).
//  * int8_matmul_kernel: out[m, n] = (float(acc) * sx[m]) * sw[n] rounded
//    to the output dtype, plus bias[n] rounded to that dtype, with
//    acc = sum_k xq[m, k] * wq[n, k] exact in int32. wq is [N, K], the
//    port's [out, in] weight layout, which is exactly the "col" operand
//    of mma.sync.m16n8k32.s32.s8.s8.s32. Tiles of both operands are
//    staged through shared memory by cp.async (16 bytes a thread, zero
//    fill past M, N and K) in a ring of stages; fragments are 32-bit
//    loads from rows padded by 16 bytes, so the 8 rows a fragment load
//    touches fall in distinct banks. The epilogue runs in registers
//    (__fmul_rn/__fadd_rn: no contraction into an FMA), so the int32
//    accumulator never reaches device memory. Two tile shapes:
//      - "decode" (M <= 16): a 16 x 32 output tile a block of 4 warps,
//        each warp a quarter of every 128-byte K stage, the four int32
//        partials summed in shared memory (exact). Decode is bound by
//        the weight's bytes: narrow N tiles put 128 blocks in flight for
//        N = 4096 and 344 for 11008.
//      - "prefill" (M > 16): a 64 x 128 tile a block of 8 warps (2 x 4),
//        32 x 32 a warp, 64-byte K stages.
//    K not a multiple of 16 (or an operand off the 16-byte grid) takes
//    the same kernels with byte loads instead of cp.async.
// Later work (ROADMAP B): wgmma on s8 operands, TMA, and a split-K for
// decode's skinny M.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int K) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kQuantThreads) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float red[kQuantThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = __fdiv_rn(fmaxf(amax, kEps), 127.0f);
  if (threadIdx.x == 0) scale[row] = s;
  int8_t* qr = q + row * K;
  for (int i = threadIdx.x; i < K; i += kQuantThreads) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(to_f32(xr[i]), s)), -127.f), 127.f);
    qr[i] = static_cast<int8_t>(static_cast<int>(v));
  }
}

// ------------------------------------------------------------ the product

template <int BM_, int BN_, int BK_, int WM_, int WN_, int WK_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, WK = WK_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN * WK;
  static constexpr int kStride = BK + 16;  // bytes a staged row
  static constexpr int TM = BM / WM, TN = BN / WN, KS = BK / WK;
  static constexpr int MT = TM / 16, NT = TN / 8, KSTEPS = KS / 32;
  static constexpr int kStageBytes = (BM + BN) * kStride;
  static constexpr int kPipeBytes = STAGES * kStageBytes;
  static constexpr int kRedBytes = (WK - 1) * WM * WN * MT * NT * 4 * 32 * 4;
  static constexpr int kSmemBytes = kPipeBytes > kRedBytes ? kPipeBytes : kRedBytes;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && KS % 32 == 0, "tile shape");
};

using DecodeCfg = Cfg<16, 32, 128, 1, 1, 4, 4>;
using PrefillCfg = Cfg<64, 128, 64, 2, 4, 1, 3>;
constexpr int kDecodeMaxM = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// rows [row0, row0 + R) x bytes [k0, k0 + BK) of g [rows_total, K] into
// sm (row stride C::kStride), zeros outside the tensor
template <class C, int R, bool VEC>
__device__ __forceinline__ void load_tile(uint8_t* sm, const int8_t* __restrict__ g,
                                          int rows_total, int row0, int K, int k0) {
  if constexpr (VEC) {
    constexpr int kChunks = R * C::BK / 16;
    for (int c = threadIdx.x; c < kChunks; c += C::kThreads) {
      const int r = c / (C::BK / 16), col = (c % (C::BK / 16)) * 16;
      const int gr = row0 + r, gk = k0 + col;
      const bool in = gr < rows_total && gk < K;  // K % 16 == 0: whole chunks
      const int8_t* src = in ? g + static_cast<int64_t>(gr) * K + gk : g;
      cp_async16(sm + r * C::kStride + col, src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * C::BK; i += C::kThreads) {
      const int r = i / C::BK, col = i % C::BK;
      const int gr = row0 + r, gk = k0 + col;
      sm[r * C::kStride + col] = (gr < rows_total && gk < K)
                                     ? static_cast<uint8_t>(g[static_cast<int64_t>(gr) * K + gk])
                                     : uint8_t{0};
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_out(float* out, float v, const float* bias, int n) {
  *out = bias ? __fadd_rn(v, bias[n]) : v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, float v, const float* bias, int n) {
  __nv_bfloat16 o = __float2bfloat16_rn(v);
  if (bias) {
    // the reference's order: round the product to the output dtype, then
    // add the bias rounded to it
    o = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(o), __bfloat162float(__float2bfloat16_rn(bias[n]))));
  }
  *out = o;
}

template <class C, bool VEC, typename TO>
__global__ void __launch_bounds__(C::kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_tiles = (N + C::BN - 1) / C::BN;
  const int m0 = (blockIdx.x / n_tiles) * C::BM, n0 = (blockIdx.x % n_tiles) * C::BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wmn = warp % (C::WM * C::WN), wk = warp / (C::WM * C::WN);
  const int wm = wmn / C::WN, wn = wmn % C::WN;
  const int KT = (K + C::BK - 1) / C::BK;

  int32_t acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto load_stage = [&](int stage, int kt) {
    uint8_t* as = smem + stage * C::kStageBytes;
    load_tile<C, C::BM, VEC>(as, xq, M, m0, K, kt * C::BK);
    load_tile<C, C::BN, VEC>(as + C::BM * C::kStride, wq, N, n0, K, kt * C::BK);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for everyone
    const int next = kt + C::STAGES - 1;
    if (next < KT) load_stage(next % C::STAGES, next);
    cp_async_commit();
    const uint8_t* as = smem + (kt % C::STAGES) * C::kStageBytes;
    const uint8_t* bs = as + C::BM * C::kStride;
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      const int kk = wk * C::KS + ks * 32 + t * 4;
      uint32_t a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const uint8_t* p = as + (wm * C::TM + i * 16 + g) * C::kStride + kk;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * C::kStride);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * C::kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const uint8_t* p = bs + (wn * C::TN + j * 8 + g) * C::kStride + kk;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  if constexpr (C::WK > 1) {
    // the K-split warps' partials, summed exactly in int32
    cp_async_wait<0>();
    __syncthreads();
    int32_t* red = reinterpret_cast<int32_t*>(smem);
    constexpr int kVals = C::MT * C::NT * 4;
    if (wk > 0) {
      int32_t* dst = red + ((wk - 1) * C::WM * C::WN + wmn) * kVals * 32;
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) dst[((i * C::NT + j) * 4 + r) * 32 + lane] = acc[i][j][r];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < C::WK; ++w) {
      const int32_t* src = red + ((w - 1) * C::WM * C::WN + wmn) * kVals * 32;
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += src[((i * C::NT + j) * 4 + r) * 32 + lane];
    }
  }

#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * C::TM + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * C::TN + j * 8 + t * 2 + (r & 1);
        if (m < M && n < N) {
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][r]), sx[m]), sw[n]);
          store_out(out + static_cast<int64_t>(m) * N + n, v, bias, n);
        }
      }
}

template <class C, bool VEC, typename TO>
cudaError_t launch_mm(const void* xq, const void* wq, const void* sx, const void* sw,
                      const void* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((M + C::BM - 1) / C::BM) *
                           ((N + C::BN - 1) / C::BN);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  int8_matmul_kernel<C, VEC, TO><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

template <class C, typename TO>
cudaError_t dispatch_vec(bool vec, const void* xq, const void* wq, const void* sx, const void* sw,
                         const void* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  return vec ? launch_mm<C, true, TO>(xq, wq, sx, sw, bias, out, M, N, K, stream)
             : launch_mm<C, false, TO>(xq, wq, sx, sw, bias, out, M, N, K, stream);
}

template <class C>
const void* mm_fn(bool vec, int out_dtype) {
  if (out_dtype == 0)
    return vec ? reinterpret_cast<const void*>(int8_matmul_kernel<C, true, float>)
               : reinterpret_cast<const void*>(int8_matmul_kernel<C, false, float>);
  return vec ? reinterpret_cast<const void*>(int8_matmul_kernel<C, true, __nv_bfloat16>)
             : reinterpret_cast<const void*>(int8_matmul_kernel<C, false, __nv_bfloat16>);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t.
extern "C" int hyperion_quantize_rows(const void* x, void* q, void* scale, long long rows, int K,
                                      int dtype, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || K <= 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scale);
  switch (dtype) {
    case 0: quantize_rows_kernel<<<grid, kQuantThreads, 0, s>>>(static_cast<const float*>(x), qp, sp, K); break;
    case 1: quantize_rows_kernel<<<grid, kQuantThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), qp, sp, K); break;
    case 2: quantize_rows_kernel<<<grid, kQuantThreads, 0, s>>>(static_cast<const __half*>(x), qp, sp, K); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// 0: the decode tile (M <= 16), 1: the prefill tile
extern "C" int hyperion_int8_matmul_path(int M) { return M <= kDecodeMaxM ? 0 : 1; }

// whether this call streams its operands by cp.async (1) or by bytes (0)
extern "C" int hyperion_int8_matmul_vec(const void* xq, const void* wq, int K) {
  return (K % 16 == 0 && aligned16(xq) && aligned16(wq)) ? 1 : 0;
}

// out_dtype: 0 float32, 1 bfloat16. bias may be null.
extern "C" int hyperion_int8_matmul(const void* xq, const void* wq, const void* sx, const void* sw,
                                    const void* bias, void* out, int M, int N, int K, int out_dtype,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || out_dtype < 0 || out_dtype > 1) return cudaErrorInvalidValue;
  const bool vec = hyperion_int8_matmul_vec(xq, wq, K) == 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (M <= kDecodeMaxM) {
    e = out_dtype == 0 ? dispatch_vec<DecodeCfg, float>(vec, xq, wq, sx, sw, bias, out, M, N, K, s)
                       : dispatch_vec<DecodeCfg, __nv_bfloat16>(vec, xq, wq, sx, sw, bias, out, M, N, K, s);
  } else {
    e = out_dtype == 0 ? dispatch_vec<PrefillCfg, float>(vec, xq, wq, sx, sw, bias, out, M, N, K, s)
                       : dispatch_vec<PrefillCfg, __nv_bfloat16>(vec, xq, wq, sx, sw, bias, out, M, N, K, s);
  }
  return static_cast<int>(e);
}

// What the compiler gave a kernel. which: 0 quantize_rows (dtype = its
// input's), 1 the decode product, 2 the prefill product (dtype = the
// output's; vec = cp.async or bytes). out = {registers a thread, local
// (spill) bytes a thread, shared memory a block, threads a block}.
extern "C" int hyperion_int8_attrs(int which, int dtype, int vec, int* out) {
  const void* fn = nullptr;
  int smem = 0, threads = 0;
  if (which == 0) {
    fn = dtype == 0 ? reinterpret_cast<const void*>(quantize_rows_kernel<float>)
         : dtype == 1 ? reinterpret_cast<const void*>(quantize_rows_kernel<__nv_bfloat16>)
                      : reinterpret_cast<const void*>(quantize_rows_kernel<__half>);
    threads = kQuantThreads;
  } else if (which == 1) {
    fn = mm_fn<DecodeCfg>(vec != 0, dtype);
    smem = DecodeCfg::kSmemBytes;
    threads = DecodeCfg::kThreads;
  } else {
    fn = mm_fn<PrefillCfg>(vec != 0, dtype);
    smem = PrefillCfg::kSmemBytes;
    threads = PrefillCfg::kThreads;
  }
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes) + smem;
  out[3] = threads;
  return 0;
}
