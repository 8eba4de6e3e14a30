// The card's wgmma TF32 rate at small N: m64nNk8 products (A from
// registers, B read K-major from shared memory under the 128-byte swizzle,
// fp32 accumulators), issued back to back with no other work by two
// warpgroups a block, one block an SM on every SM: the shape of the fp32
// D 256 flash backward's logit products (`wgmma_abt` in
// hyperion_tpu_torch/ops/csrc/flash_attention.cu: N 16 and 32, M 64, two
// warpgroups). Each case runs with one accumulator (every product depends
// on the one before) and with several independent ones, and the backward's
// own pair (an n32 and an n16 product a k-step, two accumulators).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/wgmma_tf32_rate scripts/wgmma_tf32_rate.cu && build/wgmma_tf32_rate
//
// Prints one line a case: N, accumulators, TFLOP/s over the card, and
// cycles a product on one SM at the SM clock it reads from the device.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "../hyperion_tpu_torch/ops/csrc/sm90.cuh"

namespace {

// d[64 x 64] += A[64 x 8] . B[8 x 64] in TF32, as wgmma_m64n16k8_tf32_rs
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void product(float (&d)[N / 2], const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (N == 16) sm90::wgmma_m64n16k8_tf32_rs(d, a, db);
  if constexpr (N == 32) sm90::wgmma_m64n32k8_tf32_rs(d, a, db);
  if constexpr (N == 64) wgmma_m64n64k8_tf32_rs(d, a, db);
}

// kAcc products of N a step (into kAcc accumulators), or with kPair the
// backward's n32 + n16 pair; a commit group a step, at most 4 in flight
template <int N, int kAcc, bool kPair>
__global__ void __launch_bounds__(256, 1) wgmma_loop(float* out, int iters) {
  __shared__ __align__(1024) uint32_t b[64 * 32];  // 64 rows of 128 bytes
  for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x) {
    b[i] = __float_as_uint(1.f / (1 + (i & 7)));
  }
  sm90::fence_async_smem();
  __syncthreads();
  float d[kAcc][N / 2];
  float e[16];  // the pair's n32 accumulator
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[j][i] = 0.f;
    sm90::fence_regs(d[j]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) e[i] = 0.f;
  sm90::fence_regs(e);
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x * 1e-3f + i);
  const uint64_t db = sm90::desc_sw128(sm90::smem_u32(b), 16, 1024);
  sm90::wgmma_fence();
  for (int it = 0; it < iters; ++it) {
    if constexpr (kPair) {
      sm90::wgmma_m64n32k8_tf32_rs(e, a, db);
      sm90::wgmma_m64n16k8_tf32_rs(d[0], a, db);
    } else {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) product<N>(d[j], a, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<4>();
  }
  sm90::wgmma_wait<0>();
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    sm90::fence_regs(d[j]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s += d[j][i];
  }
  sm90::fence_regs(e);
#pragma unroll
  for (int i = 0; i < 16; ++i) s += e[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, int kAcc, bool kPair = false>
void run(int sms, float ghz) {
  const int iters = 8192;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * 256);
  wgmma_loop<N, kAcc, kPair><<<sms, 256>>>(out, 16);  // warm up
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  wgmma_loop<N, kAcc, kPair><<<sms, 256>>>(out, iters);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  // products an SM: two warpgroups
  const double per_step = kPair ? 2.0 : kAcc;
  const double products = 2.0 * iters * per_step;
  const double macs = kPair ? 2.0 * iters * 64 * 8 * (32 + 16)
                            : products * 64 * 8 * N;
  printf("%s N %2d acc %d: %.3f ms, %.1f TFLOP/s, %.2f cycles a product an SM "
         "at %.3f GHz\n", kPair ? "pair n32+n16" : "m64nNk8     ",
         kPair ? 48 : N, kPair ? 2 : kAcc, ms, 2.0 * macs * sms / (ms * 1e9),
         ms * 1e-3 * ghz * 1e9 / products, ghz);
  cudaFree(out);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "wgmma_tf32_rate: needs a CUDA device\n");
    return 1;
  }
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const float ghz = khz * 1e-6f;
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int sms = prop.multiProcessorCount;
  run<16, 1>(sms, ghz);
  run<16, 4>(sms, ghz);
  run<32, 1>(sms, ghz);
  run<32, 4>(sms, ghz);
  run<64, 1>(sms, ghz);
  run<64, 2>(sms, ghz);
  run<16, 1, true>(sms, ghz);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
