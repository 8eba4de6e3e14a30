// The card's mma.sync rate: TF32 m16n8k8 and bf16 m16n8k16 products with
// fp32 accumulators, issued back to back from registers (no memory
// traffic), by 4, 8 and 16 warps an SM on every SM. This is the ceiling of
// the fp32 flash kernels' design (three TF32 passes a product on
// mma.sync), which the dense TF32 rate of wgmma (495 TFLOP/s) does not
// describe.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_rate \
//       scripts/mma_sync_rate.cu && build/mma_sync_rate
//
// Prints one line a case: warps an SM, independent accumulators a warp,
// TFLOP/s and cycles a product on one SM sub-partition at the SM clock
// it reads from the device.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <bool kTf32, int kAcc>
__global__ void mma_loop(float* out, int iters) {
  float c[kAcc][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 3 + i;
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 5 + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      if (kTf32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < kAcc; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool kTf32, int kAcc>
void run(int sms, float ghz, int warps) {
  const int iters = 4096;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * 32 * warps);
  mma_loop<kTf32, kAcc><<<sms, 32 * warps>>>(out, 16);  // warm up
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  mma_loop<kTf32, kAcc><<<sms, 32 * warps>>>(out, iters);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  const double flops_per_mma = kTf32 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16;
  const double mmas = static_cast<double>(sms) * warps * iters * kAcc;
  printf("%s warps/SM %2d acc %d: %.3f ms, %.1f TFLOP/s, %.2f cycles a product "
         "a sub-partition at %.3f GHz\n",
         kTf32 ? "tf32 m16n8k8 " : "bf16 m16n8k16", warps, kAcc, ms,
         mmas * flops_per_mma / (ms * 1e9),
         ms * 1e-3 * ghz * 1e9 / (mmas / sms / 4), ghz);
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "mma_sync_rate: needs a CUDA device\n");
    return 1;
  }
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const float ghz = khz * 1e-6f;
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  for (int warps : {4, 8, 16}) {
    run<true, 8>(prop.multiProcessorCount, ghz, warps);
    run<false, 8>(prop.multiProcessorCount, ghz, warps);
  }
  run<true, 2>(prop.multiProcessorCount, ghz, 8);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
