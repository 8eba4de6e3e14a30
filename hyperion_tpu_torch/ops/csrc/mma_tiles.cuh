// Warp-level tiles on mma.sync and cp.async, shared by the paged
// attention kernels (paged_attention.cu) and the flash attention kernels
// past head_dim 256 (flash_attention_wide.cu).
//
// A warp owns 16 rows. Products come in two shapes, each in bf16 on
// mma.sync m16n8k16 (fp32 accumulators, fragments by ldmatrix) and in
// fp32 on plain FMAs laid out as the same m16n8 fragments (never TF32):
//   * `*_abt`: s[16 x 8 ST] += A[16 x K] . B[8 ST x K]^T, A and B row-major
//     [rows, K] tiles in shared memory (q . k^T, dO . v^T);
//   * `*_pv`: acc[16 x 8 NT] += P . V, P the C fragments of an `_abt`
//     (16 x 16 KS), V a row-major [16 KS, 8 NT] tile (p . v, ds . k).
// C fragment element e of n8 tile nt is row g + 8 (e >> 1), column
// 8 nt + 2 c + (e & 1), with g = lane / 4 and c = lane % 4.
//
// Loads: `copy_unit` moves one unit of `ub` bytes global -> shared by
// cp.async (16, 8 or 4 bytes, zeros and no read where !valid), or by a
// plain 2-byte load where a row's bytes take no wider unit (bf16 at an
// odd width). `row_unit` picks the widest unit a row of `bytes` takes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared; zeros (and no read) when !valid
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(N), "r"(valid ? N : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one unit of `ub` bytes (16, 8, 4, or 2: a plain load, done before the
// call returns)
template <typename T>
__device__ __forceinline__ void copy_unit(T* dst, const T* src, bool valid, int ub) {
  if (ub == 16) {
    cp_async<16>(dst, src, valid);
  } else if (ub == 8) {
    cp_async<8>(dst, src, valid);
  } else if (ub == 4) {
    cp_async<4>(dst, src, valid);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint16_t*>(dst) = valid ? *reinterpret_cast<const uint16_t*>(src) : 0;
  }
}

// the widest copy unit every row of `bytes` bytes takes at a 16-byte
// aligned base
__host__ __device__ constexpr int row_unit(int64_t bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as one bf16 pair
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) as bf16 pairs hi + lo with hi + lo = (x, y) to ~2^-17
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c + a . b over four lanes, by fp32 FMAs
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, c))));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put1(float* p, float x) { *p = x; }
__device__ __forceinline__ void put1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// columns c and c + 1 (c even) of a row `p` points at column 0 of, those
// below `n`: the pair as one store where `pairs` (the row starts at an
// even element offset, so the pair is aligned), else each on its own
template <typename T>
__device__ __forceinline__ void put2_upto(T* p, int c, int n, bool pairs, float x, float y) {
  if (pairs && c + 1 < n) {
    put2(p + c, x, y);
  } else {
    if (c < n) put1(p + c, x);
    if (c + 1 < n) put1(p + c + 1, y);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
}

// s[16 x 8 ST] += A[16 x K] . B[8 ST x K]^T, bf16 on mma.sync
template <int ST, int K>
__device__ __forceinline__ void mma_abt(float (&s)[ST][4], const bf16* A, int lda,
                                        const bf16* B, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < ST / 2; ++np) {
      uint32_t bk[4];
      ldsm_x4(bk, B + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ldb + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
    }
  }
}

// the same in fp32 on FMAs
template <int ST, int K>
__device__ __forceinline__ void fma_abt(float (&s)[ST][4], const float* A, int lda,
                                        const float* B, int ldb, int lane) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + gq * lda + k);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (gq + 8) * lda + k);
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      const float4 b0 = *reinterpret_cast<const float4*>(B + (nt * 8 + 2 * cq) * ldb + k);
      const float4 b1 = *reinterpret_cast<const float4*>(B + (nt * 8 + 2 * cq + 1) * ldb + k);
      s[nt][0] = dot4(a0, b0, s[nt][0]);
      s[nt][1] = dot4(a0, b1, s[nt][1]);
      s[nt][2] = dot4(a1, b0, s[nt][2]);
      s[nt][3] = dot4(a1, b1, s[nt][3]);
    }
  }
}

// acc[16 x 8 NT] += P . V over 16 KS rows of V, bf16 on mma.sync. P is
// rounded to bf16 (kSplit false: the flash contract's p -> dtype), or
// enters as two bf16 halves hi + lo (kSplit true: fp32's accuracy)
template <int NT, int KS, bool kSplit>
__device__ __forceinline__ void mma_pv(float (&acc)[NT][4], const float (&p)[2 * KS][4],
                                       const bf16* V, int ldv, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t hi[4], lo[4];
    if constexpr (kSplit) {
      split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
    } else {
      hi[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      hi[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      hi[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      hi[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, V + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldv + dp * 16 +
                        (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
      if constexpr (kSplit) {
        mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
      }
    }
  }
}

// the same in fp32 on FMAs over 8 PT rows of V: P passes through the
// warp's own [16, 8 PT + 4] buffer `pw`
template <int NT, int PT>
__device__ __forceinline__ void fma_pv(float (&acc)[NT][4], const float (&p)[PT][4], float* pw,
                                       const float* V, int ldv, int lane) {
  constexpr int LP = 8 * PT + 4;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < PT; ++nt) {
    put2(pw + gq * LP + nt * 8 + 2 * cq, p[nt][0], p[nt][1]);
    put2(pw + (gq + 8) * LP + nt * 8 + 2 * cq, p[nt][2], p[nt][3]);
  }
  __syncwarp();
#pragma unroll 2
  for (int k = 0; k < 8 * PT; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(pw + gq * LP + k);
    const float4 a1 = *reinterpret_cast<const float4*>(pw + (gq + 8) * LP + k);
    const float pa[4] = {a0.x, a0.y, a0.z, a0.w}, pb[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* vr = V + (k + kk) * ldv + 2 * cq;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v2 = *reinterpret_cast<const float2*>(vr + nt * 8);
        acc[nt][0] = fmaf(pa[kk], v2.x, acc[nt][0]);
        acc[nt][1] = fmaf(pa[kk], v2.y, acc[nt][1]);
        acc[nt][2] = fmaf(pb[kk], v2.x, acc[nt][2]);
        acc[nt][3] = fmaf(pb[kk], v2.y, acc[nt][3]);
      }
    }
  }
  __syncwarp();  // p is read before the next product rewrites it
}

// the two products in either dtype
template <int ST, int K>
__device__ __forceinline__ void abt(float (&s)[ST][4], const bf16* A, int lda, const bf16* B,
                                    int ldb, int lane) {
  mma_abt<ST, K>(s, A, lda, B, ldb, lane);
}
template <int ST, int K>
__device__ __forceinline__ void abt(float (&s)[ST][4], const float* A, int lda, const float* B,
                                    int ldb, int lane) {
  fma_abt<ST, K>(s, A, lda, B, ldb, lane);
}
template <int NT, int PT, bool kSplit>
__device__ __forceinline__ void pv(float (&acc)[NT][4], const float (&p)[PT][4], float* /*pw*/,
                                   const bf16* V, int ldv, int lane) {
  mma_pv<NT, PT / 2, kSplit>(acc, p, V, ldv, lane);
}
template <int NT, int PT, bool kSplit>
__device__ __forceinline__ void pv(float (&acc)[NT][4], const float (&p)[PT][4], float* pw,
                                   const float* V, int ldv, int lane) {
  fma_pv<NT, PT>(acc, p, pw, V, ldv, lane);
}

}  // namespace mt
