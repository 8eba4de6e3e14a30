// Flash attention for Hopper (sm_90a): the forward (o and the per-row
// log-sum-exp) and the two backward kernels (dq; dk and dv), over
// [B, T, H, D] tensors read in place, with a causal mask and a [B, Tkv]
// key padding mask.
//
// Replaces: hyperion_tpu/ops/pallas/flash_attention.py
//   * forward: `flash_attention` -> `_flash_forward` -> `_fwd_kernel`;
//   * backward: `_bwd` -> `_flash_backward` -> `_dq_kernel` and
//     `_dkv_kernel`.
//
// What they compute (the JAX kernels' contract, not the "xla" path's):
//   s = (q . k^T, accumulated in fp32) * scale, scale = 1/sqrt(D) in fp32;
//   masked entries (causal kv > q, or key padding 0) set to NEG_INF =
//   -2^30; running max and sum in fp32; p cast to the input dtype before
//   p . v, which accumulates in fp32; o = acc / max(l, 1e-30) cast to the
//   input dtype; lse = m + log(max(l, 1e-30)), written only when asked
//   for. Backward from the saved lse and delta = sum(dO * O) (computed by
//   the caller): p = exp(s - lse), dp = dO . v^T, ds = p * (dp - delta),
//   dq = scale * ds->dtype . k, dv = p->dtype^T . dO, dk = scale *
//   ds->dtype^T . q, each cast to the input dtype. Key columns past Tkv
//   (the ragged last tile) are left out entirely (p = 0); rows whose keys
//   are all masked give garbage, as the reference documents.
//
// Bound on the H100: operations. At the Llama-2-7B train step ([1, 4096,
// 32, 128] bf16, causal) the forward's two causal-half products are 1.37e11
// flops, 0.139 ms at 989 TFLOP/s, against 134 MB of bytes (0.040 ms); the
// backward's five products 3.44e11 flops, 0.347 ms.
//
// Design (right and simple first; wgmma and TMA are later work):
//   * One block of 4 warps per (tile, head, batch). The forward and dq
//     kernels take a 64-row query tile and loop over 64-row key tiles up
//     to the causal frontier: the loop replaces the TPU's ordered kv grid
//     axis and its m/l/acc scratch, which live in registers here. The
//     dk/dv kernel takes a 64-row key tile and loops over the query tiles
//     from the diagonal down, so no two blocks write one gradient row and
//     no atomics are needed. Causal grids start with the longest tiles.
//   * Tiles are copied from device memory to shared memory with 16-byte
//     loads, rows padded by 16 bytes so the fragment reads hit 32 banks;
//     rows past T are zero-filled (a ragged T is a bound check).
//   * Each warp owns 16 rows of its tile's products. bf16 products run on
//     the tensor cores (mma.sync m16n8k16, fp32 accumulators), the
//     fragments read from shared memory; fp32 inputs take plain fp32 FMAs
//     over the same fragment layout (never TF32), so fp32 parity holds.
//     The dk/dv kernel computes s^T = k . q^T directly, so no operand is
//     read transposed except the right-hand tiles of p.v, ds.k, p^T.dO and
//     ds^T.q.
//   * p (and ds) go through shared memory in the input dtype to feed the
//     second product; the fp32 values stay in registers for ds.
//   * Shared memory above 48 KB is opted in (up to ~170 KB for fp32 dk/dv
//     at D = 128).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;     // rows of the block's tile and of each loop tile
constexpr int kThreads = 128; // 4 warps, 16 rows each
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

using bf16 = __nv_bfloat16;

// shared-memory row strides: 16 bytes of padding a row
template <typename T>
__host__ __device__ constexpr int pad_elems() { return 16 / sizeof(T); }
template <typename T, int D>
__host__ __device__ constexpr int ld_in() { return D + pad_elems<T>(); }
template <typename T>
__host__ __device__ constexpr int ld_p() { return kTile + pad_elems<T>(); }

// element (i, j) of a shared-memory matrix stored row-major (kTrans =
// false: p[i * ld + j]) or transposed (p[j * ld + i])
template <bool kTrans, typename T>
__device__ __forceinline__ T at(const T* p, int ld, int i, int j) {
  return kTrans ? p[j * ld + i] : p[i * ld + j];
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (M(i, j), M(i, j + 1)): an A fragment register (pairs along k = j)
template <bool kTrans>
__device__ __forceinline__ uint32_t pair_cols(const bf16* p, int ld, int i, int j) {
  if constexpr (!kTrans) {
    return *reinterpret_cast<const uint32_t*>(p + i * ld + j);
  } else {
    return pack(p[j * ld + i], p[(j + 1) * ld + i]);
  }
}

// (M(i, j), M(i + 1, j)): a B fragment register (pairs along k = i)
template <bool kTrans>
__device__ __forceinline__ uint32_t pair_rows(const bf16* p, int ld, int i, int j) {
  if constexpr (kTrans) {
    return *reinterpret_cast<const uint32_t*>(p + j * ld + i);
  } else {
    return pack(p[i * ld + j], p[(i + 1) * ld + j]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16 x 8*NT] += A[m0 .. m0+15, 0 .. K) . B[0 .. K, 0 .. 8*NT), one warp.
// The accumulator is the m16n8 fragment: thread `lane` holds rows
// lane/4 (c[.][0..1]) and lane/4 + 8 (c[.][2..3]), columns 2*(lane%4)
// and 2*(lane%4) + 1 of each 8-column tile.
template <bool kTransA, bool kTransB, int NT, typename T>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* A, int lda,
                                          int m0, const T* Bm, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, cc = (lane & 3) * 2;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      a[0] = pair_cols<kTransA>(A, lda, m0 + r, k0 + cc);
      a[1] = pair_cols<kTransA>(A, lda, m0 + r + 8, k0 + cc);
      a[2] = pair_cols<kTransA>(A, lda, m0 + r, k0 + cc + 8);
      a[3] = pair_cols<kTransA>(A, lda, m0 + r + 8, k0 + cc + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        b[0] = pair_rows<kTransB>(Bm, ldb, k0 + cc, nt * 8 + r);
        b[1] = pair_rows<kTransB>(Bm, ldb, k0 + cc + 8, nt * 8 + r);
        mma_bf16(c[nt], a, b);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = at<kTransA>(A, lda, m0 + r, k);
      const float a1 = at<kTransA>(A, lda, m0 + r + 8, k);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = at<kTransB>(Bm, ldb, k, nt * 8 + cc);
        const float b1 = at<kTransB>(Bm, ldb, k, nt * 8 + cc + 1);
        c[nt][0] = fmaf(a0, b0, c[nt][0]);
        c[nt][1] = fmaf(a0, b1, c[nt][1]);
        c[nt][2] = fmaf(a1, b0, c[nt][2]);
        c[nt][3] = fmaf(a1, b1, c[nt][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
}

// rows row0 .. row0+63 of one head of a [B, T, H, D] tensor (`src` points
// at its batch and head, rows `stride` elements apart) into a padded
// [64][D + pad] tile; rows at or past `rows` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int rows,
                                          int64_t stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = ld_in<T, D>();
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// one thread's two columns of an m16n8 fragment row, stored to shared
// memory in T (row-major, `ld` apart)
template <typename T>
__device__ __forceinline__ void put2(T* p, float x, float y) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the scaled, masked logit of query `qi`, key `ki`: -inf outside the
// arrays (left out of every sum), NEG_INF where the causal or padding
// mask drops it, as the reference's `_tile_mask` does
__device__ __forceinline__ float masked(float s, int qi, int ki, int Tq, int Tkv,
                                        int causal, int keep) {
  if (qi >= Tq || ki >= Tkv) return -INFINITY;
  if ((causal && ki > qi) || !keep) return kNegInf;
  return s;
}

// the causal grids run their longest tiles first
__device__ __forceinline__ int tile_index(int causal, bool reverse) {
  return (causal && reverse) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// ------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pad,
                 T* __restrict__ o, float* __restrict__ lse, int Tq, int Tkv,
                 int H, int causal, float scale) {
  constexpr int LD = ld_in<T, D>(), PLD = ld_p<T>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  T* Ps = Vs + kTile * LD;
  int* keep_s = reinterpret_cast<int*>(Ps + kTile * PLD);

  const int qt = tile_index(causal, true);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const T* qb = q + static_cast<int64_t>(b) * Tq * stride + h * D;
  const T* kb = k + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const T* vb = v + static_cast<int64_t>(b) * Tkv * stride + h * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, r = lane >> 2, cc = (lane & 3) * 2;
  const int rows[2] = {q0 + m0 + r, q0 + m0 + r + 8};

  load_tile<T, D>(Qs, qb, q0, Tq, stride);

  float acc[NO][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_kv = (Tkv + kTile - 1) / kTile;
  int last = n_kv - 1;
  if (causal) last = min(last, min(q0 + kTile - 1, Tq - 1) / kTile);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kb, k0, Tkv, stride);
    load_tile<T, D>(Vs, vb, k0, Tkv, stride);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      keep_s[j] = (k0 + j < Tkv) && (pad == nullptr || pad[b * Tkv + k0 + j] != 0);
    }
    __syncthreads();

    float s[8][4];
    zero(s);
    warp_gemm<false, true>(s, Qs, LD, m0, Ks, LD, D);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + cc + (e & 1);
        s[nt][e] = masked(s[nt][e] * scale, rows[e >> 1], k0 + col, Tq, Tkv,
                          causal, keep_s[col]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
      put2(Ps + (m0 + r) * PLD + nt * 8 + cc, s[nt][0], s[nt][1]);
      put2(Ps + (m0 + r + 8) * PLD + nt * 8 + cc, s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    __syncwarp();  // the warp's p rows are in shared memory
    warp_gemm<false, false>(acc, Ps, PLD, m0, Vs, LD, kTile);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0 && rows[i] < Tq) {
      lse[(static_cast<int64_t>(b) * H + h) * Tq + rows[i]] = m[i] + logf(l[i]);
    }
  }
  T* ob = o + static_cast<int64_t>(b) * Tq * stride + h * D;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < Tq) {
        put2(ob + rows[i] * stride + nt * 8 + cc, acc[nt][2 * i] / l[i],
             acc[nt][2 * i + 1] / l[i]);
      }
    }
  }
}

// ----------------------------------------------------------- backward dq

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ pad,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Tq,
                int Tkv, int H, int causal, float scale) {
  constexpr int LD = ld_in<T, D>(), PLD = ld_p<T>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kTile * LD;
  T* Ks = dOs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  T* dSs = Vs + kTile * LD;
  int* keep_s = reinterpret_cast<int*>(dSs + kTile * PLD);

  const int qt = tile_index(causal, true);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const T* kb = k + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const T* vb = v + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const float* lse_b = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* delta_b = delta + (static_cast<int64_t>(b) * H + h) * Tq;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, r = lane >> 2, cc = (lane & 3) * 2;
  const int rows[2] = {q0 + m0 + r, q0 + m0 + r + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = rows[i] < Tq ? lse_b[rows[i]] : 0.f;
    row_delta[i] = rows[i] < Tq ? delta_b[rows[i]] : 0.f;
  }

  load_tile<T, D>(Qs, q + qoff, q0, Tq, stride);
  load_tile<T, D>(dOs, dout + qoff, q0, Tq, stride);

  float acc[NO][4];
  zero(acc);
  const int n_kv = (Tkv + kTile - 1) / kTile;
  int last = n_kv - 1;
  if (causal) last = min(last, min(q0 + kTile - 1, Tq - 1) / kTile);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, kb, k0, Tkv, stride);
    load_tile<T, D>(Vs, vb, k0, Tkv, stride);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      keep_s[j] = (k0 + j < Tkv) && (pad == nullptr || pad[b * Tkv + k0 + j] != 0);
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    warp_gemm<false, true>(s, Qs, LD, m0, Ks, LD, D);
    warp_gemm<false, true>(dp, dOs, LD, m0, Vs, LD, D);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + cc + (e & 1);
        const int i = e >> 1;
        const float x = masked(s[nt][e] * scale, rows[i], k0 + col, Tq, Tkv,
                               causal, keep_s[col]);
        const float p = expf(x - row_lse[i]);
        s[nt][e] = p * (dp[nt][e] - row_delta[i]);
      }
      put2(dSs + (m0 + r) * PLD + nt * 8 + cc, s[nt][0], s[nt][1]);
      put2(dSs + (m0 + r + 8) * PLD + nt * 8 + cc, s[nt][2], s[nt][3]);
    }
    __syncwarp();
    warp_gemm<false, false>(acc, dSs, PLD, m0, Ks, LD, kTile);
  }

  T* dqb = dq + qoff;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < Tq) {
        put2(dqb + rows[i] * stride + nt * 8 + cc, scale * acc[nt][2 * i],
             scale * acc[nt][2 * i + 1]);
      }
    }
  }
}

// -------------------------------------------------------- backward dk/dv

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pad,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Tq, int Tkv, int H, int causal,
                 float scale) {
  constexpr int LD = ld_in<T, D>(), PLD = ld_p<T>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTile * LD;
  T* Qs = Vs + kTile * LD;
  T* dOs = Qs + kTile * LD;
  T* Ps = dOs + kTile * LD;
  T* dSs = Ps + kTile * PLD;
  float* lse_s = reinterpret_cast<float*>(dSs + kTile * PLD);
  float* delta_s = lse_s + kTile;
  int* keep_s = reinterpret_cast<int*>(delta_s + kTile);

  // causal: the first key tiles see the most query tiles
  const int kt = tile_index(causal, false);
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const int64_t koff = static_cast<int64_t>(b) * Tkv * stride + h * D;
  const float* lse_b = lse + (static_cast<int64_t>(b) * H + h) * Tq;
  const float* delta_b = delta + (static_cast<int64_t>(b) * H + h) * Tq;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, r = lane >> 2, cc = (lane & 3) * 2;
  const int rows[2] = {k0 + m0 + r, k0 + m0 + r + 8};  // key rows

  load_tile<T, D>(Ks, k + koff, k0, Tkv, stride);
  load_tile<T, D>(Vs, v + koff, k0, Tkv, stride);
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    keep_s[j] = (k0 + j < Tkv) && (pad == nullptr || pad[b * Tkv + k0 + j] != 0);
  }

  float acc_k[NO][4], acc_v[NO][4];
  zero(acc_k);
  zero(acc_v);
  const int n_q = (Tq + kTile - 1) / kTile;
  const int first = causal ? k0 / kTile : 0;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, q + qoff, q0, Tq, stride);
    load_tile<T, D>(dOs, dout + qoff, q0, Tq, stride);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool in = q0 + j < Tq;
      lse_s[j] = in ? lse_b[q0 + j] : 0.f;
      delta_s[j] = in ? delta_b[q0 + j] : 0.f;
    }
    __syncthreads();

    // s^T: rows are keys, columns queries
    float p[8][4];
    zero(p);
    warp_gemm<false, true>(p, Ks, LD, m0, Qs, LD, D);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + cc + (e & 1);
        const int kr = rows[e >> 1];
        const float x = masked(p[nt][e] * scale, q0 + col, kr, Tq, Tkv, causal,
                               keep_s[kr - k0]);
        p[nt][e] = expf(x - lse_s[col]);
      }
      put2(Ps + (m0 + r) * PLD + nt * 8 + cc, p[nt][0], p[nt][1]);
      put2(Ps + (m0 + r + 8) * PLD + nt * 8 + cc, p[nt][2], p[nt][3]);
    }
    __syncwarp();
    warp_gemm<false, false>(acc_v, Ps, PLD, m0, dOs, LD, kTile);

    float dp[8][4];
    zero(dp);
    warp_gemm<false, true>(dp, Vs, LD, m0, dOs, LD, D);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + cc + (e & 1);
        dp[nt][e] = p[nt][e] * (dp[nt][e] - delta_s[col]);
      }
      put2(dSs + (m0 + r) * PLD + nt * 8 + cc, dp[nt][0], dp[nt][1]);
      put2(dSs + (m0 + r + 8) * PLD + nt * 8 + cc, dp[nt][2], dp[nt][3]);
    }
    __syncwarp();
    warp_gemm<false, false>(acc_k, dSs, PLD, m0, Qs, LD, kTile);
  }

  T* dkb = dk + koff;
  T* dvb = dv + koff;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < Tkv) {
        put2(dkb + rows[i] * stride + nt * 8 + cc, scale * acc_k[nt][2 * i],
             scale * acc_k[nt][2 * i + 1]);
        put2(dvb + rows[i] * stride + nt * 8 + cc, acc_v[nt][2 * i],
             acc_v[nt][2 * i + 1]);
      }
    }
  }
}

// ----------------------------------------------------------- launchers

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                   Args... args) {
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
constexpr size_t tile_bytes() { return sizeof(T) * kTile * ld_in<T, D>(); }
template <typename T>
constexpr size_t p_bytes() { return sizeof(T) * kTile * ld_p<T>(); }

struct Args {
  const void *q, *k, *v, *pad, *dout, *lse_in, *delta;
  void *o, *lse, *dq, *dk, *dv;
  int B, Tq, Tkv, H, causal;
  float scale;
};

template <typename T, int D>
cudaError_t run(int which, const Args& a, cudaStream_t s) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* pad = static_cast<const int*>(a.pad);
  const int n_q = (a.Tq + kTile - 1) / kTile, n_kv = (a.Tkv + kTile - 1) / kTile;
  if (which == 0) {
    const size_t smem = 3 * tile_bytes<T, D>() + p_bytes<T>() + kTile * sizeof(int);
    return launch(flash_fwd_kernel<T, D>, dim3(n_q, a.H, a.B), smem, s, q, k, v,
                  pad, static_cast<T*>(a.o), static_cast<float*>(a.lse), a.Tq,
                  a.Tkv, a.H, a.causal, a.scale);
  }
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse_in);
  const float* delta = static_cast<const float*>(a.delta);
  if (which == 1) {
    const size_t smem = 4 * tile_bytes<T, D>() + p_bytes<T>() + kTile * sizeof(int);
    return launch(flash_dq_kernel<T, D>, dim3(n_q, a.H, a.B), smem, s, q, k, v,
                  pad, dout, lse, delta, static_cast<T*>(a.dq), a.Tq, a.Tkv,
                  a.H, a.causal, a.scale);
  }
  const size_t smem = 4 * tile_bytes<T, D>() + 2 * p_bytes<T>() +
                      kTile * (2 * sizeof(float) + sizeof(int));
  return launch(flash_dkv_kernel<T, D>, dim3(n_kv, a.H, a.B), smem, s, q, k, v,
                pad, dout, lse, delta, static_cast<T*>(a.dk),
                static_cast<T*>(a.dv), a.Tq, a.Tkv, a.H, a.causal, a.scale);
}

template <typename T>
cudaError_t run_d(int which, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return run<T, 32>(which, a, s);
    case 64: return run<T, 64>(which, a, s);
    case 128: return run<T, 128>(which, a, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int which, int D, int dtype, const Args& a, void* stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tkv <= 0 || a.H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(run_d<float>(which, D, a, s));
  if (dtype == 1) return static_cast<int>(run_d<bf16>(which, D, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every tensor is contiguous: q, o, dq [B, Tq, H, D]; k, v, dk, dv
// [B, Tkv, H, D], all in dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned; pad [B, Tkv] int32 or null; lse, delta [B, H, Tq] float32.
// D is 32, 64 or 128. `lse` may be null (no gradient will be taken).

extern "C" int hyperion_flash_fwd(const void* q, const void* k, const void* v,
                                  const void* pad, void* o, void* lse, int B,
                                  int Tq, int Tkv, int H, int D, int causal,
                                  float scale, int dtype, void* stream) {
  Args a{q, k, v, pad, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr,
         nullptr, B, Tq, Tkv, H, causal, scale};
  return dispatch(0, D, dtype, a, stream);
}

extern "C" int hyperion_flash_dq(const void* q, const void* k, const void* v,
                                 const void* pad, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int Tq, int Tkv, int H, int D,
                                 int causal, float scale, int dtype,
                                 void* stream) {
  Args a{q, k, v, pad, dout, lse, delta, nullptr, nullptr, dq, nullptr,
         nullptr, B, Tq, Tkv, H, causal, scale};
  return dispatch(1, D, dtype, a, stream);
}

extern "C" int hyperion_flash_dkv(const void* q, const void* k, const void* v,
                                  const void* pad, const void* dout,
                                  const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int Tq, int Tkv, int H,
                                  int D, int causal, float scale, int dtype,
                                  void* stream) {
  Args a{q, k, v, pad, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
         B, Tq, Tkv, H, causal, scale};
  return dispatch(2, D, dtype, a, stream);
}
