// Flash attention past head_dim 256 for Hopper (sm_90a): the forward (o
// and the per-row log-sum-exp), dq (with delta) and dk/dv kernels at any
// head_dim, bf16 and fp32, over [B, T, H, D] tensors read in place at
// their own width D, with a causal mask and a [B, Tkv] key padding mask.
// The wrappers (ops/flash_attention.py) send D past 256 here; up to 256
// the kernels of flash_attention.cu run.
//
// Replaces: hyperion_tpu/ops/pallas/flash_attention.py, the same kernels
// as flash_attention.cu (`_fwd_kernel`; `_dq_kernel` and `_dkv_kernel`)
// at the head dims those do not take: the reference's blocks hold the
// whole D, so its kernels take any.
//
// What they compute is flash_attention.cu's contract, term for term:
// s = (q . k^T in fp32) * scale, masked entries NEG_INF = -2^30 (causal
// kv > q, key padding 0) and keys past Tkv left out; o = (p -> dtype) . v
// / max(l, 1e-30); lse = m + log(max(l, 1e-30)); backward from the saved
// lse and delta = sum(dO * O), which dq computes and writes for dk/dv:
// p = exp(s - lse), ds = p * (dp - delta), dq = scale * (ds -> dtype) . k,
// dk = scale * (ds -> dtype)^T . q, dv = (p -> dtype)^T . dO.
//
// Bound on the H100: operations, as at D <= 256 (the products are 4 D
// flops a kept (query, key) pair in the forward, 6 D in dq, 8 D in dk/dv).
// These are first versions, right before fast:
//  * Blocks of 4 warps own 64 rows (16 a warp): q rows in the forward and
//    dq, k and v rows in dk/dv. The other side streams in 64-row tiles.
//  * Nothing D wide stays resident: every product over D (s = q . k^T,
//    dp = dO . v^T, and s^T, dp^T in dk/dv) runs in 64-column steps, each
//    step one stage of a cp.async ring holding that chunk of the block's
//    rows and of the tile's (the block's rows come again from L2 every
//    tile), so any D fits the same shared memory.
//  * A block owns one chunk of at most 128 output columns (grid x carries
//    it) and recomputes s (and dp) over the whole D: o in the forward, dq
//    in dq; in dk/dv a block owns a chunk of dv (it computes s^T only) or
//    of dk (s^T and dp^T). Its own columns of the third operand (v, k, dO
//    or q) stream as one more step a tile.
//  * bf16 on mma.sync m16n8k16 with fp32 accumulators (fragments by
//    ldmatrix), p and ds rounded to bf16 as the contract has it; fp32 on
//    fp32 FMAs laid out as the same fragments (no TF32).
//  * The softmax in the natural domain with expf and logf, as the
//    split-TF32 kernels: m starts at NEG_INF, and a row whose keys are all
//    masked gets p = 1 from the same rounding as the plain version.
//  * No atomics: every output element has one writer. Every dq block of
//    a row tile computes delta by the same sums; chunk 0's writes it.
//  * No masking fast path and no skip of a warp's tiles past its causal
//    frontier: the block walks the key tiles up to its last row's.
//  * __launch_bounds__(128, 1): without the minimum of blocks, ptxas held
//    the fp32 forward to 168 registers (3 blocks an SM) and spilled.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <cxxabi.h>
#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace mt;

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF
constexpr int kRows = 64;                  // a block's own rows, 16 a warp
constexpr int kThreads = 128;
constexpr int kTile = 64;                  // rows of a streamed tile
constexpr int kKC = 64;                    // columns a step of a product over D
constexpr int kOC = 128;                   // output columns a block, at most
constexpr int kST = kTile / 8;             // n8 tiles of s
constexpr int kNT = kOC / 8;               // n8 tiles of the output chunk

// the scaled logit of query qi, key ki: -inf outside the arrays (left out
// of every sum), NEG_INF where the causal or padding mask drops it
__device__ __forceinline__ float masked(float s, int qi, int ki, int Tq, int Tkv, int causal,
                                        bool keep) {
  if (qi >= Tq || ki >= Tkv) return -INFINITY;
  if ((causal && ki > qi) || !keep) return kNegInf;
  return s;
}

// The ring: S stages, each either a step of a product over D (the block's
// rows' 64 columns at 0, the tile's at kRows * kLdk) or a tile's own
// output columns (kTile rows of kLdo). fp32 adds each warp's p buffer.
template <typename T>
struct Ring {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kStages = kBf16 ? 4 : 3;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLdk = kKC + kVec;  // rows padded by 16 bytes
  static constexpr int kLdo = kOC + kVec;
  static constexpr int kPair = (kRows + kTile) * kLdk;
  static constexpr int kStage = kPair > kTile * kLdo ? kPair : kTile * kLdo;
  static constexpr int kPld = kTile + 4;
  static constexpr size_t p_bytes = kBf16 ? 0 : sizeof(float) * (kThreads / 32) * 16 * kPld;
  static constexpr size_t bytes = sizeof(T) * kStages * kStage + p_bytes;
};

// 64 rows [t0, t0 + 64) of x (row t at x + t * stride), columns
// [c0, c0 + n) into dst (row pitch ld): zeros past `rows` and past width
// D, copies of `ub` bytes. n / (ub / sizeof(T)) is a power of two.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* x, int64_t stride, int rows,
                                          int t0, int c0, int n, int D, int ub, int tid) {
  const int ue = ub / static_cast<int>(sizeof(T)), per_row = n / ue;
  const int shift = __ffs(per_row) - 1;
  for (int idx = tid; idx < (kTile << shift); idx += kThreads) {
    const int r = idx >> shift, c = (idx & (per_row - 1)) * ue, t = t0 + r;
    const bool valid = t < rows && c0 + c < D;
    const T* src = valid ? x + t * stride + c0 + c : x;
    copy_unit(dst + r * ld + c, src, valid, ub);
  }
}

// The pipeline shared by the three kernels: `load(st)` fills step st's
// stage; `next()` waits for step st, frees step st - 1's stage for step
// st + S - 1 and returns step st's stage. The loaders capture by value:
// a capture by reference kept the captured locals in local memory.
template <typename T, typename Load>
struct Pipe {
  T* ring;
  int total, st;
  Load load;
  __device__ __forceinline__ Pipe(T* r, int n, Load l) : ring(r), total(n), st(0), load(l) {
#pragma unroll
    for (int i = 0; i < Ring<T>::kStages - 1; ++i) {
      if (i < total) load(i);
      cp_async_commit();
    }
  }
  __device__ __forceinline__ const T* next() {
    constexpr int S = Ring<T>::kStages;
    cp_async_wait<S - 2>();
    __syncthreads();
    if (st + S - 1 < total) load(st + S - 1);
    cp_async_commit();
    return ring + (st++ % S) * Ring<T>::kStage;
  }
};
template <typename T, typename Load>
__device__ __forceinline__ Pipe<T, Load> make_pipe(T* ring, int total, Load load) {
  return Pipe<T, Load>(ring, total, load);
}

// s over D: nkc steps, the warp's 16 rows of the block's chunk against
// the tile's
template <typename T, typename P>
__device__ __forceinline__ void product_over_d(float (&s)[kST][4], P& pipe, int nkc, int warp,
                                               int lane) {
  constexpr int LDK = Ring<T>::kLdk;
  zero(s);
  for (int c = 0; c < nkc; ++c) {
    const T* stage = pipe.next();
    abt<kST, kKC>(s, stage + 16 * warp * LDK, LDK, stage + kRows * LDK, LDK, lane);
  }
}

// rows r (this thread's two) of an output chunk: columns [0, own) of a
// row at out + r * stride, times `mul`
template <typename T>
__device__ __forceinline__ void store_chunk(const float (&acc)[kNT][4], T* out, int64_t stride,
                                            const int (&r)[2], int rows, int own, int D,
                                            const float (&mul)[2], int cq) {
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r[i] < rows) {
        put2_upto(out + r[i] * stride, 8 * nt + 2 * cq, own, pairs, acc[nt][2 * i] * mul[i],
                  acc[nt][2 * i + 1] * mul[i]);
      }
    }
  }
}

// the forward for 64 query rows of one head and one chunk of o's columns
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pad, T* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tkv, int H, int D, int n_oc,
                      int causal, float scale, int ub) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* Ps = reinterpret_cast<float*>(ring + R::kStages * R::kStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, cq = lane & 3;
  const int oc = blockIdx.x % n_oc, n_qt = (Tq + kRows - 1) / kRows;
  // causal: the last query blocks see the most key tiles; launch them first
  const int qt = static_cast<int>(blockIdx.x) / n_oc;
  const int q0 = (causal ? n_qt - 1 - qt : qt) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + static_cast<int64_t>(h) * D;
  const int64_t kvoff = static_cast<int64_t>(b) * Tkv * stride + static_cast<int64_t>(h) * D;
  const int oc0 = oc * kOC, own = min(kOC, D - oc0);
  const int nkc = (D + kKC - 1) / kKC, spt = nkc + 1;
  const int n_kv = (Tkv + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, min(q0 + kRows - 1, Tq - 1) / kTile + 1) : n_kv;

  auto pipe = make_pipe(ring, n_tiles * spt, [=](int st) {
    T* stage = ring + (st % R::kStages) * R::kStage;
    const int k0 = st / spt * kTile, part = st % spt;
    if (part < nkc) {
      load_tile(stage, R::kLdk, q + qoff, stride, Tq, q0, part * kKC, kKC, D, ub, tid);
      load_tile(stage + kRows * R::kLdk, R::kLdk, k + kvoff, stride, Tkv, k0, part * kKC, kKC,
                D, ub, tid);
    } else {
      load_tile(stage, R::kLdo, v + kvoff, stride, Tkv, k0, oc0, kOC, D, ub, tid);
    }
  });

  const int rows[2] = {q0 + 16 * warp + gq, q0 + 16 * warp + gq + 8};
  float* pw = Ps + warp * 16 * R::kPld;
  float acc[kNT][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    float s[kST][4];
    product_over_d<T>(s, pipe, nkc, warp, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = k0 + 8 * nt + 2 * cq + (e & 1);
        const bool keep = pad == nullptr || ki >= Tkv ||
                          pad[static_cast<int64_t>(b) * Tkv + ki] != 0;
        const float x = masked(s[nt][e] * scale, rows[e >> 1], ki, Tq, Tkv, causal, keep);
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    pv<kNT, kST, false>(acc, s, pw, pipe.next(), R::kLdo, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
    if (lse != nullptr && oc == 0 && cq == 0 && rows[i] < Tq) {
      lse[(static_cast<int64_t>(b) * H + h) * Tq + rows[i]] = m[i] + logf(l[i]);
    }
  }
  store_chunk(acc, o + qoff + oc0, stride, rows, Tq, own, D, inv, cq);
}

// dq for 64 query rows of one head and one chunk of dq's columns, and
// delta = sum(dO * O) for those rows (chunk 0 writes it for dk/dv): each
// key tile is s over D, dp = dO . v^T over D, then dq += ds . k on the
// chunk's columns of k
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ pad,
                     const T* __restrict__ dout, const T* __restrict__ o,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     T* __restrict__ dq, int Tq, int Tkv, int H, int D, int n_oc, int causal,
                     float scale, int ub) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* Ps = reinterpret_cast<float*>(ring + R::kStages * R::kStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, cq = lane & 3;
  const int oc = blockIdx.x % n_oc, n_qt = (Tq + kRows - 1) / kRows;
  const int qt = static_cast<int>(blockIdx.x) / n_oc;
  const int q0 = (causal ? n_qt - 1 - qt : qt) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + static_cast<int64_t>(h) * D;
  const int64_t kvoff = static_cast<int64_t>(b) * Tkv * stride + static_cast<int64_t>(h) * D;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int oc0 = oc * kOC, own = min(kOC, D - oc0);
  const int nkc = (D + kKC - 1) / kKC, spt = 2 * nkc + 1;
  const int n_kv = (Tkv + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, min(q0 + kRows - 1, Tq - 1) / kTile + 1) : n_kv;

  auto pipe = make_pipe(ring, n_tiles * spt, [=](int st) {
    T* stage = ring + (st % R::kStages) * R::kStage;
    const int k0 = st / spt * kTile, part = st % spt;
    if (part < 2 * nkc) {
      const bool is_s = part < nkc;
      const int c0 = (is_s ? part : part - nkc) * kKC;
      load_tile(stage, R::kLdk, (is_s ? q : dout) + qoff, stride, Tq, q0, c0, kKC, D, ub, tid);
      load_tile(stage + kRows * R::kLdk, R::kLdk, (is_s ? k : v) + kvoff, stride, Tkv, k0, c0,
                kKC, D, ub, tid);
    } else {
      load_tile(stage, R::kLdo, k + kvoff, stride, Tkv, k0, oc0, kOC, D, ub, tid);
    }
  });

  // delta over the warp's 16 rows, a row at a time across the lanes
  float row_delta[2] = {0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    const int qi = q0 + 16 * warp + i;
    float sum = 0.f;
    if (qi < Tq) {
      const T* a = dout + qoff + qi * stride;
      const T* c = o + qoff + qi * stride;
      for (int d = lane; d < D; d += 32) sum = fmaf(to_f32(a[d]), to_f32(c[d]), sum);
    }
    sum = warp_sum(sum);
    if (i == gq) row_delta[0] = sum;
    if (i == gq + 8) row_delta[1] = sum;
    if (oc == 0 && lane == 0 && qi < Tq) delta[stat0 + qi] = sum;
  }
  const int rows[2] = {q0 + 16 * warp + gq, q0 + 16 * warp + gq + 8};
  float row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row_lse[i] = rows[i] < Tq ? lse[stat0 + rows[i]] : 0.f;

  float* pw = Ps + warp * 16 * R::kPld;
  float acc[kNT][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    float s[kST][4], dp[kST][4];
    product_over_d<T>(s, pipe, nkc, warp, lane);
    product_over_d<T>(dp, pipe, nkc, warp, lane);
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, ki = k0 + 8 * nt + 2 * cq + (e & 1);
        const bool keep = pad == nullptr || ki >= Tkv ||
                          pad[static_cast<int64_t>(b) * Tkv + ki] != 0;
        const float x = masked(s[nt][e] * scale, rows[i], ki, Tq, Tkv, causal, keep);
        s[nt][e] = expf(x - row_lse[i]) * (dp[nt][e] - row_delta[i]);
      }
    }
    pv<kNT, kST, false>(acc, s, pw, pipe.next(), R::kLdo, lane);
  }
  const float mul[2] = {scale, scale};
  store_chunk(acc, dq + qoff + oc0, stride, rows, Tq, own, D, mul, cq);
}

// dk or dv for 64 key rows of one head and one chunk of its columns (grid
// x: the key tile, then dv's chunks, then dk's): each query tile is
// s^T = k . q^T over D, and for dk dp^T = v . dO^T over D, then
// dv += p^T . dO or dk += ds^T . q on the chunk's columns
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pad,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Tq, int Tkv, int H, int D, int n_oc, int causal, float scale, int ub) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* Ps = reinterpret_cast<float*>(ring + R::kStages * R::kStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, cq = lane & 3;
  const int u = blockIdx.x % (2 * n_oc);
  const bool is_dk = u >= n_oc;
  const int oc = is_dk ? u - n_oc : u;
  const int k0 = static_cast<int>(blockIdx.x) / (2 * n_oc) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + static_cast<int64_t>(h) * D;
  const int64_t kvoff = static_cast<int64_t>(b) * Tkv * stride + static_cast<int64_t>(h) * D;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int oc0 = oc * kOC, own = min(kOC, D - oc0);
  const int nkc = (D + kKC - 1) / kKC, spt = (is_dk ? 2 * nkc : nkc) + 1;
  const int n_qt = (Tq + kTile - 1) / kTile;
  // causal: query tiles from the first that holds a row at or past k0
  const int i0 = causal ? min(k0 / kTile, n_qt) : 0;
  const int n_tiles = n_qt - i0;

  auto pipe = make_pipe(ring, n_tiles * spt, [=](int st) {
    T* stage = ring + (st % R::kStages) * R::kStage;
    const int qs0 = (i0 + st / spt) * kTile, part = st % spt;
    if (part < spt - 1) {
      const bool is_s = part < nkc;
      const int c0 = (is_s ? part : part - nkc) * kKC;
      load_tile(stage, R::kLdk, (is_s ? k : v) + kvoff, stride, Tkv, k0, c0, kKC, D, ub, tid);
      load_tile(stage + kRows * R::kLdk, R::kLdk, (is_s ? q : dout) + qoff, stride, Tq, qs0, c0,
                kKC, D, ub, tid);
    } else {
      load_tile(stage, R::kLdo, (is_dk ? q : dout) + qoff, stride, Tq, qs0, oc0, kOC, D, ub,
                tid);
    }
  });

  const int kr[2] = {k0 + 16 * warp + gq, k0 + 16 * warp + gq + 8};
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keep[i] = pad == nullptr || kr[i] >= Tkv || pad[static_cast<int64_t>(b) * Tkv + kr[i]] != 0;
  }
  float* pw = Ps + warp * 16 * R::kPld;
  float acc[kNT][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int qs0 = (i0 + j) * kTile;
    float s[kST][4], dp[kST][4];
    product_over_d<T>(s, pipe, nkc, warp, lane);
    if (is_dk) {
      product_over_d<T>(dp, pipe, nkc, warp, lane);
    } else {
      zero(dp);
    }
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = qs0 + 8 * nt + 2 * cq + (e & 1);
        const bool real = qi < Tq;
        const float x = masked(s[nt][e] * scale, qi, kr[i], Tq, Tkv, causal, keep[i]);
        const float p = expf(x - (real ? lse[stat0 + qi] : 0.f));
        s[nt][e] = is_dk ? p * (dp[nt][e] - (real ? delta[stat0 + qi] : 0.f)) : p;
      }
    }
    pv<kNT, kST, false>(acc, s, pw, pipe.next(), R::kLdo, lane);
  }
  const float mul[2] = {is_dk ? scale : 1.f, is_dk ? scale : 1.f};
  store_chunk(acc, (is_dk ? dk : dv) + kvoff + oc0, stride, kr, Tkv, own, D, mul, cq);
}

// ----------------------------------------------------------- launchers

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *pad, *dout, *o, *lse_in;
  void* delta;  // written by dq (from dout and o), read by dk/dv
  void *out_o, *lse, *dq, *dk, *dv;
  int B, Tq, Tkv, H, D, causal;
  float scale;
};

// grids: (row tile x output chunk, head, batch); dk/dv's chunks are dv's
// then dk's
template <typename T>
cudaError_t run(int which, const Args& a, cudaStream_t s) {
  const int n_oc = (a.D + kOC - 1) / kOC;
  const int ub = row_unit(static_cast<int64_t>(a.D) * sizeof(T));
  const int64_t n_qt = (a.Tq + kRows - 1) / kRows, n_kt = (a.Tkv + kRows - 1) / kRows;
  const int64_t x = which == 2 ? n_kt * 2 * n_oc : n_qt * n_oc;
  if (x >= (int64_t{1} << 31) || a.H > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(x), a.H, a.B);
  constexpr size_t smem = Ring<T>::bytes;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* pad = static_cast<const int*>(a.pad);
  if (which == 0) {
    return launch(flash_fwd_kernel_wide<T>, grid, smem, s, q, k, v, pad, static_cast<T*>(a.out_o),
                  static_cast<float*>(a.lse), a.Tq, a.Tkv, a.H, a.D, n_oc, a.causal, a.scale, ub);
  }
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse_in);
  if (which == 1) {
    return launch(flash_dq_kernel_wide<T>, grid, smem, s, q, k, v, pad, dout,
                  static_cast<const T*>(a.o), lse, static_cast<float*>(a.delta),
                  static_cast<T*>(a.dq), a.Tq, a.Tkv, a.H, a.D, n_oc, a.causal, a.scale, ub);
  }
  return launch(flash_dkv_kernel_wide<T>, grid, smem, s, q, k, v, pad, dout, lse,
                static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
                static_cast<T*>(a.dv), a.Tq, a.Tkv, a.H, a.D, n_oc, a.causal, a.scale, ub);
}

int dispatch(int which, int D, int W, int dtype, const Args& a, void* stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tkv <= 0 || a.H <= 0) return 0;
  if (D <= 0 || W != D || (which == 1 && a.o == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(run<float>(which, a, s));
  if (dtype == 1) return static_cast<int>(run<bf16>(which, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
const void* kernel_of(int which) {
  return which == 0   ? reinterpret_cast<const void*>(flash_fwd_kernel_wide<T>)
         : which == 1 ? reinterpret_cast<const void*>(flash_dq_kernel_wide<T>)
                      : reinterpret_cast<const void*>(flash_dkv_kernel_wide<T>);
}

}  // namespace

// The entry points of flash_attention.cu, at any head_dim D (the kernel's
// and the tensors' width at once: W must equal D). Every tensor is
// contiguous: q, o, dq [B, Tq, H, D]; k, v, dk, dv [B, Tkv, H, D], all in
// dtype (0 = float32, 1 = bfloat16), 16-byte aligned; pad [B, Tkv] int32
// or null; lse, delta [B, H, Tq] float32. `lse` may be null (no gradient
// will be taken).

extern "C" int hyperion_flash_wide_fwd(const void* q, const void* k, const void* v,
                                       const void* pad, void* o, void* lse, int B, int Tq,
                                       int Tkv, int H, int D, int W, int causal, float scale,
                                       int dtype, void* stream) {
  Args a{q, k, v, pad, nullptr, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         B, Tq, Tkv, H, D, causal, scale};
  return dispatch(0, D, W, dtype, a, stream);
}

// dq computes delta = sum(dO * O) from `dout` and `o` and writes it to
// `delta` for the dk/dv launch.
extern "C" int hyperion_flash_wide_dq(const void* q, const void* k, const void* v,
                                      const void* pad, const void* dout, const void* o,
                                      const void* lse, void* delta, void* dq, int B, int Tq,
                                      int Tkv, int H, int D, int W, int causal, float scale,
                                      int dtype, void* stream) {
  Args a{q, k, v, pad, dout, o, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         B, Tq, Tkv, H, D, causal, scale};
  return dispatch(1, D, W, dtype, a, stream);
}

extern "C" int hyperion_flash_wide_dkv(const void* q, const void* k, const void* v,
                                       const void* pad, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int Tq,
                                       int Tkv, int H, int D, int W, int causal, float scale,
                                       int dtype, void* stream) {
  Args a{q, k, v, pad, dout, nullptr, lse, const_cast<void*>(delta), nullptr, nullptr, nullptr,
         dk, dv, B, Tq, Tkv, H, D, causal, scale};
  return dispatch(2, D, W, dtype, a, stream);
}

// What the compiler gave the kernel `which` (0 forward, 1 dq, 2 dk/dv)
// launches in dtype (the same function at every D): out = {registers a
// thread, local-memory (spill) bytes a thread, shared memory a block
// (static + dynamic), threads a block}, and in `name` (`cap` bytes) the
// function's signature as the runtime names it, demangled.
extern "C" int hyperion_flash_wide_attrs(int which, int D, int W, int dtype, int* out,
                                         char* name, int cap) {
  if (D <= 0 || W != D || which < 0 || which > 2 || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = nullptr;
  size_t smem = 0;
  if (dtype == 0) {
    fn = kernel_of<float>(which);
    smem = Ring<float>::bytes;
  } else if (dtype == 1) {
    fn = kernel_of<bf16>(which);
    smem = Ring<bf16>::bytes;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const char* mangled = nullptr;
  if ((e = cudaFuncGetName(&mangled, fn)) != cudaSuccess) return static_cast<int>(e);
  int status = 0;
  char* full = abi::__cxa_demangle(mangled, nullptr, nullptr, &status);
  const char* src = status == 0 ? full : mangled;
  int n = 0;
  for (; src[n] != '\0' && n < cap - 1; ++n) name[n] = src[n];
  name[n] = '\0';
  free(full);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = kThreads;
  return 0;
}
