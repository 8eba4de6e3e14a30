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
// The softmax runs in the natural domain with expf and logf, as the
// split-TF32 kernels: m starts at NEG_INF, and a row whose keys are all
// masked gets p = 1 from the same rounding as the plain version.
//
// bf16 (`flash_{fwd,dq,dkv}_kernel_wide<bf16>`), first versions, right
// before fast:
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
//  * mma.sync m16n8k16 with fp32 accumulators (fragments by ldmatrix), p
//    and ds rounded to bf16 as the contract has it.
//  * No atomics: every output element has one writer. Every dq block of
//    a row tile computes delta by the same sums; chunk 0's writes it.
//  * No masking fast path and no skip of a warp's tiles past its causal
//    frontier: the block walks the key tiles up to its last row's.
//  * __launch_bounds__(128, 1): without the minimum of blocks, ptxas held
//    the kernels to three blocks an SM and spilled.
//
// fp32 (`flash_{fwd,dq,dkv}_kernel_wide_tf32`): see "fp32" below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <cxxabi.h>
#include <type_traits>

#include "mma_tiles.cuh"
#include "sm90.cuh"

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
// output columns (kTile rows of kLdo). bf16 only: fp32 runs the
// split-TF32 kernels below.
template <typename T>
struct Ring {
  static_assert(std::is_same<T, bf16>::value, "the bf16 kernels' ring");
  static constexpr int kStages = 4;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLdk = kKC + kVec;  // rows padded by 16 bytes
  static constexpr int kLdo = kOC + kVec;
  static constexpr int kPair = (kRows + kTile) * kLdk;
  static constexpr int kStage = kPair > kTile * kLdo ? kPair : kTile * kLdo;
  static constexpr size_t bytes = sizeof(T) * kStages * kStage;
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
    pv<kNT, kST, false>(acc, s, nullptr, pipe.next(), R::kLdo, lane);
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
    pv<kNT, kST, false>(acc, s, nullptr, pipe.next(), R::kLdo, lane);
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
    pv<kNT, kST, false>(acc, s, nullptr, pipe.next(), R::kLdo, lane);
  }
  const float mul[2] = {is_dk ? scale : 1.f, is_dk ? scale : 1.f};
  store_chunk(acc, (is_dk ? dk : dv) + kvoff + oc0, stride, kr, Tkv, own, D, mul, cq);
}

// ------------------------------------------------------------------ fp32
//
// The fp32 kernels: split TF32 on a thread-block cluster over D's slices.
// Each (row tile, key tile) computes s (and dp) once over the whole D:
//  * The cluster's C = ceil(D / 128) blocks (`plan`) share one row tile
//    of one head; block `rank` owns the slice [rank sw, rank sw + sw) of
//    D's columns (sw = D / C rounded up to 8, the last slice the rest) and
//    holds that slice of its own rows resident in shared memory, raw and
//    swizzled as in flash_attention.cu (q in the forward; q and dO in dq;
//    k and v in dk/dv), split into hi and lo by each warp as it reads its
//    A fragments. The other side's 32-row tiles stream at the slice's
//    columns: a raw stage filled by cp.async (4-, 8- or 16-byte units:
//    any width, zeros past D and past T) while the tile before it is
//    used, then split once for the block into hi and lo planes.
//  * Products are flash_attention.cu's split TF32: every operand x enters
//    as hi = tf32(x) and lo = tf32(x - hi) (`split_tf32` in
//    ops/flash_attention.py is the plain model), each product the three
//    mma.sync m16n8k8 passes lo.hi + hi.lo + hi.hi into one fp32
//    accumulator. (The partials on TF32 wgmma, A from registers and B
//    from 128-byte-swizzled planes as in the D 256 kernels, ran no
//    faster at lm_d512's layer: the products are not what bounds these
//    kernels.)
//  * Each warp's partial s (or dp) over its block's slice goes, as its
//    m16n8 C fragments, into a slot of its block's shared memory; after
//    one cluster barrier every block reads the same slot of every block
//    through distributed shared memory and sums them in rank order 0, 1,
//    ..., so every block holds the same bits of s, and so the same p, m,
//    l and lse. Two slot buffers by tile parity: a block writes tile j +
//    2's partials only after tile j + 1's barrier, which every block
//    passes only once it has read tile j's, so one cluster barrier a
//    tile suffices (tests/test_torch_flash_wide_tf32.py runs the protocol
//    under random schedules). A last barrier keeps every block's shared
//    memory alive until the others have read it. The exchange is the
//    largest cost left: the remote reads are bound by distributed shared
//    memory's rate, and the barrier couples the cluster every 32 keys.
//  * Then each block runs the softmax and its own slice's output product:
//    p . v (forward), ds . k (dq), p^T . dO and ds^T . q (dk/dv); delta =
//    sum(dO * O) is summed across the cluster the same way, once. Every
//    output element has one writer; lse and delta are written by rank 0.
//  * Forward: 8 warps over 128 query rows, 16 a warp, each its rows' s
//    partial and o columns. dq: 8 warps over 64 rows, warps w < 4 the s
//    partial of rows 16w.., warps w + 4 the dp partial of the same rows;
//    each sums its own across the cluster and hands the sum to the other
//    (`hand_over`: half the remote reads of both summing both); both form
//    ds and each adds ds . k into half of the slice's columns. dk/dv: 8
//    warps over 64 key rows, w < 4 the s^T partial and all of dv's slice,
//    w + 4 the dp^T partial and all of dk's (each warp's accumulator 16 x
//    128); w hands p^T to w + 4.
//  * Shared memory: 198,784 bytes (forward), 199,040 (dq), 198,912
//    (dk/dv): one block an SM. A cluster past 8 blocks (D past 1024, up
//    to 16 x 128 = 2048) is non-portable and launches with its
//    attribute.
//  * Past D 2048 (`flash_*_kernel_wide_tf32_passes`, the same code with
//    kPasses): a block's slices no longer fit one cluster of 16, so block
//    r of the 16 owns the 128-column slices r, r + 16, ... For each tile
//    it loads its own rows and the tile slice by slice (nothing resident,
//    no prefetch), its partial summed over its slices in order, then
//    exchanged as above; the grid runs ceil(D / 2048) passes, and pass p's
//    block r writes slice r + 16 p (lse and delta by pass 0's rank 0). So
//    s is computed once a tile in each pass: ceil(D / 2048) times, where
//    a block per 128 output columns would take ceil(D / 128).
//  * Causal: a 1-D grid runs every head's longest row tiles first (dk/dv:
//    the first key tiles; `tile_of`), tiles past the block's frontier
//    skipped, a warp's tiles past its own skipped by the warp (it still
//    takes every barrier); every block of a cluster walks the same tiles.

namespace tf32 {

constexpr int kSW = 128;           // a block's slice of D, at most
constexpr int kMaxCluster = 16;    // blocks of a cluster: one pass to D 2048
constexpr int kPortable = 8;       // larger clusters need their attribute
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = 32;            // rows of a streamed tile
constexpr int kNS = kKT / 8;       // n8 tiles of s over a streamed tile
constexpr int kNO = kSW / 8;       // n8 tiles of a slice
constexpr int kLd = kSW + 4;       // a plane's row stride: 4 mod 32 banks
constexpr int kFwdRows = 16 * kWarps;  // 16 rows a warp
constexpr int kBwdRows = 8 * kWarps;   // two warps (s and dp) a 16 rows
constexpr int kPlane = kKT * kLd;
constexpr int kStage = kKT * kSW;
constexpr int kSlot = kWarps * kNS * 32 * 4;  // a tile's partials, all warps

// shared memory in words: `own` resident [rows][kSW] slices, four planes
// (hi and lo of two streamed tiles), their raw stage, two slot buffers,
// then `extra` words of per-row flags or statistics
__host__ __device__ constexpr int words(int own, int rows, int extra) {
  return own * rows * kSW + 4 * kPlane + 2 * kStage + 2 * kSlot + extra;
}
constexpr size_t kFwdBytes = 4u * words(1, kFwdRows, kKT);
constexpr size_t kDqBytes = 4u * words(2, kBwdRows, kKT + kBwdRows);
constexpr size_t kDkvBytes = 4u * words(2, kBwdRows, 2 * kKT);

// The cluster for head_dim D: up to 2048, C = ceil(D / 128) blocks of
// slices sw wide (a multiple of 8, at most 128), the last one holding the
// rest of D, in one pass. Past 2048, C = 16 blocks and slices of 128:
// block r owns slices r, r + 16, ... and the grid runs ceil(slices / 16)
// passes, pass p's block r writing slice r + 16 p.
struct Plan {
  int cluster, slice, passes;
};
inline Plan plan(int D) {
  const int C = (D + kSW - 1) / kSW;
  if (C > kMaxCluster) return {kMaxCluster, kSW, (C + kMaxCluster - 1) / kMaxCluster};
  return {C, ((D + C - 1) / C + 7) & ~7, 1};
}

// this block's slice: first column, columns, columns rounded up to 32
// (whole groups of four k-steps; the columns past cw load as zeros)
struct Slice {
  int c0, cw, kw;
};
__device__ __forceinline__ Slice slice_of(int D, int sw, int rank) {
  const int c0 = rank * sw, cw = min(sw, D - c0);
  return {c0, cw, (cw + 31) & ~31};
}

// A cluster's row tile (dk/dv: key tile) and head. The 1-D grid runs the
// clusters in tile order, every (batch, head) of a tile before the next
// tile, so that under a causal mask the longest tiles of all heads start
// first: ordered by head first, the last head's longest tiles started
// after the others' and ran on alone at the end.
struct Tile {
  int order, b, h;
};
__device__ __forceinline__ Tile tile_of(int n_tiles, int H, int C) {
  const int cid = static_cast<int>(blockIdx.x) / C;
  const int n_bh = static_cast<int>(gridDim.x) / C / n_tiles;
  const int bh = cid % n_bh;
  return {cid / n_bh, bh / H, bh % H};
}

// x rounded to TF32 (10 mantissa bits, nearest, ties away) by integer ops
// on its bits, and x = hi + lo as TF32 operands: flash_attention.cu's
// `round_tf32` and `split`. The tensor cores read only the top 19 bits of
// an operand, so lo keeps its rounding increment unmasked.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = round_tf32(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i])) + 0x1000u;
  }
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b, fp32-accurate: the two small terms first, lo . lo dropped
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// word offset of element (r, col) of a resident slice: rows unpadded, the
// 16-byte chunks of row r permuted by chunk ^ (r % 8), so that `frag_a`'s
// reads fall on 32 different banks
__device__ __forceinline__ int swz(int r, int col) {
  return r * kSW + (col ^ ((r & 7) << 2));
}

// rows [t0, t0 + R) of a slice (`x` at its first column, rows `stride`
// floats apart) into a resident slice (kSwz) or a raw [R][kSW] stage:
// columns [0, s.kw) in units of `ub` bytes, zeros at or past s.cw and at
// rows at or past `rows`. s.cw is a whole number of units: the slices
// start on multiples of 8 columns and a row's unit divides its bytes.
// Thread t copies unit t % 2^lg of every (kThreads / 2^lg)-th row from
// row t / 2^lg, 2^lg the units of a row rounded up to a power of two: no
// division a unit.
template <int R, bool kSwz>
__device__ __forceinline__ void load_slice(float* dst, const float* x, int64_t stride,
                                           int rows, int t0, const Slice& s, int ub) {
  const int ue = ub / 4, per_row = s.kw / ue, lg = 32 - __clz(per_row - 1);
  const int u = threadIdx.x & ((1 << lg) - 1), c = u * ue;
  if (u >= per_row) return;
  for (int r = threadIdx.x >> lg; r < R; r += kThreads >> lg) {
    const int t = t0 + r;
    const bool valid = t < rows && c < s.cw;
    copy_unit(dst + (kSwz ? swz(r, c) : r * kSW + c), valid ? x + t * stride + c : x, valid,
              ub);
  }
}

// a raw [kKT][kSW] stage into its hi and lo planes, once for the block
// (the columns past the slice are never read)
__device__ __forceinline__ void split_tile(uint32_t* hi, uint32_t* lo, const float* raw) {
  for (int i = threadIdx.x; i < kKT * kSW / 4; i += kThreads) {
    const int r = i / (kSW / 4), c = (i % (kSW / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * kSW + c);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
    split(x, h, l);
    *reinterpret_cast<uint4*>(hi + r * kLd + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * kLd + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// In the m16n8k8 layout thread (g, c) = (lane / 4, lane % 4) holds A at
// rows g, g + 8 and columns c, c + 4; B at rows (k) c, c + 4 and column
// (n) g; C at rows g, g + 8 and columns 2c, 2c + 1.

// the A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 7 of a
// resident slice, split here
__device__ __forceinline__ FragA frag_a(const float* t, int row0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int r = row0 + g;
  const float x[4] = {t[swz(r, k0 + c)], t[swz(r + 8, k0 + c)], t[swz(r, k0 + c + 4)],
                      t[swz(r + 8, k0 + c + 4)]};
  FragA f;
  split(x, f.hi, f.lo);
  return f;
}

// B(k, n) = T[n0 + n][k0 + k] from a streamed tile's planes (s = q . k^T)
__device__ __forceinline__ FragB frag_bt(const uint32_t* hi, const uint32_t* lo, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  const int off = (n0 + (lane >> 2)) * kLd + k0 + (lane & 3);
  return FragB{{hi[off], hi[off + 4]}, {lo[off], lo[off + 4]}};
}

// B(k, n) = T[k0 + perm(k)][n0 + n], perm(c) = 2c, perm(c + 4) = 2c + 1:
// a streamed tile as it lies, its rows in the order of `frag_c2a`'s k
__device__ __forceinline__ FragB frag_b(const uint32_t* hi, const uint32_t* lo, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  const int off = (k0 + 2 * (lane & 3)) * kLd + n0 + (lane >> 2);
  return FragB{{hi[off], hi[off + kLd]}, {lo[off], lo[off + kLd]}};
}

// an m16n8 C fragment (columns 2c, 2c + 1) as the A fragment of a k-step
// over its 8 columns, k permuted as in `frag_b`
__device__ __forceinline__ FragA frag_c2a(const float (&acc)[4]) {
  const float x[4] = {acc[0], acc[2], acc[1], acc[3]};
  FragA f;
  split(x, f.hi, f.lo);
  return f;
}

// c[16 x kKT] += A[16 x kw] . Bt^T over the slice: A rows row0 .. row0 +
// 15 of a resident slice, Bt the tile's planes (a partial s)
__device__ __forceinline__ void gemm_abt_add(float (&c)[kNS][4], const float* a, int row0,
                                             const uint32_t* bhi, const uint32_t* blo, int kw) {
  for (int k1 = 0; k1 < kw; k1 += 32) {
#pragma unroll
    for (int k0 = k1; k0 < k1 + 32; k0 += 8) {
      const FragA fa = frag_a(a, row0, k0);
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) mma3(c[nt], fa, frag_bt(bhi, blo, 8 * nt, k0));
    }
  }
}
__device__ __forceinline__ void gemm_abt(float (&c)[kNS][4], const float* a, int row0,
                                         const uint32_t* bhi, const uint32_t* blo, int kw) {
  zero(c);
  gemm_abt_add(c, a, row0, bhi, blo, kw);
}

// c[16 x 8 NT] += P . B on columns n0 .. n0 + 8 NT: P the 16 x kKT C
// fragments of s, in registers; B the tile's planes. Every n-tile runs:
// columns past the slice hold what the planes held there and are never
// stored (a condition on each n-tile made the compiler serialise the
// products: the largest single cost it had)
template <int NT>
__device__ __forceinline__ void gemm_pb(float (&c)[NT][4], const float (&p)[kNS][4],
                                        const uint32_t* bhi, const uint32_t* blo, int n0) {
#pragma unroll
  for (int ks = 0; ks < kNS; ++ks) {
    const FragA fa = frag_c2a(p[ks]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma3(c[nt], fa, frag_b(bhi, blo, 8 * ks, n0 + 8 * nt));
  }
}

// ---- the cluster exchange

// distributed shared memory: `addr` (a shared::cta address of this
// block) in block `rank`'s shared memory, and loads from there. The loads
// are volatile, so they stay between the cluster barriers around them.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// every thread of every block of the cluster arrives (publishing its
// shared-memory writes) and waits for all
__device__ __forceinline__ void cluster_sync() {
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

// warp `w`'s slot in the buffer of tile parity `par`: its kNS C
// fragments, a float4 a lane
__device__ __forceinline__ float* slot_of(float* slots, int par, int w) {
  return slots + par * kSlot + w * (kNS * 128);
}
__device__ __forceinline__ void put_partial(float* slot, const float (&s)[kNS][4], int lane) {
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
    *reinterpret_cast<float4*>(slot + (nt * 32 + lane) * 4) =
        make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
  }
}

// the sum, in rank order 0, 1, ..., C - 1, of the partials at `slot` in
// every block of the cluster: the same bits in every block. The ranks go
// in groups of 4, then 2, then 1, each group's loads in flight before
// its adds, with no condition inside a group (one there let the compiler
// serialise the loads).
template <int G>
__device__ __forceinline__ void add_ranks(float (&s)[kNS][4], uint32_t a, int r0) {
  float4 x[G][kNS];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint32_t ra = map_rank(a, r0 + j);
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) x[j][nt] = ld_cluster4(ra + nt * 512);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
      s[nt][0] += x[j][nt].x;
      s[nt][1] += x[j][nt].y;
      s[nt][2] += x[j][nt].z;
      s[nt][3] += x[j][nt].w;
    }
  }
}
__device__ __forceinline__ void sum_partials(float (&s)[kNS][4], const float* slot, int C,
                                             int lane) {
  const uint32_t a = sm90::smem_u32(slot + lane * 4);
  zero(s);
  int r = 0;
  for (; r + 4 <= C; r += 4) add_ranks<4>(s, a, r);
  if (r + 2 <= C) {
    add_ranks<2>(s, a, r);
    r += 2;
  }
  if (r < C) add_ranks<1>(s, a, r);
}

// a warp's fragments handed to the other warp of its row group through
// this block's slot buffer of the other tile parity, free from the tile's
// cluster barrier (every block has read its last partials) until this
// block writes the next tile's; `bar.sync` 1 + row group over the pair
__device__ __forceinline__ void hand_over(float (&mine)[kNS][4], float (&theirs)[kNS][4],
                                          float* spare, int warp, int lane) {
  put_partial(spare + warp * (kNS * 128), mine, lane);
  sm90::named_sync(1 + (warp & 3), 64);
  const float* src = spare + (warp ^ 4) * (kNS * 128) + lane * 4;
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
    const float4 v = *reinterpret_cast<const float4*>(src + nt * 128);
    theirs[nt][0] = v.x;
    theirs[nt][1] = v.y;
    theirs[nt][2] = v.z;
    theirs[nt][3] = v.w;
  }
}

// the scaled, masked logits of a warp's 16 rows against a tile's kKT
// columns in place: `rows` the thread's two query (forward, dq) or key
// (dk/dv) rows; only an edge tile takes the per-element mask
template <bool kKeyRows>
__device__ __forceinline__ void mask_tile(float (&s)[kNS][4], float scale, bool interior,
                                          const int (&rows)[2], int t0, int Tq, int Tkv,
                                          int causal, const int* keep_s, const bool (&keep)[2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * c + (e & 1);
      float x = s[nt][e] * scale;
      if (!interior) {
        if constexpr (kKeyRows) {
          x = masked(x, t0 + col, rows[e >> 1], Tq, Tkv, causal, keep[e >> 1]);
        } else {
          x = masked(x, rows[e >> 1], t0 + col, Tq, Tkv, causal, keep_s[col]);
        }
      }
      s[nt][e] = x;
    }
  }
}

// rows r (this thread's two) of a block's output: columns [n0, n0 + 8 NT)
// of the slice below its cw columns, at out + r * stride, times mul[i]
template <int NT>
__device__ __forceinline__ void store_slice(const float (&acc)[NT][4], float* out,
                                            int64_t stride, const int (&r)[2], int rows,
                                            int n0, int cw, bool pairs, const float (&mul)[2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r[i] < rows) {
        put2_upto(out + r[i] * stride, n0 + 8 * nt + 2 * c, cw, pairs, acc[nt][2 * i] * mul[i],
                  acc[nt][2 * i + 1] * mul[i]);
      }
    }
  }
}

// Past D 2048 (`kPasses`): the slices of D (n_sl), the grid's passes and
// this block's pass: pass p's block `rank` writes slice rank + C p, if
// there is one. A cluster's C blocks lie together along grid x, the
// passes of one tile next to each other.
struct Passes {
  int n_sl, n_pass, pass;
};
__device__ __forceinline__ Passes passes_of(int D, int sw, int C) {
  const int n_sl = (D + sw - 1) / sw, n_pass = (n_sl + C - 1) / C;
  return {n_sl, n_pass, static_cast<int>(blockIdx.x) / C % n_pass};
}

}  // namespace tf32

// o (and lse) for 128 query rows of one head and one slice of D, the
// block `rank` of its row tile's cluster. kPasses (D past 2048): the
// block's own rows are not resident; each key tile loads them and the
// tile slice by slice, its partial s summed over its slices in order,
// then the v tile of the slice it writes in this pass.
template <bool kPasses>
__device__ __forceinline__ void fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v, const int* __restrict__ pad,
                                         float* __restrict__ o, float* __restrict__ lse, int Tq,
                                         int Tkv, int H, int D, int sw, int causal, float scale,
                                         int ub) {
  using namespace tf32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Qs + kFwdRows * kSW);
  uint32_t* Kl = Kh + kPlane;
  uint32_t* Vh = Kl + kPlane;
  uint32_t* Vl = Vh + kPlane;
  float* Kraw = reinterpret_cast<float*>(Vl + kPlane);
  float* Vraw = Kraw + kStage;
  float* slots = Vraw + kStage;
  int* keep_s = reinterpret_cast<int*>(slots + 2 * kSlot);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int C = static_cast<int>(sm90::cluster_nctarank());
  const Passes ps = kPasses ? passes_of(D, sw, C) : Passes{C, 1, 0};
  const int out_sl = rank + C * ps.pass;  // the slice this block writes
  const bool has_out = !kPasses || out_sl < ps.n_sl;
  const Slice sl = slice_of(D, sw, has_out ? out_sl : rank);
  const int n_qt = (Tq + kFwdRows - 1) / kFwdRows;
  const Tile t = tile_of(n_qt, H, C * ps.n_pass);
  // causal: the last query tiles see the most key tiles; launch them first
  const int q0 = (causal ? n_qt - 1 - t.order : t.order) * kFwdRows;
  const int h = t.h, b = t.b;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + static_cast<int64_t>(h) * D + sl.c0;
  const int64_t kvoff =
      static_cast<int64_t>(b) * Tkv * stride + static_cast<int64_t>(h) * D + sl.c0;
  const int n_kv = (Tkv + kKT - 1) / kKT;
  const int n_tiles = causal ? min(n_kv, min(q0 + kFwdRows - 1, Tq - 1) / kKT + 1) : n_kv;
  const int m0 = 16 * warp, qw = q0 + m0;  // the warp's first query row
  const int rows[2] = {qw + (lane >> 2), qw + (lane >> 2) + 8};
  const bool no_keep[2] = {true, true};

  // key tile `it` raw into the stage, one cp.async group; this thread's
  // keep flag for it (threads < kKT; true for the others)
  auto fetch = [&](int it) {
    const int k0 = it * kKT;
    load_slice<kKT, false>(Kraw, k + kvoff, stride, Tkv, k0, sl, ub);
    load_slice<kKT, false>(Vraw, v + kvoff, stride, Tkv, k0, sl, ub);
    cp_async_commit();
    bool kp = true;
    if (tid < kKT) {
      const int key = k0 + tid;
      kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
    }
    return kp;
  };
  // the landed stage into the planes, then a barrier; whether every key
  // of the tile is kept
  auto convert = [&](bool kp) {
    split_tile(Kh, Kl, Kraw);
    split_tile(Vh, Vl, Vraw);
    if (tid < kKT) keep_s[tid] = kp;
    return __syncthreads_and(kp) != 0;
  };

  bool kp = true, all_keep = true;
  if constexpr (!kPasses) {
    load_slice<kFwdRows, true>(Qs, q + qoff, stride, Tq, q0, sl, ub);
    kp = fetch(0);  // q and key tile 0 in one group
    cp_async_wait<0>();
    __syncthreads();
    all_keep = convert(kp);
    if (n_tiles > 1) kp = fetch(1);
  }

  float acc[kNO][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKT;
    // a warp whose rows all lie before the tile (causal) or past Tq skips
    // it, in every block of the cluster alike
    const bool active = qw < Tq && !(causal && k0 > qw + 15);
    float* slot = slot_of(slots, it & 1, warp);
    float s[kNS][4];
    if constexpr (kPasses) {
      zero(s);
      for (int j = rank; j < ps.n_sl; j += C) {
        const Slice sj = slice_of(D, sw, j);
        load_slice<kFwdRows, true>(Qs, q + qoff - sl.c0 + sj.c0, stride, Tq, q0, sj, ub);
        load_slice<kKT, false>(Kraw, k + kvoff - sl.c0 + sj.c0, stride, Tkv, k0, sj, ub);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        split_tile(Kh, Kl, Kraw);
        __syncthreads();
        if (active) gemm_abt_add(s, Qs, m0, Kh, Kl, sj.kw);
        __syncthreads();  // q's slice and the planes are read
      }
      if (has_out) load_slice<kKT, false>(Vraw, v + kvoff, stride, Tkv, k0, sl, ub);
      cp_async_commit();
      kp = true;
      if (tid < kKT) {
        const int key = k0 + tid;
        kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
      }
      cp_async_wait<0>();
      __syncthreads();
      split_tile(Vh, Vl, Vraw);
      if (tid < kKT) keep_s[tid] = kp;
      all_keep = __syncthreads_and(kp) != 0;
      if (active) put_partial(slot, s, lane);
    } else if (active) {
      gemm_abt(s, Qs, m0, Kh, Kl, sl.kw);
      put_partial(slot, s, lane);
    }
    cluster_sync();
    if (active) {
      sum_partials(s, slot, C, lane);
      const bool interior = k0 + kKT <= Tkv && all_keep && qw + 15 < Tq &&
                            (!causal || k0 + kKT - 1 <= qw);
      mask_tile<false>(s, scale, interior, rows, k0, Tq, Tkv, causal, keep_s, no_keep);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m[e >> 1]);
          sum[e >> 1] += s[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
      for (int nt = 0; nt < kNO; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }
      if (has_out) gemm_pb<kNO>(acc, s, Vh, Vl, 0);
    }
    if constexpr (!kPasses) {
      if (it + 1 < n_tiles) {
        cp_async_wait<0>();
        __syncthreads();  // the planes are read and the next stage has landed
        all_keep = convert(kp);
        if (it + 2 < n_tiles) kp = fetch(it + 2);
      }
    }
  }
  cluster_sync();  // the other blocks have read this block's slots

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
    if (lse != nullptr && rank == 0 && ps.pass == 0 && (lane & 3) == 0 && rows[i] < Tq) {
      lse[(static_cast<int64_t>(b) * H + h) * Tq + rows[i]] = m[i] + logf(l[i]);
    }
  }
  if (has_out) store_slice(acc, o + qoff, stride, rows, Tq, 0, sl.cw, (D & 1) == 0, inv);
}

__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_fwd_kernel_wide_tf32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ pad,
                           float* __restrict__ o, float* __restrict__ lse, int Tq, int Tkv,
                           int H, int D, int sw, int causal, float scale, int ub) {
  fwd_tf32<false>(q, k, v, pad, o, lse, Tq, Tkv, H, D, sw, causal, scale, ub);
}
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_fwd_kernel_wide_tf32_passes(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const int* __restrict__ pad,
                                  float* __restrict__ o, float* __restrict__ lse, int Tq, int Tkv,
                                  int H, int D, int sw, int causal, float scale, int ub) {
  fwd_tf32<true>(q, k, v, pad, o, lse, Tq, Tkv, H, D, sw, causal, scale, ub);
}

// dq for 64 query rows of one head and one slice of D, and delta =
// sum(dO * O) for them (rank 0 writes it for dk/dv): warps w < 4 the s
// partial of rows 16w .. 16w + 15, warps w + 4 the dp partial of the
// same rows; both form ds = p (dp - delta) from the sums, then dq += ds
// . k on their half of the slice's columns. kPasses: as the forward's,
// q, dO, k and v slice by slice, then k of the slice written
template <bool kPasses>
__device__ __forceinline__ void dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, const int* __restrict__ pad,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ o, const float* __restrict__ lse,
                                        float* __restrict__ delta, float* __restrict__ dq, int Tq,
                                        int Tkv, int H, int D, int sw, int causal, float scale,
                                        int ub) {
  using namespace tf32;
  constexpr int kHalf = kNO / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + kBwdRows * kSW;
  uint32_t* Kh = reinterpret_cast<uint32_t*>(dOs + kBwdRows * kSW);
  uint32_t* Kl = Kh + kPlane;
  uint32_t* Vh = Kl + kPlane;
  uint32_t* Vl = Vh + kPlane;
  float* Kraw = reinterpret_cast<float*>(Vl + kPlane);
  float* Vraw = Kraw + kStage;
  float* slots = Vraw + kStage;
  int* keep_s = reinterpret_cast<int*>(slots + 2 * kSlot);
  float* dpart = reinterpret_cast<float*>(keep_s + kKT);  // this slice's delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int grp = warp >> 2, rw = warp & 3;  // 0: s, 1: dp; the row group
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int C = static_cast<int>(sm90::cluster_nctarank());
  const Passes ps = kPasses ? passes_of(D, sw, C) : Passes{C, 1, 0};
  const int out_sl = rank + C * ps.pass;
  const bool has_out = !kPasses || out_sl < ps.n_sl;
  const Slice sl = slice_of(D, sw, has_out ? out_sl : rank);
  const int n_qt = (Tq + kBwdRows - 1) / kBwdRows;
  const Tile t = tile_of(n_qt, H, C * ps.n_pass);
  const int q0 = (causal ? n_qt - 1 - t.order : t.order) * kBwdRows;
  const int h = t.h, b = t.b;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + static_cast<int64_t>(h) * D + sl.c0;
  const int64_t kvoff =
      static_cast<int64_t>(b) * Tkv * stride + static_cast<int64_t>(h) * D + sl.c0;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int n_kv = (Tkv + kKT - 1) / kKT;
  const int n_tiles = causal ? min(n_kv, min(q0 + kBwdRows - 1, Tq - 1) / kKT + 1) : n_kv;
  const int m0 = 16 * rw, qw = q0 + m0;
  const int rows[2] = {qw + g, qw + g + 8};
  const bool no_keep[2] = {true, true};

  auto fetch = [&](int it) {
    const int k0 = it * kKT;
    load_slice<kKT, false>(Kraw, k + kvoff, stride, Tkv, k0, sl, ub);
    load_slice<kKT, false>(Vraw, v + kvoff, stride, Tkv, k0, sl, ub);
    cp_async_commit();
    bool kp = true;
    if (tid < kKT) {
      const int key = k0 + tid;
      kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
    }
    return kp;
  };
  auto convert = [&](bool kp) {
    split_tile(Kh, Kl, Kraw);
    split_tile(Vh, Vl, Vraw);
    if (tid < kKT) keep_s[tid] = kp;
    return __syncthreads_and(kp) != 0;
  };

  bool kp = true, all_keep = true;
  if constexpr (!kPasses) {
    load_slice<kBwdRows, true>(Qs, q + qoff, stride, Tq, q0, sl, ub);
    load_slice<kBwdRows, true>(dOs, dout + qoff, stride, Tq, q0, sl, ub);
    kp = fetch(0);  // q, dO and key tile 0 in one group
    cp_async_wait<0>();
    __syncthreads();
  }

  // delta over the slice: four threads a row, 32 columns each in order,
  // then the quads' sum; then the cluster's slices in rank order
  // (kPasses: over the block's slices in order, from global memory)
  {
    const int r = tid >> 2, part = tid & 3, qi = q0 + r;
    float sum = 0.f;
    if (qi < Tq) {
      const float* orow = o + qoff + qi * stride;
      if constexpr (kPasses) {
        const float* grow = dout + qoff + qi * stride;
        for (int j = rank; j < ps.n_sl; j += C) {
          const Slice sj = slice_of(D, sw, j);
          const int end = min(32 * part + 32, sj.cw);
          for (int c = 32 * part; c < end; ++c) {
            sum = fmaf(grow[sj.c0 - sl.c0 + c], orow[sj.c0 - sl.c0 + c], sum);
          }
        }
      } else {
        const int end = min(32 * part + 32, sl.cw);
        for (int j = 32 * part; j < end; ++j) sum = fmaf(dOs[swz(r, j)], orow[j], sum);
      }
    }
    sum = quad_sum(sum);
    if (part == 0) dpart[r] = sum;
  }
  cluster_sync();
  float row_delta[2] = {0.f, 0.f}, row_lse[2];
  {
    const uint32_t a = sm90::smem_u32(dpart + m0 + g);
    for (int r = 0; r < C; ++r) {
      const uint32_t ra = map_rank(a, r);
      row_delta[0] += ld_cluster(ra);
      row_delta[1] += ld_cluster(ra + 32);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rank == 0 && ps.pass == 0 && grp == 0 && (lane & 3) == 0 && rows[i] < Tq) {
      delta[stat0 + rows[i]] = row_delta[i];
    }
    row_lse[i] = rows[i] < Tq ? lse[stat0 + rows[i]] : 0.f;
  }

  if constexpr (!kPasses) {
    all_keep = convert(kp);
    if (n_tiles > 1) kp = fetch(1);
  }

  const int n0 = kHalf * 8 * grp;  // this warp's half of the slice
  float acc[kHalf][4];
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKT;
    const bool active = qw < Tq && !(causal && k0 > qw + 15);
    float s[kNS][4];
    if constexpr (kPasses) {
      zero(s);
      for (int j = rank; j < ps.n_sl; j += C) {
        const Slice sj = slice_of(D, sw, j);
        const int64_t dc = sj.c0 - sl.c0;
        load_slice<kBwdRows, true>(Qs, q + qoff + dc, stride, Tq, q0, sj, ub);
        load_slice<kBwdRows, true>(dOs, dout + qoff + dc, stride, Tq, q0, sj, ub);
        load_slice<kKT, false>(Kraw, k + kvoff + dc, stride, Tkv, k0, sj, ub);
        load_slice<kKT, false>(Vraw, v + kvoff + dc, stride, Tkv, k0, sj, ub);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        split_tile(Kh, Kl, Kraw);
        split_tile(Vh, Vl, Vraw);
        __syncthreads();
        if (active) {
          gemm_abt_add(s, grp == 0 ? Qs : dOs, m0, grp == 0 ? Kh : Vh, grp == 0 ? Kl : Vl,
                       sj.kw);
        }
        __syncthreads();  // the own slices and the planes are read
      }
      // k of the slice this block writes, and the tile's keep flags
      if (has_out) load_slice<kKT, false>(Kraw, k + kvoff, stride, Tkv, k0, sl, ub);
      cp_async_commit();
      kp = true;
      if (tid < kKT) {
        const int key = k0 + tid;
        kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
      }
      cp_async_wait<0>();
      __syncthreads();
      if (has_out) split_tile(Kh, Kl, Kraw);
      if (tid < kKT) keep_s[tid] = kp;
      all_keep = __syncthreads_and(kp) != 0;
      if (active) put_partial(slot_of(slots, it & 1, warp), s, lane);
    } else if (active) {
      gemm_abt(s, grp == 0 ? Qs : dOs, m0, grp == 0 ? Kh : Vh, grp == 0 ? Kl : Vl, sl.kw);
      put_partial(slot_of(slots, it & 1, warp), s, lane);
    }
    cluster_sync();
    if (active) {
      // warp w sums s, warp w + 4 dp, and each hands its sum to the other
      float own[kNS][4], other[kNS][4], dp[kNS][4];
      sum_partials(own, slot_of(slots, it & 1, warp), C, lane);
      hand_over(own, other, slots + ((it + 1) & 1) * kSlot, warp, lane);
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = grp == 0 ? own[nt][e] : other[nt][e];
          dp[nt][e] = grp == 0 ? other[nt][e] : own[nt][e];
        }
      }
      const bool interior = k0 + kKT <= Tkv && all_keep && qw + 15 < Tq &&
                            (!causal || k0 + kKT - 1 <= qw);
      mask_tile<false>(s, scale, interior, rows, k0, Tq, Tkv, causal, keep_s, no_keep);
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[nt][e] = expf(s[nt][e] - row_lse[i]) * (dp[nt][e] - row_delta[i]);
        }
      }
      if (has_out) gemm_pb<kHalf>(acc, s, Kh, Kl, n0);
    }
    if constexpr (!kPasses) {
      if (it + 1 < n_tiles) {
        cp_async_wait<0>();
        __syncthreads();
        all_keep = convert(kp);
        if (it + 2 < n_tiles) kp = fetch(it + 2);
      }
    }
  }
  cluster_sync();
  const float mul[2] = {scale, scale};
  if (has_out) store_slice(acc, dq + qoff, stride, rows, Tq, n0, sl.cw, (D & 1) == 0, mul);
}

__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dq_kernel_wide_tf32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ pad,
                          const float* __restrict__ dout, const float* __restrict__ o,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          float* __restrict__ dq, int Tq, int Tkv, int H, int D, int sw,
                          int causal, float scale, int ub) {
  dq_tf32<false>(q, k, v, pad, dout, o, lse, delta, dq, Tq, Tkv, H, D, sw, causal, scale, ub);
}
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dq_kernel_wide_tf32_passes(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ pad,
                                 const float* __restrict__ dout, const float* __restrict__ o,
                                 const float* __restrict__ lse, float* __restrict__ delta,
                                 float* __restrict__ dq, int Tq, int Tkv, int H, int D, int sw,
                                 int causal, float scale, int ub) {
  dq_tf32<true>(q, k, v, pad, dout, o, lse, delta, dq, Tq, Tkv, H, D, sw, causal, scale, ub);
}

// dk and dv for 64 key rows of one head and one slice of D: warps w < 4
// the s^T = k . q^T partial of key rows 16w .. 16w + 15 and dv += p^T .
// dO on the slice; warps w + 4 the dp^T = v . dO^T partial of the same
// rows and dk += ds^T . q; p^T and ds^T from the cluster's sums.
// kPasses: as the forward's, k, v, q and dO slice by slice, then q and dO
// of the slice written
template <bool kPasses>
__device__ __forceinline__ void dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v, const int* __restrict__ pad,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, float* __restrict__ dk,
                                         float* __restrict__ dv, int Tq, int Tkv, int H, int D,
                                         int sw, int causal, float scale, int ub) {
  using namespace tf32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kBwdRows * kSW;
  uint32_t* Qh = reinterpret_cast<uint32_t*>(Vs + kBwdRows * kSW);
  uint32_t* Ql = Qh + kPlane;
  uint32_t* Dh = Ql + kPlane;  // dO
  uint32_t* Dl = Dh + kPlane;
  float* Qraw = reinterpret_cast<float*>(Dl + kPlane);
  float* Draw = Qraw + kStage;
  float* slots = Draw + kStage;
  float* lse_s = slots + 2 * kSlot;
  float* delta_s = lse_s + kKT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int grp = warp >> 2, rw = warp & 3;  // 0: s^T and dv, 1: dp^T and dk
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int C = static_cast<int>(sm90::cluster_nctarank());
  const Passes ps = kPasses ? passes_of(D, sw, C) : Passes{C, 1, 0};
  const int out_sl = rank + C * ps.pass;
  const bool has_out = !kPasses || out_sl < ps.n_sl;
  const Slice sl = slice_of(D, sw, has_out ? out_sl : rank);
  // causal: the first key tiles see the most query tiles, and start first
  const Tile t = tile_of((Tkv + kBwdRows - 1) / kBwdRows, H, C * ps.n_pass);
  const int k0 = t.order * kBwdRows;
  const int h = t.h, b = t.b;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + static_cast<int64_t>(h) * D + sl.c0;
  const int64_t kvoff =
      static_cast<int64_t>(b) * Tkv * stride + static_cast<int64_t>(h) * D + sl.c0;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int n_q = (Tq + kKT - 1) / kKT;
  const int first = causal ? min(k0 / kKT, n_q) : 0;
  const int n_tiles = n_q - first;
  const int m0 = 16 * rw, kw0 = k0 + m0;  // the warp's first key row
  const int kr[2] = {kw0 + g, kw0 + g + 8};
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keep[i] = kr[i] < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + kr[i]] != 0);
  }
  const bool warp_keep = __all_sync(0xffffffffu, keep[0] && keep[1]);

  // query tile `it` (q and dO) raw into the stage, one cp.async group,
  // and its lse and delta into registers (threads < kKT)
  float next_lse = 0.f, next_delta = 0.f;
  auto fetch = [&](int it) {
    const int q0 = (first + it) * kKT;
    load_slice<kKT, false>(Qraw, q + qoff, stride, Tq, q0, sl, ub);
    load_slice<kKT, false>(Draw, dout + qoff, stride, Tq, q0, sl, ub);
    cp_async_commit();
    if (tid < kKT) {
      const bool in = q0 + tid < Tq;
      next_lse = in ? lse[stat0 + q0 + tid] : 0.f;
      next_delta = in ? delta[stat0 + q0 + tid] : 0.f;
    }
  };
  auto convert = [&]() {
    split_tile(Qh, Ql, Qraw);
    split_tile(Dh, Dl, Draw);
    if (tid < kKT) {
      lse_s[tid] = next_lse;
      delta_s[tid] = next_delta;
    }
    __syncthreads();
  };

  if constexpr (!kPasses) {
    load_slice<kBwdRows, true>(Ks, k + kvoff, stride, Tkv, k0, sl, ub);
    load_slice<kBwdRows, true>(Vs, v + kvoff, stride, Tkv, k0, sl, ub);
    if (n_tiles > 0) {
      fetch(0);  // k, v and query tile 0 in one group
    } else {
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (n_tiles > 0) convert();
    if (n_tiles > 1) fetch(1);
  }

  float acc[kNO][4];  // dv (warps < 4) or dk
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (first + it) * kKT;
    // a warp whose keys all lie after the tile's queries (causal), or
    // past Tkv, skips it
    const bool active = kw0 < Tkv && !(causal && kw0 > q0 + kKT - 1);
    float s[kNS][4];
    if constexpr (kPasses) {
      zero(s);
      for (int j = rank; j < ps.n_sl; j += C) {
        const Slice sj = slice_of(D, sw, j);
        const int64_t dc = sj.c0 - sl.c0;
        load_slice<kBwdRows, true>(Ks, k + kvoff + dc, stride, Tkv, k0, sj, ub);
        load_slice<kBwdRows, true>(Vs, v + kvoff + dc, stride, Tkv, k0, sj, ub);
        load_slice<kKT, false>(Qraw, q + qoff + dc, stride, Tq, q0, sj, ub);
        load_slice<kKT, false>(Draw, dout + qoff + dc, stride, Tq, q0, sj, ub);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        split_tile(Qh, Ql, Qraw);
        split_tile(Dh, Dl, Draw);
        __syncthreads();
        if (active) {
          gemm_abt_add(s, grp == 0 ? Ks : Vs, m0, grp == 0 ? Qh : Dh, grp == 0 ? Ql : Dl,
                       sj.kw);
        }
        __syncthreads();  // the own slices and the planes are read
      }
      // q and dO of the slice this block writes, the tile's lse and delta
      if (has_out) {
        fetch(it);
      } else {
        cp_async_commit();
        if (tid < kKT) {
          const bool in = q0 + tid < Tq;
          next_lse = in ? lse[stat0 + q0 + tid] : 0.f;
          next_delta = in ? delta[stat0 + q0 + tid] : 0.f;
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      convert();
      if (active) put_partial(slot_of(slots, it & 1, warp), s, lane);
    } else if (active) {
      gemm_abt(s, grp == 0 ? Ks : Vs, m0, grp == 0 ? Qh : Dh, grp == 0 ? Ql : Dl, sl.kw);
      put_partial(slot_of(slots, it & 1, warp), s, lane);
    }
    cluster_sync();
    if (active) {
      // warp w: p^T = exp(s^T - lse) (rows are keys, columns queries),
      // handed to warp w + 4, which sums dp^T
      const int c = lane & 3;
      float* spare = slots + ((it + 1) & 1) * kSlot;
      sum_partials(s, slot_of(slots, it & 1, warp), C, lane);
      if (grp == 0) {
        const bool interior = q0 + kKT <= Tq && warp_keep && (!causal || kw0 + 15 <= q0);
        mask_tile<true>(s, scale, interior, kr, q0, Tq, Tkv, causal, nullptr, keep);
#pragma unroll
        for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - lse_s[8 * nt + 2 * c + (e & 1)]);
        }
        put_partial(spare + warp * (kNS * 128), s, lane);
        sm90::named_sync(1 + rw, 64);
        if (has_out) gemm_pb<kNO>(acc, s, Dh, Dl, 0);
      } else {
        // ds^T = p^T (dp^T - delta)
        sm90::named_sync(1 + rw, 64);
        const float* src = spare + rw * (kNS * 128) + lane * 4;
#pragma unroll
        for (int nt = 0; nt < kNS; ++nt) {
          const float4 pt = *reinterpret_cast<const float4*>(src + nt * 128);
          const float pv[4] = {pt.x, pt.y, pt.z, pt.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = pv[e] * (s[nt][e] - delta_s[8 * nt + 2 * c + (e & 1)]);
          }
        }
        if (has_out) gemm_pb<kNO>(acc, s, Qh, Ql, 0);
      }
    }
    if constexpr (!kPasses) {
      if (it + 1 < n_tiles) {
        cp_async_wait<0>();
        __syncthreads();  // the planes are read and the next stage has landed
        convert();
        if (it + 2 < n_tiles) fetch(it + 2);
      }
    }
  }
  cluster_sync();
  const float mul[2] = {grp == 0 ? 1.f : scale, grp == 0 ? 1.f : scale};
  if (has_out) {
    store_slice(acc, (grp == 0 ? dv : dk) + kvoff, stride, kr, Tkv, 0, sl.cw, (D & 1) == 0, mul);
  }
}

__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dkv_kernel_wide_tf32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ pad,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int Tq, int Tkv, int H, int D, int sw,
                           int causal, float scale, int ub) {
  dkv_tf32<false>(q, k, v, pad, dout, lse, delta, dk, dv, Tq, Tkv, H, D, sw, causal, scale, ub);
}
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dkv_kernel_wide_tf32_passes(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const int* __restrict__ pad,
                                  const float* __restrict__ dout, const float* __restrict__ lse,
                                  const float* __restrict__ delta, float* __restrict__ dk,
                                  float* __restrict__ dv, int Tq, int Tkv, int H, int D, int sw,
                                  int causal, float scale, int ub) {
  dkv_tf32<true>(q, k, v, pad, dout, lse, delta, dk, dv, Tq, Tkv, H, D, sw, causal, scale, ub);
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

// the fp32 kernels: clusters of C blocks along grid x, the non-portable
// sizes past 8 with their attribute
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int C, size_t smem, cudaStream_t s,
                           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess && C > tf32::kPortable) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(tf32::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

struct Args {
  const void *q, *k, *v, *pad, *dout, *o, *lse_in;
  void* delta;  // written by dq (from dout and o), read by dk/dv
  void *out_o, *lse, *dq, *dk, *dv;
  int B, Tq, Tkv, H, D, causal;
  float scale;
};

// bf16 grids: (row tile x output chunk, head, batch); dk/dv's chunks are
// dv's then dk's
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

// fp32 grids: 1-D, a cluster a (row tile, batch, head, pass) (dk/dv: a
// key tile), in `tile_of`'s order; past D 2048 the `_passes` kernels
cudaError_t run_tf32(int which, const Args& a, cudaStream_t s) {
  const tf32::Plan p = tf32::plan(a.D);
  const int rows = which == 0 ? tf32::kFwdRows : tf32::kBwdRows;
  const int64_t x = static_cast<int64_t>(((which == 2 ? a.Tkv : a.Tq) + rows - 1) / rows) *
                    a.B * a.H * p.cluster * p.passes;
  if (x >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(x));
  const bool passes = p.passes > 1;
  const int ub = row_unit(static_cast<int64_t>(a.D) * sizeof(float));
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int* pad = static_cast<const int*>(a.pad);
  if (which == 0) {
    return launch_cluster(passes ? flash_fwd_kernel_wide_tf32_passes : flash_fwd_kernel_wide_tf32,
                          grid, p.cluster, tf32::kFwdBytes, s, q, k, v, pad,
                          static_cast<float*>(a.out_o), static_cast<float*>(a.lse), a.Tq, a.Tkv,
                          a.H, a.D, p.slice, a.causal, a.scale, ub);
  }
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse_in);
  if (which == 1) {
    return launch_cluster(passes ? flash_dq_kernel_wide_tf32_passes : flash_dq_kernel_wide_tf32,
                          grid, p.cluster, tf32::kDqBytes, s, q, k, v, pad, dout,
                          static_cast<const float*>(a.o), lse, static_cast<float*>(a.delta),
                          static_cast<float*>(a.dq), a.Tq, a.Tkv, a.H, a.D, p.slice, a.causal,
                          a.scale, ub);
  }
  return launch_cluster(passes ? flash_dkv_kernel_wide_tf32_passes : flash_dkv_kernel_wide_tf32,
                        grid, p.cluster, tf32::kDkvBytes, s, q, k, v, pad, dout, lse,
                        static_cast<const float*>(a.delta), static_cast<float*>(a.dk),
                        static_cast<float*>(a.dv), a.Tq, a.Tkv, a.H, a.D, p.slice, a.causal,
                        a.scale, ub);
}

int dispatch(int which, int D, int W, int dtype, const Args& a, void* stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tkv <= 0 || a.H <= 0) return 0;
  if (D <= 0 || W != D || (which == 1 && a.o == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(run_tf32(which, a, s));
  if (dtype == 1) return static_cast<int>(run<bf16>(which, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const void* kernel_of(int which, int D, int dtype) {
  if (dtype == 0 && tf32::plan(D).passes > 1) {
    return which == 0   ? reinterpret_cast<const void*>(flash_fwd_kernel_wide_tf32_passes)
           : which == 1 ? reinterpret_cast<const void*>(flash_dq_kernel_wide_tf32_passes)
                        : reinterpret_cast<const void*>(flash_dkv_kernel_wide_tf32_passes);
  }
  if (dtype == 0) {
    return which == 0   ? reinterpret_cast<const void*>(flash_fwd_kernel_wide_tf32)
           : which == 1 ? reinterpret_cast<const void*>(flash_dq_kernel_wide_tf32)
                        : reinterpret_cast<const void*>(flash_dkv_kernel_wide_tf32);
  }
  return which == 0   ? reinterpret_cast<const void*>(flash_fwd_kernel_wide<bf16>)
         : which == 1 ? reinterpret_cast<const void*>(flash_dq_kernel_wide<bf16>)
                      : reinterpret_cast<const void*>(flash_dkv_kernel_wide<bf16>);
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
// launches in dtype at head_dim D: out = {registers a thread, local-memory
// (spill) bytes a thread, shared memory a block (static + dynamic),
// threads a block, blocks a cluster at this D (1 for bf16)}, and in `name`
// (`cap` bytes) the function's signature as the runtime names it,
// demangled.
extern "C" int hyperion_flash_wide_attrs(int which, int D, int W, int dtype, int* out,
                                         char* name, int cap) {
  if (D <= 0 || W != D || which < 0 || which > 2 || cap <= 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cluster = dtype == 0 ? tf32::plan(D).cluster : 1;
  const size_t smem = dtype == 1    ? Ring<bf16>::bytes
                      : which == 0 ? tf32::kFwdBytes
                      : which == 1 ? tf32::kDqBytes
                                   : tf32::kDkvBytes;
  const void* fn = kernel_of(which, D, dtype);
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
  out[3] = dtype == 0 ? tf32::kThreads : kThreads;
  out[4] = cluster;
  return 0;
}
