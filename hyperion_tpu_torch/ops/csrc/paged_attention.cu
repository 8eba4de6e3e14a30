// paged_attention for Hopper (sm_90a): attention of a query window
// q [B, T, H, D] over pooled K/V [NB, bs, Hkv, D] through the block
// table bt [B, MB], with kv position p visible to query token t of row
// b iff p <= base[b] + t.
//
// Replaces: hyperion_tpu/ops/pallas/paged_attention.py, `paged_attention`
// -> `_decode_kernel` (the Pallas block-table walk with scalar-prefetched
// tables and an online softmax in VMEM scratch).
//
// Bound on the H100: bytes for decode and verify windows, which read
// every visible K/V position of the slot (2 * visible * Hkv * D *
// itemsize) for ~4 flops an element per query row; a [1, C] prefill
// window reuses each K/V tile across its C * rep rows and nears the
// tensor cores' rate. Both shapes run the one kernel below, with a plan
// (rows a block, splits of the chain) that the wrapper derives from the
// shapes alone, never from `base` or the tables, which live on the card:
// the launch reads nothing back and is captured in a CUDA graph whole.
//
// Design:
//  * Grid (row tiles x KV splits, Hkv, B). GQA folds into rows as on the
//    TPU: row r of kv head g is token r / rep and head g*rep + r % rep,
//    so every K/V tile a block stages serves all rep query heads. A block
//    has 1 warp (a window of at most 16 rows: decode, verify) or 4 (64
//    rows: prefill), 16 rows a warp. The tile order runs the longest
//    causal tiles first.
//  * Flash-decoding: the chain [0, MB*bs) is cut into splits of
//    `split_len` positions, and each block walks its split only up to
//    the frontier of its last row and never past the table, so it reads
//    no position no row can see: the null block 0 behind unmapped
//    entries is never touched by a real row. A split wholly past the
//    frontier reads no K/V and writes (m, l) = (-inf, 0).
//  * The block first turns its walk's positions into pool row indices
//    (bt[b, p / bs] * bs + p % bs) in shared memory, then streams K and V
//    in their own dtype (bf16 stays bf16) through a ring of 32-position
//    tiles filled by cp.async, 16 bytes a thread (3 stages in bf16, 2 in
//    fp32); positions past the walk arrive as zeros.
//  * bf16: s = q . k^T and o += p . v on mma.sync m16n8k16 with fp32
//    accumulators, fragments by ldmatrix (v transposed on the way). p
//    enters the second product as two bf16 halves (p = hi + lo), so the
//    output keeps fp32's accuracy, not bf16-rounded weights'.
//  * fp32: the same plan and fragment layout on plain fp32 FMAs (never
//    TF32), p passing through shared memory.
//  * Online softmax in the exp2 domain; a tile takes the per-element mask
//    only where it crosses its warp's nearest frontier or the walk's end.
//    Rows that see nothing yet keep m = -inf and exponentiate against 0,
//    so no exp(-inf - -inf) arises.
//  * One split writes the output directly. More write fp32 partials (m,
//    l, the unnormalised accumulator) to a workspace that the wrapper
//    allocates, and `paged_attention_combine_kernel` (a warp an output
//    row) merges them in split order, with no atomics: two runs give the
//    same bits.
//  * Any head_dim, as the reference's kernel takes any. D a multiple of 16
//    up to 256 runs its own instantiation. Any other D up to 256 runs the
//    next one's kTail twin: q and the pools are read at their true width
//    in the widest unit a row's bytes take (16, 8, 4, or 2 bytes through
//    a plain load), the columns past D are zeros in shared memory (zero
//    terms of q . k^T; their p . v columns are never stored), and the
//    output and the partials are written up to D. Past 256 runs
//    `paged_attention_wide_kernel` (below). No pool is copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "mma_tiles.cuh"

namespace {

using namespace mt;

constexpr int kN = 32;        // kv positions a tile
constexpr int kMaxWarps = 4;  // 16 query rows a warp
constexpr size_t kMaxSmem = 232448;  // what one block may have on sm_90

template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kStages = kBf16 ? 3 : 2;
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kLd = D + kVec;         // a row padded by 16 bytes
  static constexpr int kPld = kN + 4;          // fp32 p rows
  __host__ __device__ static constexpr size_t q_bytes(int warps) {
    return sizeof(T) * 16 * warps * kLd;
  }
  __host__ __device__ static constexpr size_t kv_bytes() {
    return sizeof(T) * kStages * 2 * kN * kLd;
  }
  __host__ __device__ static constexpr size_t p_bytes(int warps) {
    return kBf16 ? 0 : sizeof(float) * warps * 16 * kPld;
  }
  __host__ __device__ static constexpr size_t bytes(int warps, int split_len) {
    return q_bytes(warps) + kv_bytes() + p_bytes(warps) + sizeof(int) * split_len;
  }
};

// element offset of query row r (of kv head g, slot b) in [B, T, H, D]
__device__ __forceinline__ int64_t row_offset(int b, int g, int r, int n_tok, int H,
                                              int rep, int D) {
  return ((static_cast<int64_t>(b) * n_tok + r / rep) * H +
          static_cast<int64_t>(g) * rep + r % rep) * D;
}

// one tile of the online softmax in the exp2 domain: s (the tile's
// scores, this thread's fragment) becomes p, and m, l and acc are
// rescaled to the new running max. The mask is applied only where the
// tile crosses the warp's nearest frontier or the walk's end (`edge`:
// positions past walk_end are zero-filled). Rows that see nothing yet
// keep m = -inf and exponentiate against 0, so no exp(-inf - -inf) arises.
template <int ST, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[ST][4], float (&acc)[NT][4],
                                             float (&m)[2], float (&l)[2], int p0, bool edge,
                                             const int (&front)[2], int walk_end,
                                             float scale_log2, int cq) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[nt][e] * scale_log2;
      if (edge) {
        const int pos = p0 + nt * 8 + 2 * cq + (e & 1);
        if (pos > front[e >> 1] || pos >= walk_end) v = -INFINITY;
      }
      s[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float ref[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    ref[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row that sees nothing yet
    const float alpha = exp2f(m[i] - ref[i]);
    m[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][2 * i] *= alpha;
      acc[nt][2 * i + 1] *= alpha;
    }
  }
#pragma unroll
  for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = exp2f(s[nt][e] - ref[e >> 1]);
      l[e >> 1] += s[nt][e];  // this thread's share; quad-summed at the end
    }
  }
}

// a warp's two rows (r, r + 8: this thread's) at the end of its walk,
// columns [c0, c0 + n) of rows dt wide: with one split the output itself,
// else the fp32 partials of this split, and (m, l) where `stats`. kAll:
// every column pair of the NT tiles is stored (n == dt == 8 NT)
template <bool kAll, typename T, int NT>
__device__ __forceinline__ void store_rows(const float (&acc)[NT][4], const float (&m)[2],
                                           float (&l)[2], T* out, float* part_acc,
                                           float* part_ml, int b, int g, int r_first, int rows,
                                           int last_row, int n_tok, int H, int rep, int dt,
                                           int n_splits, int split, int64_t bg, int c0, int n,
                                           bool stats, int cq) {
  const bool pairs = (dt & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const int r = r_first + 8 * i;
    if (r >= rows || r > last_row) continue;
    if (n_splits == 1) {
      // l > 0: position 0 is visible to every row (base + t >= 0)
      const float inv = 1.f / l[i];
      T* o = out + row_offset(b, g, r, n_tok, H, rep, dt) + c0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (kAll) {
          put2(o + nt * 8 + 2 * cq, acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
        } else {
          put2_upto(o, nt * 8 + 2 * cq, n, pairs, acc[nt][2 * i] * inv,
                    acc[nt][2 * i + 1] * inv);
        }
      }
    } else {
      const int64_t slot = (bg * rows + r) * n_splits + split;
      float* pa = part_acc + slot * dt + c0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (kAll) {
          put2(pa + nt * 8 + 2 * cq, acc[nt][2 * i], acc[nt][2 * i + 1]);
        } else {
          put2_upto(pa, nt * 8 + 2 * cq, n, pairs, acc[nt][2 * i], acc[nt][2 * i + 1]);
        }
      }
      if (stats && cq == 0) {
        part_ml[slot * 2] = m[i];
        part_ml[slot * 2 + 1] = l[i];
      }
    }
  }
}

// kTail: the true width dt is below the instantiation's D (any D in
// 1..256 that is no multiple of 16). The kTail = false instantiations,
// which run every D that is one, are PR 6's code: W = D at compile time.
template <typename T, int D, bool kTail>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ bt,
                       const int* __restrict__ base, T* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int n_tok, int H, int Hkv, int bs, int MB, int rep,
                       int n_splits, int split_len, int row_tiles, int dt,
                       int ub, float scale_log2) {
  using Lay = Layout<T, D>;
  constexpr int LD = Lay::kLd, S = Lay::kStages, VEC = Lay::kVec;
  constexpr int CPP = D / VEC;  // 16-byte chunks a row
  constexpr int NT = D / 8;     // n8 tiles of the output
  constexpr int ST = kN / 8;    // n8 tiles of s

  const int warps = blockDim.x >> 5, nthr = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, cq = lane & 3;
  const int tile_rows = 16 * warps;
  const int rt = row_tiles - 1 - static_cast<int>(blockIdx.x) / n_splits;
  const int split = blockIdx.x % n_splits;
  const int g = blockIdx.y, b = blockIdx.z;
  const int rows = n_tok * rep;
  const int r0 = rt * tile_rows;
  const int last_row = min(r0 + tile_rows, rows) - 1;
  const int b_base = base[b];
  const int s0 = split * split_len;
  // the walk: what the deepest row sees of this split, within the table
  const int walk_end = min(min(s0 + split_len, MB * bs), b_base + last_row / rep + 1);
  const int64_t bg = static_cast<int64_t>(b) * Hkv + g;

  if (walk_end <= s0) {  // only with n_splits > 1: split 0 holds position 0
    for (int r = r0 + tid; r <= last_row; r += nthr) {
      float* ml = part_ml + ((bg * rows + r) * n_splits + split) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + tile_rows * LD;  // [S][kN][LD]
  T* Vs = Ks + S * kN * LD;
  float* Ps = reinterpret_cast<float*>(Vs + S * kN * LD);  // fp32: [warps][16][kPld]
  int* rowidx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(Ps) +
                                       Lay::p_bytes(warps));

  const int n_pos = walk_end - s0;
  const int* btr = bt + static_cast<int64_t>(b) * MB;
  for (int i = tid; i < n_pos; i += nthr) {
    const int p = s0 + i;
    rowidx[i] = btr[p / bs] * bs + p % bs;
  }
  // rows at the kernel's width D in 16-byte chunks; at a true width dt
  // below it in units of `ub` bytes, the columns past dt zeros
  const int W = kTail ? dt : D;
  const int ue = ub / static_cast<int>(sizeof(T));  // elements a unit (kTail)
  if constexpr (!kTail) {
    for (int idx = tid; idx < tile_rows * CPP; idx += nthr) {
      const int r = idx / CPP, c = idx % CPP, rr = r0 + r;
      const bool valid = rr < rows;
      const T* src = valid ? q + row_offset(b, g, rr, n_tok, H, rep, D) + c * VEC : q;
      cp_async<16>(Qs + r * LD + c * VEC, src, valid);
    }
  } else {
    const int upr = D / ue;
    for (int idx = tid; idx < tile_rows * upr; idx += nthr) {
      const int r = idx / upr, c = idx % upr * ue, rr = r0 + r;
      const bool valid = rr < rows && c < dt;
      const T* src = valid ? q + row_offset(b, g, rr, n_tok, H, rep, dt) + c : q;
      copy_unit(Qs + r * LD + c, src, valid, ub);
    }
  }
  __syncthreads();  // rowidx is read by every thread's copies

  const int64_t row_stride = static_cast<int64_t>(Hkv) * W;
  const int64_t head_off = static_cast<int64_t>(g) * W;
  auto load_tile = [&](int j) {
    T* ks = Ks + (j % S) * kN * LD;
    T* vs = Vs + (j % S) * kN * LD;
    if constexpr (!kTail) {
      for (int idx = tid; idx < kN * CPP; idx += nthr) {
        const int i = idx / CPP, c = idx % CPP, p = j * kN + i;
        const bool valid = p < n_pos;
        const int64_t off = valid ? rowidx[p] * row_stride + head_off + c * VEC : 0;
        cp_async<16>(ks + i * LD + c * VEC, kp + off, valid);
        cp_async<16>(vs + i * LD + c * VEC, vp + off, valid);
      }
    } else {
      const int upr = D / ue;
      for (int idx = tid; idx < kN * upr; idx += nthr) {
        const int i = idx / upr, c = idx % upr * ue, p = j * kN + i;
        const bool valid = p < n_pos && c < dt;
        const int64_t off = valid ? rowidx[p] * row_stride + head_off + c : 0;
        copy_unit(ks + i * LD + c, kp + off, valid, ub);
        copy_unit(vs + i * LD + c, vp + off, valid, ub);
      }
    }
  };
  const int n_tiles = (n_pos + kN - 1) / kN;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_async_commit();  // group 0 carries q as well
  }

  const int wrow0 = r0 + 16 * warp;
  const int front[2] = {b_base + (wrow0 + gq) / rep, b_base + (wrow0 + gq + 8) / rep};
  const int warp_front = b_base + wrow0 / rep;  // the warp's nearest frontier
  const T* Qw = Qs + 16 * warp * LD;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile j landed for all; tile j - 1's stage is free
    if (j + S - 1 < n_tiles) load_tile(j + S - 1);
    cp_async_commit();
    const T* ks = Ks + (j % S) * kN * LD;
    const T* vs = Vs + (j % S) * kN * LD;
    const int p0 = s0 + j * kN;

    float s[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (Lay::kBf16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < D; k += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(Qw + gq * LD + k);
        const float4 a1 = *reinterpret_cast<const float4*>(Qw + (gq + 8) * LD + k);
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
          const float4 b0 = *reinterpret_cast<const float4*>(ks + (nt * 8 + 2 * cq) * LD + k);
          const float4 b1 = *reinterpret_cast<const float4*>(ks + (nt * 8 + 2 * cq + 1) * LD + k);
          s[nt][0] = dot4(a0, b0, s[nt][0]);
          s[nt][1] = dot4(a0, b1, s[nt][1]);
          s[nt][2] = dot4(a1, b0, s[nt][2]);
          s[nt][3] = dot4(a1, b1, s[nt][3]);
        }
      }
    }

    softmax_tile(s, acc, m, l, p0, p0 + kN > min(warp_front + 1, walk_end), front, walk_end,
                 scale_log2, cq);

    if constexpr (Lay::kBf16) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dp * 16 +
                            (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
        }
      }
    } else {
      float* pw = Ps + warp * 16 * Lay::kPld;
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        put2(pw + gq * Lay::kPld + nt * 8 + 2 * cq, s[nt][0], s[nt][1]);
        put2(pw + (gq + 8) * Lay::kPld + nt * 8 + 2 * cq, s[nt][2], s[nt][3]);
      }
      __syncwarp();
#pragma unroll 2
      for (int k = 0; k < kN; k += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(pw + gq * Lay::kPld + k);
        const float4 a1 = *reinterpret_cast<const float4*>(pw + (gq + 8) * Lay::kPld + k);
        const float pa[4] = {a0.x, a0.y, a0.z, a0.w}, pb[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const T* vr = vs + (k + kk) * LD + 2 * cq;
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
      __syncwarp();  // p is read before the next tile rewrites it
    }
  }

  store_rows<!kTail>(acc, m, l, out, part_acc, part_ml, b, g, wrow0 + gq, rows, last_row, n_tok,
                    H, rep, W, n_splits, split, bg, 0, W, true, cq);
}

// D past 256: one block cannot hold q's rows and a D-wide accumulator.
// q . k^T runs over D in column chunks of kKC: each chunk of the window's
// rows and of the tile's K streams through the ring as a step of its own;
// and a block owns one chunk of at most kOC output columns (grid x carries
// the chunk), recomputing s over the whole D and streaming only its own
// columns of V. Each tile is nkc q . k^T steps and one V step. Splits,
// masks and the softmax are the narrow kernel's; every chunk's block of a
// split computes the same (m, l) by the same sums, and chunk 0 writes them.
constexpr int kKC = 64;   // columns a q . k^T step
constexpr int kOC = 192;  // output columns a block, at most (at 256 bf16 spilled)

template <typename T>
struct WideLayout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kStages = kBf16 ? 3 : 2;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLdk = kKC + kVec;  // q and k chunk rows, padded by 16 bytes
  static constexpr int kLdv = kOC + kVec;  // v rows
  static constexpr int kQRows = 16 * kMaxWarps;
  static constexpr int kQk = (kQRows + kN) * kLdk;  // a q . k^T step's elements
  static constexpr int kStage = kQk > kN * kLdv ? kQk : kN * kLdv;
  static constexpr int kPld = kN + 4;  // fp32 p rows
  __host__ __device__ static constexpr size_t p_bytes(int warps) {
    return kBf16 ? 0 : sizeof(float) * warps * 16 * kPld;
  }
  __host__ __device__ static constexpr size_t bytes(int warps, int split_len) {
    return sizeof(T) * kStages * kStage + p_bytes(warps) + sizeof(int) * split_len;
  }
};

// the output columns a chunk of a D-wide row owns: D split as evenly as
// whole 16-column groups allow into ceil(D / kOC) chunks
__host__ __device__ constexpr int wide_chunks(int D) { return (D + kOC - 1) / kOC; }
__host__ __device__ constexpr int wide_chunk_cols(int D) {
  return ((D + wide_chunks(D) - 1) / wide_chunks(D) + 15) / 16 * 16;
}

// __launch_bounds__ names one block an SM: without it ptxas held the bf16
// kernel to 168 registers (3 blocks an SM) and spilled.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
paged_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                            const T* __restrict__ vp, const int* __restrict__ bt,
                            const int* __restrict__ base, T* __restrict__ out,
                            float* __restrict__ part_acc, float* __restrict__ part_ml,
                            int n_tok, int H, int Hkv, int bs, int MB, int rep, int n_splits,
                            int split_len, int row_tiles, int n_chunks, int dt, int ub,
                            float scale_log2) {
  using Lay = WideLayout<T>;
  constexpr int LDK = Lay::kLdk, LDV = Lay::kLdv, S = Lay::kStages;
  constexpr int NT = kOC / 8;  // n8 tiles of the output chunk
  constexpr int ST = kN / 8;   // n8 tiles of s

  const int warps = blockDim.x >> 5, nthr = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, cq = lane & 3;
  const int tile_rows = 16 * warps;
  const int chunk = blockIdx.x % n_chunks;
  const int tile = blockIdx.x / n_chunks;
  const int rt = row_tiles - 1 - tile / n_splits;
  const int split = tile % n_splits;
  const int g = blockIdx.y, b = blockIdx.z;
  const int rows = n_tok * rep;
  const int r0 = rt * tile_rows;
  const int last_row = min(r0 + tile_rows, rows) - 1;
  const int b_base = base[b];
  const int s0 = split * split_len;
  const int walk_end = min(min(s0 + split_len, MB * bs), b_base + last_row / rep + 1);
  const int64_t bg = static_cast<int64_t>(b) * Hkv + g;
  const int ocw = wide_chunk_cols(dt);
  const int oc0 = chunk * ocw, own = min(ocw, dt - oc0);

  if (walk_end <= s0) {  // only with n_splits > 1: split 0 holds position 0
    for (int r = r0 + tid; chunk == 0 && r <= last_row; r += nthr) {
      float* ml = part_ml + ((bg * rows + r) * n_splits + split) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [S][kStage]
  float* Ps = reinterpret_cast<float*>(ring + S * Lay::kStage);  // fp32: [warps][16][kPld]
  int* rowidx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(Ps) +
                                       Lay::p_bytes(warps));

  const int n_pos = walk_end - s0;
  const int* btr = bt + static_cast<int64_t>(b) * MB;
  for (int i = tid; i < n_pos; i += nthr) {
    const int p = s0 + i;
    rowidx[i] = btr[p / bs] * bs + p % bs;
  }
  __syncthreads();  // rowidx is read by every thread's copies

  const int64_t row_stride = static_cast<int64_t>(Hkv) * dt;
  const int64_t head_off = static_cast<int64_t>(g) * dt;
  const int ue = ub / static_cast<int>(sizeof(T));
  const int nkc = (dt + kKC - 1) / kKC, spt = nkc + 1;
  const int n_tiles = (n_pos + kN - 1) / kN, total = n_tiles * spt;
  const int vcols = (own + 15) / 16 * 16;
  // step st of the walk into its stage: q . k^T chunk st % spt of tile
  // st / spt (the window's rows, then the tile's K), or the tile's V.
  // Captures by value: by reference, the captured locals sat in local
  // memory.
  auto load_step = [=](int st) {
    T* stage = ring + (st % S) * Lay::kStage;
    const int j = st / spt, part = st % spt;
    if (part < nkc) {
      const int c0 = part * kKC, upr = kKC / ue;
      for (int idx = tid; idx < tile_rows * upr; idx += nthr) {
        const int r = idx / upr, c = idx % upr * ue, rr = r0 + r;
        const bool valid = rr < rows && c0 + c < dt;
        const T* src = valid ? q + row_offset(b, g, rr, n_tok, H, rep, dt) + c0 + c : q;
        copy_unit(stage + r * LDK + c, src, valid, ub);
      }
      T* ks = stage + Lay::kQRows * LDK;
      for (int idx = tid; idx < kN * upr; idx += nthr) {
        const int i = idx / upr, c = idx % upr * ue, p = j * kN + i;
        const bool valid = p < n_pos && c0 + c < dt;
        const int64_t off = valid ? rowidx[p] * row_stride + head_off + c0 + c : 0;
        copy_unit(ks + i * LDK + c, kp + off, valid, ub);
      }
    } else {
      const int upr = vcols / ue;
      for (int idx = tid; idx < kN * upr; idx += nthr) {
        const int i = idx / upr, c = idx % upr * ue, p = j * kN + i;
        const bool valid = p < n_pos && c < own;
        const int64_t off = valid ? rowidx[p] * row_stride + head_off + oc0 + c : 0;
        copy_unit(stage + i * LDV + c, vp + off, valid, ub);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < total) load_step(i);
    cp_async_commit();
  }
  // step st landed for all and step st - 1's stage is free: refill it
  auto next_step = [=](int st) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (st + S - 1 < total) load_step(st + S - 1);
    cp_async_commit();
    return ring + (st % S) * Lay::kStage;
  };

  const int wrow0 = r0 + 16 * warp;
  const int front[2] = {b_base + (wrow0 + gq) / rep, b_base + (wrow0 + gq + 8) / rep};
  const int warp_front = b_base + wrow0 / rep;
  float* pw = Ps + warp * 16 * Lay::kPld;

  float acc[NT][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int st = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int p0 = s0 + j * kN;
    float s[ST][4];
    zero(s);
    for (int c = 0; c < nkc; ++c, ++st) {
      const T* stage = next_step(st);
      abt<ST, kKC>(s, stage + 16 * warp * LDK, LDK, stage + Lay::kQRows * LDK, LDK, lane);
    }
    softmax_tile(s, acc, m, l, p0, p0 + kN > min(warp_front + 1, walk_end), front, walk_end,
                 scale_log2, cq);
    pv<NT, ST, true>(acc, s, pw, next_step(st), LDV, lane);
    ++st;
  }
  store_rows<false>(acc, m, l, out, part_acc, part_ml, b, g, wrow0 + gq, rows, last_row, n_tok,
                    H, rep, dt, n_splits, split, bg, oc0, own, chunk == 0, cq);
}

__device__ __forceinline__ void put4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The splits' partials of one output row -> the row, a warp a row, in
// split order. m of a split that saw nothing is -inf and its acc unread.
// Rows of a D that is a multiple of 4 go by 16-byte vectors, others by
// columns.
template <typename T>
__global__ void __launch_bounds__(128)
paged_attention_combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml, T* __restrict__ out,
                               int n_rows, int rows, int n_tok, int H, int Hkv,
                               int rep, int D, int n_splits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float* ml = part_ml + static_cast<int64_t>(row) * n_splits * 2;
  const float* acc = part_acc + static_cast<int64_t>(row) * n_splits * D;
  float mx = -INFINITY;
  for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int s = lane; s < n_splits; s += 32) {
    const float ms = ml[2 * s];
    if (ms != -INFINITY) sum += exp2f(ms - mx) * ml[2 * s + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float inv = 1.f / sum;  // > 0: split 0 holds position 0
  const int bg = row / rows, r = row % rows;
  T* o = out + row_offset(bg / Hkv, bg % Hkv, r, n_tok, H, rep, D);
  if (D % 4 != 0) {
    for (int d = lane; d < D; d += 32) {
      float v = 0.f;
      for (int s = 0; s < n_splits; ++s) {
        const float ms = ml[2 * s];
        if (ms == -INFINITY) continue;
        v = fmaf(exp2f(ms - mx), acc[static_cast<int64_t>(s) * D + d], v);
      }
      put1(o + d, v * inv);
    }
    return;
  }
  for (int d = lane * 4; d < D; d += 128) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_splits; ++s) {
      const float ms = ml[2 * s];
      if (ms == -INFINITY) continue;
      const float w = exp2f(ms - mx);
      const float4 a = *reinterpret_cast<const float4*>(acc + static_cast<int64_t>(s) * D + d);
      v.x = fmaf(w, a.x, v.x);
      v.y = fmaf(w, a.y, v.y);
      v.z = fmaf(w, a.z, v.z);
      v.w = fmaf(w, a.w, v.w);
    }
    put4(o + d, make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
  }
}

struct Args {
  const void *q, *kp, *vp;
  const int *bt, *base;
  void *out;
  float* ws;
  int B, n_tok, H, Hkv, D, bs, MB, warps, row_tiles, n_splits, split_len, n_chunks;
};

// the kernel that runs head_dim D in T (the next multiple of 16 up to
// 256, kTail where D is below it; else the wide kernel) and its dynamic
// shared memory at a plan of `warps` warps walking `split_len` positions
template <typename T, int Dk, bool kTail>
const void* split_kernel(int warps, int split_len, size_t* smem) {
  if constexpr (Dk == 0) {
    *smem = WideLayout<T>::bytes(warps, split_len);
    return reinterpret_cast<const void*>(paged_attention_wide_kernel<T>);
  } else {
    *smem = Layout<T, Dk>::bytes(warps, split_len);
    return reinterpret_cast<const void*>(paged_attention_kernel<T, Dk, kTail>);
  }
}

// Dk: the instantiation that runs a.D (0: the wide kernel)
template <typename T, int Dk, bool kTail>
cudaError_t launch(const Args& a, cudaStream_t s) {
  size_t smem = 0;
  const void* fn = split_kernel<T, Dk, kTail>(a.warps, a.split_len, &smem);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rep = a.H / a.Hkv, rows = a.n_tok * rep;
  const int64_t n_rows = static_cast<int64_t>(a.B) * a.Hkv * rows;
  float* part_acc = a.ws;
  float* part_ml = a.ws == nullptr ? nullptr : a.ws + n_rows * a.n_splits * a.D;
  // the scale of the true D; rows load in the widest unit D's bytes take
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(a.D));
  const int ub = row_unit(static_cast<int64_t>(a.D) * sizeof(T));
  const dim3 grid(a.row_tiles * a.n_splits * a.n_chunks, a.Hkv, a.B);
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  T* out = static_cast<T*>(a.out);
  if constexpr (Dk == 0) {
    paged_attention_wide_kernel<T><<<grid, 32 * a.warps, smem, s>>>(
        q, kp, vp, a.bt, a.base, out, part_acc, part_ml, a.n_tok, a.H, a.Hkv, a.bs, a.MB, rep,
        a.n_splits, a.split_len, a.row_tiles, a.n_chunks, a.D, ub, scale_log2);
  } else {
    paged_attention_kernel<T, Dk, kTail><<<grid, 32 * a.warps, smem, s>>>(
        q, kp, vp, a.bt, a.base, out, part_acc, part_ml, a.n_tok, a.H, a.Hkv, a.bs, a.MB, rep,
        a.n_splits, a.split_len, a.row_tiles, a.D, ub, scale_log2);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return e;
  paged_attention_combine_kernel<T><<<static_cast<unsigned>((n_rows + 3) / 4), 128, 0, s>>>(
      part_acc, part_ml, out, static_cast<int>(n_rows), rows, a.n_tok, a.H, a.Hkv, rep, a.D,
      a.n_splits);
  return cudaGetLastError();
}

// f(std::integral_constant<int, Dk>) for the instantiation that runs D:
// the next multiple of 16 for D in 1..256 (16, 32, ..., 256), 0 (the wide
// kernel) past 256
template <typename F, int... I>
cudaError_t with_d(int D, F&& f, std::integer_sequence<int, I...>) {
  if (D > 256) return f(std::integral_constant<int, 0>{});
  const int Dk = (D + 15) / 16 * 16;
  cudaError_t e = cudaErrorInvalidValue;
  ((Dk == 16 * (I + 1) ? (e = f(std::integral_constant<int, 16 * (I + 1)>{}), true) : false) ||
   ...);
  return e;
}
template <typename F>
cudaError_t with_d(int D, F&& f) {
  if (D <= 0) return cudaErrorInvalidValue;
  return with_d(D, static_cast<F&&>(f), std::make_integer_sequence<int, 16>{});
}

template <typename F>
cudaError_t with_type(int dtype, F&& f) {
  if (dtype == 0) return f(float{});
  if (dtype == 1) return f(bf16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// q/out [B, T, H, D], pools [NB, bs, Hkv, D], bt [B, MB] and base [B]
// int32, all contiguous, their base pointers 16-byte aligned; any D >= 1
// (rows whose bytes are no multiple of 16 load in 8-, 4- or 2-byte
// units). The plan (the wrapper's): `warps` (1 or 4) a block of 16 *
// warps query rows, `row_tiles` such blocks over T * H / Hkv rows,
// `n_splits` splits of `split_len` positions (a multiple of 32) over
// [0, MB * bs), `n_chunks` output-column chunks (1 up to D 256, else
// ceil(D / 192)). `ws`: fp32 [B * Hkv * T * H / Hkv * n_splits * (D + 2)]
// when n_splits > 1, else null.
extern "C" int hyperion_paged_attention(const void* q, const void* k_pool,
                                        const void* v_pool, const void* bt,
                                        const void* base, void* out, void* ws,
                                        int B, int n_tok, int H, int Hkv, int D,
                                        int bs, int MB, int warps, int row_tiles,
                                        int n_splits, int split_len, int n_chunks,
                                        int dtype, void* stream) {
  if (B == 0 || n_tok == 0) return 0;
  const int rows = n_tok * (H / Hkv);
  if ((warps != 1 && warps != kMaxWarps) || split_len <= 0 || split_len % kN ||
      n_splits <= 0 || static_cast<int64_t>(n_splits) * split_len < static_cast<int64_t>(MB) * bs ||
      static_cast<int64_t>(n_splits - 1) * split_len >= static_cast<int64_t>(MB) * bs ||
      static_cast<int64_t>(row_tiles) * 16 * warps < rows ||
      n_chunks != (D > 256 ? wide_chunks(D) : 1) || (n_splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k_pool, v_pool, static_cast<const int*>(bt), static_cast<const int*>(base), out,
         static_cast<float*>(ws), B, n_tok, H, Hkv, D, bs, MB, warps, row_tiles, n_splits,
         split_len, n_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_type(dtype, [&](auto t) {
    using T = decltype(t);
    return with_d(D, [&](auto d) {
      constexpr int kD = decltype(d)::value;
      return D == kD || kD == 0 ? launch<T, kD, false>(a, s) : launch<T, kD, true>(a, s);
    });
  }));
}

// What the compiler gave a kernel at this D and dtype (which: 0 the split
// kernel that runs D, at a block of `warps` warps walking `split_len`
// positions; 1 the combine): out = {registers a thread, local-memory
// (spill) bytes a thread, shared memory a block (static + dynamic),
// threads a block}.
extern "C" int hyperion_paged_attrs(int which, int D, int dtype, int warps,
                                    int split_len, int* out) {
  return static_cast<int>(with_type(dtype, [&](auto t) {
    using T = decltype(t);
    return with_d(D, [&](auto d) {
      constexpr int kD = decltype(d)::value;
      size_t smem = 0;
      const void* fn =
          which != 0 ? reinterpret_cast<const void*>(paged_attention_combine_kernel<T>)
          : D == kD || kD == 0 ? split_kernel<T, kD, false>(warps, split_len, &smem)
                               : split_kernel<T, kD, true>(warps, split_len, &smem);
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, fn);
      if (e != cudaSuccess) return e;
      out[0] = attr.numRegs;
      out[1] = static_cast<int>(attr.localSizeBytes);
      out[2] = static_cast<int>(attr.sharedSizeBytes + (which == 0 ? smem : 0));
      out[3] = which == 0 ? 32 * warps : 128;
      return cudaSuccess;
    });
  }));
}
