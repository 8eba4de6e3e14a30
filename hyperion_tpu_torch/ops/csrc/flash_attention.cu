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
//   every dq kernel in its prologue and handed to dk/dv):
//   p = exp(s - lse), dp = dO . v^T, ds = p * (dp - delta),
//   dq = scale * ds->dtype . k, dv = p->dtype^T . dO,
//   dk = scale * ds->dtype^T . q, each cast to the input dtype. Key columns past Tkv (the ragged last tile) are left out
//   entirely (p = 0). A row whose keys are all padding has every s at
//   NEG_INF, so its o is the mean of v over the Tkv keys; under a causal
//   mask the tiles past its frontier are skipped, so its o depends on the
//   tiling: garbage, as the reference documents.
//
// Bound on the H100: operations. At the Llama-2-7B train step ([1, 4096,
// 32, 128] bf16, causal, the last 1024 keys padding) the forward's two
// products over the kept (query, key) pairs are 1.29e11 flops, 0.130 ms at
// 989 TFLOP/s, against 134 MB of bytes (0.040 ms); dq's three products
// (s, dp, dq) 0.196 ms and dk/dv's four (s, dp, dv, dk) 0.261 ms. Every
// design below therefore works at keeping the tensor cores fed: operands
// reach them from shared memory filled by TMA (or from registers), and
// the softmax arithmetic runs beside the products, not between them.
//
// fp32 at D = 32, 64, 128 and 256 (`flash_fwd_kernel_tf32`,
// `flash_dq_kernel_tf32`, `flash_dkv_kernel_tf32`; at 256 all three are
// `flash_*_kernel_tf32_d256`, see "fp32 at D = 256"): the same products on
// the tensor cores as split TF32, within the reference's fp32 bounds
// (o, lse 2e-5; gradients 2e-4) of the plain version:
//   * Every operand x enters as hi = tf32(x) and lo = tf32(x - hi), each
//     rounded to 10 mantissa bits (nearest, ties away) by integer ops on
//     the fp32 bits; a product is the three mma.sync m16n8k8 TF32 passes
//     lo.hi + hi.lo + hi.hi into one fp32 accumulator (lo.lo dropped: it
//     is below 2^-22 of the product). One pass alone misses the bounds.
//   * mma.sync, not wgmma: TF32 wgmma reads only K-major shared memory,
//     and five of the seven products read B along the rows of a [T, D]
//     tile (p.v, dq, dk, dv); mma.sync loads B fragments by thread from
//     any layout. (The D 256 backward runs its four K-major products on
//     wgmma, and the D 256 forward both of its, p . v over value planes
//     it writes transposed: "fp32 at D = 256" below.)
//   * 8 warps a block over 128 rows of the block's own side (q for the
//     forward and dq, k and v for dk/dv), 16 rows a warp, resident in
//     shared memory as raw fp32 (rows unpadded, 16-byte chunks XOR-
//     swizzled by row, so the A-fragment reads hit 32 banks); each warp
//     splits its A fragments as it reads them.
//   * The other side streams in tiles of 32 rows at D 128 and 64 below:
//     a raw stage filled by 16-byte cp.async while the tile before it is
//     used, then split once for the block into hi and lo planes (rows
//     padded by 16 bytes, so both B-fragment reads below hit 32 banks).
//     The eight warps read B fragments ready to use: splitting them in
//     every warp cost ten integer and float ops per three mma.sync and
//     held the backward at the speed of SDPA's. At D 128 the backward's
//     231.7 KB (two resident tiles, four planes, the stage) are just
//     within the 227 KB a block may have: one block an SM.
//   * s and dp stay in registers: the m16n8 C fragment of an 8-column
//     tile (columns 2c, 2c + 1) is the A fragment of the next product
//     (columns c, c + 4) once that product's k is permuted to match
//     (k = c reads column 2c, k = c + 4 column 2c + 1), and its B
//     fragment is read from the same permuted rows.
//   * The dq kernel computes delta = sum(dO * O) for its rows in its
//     prologue and writes it for the dk/dv launch; one writer per
//     gradient row, so two backward runs give the same bits.
//   * A warp skips a tile wholly past its causal frontier; only edge
//     tiles (the diagonal, padded or ragged keys, a ragged query tail)
//     take the per-element mask.
//
// bf16 at D = 64, 80, 96 and 128 (`flash_fwd_kernel_sm90<D>`,
// `flash_dq_kernel_sm90<D>`, `flash_dkv_kernel_sm90<D>`; any D up to 64
// runs on the D 64 kernels, up to 80 on 80, up to 96 on 96, up to 128 on
// 128, and up to 256 on the D 256 kernels of "bf16 at D = 256" below),
// built from sm90.cuh for the tensor cores' full rate:
//   * A block of three warpgroups per (head, 128-row tile, batch): two
//     consumers of 64 rows each and a producer, whose first warp issues
//     every TMA load. The block's own 128 rows (q for the forward; q and
//     dO for dq; k and v for dk/dv) stay resident in shared memory; the
//     other side's tiles stream through a ring with full/empty mbarriers,
//     so the next tiles' loads overlap this tile's products. The forward
//     streams 128-key tiles, the backward R-row tiles: 64 rows at D 128,
//     128 at D 64, where the tiles are half as wide (`Ring` has the rows
//     and stages of each D).
//   * TMA reads [B, T, H, W] in place as a 4-D map (W, H, T, B), boxes of
//     64 columns under the 128-byte swizzle, D / 64 boxes side by side
//     for a row (at D 64 one box: each row is one 128-byte swizzle span);
//     at D 80 and 96 a second map's box of the last 16 or 32 columns
//     under the 32- or 64-byte swizzle follows (`Narrow`), read by
//     descriptors of that swizzle, and the products whose N is D run as
//     n64 plus n16 or n32. Rows past T and columns past the tensors' own
//     width W (any multiple of 8 up to D) arrive as zeros, so a ragged T
//     needs no bound check and a head dim between instantiations runs on
//     the next one in place: no padded copy, the same tile bytes as one,
//     and o, dq, dk and dv stored only below W. The maps are encoded on
//     the host at each launch and passed as __grid_constant__ parameters.
//   * forward: s = q . k^T on wgmma m64n128k16 (D / 16 k-steps) with q's A
//     fragments in registers (read once from the resident tile) and k
//     K-major in shared memory; the online softmax in registers (running
//     max, per-thread partial sums, exp2 with the scale folded in); the
//     m64n128 fp32 accumulator is, element for element, the bf16 A
//     fragment of o += p . v (m64nDk16), whose B (v) is read MN-major
//     through the descriptor's transpose bit. Each consumer issues tile
//     j's s product and tile j - 1's p . v together, then runs tile j's
//     softmax while p . v runs; and the two consumers take turns at the
//     tensor cores (a named-barrier ping-pong), so one's softmax runs
//     beside the other's products. At D 64 the products halve and the
//     softmax does not, so that overlap carries more of the time. No
//     wgmma sits under a condition (ptxas would serialise them). Rows
//     whose keys are all padding take every tile, so their o is the plain
//     version's mean of v.
//   * dk/dv: s^T = k . q^T and dp^T = v . dO^T run on wgmma m64nRk16 with
//     both operands K-major in shared memory, as they lie in [T, D]. p^T
//     and ds^T stay in registers as the A fragments of dv += p^T . dO and
//     dk += ds^T . q (wgmma m64nDk16, B = dO or q read MN-major). The dk
//     and dv accumulators are D / 2 + D / 2 floats a consumer thread;
//     setmaxnreg gives the consumers 240 registers and the producer 24, as
//     in the forward and dq. At D 64 the R = 128 tiles double the work
//     between two waits on the ring, and s^T, dp^T and the accumulators
//     (192 floats) still fit.
//   * dq: s = q . k^T and dp = dO . v^T likewise, dq += ds . k with k read
//     MN-major. The dq block also computes delta = sum(dO * O) for its
//     rows in its prologue (dO from the resident tile, O read once) and
//     writes it for the dk/dv launch that follows on the same stream.
//   * Two backward kernels, no atomics: every gradient row has one
//     writer, so two launches give bit-identical results. The cost is two
//     recomputed products (seven against a fused kernel's five).
//   * Only edge tiles (the diagonal, padded or ragged keys, a ragged query
//     tail) take the per-element mask; a backward consumer skips a tile
//     wholly past its causal frontier. p = exp2(s * scale * log2(e) -
//     m * log2(e)) (lse in place of m in the backward).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <cxxabi.h>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

using bf16 = __nv_bfloat16;

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
}

// one thread's two columns of an m16n8 fragment row, stored in T
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

// ------------------------------------- bf16 at D = 64 and 128 (sm_90a)
//
// Three warpgroups a block: two consumers of 64 rows each and one
// producer. The producer's first warp issues every TMA load and fills the
// small per-tile arrays; the consumers run wgmma and the softmax
// arithmetic. A block's own 128 rows stay resident; the other side's
// tiles come through a ring of stages, each with a "full" mbarrier (the
// producer warp's 32 arrivals plus the TMA bytes) and an "empty" one (the
// 256 consumer threads' arrivals).

namespace wgp {

constexpr int kBox = 8192;       // one TMA box: 64 rows x 64 bf16 columns
constexpr int kThreads = 384;    // consumers 0..255, producer 256..383
constexpr float kLog2e = 1.4426950408889634f;

// R rows x D columns: D / 64 boxes of R rows x 64 columns side by side,
// then, where D is no multiple of 64 (80, 96), a narrow box of R rows x
// D % 64 columns (rows of 32 or 64 bytes under that swizzle)
template <int D, int R>
constexpr int kTile = R * D * 2;
// the block's own rows come in halves of 64, one a consumer
template <int D>
constexpr int kHalf = kTile<D, 64>;

// the forward streams 128-key tiles (boxes of 128 rows x 64 columns)
constexpr int kFwdKeys = 128;
constexpr int kFwdBox = kFwdKeys * 128;

// The streamed side's ring: its stages (forward, backward) and the rows
// of the backward's tiles (q and dO for dk/dv, k and v for dq; the
// forward's are 128 keys). A forward consumer holds two tiles at once (k
// of tile it, v of tile it - 1), so the third of three stages is the one
// being loaded. At D 128 that is 226.6 KB with q, just under the 227 KB
// a block may have, and the backward's two stages of 64 rows ~130 KB.
template <int D>
struct Ring {
  static constexpr int kFwd = 3;
  static constexpr int kBwd = 2;
  static constexpr int kBwdRows = 64;
};

// D 64 halves every tile. On an H100 at [8, 4096, 4, 64] causal, four
// stages ran faster than three (forward) and two or three (backward),
// six forward stages no faster than four; then 128-row backward tiles
// ran 11 % faster than 64-row ones (forward 150.6 KB, dq 167.5 KB,
// dk/dv 169.0 KB of shared memory).
template <>
struct Ring<64> {
  static constexpr int kFwd = 4;
  static constexpr int kBwd = 4;
  static constexpr int kBwdRows = 128;
};

// D 256 (see "bf16 at D = 256" below): the forward's 64-key stages and
// dk/dv's 64-row query stages are 64 KB each, two of each beside the
// resident 64 KB; dq streams 64-key tiles through slots of its own
// (`DqSmemWide`).
template <>
struct Ring<256> {
  static constexpr int kFwd = 2;
  static constexpr int kBwd = 2;
  static constexpr int kBwdRows = 64;
};

// D 80 and 96 (64 + 16 and 64 + 32 columns) run the D 128 design on their
// own widths: every tile is a 64-column box and a narrow one, so a stage
// holds 5/8 or 3/4 of D 128's bytes. On an H100 at [2, 1000, 8, D] causal,
// four stages ran as fast as five or six (D 96's forward fits four), the
// forward ~2 % faster than with three; the backward's 64-row tiles keep
// dk/dv's accumulators beside s^T and dp^T within 240 registers (forward
// 187,480 and 224,344 bytes of shared memory, dq and dk/dv 126-151 KB).
struct RingNarrow {
  static constexpr int kFwd = 4;
  static constexpr int kBwd = 4;
  static constexpr int kBwdRows = 64;
};
template <>
struct Ring<80> : RingNarrow {};
template <>
struct Ring<96> : RingNarrow {};

// The maps of the narrow box (D % 64 columns) of q, k, v and dO, passed
// beside the 64-column maps where D has one, empty where it has none
template <int D, bool = (D % 64 != 0)>
struct Narrow {
  CUtensorMap m[4];
};
template <int D>
struct Narrow<D, false> {};
enum { kMapQ, kMapK, kMapV, kMapDo };

template <int D>
struct DkvSmem {
  static constexpr int S = Ring<D>::kBwd, R = Ring<D>::kBwdRows;
  uint8_t k[2 * kHalf<D>];  // the block's 128 key rows: [consumer][box]
  uint8_t v[2 * kHalf<D>];
  uint8_t q[S][kTile<D, R>];  // an R-row query tile: [box]
  uint8_t dout[S][kTile<D, R>];
  float lse[S][R];
  float delta[S][R];
  uint64_t kv_full, full[S], empty[S];
};

template <int D>
struct DqSmem {
  static constexpr int S = Ring<D>::kBwd, R = Ring<D>::kBwdRows;
  uint8_t q[2 * kHalf<D>];  // the block's 128 query rows: [consumer][box]
  uint8_t dout[2 * kHalf<D>];
  uint8_t k[S][kTile<D, R>];  // an R-row key tile: [box]
  uint8_t v[S][kTile<D, R>];
  int keep[S][R];  // key kept (in range and not padding)
  int all_keep[S];
  float delta[128];
  uint64_t qd_full, full[S], empty[S];
};

template <int D>
struct FwdSmem {
  static constexpr int S = Ring<D>::kFwd;
  uint8_t q[2 * kHalf<D>];  // the block's 128 query rows: [consumer][box]
  uint8_t k[S][kTile<D, kFwdKeys>];  // a 128-row key tile: [box]
  uint8_t v[S][kTile<D, kFwdKeys>];
  int keep[S][kFwdKeys];  // key kept (in range and not padding)
  int all_keep[S];
  uint64_t q_full, full[S], empty[S];
};

// D 256: the forward's stages hold 64-key tiles (k and v 32 KB each) beside
// the block's 128 query rows (64 KB), two stages: 197 KB. dk/dv's block
// owns 64 key rows (k and v 32 KB each) and streams 64-row q and dO tiles
// (32 KB each) through two stages, each with a 16 KB buffer for the p^T
// that consumer 0 hands to consumer 1. dq keeps the block's 128 query rows
// of q and dO (128 KB) beside 64-key tiles of k in two slots and v in one.
constexpr int kWideKeys = 64;

struct FwdSmemWide {
  static constexpr int S = Ring<256>::kFwd;
  uint8_t q[2 * kHalf<256>];  // the block's 128 query rows: [consumer][box]
  uint8_t k[S][kTile<256, kWideKeys>];  // a 64-key tile: [box]
  uint8_t v[S][kTile<256, kWideKeys>];
  int keep[S][kWideKeys];
  int all_keep[S];
  uint64_t q_full, full[S], empty[S];
};

struct DkvSmemWide {
  static constexpr int S = Ring<256>::kBwd, R = Ring<256>::kBwdRows;
  uint8_t k[kHalf<256>];  // the block's 64 key rows: [box]
  uint8_t v[kHalf<256>];
  uint8_t q[S][kTile<256, R>];  // a 64-row query tile: [box]
  uint8_t dout[S][kTile<256, R>];
  // p^T of the stage's tile, fp32: float4 j of consumer thread t at
  // [j][t], so a warp's stores and loads cover 512 consecutive bytes
  float4 pt[S][R / 8][128];
  float lse[S][R];
  float delta[S][R];
  uint64_t kv_full, full[S], empty[S];
};

struct DqSmemWide {
  static constexpr int R = Ring<256>::kBwdRows;  // keys a streamed tile
  uint8_t q[2 * kHalf<256>];  // the block's 128 query rows: [consumer][box]
  uint8_t dout[2 * kHalf<256>];
  uint8_t k[2][kTile<256, R>];  // two key slots: [box]
  uint8_t v[kTile<256, R>];     // one value slot
  int keep[2][R];               // key kept, with the k slot
  int all_keep[2];
  float delta[128];
  uint64_t qd_full, k_full[2], k_empty[2], v_full, v_empty;
};

// the launch asks for sizeof + 1024 of the 232,448 bytes a block may have
static_assert(sizeof(DkvSmemWide) + 1024 <= 232448, "dk/dv fits one block");
static_assert(sizeof(DqSmemWide) + 1024 <= 232448, "dq fits one block");

// the block's shared memory, its start rounded up to 1024 bytes (the
// swizzle's period); the launch asks for sizeof(S) + 1024
template <typename S>
__device__ __forceinline__ S& smem_block() {
  extern __shared__ __align__(16) uint8_t smem_ws[];
  const uint32_t off = (1024u - (sm90::smem_u32(smem_ws) & 1023u)) & 1023u;
  return *reinterpret_cast<S*>(smem_ws + off);
}

// K-major operand: a tile of D columns (D / 64 boxes of `box` bytes: 64
// or 128 rows of 128 bytes, then the narrow box, rows of (D % 64) * 2
// bytes); k-step kk covers columns 16kk .. 16kk + 15. kk is a constant of
// an unrolled loop, so the choice of box is made at compile time.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk,
                                           int box = kBox) {
  constexpr int kFull = 4 * (D / 64);  // the k-steps of the 64-column boxes
  if constexpr (D % 64 != 0) {
    if (kk >= kFull) {
      constexpr int kRow = (D % 64) * 2;
      return sm90::desc_sw<kRow>(tile + (D / 64) * box + (kk - kFull) * 32,
                                 16, 8 * kRow);
    }
  }
  return sm90::desc_sw128(tile + (kk >> 2) * box + (kk & 3) * 32, 16, 1024);
}

// the byte offset of (row, col) in a tile of D columns whose 64-column
// boxes are `box` bytes, as TMA's swizzle lays it out (sm90.cuh)
template <int D>
__device__ __forceinline__ int tile_offset(int row, int col, int box) {
  const int x = col >> 6, chunk = (col & 63) >> 3;
  if constexpr (D % 64 == 0) {
    return x * box + row * 128 + ((chunk ^ (row & 7)) << 4) + (col & 7) * 2;
  } else {
    const int row_bytes = x < D / 64 ? 128 : (D % 64) * 2;
    const int swz = (row * row_bytes >> 7) & (row_bytes / 16 - 1);
    return x * box + row * row_bytes + ((chunk ^ swz) << 4) + (col & 7) * 2;
  }
}

// TMA loads of `rows` rows of one head from row r0 into a tile of D
// columns whose 64-column boxes are `box` bytes: D / 64 boxes through
// `map`, then the narrow box through `narrow.m[which]` where D has one
template <int D, typename N>
__device__ __forceinline__ void load_tile(uint8_t* tile, int box,
                                          const CUtensorMap* map,
                                          const N& narrow, int which,
                                          uint64_t* bar, int h, int r0, int b) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x) {
    sm90::tma_load_4d(tile + x * box, map, bar, 64 * x, h, r0, b);
  }
  if constexpr (D % 64 != 0) {
    sm90::tma_load_4d(tile + (D / 64) * box, &narrow.m[which], bar,
                      64 * (D / 64), h, r0, b);
  }
}

// MN-major operand: the same tile read with its rows as k; k-step kk
// covers rows 16kk .. 16kk + 15, all D columns (each further box lbo on)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk,
                                            int box = kBox) {
  return sm90::desc_sw128(tile + kk * 2048, box, 1024);
}

// d[64 x N] += A[64 x 16] . B[16 x N], A from registers, B MN-major from
// `tile` (boxes of `box` bytes side by side), its k-step kk: the products
// whose N is the head dim (o += p . v, dv, dk, dq). N 256 runs as two
// n128 products, the second reading the tile's third and fourth boxes
// into the accumulator's second half (columns 128 + 8j + 2c + e: the
// m64n256 layout). N 80 and 96 run as n64 over the first box and n16 or
// n32 over the narrow box (rows of 32 or 64 bytes, a k-step 16 of them)
// into the accumulator's last 8 or 16 floats, alike in layout.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint32_t tile, int kk,
                                            int box = kBox) {
  if constexpr (N == 256) {
    sm90::wgmma_m64n128k16_rs_mn(*reinterpret_cast<float(*)[64]>(&d[0]), a,
                                 desc_mn(tile, kk, box));
    sm90::wgmma_m64n128k16_rs_mn(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                                 desc_mn(tile + 2 * box, kk, box));
  } else if constexpr (N == 128) {
    sm90::wgmma_m64n128k16_rs_mn(d, a, desc_mn(tile, kk, box));
  } else if constexpr (N == 80 || N == 96) {
    constexpr int kRow = (N - 64) * 2;
    const uint64_t dn =
        sm90::desc_sw<kRow>(tile + box + kk * 16 * kRow, box, 8 * kRow);
    sm90::wgmma_m64n64k16_rs_mn(*reinterpret_cast<float(*)[32]>(&d[0]), a,
                                desc_mn(tile, kk, box));
    if constexpr (N == 80) {
      sm90::wgmma_m64n16k16_rs_mn(*reinterpret_cast<float(*)[8]>(&d[32]), a, dn);
    } else {
      sm90::wgmma_m64n32k16_rs_mn(*reinterpret_cast<float(*)[16]>(&d[32]), a, dn);
    }
  } else {
    static_assert(N == 64, "N is 64, 80, 96, 128 or 256");
    sm90::wgmma_m64n64k16_rs_mn(d, a, desc_mn(tile, kk, box));
  }
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N], both K-major in shared memory:
// the backward's s and dp over a streamed tile of N rows
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128) {
    sm90::wgmma_m64n128k16_ss(d, da, db, accumulate);
  } else if constexpr (N == 64) {
    sm90::wgmma_m64n64k16_ss(d, da, db, accumulate);
  } else {
    static_assert(N == 32, "N is 32, 64 or 128");
    sm90::wgmma_m64n32k16_ss(d, da, db, accumulate);
  }
}

// put(j) for the column groups 8j of a D-wide accumulator that lie below
// the tensors' width W: all D / 8 of them unpredicated when W is D (one
// uniform branch, so full-width stores carry no per-column condition)
template <int D, typename Put>
__device__ __forceinline__ void store_cols(int W, Put&& put) {
  if (W == D) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) put(j);
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j < W) put(j);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the m64nN accumulator (fp32) as the bf16 A fragments of N / 16 k16 steps
template <int K>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[K][4],
                                           const float (&acc)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// One step of the forward's online softmax over a 64 x NK tile of raw
// scores `sc` (the m64nNK accumulator: this thread's rows qr[0], qr[1],
// columns col0 + 8j + (e & 1) of the tile's keys): the running max m
// (natural units) moves to the tile's, alpha = exp(m_old - m_new) comes
// back for the caller's rescale of o, sc becomes p = exp(s - m) in fp32,
// and this thread's partial row sums l = l * alpha + sum(p). Interior
// tiles take the raw scores' max times scale (the same value, scale > 0)
// and fold the scale into one fma: s * scale * log2(e) - m * log2(e).
// Edge tiles take the per-element mask, whose NEG_INF and -inf entries
// need the plain difference (NEG_INF - NEG_INF = 0 exactly).
template <int NK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[NK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool interior, const int* keep, const int (&qr)[2], int col0, int Tq,
    int Tkv, int causal, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (interior) {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    mx[0] *= scale;
    mx[1] *= scale;
  } else {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * j + (e & 1);  // key index
        const float x = masked(sc[4 * j + e] * scale, qr[e >> 1], col, Tq,
                               Tkv, causal, keep[col & (NK - 1)]);
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(mx[i]));
    alpha[i] = ex2((m[i] - mn) * kLog2e);
    m[i] = mn;
  }
  float rs[2] = {0.f, 0.f};
  if (interior) {
    const float mb[2] = {m[0] * kLog2e, m[1] * kLog2e};
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], sl2, -mb[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += sc[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      sc[i] = ex2((sc[i] - m[(i >> 1) & 1]) * kLog2e);
      rs[(i >> 1) & 1] += sc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// delta = sum(dO * O) over one consumer's 64 rows of a dq block, from row
// row0: into `sm_delta` (those 64 rows) and, below Tq, into `delta` for the
// dk/dv launch. Two threads a row, D / 2 columns (D / 16 chunks of 16
// bytes) each; at D 80 and 96 the first 64 columns and the rest, as the D
// 128 kernel splits them, so that both sum in one order. dO from the
// resident (swizzled) tile, whose columns past W are zeros; o's chunks at
// or past W are not read and add 0 * 0.
template <int D>
__device__ __forceinline__ void dq_delta(const uint8_t* dout_tile,
                                         const bf16* o, float* sm_delta,
                                         float* delta, int64_t stat0, int row0,
                                         int b, int h, int Tq, int H, int W) {
  constexpr int kCh = D % 64 != 0 ? 8 : D / 16;  // thread 0's chunks
  const int t = threadIdx.x & 127;
  const int row = t >> 1, x = t & 1;
  const int n_ch = x == 0 ? kCh : D / 8 - kCh;
  const int qrow = row0 + row;
  float sum = 0.f;
  if (qrow < Tq) {
    const bf16* orow =
        o + (static_cast<int64_t>(b) * Tq + qrow) * (static_cast<int64_t>(H) * W) +
        h * W;
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      if (ch >= n_ch) break;
      const int gc = x * kCh + ch;  // the chunk's place in the row
      const uint4 dv4 = *reinterpret_cast<const uint4*>(
          dout_tile + tile_offset<D>(row, 8 * gc, kBox));
      const uint4 ov4 = 8 * gc < W ? *reinterpret_cast<const uint4*>(orow + 8 * gc)
                                   : make_uint4(0, 0, 0, 0);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv4);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(d2[e]);
        const float2 bb = __bfloat1622float2(o2[e]);
        sum = fmaf(a.x, bb.x, sum);
        sum = fmaf(a.y, bb.y, sum);
      }
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (x == 0) {
    sm_delta[row] = sum;
    if (qrow < Tq) delta[stat0 + qrow] = sum;
  }
}

}  // namespace wgp

// o (and lse) for 128 query rows of one head: each consumer owns 64 query
// rows and walks the 128-key tiles up to the block's causal frontier,
// computing s = q . k^T (wgmma, q from registers, k K-major in shared
// memory), the online softmax in registers, then o += p . v (A from
// registers, v read MN-major). The running max m, the per-thread partial
// sum l and the D / 2 o accumulators stay in registers across tiles; l is
// summed over the row's quad once, in the epilogue. The tensors are W
// columns wide (W <= D, a multiple of 8): the maps fill the columns past W
// with zeros, and o's columns past W are not stored.
template <int D>
__global__ void __launch_bounds__(wgp::kThreads, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ wgp::Narrow<D> nm,
                      const int* __restrict__ pad, bf16* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tkv, int H, int W,
                      int causal, float scale) {
  using namespace wgp;
  constexpr int S = FwdSmem<D>::S, kH = kHalf<D>, KK = D / 16;
  FwdSmem<D>& sm = smem_block<FwdSmem<D>>();
  const int h = blockIdx.x, b = blockIdx.z;
  // causal: the last query blocks see the most key tiles; launch them first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 128;
  const int n_kv = (Tkv + kFwdKeys - 1) / kFwdKeys;
  const int n_tiles =
      causal ? min(n_kv, min(q0 + 127, Tq - 1) / kFwdKeys + 1) : n_kv;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.full[s], 32);
      sm90::mbar_init(&sm.empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.q_full, 2 * kH);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          load_tile<D>(sm.q + w * kH, kBox, &tq, nm, kMapQ, &sm.q_full, h,
                       q0 + 64 * w, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&sm.empty[s], ((it / S) & 1) ^ 1);
        const int k0 = it * kFwdKeys;
        bool all = true;
#pragma unroll
        for (int part = 0; part < kFwdKeys / 32; ++part) {
          const int j = lane + 32 * part;
          const int key = k0 + j;
          const bool kp = key < Tkv &&
                          (pad == nullptr ||
                           pad[static_cast<int64_t>(b) * Tkv + key] != 0);
          sm.keep[s][j] = kp;
          all = all && kp;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) {
          sm.all_keep[s] = all;
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTile<D, kFwdKeys>);
          load_tile<D>(sm.k[s], kFwdBox, &tk, nm, kMapK, &sm.full[s], h, k0,
                       b);
          load_tile<D>(sm.v[s], kFwdBox, &tv, nm, kMapV, &sm.full[s], h, k0,
                       b);
        } else {
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int row0 = q0 + 64 * wg;     // the consumer's first query row
    const int qw = row0 + 16 * warp;   // the warp's first query row
    const int qr[2] = {qw + g, qw + g + 8};

    float acc[D / 2];
    zero(acc);
    // m starts at NEG_INF, not -inf: a first tile wholly masked then
    // gives alpha = exp(0), never exp(-inf + inf)
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(&sm.q_full, 0);
    // this warp's 16 query rows as the bf16 A fragments of the D / 16 k16
    // steps of s = q . k^T, read once from the swizzled tile: the product
    // then reads only k from shared memory
    uint32_t qa[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * warp + g + 8 * (r & 1);
        const int col = 16 * kk + 2 * c + 8 * (r >> 1);
        qa[kk][r] = *reinterpret_cast<const uint32_t*>(
            sm.q + wg * kH + tile_offset<D>(row, col, kBox));
      }
    }

    // Both consumers walk all of the block's key tiles (keys past consumer
    // 0's causal frontier come out masked, p = 0), so they take turns at
    // the tensor cores: named barrier 1 + w is consumer w's turn. In its
    // turn a consumer issues tile it's s = q . k^T and then o += p . v of
    // tile it - 1, and hands the turn over; its softmax of tile it then
    // runs while the other consumer's products do, and only its rescale
    // of o waits for its own p . v. Consumer 0 goes first. No wgmma sits
    // under a condition: ptxas serialises wgmma on a path it cannot prove
    // uniform.
    const int turn = 1 + wg, other = 2 - wg;
    if (wg == 1) sm90::named_arrive(1, 256);
    uint32_t pa[kFwdKeys / 16][4];
    float sc[kFwdKeys / 2];
    float alpha[2];
    {  // tile 0: s only
      sm90::mbar_wait(&sm.full[0], 0);
      const uint32_t k_tile = sm90::smem_u32(sm.k[0]);
      sm90::named_sync(turn, 256);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        sm90::wgmma_m64n128k16_rs(sc, qa[kk], desc_k<D>(k_tile, kk, kFwdBox),
                                  kk > 0);
      }
      sm90::wgmma_commit();
      sm90::named_arrive(other, 256);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      const bool interior = kFwdKeys <= Tkv && sm.all_keep[0] != 0 &&
                            (!causal || kFwdKeys - 1 <= qw);
      online_softmax<kFwdKeys>(sc, m, l, alpha, interior, sm.keep[0], qr,
                               2 * c, Tq, Tkv, causal, scale);
      to_a_frags(pa, sc);  // o is still zero: no rescale
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % S;
      const int k0 = it * kFwdKeys;
      sm90::mbar_wait(&sm.full[s], (it / S) & 1);
      const uint32_t k_tile = sm90::smem_u32(sm.k[s]);
      const uint32_t v_prev = sm90::smem_u32(sm.v[(it - 1) % S]);
      sm90::named_sync(turn, 256);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        sm90::wgmma_m64n128k16_rs(sc, qa[kk], desc_k<D>(k_tile, kk, kFwdBox),
                                  kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
        wgmma_rs_mn<D>(acc, pa[kk], v_prev, kk, kFwdBox);
      }
      sm90::wgmma_commit();
      sm90::named_arrive(other, 256);
      sm90::wgmma_wait<1>();  // s is ready; p . v runs on
      sm90::fence_regs(sc);

      // only edge tiles (the diagonal, padded or ragged keys) take the
      // per-element mask
      const bool interior = k0 + kFwdKeys <= Tkv && sm.all_keep[s] != 0 &&
                            (!causal || k0 + kFwdKeys - 1 <= qw);
      online_softmax<kFwdKeys>(sc, m, l, alpha, interior, sm.keep[s], qr,
                               k0 + 2 * c, Tq, Tkv, causal, scale);

      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&sm.empty[(it - 1) % S]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_a_frags(pa, sc);
    }
    {  // the last tile's o += p . v
      const int s = (n_tiles - 1) % S;
      const uint32_t v_tile = sm90::smem_u32(sm.v[s]);
      sm90::named_sync(turn, 256);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
        wgmma_rs_mn<D>(acc, pa[kk], v_tile, kk, kFwdBox);
      }
      sm90::wgmma_commit();
      sm90::named_arrive(other, 256);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&sm.empty[s]);
    }
    // consumer 1's last hand-over has no turn of consumer 0 to open:
    // take it, so that both barriers end balanced
    if (wg == 0) sm90::named_sync(1, 256);

    const int64_t stride = static_cast<int64_t>(H) * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = fmaxf(quad_sum(l[i]), 1e-30f);
      if (qr[i] < Tq) {
        if (lse != nullptr && c == 0) {
          lse[(static_cast<int64_t>(b) * H + h) * Tq + qr[i]] = m[i] + logf(l[i]);
        }
        const int64_t row = (static_cast<int64_t>(b) * Tq + qr[i]) * stride + h * W;
        store_cols<D>(W, [&](int j) {
          put2(o + row + 8 * j + 2 * c, acc[4 * j + 2 * i] / l[i],
               acc[4 * j + 2 * i + 1] / l[i]);
        });
      }
    }
  }
}

// dk, dv for 128 key rows of one head: each consumer owns 64 key rows and
// walks the R-row query tiles from the causal diagonal down, computing
// s^T = k . q^T and dp^T = v . dO^T (wgmma, both operands K-major in shared
// memory), p^T and ds^T in registers, then dv += p^T . dO and
// dk += ds^T . q (wgmma, A from registers, B = dO or q read MN-major).
// The tensors are W columns wide, as in the forward.
template <int D>
__global__ void __launch_bounds__(wgp::kThreads, 1)
flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ wgp::Narrow<D> nm,
                      const int* __restrict__ pad,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Tq, int Tkv, int H, int W,
                      int causal, float scale) {
  using namespace wgp;
  constexpr int S = DkvSmem<D>::S, R = DkvSmem<D>::R, kH = kHalf<D>;
  constexpr int KK = D / 16, kRB = R * 128;  // kRB: a streamed tile's box
  DkvSmem<D>& sm = smem_block<DkvSmem<D>>();
  // causal: the first key blocks see the most query tiles, and the tile
  // index is the grid's slower axis, so every head's longest blocks start
  // first
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * 128;
  const int n_q = (Tq + R - 1) / R;
  const int first = causal ? k0 / R : 0;
  const int n_tiles = max(n_q - first, 0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.full[s], 32);
      sm90::mbar_init(&sm.empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.kv_full, 4 * kH);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          load_tile<D>(sm.k + w * kH, kBox, &tk, nm, kMapK, &sm.kv_full, h,
                       k0 + 64 * w, b);
          load_tile<D>(sm.v + w * kH, kBox, &tv, nm, kMapV, &sm.kv_full, h,
                       k0 + 64 * w, b);
        }
      }
      const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&sm.empty[s], ((it / S) & 1) ^ 1);
        const int q0 = (first + it) * R;
#pragma unroll
        for (int part = 0; part < R / 32; ++part) {
          const int j = lane + 32 * part;
          const bool in = q0 + j < Tq;
          sm.lse[s][j] = in ? lse[row0 + q0 + j] : 0.f;
          sm.delta[s][j] = in ? delta[row0 + q0 + j] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTile<D, R>);
          load_tile<D>(sm.q[s], kRB, &tq, nm, kMapQ, &sm.full[s], h, q0, b);
          load_tile<D>(sm.dout[s], kRB, &tdo, nm, kMapDo, &sm.full[s], h, q0,
                       b);
        } else {
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int kw = k0 + 64 * wg + 16 * warp;  // the warp's first key row
    const int kr[2] = {kw + g, kw + g + 8};
    bool keep[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      keep[i] = kr[i] < Tkv &&
                (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + kr[i]] != 0);
    }
    const bool warp_keep = __all_sync(0xffffffffu, keep[0] && keep[1]);
    const float sl2 = scale * kLog2e;

    float acc_k[D / 2], acc_v[D / 2];
    zero(acc_k);
    zero(acc_v);
    const uint32_t k_tile = sm90::smem_u32(sm.k + wg * kH);
    const uint32_t v_tile = sm90::smem_u32(sm.v + wg * kH);
    sm90::mbar_wait(&sm.kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S;
      const int q0 = (first + it) * R;
      sm90::mbar_wait(&sm.full[s], (it / S) & 1);
      // a tile wholly above the diagonal for this consumer's keys is skipped
      if (!causal || k0 + 64 * wg <= q0 + R - 1) {
        const uint32_t q_tile = sm90::smem_u32(sm.q[s]);
        const uint32_t do_tile = sm90::smem_u32(sm.dout[s]);
        float st[R / 2], dpt[R / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(st, desc_k<D>(k_tile, kk), desc_k<D>(q_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(dpt, desc_k<D>(v_tile, kk), desc_k<D>(do_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(st);

        // p^T = exp(s^T - lse): rows are keys, columns queries. Only edge
        // tiles (the diagonal, padded or ragged keys, a ragged query tail)
        // take the per-element mask.
        const bool interior = q0 + R - 1 < Tq && warp_keep &&
                              (!causal || kw + 15 <= q0);
        if (interior) {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float l = sm.lse[s][8 * j + 2 * c + (e & 1)];
              st[4 * j + e] = ex2(fmaf(st[4 * j + e], sl2, -l * kLog2e));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * c + (e & 1);
              const float x = masked(st[4 * j + e] * scale, q0 + col,
                                     kr[e >> 1], Tq, Tkv, causal, keep[e >> 1]);
              st[4 * j + e] = ex2((x - sm.lse[s][col]) * kLog2e);
            }
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dpt);

        // ds^T = p^T (dp^T - delta); then both cast to bf16 as A
        // fragments, each fp32 value dying as it is packed
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = sm.delta[s][8 * j + 2 * c + (e & 1)];
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - d);
          }
        }
        uint32_t pa[R / 16][4], dsa[R / 16][4];
        to_a_frags(pa, st);
        to_a_frags(dsa, dpt);

        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          wgmma_rs_mn<D>(acc_v, pa[kk], do_tile, kk, kRB);
        }
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          wgmma_rs_mn<D>(acc_k, dsa[kk], q_tile, kk, kRB);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc_v);
        sm90::fence_regs(acc_k);
        sm90::fence_regs(pa);
        sm90::fence_regs(dsa);
      }
      sm90::mbar_arrive(&sm.empty[s]);
    }

    const int64_t stride = static_cast<int64_t>(H) * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kr[i] < Tkv) {
        const int64_t row = (static_cast<int64_t>(b) * Tkv + kr[i]) * stride + h * W;
        store_cols<D>(W, [&](int j) {
          const int col = 8 * j + 2 * c;
          put2(dk + row + col, scale * acc_k[4 * j + 2 * i],
               scale * acc_k[4 * j + 2 * i + 1]);
          put2(dv + row + col, acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
        });
      }
    }
  }
}

// dq for 128 query rows of one head, and delta = sum(dO * O) for them
// (written for the dk/dv launch that follows): each consumer owns 64
// query rows and walks the R-row key tiles up to its causal frontier, computing
// s = q . k^T and dp = dO . v^T (wgmma from shared memory), ds in
// registers, then dq += ds . k (A from registers, k read MN-major). The
// tensors are W columns wide, as in the forward.
template <int D>
__global__ void __launch_bounds__(wgp::kThreads, 1)
flash_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ wgp::Narrow<D> nm,
                     const bf16* __restrict__ o, const int* __restrict__ pad,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     bf16* __restrict__ dq, int Tq, int Tkv, int H, int W,
                     int causal, float scale) {
  using namespace wgp;
  constexpr int S = DqSmem<D>::S, R = DqSmem<D>::R, kH = kHalf<D>;
  constexpr int KK = D / 16, kRB = R * 128;  // kRB: a streamed tile's box
  DqSmem<D>& sm = smem_block<DqSmem<D>>();
  const int h = blockIdx.x, b = blockIdx.z;
  // causal: the last query blocks see the most key tiles; launch them first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 128;
  const int n_kv = (Tkv + R - 1) / R;
  const int n_tiles = causal ? min(n_kv, min(q0 + 127, Tq - 1) / R + 1) : n_kv;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.qd_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.full[s], 32);
      sm90::mbar_init(&sm.empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.qd_full, 4 * kH);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          load_tile<D>(sm.q + w * kH, kBox, &tq, nm, kMapQ, &sm.qd_full, h,
                       q0 + 64 * w, b);
          load_tile<D>(sm.dout + w * kH, kBox, &tdo, nm, kMapDo, &sm.qd_full,
                       h, q0 + 64 * w, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&sm.empty[s], ((it / S) & 1) ^ 1);
        const int k0 = it * R;
        bool all = true;
#pragma unroll
        for (int part = 0; part < R / 32; ++part) {
          const int j = lane + 32 * part;
          const int key = k0 + j;
          const bool kp = key < Tkv &&
                          (pad == nullptr ||
                           pad[static_cast<int64_t>(b) * Tkv + key] != 0);
          sm.keep[s][j] = kp;
          all = all && kp;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) {
          sm.all_keep[s] = all;
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTile<D, R>);
          load_tile<D>(sm.k[s], kRB, &tk, nm, kMapK, &sm.full[s], h, k0, b);
          load_tile<D>(sm.v[s], kRB, &tv, nm, kMapV, &sm.full[s], h, k0, b);
        } else {
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    const int t = tid & 127, wg = tid >> 7, warp = t >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int64_t stride = static_cast<int64_t>(H) * W;
    const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
    sm90::mbar_wait(&sm.qd_full, 0);

    dq_delta<D>(sm.dout + wg * kH, o, sm.delta + 64 * wg, delta, stat0,
                q0 + 64 * wg, b, h, Tq, H, W);
    sm90::named_sync(1 + wg, 128);

    const int qw = q0 + 64 * wg + 16 * warp;  // the warp's first query row
    const int qr[2] = {qw + g, qw + g + 8};
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_lse[i] = qr[i] < Tq ? lse[stat0 + qr[i]] : 0.f;
      row_delta[i] = sm.delta[64 * wg + 16 * warp + g + 8 * i];
    }
    const float sl2 = scale * kLog2e;

    float acc[D / 2];
    zero(acc);
    const uint32_t q_tile = sm90::smem_u32(sm.q + wg * kH);
    const uint32_t do_tile = sm90::smem_u32(sm.dout + wg * kH);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S;
      const int k0 = it * R;
      sm90::mbar_wait(&sm.full[s], (it / S) & 1);
      // a tile wholly past this consumer's causal frontier is skipped
      if (!causal || k0 <= q0 + 64 * wg + 63) {
        const uint32_t k_tile = sm90::smem_u32(sm.k[s]);
        const uint32_t v_tile = sm90::smem_u32(sm.v[s]);
        float sc[R / 2], dp[R / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(sc, desc_k<D>(q_tile, kk), desc_k<D>(k_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(dp, desc_k<D>(do_tile, kk), desc_k<D>(v_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(sc);

        const bool interior = qw + 15 < Tq && k0 + R - 1 < Tkv &&
                              sm.all_keep[s] != 0 && (!causal || k0 + R - 1 <= qw);
        if (interior) {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2,
                                       -row_lse[e >> 1] * kLog2e));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * c + (e & 1);
              const float x = masked(sc[4 * j + e] * scale, qr[e >> 1], k0 + col,
                                     Tq, Tkv, causal, sm.keep[s][col]);
              sc[4 * j + e] = ex2((x - row_lse[e >> 1]) * kLog2e);
            }
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);

        uint32_t dsa[R / 16][4];
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          dp[i] = sc[i] * (dp[i] - row_delta[(i >> 1) & 1]);
        }
        to_a_frags(dsa, dp);

        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          wgmma_rs_mn<D>(acc, dsa[kk], k_tile, kk, kRB);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(dsa);
      }
      sm90::mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qr[i] < Tq) {
        const int64_t row = (static_cast<int64_t>(b) * Tq + qr[i]) * stride + h * W;
        store_cols<D>(W, [&](int j) {
          put2(dq + row + 8 * j + 2 * c, scale * acc[4 * j + 2 * i],
               scale * acc[4 * j + 2 * i + 1]);
        });
      }
    }
  }
}

// ---------------------------------------------- bf16 at D = 256 (sm_90a)
//
// Head dims 129 to 256 run here with the scale of their true D, at their
// own width (the maps fill the columns past it with zeros), or on copies
// zero-padded to 256 where that width is no multiple of 8 (the wrapper's
// `host_padded`). The D 128 designs do not fit at 256, in shared memory or
// in registers, so each kernel gives something up:
//   * forward (`flash_fwd_kernel_sm90_d256`): 128 query rows a block, two
//     consumers of 64 rows, as at D 128; but the rows stay in shared
//     memory (64 KB) and s = q . k^T reads both operands from there
//     (wgmma m64n64k16, A and B K-major), because q's A fragments would
//     take 64 registers a thread beside the o accumulator's 128. Keys come
//     in 64-key tiles (k and v 64 KB a stage, two stages: 197 KB), so s
//     and p take 32 and 16 registers. o += p . v is two m64n128k16
//     products per k-step over the halves of D. No ping-pong and no
//     overlap of one tile's softmax with another's p . v: each consumer
//     runs s, softmax, rescale, p . v in turn; the other consumer's
//     products fill the tensor cores meanwhile. Peak live values a
//     consumer thread: o 128 + s 32 + p 16 = 176 of its 240.
//   * dq (`flash_dq_kernel_sm90_d256`): q and dO of 128 rows stay resident
//     (128 KB), and the keys stream in 64-key tiles through slots of their
//     own: two of k and one of v (96 KB; 231,488 bytes with the flags,
//     delta, barriers and the 1,024 of alignment). dp = dO . v^T and s =
//     q . k^T are m64n64k16 with both operands in shared memory: a k-step
//     reads 2 KB of A and 2 KB of B for 32 tensor-core cycles, shared
//     memory's 128 bytes a cycle (32-key tiles, m64n32, read 3 KB for 16
//     cycles, past that rate, and re-read q and dO twice as often). dp
//     runs first, so v's slot goes back as soon as both consumers' dp is
//     done and the next v loads under s and dq's product; k goes back
//     after dq += ds . k (two n128 halves). Peak: dq 128 + dp 32 + s 32 =
//     192. An interior tile takes p = exp2(s * scale * log2 e - lse *
//     log2 e) in one fma and an edge tile the masked difference, so the
//     tile width decides which pairs round which way: dq's last bits
//     depend on it, within the bf16 bounds. On an H100 at [1, 4096, 8,
//     256] causal, s before dp ran 9 % slower, the consumers taking turns
//     at issuing (the forward's ping-pong) 7 % slower, and the next tile's
//     dp and s issued behind dq's product 30 % slower (that v loads only
//     once both consumers' dp is done).
//   * dk/dv (`flash_dkv_kernel_sm90_d256`): the dk and dv accumulators of
//     64 key rows at D 256 are 256 floats a thread, past the 255-register
//     limit, so the two consumers split the gradients, not the rows: the
//     block owns 64 key rows, consumer 0 accumulates dv and consumer 1 dk
//     (128 registers each). Consumer 0 computes s^T = k . q^T and p^T,
//     writes p^T in fp32 to the stage's hand-over buffer, and adds p^T .
//     dO into dv; consumer 1 computes dp^T = v . dO^T meanwhile, waits on
//     the stage's named barrier, reads p^T, forms ds^T and adds ds^T . q
//     into dk: four products a tile, two a consumer (s^T computed by both
//     would make five, three on consumer 1, which would set the pace). A
//     buffer a stage (16 KB each; 231,472 bytes): consumer 0
//     writes stage s's again only for the tile S on, whose load waits for
//     consumer 1's release of stage s, so the ring's own barriers keep the
//     buffer from being overwritten before it is read, and barrier 1 + s
//     is never arrived at twice before its wait. p^T crosses in fp32, so
//     ds^T is what consumer 1 would compute from its own s^T. Peak:
//     consumer 1 dk 128 + dp^T 32 + p^T 32 = 192. The next tile's s^T
//     issued before dv drains ran 20 % slower on an H100 at [1, 4096, 8,
//     256] causal: consumer 0 then holds both stages of the ring, and the
//     next load waits.
//   * TMA boxes stay 64 columns: a row of 256 is four boxes. The
//     backward's epilogues keep their per-column store predicates: an
//     instantiation without them for W = 256 ran within 1 % at [2, 1000,
//     8, 256].

// o (and lse) for 128 query rows of one head at D 256: each consumer owns
// 64 query rows and walks the 64-key tiles up to the block's causal
// frontier: s = q . k^T (both from shared memory), the online softmax in
// registers, o *= alpha, then o += p . v (A from registers, v MN-major).
// The tensors are W columns wide, as in the D 128 forward. kFull (W = 256)
// stores every column with no condition: on an H100 the epilogue's
// per-column store predicates, even behind a uniform W == D branch, cost
// this kernel 4 % at [2, 1000, 8, 256] (PERF.md §6); D 160 and 192
// take the predicated instantiation.
template <bool kFull>
__global__ void __launch_bounds__(wgp::kThreads, 1)
flash_fwd_kernel_sm90_d256(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const int* __restrict__ pad, bf16* __restrict__ o,
                           float* __restrict__ lse, int Tq, int Tkv, int H,
                           int W, int causal, float scale) {
  using namespace wgp;
  constexpr int D = 256, NK = kWideKeys, S = FwdSmemWide::S;
  constexpr int kH = kHalf<D>, KK = D / 16, kKB = NK * 128;  // kKB: a box
  FwdSmemWide& sm = smem_block<FwdSmemWide>();
  const int h = blockIdx.x, b = blockIdx.z;
  // causal: the last query blocks see the most key tiles; launch them first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 128;
  const int n_kv = (Tkv + NK - 1) / NK;
  const int n_tiles =
      causal ? min(n_kv, min(q0 + 127, Tq - 1) / NK + 1) : n_kv;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.full[s], 32);
      sm90::mbar_init(&sm.empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.q_full, 2 * kH);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            sm90::tma_load_4d(sm.q + w * kH + x * kBox, &tq, &sm.q_full,
                              64 * x, h, q0 + 64 * w, b);
          }
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&sm.empty[s], ((it / S) & 1) ^ 1);
        const int k0 = it * NK;
        bool all = true;
#pragma unroll
        for (int part = 0; part < NK / 32; ++part) {
          const int j = lane + 32 * part;
          const int key = k0 + j;
          const bool kp = key < Tkv &&
                          (pad == nullptr ||
                           pad[static_cast<int64_t>(b) * Tkv + key] != 0);
          sm.keep[s][j] = kp;
          all = all && kp;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) {
          sm.all_keep[s] = all;
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTile<D, NK>);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            sm90::tma_load_4d(sm.k[s] + x * kKB, &tk, &sm.full[s], 64 * x, h,
                              k0, b);
            sm90::tma_load_4d(sm.v[s] + x * kKB, &tv, &sm.full[s], 64 * x, h,
                              k0, b);
          }
        } else {
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int qw = q0 + 64 * wg + 16 * warp;  // the warp's first query row
    const int qr[2] = {qw + g, qw + g + 8};

    float acc[D / 2];
    zero(acc);
    // m starts at NEG_INF, not -inf: a first tile wholly masked then
    // gives alpha = exp(0), never exp(-inf + inf)
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_tile = sm90::smem_u32(sm.q + wg * kH);
    sm90::mbar_wait(&sm.q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S;
      const int k0 = it * NK;
      sm90::mbar_wait(&sm.full[s], (it / S) & 1);
      const uint32_t k_tile = sm90::smem_u32(sm.k[s]);
      const uint32_t v_tile = sm90::smem_u32(sm.v[s]);
      float sc[NK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        wgmma_ss<NK>(sc, desc_k<D>(q_tile, kk), desc_k<D>(k_tile, kk, kKB),
                     kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // only edge tiles (the diagonal, padded or ragged keys) take the
      // per-element mask
      const bool interior = k0 + NK <= Tkv && sm.all_keep[s] != 0 &&
                            (!causal || k0 + NK - 1 <= qw);
      float alpha[2];
      online_softmax<NK>(sc, m, l, alpha, interior, sm.keep[s], qr,
                         k0 + 2 * c, Tq, Tkv, causal, scale);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[NK / 16][4];
      to_a_frags(pa, sc);

      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        wgmma_rs_mn<D>(acc, pa[kk], v_tile, kk, kKB);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&sm.empty[s]);
    }

    const int64_t stride = static_cast<int64_t>(H) * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = fmaxf(quad_sum(l[i]), 1e-30f);
      if (qr[i] < Tq) {
        if (lse != nullptr && c == 0) {
          lse[(static_cast<int64_t>(b) * H + h) * Tq + qr[i]] = m[i] + logf(l[i]);
        }
        const int64_t row = (static_cast<int64_t>(b) * Tq + qr[i]) * stride + h * W;
        const auto put = [&](int j) {
          put2(o + row + 8 * j + 2 * c, acc[4 * j + 2 * i] / l[i],
               acc[4 * j + 2 * i + 1] / l[i]);
        };
        if constexpr (kFull) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) put(j);
        } else {
          store_cols<D>(W, put);
        }
      }
    }
  }
}

// dk, dv for 64 key rows of one head at D 256, walking the 64-row query
// tiles from the causal diagonal down. Consumer 0 computes s^T = k . q^T
// (both operands K-major in shared memory) and p^T = exp(s^T - lse), hands
// p^T in fp32 to consumer 1 through shared memory, and adds p^T . dO into
// dv; consumer 1 computes dp^T = v . dO^T meanwhile, takes p^T, forms ds^T
// = p^T (dp^T - delta) and adds ds^T . q into dk (unscaled). Both hold the
// same key rows (a warp's 16), so thread t of one consumer holds the
// fragment that thread t of the other needs. The tensors are W columns
// wide, as in the D 256 forward.
__global__ void __launch_bounds__(wgp::kThreads, 1)
flash_dkv_kernel_sm90_d256(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const int* __restrict__ pad,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Tq, int Tkv, int H, int W, int causal,
                           float scale) {
  using namespace wgp;
  constexpr int D = 256, S = DkvSmemWide::S, R = DkvSmemWide::R;
  constexpr int KK = D / 16, kRB = R * 128;  // kRB: a streamed tile's box
  DkvSmemWide& sm = smem_block<DkvSmemWide>();
  // causal: the first key blocks see the most query tiles, and the tile
  // index is the grid's slower axis, so every head's longest blocks start
  // first. A block's first query tile holds its first key (R = 64 keys a
  // block), so no tile of the walk lies wholly above the diagonal.
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * 64;
  const int n_q = (Tq + R - 1) / R;
  const int first = causal ? k0 / R : 0;
  const int n_tiles = max(n_q - first, 0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&sm.full[s], 32);
      sm90::mbar_init(&sm.empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.kv_full, 2 * kHalf<D>);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          sm90::tma_load_4d(sm.k + x * kBox, &tk, &sm.kv_full, 64 * x, h, k0, b);
          sm90::tma_load_4d(sm.v + x * kBox, &tv, &sm.kv_full, 64 * x, h, k0, b);
        }
      }
      const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&sm.empty[s], ((it / S) & 1) ^ 1);
        const int q0 = (first + it) * R;
#pragma unroll
        for (int part = 0; part < R / 32; ++part) {
          const int j = lane + 32 * part;
          const bool in = q0 + j < Tq;
          sm.lse[s][j] = in ? lse[row0 + q0 + j] : 0.f;
          sm.delta[s][j] = in ? delta[row0 + q0 + j] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTile<D, R>);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            sm90::tma_load_4d(sm.q[s] + x * kRB, &tq, &sm.full[s], 64 * x, h,
                              q0, b);
            sm90::tma_load_4d(sm.dout[s] + x * kRB, &tdo, &sm.full[s],
                              64 * x, h, q0, b);
          }
        } else {
          sm90::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    // the warpgroup's index, shown warp-uniform to the compiler: each
    // consumer's loop holds its own products
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int t = tid & 127, warp = t >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int kw = k0 + 16 * warp;  // the warp's first key row
    const int kr[2] = {kw + g, kw + g + 8};
    bool keep[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      keep[i] = kr[i] < Tkv &&
                (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + kr[i]] != 0);
    }
    const bool warp_keep = __all_sync(0xffffffffu, keep[0] && keep[1]);
    const float sl2 = scale * kLog2e;

    float acc[D / 2];  // dv (consumer 0) or dk unscaled (consumer 1)
    zero(acc);
    const uint32_t k_tile = sm90::smem_u32(sm.k);
    const uint32_t v_tile = sm90::smem_u32(sm.v);
    sm90::mbar_wait(&sm.kv_full, 0);

    if (wg == 0) {  // s^T, p^T (handed over), dv += p^T . dO
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        const int q0 = (first + it) * R;
        sm90::mbar_wait(&sm.full[s], (it / S) & 1);
        const uint32_t q_tile = sm90::smem_u32(sm.q[s]);
        const uint32_t do_tile = sm90::smem_u32(sm.dout[s]);
        float st[R / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(st, desc_k<D>(k_tile, kk), desc_k<D>(q_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);

        // p^T = exp(s^T - lse): rows are keys, columns queries. Only edge
        // tiles (the diagonal, padded or ragged keys, a ragged query tail)
        // take the per-element mask.
        const bool interior = q0 + R - 1 < Tq && warp_keep &&
                              (!causal || kw + 15 <= q0);
        if (interior) {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float l = sm.lse[s][8 * j + 2 * c + (e & 1)];
              st[4 * j + e] = ex2(fmaf(st[4 * j + e], sl2, -l * kLog2e));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * c + (e & 1);
              const float x = masked(st[4 * j + e] * scale, q0 + col, kr[e >> 1],
                                     Tq, Tkv, causal, keep[e >> 1]);
              st[4 * j + e] = ex2((x - sm.lse[s][col]) * kLog2e);
            }
          }
        }
        // the hand-over: thread t's fragment, 16 bytes at a time, the
        // warp's 32 stores on 512 consecutive bytes; then named barrier
        // 1 + s, which consumer 1 waits on for this stage's tile
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          sm.pt[s][j][t] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2],
                                       st[4 * j + 3]);
        }
        sm90::named_arrive(1 + s, 256);

        uint32_t pa[R / 16][4];
        to_a_frags(pa, st);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          wgmma_rs_mn<D>(acc, pa[kk], do_tile, kk, kRB);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(pa);
        sm90::mbar_arrive(&sm.empty[s]);
      }
    } else {  // dp^T, ds^T from the handed p^T, dk += ds^T . q
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&sm.full[s], (it / S) & 1);
        const uint32_t q_tile = sm90::smem_u32(sm.q[s]);
        const uint32_t do_tile = sm90::smem_u32(sm.dout[s]);
        float dpt[R / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(dpt, desc_k<D>(v_tile, kk), desc_k<D>(do_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();

        // p^T of this tile from consumer 0 (stage s's buffer: consumer 0
        // writes it again only for tile it + S, whose load waits for this
        // consumer's release of stage s below)
        sm90::named_sync(1 + s, 256);
        float pt[R / 2];
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          const float4 x = sm.pt[s][j][t];
          pt[4 * j] = x.x;
          pt[4 * j + 1] = x.y;
          pt[4 * j + 2] = x.z;
          pt[4 * j + 3] = x.w;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dpt);

        // ds^T = p^T (dp^T - delta)
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = sm.delta[s][8 * j + 2 * c + (e & 1)];
            dpt[4 * j + e] = pt[4 * j + e] * (dpt[4 * j + e] - d);
          }
        }
        uint32_t dsa[R / 16][4];
        to_a_frags(dsa, dpt);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          wgmma_rs_mn<D>(acc, dsa[kk], q_tile, kk, kRB);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(dsa);
        sm90::mbar_arrive(&sm.empty[s]);
      }
    }

    const int64_t stride = static_cast<int64_t>(H) * W;
    bf16* out = wg == 1 ? dk : dv;
    const float f = wg == 1 ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kr[i] < Tkv) {
        const int64_t row = (static_cast<int64_t>(b) * Tkv + kr[i]) * stride + h * W;
        store_cols<D>(W, [&](int j) {
          put2(out + row + 8 * j + 2 * c, f * acc[4 * j + 2 * i],
               f * acc[4 * j + 2 * i + 1]);
        });
      }
    }
  }
}

// dq for 128 query rows of one head at D 256, and delta = sum(dO * O) for
// them (written for the dk/dv launch that follows): each consumer owns 64
// query rows and walks the 64-key tiles up to its causal frontier,
// computing dp = dO . v^T and s = q . k^T (wgmma m64n64k16, both operands
// K-major in shared memory), ds in registers, then dq += ds . k (two n128
// halves, A from registers, k read MN-major). q and dO stay resident; k
// and v stream through slots of their own (`DqSmemWide`): v is released
// once both consumers' dp is done, k once their dq product is. The
// tensors are W columns wide, as in the D 256 forward.
__global__ void __launch_bounds__(wgp::kThreads, 1)
flash_dq_kernel_sm90_d256(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const bf16* __restrict__ o, const int* __restrict__ pad,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          bf16* __restrict__ dq, int Tq, int Tkv, int H, int W,
                          int causal, float scale) {
  using namespace wgp;
  constexpr int D = 256, R = DqSmemWide::R, kH = kHalf<D>;
  constexpr int KK = D / 16, kRB = R * 128;  // kRB: a streamed tile's box
  DqSmemWide& sm = smem_block<DqSmemWide>();
  const int h = blockIdx.x, b = blockIdx.z;
  // causal: the last query blocks see the most key tiles; launch them first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 128;
  const int n_kv = (Tkv + R - 1) / R;
  const int n_tiles = causal ? min(n_kv, min(q0 + 127, Tq - 1) / R + 1) : n_kv;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(&sm.qd_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&sm.k_full[s], 32);
      sm90::mbar_init(&sm.k_empty[s], 256);
    }
    sm90::mbar_init(&sm.v_full, 1);
    sm90::mbar_init(&sm.v_empty, 256);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.qd_full, 4 * kH);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            sm90::tma_load_4d(sm.q + w * kH + x * kBox, &tq, &sm.qd_full,
                              64 * x, h, q0 + 64 * w, b);
            sm90::tma_load_4d(sm.dout + w * kH + x * kBox, &tdo, &sm.qd_full,
                              64 * x, h, q0 + 64 * w, b);
          }
        }
      }
      // tile it's k into slot it % 2 (with its keep flags) once the
      // consumers have released the tile two back, its v into the one v
      // slot once they are done with the tile before
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it & 1;
        const int k0 = it * R;
        sm90::mbar_wait(&sm.k_empty[s], ((it >> 1) & 1) ^ 1);
        bool all = true;
#pragma unroll
        for (int part = 0; part < R / 32; ++part) {
          const int j = lane + 32 * part;
          const int key = k0 + j;
          const bool kp = key < Tkv &&
                          (pad == nullptr ||
                           pad[static_cast<int64_t>(b) * Tkv + key] != 0);
          sm.keep[s][j] = kp;
          all = all && kp;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) {
          sm.all_keep[s] = all;
          sm90::mbar_arrive_expect_tx(&sm.k_full[s], kTile<D, R>);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            sm90::tma_load_4d(sm.k[s] + x * kRB, &tk, &sm.k_full[s], 64 * x, h,
                              k0, b);
          }
        } else {
          sm90::mbar_arrive(&sm.k_full[s]);
        }
        sm90::mbar_wait(&sm.v_empty, (it & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&sm.v_full, kTile<D, R>);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            sm90::tma_load_4d(sm.v + x * kRB, &tv, &sm.v_full, 64 * x, h, k0, b);
          }
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    const int t = tid & 127, wg = tid >> 7, warp = t >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int64_t stride = static_cast<int64_t>(H) * W;
    const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
    sm90::mbar_wait(&sm.qd_full, 0);

    dq_delta<D>(sm.dout + wg * kH, o, sm.delta + 64 * wg, delta, stat0,
                q0 + 64 * wg, b, h, Tq, H, W);
    sm90::named_sync(1 + wg, 128);

    const int qw = q0 + 64 * wg + 16 * warp;  // the warp's first query row
    const int qr[2] = {qw + g, qw + g + 8};
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_lse[i] = qr[i] < Tq ? lse[stat0 + qr[i]] : 0.f;
      row_delta[i] = sm.delta[64 * wg + 16 * warp + g + 8 * i];
    }
    const float sl2 = scale * kLog2e;

    float acc[D / 2];
    zero(acc);
    const uint32_t q_tile = sm90::smem_u32(sm.q + wg * kH);
    const uint32_t do_tile = sm90::smem_u32(sm.dout + wg * kH);
    const uint32_t v_tile = sm90::smem_u32(sm.v);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it & 1;
      const int k0 = it * R;
      // both waits come before either release below, also for a skipped
      // tile: an arrival on an empty barrier never counts toward the phase
      // of a load this consumer has not seen land
      sm90::mbar_wait(&sm.k_full[s], (it >> 1) & 1);
      sm90::mbar_wait(&sm.v_full, it & 1);
      // a tile wholly past this consumer's causal frontier is skipped
      if (!causal || k0 <= q0 + 64 * wg + 63) {
        const uint32_t k_tile = sm90::smem_u32(sm.k[s]);
        float dp[R / 2], sc[R / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(dp, desc_k<D>(do_tile, kk), desc_k<D>(v_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          wgmma_ss<R>(sc, desc_k<D>(q_tile, kk), desc_k<D>(k_tile, kk, kRB),
                      kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // dp is done: v's slot goes back
        sm90::fence_regs(dp);
        sm90::mbar_arrive(&sm.v_empty);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);

        // p = exp(s - lse). Only edge tiles (the diagonal, padded or ragged
        // keys, a ragged query tail) take the per-element mask.
        const bool interior = qw + 15 < Tq && k0 + R - 1 < Tkv &&
                              sm.all_keep[s] != 0 && (!causal || k0 + R - 1 <= qw);
        if (interior) {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2,
                                       -row_lse[e >> 1] * kLog2e));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < R / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * c + (e & 1);
              const float x = masked(sc[4 * j + e] * scale, qr[e >> 1], k0 + col,
                                     Tq, Tkv, causal, sm.keep[s][col]);
              sc[4 * j + e] = ex2((x - row_lse[e >> 1]) * kLog2e);
            }
          }
        }

        // ds = p (dp - delta), cast to bf16 as the A fragments of dq's
        // product
        uint32_t dsa[R / 16][4];
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          dp[i] = sc[i] * (dp[i] - row_delta[(i >> 1) & 1]);
        }
        to_a_frags(dsa, dp);

        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
          wgmma_rs_mn<D>(acc, dsa[kk], k_tile, kk, kRB);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(dsa);
      } else {
        sm90::mbar_arrive(&sm.v_empty);
      }
      sm90::mbar_arrive(&sm.k_empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qr[i] < Tq) {
        const int64_t row = (static_cast<int64_t>(b) * Tq + qr[i]) * stride + h * W;
        store_cols<D>(W, [&](int j) {
          put2(dq + row + 8 * j + 2 * c, scale * acc[4 * j + 2 * i],
               scale * acc[4 * j + 2 * i + 1]);
        });
      }
    }
  }
}

// ------------------------------------------ fp32: split TF32 on mma.sync
//
// Eight warps a block over 128 rows of the block's own side, 16 a warp,
// resident in shared memory; the other side streams through a raw stage
// (cp.async) and is split once a tile into hi and lo planes.

namespace tf32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // the block's own rows

// the streamed side's tile: 32 rows at D = 128, 64 below (what fits
// beside the resident tiles in 227 KB); D 256 has kernels of its own
template <int D>
__host__ __device__ constexpr int tile_rows() {
  static_assert(D <= 128, "D 256: the `_d256` kernels");
  return D == 128 ? 32 : 64;
}

// the backward kernels' own rows: 128, and 64 at D 256, where two
// resident [64][256] fp32 tiles already take 128 KB (the forward keeps
// 128: it holds one)
template <int D>
__host__ __device__ constexpr int bwd_rows() { return D == 256 ? 64 : kRows; }

// the row stride of a plane: D + 4 words, 4 mod 32 banks, so both of its
// fragment reads (rows g, columns c; rows 2c and 2c + 1, columns g) fall
// on 32 different banks
template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }

// Shared memory, in 4-byte words: `kOwn` resident [kOwnRows][D] tiles
// (raw fp32, swizzled), four planes (hi and lo of the two streamed
// tiles), the raw stage of the two streamed tiles, then `extra` words of
// per-row flags or statistics.
template <int D, int kOwn, int kOwnRows = kRows>
struct Layout {
  static constexpr int R = tile_rows<D>();
  static constexpr int own = kOwnRows * D;
  static constexpr int plane = R * ld<D>();
  static constexpr int stage = R * D;
  static constexpr int planes_off = kOwn * own;
  static constexpr int stage_off = planes_off + 4 * plane;
  static constexpr int extra_off = stage_off + 2 * stage;
  static constexpr size_t bytes(int extra) { return 4u * (extra_off + extra); }
};

template <int D>
constexpr size_t fwd_smem() { return Layout<D, 1>::bytes(tile_rows<D>()); }
template <int D>
constexpr size_t dq_smem() {
  return Layout<D, 2, bwd_rows<D>()>::bytes(tile_rows<D>());
}
template <int D>
constexpr size_t dkv_smem() {
  return Layout<D, 2, bwd_rows<D>()>::bytes(2 * tile_rows<D>());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// word offset of element (r, col) of a resident tile: rows unpadded, the
// 16-byte chunks of row r permuted by chunk ^ (r % 8), so that `frag_a`'s
// reads (rows g, g + 8; columns c, c + 4) fall on 32 different banks
template <int D>
__device__ __forceinline__ int swz(int r, int col) {
  return r * D + (col ^ ((r & 7) << 2));
}

// rows row0 .. row0 + R - 1 of one head of a [B, T, H, D] fp32 tensor
// (`src` at its batch and head, rows `stride` floats apart), 16 bytes a
// cp.async, into a resident tile (kSwz) or a raw [R][D] stage; rows at or
// past `rows` are zeros
template <int R, int D, bool kSwz>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int rows, int64_t stride) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const bool valid = row0 + r < rows;
    cp_async16(dst + (kSwz ? swz<D>(r, c) : r * D + c),
               valid ? src + (row0 + r) * stride + c : src, valid);
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, by integer ops on its bits: `split_tf32` in ops/flash_attention.py
// is the same rounding
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo as TF32 operands. The tensor cores read only the top 19
// bits of an operand, so lo keeps its rounding increment unmasked: they
// read round_tf32(x - hi).
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = round_tf32(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i])) + 0x1000u;
  }
}

// a raw [R][D] stage into its hi and lo planes, once for the block
template <int R, int D>
__device__ __forceinline__ void split_tile(uint32_t* hi, uint32_t* lo,
                                           const float* raw) {
  for (int i = threadIdx.x; i < R * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * D + c);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
    split(x, h, l);
    *reinterpret_cast<uint4*>(hi + r * ld<D>() + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * ld<D>() + c) = make_uint4(l[0], l[1], l[2], l[3]);
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

// In the m16n8k8 layout thread (g, c) = (lane / 4, lane % 4) holds A at
// rows g, g + 8 and columns c, c + 4; B at rows (k) c, c + 4 and column
// (n) g; C at rows g, g + 8 and columns 2c, 2c + 1.

// the A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 7 of a
// resident tile, split here
template <int D>
__device__ __forceinline__ FragA frag_a(const float* t, int row0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int r = row0 + g;
  const float x[4] = {t[swz<D>(r, k0 + c)], t[swz<D>(r + 8, k0 + c)],
                      t[swz<D>(r, k0 + c + 4)], t[swz<D>(r + 8, k0 + c + 4)]};
  FragA f;
  split(x, f.hi, f.lo);
  return f;
}

// B(k, n) = T[n0 + n][k0 + k] from a streamed tile's planes: its rows as
// B's columns (s = q . k^T)
template <int D>
__device__ __forceinline__ FragB frag_bt(const uint32_t* hi, const uint32_t* lo,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int off = (n0 + (lane >> 2)) * ld<D>() + k0 + (lane & 3);
  return FragB{{hi[off], hi[off + 4]}, {lo[off], lo[off + 4]}};
}

// B(k, n) = T[k0 + perm(k)][n0 + n], perm(c) = 2c, perm(c + 4) = 2c + 1:
// a streamed tile as it lies, its rows in the order of `frag_c2a`'s k
template <int D>
__device__ __forceinline__ FragB frag_b(const uint32_t* hi, const uint32_t* lo,
                                        int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int off = (k0 + 2 * (lane & 3)) * ld<D>() + n0 + (lane >> 2);
  return FragB{{hi[off], hi[off + ld<D>()]}, {lo[off], lo[off + ld<D>()]}};
}

// an m16n8 C fragment (columns 2c, 2c + 1) as the A fragment of a k-step
// over its 8 columns, k permuted as in `frag_b`: no data moves between
// threads
__device__ __forceinline__ FragA frag_c2a(const float (&acc)[4]) {
  const float x[4] = {acc[0], acc[2], acc[1], acc[3]};
  FragA f;
  split(x, f.hi, f.lo);
  return f;
}

// c[16 x 8NT] += A[16 x D] . Bt^T: A rows row0 .. row0 + 15 of a
// resident tile, Bt the 8NT rows of a streamed tile (s = q . k^T)
template <int NT, int D>
__device__ __forceinline__ void gemm_abt(float (&c)[NT][4], const float* a, int row0,
                                         const uint32_t* bhi, const uint32_t* blo) {
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    const FragA fa = frag_a<D>(a, row0, k0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma3(c[nt], fa, frag_bt<D>(bhi, blo, 8 * nt, k0));
  }
}

// c[16 x D] += P . B: P the 16 x 8KS C fragments of an earlier product,
// in registers; B the 8KS rows of a streamed tile (p . v, ds . k)
template <int KS, int D>
__device__ __forceinline__ void gemm_pb(float (&c)[D / 8][4], const float (&p)[KS][4],
                                        const uint32_t* bhi, const uint32_t* blo) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const FragA fa = frag_c2a(p[ks]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      mma3(c[nt], fa, frag_b<D>(bhi, blo, 8 * ks, 8 * nt));
    }
  }
}

}  // namespace tf32

// o (and lse) for 128 query rows of one head: each warp owns 16 rows and
// walks the key tiles up to the block's causal frontier, s = q . k^T and
// o += p . v in split TF32, the online softmax in registers. Each key
// tile is copied raw into the stage while the tile before it is used,
// then split once into the planes.
template <int D>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_fwd_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pad,
                      float* __restrict__ o, float* __restrict__ lse, int Tq,
                      int Tkv, int H, int causal, float scale) {
  using namespace tf32;
  using L = Layout<D, 1>;
  constexpr int KT = L::R, NO = D / 8, NS = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Qs + L::planes_off);
  uint32_t* Kl = Kh + L::plane;
  uint32_t* Vh = Kl + L::plane;
  uint32_t* Vl = Vh + L::plane;
  float* Kraw = Qs + L::stage_off;
  float* Vraw = Kraw + L::stage;
  int* keep_s = reinterpret_cast<int*>(Qs + L::extra_off);

  const int h = blockIdx.x, b = blockIdx.z;
  // causal: the last query blocks see the most key tiles; launch them first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const float* qb = q + static_cast<int64_t>(b) * Tq * stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const int n_kv = (Tkv + KT - 1) / KT;
  const int n_tiles =
      causal ? min(n_kv, min(q0 + kRows - 1, Tq - 1) / KT + 1) : n_kv;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3, m0 = 16 * warp;
  const int qw = q0 + m0;  // the warp's first query row
  const int rows[2] = {qw + (lane >> 2), qw + (lane >> 2) + 8};

  // key tile `it` raw into the stage, one cp.async group; this thread's
  // keep flag for it (threads < KT; true for the others)
  auto fetch = [&](int it) {
    const int k0 = it * KT;
    load_rows<KT, D, false>(Kraw, kb, k0, Tkv, stride);
    load_rows<KT, D, false>(Vraw, vb, k0, Tkv, stride);
    cp_async_commit();
    bool kp = true;
    if (threadIdx.x < KT) {
      const int key = k0 + threadIdx.x;
      kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
    }
    return kp;
  };
  // the landed stage into the planes, then a barrier; whether every key
  // of the tile is kept
  auto convert = [&](bool kp) {
    split_tile<KT, D>(Kh, Kl, Kraw);
    split_tile<KT, D>(Vh, Vl, Vraw);
    if (threadIdx.x < KT) keep_s[threadIdx.x] = kp;
    return __syncthreads_and(kp) != 0;
  };

  load_rows<kRows, D, true>(Qs, qb, q0, Tq, stride);
  bool kp = fetch(0);  // q and key tile 0 in one group
  cp_async_wait_all();
  __syncthreads();
  bool all_keep = convert(kp);
  if (n_tiles > 1) kp = fetch(1);

  float acc[NO][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    // a warp whose rows all lie before the tile (causal) or past Tq skips it
    if (qw < Tq && !(causal && k0 > qw + 15)) {
      float s[NS][4];
      zero(s);
      gemm_abt<NS, D>(s, Qs, m0, Kh, Kl);
      const bool interior = k0 + KT <= Tkv && all_keep && qw + 15 < Tq &&
                            (!causal || k0 + KT - 1 <= qw);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * c + (e & 1);
          float x = s[nt][e] * scale;
          if (!interior) {
            x = masked(x, rows[e >> 1], k0 + col, Tq, Tkv, causal, keep_s[col]);
          }
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
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m[e >> 1]);
          sum[e >> 1] += s[nt][e];
        }
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
      gemm_pb<NS, D>(acc, s, Vh, Vl);
    }
    if (it + 1 < n_tiles) {
      cp_async_wait_all();
      __syncthreads();  // the planes are read and the next stage has landed
      all_keep = convert(kp);
      if (it + 2 < n_tiles) kp = fetch(it + 2);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && c == 0 && rows[i] < Tq) {
      lse[(static_cast<int64_t>(b) * H + h) * Tq + rows[i]] = m[i] + logf(l[i]);
    }
  }
  float* ob = o + static_cast<int64_t>(b) * Tq * stride + h * D;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < Tq) {
        put2(ob + rows[i] * stride + 8 * nt + 2 * c, acc[nt][2 * i] / l[i],
             acc[nt][2 * i + 1] / l[i]);
      }
    }
  }
}

// dq for 128 query rows of one head, and delta = sum(dO * O) for them
// (written for the dk/dv launch that follows): each warp owns 16 rows and
// walks the key tiles up to its causal frontier, s = q . k^T and
// dp = dO . v^T, ds in registers, then dq += ds . k.
template <int D>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dq_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ pad,
                     const float* __restrict__ dout, const float* __restrict__ o,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     float* __restrict__ dq, int Tq, int Tkv, int H, int causal,
                     float scale) {
  using namespace tf32;
  using L = Layout<D, 2>;
  constexpr int KT = L::R, NO = D / 8, NS = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + L::own;
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Qs + L::planes_off);
  uint32_t* Kl = Kh + L::plane;
  uint32_t* Vh = Kl + L::plane;
  uint32_t* Vl = Vh + L::plane;
  float* Kraw = Qs + L::stage_off;
  float* Vraw = Kraw + L::stage;
  int* keep_s = reinterpret_cast<int*>(Qs + L::extra_off);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int n_kv = (Tkv + KT - 1) / KT;
  const int n_tiles =
      causal ? min(n_kv, min(q0 + kRows - 1, Tq - 1) / KT + 1) : n_kv;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, m0 = 16 * warp;
  const int qw = q0 + m0;
  const int rows[2] = {qw + g, qw + g + 8};

  auto fetch = [&](int it) {
    const int k0 = it * KT;
    load_rows<KT, D, false>(Kraw, kb, k0, Tkv, stride);
    load_rows<KT, D, false>(Vraw, vb, k0, Tkv, stride);
    cp_async_commit();
    bool kp = true;
    if (threadIdx.x < KT) {
      const int key = k0 + threadIdx.x;
      kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
    }
    return kp;
  };
  auto convert = [&](bool kp) {
    split_tile<KT, D>(Kh, Kl, Kraw);
    split_tile<KT, D>(Vh, Vl, Vraw);
    if (threadIdx.x < KT) keep_s[threadIdx.x] = kp;
    return __syncthreads_and(kp) != 0;
  };

  load_rows<kRows, D, true>(Qs, q + qoff, q0, Tq, stride);
  load_rows<kRows, D, true>(dOs, dout + qoff, q0, Tq, stride);
  bool kp = fetch(0);  // q, dO and key tile 0 in one group
  cp_async_wait_all();
  __syncthreads();

  // delta = sum(dO * O) over the warp's 16 rows: two lanes a row, half of
  // D each, dO from shared memory
  float row_delta[2];
  {
    const int r = lane >> 1, half = lane & 1, qrow = qw + r;
    float sum = 0.f;
    if (qrow < Tq) {
      const float* orow = o + qoff + qrow * stride;
#pragma unroll 4
      for (int j = half * (D / 2); j < (half + 1) * (D / 2); j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(dOs + swz<D>(m0 + r, j));
        const float4 bb = *reinterpret_cast<const float4*>(orow + j);
        sum = fmaf(a.x, bb.x, sum);
        sum = fmaf(a.y, bb.y, sum);
        sum = fmaf(a.z, bb.z, sum);
        sum = fmaf(a.w, bb.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0 && qrow < Tq) delta[stat0 + qrow] = sum;
    row_delta[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    row_delta[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
  }
  float row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row_lse[i] = rows[i] < Tq ? lse[stat0 + rows[i]] : 0.f;

  bool all_keep = convert(kp);
  if (n_tiles > 1) kp = fetch(1);

  float acc[NO][4];
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    if (qw < Tq && !(causal && k0 > qw + 15)) {
      float s[NS][4], dp[NS][4];
      zero(s);
      zero(dp);
      gemm_abt<NS, D>(s, Qs, m0, Kh, Kl);
      gemm_abt<NS, D>(dp, dOs, m0, Vh, Vl);
      const bool interior = k0 + KT <= Tkv && all_keep && qw + 15 < Tq &&
                            (!causal || k0 + KT - 1 <= qw);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = 8 * nt + 2 * c + (e & 1);
          float x = s[nt][e] * scale;
          if (!interior) {
            x = masked(x, rows[i], k0 + col, Tq, Tkv, causal, keep_s[col]);
          }
          s[nt][e] = expf(x - row_lse[i]) * (dp[nt][e] - row_delta[i]);
        }
      }
      gemm_pb<NS, D>(acc, s, Kh, Kl);
    }
    if (it + 1 < n_tiles) {
      cp_async_wait_all();
      __syncthreads();
      all_keep = convert(kp);
      if (it + 2 < n_tiles) kp = fetch(it + 2);
    }
  }

  float* dqb = dq + qoff;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < Tq) {
        put2(dqb + rows[i] * stride + 8 * nt + 2 * c, scale * acc[nt][2 * i],
             scale * acc[nt][2 * i + 1]);
      }
    }
  }
}

// dk, dv for 128 key rows of one head: each warp owns 16 key rows and
// walks the query tiles from the causal diagonal down, s^T = k . q^T and
// dp^T = v . dO^T, p^T and ds^T in registers, dv += p^T . dO and
// dk += ds^T . q.
template <int D>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dkv_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pad,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Tq, int Tkv, int H, int causal,
                      float scale) {
  using namespace tf32;
  using L = Layout<D, 2>;
  constexpr int QT = L::R, NO = D / 8, NS = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + L::own;
  uint32_t* Qh = reinterpret_cast<uint32_t*>(Ks + L::planes_off);
  uint32_t* Ql = Qh + L::plane;
  uint32_t* Dh = Ql + L::plane;  // dO
  uint32_t* Dl = Dh + L::plane;
  float* Qraw = Ks + L::stage_off;
  float* Draw = Qraw + L::stage;
  float* lse_s = Ks + L::extra_off;
  float* delta_s = lse_s + QT;

  // causal: the first key blocks see the most query tiles, and the tile
  // index is the grid's slower axis, so they start first
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kRows;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const int64_t koff = static_cast<int64_t>(b) * Tkv * stride + h * D;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int n_q = (Tq + QT - 1) / QT;
  const int first = causal ? k0 / QT : 0;
  const int n_tiles = max(n_q - first, 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, m0 = 16 * warp;
  const int kw = k0 + m0;  // the warp's first key row
  const int kr[2] = {kw + g, kw + g + 8};
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keep[i] = kr[i] < Tkv &&
              (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + kr[i]] != 0);
  }
  const bool warp_keep = __all_sync(0xffffffffu, keep[0] && keep[1]);

  // query tile `it` (q and dO) raw into the stage, one cp.async group,
  // and its lse and delta into registers (threads < QT)
  float next_lse = 0.f, next_delta = 0.f;
  auto fetch = [&](int it) {
    const int q0 = (first + it) * QT;
    load_rows<QT, D, false>(Qraw, q + qoff, q0, Tq, stride);
    load_rows<QT, D, false>(Draw, dout + qoff, q0, Tq, stride);
    cp_async_commit();
    if (threadIdx.x < QT) {
      const bool in = q0 + threadIdx.x < Tq;
      next_lse = in ? lse[stat0 + q0 + threadIdx.x] : 0.f;
      next_delta = in ? delta[stat0 + q0 + threadIdx.x] : 0.f;
    }
  };
  auto convert = [&]() {
    split_tile<QT, D>(Qh, Ql, Qraw);
    split_tile<QT, D>(Dh, Dl, Draw);
    if (threadIdx.x < QT) {
      lse_s[threadIdx.x] = next_lse;
      delta_s[threadIdx.x] = next_delta;
    }
    __syncthreads();
  };

  load_rows<kRows, D, true>(Ks, k + koff, k0, Tkv, stride);
  load_rows<kRows, D, true>(Vs, v + koff, k0, Tkv, stride);
  if (n_tiles > 0) {
    fetch(0);  // k, v and query tile 0 in one group
  } else {
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();
  if (n_tiles > 0) convert();
  if (n_tiles > 1) fetch(1);

  float acc_k[NO][4], acc_v[NO][4];
  zero(acc_k);
  zero(acc_v);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (first + it) * QT;
    // a warp whose keys all lie after the tile's queries (causal), or
    // past Tkv, skips it
    if (kw < Tkv && !(causal && kw > q0 + QT - 1)) {
      // p^T = exp(s^T - lse): rows are keys, columns queries
      float p[NS][4];
      zero(p);
      gemm_abt<NS, D>(p, Ks, m0, Qh, Ql);
      const bool interior = q0 + QT <= Tq && warp_keep && (!causal || kw + 15 <= q0);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * c + (e & 1);
          float x = p[nt][e] * scale;
          if (!interior) {
            x = masked(x, q0 + col, kr[e >> 1], Tq, Tkv, causal, keep[e >> 1]);
          }
          p[nt][e] = expf(x - lse_s[col]);
        }
      }
      gemm_pb<NS, D>(acc_v, p, Dh, Dl);
      // ds^T = p^T (dp^T - delta)
      float dp[NS][4];
      zero(dp);
      gemm_abt<NS, D>(dp, Vs, m0, Dh, Dl);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[nt][e] = p[nt][e] * (dp[nt][e] - delta_s[8 * nt + 2 * c + (e & 1)]);
        }
      }
      gemm_pb<NS, D>(acc_k, dp, Qh, Ql);
    }
    if (it + 1 < n_tiles) {
      cp_async_wait_all();
      __syncthreads();  // the planes are read and the next stage has landed
      convert();
      if (it + 2 < n_tiles) fetch(it + 2);
    }
  }

#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kr[i] < Tkv) {
        const int64_t row = koff + kr[i] * stride + 8 * nt + 2 * c;
        put2(dk + row, scale * acc_k[nt][2 * i], scale * acc_k[nt][2 * i + 1]);
        put2(dv + row, acc_v[nt][2 * i], acc_v[nt][2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------ fp32 at D = 256 (TF32)
//
// The forward is `flash_fwd_kernel_tf32_d256` (its note is at the kernel):
// 64 own query rows split once into planes read by wgmma, a producer
// warpgroup splitting each key tile once into a ring of planes, s and
// p . v on TF32 wgmma.
//
// The backward (`flash_dq_kernel_tf32_d256`, `flash_dkv_kernel_tf32_d256`)
// cannot keep two [128][256] resident tiles (256 KB), so its blocks own 64
// rows (two raw tiles, 128 KB, read as in the D <= 128 kernels) and stream
// 16-row tiles, split once a tile into hi and lo planes (64 KB). The two
// warpgroups split each tile's work by product, and the warps w and w + 4
// that share a 16-row group meet through shared memory:
//   * dk/dv: warpgroup 0 computes s^T = k . q^T for the block's 64 keys,
//     warpgroup 1 dp^T = v . dO^T. Warp w turns its rows of s^T into p^T,
//     hands p^T to warp w + 4 and adds p^T . dO into dv; warp w + 4 forms
//     ds^T and adds ds^T . q into dk: four products a tile, s^T once. dv
//     and dk of 16 rows at D 256 are 128 floats a thread each, so one warp
//     cannot hold both.
//   * dq: warpgroup 0 computes s = q . k^T and p, warpgroup 1 dp; warps w
//     and w + 4 trade p and dp, both form ds (the same bits), and each adds
//     ds . k into its half of dq's columns: 64 accumulators a thread, no
//     partial sums to add, one writer a value.
//   * s, s^T, dp and dp^T (M 64, N 16, K = D = 256) run on wgmma TF32
//     (`wgmma_abt`): A (k, v, q or dO) from registers, split a k-step from
//     the raw resident tile, two groups of k-steps in flight; B read once
//     for the warpgroup from the streamed tile's planes, which lie K-major
//     under the 128-byte swizzle with each box's 16 hi rows followed by
//     its 16 lo rows (`sw_off`), so a k-step is two products: hi . [hi |
//     lo] (m64n32k8) and lo . hi (m64n16k8). Their sums, lo.hi + hi.lo and
//     hi.hi, are added small first at the end, as the CPU model sums them
//     (`_split_attention` in tests/test_torch_flash.py). N is 16 or 32
//     because a stage holds 16 rows; alone, the n32 + n16 pair runs at 383
//     TFLOP/s on an H100 (scripts/wgmma_tf32_rate.cu), in these kernels at
//     under half that (PERF.md §6).
//   * dv, dk and dq contract over the tile's 16 rows and stay on mma.sync
//     m16n8k8 (`gemm_pb_sw`: A the C fragments of p^T, ds^T or ds in
//     registers, B fragments from the same planes, one accumulator an
//     8-column n-tile): TF32 wgmma reads B from shared memory only
//     K-major (the transpose exists for 16-bit types), and transposed
//     copies of the planes (64 KB more a 16-row tile) do not fit beside
//     the resident 128 KB, the planes and a stage. Planes in bf16x3 (6
//     bytes an element, read MN-major: 48 KB a stage) would fit and put
//     these products on wgmma too, at six bf16 products a pass; not built.
//   * dk/dv copies each tile raw into a stage (cp.async, 32 KB) and splits
//     it for the block between two barriers (230,528 bytes); the p^T
//     hand-over lies over the stage's q rows, free from one split until
//     the next tile's q copy, which the four dk warps issue once they have
//     read it. dq keeps no stage: each thread loads its 32 values of the
//     next key tile into registers at the top of a tile and splits them at
//     the end (205,888 bytes; the hand-overs 8 KB of their own). A ring of
//     planes split by warps of their own needs a second set of planes
//     (64 KB): 1.9 KB are left in dk/dv.
namespace tf32 {

// The D 256 backward's planes: a streamed 16-row tile's hi and lo values
// as D / 32 boxes of 32 rows of 32 words (128 bytes), the tile's 16 rows of
// hi then its 16 rows of lo (4 KB a box), the 16-byte chunks of row r
// permuted by chunk ^ (r % 8), from a 1024-byte boundary: the layout a
// 128-byte-swizzle wgmma descriptor reads K-major, as a 16-row operand (hi)
// or a 32-row one (hi then lo); and one where `frag_b_sw`'s reads (rows
// 2c, 2c + 1; eight columns) hit 32 banks
constexpr int kSwRows = 16;
constexpr int kSwBox = 2 * kSwRows * 32;  // words
constexpr int kSwLo = kSwRows * 32;       // lo's rows after hi's, in words
constexpr int kSwPlanes = 256 / 32 * kSwBox;  // a tile's hi and lo, in words

// (row r, column col)'s word in the hi rows; its lo value is kSwLo on
__device__ __forceinline__ int sw_off(int r, int col) {
  return (col >> 5) * kSwBox + r * 32 + ((((col & 31) >> 2) ^ (r & 7)) << 2) + (col & 3);
}

// `frag_b` from swizzled planes
__device__ __forceinline__ FragB frag_b_sw(const uint32_t* hi, const uint32_t* lo,
                                           int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + 2 * (lane & 3), col = n0 + (lane >> 2);
  const int o0 = sw_off(r, col), o1 = sw_off(r + 1, col);
  return FragB{{hi[o0], hi[o1]}, {lo[o0], lo[o1]}};
}

// c[16 x 8NT] += P . B[:, n0 .. n0 + 8NT): `gemm_pb` from swizzled planes,
// over a band of D's columns, an n-tile's k-steps together (they share
// the swizzle's offsets: rows 8ks + 2c lie in the same row of 8)
template <int KS, int NT>
__device__ __forceinline__ void gemm_pb_sw(float (&c)[NT][4], const float (&p)[KS][4],
                                           const uint32_t* bhi, const uint32_t* blo,
                                           int n0) {
#pragma unroll
  FragA fa[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) fa[ks] = frag_c2a(p[ks]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      mma3(c[nt], fa[ks], frag_b_sw(bhi, blo, 8 * ks, n0 + 8 * nt));
    }
  }
}

// hi and lo of 4 consecutive values (row r, columns col .. col + 3) into
// swizzled planes
__device__ __forceinline__ void put_split_sw(uint32_t* hi, uint32_t* lo, int r, int col,
                                             float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[4], l[4];
  split(x, h, l);
  const int o = sw_off(r, col);
  *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
}

// a raw [16][D] stage into its swizzled planes, once for the block
template <int D>
__device__ __forceinline__ void split_tile_sw(uint32_t* hi, uint32_t* lo,
                                              const float* raw) {
  for (int i = threadIdx.x; i < kSwRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    put_split_sw(hi, lo, r, col, *reinterpret_cast<const float4*>(raw + r * D + col));
  }
}

// this thread's share (kRegs float4) of a streamed tile's 16 rows from row
// row0 of one head, straight into registers; rows at or past `rows` zeros
template <int D>
struct TileRegs {
  static constexpr int kRegs = kSwRows * D / 4 / kThreads;
  float4 x[kRegs];

  __device__ __forceinline__ void load(const float* src, int row0, int rows,
                                       int64_t stride) {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (D / 4), col = (i % (D / 4)) * 4;
      x[j] = row0 + r < rows
                 ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * stride + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void split_into(uint32_t* hi, uint32_t* lo) const {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int i = threadIdx.x + j * kThreads;
      put_split_sw(hi, lo, i / (D / 4), (i % (D / 4)) * 4, x[j]);
    }
  }
};

// c[16 x 16] = A . Bt^T for this warp's 16 rows of the warpgroup's 64, on
// wgmma TF32 in three passes: A rows row0 .. row0 + 15 of a raw resident
// tile, split a k-step into registers (`frag_a`), kC k-steps a group, two
// groups' A fragments in registers (a group is loaded while the one before
// it runs; a third buffer ran no faster). Bt the 16 rows of a streamed
// tile from its swizzled planes at shared address `bt`. A k-step is two
// products: hi . [hi | lo] (m64n32k8 over the box's 32 rows: hi.hi and
// hi.lo side by side) and lo . hi (m64n16k8), into separate accumulators
// (the two sharing hi.lo's registers ran slower). Step j of a group goes
// into accumulator set j % kK (dk/dv takes two: with one, ptxas spilled
// it). c = (lo.hi + hi.lo) + hi.hi, each summed over the sets. Every
// thread of the warpgroup calls it alike.
template <int D, int kC, int kK>
__device__ __forceinline__ void wgmma_abt(float (&c)[2][4], const float* a, int row0,
                                          uint32_t bt) {
  constexpr int kG = D / 8 / kC, kBuf = 2;  // groups of k-steps, buffers
  static_assert(kC % kK == 0, "a group covers every accumulator set");
  float lh[kK][8], hb[kK][16];  // lo.hi; hi.hi then hi.lo
#pragma unroll
  for (int x = 0; x < kK; ++x) {
#pragma unroll
    for (int i = 0; i < 8; ++i) lh[x][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) hb[x][i] = 0.f;
    sm90::fence_regs(lh[x]);
    sm90::fence_regs(hb[x]);
  }
  uint32_t ah[kBuf][kC][4], al[kBuf][kC][4];
  auto load = [&](int grp, uint32_t (&h)[kC][4], uint32_t (&l)[kC][4]) {
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const FragA f = frag_a<D>(a, row0, 8 * (grp * kC + j));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[j][e] = f.hi[e];
        l[j][e] = f.lo[e];
      }
    }
  };
#pragma unroll
  for (int grp = 0; grp < kBuf - 1; ++grp) load(grp, ah[grp], al[grp]);
#pragma unroll
  for (int grp = 0; grp < kG; ++grp) {
    const int b = grp % kBuf;
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int kk = grp * kC + j;
      const uint64_t db =
          sm90::desc_sw128(bt + (kk >> 2) * (4 * kSwBox) + (kk & 3) * 32, 16, 1024);
      sm90::wgmma_m64n16k8_tf32_rs(lh[j % kK], al[b][j], db);
      sm90::wgmma_m64n32k8_tf32_rs(hb[j % kK], ah[b][j], db);
    }
    sm90::wgmma_commit();
    const int nx = grp + kBuf - 1;  // into the registers of group grp - 1
    if (nx < kG) {
      sm90::wgmma_wait<1>();  // group grp - 1 is done
      sm90::fence_regs(ah[nx % kBuf]);
      sm90::fence_regs(al[nx % kBuf]);
      load(nx, ah[nx % kBuf], al[nx % kBuf]);
    }
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kBuf; ++i) {
    sm90::fence_regs(ah[i]);
    sm90::fence_regs(al[i]);
  }
#pragma unroll
  for (int x = 0; x < kK; ++x) {
    sm90::fence_regs(lh[x]);
    sm90::fence_regs(hb[x]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float small = 0.f, big = 0.f;
#pragma unroll
    for (int x = 0; x < kK; ++x) {
      small += lh[x][i] + hb[x][8 + i];
      big += hb[x][i];
    }
    c[i >> 2][i & 3] = small + big;
  }
}

// a warp's 16 x 8NT C fragments into shared memory and back, lane-major
// (no bank conflicts): the hand-over between the two warps of a pair
template <int NT>
__device__ __forceinline__ void put_frags(float* x, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * nt + e) * 32 + lane] = c[nt][e];
  }
}

template <int NT>
__device__ __forceinline__ void get_frags(float (&c)[NT][4], const float* x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = x[(4 * nt + e) * 32 + lane];
  }
}

// `load_rows` into a raw stage issued by kN threads of the block, t = 0 ..
// kN - 1 its own index among them
template <int R, int D, int kN>
__device__ __forceinline__ void load_rows_by(float* dst, const float* src, int row0,
                                             int rows, int64_t stride, int t) {
  constexpr int kPerRow = D / 4;
  for (int i = t; i < R * kPerRow; i += kN) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * D + c, valid ? src + (row0 + r) * stride + c : src, valid);
  }
}

// shared memory of the D 256 backward, in words from a 1024-byte boundary
// (the launch asks for 1024 bytes more): four swizzled planes, the two raw
// resident [64][256] tiles, then dk/dv's raw stage and per-row lse and
// delta, or dq's hand-overs and keep flags
struct Wide {
  static constexpr int kOwn = 64, kTile = 16, D = 256;
  static constexpr int planes = 0;
  static constexpr int own = 2 * kSwPlanes;               // 2 x [64][256]
  static constexpr int after = own + 2 * kOwn * D;
  static constexpr int kX = 2 * 4 * 32;                   // a 16 x 16 hand-over
  static constexpr size_t dkv_bytes = 4u * (after + 2 * kTile * D + 2 * kTile) + 1024;
  static constexpr size_t dq_bytes = 4u * (after + 4 * 2 * kX + kTile) + 1024;
};

__device__ __forceinline__ float* wide_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t off = (1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u;
  return reinterpret_cast<float*>(smem_raw + off);
}

}  // namespace tf32

// dq at D 256 for 64 query rows of one head, and delta = sum(dO * O) for
// them, over 16-key tiles: warpgroup 0 computes s (and warp w, p for its
// 16 rows), warpgroup 1 dp; warps w and w + 4 trade p and dp, both form
// ds, and warp w adds ds . k into dq's first 128 columns, w + 4 the last.
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dq_kernel_tf32_d256(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ pad,
                          const float* __restrict__ dout, const float* __restrict__ o,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          float* __restrict__ dq, int Tq, int Tkv, int H, int causal,
                          float scale) {
  using namespace tf32;
  using W = Wide;
  constexpr int D = W::D, OWN = W::kOwn, KT = W::kTile, kGroups = OWN / 16;
  constexpr int NS = KT / 8, NH = D / 16, kX = W::kX;
  static_assert(kWarps == 2 * kGroups, "a pair of warps a 16-row group");
  float* sm = wide_smem();
  uint32_t* Kh = reinterpret_cast<uint32_t*>(sm + W::planes);
  uint32_t* Kl = Kh + kSwLo;
  uint32_t* Vh = Kh + kSwPlanes;
  uint32_t* Vl = Vh + kSwLo;
  float* Qs = sm + W::own;
  float* dOs = Qs + OWN * D;
  float* xs_all = sm + W::after;
  int* keep_s = reinterpret_cast<int*>(xs_all + kGroups * 2 * kX);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * OWN;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int n_kv = (Tkv + KT - 1) / KT;
  const int n_tiles =
      causal ? min(n_kv, min(q0 + OWN - 1, Tq - 1) / KT + 1) : n_kv;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int grp = warp % kGroups, part = warp / kGroups;
  const int m0 = 16 * grp, qw = q0 + m0;
  const int rows[2] = {qw + g, qw + g + 8};
  float* xs = xs_all + grp * 2 * kX;  // the pair's p, then dp

  // key tile `it`'s k and v rows into registers; this thread's keep flag
  // for it (threads < KT; true for the others)
  TileRegs<D> kt, vt;
  auto fetch = [&](int it) {
    const int kt0 = it * KT;
    kt.load(kb, kt0, Tkv, stride);
    vt.load(vb, kt0, Tkv, stride);
    bool kp = true;
    if (threadIdx.x < KT) {
      const int key = kt0 + threadIdx.x;
      kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
    }
    return kp;
  };
  // the fetched tile into the planes (visible to wgmma), then a barrier;
  // whether every key of the tile is kept
  auto convert = [&](bool kp) {
    kt.split_into(Kh, Kl);
    vt.split_into(Vh, Vl);
    if (threadIdx.x < KT) keep_s[threadIdx.x] = kp;
    sm90::fence_async_smem();
    return __syncthreads_and(kp) != 0;
  };

  load_rows<OWN, D, true>(Qs, q + qoff, q0, Tq, stride);
  load_rows<OWN, D, true>(dOs, dout + qoff, q0, Tq, stride);
  cp_async_commit();
  bool kp = fetch(0);
  cp_async_wait_all();
  __syncthreads();

  // delta = sum(dO * O) over the pair's 16 rows: two lanes a row, half of
  // D each, dO from shared memory; the first warp of the pair writes it
  float row_delta[2];
  {
    const int r = lane >> 1, half = lane & 1, qrow = qw + r;
    float sum = 0.f;
    if (qrow < Tq) {
      const float* orow = o + qoff + qrow * stride;
#pragma unroll 4
      for (int j = half * (D / 2); j < (half + 1) * (D / 2); j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(dOs + swz<D>(m0 + r, j));
        const float4 bb = *reinterpret_cast<const float4*>(orow + j);
        sum = fmaf(a.x, bb.x, sum);
        sum = fmaf(a.y, bb.y, sum);
        sum = fmaf(a.z, bb.z, sum);
        sum = fmaf(a.w, bb.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0 && half == 0 && qrow < Tq) delta[stat0 + qrow] = sum;
    row_delta[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    row_delta[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
  }
  float row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row_lse[i] = rows[i] < Tq ? lse[stat0 + rows[i]] : 0.f;

  bool all_keep = convert(kp);

  // warpgroup 0: s = q . k^T; warpgroup 1: dp = dO . v^T
  const float* a_tile = part == 0 ? Qs : dOs;
  const uint32_t b_tile = sm90::smem_u32(part == 0 ? Kh : Vh);
  float acc[NH][4];  // dq's columns n0 .. n0 + 127, unscaled
  zero(acc);
  const int n0 = part * (D / 2);
  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = it * KT;
    const bool more = it + 1 < n_tiles;
    if (more) kp = fetch(it + 1);  // under this tile's products
    float sd[NS][4];
    wgmma_abt<D, 4, 1>(sd, a_tile, m0, b_tile);
    // a pair whose rows all lie before the tile (causal) or past Tq has
    // p = 0 there: it skips the rest
    if (qw < Tq && !(causal && kt0 > qw + 15)) {
      if (part == 0) {  // p = exp(s - lse)
        const bool interior = kt0 + KT <= Tkv && all_keep && qw + 15 < Tq &&
                              (!causal || kt0 + KT - 1 <= qw);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * nt + 2 * c + (e & 1);
            float x = sd[nt][e] * scale;
            if (!interior) {
              x = masked(x, rows[e >> 1], kt0 + col, Tq, Tkv, causal, keep_s[col]);
            }
            sd[nt][e] = expf(x - row_lse[e >> 1]);
          }
        }
      }
      put_frags(xs + part * kX, sd);
      sm90::named_sync(1 + grp, 64);
      float other[NS][4];
      get_frags(other, xs + (1 - part) * kX);
      // ds = p (dp - delta), the same bits in both warps
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = part == 0 ? sd[nt][e] : other[nt][e];
          const float dp = part == 0 ? other[nt][e] : sd[nt][e];
          sd[nt][e] = p * (dp - row_delta[e >> 1]);
        }
      }
      gemm_pb_sw<NS, NH>(acc, sd, Kh, Kl, n0);
    }
    if (more) {
      __syncthreads();  // the planes and the hand-overs are read
      all_keep = convert(kp);
    }
  }

  float* dqb = dq + qoff;
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < Tq) {
        put2(dqb + rows[i] * stride + n0 + 8 * nt + 2 * c, scale * acc[nt][2 * i],
             scale * acc[nt][2 * i + 1]);
      }
    }
  }
}

// dk, dv at D 256 for 64 key rows of one head, walking the 16-row query
// tiles from the causal diagonal down: warpgroup 0 computes s^T (and warp
// w, p^T for its 16 key rows) and accumulates dv; warpgroup 1 computes
// dp^T, and warp w + 4 takes p^T from warp w, forms ds^T and accumulates
// dk.
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_dkv_kernel_tf32_d256(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ pad,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int Tq, int Tkv, int H, int causal,
                           float scale) {
  using namespace tf32;
  using W = Wide;
  constexpr int D = W::D, OWN = W::kOwn, QT = W::kTile, kGroups = OWN / 16;
  constexpr int NO = D / 8, NS = QT / 8, kX = W::kX;
  static_assert(kWarps == 2 * kGroups, "a pair of warps a 16-row group");
  static_assert(kGroups * kX <= QT * D, "p^T fits the q stage");
  float* sm = wide_smem();
  uint32_t* Qh = reinterpret_cast<uint32_t*>(sm + W::planes);
  uint32_t* Ql = Qh + kSwLo;
  uint32_t* Dh = Qh + kSwPlanes;  // dO
  uint32_t* Dl = Dh + kSwLo;
  float* Ks = sm + W::own;
  float* Vs = Ks + OWN * D;
  float* Qraw = sm + W::after;
  float* Draw = Qraw + QT * D;
  float* lse_s = Draw + QT * D;
  float* delta_s = lse_s + QT;

  // causal: the first key blocks see the most query tiles, and the tile
  // index is the grid's slower axis, so they start first
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * OWN;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const int64_t koff = static_cast<int64_t>(b) * Tkv * stride + h * D;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int n_q = (Tq + QT - 1) / QT;
  const int first = causal ? k0 / QT : 0;
  const int n_tiles = max(n_q - first, 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int grp = warp % kGroups, m0 = 16 * grp;
  const bool dk_warp = warp >= kGroups;
  const int kw = k0 + m0;  // the pair's first key row
  const int kr[2] = {kw + g, kw + g + 8};
  float* xp = Qraw + grp * kX;  // the pair's p^T, over the q stage
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keep[i] = kr[i] < Tkv &&
              (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + kr[i]] != 0);
  }
  const bool warp_keep = __all_sync(0xffffffffu, keep[0] && keep[1]);

  // query tile `it`'s lse and delta into registers (threads < QT)
  float next_lse = 0.f, next_delta = 0.f;
  auto fetch_stats = [&](int it) {
    const int q0 = (first + it) * QT;
    if (threadIdx.x < QT) {
      const bool in = q0 + threadIdx.x < Tq;
      next_lse = in ? lse[stat0 + q0 + threadIdx.x] : 0.f;
      next_delta = in ? delta[stat0 + q0 + threadIdx.x] : 0.f;
    }
  };
  // the landed stage into the planes (visible to wgmma), then a barrier
  auto convert = [&]() {
    split_tile_sw<D>(Qh, Ql, Qraw);
    split_tile_sw<D>(Dh, Dl, Draw);
    if (threadIdx.x < QT) {
      lse_s[threadIdx.x] = next_lse;
      delta_s[threadIdx.x] = next_delta;
    }
    sm90::fence_async_smem();
    __syncthreads();
  };

  load_rows<OWN, D, true>(Ks, k + koff, k0, Tkv, stride);
  load_rows<OWN, D, true>(Vs, v + koff, k0, Tkv, stride);
  if (n_tiles > 0) {  // k, v and query tile 0 in one group
    load_rows<QT, D, false>(Qraw, q + qoff, first * QT, Tq, stride);
    load_rows<QT, D, false>(Draw, dout + qoff, first * QT, Tq, stride);
    fetch_stats(0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (n_tiles > 0) convert();

  // warpgroup 0: s^T = k . q^T; warpgroup 1: dp^T = v . dO^T
  const float* a_tile = dk_warp ? Vs : Ks;
  const uint32_t b_tile = sm90::smem_u32(dk_warp ? Dh : Qh);
  float acc[NO][4];  // dv, or dk unscaled
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (first + it) * QT;
    const bool more = it + 1 < n_tiles;
    if (more) {  // the next tile's dO, under this tile's products
      load_rows<QT, D, false>(Draw, dout + qoff, q0 + QT, Tq, stride);
      cp_async_commit();
      fetch_stats(it + 1);
    }
    float sd[NS][4];
    wgmma_abt<D, 2, 2>(sd, a_tile, m0, b_tile);
    // a pair whose keys all lie after the tile's queries (causal), or past
    // Tkv, has p^T = 0 there: it skips the rest
    const bool active = kw < Tkv && !(causal && kw > q0 + QT - 1);
    if (!dk_warp) {
      if (active) {
        // p^T = exp(s^T - lse): rows are keys, columns queries
        const bool interior = q0 + QT <= Tq && warp_keep && (!causal || kw + 15 <= q0);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * nt + 2 * c + (e & 1);
            float x = sd[nt][e] * scale;
            if (!interior) {
              x = masked(x, q0 + col, kr[e >> 1], Tq, Tkv, causal, keep[e >> 1]);
            }
            sd[nt][e] = expf(x - lse_s[col]);
          }
        }
        put_frags(xp, sd);
        sm90::named_arrive(1 + grp, 64);
        gemm_pb_sw<NS, NO>(acc, sd, Dh, Dl, 0);
      }
    } else {
      if (active) {
        float p[NS][4];
        sm90::named_sync(1 + grp, 64);
        get_frags(p, xp);
        // ds^T = p^T (dp^T - delta)
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sd[nt][e] = p[nt][e] * (sd[nt][e] - delta_s[8 * nt + 2 * c + (e & 1)]);
          }
        }
      }
      // every dk warp has read its p^T: the q stage takes the next tile
      sm90::named_sync(1 + kGroups, 32 * kGroups);
      if (more) {
        load_rows_by<QT, D, 32 * kGroups>(Qraw, q + qoff, q0 + QT, Tq, stride,
                                          threadIdx.x - 32 * kGroups);
        cp_async_commit();
      }
      if (active) gemm_pb_sw<NS, NO>(acc, sd, Qh, Ql, 0);
    }
    if (more) {
      cp_async_wait_all();
      __syncthreads();  // the planes are read and the next stage has landed
      convert();
    }
  }

  float* out = dk_warp ? dk : dv;
  const float f = dk_warp ? scale : 1.f;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kr[i] < Tkv) {
        const int64_t row = koff + kr[i] * stride + 8 * nt + 2 * c;
        put2(out + row, f * acc[nt][2 * i], f * acc[nt][2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------ fp32 forward at D = 256 (TF32)
//
// `flash_fwd_kernel_tf32_d256`: o (and lse) for 64 query rows of one
// head. Two warpgroups: warpgroup 0 (the consumer) computes, warpgroup 1
// (the producer) only loads and splits the streamed key tiles. Its
// design answers what held back the 128-row kernel it replaces (the D
// 256 instantiation of `flash_fwd_kernel_tf32`: one wave of 128 blocks at
// [2, 1024, 8, 256], q re-split for every key tile, a block-wide barrier
// and split every 16 keys, every product on mma.sync from scalar loads):
//   * 64 own rows, one block a (head, batch, row tile) on a 1-D grid whose
//     slowest index is the row tile, the longest causal tiles first: 256
//     blocks at that shape, two waves on 132 SMs, so a causal run takes
//     about the work it does (the sum of the blocks' tiles over the SMs),
//     not the longest block's time.
//   * q is split once a block into hi and lo planes (128 KB), read by
//     wgmma straight from shared memory (A K-major under the 128-byte
//     swizzle): s = q . k^T is, a k-step of 8 columns, hi . [hi | lo]
//     (m64n32k8: hi.hi and hi.lo side by side) and lo . hi (m64n16k8) over
//     a key tile's planes laid as the D 256 backward lays them (`sw_off`:
//     each box's 16 hi rows, then its 16 lo rows), summed (lo.hi + hi.lo)
//     + hi.hi as the backward's `wgmma_abt` does. (A second accumulator
//     set ran no faster; A from registers, loaded from planes laid as the
//     fragments, ran slower than A from shared memory.)
//   * p . v contracts over keys, so v's planes are written transposed:
//     256 rows (d) of the tile's 16 keys, 64 bytes a row under the 64-byte
//     swizzle, the keys of each 8 in `frag_c2a`'s order (0, 2, 4, 6, 1, 3,
//     5, 7). o += p . v then runs on wgmma too: A is p's C fragment split
//     in registers, B each plane K-major, o the two m64n128 halves of one
//     accumulator, each k-step lo.hi, hi.lo, hi.hi into it (the order of
//     `mma3`).
//   * The producer's two groups of 64 threads take the key tiles in
//     turns: a group loads its tile's k and v rows from global memory
//     into registers two tiles ahead, splits them once, writes the planes
//     and arrives on the planes' "full" mbarrier; the consumer arrives on
//     the "empty" one once its products have read them (v's by the tile's
//     parity, so that each group waits on every phase of one barrier).
//     Shared memory, from a 1024-byte boundary: q's planes 131,072 bytes,
//     two k slots (hi and lo boxes, 32,768 bytes each), one v slot (two
//     transposed planes, 32,768 bytes), keep flags and barriers: 229,560
//     bytes, 230,584 with the alignment slack, of the 232,448 a block may
//     have. So a k tile is written while the tile before it is used, and
//     v's one slot while the next tile's s runs (a second v slot or a
//     32-key tile does not fit).
//   * The consumer issues tile j's s and then tile j - 1's p . v, runs tile
//     j's softmax while p . v runs, and only its rescale of o waits for it
//     (the first tile peeled: no wgmma sits under a condition, C7520; s j
//     + 1 issued before that rescale got the wgmmas serialised, C7514).
//   * The block's registers: 256 threads at up to 255 each (o is 128 a
//     consumer thread), so no `setmaxnreg`.
//   * Measured (PERF.md §6): a two-consumer version (each warpgroup
//     half of D, q's hi parts in registers, partial s handed over, raw
//     tiles staged by bulk copies) ran slower; its producer alone took as
//     long as the whole of this kernel.
namespace tf32 {

struct FwdWide {
  static constexpr int kRows = 64, kKeys = 16, D = 256;
  uint32_t qh[kRows * D], ql[kRows * D];   // D / 32 boxes of [64][32] words
  uint32_t k[2][kSwPlanes];                // two key tiles' planes
  uint32_t vh[D * kKeys], vl[D * kKeys];   // one value tile's, transposed
  int keep[2][kKeys];                      // the k slots' keep flags
  // empty_v by the parity of the tile whose v was read: each producer
  // group waits on one of them, phase after phase
  uint64_t full_k[2], empty_k[2], full_v, empty_v[2];
};
static_assert(sizeof(FwdWide) + 1024 <= 232448, "one block's shared memory");

// (row r, column col)'s word in a plane of q: box col / 32 of 64 rows of
// 128 bytes, the 16-byte chunks of row r permuted by chunk ^ (r % 8)
__device__ __forceinline__ int q_off(int r, int col) {
  return (col >> 5) * (FwdWide::kRows * 32) + r * 32 +
         ((((col & 31) >> 2) ^ (r & 7)) << 2) + (col & 3);
}

// the word of chunk `ch` (keys 4ch .. 4ch + 3 of the permuted order) of
// row d of a transposed value plane: rows of 64 bytes, chunk ^ ((d / 2) % 4)
__device__ __forceinline__ int vt_off(int d, int ch) {
  return d * FwdWide::kKeys + ((ch ^ ((d >> 1) & 3)) << 2);
}

}  // namespace tf32

__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_fwd_kernel_tf32_d256(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ pad,
                           float* __restrict__ o, float* __restrict__ lse, int B,
                           int Tq, int Tkv, int H, int causal, float scale) {
  using namespace tf32;
  using F = FwdWide;
  constexpr int D = F::D, QR = F::kRows, KT = F::kKeys, NS = KT / 8;
  static_assert(kThreads == 256, "a consumer and a producer warpgroup");
  F& sm = *reinterpret_cast<F*>(wide_smem());

  const int n_q = (Tq + QR - 1) / QR;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int tile = blockIdx.x / (H * B);
  const int q0 = (causal ? n_q - 1 - tile : tile) * QR;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * Tq * stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * Tkv * stride + h * D;
  const int n_kv = (Tkv + KT - 1) / KT;
  const int n_tiles = causal ? min(n_kv, min(q0 + QR - 1, Tq - 1) / KT + 1) : n_kv;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&sm.full_k[s], 64);  // the tile's producer group
      sm90::mbar_init(&sm.empty_k[s], 128);
    }
    sm90::mbar_init(&sm.full_v, 64);
    sm90::mbar_init(&sm.empty_v[0], 128);
    sm90::mbar_init(&sm.empty_v[1], 128);
    sm90::fence_barrier_init();
  }
  // q's rows into their planes, split once for the block by every thread
  for (int i = tid; i < QR * D / 4; i += kThreads) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    const float4 x4 =
        q0 + r < Tq
            ? __ldg(reinterpret_cast<const float4*>(q + qoff + (q0 + r) * stride + col))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    uint32_t hi[4], lo[4];
    split(x, hi, lo);
    const int off = q_off(r, col);
    *reinterpret_cast<uint4*>(sm.qh + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(sm.ql + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  sm90::fence_async_smem();
  __syncthreads();

  if (tid >= 128) {  // ---------------------------------------- producer
    // two groups of 64 threads take the key tiles in turns, tile j going
    // to group j % 2: each group's loads of its next tile are issued after
    // its stores and land over two tiles of the consumer's work (the proxy
    // fence before each arrive waits for every load of its own in flight)
    const int t = tid - 128, gp = t >> 6, u = t & 63;
    // a key tile's k rows (thread u: the 16-byte chunk u of each of the 16
    // rows) and its keep flag (u < KT); its v values in columns u + 64x
    float4 kx[KT];
    bool kp = true;
    float vx[4][KT];
    auto load_k = [&](int j) {
      const int k0 = j * KT;
#pragma unroll
      for (int r = 0; r < KT; ++r) {
        kx[r] = k0 + r < Tkv
                    ? __ldg(reinterpret_cast<const float4*>(kb + (k0 + r) * stride + 4 * u))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (u < KT) {
        const int key = k0 + u;
        kp = key < Tkv && (pad == nullptr || pad[static_cast<int64_t>(b) * Tkv + key] != 0);
      }
    };
    auto store_k = [&](int s) {
      uint32_t* hi = sm.k[s];
#pragma unroll
      for (int r = 0; r < KT; ++r) put_split_sw(hi, hi + kSwLo, r, 4 * u, kx[r]);
      if (u < KT) sm.keep[s][u] = kp;
      sm90::fence_async_smem();
      sm90::mbar_arrive(&sm.full_k[s]);
    };
    auto load_v = [&](int j) {
      const int k0 = j * KT;
#pragma unroll
      for (int key = 0; key < KT; ++key) {
        const bool in = k0 + key < Tkv;
        const float* row = vb + (k0 + key) * stride + u;
#pragma unroll
        for (int x = 0; x < 4; ++x) vx[x][key] = in ? __ldg(row + 64 * x) : 0.f;
      }
    };
    auto store_v = [&]() {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = u + 64 * x;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const int key0 = 8 * (ch >> 1) + (ch & 1);  // keys key0 + 0, 2, 4, 6
          const float y[4] = {vx[x][key0], vx[x][key0 + 2], vx[x][key0 + 4],
                              vx[x][key0 + 6]};
          uint32_t hi[4], lo[4];
          split(y, hi, lo);
          const int off = vt_off(d, ch);
          *reinterpret_cast<uint4*>(sm.vh + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(sm.vl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      sm90::fence_async_smem();
      sm90::mbar_arrive(&sm.full_v);
    };

    // group gp: k gp into its slot; then, at each of its tiles j, v j into
    // the v slot once v j - 1 is read and k j + 2 into k j's slot once k j
    // is read, then the loads of v j + 2 and k j + 4
    if (gp < n_tiles) {
      load_k(gp);
      store_k(gp);
      load_v(gp);
      if (gp + 2 < n_tiles) load_k(gp + 2);
    }
#pragma unroll 1
    for (int j = gp; j < n_tiles; j += 2) {
      if (j > 0) sm90::mbar_wait(&sm.empty_v[(j - 1) & 1], ((j - 1) >> 1) & 1);
      store_v();
      if (j + 2 < n_tiles) {
        sm90::mbar_wait(&sm.empty_k[j & 1], (j >> 1) & 1);
        store_k(j & 1);
      }
      if (j + 2 < n_tiles) load_v(j + 2);
      if (j + 4 < n_tiles) load_k(j + 4);
    }
  } else {  // ------------------------------------------------ consumer
    const int warp = tid >> 5, lane = tid & 31, c = lane & 3;
    const int qw = q0 + 16 * warp;  // the warp's first query row
    const int rows[2] = {qw + (lane >> 2), qw + (lane >> 2) + 8};
    // the operands' descriptors at their first k-step; the one `off`
    // bytes on adds off / 16 to the start address, its low 14 bits (every
    // operand lies below 256 KB). Each tile takes them through an empty
    // asm, so that the 104 descriptors of a tile are formed there and not
    // hoisted out of the loop into registers.
    const uint64_t dq_hi = sm90::desc_sw128(sm90::smem_u32(sm.qh), 16, 1024);
    const uint64_t dq_lo = sm90::desc_sw128(sm90::smem_u32(sm.ql), 16, 1024);
    const uint64_t dk0 = sm90::desc_sw128(sm90::smem_u32(sm.k[0]), 16, 1024);
    const uint64_t dk1 = sm90::desc_sw128(sm90::smem_u32(sm.k[1]), 16, 1024);
    const uint64_t dv_hi = sm90::desc_sw<64>(sm90::smem_u32(sm.vh), 16, 512);
    const uint64_t dv_lo = sm90::desc_sw<64>(sm90::smem_u32(sm.vl), 16, 512);

    float acc[2 * 64];  // o: two m64n128 halves (columns 0-127, 128-255)
#pragma unroll
    for (int i = 0; i < 2 * 64; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float hb[16], lh[8];            // s's hi.hi then hi.lo; its lo.hi
    float p[NS][4];                 // a tile's s, then p
    uint32_t pa[NS][4], pl[NS][4];  // p's hi and lo A fragments
    int keep[4];                    // the keep flags of this thread's columns
    bool all_keep = true;

    // this thread's keep flags of the tile in slot s, and whether the
    // warp's (every key of the tile's) are all set
    auto read_keep = [&](int s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) keep[i] = sm.keep[s][8 * (i >> 1) + 2 * c + (i & 1)];
      all_keep = __all_sync(0xffffffffu, keep[0] && keep[1] && keep[2] && keep[3]);
    };
    // s = q . k^T over the k slot s, issued as one group
    auto issue_s = [&](int s) {
#pragma unroll
      for (int i = 0; i < 16; ++i) hb[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) lh[i] = 0.f;
      uint64_t ah = dq_hi, al = dq_lo, bk = s ? dk1 : dk0;
      asm volatile("" : "+l"(ah), "+l"(al), "+l"(bk));
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qk = ((kk >> 2) * (4 * QR * 32) + (kk & 3) * 32) >> 4;
        const uint64_t db = bk + (((kk >> 2) * (4 * kSwBox) + (kk & 3) * 32) >> 4);
        sm90::wgmma_m64n32k8_tf32_ss(hb, ah + qk, db);
        sm90::wgmma_m64n16k8_tf32_ss(lh, al + qk, db);
      }
      sm90::wgmma_commit();
    };
    // o += p . v over the v slot, issued as one group: per k-step of 8
    // keys and per half of D, lo.hi, hi.lo, hi.hi (`mma3`'s order)
    auto issue_pv = [&]() {
      uint64_t bh = dv_hi, bl = dv_lo;
      asm volatile("" : "+l"(bh), "+l"(bl));
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NS; ++ks) {
        uint64_t dh[2], dl[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint32_t off = (x * (128 * 4 * KT) + ks * 32) >> 4;
          dh[x] = bh + off;
          dl[x] = bl + off;
        }
        float(&o0)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
        float(&o1)[64] = *reinterpret_cast<float(*)[64]>(&acc[64]);
        sm90::wgmma_m64n128k8_tf32_rs(o0, pl[ks], dh[0]);
        sm90::wgmma_m64n128k8_tf32_rs(o1, pl[ks], dh[1]);
        sm90::wgmma_m64n128k8_tf32_rs(o0, pa[ks], dl[0]);
        sm90::wgmma_m64n128k8_tf32_rs(o1, pa[ks], dl[1]);
        sm90::wgmma_m64n128k8_tf32_rs(o0, pa[ks], dh[0]);
        sm90::wgmma_m64n128k8_tf32_rs(o1, pa[ks], dh[1]);
      }
      sm90::wgmma_commit();
    };
    // the completed s into p: (lo.hi + hi.lo) + hi.hi
    auto gather_s = [&]() {
      sm90::fence_regs(hb);
      sm90::fence_regs(lh);
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i >> 2][i & 3] = (lh[i] + hb[8 + i]) + hb[i];
    };
    // tile j's softmax against the running max: p, alpha, m and l
    auto softmax = [&](int j) {
      const int k0 = j * KT;
      const bool interior = k0 + KT <= Tkv && all_keep && qw + 15 < Tq &&
                            (!causal || k0 + KT - 1 <= qw);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * c + (e & 1);
          float x = p[nt][e] * scale;
          if (!interior) {
            x = masked(x, rows[e >> 1], k0 + col, Tq, Tkv, causal, keep[2 * nt + (e & 1)]);
          }
          p[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nt][e] = expf(p[nt][e] - m[e >> 1]);
          sum[e >> 1] += p[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
    };
    // p into the A fragments of o += p . v
    auto split_p = [&]() {
#pragma unroll
      for (int ks = 0; ks < NS; ++ks) {
        const FragA f = frag_c2a(p[ks]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[ks][e] = f.hi[e];
          pl[ks][e] = f.lo[e];
        }
      }
    };

    // tile 0: s alone
    sm90::mbar_wait(&sm.full_k[0], 0);
    read_keep(0);
    issue_s(0);
    sm90::wgmma_wait<0>();
    gather_s();
    sm90::mbar_arrive(&sm.empty_k[0]);
    softmax(0);
    split_p();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j & 1;
      sm90::mbar_wait(&sm.full_k[s], (j >> 1) & 1);
      read_keep(s);
      issue_s(s);
      sm90::mbar_wait(&sm.full_v, (j - 1) & 1);
      issue_pv();  // tile j - 1's
      sm90::wgmma_wait<1>();  // s is done
      gather_s();
      sm90::mbar_arrive(&sm.empty_k[s]);
      softmax(j);
      sm90::wgmma_wait<0>();  // p . v is done
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::fence_regs(pl);
      sm90::mbar_arrive(&sm.empty_v[(j - 1) & 1]);
      // o *= alpha, skipped where no row of the warp's max moved (x 1 is
      // exact, so the bits are those of the multiply)
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < 2 * 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      split_p();
    }
    sm90::mbar_wait(&sm.full_v, (n_tiles - 1) & 1);
    issue_pv();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    sm90::fence_regs(pl);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = fmaxf(l[i], 1e-30f);
      if (lse != nullptr && c == 0 && rows[i] < Tq) {
        lse[(static_cast<int64_t>(b) * H + h) * Tq + rows[i]] = m[i] + logf(l[i]);
      }
    }
    float* ob = o + qoff;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] < Tq) {
          put2(ob + rows[i] * stride + 8 * nt + 2 * c, acc[4 * nt + 2 * i] / l[i],
               acc[4 * nt + 2 * i + 1] / l[i]);
        }
      }
    }
  }
}

// ----------------------------------------------------------- launchers

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *pad, *dout, *o, *lse_in;
  void *delta;  // written by the dq kernels (from dout and o), read by dk/dv
  void *out_o, *lse, *dq, *dk, *dv;
  int B, Tq, Tkv, H;
  int W;  // the tensors' head width: D, or below it for the Hopper kernels
  int causal;
  float scale;
};

// the forward, dq and dk/dv kernels of the split-TF32 family at D, and
// their dynamic shared memory
template <int D>
constexpr size_t tf32_fwd_smem() {
  if constexpr (D == 256) return sizeof(tf32::FwdWide) + 1024;
  else return tf32::fwd_smem<D>();
}
template <int D>
inline auto tf32_fwd() {
  if constexpr (D == 256) return flash_fwd_kernel_tf32_d256;
  else return flash_fwd_kernel_tf32<D>;
}
template <int D>
constexpr size_t tf32_dq_smem() {
  if constexpr (D == 256) return tf32::Wide::dq_bytes;
  else return tf32::dq_smem<D>();
}
template <int D>
constexpr size_t tf32_dkv_smem() {
  if constexpr (D == 256) return tf32::Wide::dkv_bytes;
  else return tf32::dkv_smem<D>();
}
template <int D>
inline auto tf32_dq() {
  if constexpr (D == 256) return flash_dq_kernel_tf32_d256;
  else return flash_dq_kernel_tf32<D>;
}
template <int D>
inline auto tf32_dkv() {
  if constexpr (D == 256) return flash_dkv_kernel_tf32_d256;
  else return flash_dkv_kernel_tf32<D>;
}

// the split-TF32 kernels (fp32): grids of (head, row tile, batch), the
// forward's tiles 128 rows, the backward's `tf32::bwd_rows`; at D 256 the
// forward's 64-row tiles on a 1-D grid, the row tile its slowest index
template <int D>
cudaError_t run_tf32(int which, const Args& a, cudaStream_t s) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int* pad = static_cast<const int*>(a.pad);
  constexpr int kBwd = tf32::bwd_rows<D>();
  const int n_q = (a.Tq + (which == 0 ? tf32::kRows : kBwd) - 1) /
                  (which == 0 ? tf32::kRows : kBwd);
  const int n_kv = (a.Tkv + kBwd - 1) / kBwd;
  if (which == 0) {
    if constexpr (D == 256) {
      constexpr int R = tf32::FwdWide::kRows;
      const int64_t blocks = static_cast<int64_t>(a.H) * a.B * ((a.Tq + R - 1) / R);
      if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
      return launch(tf32_fwd<D>(), dim3(static_cast<unsigned>(blocks)),
                    tf32::kThreads, tf32_fwd_smem<D>(), s, q, k, v, pad,
                    static_cast<float*>(a.out_o), static_cast<float*>(a.lse), a.B,
                    a.Tq, a.Tkv, a.H, a.causal, a.scale);
    } else {
      return launch(tf32_fwd<D>(), dim3(a.H, n_q, a.B), tf32::kThreads,
                    tf32_fwd_smem<D>(), s, q, k, v, pad,
                    static_cast<float*>(a.out_o), static_cast<float*>(a.lse), a.Tq,
                    a.Tkv, a.H, a.causal, a.scale);
    }
  }
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse_in);
  if (which == 1) {
    return launch(tf32_dq<D>(), dim3(a.H, n_q, a.B), tf32::kThreads,
                  tf32_dq_smem<D>(), s, q, k, v, pad, dout,
                  static_cast<const float*>(a.o), lse, static_cast<float*>(a.delta),
                  static_cast<float*>(a.dq), a.Tq, a.Tkv, a.H, a.causal, a.scale);
  }
  return launch(tf32_dkv<D>(), dim3(a.H, n_kv, a.B), tf32::kThreads,
                tf32_dkv_smem<D>(), s, q, k, v, pad, dout, lse,
                static_cast<const float*>(a.delta), static_cast<float*>(a.dk),
                static_cast<float*>(a.dv), a.Tq, a.Tkv, a.H, a.causal, a.scale);
}

// the Hopper kernels (bf16, D 64, 80, 96, 128 and 256): the tensor maps are
// encoded on the host at every launch, at the tensors' own width W, and
// passed by value
template <int D>
cudaError_t run_sm90(int which, const Args& a, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  wgp::Narrow<D> nm{};
  cudaError_t e;
  // the block's own rows come in 64-row boxes, the streamed side's in
  // boxes of its tile's rows: 128 keys in the forward, R rows (q and dO
  // for dk/dv, k and v for dq) in the backward; at D 256 64 rows in all
  constexpr int R = wgp::Ring<D>::kBwdRows;
  constexpr bool kWide = D == 256;
  const int q_rows = which == 2 && !kWide ? R : 64;
  const int kv_rows = which == 0 ? (kWide ? wgp::kWideKeys : wgp::kFwdKeys)
                      : which == 1 ? R : 64;
  const int W = a.W;
  if ((e = sm90::bthd_map(&mq, a.q, a.B, a.Tq, a.H, W, q_rows)) != cudaSuccess ||
      (e = sm90::bthd_map(&mk, a.k, a.B, a.Tkv, a.H, W, kv_rows)) != cudaSuccess ||
      (e = sm90::bthd_map(&mv, a.v, a.B, a.Tkv, a.H, W, kv_rows)) != cudaSuccess) {
    return e;
  }
  if constexpr (D % 64 != 0) {  // the narrow box's maps
    constexpr int kCols = D % 64;
    if ((e = sm90::bthd_map(&nm.m[wgp::kMapQ], a.q, a.B, a.Tq, a.H, W, q_rows,
                            kCols)) != cudaSuccess ||
        (e = sm90::bthd_map(&nm.m[wgp::kMapK], a.k, a.B, a.Tkv, a.H, W,
                            kv_rows, kCols)) != cudaSuccess ||
        (e = sm90::bthd_map(&nm.m[wgp::kMapV], a.v, a.B, a.Tkv, a.H, W,
                            kv_rows, kCols)) != cudaSuccess ||
        (which != 0 &&
         (e = sm90::bthd_map(&nm.m[wgp::kMapDo], a.dout, a.B, a.Tq, a.H, W,
                             q_rows, kCols)) != cudaSuccess)) {
      return e;
    }
  }
  const int* pad = static_cast<const int*>(a.pad);
  if (which == 0) {
    if constexpr (kWide) {
      return launch(W == D ? flash_fwd_kernel_sm90_d256<true>
                           : flash_fwd_kernel_sm90_d256<false>,
                    dim3(a.H, (a.Tq + 127) / 128, a.B), wgp::kThreads,
                    sizeof(wgp::FwdSmemWide) + 1024, s, mq, mk, mv, pad,
                    static_cast<bf16*>(a.out_o), static_cast<float*>(a.lse),
                    a.Tq, a.Tkv, a.H, W, a.causal, a.scale);
    } else {
      return launch(flash_fwd_kernel_sm90<D>, dim3(a.H, (a.Tq + 127) / 128, a.B),
                    wgp::kThreads, sizeof(wgp::FwdSmem<D>) + 1024, s, mq, mk,
                    mv, nm, pad, static_cast<bf16*>(a.out_o),
                    static_cast<float*>(a.lse), a.Tq, a.Tkv, a.H, W, a.causal,
                    a.scale);
    }
  }
  if ((e = sm90::bthd_map(&mdo, a.dout, a.B, a.Tq, a.H, W, q_rows)) != cudaSuccess) {
    return e;
  }
  const float* lse = static_cast<const float*>(a.lse_in);
  if (which == 1) {
    if constexpr (kWide) {
      return launch(flash_dq_kernel_sm90_d256, dim3(a.H, (a.Tq + 127) / 128, a.B),
                    wgp::kThreads, sizeof(wgp::DqSmemWide) + 1024, s, mq, mk,
                    mv, mdo, static_cast<const bf16*>(a.o), pad, lse,
                    static_cast<float*>(a.delta), static_cast<bf16*>(a.dq),
                    a.Tq, a.Tkv, a.H, W, a.causal, a.scale);
    } else {
      return launch(flash_dq_kernel_sm90<D>, dim3(a.H, (a.Tq + 127) / 128, a.B),
                    wgp::kThreads, sizeof(wgp::DqSmem<D>) + 1024, s, mq, mk, mv,
                    mdo, nm, static_cast<const bf16*>(a.o), pad, lse,
                    static_cast<float*>(a.delta), static_cast<bf16*>(a.dq), a.Tq,
                    a.Tkv, a.H, W, a.causal, a.scale);
    }
  }
  if constexpr (kWide) {
    return launch(flash_dkv_kernel_sm90_d256, dim3(a.H, (a.Tkv + 63) / 64, a.B),
                  wgp::kThreads, sizeof(wgp::DkvSmemWide) + 1024, s, mq, mk, mv,
                  mdo, pad, lse, static_cast<const float*>(a.delta),
                  static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Tq,
                  a.Tkv, a.H, W, a.causal, a.scale);
  } else {
    return launch(flash_dkv_kernel_sm90<D>, dim3(a.H, (a.Tkv + 127) / 128, a.B),
                  wgp::kThreads, sizeof(wgp::DkvSmem<D>) + 1024, s, mq, mk, mv,
                  mdo, nm, pad, lse, static_cast<const float*>(a.delta),
                  static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Tq,
                  a.Tkv, a.H, W, a.causal, a.scale);
  }
}

// bf16 at D 64, 80, 96, 128 and 256 takes the Hopper kernels, at any width
// W <= D that is a multiple of 8; fp32 at D 32, 64, 128 and 256 the
// split-TF32 ones, whose tensors are D wide (W = D)
int dispatch(int which, int D, int dtype, const Args& a, void* stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tkv <= 0 || a.H <= 0) return 0;
  // the dq kernels compute delta from dout and o
  if (which == 1 && a.o == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (a.W != D) return static_cast<int>(e);
    if (D == 32) e = run_tf32<32>(which, a, s);
    if (D == 64) e = run_tf32<64>(which, a, s);
    if (D == 128) e = run_tf32<128>(which, a, s);
    if (D == 256) e = run_tf32<256>(which, a, s);
  } else if (dtype == 1) {
    if (a.W <= 0 || a.W > D || a.W % 8 != 0) return static_cast<int>(e);
    if (D == 64) e = run_sm90<64>(which, a, s);
    if (D == 80) e = run_sm90<80>(which, a, s);
    if (D == 96) e = run_sm90<96>(which, a, s);
    if (D == 128) e = run_sm90<128>(which, a, s);
    if (D == 256) e = run_sm90<256>(which, a, s);
  }
  return static_cast<int>(e);
}

// the kernel `which` launches at width W, and its dynamic shared memory
template <int D>
void kernel_of_sm90(int which, int /*W*/, const void** fn, size_t* smem) {
  *smem = (which == 0   ? sizeof(wgp::FwdSmem<D>)
           : which == 1 ? sizeof(wgp::DqSmem<D>)
                        : sizeof(wgp::DkvSmem<D>)) + 1024;
  *fn = which == 0   ? reinterpret_cast<const void*>(flash_fwd_kernel_sm90<D>)
        : which == 1 ? reinterpret_cast<const void*>(flash_dq_kernel_sm90<D>)
                     : reinterpret_cast<const void*>(flash_dkv_kernel_sm90<D>);
}

template <>
void kernel_of_sm90<256>(int which, int W, const void** fn, size_t* smem) {
  *smem = (which == 0   ? sizeof(wgp::FwdSmemWide)
           : which == 1 ? sizeof(wgp::DqSmemWide)
                        : sizeof(wgp::DkvSmemWide)) + 1024;
  *fn = which == 0   ? (W == 256 ? reinterpret_cast<const void*>(
                                        flash_fwd_kernel_sm90_d256<true>)
                                  : reinterpret_cast<const void*>(
                                        flash_fwd_kernel_sm90_d256<false>))
        : which == 1 ? reinterpret_cast<const void*>(flash_dq_kernel_sm90_d256)
                     : reinterpret_cast<const void*>(flash_dkv_kernel_sm90_d256);
}

template <int D>
void kernel_of_tf32(int which, const void** fn, size_t* smem) {
  *smem = which == 0   ? tf32_fwd_smem<D>()
          : which == 1 ? tf32_dq_smem<D>()
                       : tf32_dkv_smem<D>();
  *fn = which == 0   ? reinterpret_cast<const void*>(tf32_fwd<D>())
        : which == 1 ? reinterpret_cast<const void*>(tf32_dq<D>())
                     : reinterpret_cast<const void*>(tf32_dkv<D>());
}

}  // namespace

// Every tensor is contiguous: q, o, dq [B, Tq, H, W]; k, v, dk, dv
// [B, Tkv, H, W], all in dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned; pad [B, Tkv] int32 or null; lse, delta [B, H, Tq] float32. D,
// the kernel's head dim, is 32, 64, 128 or 256 in float32 (W = D), 64, 80,
// 96, 128 or 256 in bfloat16 (W <= D, a multiple of 8: the kernel reads
// the columns past W as zeros and writes none of them). `lse` may be null
// (no gradient will be taken).

extern "C" int hyperion_flash_fwd(const void* q, const void* k, const void* v,
                                  const void* pad, void* o, void* lse, int B,
                                  int Tq, int Tkv, int H, int D, int W,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  Args a{q, k, v, pad, nullptr, nullptr, nullptr, nullptr, o, lse, nullptr,
         nullptr, nullptr, B, Tq, Tkv, H, W, causal, scale};
  return dispatch(0, D, dtype, a, stream);
}

// The dq kernel computes delta = sum(dO * O) from `dout` and `o` and
// writes it to `delta` for the dk/dv launch.
extern "C" int hyperion_flash_dq(const void* q, const void* k, const void* v,
                                 const void* pad, const void* dout,
                                 const void* o, const void* lse, void* delta,
                                 void* dq, int B, int Tq, int Tkv, int H,
                                 int D, int W, int causal, float scale,
                                 int dtype, void* stream) {
  Args a{q, k, v, pad, dout, o, lse, delta, nullptr, nullptr, dq, nullptr,
         nullptr, B, Tq, Tkv, H, W, causal, scale};
  return dispatch(1, D, dtype, a, stream);
}

extern "C" int hyperion_flash_dkv(const void* q, const void* k, const void* v,
                                  const void* pad, const void* dout,
                                  const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int Tq, int Tkv, int H,
                                  int D, int W, int causal, float scale,
                                  int dtype, void* stream) {
  Args a{q, k, v, pad, dout, nullptr, lse, const_cast<void*>(delta), nullptr,
         nullptr, nullptr, dk, dv, B, Tq, Tkv, H, W, causal, scale};
  return dispatch(2, D, dtype, a, stream);
}

// What the compiler gave the kernel that `which` (0 forward, 1 dq, 2 dk/dv)
// launches at this D, width W and dtype: out = {registers a thread,
// local-memory (spill) bytes a thread, shared memory a block (static +
// dynamic), threads a block}, and in `name` (`cap` bytes, cut there) the
// launched function's signature as the runtime names it, demangled.
extern "C" int hyperion_flash_attrs(int which, int D, int W, int dtype,
                                    int* out, char* name, int cap) {
  const void* fn = nullptr;
  size_t smem = 0;
  int threads = 0;
  if (dtype == 0) {
    threads = tf32::kThreads;
    if (D == 32) kernel_of_tf32<32>(which, &fn, &smem);
    if (D == 64) kernel_of_tf32<64>(which, &fn, &smem);
    if (D == 128) kernel_of_tf32<128>(which, &fn, &smem);
    if (D == 256) kernel_of_tf32<256>(which, &fn, &smem);
  } else if (dtype == 1) {
    threads = wgp::kThreads;
    if (D == 64) kernel_of_sm90<64>(which, W, &fn, &smem);
    if (D == 80) kernel_of_sm90<80>(which, W, &fn, &smem);
    if (D == 96) kernel_of_sm90<96>(which, W, &fn, &smem);
    if (D == 128) kernel_of_sm90<128>(which, W, &fn, &smem);
    if (D == 256) kernel_of_sm90<256>(which, W, &fn, &smem);
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const char* mangled = nullptr;
  if ((e = cudaFuncGetName(&mangled, fn)) != cudaSuccess) return static_cast<int>(e);
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
  out[3] = threads;
  return 0;
}
