// Weight-only int8 inference for Hopper (sm_90a): the per-row symmetric
// quantizer and the int8 x int8 -> int32 product with its dequant
// epilogue, on three paths by the product's M.
//
// Replaces no Pallas kernel. The reference computes these in XLA:
// `quantize_int8` (hyperion_tpu/precision/quant.py:47-62) as fused
// elementwise ops and `int8_matmul` (:69-85) as a `dot_general` into
// int32 with the dequant multiply fused into its output. The port needs
// kernels of its own because the library's int8 product (`torch._int_mm`)
// refuses M <= 16, which is every decode step, and would write the int32
// product to device memory before a separate epilogue read it back.
//
// Every path computes the reference's bits: the amax is a max (no order
// can change it), scale = max(amax, 1e-8) / 127 and q = clip(rint(x /
// scale), -127, 127) as IEEE quotients (computed without a division, which
// is a call on the card: `scale_of`, `rint_quotient`), the sum is exact in
// int32 (any order, so a split over K needs no atomics), and the epilogue is
// (float(acc) * sx[m]) * sw[n] rounded to the output dtype, plus bias[n]
// rounded to that dtype (__fmul_rn/__fadd_rn: no contraction into an FMA).
// wq is [N, K], the port's [out, in] layout: K-major, as both mma.sync's
// "col" operand and wgmma's 8-bit B operand (the only layout wgmma takes
// for 8 bits) want it, so no weight is transposed.
//
//  * "decode_fused" (int8_decode_kernel<fused>, quantized_dense at M <= 16):
//    the float activations x [M, K] in, out [M, N] out, no quantize launch
//    and no int8 copy of x in device memory. Bound: the weight's bytes,
//    and at these sizes the latency of a block's chain of steps. A
//    thread-block cluster of S blocks splits K for 64-column tiles (S = 8,
//    or 4 or 2 where that puts every tile's cluster on the card in one
//    wave: N = 4096 at K = 4096 runs 64 clusters of 4 at once, where 8 left
//    two clusters a second tile). Each block streams its [64, K/S] weight
//    slab through a 4-stage ring of 8 KB TMA boxes (128 bytes of K over 64
//    rows, swizzled), issued by one producer warp from the block's first
//    cycle and freed by mbarriers, no __syncthreads a stage. Meanwhile the
//    4 consumer warps take their slice's amax of each row, push it into
//    every block's shared memory (distributed shared memory, one cluster
//    barrier), quantize their slice into shared memory with the row scales
//    (no division: `rint_quotient`), and run mma.sync.m16n8k32 s8 (M padded
//    to 16 in registers) on each box. A tile's S int32 partials are pushed
//    to the block that finishes their columns (64 / S of them, summed in
//    rank order, the epilogue once an element): one cluster barrier a tile,
//    two buffers by tile parity. Where tiles outnumber the clusters that
//    fit, each cluster walks several (a persistent grid of as many
//    clusters as the occupancy query allows). The weight's tensor map and
//    the launch plan are cached a (weight, shape): a decode step's dense
//    pays one launch.
//  * "decode" (int8_decode_kernel<!fused>, int8_matmul at M <= 16): the same
//    kernel on already quantized xq and sx, each block's slice of xq
//    brought once by TMA. K past 32768 (a slice past 64 KB) takes the
//    prefill kernel.
//  * "prefill_wgmma" (int8_prefill_kernel, M > 16): bound by operations at
//    the 7B's prefill. 128 x 128 output tiles, blocks ordered m-fastest so
//    the blocks in flight share a weight tile and read it from device
//    memory once. One producer thread fills a 4-stage ring of 128-byte
//    K boxes of xq and wq by TMA (128-byte swizzle); two consumer
//    warpgroups (setmaxnreg 240) each run wgmma.m64n128k32.s32.s8.s8 on
//    their 64 rows, one product group in flight while the stage before is
//    handed back. The epilogue dequantises in registers and stores
//    through shared memory in 16-byte rows.
//  * "bytes" (int8_bytes_kernel): operands TMA cannot take (K % 16 != 0,
//    or an operand off the 16-byte grid): a 64 x 128 tile of mma.sync
//    m16n8k32 s8 staged by byte loads.
//  * The quantizer, where the prefill (M > 16) and the weights
//    (`quantize_llama`) still need it: one pass, a block a row, each row
//    read once with 16-byte loads and held in registers, 1 to 4 chunks a
//    thread so that a row takes up to 256 threads (the design of the RMSNorm
//    block kernel; [512, 4096] bf16 is 512 blocks of 256), rows up to 4096
//    chunks (quantize_rows_block_kernel); scalar loads that read the row
//    twice for rows off the 16-byte grid, K not whole chunks or longer rows
//    (quantize_rows_kernel). Bound: bytes. (A warp a row, 16 chunks a lane,
//    ran [512, 4096] on 4 warps an SM and lost to the old kernel.)

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float kEps = 1e-8f;
constexpr int kQuantThreads = 256;       // the scalar quantizer's block
constexpr int kQuantBlockMaxChunks = 4;  // 16-byte chunks a thread (64 registers at 1024)
constexpr int kQuantBlockTarget = 256;   // threads a row, while it fits
constexpr int kDecodeMaxM = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// max(amax, 1e-8) / 127 as the IEEE quotient, with no division (the
// division's slow path is a call, and a call spills): a / 127 lies at least
// 2^-31 (relative) from every float midpoint (a = 127 m would need a
// midpoint's 25 bits times 7 more in 24), the double product within 2^-52
// of it, so rounding that product to float rounds the quotient
__device__ __forceinline__ float scale_of(float amax) {
  return __double2float_rn(__dmul_rn(static_cast<double>(fmaxf(amax, kEps)), 1.0 / 127.0));
}

// an approximate 1 / s (within 2 ulps): all the rounding below needs
__device__ __forceinline__ float recip(float s) { return __fdividef(1.0f, s); }

// rint(v / s) for the IEEE quotient v / s, from r = recip(s) and no
// division. |v| <= amax, so |Q| = |v / s| <= 127.00001, and q = v * r lies
// within 3.9e-5 of Q, RN(Q) within 7.6e-6 of it: farther than kTieBand
// from the nearest half-integer h, q and RN(Q) round to the same integer.
// Within it, t = v - h * s is exact (v and h * s agree to within 2^-11 of
// s, so t needs at most 16 bits) and so is its sign; RN(Q) differs from h
// iff |Q - h| = |t| / s passes half the gap from h to its float neighbour
// on that side (never equal: Q is not a float midpoint, which would need
// v = midpoint * s, odd 25 bits times odd bits, in 24), and then it lies
// on t's side; else RN(Q) = h, rounded half to even. Branch-free: no call.
constexpr float kTieBand = 1.0f / 4096;
__device__ __forceinline__ float rint_quotient(float v, float s, float r) {
  const float q = __fmul_rn(v, r);
  const float fl = floorf(q);
  const float h = __fadd_rn(fl, 0.5f);
  const float t = __fmaf_rn(-h, s, v);
  const float ah = fabsf(h);
  const float ulp = __fmul_rn(__int_as_float(__float_as_int(ah) & 0x7f800000), 0x1p-23f);
  // toward zero from 0.5 the neighbour is half as far
  const bool away = (t > 0.f) == (h > 0.f);
  const float gap = (away || ah != 0.5f) ? __fmul_rn(ulp, 0.5f) : __fmul_rn(ulp, 0.25f);
  const float at_tie =
      fabsf(t) > __fmul_rn(gap, s) ? (t > 0.f ? __fadd_rn(fl, 1.f) : fl) : rintf(h);
  return fabsf(__fsub_rn(q, h)) < kTieBand ? at_tie : rintf(q);
}

// clip(k, -127, 127) as the int8 byte
__device__ __forceinline__ uint32_t to_byte(float k) {
  k = fminf(fmaxf(k, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(k))));
}

__device__ __forceinline__ uint32_t quant_byte(float v, float s, float r) {
  return to_byte(rint_quotient(v, s, r));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of T as 16 / sizeof(T) floats
template <typename T>
struct Chunk {
  static constexpr int kVec = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack_bf16(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack_f16(const uint4& raw, float (&v)[8]) {
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& raw, float (&v)[Chunk<T>::kVec]) {
  if constexpr (sizeof(T) == 4) {
    unpack(raw, v);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    unpack_bf16(raw, v);
  } else {
    unpack_f16(raw, v);
  }
}

template <int N>
__device__ __forceinline__ float chunk_amax(float a, const float (&v)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) a = fmaxf(a, fabsf(v[e]));
  return a;
}

// the N (4 or 8) int8 values of one chunk at dst (4- or 8-byte aligned)
template <int N>
__device__ __forceinline__ void store_q(uint8_t* dst, const float (&v)[N], float s, float r) {
  uint32_t w[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    w[i] = quant_byte(v[4 * i], s, r) | (quant_byte(v[4 * i + 1], s, r) << 8) |
           (quant_byte(v[4 * i + 2], s, r) << 16) | (quant_byte(v[4 * i + 3], s, r) << 24);
  }
  if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ------------------------------------------------------------ quantizer

// Any K and alignment: a block a row, scalar loads, the row read twice
// (the second time from L1/L2).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int K) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kQuantThreads) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = warp_max(amax);
  __shared__ float red[kQuantThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = scale_of(amax), r = recip(s);
  if (threadIdx.x == 0) scale[row] = s;
  int8_t* qr = q + row * K;
  for (int i = threadIdx.x; i < K; i += kQuantThreads) {
    qr[i] = static_cast<int8_t>(quant_byte(to_f32(xr[i]), s, r));
  }
}

// A block a row: thread t holds the row's chunks t, t + blockDim.x, ...
// (at most kChunks) in registers; the warps' maxima meet in shared memory
// behind one barrier.
template <typename T, int kChunks>
__global__ void __launch_bounds__(1024)
quantize_rows_block_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                           float* __restrict__ scale, int K) {
  constexpr int kVec = Chunk<T>::kVec;
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int n = K / kVec;
  const T* xr = x + row * K;
  uint4 raw[kChunks];  // chunks past the row stay zero
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = threadIdx.x + i * blockDim.x;
    raw[i] = ch < n ? ldg16(xr + ch * kVec) : make_uint4(0, 0, 0, 0);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    float v[kVec];
    unpack_chunk<T>(raw[i], v);
    amax = chunk_amax(amax, v);
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = 0.f;
  for (int w = 0; w < (blockDim.x >> 5); ++w) amax = fmaxf(amax, red[w]);
  const float s = scale_of(amax), r = recip(s);
  if (threadIdx.x == 0) scale[row] = s;
  uint8_t* qr = reinterpret_cast<uint8_t*>(q) + row * K;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = threadIdx.x + i * blockDim.x;
    if (ch < n) {
      float v[kVec];
      unpack_chunk<T>(raw[i], v);
      store_q(qr + ch * kVec, v, s, r);
    }
  }
}

// ------------------------------------------------------ shared by products

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

// the dequantised value v in the output dtype, plus the bias value b (when
// there is a bias) in the reference's order: round the product to the
// output dtype, then add the bias rounded to it
__device__ __forceinline__ float out_value(float v, bool has_bias, float b, float*) {
  return has_bias ? __fadd_rn(v, b) : v;
}
__device__ __forceinline__ __nv_bfloat16 out_value(float v, bool has_bias, float b,
                                                   __nv_bfloat16*) {
  __nv_bfloat16 o = __float2bfloat16_rn(v);
  if (has_bias) {
    o = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(o), __bfloat162float(__float2bfloat16_rn(b))));
  }
  return o;
}

__device__ __forceinline__ float dequant(int32_t acc, float sxm, float swn) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), swn);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// an operand TMA can stream: [rows, K] int8 with K % 16 == 0 on the 16-byte grid
bool tma_ok(const void* p, int K) { return K % 16 == 0 && aligned16(p); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ------------------------------------------------------------ decode

namespace dec {
constexpr int kBN = 64;           // output columns a tile
constexpr int kBox = 128;         // bytes of K a TMA box: one swizzled row
constexpr int kStages = 4;        // weight boxes in flight a block
constexpr int kConsumers = 4;     // mma warps; one producer warp beside them
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kMaxRanks = 8;      // the portable cluster size
constexpr int kWBox = kBN * kBox;           // 8 KB of weight a stage
constexpr int kXBox = kDecodeMaxM * kBox;   // 16 rows of xq a box
constexpr int kMaxSliceBoxes = 32;          // a block's slice of xq <= 64 KB
constexpr int kRedCols = kBN + kMaxRanks;   // >= S * ceil(64 / S)
constexpr int kMaxK = kMaxRanks * kMaxSliceBoxes * kBox;

constexpr int kShortSlice = 16;  // boxes: a cluster is cut below 8 only this far

inline int boxes(int K) { return (K + kBox - 1) / kBox; }
// the most boxes a rank of an S-block cluster takes
inline int slice_boxes(int K, int S) { return (boxes(K) + S - 1) / S; }
// dynamic shared memory: 1024 of slack to align the ring, the weight
// ring, the block's slice of xq, the pushed int32 partials (two tiles),
// the pushed row maxima, the row scales and their reciprocals, sw and the
// bias of two tiles, the mbarriers
__host__ __device__ constexpr int smem_bytes(int xboxes) {
  return 1024 + kStages * kWBox + xboxes * kXBox + 2 * kDecodeMaxM * kRedCols * 4 +
         kMaxRanks * kDecodeMaxM * 4 + 2 * kDecodeMaxM * 4 + 2 * 2 * kBN * 4 +
         (2 * kStages + 1) * 8;
}
}  // namespace dec

// A cluster of S blocks walks 64-column tiles t = cluster, cluster + G, ...
// (G clusters, as many as fit at once), each block over its slice [b0, b1)
// of K's 128-byte boxes, its slice of xq [16 rows] held in shared memory
// throughout. `fused`: x is the float activations TI [M, K] and the block
// quantizes its slice itself; otherwise one TMA load a box brings it from
// the int8 xq [M, K] that `txq` maps, and sx holds its scales. Blocks meet
// once a tile, at one cluster barrier: before it each pushes its int32
// partials into the shared memory of the block that finishes those
// columns (two buffers, by tile parity), after it each sums what it was
// sent, locally. The producer warp's next tile waits on that barrier too:
// with the ring refilled one tile ahead instead, a consumer warp that
// started its tile late (the two that stage sw and the bias) read boxes
// the next tile's loads had overwritten (M > 8, about one launch in ten);
// each consumer also fences its reads of a stage against the TMA that
// refills it before it frees the stage.
template <typename TI, typename TO, bool kFused>
__global__ void __launch_bounds__(dec::kThreads)
int8_decode_kernel(const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap txq,
                   const TI* __restrict__ x, const float* __restrict__ sx,
                   const float* __restrict__ sw, const float* __restrict__ bias,
                   TO* __restrict__ out, int M, int N, int K, int xboxes) {
  using namespace dec;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* wring = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* xbuf = wring + kStages * kWBox;
  int32_t* red = reinterpret_cast<int32_t*>(xbuf + xboxes * kXBox);  // [2][16][kRedCols]
  float* amax_in = reinterpret_cast<float*>(red + 2 * kDecodeMaxM * kRedCols);  // [8][16]
  float* scl = amax_in + kMaxRanks * kDecodeMaxM;
  float* rcp = scl + kDecodeMaxM;   // recip(scl)
  float* sw_s = rcp + kDecodeMaxM;  // [2][64]
  float* bias_s = sw_s + 2 * kBN;   // [2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + 2 * kBN);
  uint64_t* empty = full + kStages;
  uint64_t* xq_full = empty + kStages;

  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int S = static_cast<int>(sm90::cluster_nctarank());
  const int G = gridDim.x / S, cid = blockIdx.x / S;
  const int tiles = (N + kBN - 1) / kBN;
  const int T = (tiles - cid + G - 1) / G;  // this cluster's tiles
  const int NB = (K + kBox - 1) / kBox;
  const int b0 = rank * NB / S, b1 = (rank + 1) * NB / S;
  const int nb = b1 - b0;
  const int per = (kBN + S - 1) / S;  // the columns each block finishes
  const int c_lo = rank * per, cols = max(0, min(kBN, c_lo + per) - c_lo);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 32 * kConsumers);
    }
    sm90::mbar_init(xq_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Cluster barriers, each split into an arrive and a wait: "start" (no
  // block writes another's shared memory before all have started), the
  // prologue's (fused: the row maxima), then one a tile (the partials).
  if (warp == kConsumers) {  // ------------------------------- producer
    // lane 0 issues box `it` of this block's stream (tile it / nb)
    auto issue = [&](int it) {
      const int s = it % kStages, j = it / nb;
      sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&full[s], kWBox);
      sm90::tma_load_2d(wring + s * kWBox, &tw, &full[s], (b0 + it % nb) * kBox,
                        (cid + j * G) * kBN);
    };
    // xq's slice (unfused), then the ring's first fill: no slot to wait
    // for, no barrier
    const int first = min(kStages, T * nb);
    if (lane == 0) {
      if constexpr (!kFused) {
        sm90::mbar_arrive_expect_tx(xq_full, nb * kXBox);
        for (int b = 0; b < nb; ++b) {
          sm90::tma_load_2d(xbuf + b * kXBox, &txq, xq_full, (b0 + b) * kBox, 0);
        }
      }
      for (int it = 0; it < first; ++it) issue(it);
    }
    __syncwarp();
    sm90::cluster_arrive_relaxed();  // start
    sm90::cluster_wait();
    // the prologue's barrier (fused), then tile j's once its boxes are
    // issued: the next tile's boxes wait until every warp is past this
    // one (the producer publishes nothing)
    if constexpr (kFused) sm90::cluster_arrive_relaxed();
    for (int j = 0; j < T; ++j) {
      if (lane == 0) {
        for (int it = max(first, j * nb); it < (j + 1) * nb; ++it) issue(it);
      }
      __syncwarp();
      if (kFused && j == 0) sm90::cluster_wait();
      sm90::cluster_arrive_relaxed();
      sm90::cluster_wait();
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  sm90::cluster_arrive_relaxed();  // start: waited before the first push
  if constexpr (kFused) {
    // each row's amax over this block's slice (warp w takes rows w, w + 4,
    // ...), pushed into every block's amax_in[rank]. A lane reads kHold
    // chunks at a time, all in flight together, and again (from L1) to
    // quantize them.
    constexpr int kVec = Chunk<TI>::kVec, kHold = 8;
    const int k0 = b0 * kBox, len = min(K, b1 * kBox) - k0;
    const int nch = len / kVec;  // K % 16 == 0: whole chunks
    auto load = [&](uint4 (&raw)[kHold], const TI* xr, int c0) {
#pragma unroll
      for (int i = 0; i < kHold; ++i) {
        const int ch = c0 + lane + 32 * i;
        raw[i] = ch < nch ? ldg16(xr + ch * kVec) : make_uint4(0, 0, 0, 0);
      }
    };
    for (int m = warp; m < M; m += kConsumers) {
      const TI* xr = x + static_cast<int64_t>(m) * K + k0;
      float a = 0.f;
      for (int c0 = 0; c0 < nch; c0 += 32 * kHold) {
        uint4 raw[kHold];
        load(raw, xr, c0);
#pragma unroll
        for (int i = 0; i < kHold; ++i) {  // zero chunks past the slice: no effect
          float v[kVec];
          unpack_chunk<TI>(raw[i], v);
          a = chunk_amax(a, v);
        }
      }
      a = warp_max(a);
      if (m == warp) sm90::cluster_wait();  // start
      if (lane < S) {
        sm90::st_cluster_u32(
            sm90::cluster_map(sm90::smem_u32(&amax_in[rank * kDecodeMaxM + m]), lane),
            __float_as_uint(a));
      }
    }
    if (warp >= M) sm90::cluster_wait();  // start, for warps with no row
    sm90::cluster_arrive();  // the prologue's barrier
    sm90::cluster_wait();
    if (tid < M) {
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q < S) a = fmaxf(a, amax_in[q * kDecodeMaxM + tid]);
      }
      scl[tid] = scale_of(a);
      rcp[tid] = recip(scl[tid]);
    }
    sm90::named_sync(1, 32 * kConsumers);
    // the slice quantized into xbuf: box b, row m, chunk c at b * kXBox +
    // m * 128 + (c ^ (m % 8)) * 16, the layout TMA's swizzle gives the
    // unfused path; the slice's last box zero past K. Rows >= M are never
    // read: their A fragments are zero in registers.
    for (int m = warp; m < M; m += kConsumers) {
      const float s = scl[m], r = rcp[m];
      const TI* xr = x + static_cast<int64_t>(m) * K + k0;
      uint8_t* row = xbuf + m * kBox;
      for (int c0 = 0; c0 < nch; c0 += 32 * kHold) {
        uint4 raw[kHold];
        load(raw, xr, c0);
#pragma unroll
        for (int i = 0; i < kHold; ++i) {
          const int ch = c0 + lane + 32 * i;
          if (ch < nch) {
            float v[kVec];
            unpack_chunk<TI>(raw[i], v);
            const int kl = ch * kVec;
            store_q(row + (kl >> 7) * kXBox + ((((kl & 127) >> 4) ^ (m & 7)) << 4) + (kl & 15),
                    v, s, r);
          }
        }
      }
      for (int c = len / 16 + lane; c < nb * (kBox / 16); c += 32) {
        *reinterpret_cast<uint4*>(row + (c >> 3) * kXBox + (((c & 7) ^ (m & 7)) << 4)) =
            make_uint4(0, 0, 0, 0);
      }
    }
    sm90::named_sync(1, 32 * kConsumers);
  } else {
    if (tid < M) scl[tid] = sx[tid];
    sm90::mbar_wait(xq_full, 0);
  }

  // warp w owns the tile's columns [16w, 16w + 16), two n8 tiles, over
  // all of the slice's boxes; rows >= M stay zero in registers
  const bool row_lo = g < M, row_hi = g + 8 < M;
  int it = 0;
  for (int j = 0; j < T; ++j) {
    const int n0 = (cid + j * G) * kBN;
    const int buf = j & 1;
    if (tid < kBN) {  // this tile's sw and bias, read after the barrier
      const int n = n0 + tid;
      sw_s[buf * kBN + tid] = n < N ? sw[n] : 0.f;
      bias_s[buf * kBN + tid] = (bias != nullptr && n < N) ? bias[n] : 0.f;
    }
    int32_t acc[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[jj][r] = 0;
    for (int b = 0; b < nb; ++b, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* ws = wring + s * kWBox + (16 * warp + g) * kBox;
      const uint8_t* xs = xbuf + b * kXBox + g * kBox;
#pragma unroll
      for (int kk = 0; kk < kBox / 32; ++kk) {
        const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
        uint32_t a[4];
        a[0] = row_lo ? lds32(xs + c0 + 4 * t) : 0u;
        a[1] = row_hi ? lds32(xs + 8 * kBox + c0 + 4 * t) : 0u;
        a[2] = row_lo ? lds32(xs + c1 + 4 * t) : 0u;
        a[3] = row_hi ? lds32(xs + 8 * kBox + c1 + 4 * t) : 0u;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const uint32_t bf[2] = {lds32(ws + jj * 8 * kBox + c0 + 4 * t),
                                  lds32(ws + jj * 8 * kBox + c1 + 4 * t)};
          mma_s8(acc[jj], a, bf);
        }
      }
      // this thread's reads of the stage, ordered before the TMA write
      // that refills it (generic then async proxy)
      sm90::fence_async_smem();
      sm90::mbar_arrive(&empty[s]);
    }
    // push the partials of rows < M to the blocks that finish them
    if (!kFused && j == 0) sm90::cluster_wait();  // start
    int32_t* red_buf = red + buf * kDecodeMaxM * kRedCols;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = g + (r >= 2 ? 8 : 0);
        const int col = 16 * warp + 8 * jj + 2 * t + (r & 1);
        const int owner = col / per;
        if (m < M) {
          sm90::st_cluster_u32(
              sm90::cluster_map(
                  sm90::smem_u32(&red_buf[m * kRedCols + rank * per + col - owner * per]),
                  owner),
              static_cast<uint32_t>(acc[jj][r]));
        }
      }
    sm90::cluster_arrive();
    sm90::cluster_wait();
    for (int i = tid; i < M * cols; i += 32 * kConsumers) {
      const int m = i / cols, c = i % cols, col = c_lo + c, n = n0 + col;
      if (n < N) {
        int32_t sum = 0;
#pragma unroll
        for (int q = 0; q < kMaxRanks; ++q) {
          if (q < S) sum += red_buf[m * kRedCols + q * per + c];
        }
        const float v = dequant(sum, scl[m], sw_s[buf * kBN + col]);
        out[static_cast<int64_t>(m) * N + n] =
            out_value(v, bias != nullptr, bias_s[buf * kBN + col], out);
      }
    }
  }
}

// how many clusters of S blocks of `kernel` fit on the card at once with
// `smem` bytes each (cached: the occupancy query is not free). The kernel
// must already allow `smem` bytes of dynamic shared memory.
int resident_clusters(const void* kernel, int S, int smem) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int>, int> cache;
  const auto key = std::make_tuple(kernel, S, smem);
  std::lock_guard<std::mutex> guard(lock);
  auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * 1024);
  cfg.blockDim = dim3(dec::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1) {
    cudaGetLastError();  // clear it, and ask again next time
    return 0;
  }
  cache[key] = n;
  return n;
}

// The cluster size for K and `tiles` output tiles: the largest of 8, 4 and
// 2 (at most K's box count) whose clusters all fit on the card at once, so
// that no cluster walks a second tile alone; cut below 8 only while a
// rank's slice stays within kShortSlice boxes (a longer slice stretches
// the fused kernel's quantizing past its weight stream). Else 8, the
// clusters walking several tiles each.
int pick_ranks(const void* kernel, int K, int tiles) {
  const int nb = dec::boxes(K);
  const int top = nb < dec::kMaxRanks ? nb : dec::kMaxRanks;
  for (int S = top; S >= 2; S /= 2) {
    if (dec::slice_boxes(K, S) > dec::kShortSlice && S < top) break;
    if (tiles <= resident_clusters(kernel, S, dec::smem_bytes(dec::slice_boxes(K, S)))) {
      return S;
    }
  }
  return top;
}

// the decode kernel's shared memory allowance, set once: the most any K
// asks for
template <typename TI, typename TO, bool kFused>
cudaError_t decode_smem_ok() {
  static const cudaError_t ok =
      allow_smem(int8_decode_kernel<TI, TO, kFused>, dec::smem_bytes(dec::kMaxSliceBoxes));
  return ok;
}

// What a decode launch reads off its shapes and its weight, kept a
// process: the weight's tensor map (a function of its address and shape
// alone) and the launch plan (cluster size, slice, shared memory, grid),
// so that a decode step's dense pays neither the map's encoding nor the
// occupancy queries again.
struct DecodePlan {
  CUtensorMap tw;
  int S, xboxes, smem, blocks;
};

template <typename TI, typename TO, bool kFused>
cudaError_t decode_plan(const void* wq, int N, int K, DecodePlan* plan) {
  using Key = std::tuple<const void*, int, int>;
  static std::mutex lock;
  static std::map<Key, DecodePlan> cache;
  const Key key{wq, N, K};
  {
    std::lock_guard<std::mutex> guard(lock);
    auto hit = cache.find(key);
    if (hit != cache.end()) {
      *plan = hit->second;
      return cudaSuccess;
    }
  }
  cudaError_t e = decode_smem_ok<TI, TO, kFused>();
  if (e != cudaSuccess) return e;
  e = sm90::rows_map_u8(&plan->tw, wq, N, K, dec::kBN);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(int8_decode_kernel<TI, TO, kFused>);
  const int tiles = (N + dec::kBN - 1) / dec::kBN;
  plan->S = pick_ranks(fn, K, tiles);
  plan->xboxes = dec::slice_boxes(K, plan->S);
  plan->smem = dec::smem_bytes(plan->xboxes);
  const int fit = resident_clusters(fn, plan->S, plan->smem);
  const long long blocks = static_cast<long long>(fit > 0 && fit < tiles ? fit : tiles) * plan->S;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  plan->blocks = static_cast<int>(blocks);
  if (fit > 0) {  // a failed occupancy query is asked again next time
    std::lock_guard<std::mutex> guard(lock);
    if (cache.size() > 4096) cache.clear();
    cache[key] = *plan;
  }
  return cudaSuccess;
}

template <typename TI, typename TO, bool kFused>
cudaError_t launch_decode(const void* x, const void* xq, const void* sx, const void* wq,
                          const void* sw, const void* bias, void* out, int M, int N,
                          int K, cudaStream_t stream) {
  DecodePlan plan;
  cudaError_t e = decode_plan<TI, TO, kFused>(wq, N, K, &plan);
  if (e != cudaSuccess) return e;
  CUtensorMap txq = plan.tw;  // fused: unused
  if constexpr (!kFused) {
    e = sm90::rows_map_u8(&txq, xq, M, K, kDecodeMaxM);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(plan.blocks));
  cfg.blockDim = dim3(dec::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(plan.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, int8_decode_kernel<TI, TO, kFused>, plan.tw, txq,
                         static_cast<const TI*>(x), static_cast<const float*>(sx),
                         static_cast<const float*>(sw), static_cast<const float*>(bias),
                         static_cast<TO*>(out), M, N, K, plan.xboxes);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------------------ prefill

namespace pre {
constexpr int kBM = 128, kBN = 128, kBK = 128;  // kBK: bytes of K a stage
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kTile = kBM * kBK;  // 16 KB: A's and B's box alike
template <typename TO>
constexpr int kEpStride = kBN * static_cast<int>(sizeof(TO)) + 16;  // bytes a staged row
template <typename TO>
constexpr int smem_bytes() {
  return 1024 + 2 * kStages * kTile + 2 * 64 * kEpStride<TO> + 2 * kStages * 8;
}
}  // namespace pre

// One 128 x 128 output tile: consumer warpgroup w computes rows
// [m0 + 64w, m0 + 64w + 64) with wgmma from the ring's A and B boxes.
template <typename TO>
__global__ void __launch_bounds__(pre::kThreads, 1)
int8_prefill_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    const float* __restrict__ bias, TO* __restrict__ out, int M,
                    int N, int K) {
  using namespace pre;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* a_ring = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* b_ring = a_ring + kStages * kTile;
  uint8_t* ep = b_ring + kStages * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ep + 2 * 64 * kEpStride<TO>);
  uint64_t* empty = full + kStages;

  // m fastest: the blocks in flight share their weight tile
  const int m_tiles = (M + kBM - 1) / kBM;
  const int m0 = (blockIdx.x % m_tiles) * kBM, n0 = (blockIdx.x / m_tiles) * kBN;
  const int KT = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        sm90::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * kTile);
        sm90::tma_load_2d(a_ring + s * kTile, &ta, &full[s], kt * kBK, m0);
        sm90::tma_load_2d(b_ring + s * kTile, &tb, &full[s], kt * kBK, n0);
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const uint32_t a0 = sm90::smem_u32(a_ring) + wg * 64 * kBK;
    const uint32_t b0 = sm90::smem_u32(b_ring);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      sm90::mbar_wait(&full[s], (kt / kStages) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        sm90::wgmma_m64n128k32_s8(acc,
                                  sm90::desc_sw128(a0 + s * kTile + kk * 32, 16, 1024),
                                  sm90::desc_sw128(b0 + s * kTile + kk * 32, 16, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the group before this one is done
      sm90::fence_regs(acc);
      if (kt > 0) sm90::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[(KT - 1) % kStages]);

    // dequantise into this warpgroup's staging rows, then 16-byte rows out
    uint8_t* stage = ep + wg * 64 * kEpStride<TO>;
    const int mw = m0 + 64 * wg;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = 16 * warp + g + 8 * i;
      const float sxm = mw + rl < M ? sx[mw + rl] : 0.f;
      TO* srow = reinterpret_cast<TO*>(stage + rl * kEpStride<TO>);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e, n = n0 + col;
          const float swn = n < N ? sw[n] : 0.f;
          srow[col] = out_value(dequant(acc[4 * j + 2 * i + e], sxm, swn),
                                bias != nullptr, bias != nullptr && n < N ? bias[n] : 0.f,
                                out);
        }
      }
    }
    sm90::named_sync(1 + wg, 128);
    const int rows = min(64, M - mw), cols = min(kBN, N - n0);
    const int lt = tid & 127;
    if (rows > 0) {
      constexpr int kVec = 16 / sizeof(TO), kChunks = kBN / kVec;
      if (cols == kBN && (static_cast<long long>(N) * sizeof(TO)) % 16 == 0 && aligned16(out)) {
        for (int c = lt; c < rows * kChunks; c += 128) {
          const int r = c / kChunks, k = c % kChunks;
          *reinterpret_cast<uint4*>(out + static_cast<int64_t>(mw + r) * N + n0 + k * kVec) =
              *reinterpret_cast<const uint4*>(stage + r * kEpStride<TO> + k * 16);
        }
      } else {
        for (int c = lt; c < rows * kBN; c += 128) {
          const int r = c / kBN, col = c % kBN;
          if (col < cols) {
            out[static_cast<int64_t>(mw + r) * N + n0 + col] =
                reinterpret_cast<const TO*>(stage + r * kEpStride<TO>)[col];
          }
        }
      }
    }
  }
}

template <typename TO>
cudaError_t launch_prefill(const void* xq, const void* wq, const void* sx, const void* sw,
                           const void* bias, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t e = sm90::rows_map_u8(&ta, xq, M, K, pre::kBM);
  if (e != cudaSuccess) return e;
  e = sm90::rows_map_u8(&tb, wq, N, K, pre::kBN);
  if (e != cudaSuccess) return e;
  constexpr int smem = pre::smem_bytes<TO>();
  static const cudaError_t smem_ok = allow_smem(int8_prefill_kernel<TO>, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  const long long blocks = static_cast<long long>((M + pre::kBM - 1) / pre::kBM) *
                           ((N + pre::kBN - 1) / pre::kBN);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  int8_prefill_kernel<TO><<<static_cast<unsigned>(blocks), pre::kThreads, smem, stream>>>(
      ta, tb, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

// ------------------------------------------------------------- bytes

namespace byt {
constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kThreads = 256;  // 8 warps, 2 x 4, 32 x 32 each
constexpr int kStride = kBK + 16;  // bytes a staged row: fragment loads miss no bank twice
constexpr int kSmem = (kBM + kBN) * kStride;
}  // namespace byt

// rows [row0, row0 + R) x bytes [k0, k0 + kBK) of g [rows_total, K] into
// sm, byte by byte, zeros outside the tensor
template <int R>
__device__ __forceinline__ void load_bytes(uint8_t* sm, const int8_t* __restrict__ g,
                                           int rows_total, int row0, int K, int k0) {
  for (int i = threadIdx.x; i < R * byt::kBK; i += byt::kThreads) {
    const int r = i / byt::kBK, col = i % byt::kBK;
    const int gr = row0 + r, gk = k0 + col;
    sm[r * byt::kStride + col] = (gr < rows_total && gk < K)
                                     ? static_cast<uint8_t>(g[static_cast<int64_t>(gr) * K + gk])
                                     : uint8_t{0};
  }
}

template <typename TO>
__global__ void __launch_bounds__(byt::kThreads)
int8_bytes_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int K) {
  using namespace byt;
  __shared__ __align__(16) uint8_t smem[kSmem];
  const int n_tiles = (N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  int32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  const uint8_t* as = smem;
  const uint8_t* bs = smem + kBM * kStride;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the tile before is read
    load_bytes<kBM>(smem, xq, M, m0, K, k0);
    load_bytes<kBN>(smem + kBM * kStride, wq, N, n0, K, k0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int kk = ks * 32 + t * 4;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* p = as + (wm * 32 + i * 16 + g) * kStride + kk;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kStride);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = bs + (wn * 32 + j * 8 + g) * kStride + kk;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + t * 2 + (r & 1);
        if (m < M && n < N) {
          out[static_cast<int64_t>(m) * N + n] = out_value(
              dequant(acc[i][j][r], sx[m], sw[n]), bias != nullptr,
              bias != nullptr ? bias[n] : 0.f, out);
        }
      }
}

template <typename TO>
cudaError_t launch_bytes(const void* xq, const void* wq, const void* sx, const void* sw,
                         const void* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((M + byt::kBM - 1) / byt::kBM) *
                           ((N + byt::kBN - 1) / byt::kBN);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  int8_bytes_kernel<TO><<<static_cast<unsigned>(blocks), byt::kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

// ------------------------------------------------------------ dispatch

enum Path { kFusedPath = 0, kDecodePath = 1, kPrefillPath = 2, kBytesPath = 3 };
enum QPath { kQuantScalar = 0, kQuantBlock = 1 };

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

// the quantizer's path, and its chunks a thread: the fewest (a power of
// two) that keep a row within kQuantBlockTarget threads, or within 1024
int quant_path(const void* x, int K, int dtype, int* chunks) {
  const int vec = 16 / elem_size(dtype);
  if (!aligned16(x) || K % vec != 0) return kQuantScalar;
  const int n = K / vec;
  if (n > 1024 * kQuantBlockMaxChunks) return kQuantScalar;
  int c = 1;
  while (c < kQuantBlockMaxChunks && (n + c - 1) / c > kQuantBlockTarget) c *= 2;
  *chunks = c;
  return kQuantBlock;
}

template <typename T, int kChunks>
cudaError_t launch_quant_block(const void* x, void* q, void* scale, long long rows, int K,
                               int chunks, cudaStream_t s) {
  if constexpr (kChunks < kQuantBlockMaxChunks) {
    if (chunks > kChunks) return launch_quant_block<T, 2 * kChunks>(x, q, scale, rows, K, chunks, s);
  }
  const int n = K / Chunk<T>::kVec;
  const int threads = ((n + kChunks - 1) / kChunks + 31) / 32 * 32;
  quantize_rows_block_kernel<T, kChunks><<<static_cast<unsigned>(rows), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* scale, long long rows, int K, int dtype,
                         cudaStream_t s) {
  int chunks = 1;
  if (quant_path(x, K, dtype, &chunks) == kQuantBlock) {
    return launch_quant_block<T, 1>(x, q, scale, rows, K, chunks, s);
  }
  quantize_rows_kernel<T><<<static_cast<unsigned>(rows), kQuantThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t run_mm(const void* xq, const void* wq, const void* sx, const void* sw,
                   const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
  if (!tma_ok(xq, K) || !tma_ok(wq, K)) {
    return launch_bytes<TO>(xq, wq, sx, sw, bias, out, M, N, K, s);
  }
  if (M <= kDecodeMaxM && K <= dec::kMaxK) {
    return launch_decode<int8_t, TO, false>(nullptr, xq, sx, wq, sw, bias, out, M, N, K, s);
  }
  return launch_prefill<TO>(xq, wq, sx, sw, bias, out, M, N, K, s);
}

template <typename TI>
cudaError_t run_fused(int out_dtype, const void* x, const void* wq, const void* sw,
                      const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
  return out_dtype == 0
             ? launch_decode<TI, float, true>(x, nullptr, nullptr, wq, sw, bias, out, M, N, K, s)
             : launch_decode<TI, __nv_bfloat16, true>(x, nullptr, nullptr, wq, sw, bias, out, M,
                                                      N, K, s);
}

bool fused_ok(const void* x, const void* wq, int M, int K) {
  return M >= 1 && M <= kDecodeMaxM && K % 16 == 0 && K <= dec::kMaxK && aligned16(x) &&
         aligned16(wq);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t.
extern "C" int hyperion_quantize_rows(const void* x, void* q, void* scale, long long rows, int K,
                                      int dtype, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || K <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_quant<float>(x, q, scale, rows, K, dtype, s);
    case 1: return launch_quant<__nv_bfloat16>(x, q, scale, rows, K, dtype, s);
    case 2: return launch_quant<__half>(x, q, scale, rows, K, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

// 0: the scalar block a row, 1: a block a row held in registers
extern "C" int hyperion_quantize_rows_path(const void* x, int K, int dtype) {
  int chunks = 1;
  return quant_path(x, K, dtype, &chunks);
}

// The path of a product: x is the float activations of quantized_dense
// (fused != 0) or int8_matmul's xq. 0 decode_fused, 1 decode, 2
// prefill_wgmma, 3 bytes; a fused call off its rule takes quantize_rows
// and then the product's path.
extern "C" int hyperion_int8_matmul_path(const void* x, const void* wq, int M, int K, int fused) {
  if (fused != 0 && fused_ok(x, wq, M, K)) return kFusedPath;
  if (fused == 0 && !tma_ok(x, K)) return kBytesPath;
  if (!tma_ok(wq, K)) return kBytesPath;
  return M <= kDecodeMaxM && K <= dec::kMaxK ? kDecodePath : kPrefillPath;
}

// out_dtype: 0 float32, 1 bfloat16. bias may be null.
extern "C" int hyperion_int8_matmul(const void* xq, const void* wq, const void* sx, const void* sw,
                                    const void* bias, void* out, int M, int N, int K, int out_dtype,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || out_dtype < 0 || out_dtype > 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_dtype == 0 ? run_mm<float>(xq, wq, sx, sw, bias, out, M, N, K, s)
                     : run_mm<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, s));
}

// quantized_dense at M <= 16 in one launch: x [M, K] float (in_dtype 0
// float32, 1 bfloat16, 2 float16), wq [N, K] int8, sw [N], bias [N] or
// null, out [M, N] (out_dtype 0 float32, 1 bfloat16). Off the fused rule
// (M <= 16, K % 16 == 0, K <= 32768, x and wq on the 16-byte grid) it
// launches nothing and returns cudaErrorInvalidValue.
extern "C" int hyperion_quantized_dense_decode(const void* x, const void* wq, const void* sw,
                                               const void* bias, void* out, int M, int N, int K,
                                               int in_dtype, int out_dtype, void* stream) {
  if (N <= 0 || !fused_ok(x, wq, M, K) || out_dtype < 0 || out_dtype > 1) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return run_fused<float>(out_dtype, x, wq, sw, bias, out, M, N, K, s);
    case 1: return run_fused<__nv_bfloat16>(out_dtype, x, wq, sw, bias, out, M, N, K, s);
    case 2: return run_fused<__half>(out_dtype, x, wq, sw, bias, out, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}

namespace {
// a decode kernel, its shared memory allowance set
template <typename TI, typename TO, bool kFused>
const void* decode_kernel_ready() {
  decode_smem_ok<TI, TO, kFused>();
  return reinterpret_cast<const void*>(int8_decode_kernel<TI, TO, kFused>);
}
template <typename TI>
const void* decode_fn(bool fused, int out_dtype) {
  if (fused) {
    return out_dtype == 0 ? decode_kernel_ready<TI, float, true>()
                          : decode_kernel_ready<TI, __nv_bfloat16, true>();
  }
  return out_dtype == 0 ? decode_kernel_ready<int8_t, float, false>()
                        : decode_kernel_ready<int8_t, __nv_bfloat16, false>();
}
template <typename T>
const void* quant_fn(int which) {
  // the widest instantiation: the most registers
  return which == 1
             ? reinterpret_cast<const void*>(quantize_rows_block_kernel<T, kQuantBlockMaxChunks>)
             : reinterpret_cast<const void*>(quantize_rows_kernel<T>);
}
}  // namespace

// What the compiler gave a kernel. which: 0 the scalar quantizer, 1 the
// block quantizer (in_dtype: their input's; the widest instantiation), 2
// decode_fused (in_dtype: x's), 3 decode, 4 prefill_wgmma, 5 bytes
// (out_dtype: the output's). K and N size the decode kernels' cluster and
// shared memory. out = {registers a thread, local (spill) bytes a thread, shared
// memory a block, threads a block, blocks a cluster, clusters resident at
// once (decode; 0 otherwise)}.
extern "C" int hyperion_int8_attrs(int which, int in_dtype, int out_dtype, int K, int N,
                                   int* out) {
  const void* fn = nullptr;
  int smem = 0, threads = 0, cluster = 1, resident = 0;
  if (which <= 1) {
    fn = in_dtype == 0 ? quant_fn<float>(which)
         : in_dtype == 1 ? quant_fn<__nv_bfloat16>(which)
                         : quant_fn<__half>(which);
    threads = which == 1 ? 1024 : kQuantThreads;
  } else if (which <= 3) {
    const bool fused = which == 2;
    fn = in_dtype == 0 ? decode_fn<float>(fused, out_dtype)
         : in_dtype == 1 ? decode_fn<__nv_bfloat16>(fused, out_dtype)
                         : decode_fn<__half>(fused, out_dtype);
    cluster = pick_ranks(fn, K, (N + dec::kBN - 1) / dec::kBN);
    smem = dec::smem_bytes(dec::slice_boxes(K, cluster));
    threads = dec::kThreads;
    resident = resident_clusters(fn, cluster, smem);
  } else if (which == 4) {
    fn = out_dtype == 0 ? reinterpret_cast<const void*>(int8_prefill_kernel<float>)
                        : reinterpret_cast<const void*>(int8_prefill_kernel<__nv_bfloat16>);
    smem = out_dtype == 0 ? pre::smem_bytes<float>() : pre::smem_bytes<__nv_bfloat16>();
    threads = pre::kThreads;
  } else {
    fn = out_dtype == 0 ? reinterpret_cast<const void*>(int8_bytes_kernel<float>)
                        : reinterpret_cast<const void*>(int8_bytes_kernel<__nv_bfloat16>);
    threads = byt::kThreads;
  }
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes) + smem;
  out[3] = threads;
  out[4] = cluster;
  out[5] = resident;
  return 0;
}
