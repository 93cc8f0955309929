// Hopper body of the dequant-GEMM above the decode rows, shared by kernel 1
// (T = false, NW = 1: y = x @ dequant(W) (+ bias), entry gptq_qmm_wgmma in
// qmm.cu), kernel 2 (T = false, NW = 2: silu(x @ dequant(Wg)) * (x @
// dequant(Wu)), entry gptq_fused_mlp_wgmma in fused_mlp.cu) and kernel 8
// (T = true: dx = g @ dequant(W)^T, entry gptq_qmm_t_wgmma in qmm_t.cu).
//
// Replaces, beside the mma.sync tiles of qmm_tc.cuh and qmm_t.cu where the
// plan finds it faster, the TPU kernels
// gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel (entry _qmm_2d),
// :_qmm_t_kernel (entry _qmm_t_2d) and
// gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel. W is the packed (K * BITS / 32, N) int32
// weight with bf16 scales and zeros (G, N), in device row order; each element
// is dequantized as c * s - z * s in fp32 and rounded once to bf16 (both
// products are exact in fp32, so (c - z) * s rounded once is the same bf16:
// bit-equal to PackedLinear.dequantize), and the products sum in fp32.
//
// What bounds it on the H100: operations from a few hundred rows up (M =
// 1024 at 4096 x 4096 is 34.4 GFLOP, 34.7 us at 989 TFLOP/s, against 7.5 us
// of bytes); the packed weight bytes below that (M = 128: 4.3 us of each).
// The mma.sync tiles reach a third of the operations bound: every warp copies,
// dequantizes into a bf16 tile in shared memory and multiplies, one barrier
// a slab orders the three, and mma.sync cannot reach the card's rate. So:
//  - the roles swap: the output is taken transposed, y^T = dequant(W)^T x^T
//    (dx^T = dequant(W) g^T), so the weight is wgmma's A operand, 64 output
//    columns a warpgroup, dequantized straight from the packed words into A
//    fragments in registers (the RS form); it never touches shared memory.
//    x (g) is the B operand, read by wgmma from shared memory as TMA wrote it
//    (K-major, 128-byte swizzle), and its rows are wgmma's N (BM = 64, 128,
//    144 or 256), so the 136-row serving chunk runs at 144, not 256;
//  - an A fragment's pairs run along the reduction, and the output columns a
//    thread holds are free to choose: a thread's rows g and g + 8 are output
//    columns c and c + 1 (kernel 1: columns of W, whose words sit side by
//    side, one 8-byte load; kernel 8: rows k and k + 1 of W, two codes of one
//    word). Kernel 1's pairs are two codes of one word (a byte, or a nibble
//    at 2 bits, moved into both halves of a bf16x2 by one multiply); kernel
//    8's pairs are one code of each of two neighbouring words, gathered by
//    one byte permute, where a shuffle or a dequantizing warpgroup writing
//    an SS tile would cost more instructions or a shared-memory round trip.
//    2 and 4 bits dequantize in bf16x2 (128 + c, exact; minus 128 + z,
//    exact; times s, one rounding), 8 bits in fp32 through 2^23 + c;
//  - warp specialisation: one thread of a producer warpgroup keeps TMA loads
//    in flight through a ring of as many stages as shared memory holds (up
//    to 8), each stage x's (g's) BM x 64 tile (zero fill past M and the
//    reduction), the slab's packed words as a 2-D int32 box, and the scale
//    and zero rows of the groups the stage touches; full and empty mbarriers
//    per stage; setmaxnreg gives the producer's registers to the two
//    consumer warpgroups;
//  - each consumer warpgroup dequantizes k16 step s + 1 while the
//    asynchronous wgmmas of steps s - 1 and s run (wgmma_wait<1>, a fragment
//    buffer for each of a stage's four steps), and releases a stage once the
//    products that read it have completed;
//  - epilogue straight from the accumulators: a thread's pair of columns is
//    one 4-byte store, 8 threads write a whole 32-byte sector of one row, so
//    y needs no staging. The bias is added in fp32 before the rounding, as
//    the tiles do. Where the plan splits the reduction (too few output tiles
//    for 132 SMs) each split writes fp32 partials and gptq::qmm_reduce_kernel
//    sums them in split order: the same bytes on every launch. (Summing
//    them over distributed shared memory in a cluster of the split blocks,
//    in one launch, measured 2x slower at M = 128: 32.67 against 16.71 us,
//    scripts/torch_qmm_bodies.py --quick. Why is not measured; at one block
//    an SM, clusters of 4-8 blocks may not all fit the GPCs at once. Pairs
//    of column tiles multicasting x's tile, half of x's L2 reads, measured
//    no faster: those reads do not bound it.)
//  - kernel 2 (NW = 2): a block covers 64 columns of y; consumer warpgroup 0
//    multiplies the gate weight's 64 columns and warpgroup 1 the up
//    weight's same 64, each with kernel 1's inner loop over the one x tile a
//    stage. A stage holds one word box, one scale box and one zero box of
//    64 columns of each weight: kernel 1's bytes, so the ring is kernel 1's.
//    Once both have drained the ring, warpgroup 1 hands its fp32 sums to
//    warpgroup 0 through the ring's shared memory (thread t of one holds the
//    (row, column) pairs of thread t of the other), and warpgroup 0 stores
//    silu(g) * u rounded once to bf16; split, each writes its partials
//    into qmm_reduce_kernel<2>'s (2, split, M, N) layout.
// Scope: a k16 step (kernel 1, 2) or a warp's 16 rows (kernel 8) lies in one
// group, that is groupsize % 16 == 0 or G = 1; a stage holds the scale and
// zero rows of at most sz_rows_max(T) groups (the wrapper's plan counts them).
// K % 8 == 0 and N % 8 == 0 for TMA's 16-byte strides. Other shapes keep the
// mma.sync tiles.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "qmm_common.cuh"

namespace gptq_wg {

using namespace gptq_hopper;
using gptq_mma::pack_bf16;

constexpr int kThreads = 384;     // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int kCols = 128;        // weight columns per block, 64 a consumer warpgroup
constexpr int kDepth = 64;        // reduction per stage: one 128-byte swizzled row of bf16
constexpr int kSZBytes = 1024;    // a stage's scale rows, and as much for its zero rows
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;   // dynamic shared memory one block may have
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
// kernel 2: row tiles a group of the launch order. Its 172 column tiles at N
// = 11008 (gate and up, 45 MB a pass with their scales) make a wave of
// blocks span under one row tile and every row tile read both weights
// again; walking the column tiles of 8 row tiles at a time keeps a wave on
// fewer weight columns. Two calls of scripts/torch_mlp_wgmma_variants.py
// (NVIDIA H100 80GB HBM3, 700 W), 8 against unordered: M = 1024 326.3 /
// 329.5 against 338.3 / 339.7 us, M = 2048 620.1 / 608.0 against 621.0 /
// 633.9, M = 16384 4797 / 4986 against 5046 / 4859 (within the calls'
// spread; kernel 1 twice moved 4603-4786 between processes).
constexpr int kRasterRows = 8;

// Scale and zero rows a stage holds: kernel 1's stage covers 64 rows of K for
// 128 columns (4 rows of 256 bytes), kernel 8's the block's 128 rows of K for
// 64 columns (8 rows of 128 bytes).
__host__ __device__ constexpr int sz_rows_max(bool t) { return t ? 8 : 4; }

// One block's shared memory: kStages stages of (x tile, words, scales,
// zeros), then the full and empty barriers, and 1 KB to align the stages
// to the 128-byte swizzle's 1 KB atom. ops/cuda/matmul.py's wgmma_smem_bytes
// computes the same.
template <int BITS, int BM>
struct Layout {
  static constexpr int kX = BM * kDepth * 2;
  static constexpr int kW = kDepth * kCols * BITS / 8;
  static constexpr int kStage = kX + kW + 2 * kSZBytes;
  static constexpr int kBars = 2 * kMaxStages * 8;
  static constexpr int kFit = (kSmemLimit - kBars - 1024) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytes = kStages * kStage + kBars + 1024;
  static_assert(kStages >= 3, "a ring of at least 3 stages");
};

__device__ __forceinline__ int group_of(int r, int groupsize, int G) {
  return min(r / groupsize, G - 1);
}

__device__ __forceinline__ uint32_t hsub_hmul(uint32_t v, uint32_t z2, uint32_t s2) {
  __nv_bfloat162 r = __hmul2(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                     *reinterpret_cast<__nv_bfloat162*>(&z2)),
                             *reinterpret_cast<__nv_bfloat162*>(&s2));
  return *reinterpret_cast<uint32_t*>(&r);
}

// 128 + z for a pair of zeros (bf16x2, exact: z <= 2^BITS)
__device__ __forceinline__ uint32_t zero_128(uint32_t z) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&z),
                                   __floats2bfloat162_rn(128.0f, 128.0f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 2^23 + byte b of q, as a float (exact)
__device__ __forceinline__ float magic8(uint32_t q, int b) {
  return __int_as_float(__byte_perm(q, 0x4B000000u, 0x7540 | b));
}

// grid: (ceil(O / (kCols / NW)), split, ceil(M / BM)), O the output width
// (N for kernels 1 and 2, K for kernel 8); block: kThreads; dynamic shared memory
// Layout<BITS, BM>::kBytes. The reduction (K for kernel 1, N for kernel 8)
// runs in stages of kDepth; split z takes stages [z * per_split, ...) and,
// with split > 1, writes partial[(z * M + m) * O + o] (qmm_reduce_kernel's
// layout; kernel 2: partial[((w * split + z) * M + m) * N + n] for stream w).
// Tensor maps: tx x (M, K) or g (M, N) bf16, box kDepth x BM, 128-byte
// swizzle; tw the words (K * BITS / 32, N) int32, box kCols / NW x 64 * BITS
// / 32 (kernels 1, 2) or kDepth x kCols * BITS / 32 (kernel 8); ts, tz scales
// and zeros (G, N) bf16, box kCols / NW (kernels 1, 2) or kDepth (kernel 8) x
// sz_rows; tw2, ts2, tz2 the up weight's (kernel 2; unused otherwise).
template <int BITS, int BM, bool T, int NW>
__global__ void __launch_bounds__(kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tz,
                 const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap ts2,
                 const __grid_constant__ CUtensorMap tz2,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ partial, int M, int K, int N, int G, int groupsize,
                 int per_split, int sz_rows) {
  static_assert(NW == 1 || (NW == 2 && !T), "two weight streams: kernel 2");
  using L = Layout<BITS, BM>;
  constexpr int S = L::kStages;
  constexpr int kIpw = 32 / BITS;                   // rows of W per word
  constexpr int kBoxCols = kCols / NW;              // kernels 1, 2: columns of one weight's boxes
  constexpr int kWCols = T ? kDepth : kBoxCols;     // columns of the word and scale boxes
  // kernel 2's sums handed from warpgroup 1 to 0 fit in the ring
  static_assert(NW == 1 || S * L::kStage >= BM / 2 * 128 * 4, "the exchange fits the ring");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  auto sx = [&](int st) { return base + st * L::kStage; };
  auto sw = [&](int st) { return base + st * L::kStage + L::kX; };
  auto ss = [&](int st) { return base + st * L::kStage + L::kX + L::kW; };
  auto sz = [&](int st) { return ss(st) + kSZBytes; };
  const uint32_t bars = base + S * L::kStage;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kMaxStages + st); };

  const int O = T ? K : N;                          // output width
  const int R = T ? N : K;                          // reduction
  // the block's column and row tiles: blocks launch in the order of x, then
  // z; kernel 2 walks the column tiles of kRasterRows row tiles at a time
  int bx = blockIdx.x, bz = blockIdx.z;
  if constexpr (NW == 2 && kRasterRows > 1) {
    const int id = bz * gridDim.x + bx, per = kRasterRows * gridDim.x;
    const int first = id / per * kRasterRows;
    const int rows = min(kRasterRows, (int)gridDim.z - first), local = id % per;
    bz = first + local % rows;
    bx = local / rows;
  }
  const int o0 = bx * (kCols / NW), m0 = bz * BM;
  const int split = gridDim.y;
  const int n_steps = (R + kDepth - 1) / kDepth;
  const int t_begin = blockIdx.y * per_split;
  const int t_count = max(0, min(n_steps, t_begin + per_split) - t_begin);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);   // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every copy, stage by stage
    reg_dealloc<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      tma_prefetch_desc(&tx);
      tma_prefetch_desc(&tw);
      tma_prefetch_desc(&ts);
      tma_prefetch_desc(&tz);
      if constexpr (NW == 2) {
        tma_prefetch_desc(&tw2);
        tma_prefetch_desc(&ts2);
        tma_prefetch_desc(&tz2);
      }
      const uint32_t bytes = L::kX + L::kW + NW * 2 * sz_rows * kWCols * 2;
      for (int i = 0; i < t_count; ++i) {
        const int st = i % S, r0 = (t_begin + i) * kDepth;
        if (i >= S) mbar_wait(empty(st), (uint32_t)((i / S - 1) & 1));
        mbar_expect_tx(full(st), bytes);
        tma_load_2d(sx(st), &tx, full(st), r0, m0);
        if constexpr (T) {   // the groups of the block's rows of W
          const int g_lo = group_of(o0, groupsize, G);
          tma_load_2d(sw(st), &tw, full(st), r0, o0 / kIpw);
          tma_load_2d(ss(st), &ts, full(st), r0, g_lo);
          tma_load_2d(sz(st), &tz, full(st), r0, g_lo);
        } else {
          const int g_lo = group_of(r0, groupsize, G);
          tma_load_2d(sw(st), &tw, full(st), o0, r0 / kIpw);
          tma_load_2d(ss(st), &ts, full(st), o0, g_lo);
          tma_load_2d(sz(st), &tz, full(st), o0, g_lo);
          if constexpr (NW == 2) {   // the up weight's boxes in the second halves
            tma_load_2d(sw(st) + L::kW / 2, &tw2, full(st), o0, r0 / kIpw);
            tma_load_2d(ss(st) + kSZBytes / 2, &ts2, full(st), o0, g_lo);
            tma_load_2d(sz(st) + kSZBytes / 2, &tz2, full(st), o0, g_lo);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output columns o0 + 64 wg .. (kernel 2:
  // columns o0 .. of weight wg, gate or up); a thread's A rows g and g + 8
  // are output columns c and c + 1
  reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int c = (NW == 1 ? 64 * wg : 0) + 16 * w + 2 * g;
  // kernel 2: this warpgroup's weight's boxes, the second halves for up
  const uint32_t w_off = NW == 2 ? wg * (L::kW / 2) : 0;
  const uint32_t s_off = NW == 2 ? wg * (kSZBytes / 2) : 0;

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
  // the zeros are defined here, once: where the compiler sank them into the
  // path that skips the loop, ptxas serialized every wgmma (C7515)
  fence_regs(acc);
  uint32_t a[kDepth / 16][4];   // one fragment buffer a k16 step of a stage

  // scales and zeros of the thread's pair: kernel 1, columns c and c + 1 of
  // one group row (2 / 4 bits: (s_c, s_c) and (s_c1, s_c1) as bf16x2, 128 +
  // z likewise; 8 bits: s and 2^23 + z as floats); kernel 8, reloaded per
  // step for the step's columns
  uint32_t s2[2] = {0u, 0u}, z2[2] = {0u, 0u};
  float sf[2] = {0.0f, 0.0f}, zf[2] = {0.0f, 0.0f};
  auto scale_pair = [&](uint32_t sp, uint32_t zp) {
    if constexpr (BITS == 8) {
      sf[0] = __uint_as_float(sp << 16);
      sf[1] = __uint_as_float(sp & 0xFFFF0000u);
      zf[0] = 8388608.0f + __uint_as_float(zp << 16);
      zf[1] = 8388608.0f + __uint_as_float(zp & 0xFFFF0000u);
    } else {
      const uint32_t zz = zero_128(zp);
      s2[0] = __byte_perm(sp, 0, 0x1010);
      s2[1] = __byte_perm(sp, 0, 0x3232);
      z2[0] = __byte_perm(zz, 0, 0x1010);
      z2[1] = __byte_perm(zz, 0, 0x3232);
    }
  };
  // kernel 1: column pair c, c + 1 of group row `row` of stage st
  auto k1_scales = [&](int st, int row) {
    const unsigned char* p = sbase + (ss(st) - base) + s_off + (row * kBoxCols + c) * 2;
    scale_pair(*reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + kSZBytes));
  };
  // kernel 1, 2 / 4 bits: codes 2 t4, 2 t4 + 1 (bits at `sh` and sh + BITS)
  // as the bf16x2 (128 + c0, 128 + c1)
  auto pair_k = [&](uint32_t q, int sh) -> uint32_t {
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    constexpr uint32_t kTwo = (1u << (2 * BITS)) - 1u;
    const uint32_t b = (q >> sh) & kTwo;                    // the two codes
    constexpr uint32_t kSpread = 1u | (1u << (16 - BITS));  // code 1 to bit 16
    return ((b * kSpread) & (kMask | (kMask << 16))) | 0x43004300u;
  };
  // kernel 1, 8 bits: bytes b, b + 1 of q
  auto pair8 = [&](uint32_t q, int b, int j) -> uint32_t {
    return pack_bf16((magic8(q, b) - zf[j]) * sf[j], (magic8(q, b + 1) - zf[j]) * sf[j]);
  };

  // the A fragment of k16 step kk of stage st into f
  auto build = [&](int st, int kk, uint32_t (&f)[4]) {
    const unsigned char* wd = sbase + (sw(st) - base) + w_off;
    if constexpr (!T) {
      // words [64 / kIpw][kBoxCols]: the pair of columns c, c + 1 is one 8-byte load
      if constexpr (BITS == 8) {
        const uint2 lo = *reinterpret_cast<const uint2*>(wd + ((4 * kk + (t4 >> 1)) * kBoxCols + c) * 4);
        const uint2 hi = *reinterpret_cast<const uint2*>(wd + ((4 * kk + 2 + (t4 >> 1)) * kBoxCols + c) * 4);
        const int b = 2 * (t4 & 1);
        f[0] = pair8(lo.x, b, 0);
        f[1] = pair8(lo.y, b, 1);
        f[2] = pair8(hi.x, b, 0);
        f[3] = pair8(hi.y, b, 1);
      } else if constexpr (BITS == 4) {
        const uint2 lo = *reinterpret_cast<const uint2*>(wd + ((2 * kk) * kBoxCols + c) * 4);
        const uint2 hi = *reinterpret_cast<const uint2*>(wd + ((2 * kk + 1) * kBoxCols + c) * 4);
        const int sh = 8 * t4;
        f[0] = hsub_hmul(pair_k(lo.x, sh), z2[0], s2[0]);
        f[1] = hsub_hmul(pair_k(lo.y, sh), z2[1], s2[1]);
        f[2] = hsub_hmul(pair_k(hi.x, sh), z2[0], s2[0]);
        f[3] = hsub_hmul(pair_k(hi.y, sh), z2[1], s2[1]);
      } else {
        const uint2 q = *reinterpret_cast<const uint2*>(wd + (kk * kBoxCols + c) * 4);
        const int sh = 4 * t4;
        f[0] = hsub_hmul(pair_k(q.x, sh), z2[0], s2[0]);
        f[1] = hsub_hmul(pair_k(q.y, sh), z2[1], s2[1]);
        f[2] = hsub_hmul(pair_k(q.x, sh + 16), z2[0], s2[0]);
        f[3] = hsub_hmul(pair_k(q.y, sh + 16), z2[1], s2[1]);
      }
    } else {
      // words [kCols / kIpw][kDepth]: rows c, c + 1 of W (codes p, p + 1 of
      // word row c / kIpw) at columns n, n + 1 and n + 8, n + 9 of the step
      const int n = 16 * kk + 2 * t4;
      const unsigned char* row = wd + (c / kIpw) * kDepth * 4;
      const uint2 lo = *reinterpret_cast<const uint2*>(row + n * 4);
      const uint2 hi = *reinterpret_cast<const uint2*>(row + (n + 8) * 4);
      const unsigned char* sp = sbase + (ss(st) - base);
      const int srow = min(group_of(min(o0 + c, K - 1), groupsize, G) -
                               group_of(o0, groupsize, G), sz_rows - 1);
      const uint32_t* s_row = reinterpret_cast<const uint32_t*>(sp + srow * kDepth * 2);
      const uint32_t* z_row = reinterpret_cast<const uint32_t*>(sp + kSZBytes + srow * kDepth * 2);
      const int p = c % kIpw;   // even
      if constexpr (BITS == 8) {
        // (columns n, n + 1) of row c: bytes p of lo.x, lo.y; row c + 1: bytes p + 1
        scale_pair(s_row[n / 2], z_row[n / 2]);
        f[0] = pack_bf16((magic8(lo.x, p) - zf[0]) * sf[0], (magic8(lo.y, p) - zf[1]) * sf[1]);
        f[1] = pack_bf16((magic8(lo.x, p + 1) - zf[0]) * sf[0], (magic8(lo.y, p + 1) - zf[1]) * sf[1]);
        scale_pair(s_row[n / 2 + 4], z_row[n / 2 + 4]);
        f[2] = pack_bf16((magic8(hi.x, p) - zf[0]) * sf[0], (magic8(hi.y, p) - zf[1]) * sf[1]);
        f[3] = pack_bf16((magic8(hi.x, p + 1) - zf[0]) * sf[0], (magic8(hi.y, p + 1) - zf[1]) * sf[1]);
      } else {
        // the byte holding codes p, p + 1 of each word, into the two halves
        constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x00010001u;
        const int byte = p * BITS / 8, sh = (p * BITS) % 8;
        const uint32_t sel = byte | (byte << 4) | ((4 + byte) << 8) | ((4 + byte) << 12);
        const uint32_t bl = __byte_perm(lo.x, lo.y, sel) >> sh;
        const uint32_t bh = __byte_perm(hi.x, hi.y, sel) >> sh;
        const uint32_t sl = s_row[n / 2], zl = zero_128(z_row[n / 2]);
        const uint32_t sh2 = s_row[n / 2 + 4], zh = zero_128(z_row[n / 2 + 4]);
        f[0] = hsub_hmul((bl & kMask) | 0x43004300u, zl, sl);
        f[1] = hsub_hmul(((bl >> BITS) & kMask) | 0x43004300u, zl, sl);
        f[2] = hsub_hmul((bh & kMask) | 0x43004300u, zh, sh2);
        f[3] = hsub_hmul(((bh >> BITS) & kMask) | 0x43004300u, zh, sh2);
      }
    }
  };

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  // the fragments of k16 step kk of stage i % S into a[kk] (kernel 1: the
  // step's group row first)
  auto prep = [&](int i, int kk) {
    const int st = i % S;
    if constexpr (!T) {
      const int r0 = (t_begin + i) * kDepth;
      if (kk == 0 || sz_rows > 1)
        k1_scales(st, group_of(r0 + 16 * kk, groupsize, G) - group_of(r0, groupsize, G));
    }
    build(st, kk, a[kk]);
  };

  // Step s = (stage i, k16 step kk) multiplies fragments a[kk], built while
  // steps s - 2 and s - 1 ran; step s + 1's are built while s - 1 and s run,
  // then the wait for s - 1 frees a[kk - 1 mod 4] for step s + 3 and, at kk
  // = 0, stage i - 1 (its last product done).
  if (t_count > 0) {
    mbar_wait(full(0), 0u);
    prep(0, 0);
  }
  for (int i = 0; i < t_count; ++i) {
    const int st = i % S;
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      wgmma_fence();
      wgmma_rs<0>(acc, a[kk], desc_sw<128>(sx(st) + kk * 32, 16, 1024), 1);
      wgmma_commit();
      if (kk + 1 < kDepth / 16) {
        prep(i, kk + 1);
      } else if (i + 1 < t_count) {
        mbar_wait(full((i + 1) % S), (uint32_t)(((i + 1) / S) & 1));
        prep(i + 1, 0);
      }
      wgmma_wait<1>();   // step s - 1 is done
      fence_regs(a);     // keeps the fragments the products read in their registers
      if (kk == 0 && i > 0) release((i - 1) % S);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);

  // acc[4 j + e] is row g (column c) and acc[4 j + 2 + e] row g + 8 (column
  // c + 1) at x row 8 j + 2 t4 + e
  const int oc = o0 + c;
  if (split > 1) {   // fp32 partials, summed in split order by qmm_reduce_kernel
    if (oc >= O) return;   // O % 8 == 0: the pair is all in or out
    const size_t zw = (size_t)(NW == 2 ? wg : 0) * split + blockIdx.y;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t4 + e;
        if (m < M)
          *reinterpret_cast<float2*>(partial + (zw * M + m) * O + oc) =
              make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
      }
    }
    return;
  }
  if constexpr (NW == 2) {
    // Both warpgroups are past their last product and every copy has landed,
    // so the ring is free: warpgroup 1's up sums go into it, thread t's as
    // float4s at [j][t] (whole 512-byte rows a warp), and thread t of
    // warpgroup 0, which holds the gate sums of the same (row, column)
    // pairs, reads them back. Named barrier 1 joins the 256 consumers.
    float4* xch = reinterpret_cast<float4*>(smem_raw + (base - raw));
    const int ct = tid & 127;
    named_barrier(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
        xch[j * 128 + ct] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_barrier(1, 256);
    if (wg == 1 || oc >= O) return;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float4 u = xch[j * 128 + ct];
      const float up[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t4 + e;
        const float v0[2] = {acc[4 * j + e], up[e]};
        const float v1[2] = {acc[4 * j + 2 + e], up[2 + e]};
        if (m < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)m * O + oc) =
              pack_bf16(gptq::epilogue<2>(v0, nullptr, oc), gptq::epilogue<2>(v1, nullptr, oc + 1));
      }
    }
    return;
  }
  if (oc >= O) return;
  float b0 = 0.0f, b1 = 0.0f;
  if (bias != nullptr) {
    b0 = __bfloat162float(bias[oc]);
    b1 = __bfloat162float(bias[oc + 1]);
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t4 + e;
      if (m < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)m * O + oc) =
            pack_bf16(acc[4 * j + e] + b0, acc[4 * j + 2 + e] + b1);
    }
  }
}

// A 2-D tensor map of a row-major (rows, cols) tensor of `elem` bytes a value,
// box box_cols x box_rows; zero fill past its edges.
inline bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                   int rows, int cols, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  auto encode = [&] {
    return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT && bind_context_of(ptr)) r = encode();
  return r == CUDA_SUCCESS;
}

// One launch (then, with split > 1, the sum of the partials): x (M, R) bf16,
// the packed weight (K * BITS / 32, N), scales and zeros (G, N) (kernel 2:
// w the gate's, w2 the up's, of one shape; kernels 1, 8 ignore w2); out (M,
// O); partial (NW, split, M, O) fp32 when split > 1. Sets the dynamic shared
// memory attribute once per instantiation (not per launch, so a CUDA-graph
// capture sees none). The tensor maps hold the pointers, so a captured
// launch replays over the same buffers.
template <int BITS, int BM, bool T, int NW>
cudaError_t launch(const void* x, gptq::Stream w, gptq::Stream w2, const __nv_bfloat16* bias,
                   __nv_bfloat16* out, float* partial, int M, int K, int N, int G, int groupsize,
                   int split, int per_split, int sz_rows, int smem_bytes, cudaStream_t stream) {
  using L = Layout<BITS, BM>;
  constexpr int kIpw = 32 / BITS;
  const int O = T ? K : N, R = T ? N : K;
  const int n_steps = (R + kDepth - 1) / kDepth;
  // the wrapper's plan computes the same size; a disagreement is a fault
  if (smem_bytes != L::kBytes || M < 1 || K % 8 || N % 8 || K % kIpw || G < 1 ||
      groupsize < 1 || (G > 1 && groupsize % 16) || sz_rows < 1 || sz_rows > sz_rows_max(T) ||
      split < 1 || split > 65535 || per_split < 1 || (long long)split * per_split < n_steps ||
      (M + BM - 1) / BM > 65535 || (split > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  auto kern = qmm_wgmma_kernel<BITS, BM, T, NW>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  constexpr int kWCols = T ? kDepth : kCols / NW;
  // the word, scale and zero maps of one weight
  auto weight_maps = [&](gptq::Stream s, CUtensorMap* mw, CUtensorMap* ms, CUtensorMap* mz) {
    return map_2d(mw, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, s.qweight, K / kIpw, N, kWCols,
                  (T ? kCols : kDepth) / kIpw, CU_TENSOR_MAP_SWIZZLE_NONE) &&
           map_2d(ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, s.scales, G, N, kWCols, sz_rows,
                  CU_TENSOR_MAP_SWIZZLE_NONE) &&
           map_2d(mz, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, s.zeros, G, N, kWCols, sz_rows,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  CUtensorMap tx, tw, ts, tz, tw2, ts2, tz2;
  if (!map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, R, kDepth, BM,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !weight_maps(w, &tw, &ts, &tz) || !weight_maps(NW == 2 ? w2 : w, &tw2, &ts2, &tz2))
    return cudaErrorInvalidValue;
  dim3 grid((O + kCols / NW - 1) / (kCols / NW), split, (M + BM - 1) / BM);
  kern<<<grid, kThreads, L::kBytes, stream>>>(tx, tw, ts, tz, tw2, ts2, tz2, bias, out, partial,
                                              M, K, N, G, groupsize, per_split, sz_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  return gptq::launch_reduce<NW>(partial, T || NW == 2 ? nullptr : bias, out, M, O, split,
                                 stream);
}

// The row tiles BM (64, 128, 144, 256) and bits (2, 4, 8) of one kernel.
template <bool T, int NW>
cudaError_t launch_bits(int bits, int bm, const void* x, gptq::Stream w, gptq::Stream w2,
                        const __nv_bfloat16* bias, __nv_bfloat16* out, float* partial, int M,
                        int K, int N, int G, int groupsize, int split, int per_split,
                        int sz_rows, int smem_bytes, cudaStream_t stream) {
#define GPTQ_WG(B, R)                                                                        \
  launch<B, R, T, NW>(x, w, w2, bias, out, partial, M, K, N, G, groupsize, split, per_split,  \
                      sz_rows, smem_bytes, stream)
#define GPTQ_WGS(B)                                                                          \
  (bm == 64 ? GPTQ_WG(B, 64) : bm == 128 ? GPTQ_WG(B, 128) : bm == 144 ? GPTQ_WG(B, 144)   \
             : bm == 256 ? GPTQ_WG(B, 256) : cudaErrorInvalidValue)
  switch (bits) {
    case 2: return GPTQ_WGS(2);
    case 4: return GPTQ_WGS(4);
    case 8: return GPTQ_WGS(8);
    default: return cudaErrorInvalidValue;
  }
#undef GPTQ_WGS
#undef GPTQ_WG
}

}  // namespace gptq_wg
