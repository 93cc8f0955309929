// Small-M form of the dequant-GEMM on bf16 mma.sync with fp32 sums, for
// M <= 16 (kernel 1's batch-1 decode row, both kernels' serving decode step
// of 8 slots): kernel 2, the fused gate/up MLP
// y = silu(x @ dequant(Wg)) * (x @ dequant(Wu)) (NW = 2, fused_mlp.cu), and
// kernel 1, y = x @ dequant(W) (+ bias) (NW = 1, qmm.cu).
//
// Replaces, with the GEMV of qmm_gemv.cuh and the tiles of qmm_tc.cuh, the
// TPU kernels gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel and
// gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel.
//
// What bounds it on the H100: the packed weight streams (45 MB at
// 4096 x 11008 INT4-g128 for kernel 2: 13.4 us at 3.35 TB/s), and next to
// them the dequantization, one weight per multiply-add of each of the M rows.
// The tiles of qmm_tc.cuh stage a 64-row slab as bf16 in shared memory, which
// costs a store, a barrier and an ldmatrix per weight that 8 rows of x do not
// pay back. So this form never writes a weight to shared memory:
//  - the product is taken transposed, y^T = W^T x^T: the weight is the A
//    operand of mma.m16n8k16 and x the B operand (8 columns = 8 rows of x;
//    two n8 tiles for M <= 16), so no tensor-core row is padding at M = 8.
//    The 16 A rows are 8 gate and 8 up columns (NW = 2), or 16 columns of
//    the one weight (NW = 1: a lane's two 16-byte words are columns c..c+3
//    and c+4..c+7, the second "stream" is the first shifted by 4 columns);
//  - each lane dequantizes its own A fragments in registers from the packed
//    words it copied: lane (g, t) owns word-row t of every K-block of 4
//    word-rows (128 / BITS rows of K) for 4 columns of each stream. The
//    product sums over K, so the rows a lane puts in its fragment slots may
//    come in any order, as long as x's fragment takes the same order: a
//    lane's pair of bf16 is the two codes one lop3 puts in a bf16x2
//    (codes j and j + R / 2 of a word of R codes), and x's pair is built to
//    match with one byte permute;
//  - dequantization as the plain version rounds it: 2 and 4 bits place two
//    codes in the mantissas of a bf16x2 of 128 + c (lop3), subtract 128 + z
//    (exact) and multiply by the scale (one rounding: (c - z) * s is exact in
//    fp32, as in PackedLinear.dequantize); 8 bits do the same in fp32 through
//    the 2^23 magic number and round the pair once;
//  - no block barrier in the main loop: each warp streams its own run of
//    K-blocks through a 3-stage cp.async ring of its own (the packed words,
//    x's rows and, at a group's first K-block, its scales and zeros; the
//    first stages' words go out before any x). Every lane reads back what it
//    copied itself (the scales after a __syncwarp); a block's 8 warps take
//    consecutive runs of K for the same columns and meet once, in a
//    shared-memory sum in warp order;
//  - where the columns alone do not fill the card the plan splits K across
//    the blocks of a thread block cluster: their partials meet over
//    distributed shared memory in rank order (gptq::cluster_reduce), each
//    block finishing a share of the columns with the epilogue (the SiLU-mul,
//    or the bias), in the same launch.
// It needs every K-block inside one group (groupsize % (128 / BITS) == 0);
// the wrapper's plan sends other group sizes to the GEMV.
#pragma once

#include <cuda_bf16.h>

#include "mma_sync.cuh"
#include "qmm_common.cuh"

namespace gptq_frag {

using namespace gptq_mma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;        // lane-group columns per block: 4 per lane group and stream
constexpr int kStages = 3;
constexpr int kSZBytes = 8 * 4 * 8;   // per lane group: gate s, gate z, up s, up z (4 bf16 each)

// One warp's ring stage: each lane's two words (16 B each), then NT slices
// of x (this lane's row g + 8 nt, its R rows of K), then the scales. After
// the main loop the ring holds the warps' sums (red); the buffer that
// receives the cluster's partials of this block's share (recv) follows it.
template <int BITS, int NT>
struct Layout {
  static constexpr int kR = 32 / BITS;        // rows of K per word
  static constexpr int kKB = 4 * kR;          // rows of K per K-block (4 word-rows)
  static constexpr int kXB = 2 * kR;          // bytes of x per lane and n8 tile
  static constexpr int kW = 32 * 32;
  static constexpr int kX = NT * 32 * kXB;
  static constexpr int kStage = kW + kX + kSZBytes;
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kOuts = 8 * NT * kCols;                  // rows of x x lane-group columns
  static constexpr int kRed = kWarps * 2 * kOuts * 4;
  static constexpr int kRecv = gptq::cluster_recv_floats(2, kOuts) * 4;
  static constexpr int kBytes = (kRing > kRed ? kRing : kRed) + kRecv;
};

__device__ __forceinline__ uint32_t bf2_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 u32_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// A column's scale and zero in the form the dequantization takes them.
template <int BITS>
struct Affine {
  // 2 / 4 bits: bf16x2 (s, s) and (128 + z, 128 + z); 8 bits: s and 2^23 + z
  uint32_t s2, z2;
  float sf, zf;
};

template <int BITS>
__device__ __forceinline__ Affine<BITS> affine(__nv_bfloat16 s, __nv_bfloat16 z) {
  Affine<BITS> a;
  if constexpr (BITS == 8) {
    a.sf = __bfloat162float(s);
    a.zf = 8388608.0f + __bfloat162float(z);
    a.s2 = a.z2 = 0u;
  } else {
    a.s2 = bf2_u32(__halves2bfloat162(s, s));
    const __nv_bfloat16 zz = __float2bfloat16_rn(128.0f + __bfloat162float(z));   // exact
    a.z2 = bf2_u32(__halves2bfloat162(zz, zz));
    a.sf = a.zf = 0.0f;
  }
  return a;
}

// The dequantized bf16 pair p of word q: for 2 / 4 bits the codes p and
// p + R / 2, for 8 bits codes 2p and 2p + 1.
template <int BITS>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t q, int p, const Affine<BITS>& a) {
  if constexpr (BITS == 8) {
    const float c0 = __int_as_float(__byte_perm(q, 0x4B000000u, 0x7540 | (2 * p)));
    const float c1 = __int_as_float(__byte_perm(q, 0x4B000000u, 0x7540 | (2 * p + 1)));
    return pack_bf16((c0 - a.zf) * a.sf, (c1 - a.zf) * a.sf);
  } else {
    constexpr uint32_t kMask = BITS == 4 ? 0x000F000Fu : 0x00030003u;
    const uint32_t v = ((q >> (BITS * p)) & kMask) | 0x43004300u;   // 128 + c, exact
    return bf2_u32(__hmul2(__hsub2(u32_bf2(v), u32_bf2(a.z2)), u32_bf2(a.s2)));
  }
}

// x's B fragment of step s from a lane's R values of x (xw[i] = rows 2i,
// 2i + 1): the rows the A fragment's pairs 2s and 2s + 1 hold.
template <int BITS>
__device__ __forceinline__ void x_frag(const uint32_t* xw, int s, uint32_t& b0, uint32_t& b1) {
  if constexpr (BITS == 8) {
    b0 = xw[0];
    b1 = xw[1];
  } else {
    constexpr int kR = 32 / BITS;
    b0 = __byte_perm(xw[s], xw[s + kR / 4], 0x5410);   // rows 2s, 2s + R / 2
    b1 = __byte_perm(xw[s], xw[s + kR / 4], 0x7632);   // rows 2s + 1, 2s + 1 + R / 2
  }
}

// grid: (ceil(N / (kCols * (3 - NW))), split), clusters of 1 x split x 1;
// block: kThreads; dynamic shared memory Layout<BITS, NT>::kBytes. Block
// (x, y) of cluster rank y takes K-blocks [y * kb_per_split, ...). NW = 2:
// streams sa (gate) and sb (up), 32 columns of y a block, out = silu(a) * b;
// NW = 1: sa = sb, 64 columns of y a block, out = a (+ bias).
template <int BITS, int NT, int NW>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 3 : 2)
frag_kernel(const __nv_bfloat16* __restrict__ x, gptq::Stream sa, gptq::Stream sb,
            const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int K,
            int N, int G, int groupsize, int kb_per_split) {
  using L = Layout<BITS, NT>;
  constexpr int kR = L::kR, kSteps = kR / 4;
  constexpr int kBlockCols = NW == 2 ? kCols : 2 * kCols;   // columns of y per block
  static_assert(kSteps >= 1, "bits");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockCols;
  // this lane's 4 columns of each stream (A rows g and g + 8)
  const int col_a = n0 + (NW == 2 ? 4 * g : 8 * g);
  const int col_b = NW == 2 ? col_a : col_a + 4;
  const bool col_ok = col_a < N;                         // N % 8 == 0: all or none
  const int kw = K / kR;
  const int nkb = (K + L::kKB - 1) / L::kKB;
  const int b_begin = blockIdx.y * kb_per_split;
  const int b_end = min(nkb, b_begin + kb_per_split);
  const int per_warp = (max(0, b_end - b_begin) + kWarps - 1) / kWarps;
  const int w_begin = b_begin + warp * per_warp;
  const int n_kb = max(0, min(b_end, w_begin + per_warp) - w_begin);

  unsigned char* ring = smem + warp * kStages * L::kStage;
  auto stage_of = [&](int i) { return ring + (i % kStages) * L::kStage; };
  // a K-block whose scales the stage carries: the warp's first, or a group's first
  const int kb_per_group = groupsize / L::kKB;
  auto new_group = [&](int i) { return i == 0 || gptq::run_start(w_begin + i, kb_per_group); };

  // K-block i's weights and scales
  auto issue_w = [&](int i) {
    unsigned char* st = stage_of(i);
    const int k0 = (w_begin + i) * L::kKB;
    const int wr = k0 / kR + t;
    const bool ok = wr < kw && col_ok;
    const size_t wo = ok ? (size_t)wr * N : 0;
    cp_async16(st + lane * 32, sa.qweight + wo + (ok ? col_a : 0), ok);
    cp_async16(st + lane * 32 + 16, sb.qweight + wo + (ok ? col_b : 0), ok);
    if (new_group(i)) {   // lane t of a group copies item t of its 4 columns
      const int gi = min(k0 / groupsize, G - 1);
      const __nv_bfloat16* src = t == 0 ? sa.scales : t == 1 ? sa.zeros
                                 : t == 2 ? sb.scales : sb.zeros;
      cp_async8(st + L::kW + L::kX + (g * 4 + t) * 8,
                src + (col_ok ? (size_t)gi * N + (t < 2 ? col_a : col_b) : 0), col_ok);
    }
  };
  // K-block i's rows of x
  auto issue_x = [&](int i) {
    unsigned char* st = stage_of(i);
    const int wr = (w_begin + i) * L::kKB / kR + t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = g + 8 * nt;
      const bool xok = m < M && wr < kw;
      const __nv_bfloat16* src = x + (xok ? (size_t)m * K + (size_t)wr * kR : 0);
      unsigned char* dst = st + L::kW + (nt * 32 + lane) * L::kXB;
      if constexpr (L::kXB == 8) {
        cp_async8(dst, src, xok);
      } else {
#pragma unroll
        for (int c = 0; c < L::kXB; c += 16) cp_async16(dst + c, src + c / 2, xok);
      }
    }
  };

  // acc[j][nt]: the m16n8 tile of column pair j (row g: stream sa's column
  // col_a + j, row g + 8: stream sb's column col_b + j) by rows 8 nt .. 8 nt + 7
  // of x
  float acc[4][NT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.0f;
  Affine<BITS> ag[4], au[4];

  // the ring's first stages: every stage's weights, then (one group a stage)
  // x; stage i is complete once at most kStages - 1 newer groups are
  // pending, in the prologue as in the loop
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_kb) issue_w(i);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_kb) issue_x(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_kb; ++i) {
    cp_async_wait<kStages - 1>();
    __syncwarp();   // every lane's copies of K-block i landed
    const unsigned char* st = stage_of(i);
    if (new_group(i)) {
      const uint2* sz = reinterpret_cast<const uint2*>(st + L::kW + L::kX + g * 32);
      const uint2 gs = sz[0], gz = sz[1], us = sz[2], uz = sz[3];
      const __nv_bfloat16* gsp = reinterpret_cast<const __nv_bfloat16*>(&gs);
      const __nv_bfloat16* gzp = reinterpret_cast<const __nv_bfloat16*>(&gz);
      const __nv_bfloat16* usp = reinterpret_cast<const __nv_bfloat16*>(&us);
      const __nv_bfloat16* uzp = reinterpret_cast<const __nv_bfloat16*>(&uz);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ag[j] = affine<BITS>(gsp[j], gzp[j]);
        au[j] = affine<BITS>(usp[j], uzp[j]);
      }
    }
    const uint4 wg = *reinterpret_cast<const uint4*>(st + lane * 32);
    const uint4 wu = *reinterpret_cast<const uint4*>(st + lane * 32 + 16);
    uint32_t xw[NT][kR / 2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* xs = reinterpret_cast<const uint32_t*>(st + L::kW + (nt * 32 + lane) * L::kXB);
#pragma unroll
      for (int c = 0; c < kR / 2; ++c) xw[nt][c] = xs[c];
    }
    const uint32_t qg[4] = {wg.x, wg.y, wg.z, wg.w};
    const uint32_t qu[4] = {wu.x, wu.y, wu.z, wu.w};
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) x_frag<BITS>(xw[nt], s, b[nt][0], b[nt][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {dequant_pair<BITS>(qg[j], 2 * s, ag[j]),
                               dequant_pair<BITS>(qu[j], 2 * s, au[j]),
                               dequant_pair<BITS>(qg[j], 2 * s + 1, ag[j]),
                               dequant_pair<BITS>(qu[j], 2 * s + 1, au[j])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16816(acc[j][nt], a, b[nt][0], b[nt][1]);
      }
    }
    __syncwarp();   // every lane is done with stage i
    if (i + kStages < n_kb) {
      issue_w(i + kStages);
      issue_x(i + kStages);
    }
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();   // every warp is done with its ring

  // red[warp][stream][row of x][lane-group column]: the warps' sums, added
  // in warp order, then across the cluster
  float* red = reinterpret_cast<float*>(smem);
  float* recv = reinterpret_cast<float*>(smem + (L::kRing > L::kRed ? L::kRing : L::kRed));
  constexpr int kRows = 8 * NT;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = e >> 1, m = 8 * nt + 2 * t + (e & 1);
        red[((warp * 2 + w) * kRows + m) * kCols + 4 * g + j] = acc[j][nt][e];
      }
  __syncthreads();
  // i = (stream, row, lane-group column): the block's sum of the 8 warps
  auto warp_sum = [&](int i) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += red[k * 2 * L::kOuts + i];
    return sum;
  };
  if constexpr (NW == 2) {   // output o = (row, column): gate and up sums
    gptq::cluster_reduce<2>(
        recv, L::kOuts, [&](int w, int o) { return warp_sum(w * L::kOuts + o); },
        [&](int o, const float (&v)[2]) {
          const int m = o / kCols, n = n0 + o % kCols;
          if (m < M && n < N)
            out[(size_t)m * N + n] = __float2bfloat16_rn(gptq::epilogue<2>(v, nullptr, n));
        });
  } else {   // output o = (half w, row, lane-group column c): column n0 + 8 (c / 4) + 4 w + c % 4
    gptq::cluster_reduce<1>(
        recv, 2 * L::kOuts, [&](int, int o) { return warp_sum(o); },
        [&](int o, const float (&v)[1]) {
          const int w = o / L::kOuts, m = (o % L::kOuts) / kCols, c = o % kCols;
          const int n = n0 + 8 * (c >> 2) + 4 * w + (c & 3);
          if (m < M && n < N)
            out[(size_t)m * N + n] = __float2bfloat16_rn(gptq::epilogue<1>(v, bias, n));
        });
  }
}

template <int BITS, int NT, int NW>
cudaError_t launch(const __nv_bfloat16* x, gptq::Stream a, gptq::Stream b,
                   const __nv_bfloat16* bias, __nv_bfloat16* out, int M, int K, int N, int G,
                   int groupsize, int split, int kb_per_split, int smem_bytes,
                   cudaStream_t stream) {
  using L = Layout<BITS, NT>;
  // the wrapper's plan computes the same size; a disagreement is a fault
  if (smem_bytes != L::kBytes || groupsize % L::kKB != 0 || (split & (split - 1)) ||
      split > 16 || (long long)split * kb_per_split < (K + L::kKB - 1) / L::kKB)
    return cudaErrorInvalidValue;
  auto kern = frag_kernel<BITS, NT, NW>;
  static const cudaError_t attr = gptq::cluster_attributes(kern, L::kBytes);
  if (attr != cudaSuccess) return attr;
  constexpr int kBlockCols = NW == 2 ? kCols : 2 * kCols;
  dim3 grid((N + kBlockCols - 1) / kBlockCols, split);
  return gptq::launch_cluster(kern, grid, kThreads, split, L::kBytes, stream, x, a, b, bias, out,
                              M, K, N, G, groupsize, kb_per_split);
}

// x (M, K) bf16, M <= 8 * nt, K % 8 == 0; qweights (K * bits / 32, N) int32
// with N % 8 == 0; scales, zeros (G, N) bf16 with groupsize a multiple of
// 128 / bits; nt: n8 tiles of rows (1 or 2); split: blocks along K, one
// cluster (1, 2, 4, 8 or 16); kb_per_split: K-blocks of 128 / bits rows per
// split; smem_bytes: the plan's size.
template <int NW>
cudaError_t launch_bits(int bits, int nt, const __nv_bfloat16* x, gptq::Stream a, gptq::Stream b,
                        const __nv_bfloat16* bias, __nv_bfloat16* out, int M, int K, int N, int G,
                        int groupsize, int split, int kb_per_split, int smem_bytes,
                        cudaStream_t stream) {
  if (M < 1 || M > 8 * nt || K < 8 || K % 8 || N < 8 || N % 8 || G < 1 || groupsize < 1 ||
      split < 1 || kb_per_split < 1 || (nt != 1 && nt != 2))
    return cudaErrorInvalidValue;
#define GPTQ_FRAG(B, T)                                                                     \
  launch<B, T, NW>(x, a, b, bias, out, M, K, N, G, groupsize, split, kb_per_split, smem_bytes, \
                   stream)
  cudaError_t e;
  switch (bits) {
    case 2: e = nt == 1 ? GPTQ_FRAG(2, 1) : GPTQ_FRAG(2, 2); break;
    case 4: e = nt == 1 ? GPTQ_FRAG(4, 1) : GPTQ_FRAG(4, 2); break;
    case 8: e = nt == 1 ? GPTQ_FRAG(8, 1) : GPTQ_FRAG(8, 2); break;
    default: e = cudaErrorInvalidValue;
  }
#undef GPTQ_FRAG
  return e;
}

}  // namespace gptq_frag
