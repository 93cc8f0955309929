// Decode-width GEMV of the dequant-GEMM: y = x @ dequant(W) (+ bias) with one
// weight stream (kernel 1, qmm.cu) and silu(x @ dequant(Wg)) * (x @
// dequant(Wu)) with two (kernel 2, fused_mlp.cu), on CUDA cores with fp32
// sums: kernel 2's batch-1 decode row, and any row count whose group size
// or shape the other forms do not take (kernel 1's fragments beat it from
// M = 1).
//
// Replaces, with qmm_frag.cuh and qmm_tc.cuh, the TPU kernels
// gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel and
// gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel.
//
// What bounds it on the H100: the packed weight bytes (a 4096 x 4096
// INT4-g128 linear moves 8.9 MB with its scales and zeros: 2.66 us at 3.35
// TB/s), but a call is so short that each SM sees only a few microseconds of
// traffic, so the latency of the first bytes and the launches count as much.
// The design:
//  - one block of 8 warps per 128 columns (4 a lane, one 16-byte word load
//    per packed row); the wrapper splits K across the C blocks of a thread
//    block cluster (C <= 16, ops/cuda/matmul.py:plan) so that a 4096-wide
//    output still puts two blocks on every SM; each warp takes a consecutive
//    run of the block's packed words;
//  - nothing runs before the weight loads: each warp fills an 8-stage (4
//    with two streams) cp.async ring of its own words first, then copies x.
//    Every stage carries what the word needs: at a group's first word the
//    lanes' scales and zeros, and the word's rows of x (lanes 0..MT-1 copy
//    one row each, 16-byte copies at 2 and 4 bits), so no block barrier, x
//    prologue or dependent scale load comes before the first product; a
//    lane reads back its own words and scales, and x after a __syncwarp;
//  - dot-then-scale (the TPU kernel's trick): codes become floats with one OR
//    and one FADD (2^23 magic number) and are dotted with x per group; the
//    affine correction s_g * (x_g . c_g - z_g * sum(x_g)) is applied once per
//    group and column;
//  - where the group size is not a multiple of 32 / BITS a group boundary
//    falls inside a word: that word is summed row by row and each new
//    group's scales and zeros come from device memory;
//  - one launch: the 8 warps' sums meet in shared memory in warp order, then
//    the cluster's blocks add their partials in rank order over distributed
//    shared memory (gptq::cluster_reduce), each block finishing 128 / C
//    columns with the epilogue: no second kernel, no atomics, and the same
//    bytes on every launch and every CUDA-graph replay.
#pragma once

#include <cuda_bf16.h>
#include <limits.h>

#include "mma_sync.cuh"
#include "qmm_common.cuh"

namespace gptq_gemv {

using namespace gptq_mma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;              // columns per lane: one 16-byte word load
constexpr int kTileN = 32 * kCols;    // columns per block

// One warp's ring stage: every lane's words (16 B a stream), every lane's
// scales and zeros (8 + 8 B a stream, copied at a group's first word only),
// then MT rows of x over the word's 32 / BITS rows. After the main loop the
// ring holds the warps' sums (red); the buffer that receives the cluster's
// partials of this block's share of the outputs (recv) follows it.
template <int BITS, int MT, int NW>
struct Layout {
  static constexpr int kIpw = 32 / BITS;                 // rows of K per word
  static constexpr int kStages = NW == 1 ? 8 : 4;
  static constexpr int kXB = 2 * kIpw;                   // bytes of x per row and word
  static constexpr int kW = NW * 32 * 16;
  static constexpr int kSZ = NW * 32 * 16;
  static constexpr int kX = (MT * kXB + 15) / 16 * 16;
  static constexpr int kStage = kW + kSZ + kX;
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kRed = kWarps * NW * MT * kTileN * 4;
  static constexpr int kRecv = gptq::cluster_recv_floats(NW, MT * kTileN) * 4;
  static constexpr int kBytes = (kRing > kRed ? kRing : kRed) + kRecv;
};

// grid: (ceil(N / kTileN), split, ceil(M / MT)), clusters of 1 x split x 1;
// block: kThreads; dynamic shared memory Layout<BITS, MT, NW>::kBytes. Block
// (x, z) of cluster rank y sums packed words [y * words_per_split, ...).
template <int BITS, int MT, int NW>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __nv_bfloat16* __restrict__ x, gptq::Stream s0, gptq::Stream s1,
            const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
            int K, int N, int G, int groupsize, int words_per_split) {
  using L = Layout<BITS, MT, NW>;
  constexpr int kIpw = L::kIpw, S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kw = K / kIpw;
  const int w_begin = blockIdx.y * words_per_split;
  const int w_end = min(kw, w_begin + words_per_split);
  const int per_warp = (max(0, w_end - w_begin) + kWarps - 1) / kWarps;
  const int wa = w_begin + warp * per_warp;
  const int n_words = max(0, min(w_end, wa + per_warp) - wa);
  const int m0 = blockIdx.z * MT;
  const int col = blockIdx.x * kTileN + lane * kCols;
  const bool valid = col < N;                    // N % 4 == 0: all 4 columns or none
  const bool aligned = groupsize % kIpw == 0;    // every word inside one group

  unsigned char* ring = smem + warp * S * L::kStage;
  auto stage_of = [&](int i) { return ring + (i % S) * L::kStage; };
  // the stage of word i carries scales and zeros: the warp's first word, or
  // a group's first word
  const int words_per_group = groupsize / kIpw;
  auto has_sz = [&](int i) { return aligned && (i == 0 || gptq::run_start(wa + i, words_per_group)); };

  // word i's weights (and scales)
  auto issue_w = [&](int i) {
    unsigned char* st = stage_of(i);
    const int wd = wa + i;
    const size_t wo = valid ? (size_t)wd * N + col : 0;
    cp_async16(st + lane * 16, s0.qweight + wo, valid);
    if constexpr (NW == 2) cp_async16(st + (32 + lane) * 16, s1.qweight + wo, valid);
    if (has_sz(i)) {
      const int g = min(wd * kIpw / groupsize, G - 1);
      const size_t so = valid ? (size_t)g * N + col : 0;
      unsigned char* sz = st + L::kW + lane * 16;
      cp_async8(sz, s0.scales + so, valid);
      cp_async8(sz + 8, s0.zeros + so, valid);
      if constexpr (NW == 2) {
        cp_async8(sz + 32 * 16, s1.scales + so, valid);
        cp_async8(sz + 32 * 16 + 8, s1.zeros + so, valid);
      }
    }
  };
  // word i's rows of x
  auto issue_x = [&](int i) {
    unsigned char* st = stage_of(i);
    const int wd = wa + i;
    if (lane < MT) {   // lane m copies row m0 + m of x over the word's rows
      const bool ok = m0 + lane < M;
      const __nv_bfloat16* src = x + (ok ? (size_t)(m0 + lane) * K + (size_t)wd * kIpw : 0);
      unsigned char* dst = st + L::kW + L::kSZ + lane * L::kXB;
      if constexpr (L::kXB == 8) {
        cp_async8(dst, src, ok);
      } else {
#pragma unroll
        for (int c = 0; c < L::kXB; c += 16) cp_async16(dst + c, src + c / 2, ok);
      }
    }
  };

  float acc[NW][MT][kCols];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[w][m][c] = 0.0f;

  float p[NW][MT][kCols];   // x . codes over the current group segment
  float sx[MT];             // sum of x over the current group segment
  float sc[NW][kCols], zz[NW][kCols];   // the current group's scales and zeros
  int cur_g = -1;
  int next_b = 0;           // first row of the group after cur_g

  auto flush = [&]() {
    if (cur_g < 0) return;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[w][m][c] += sc[w][c] * (p[w][m][c] - zz[w][c] * sx[m]);
  };
  // group g starts; its scales and zeros from the stage st, else (st null)
  // from device memory
  auto start_group = [&](int g, const unsigned char* st) {
    cur_g = g;
    next_b = (g >= G - 1) ? INT_MAX : (g + 1) * groupsize;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) p[w][m][c] = 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) sx[m] = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (st != nullptr) {   // zero-filled for columns past N
        const uint4 v = *reinterpret_cast<const uint4*>(st + L::kW + (w * 32 + lane) * 16);
        gptq::bf16x4_f(make_uint2(v.x, v.y), sc[w]);
        gptq::bf16x4_f(make_uint2(v.z, v.w), zz[w]);
      } else if (valid) {   // pointers picked by value: no stream in local memory
        gptq::load_bf16x4((w == 0 ? s0.scales : s1.scales) + (size_t)g * N + col, sc[w]);
        gptq::load_bf16x4((w == 0 ? s0.zeros : s1.zeros) + (size_t)g * N + col, zz[w]);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[w][c] = zz[w][c] = 0.0f;
      }
    }
  };

  // packed word wd (kCols columns per stream) of stage st into the group sums
  auto word = [&](int wd, const uint32_t (&q)[NW][kCols], const unsigned char* st) {
    const int r0 = wd * kIpw;
    const unsigned char* xs = st + L::kW + L::kSZ;   // [MT][kIpw] bf16
    if (cur_g < 0 || r0 + kIpw > next_b) {
      const int g0 = min(r0 / groupsize, G - 1);
      const int end0 = (g0 >= G - 1) ? INT_MAX : (g0 + 1) * groupsize;
      if (r0 + kIpw > end0) {
        // a group boundary falls inside this word (groupsize not a multiple
        // of 32/BITS): accumulate row by row, flushing at each boundary
        const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(xs);
#pragma unroll
        for (int j = 0; j < kIpw; ++j) {
          const int r = r0 + j;
          if (cur_g < 0 || r >= next_b) {
            flush();
            start_group(min(r / groupsize, G - 1), nullptr);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = __bfloat162float(xr[m * kIpw + j]);
            sx[m] += xv;
#pragma unroll
            for (int w = 0; w < NW; ++w)
#pragma unroll
              for (int c = 0; c < kCols; ++c) p[w][m][c] += xv * gptq::code_f<BITS>(q[w][c], j);
          }
        }
        return;
      }
      if (g0 != cur_g) {
        flush();
        start_group(g0, aligned ? st : nullptr);
      }
    }
#pragma unroll
    for (int j4 = 0; j4 < kIpw; j4 += 4) {
      float xv[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        gptq::bf16x4_f(*reinterpret_cast<const uint2*>(xs + m * L::kXB + j4 * 2), xv[m]);
        sx[m] += (xv[m][0] + xv[m][1]) + (xv[m][2] + xv[m][3]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float cf = gptq::code_f<BITS>(q[w][c], j4 + jj);
#pragma unroll
            for (int m = 0; m < MT; ++m) p[w][m][c] += xv[m][jj] * cf;
          }
      }
    }
  };

  // the ring's first S stages: every stage's weights, then (one group a
  // stage) x; stage i is complete once at most S - 1 newer groups are
  // pending, in the prologue as in the loop
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < n_words) issue_w(i);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < n_words) issue_x(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_words; ++i) {
    cp_async_wait<S - 1>();
    __syncwarp();   // every lane's copies of word i landed (x is read by all)
    const unsigned char* st = stage_of(i);
    uint32_t q[NW][kCols];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint4 a = *reinterpret_cast<const uint4*>(st + (w * 32 + lane) * 16);
      q[w][0] = a.x; q[w][1] = a.y; q[w][2] = a.z; q[w][3] = a.w;
    }
    word(wa + i, q, st);
    __syncwarp();   // every lane is done with the stage
    if (i + S < n_words) {
      issue_w(i + S);
      issue_x(i + S);
    }
    cp_async_commit();
  }
  flush();
  cp_async_wait_all();
  __syncthreads();   // every warp is done with its ring

  // the 8 warps' sums through shared memory, added in warp order
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][NW][MT][kTileN]
  float* recv = reinterpret_cast<float*>(smem + (L::kRing > L::kRed ? L::kRing : L::kRed));
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      *reinterpret_cast<float4*>(red + ((warp * NW + w) * MT + m) * kTileN + lane * kCols) =
          make_float4(acc[w][m][0], acc[w][m][1], acc[w][m][2], acc[w][m][3]);
  __syncthreads();
  constexpr int kOuts = MT * kTileN;
  gptq::cluster_reduce<NW>(
      recv, kOuts,
      [&](int w, int o) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) t += red[(k * NW + w) * kOuts + o];
        return t;
      },
      [&](int o, const float (&v)[NW]) {
        const int m = o / kTileN, n = blockIdx.x * kTileN + o % kTileN;
        if (m0 + m < M && n < N)
          out[(size_t)(m0 + m) * N + n] = __float2bfloat16_rn(gptq::epilogue<NW>(v, bias, n));
      });
}

template <int BITS, int MT, int NW>
cudaError_t launch_mt(const __nv_bfloat16* x, gptq::Stream s0, gptq::Stream s1,
                      const __nv_bfloat16* bias, __nv_bfloat16* out, int M, int K, int N, int G,
                      int groupsize, int split, int words_per_split, int smem_bytes,
                      cudaStream_t stream) {
  using L = Layout<BITS, MT, NW>;
  // the wrapper's plan computes the same size; a disagreement is a fault
  if (smem_bytes != L::kBytes) return cudaErrorInvalidValue;
  auto kern = gemv_kernel<BITS, MT, NW>;
  static const cudaError_t attr = gptq::cluster_attributes(kern, L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kTileN - 1) / kTileN, split, (M + MT - 1) / MT);
  return gptq::launch_cluster(kern, grid, kThreads, split, L::kBytes, stream, x, s0, s1, bias,
                              out, M, K, N, G, groupsize, words_per_split);
}

// x (M, K) bf16; qweights (K * bits / 32, N) int32 with N % 4 == 0; scales,
// zeros (G, N) bf16; mt: rows per block (1, 2, 4, 8); split: blocks along K,
// one cluster (1, 2, 4, 8 or 16); smem_bytes: the plan's size.
template <int NW>
cudaError_t launch(int bits, int mt, const __nv_bfloat16* x, gptq::Stream s0, gptq::Stream s1,
                   const __nv_bfloat16* bias, __nv_bfloat16* out, int M, int K, int N, int G,
                   int groupsize, int split, int words_per_split, int smem_bytes,
                   cudaStream_t stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || M < 1 || K < 1 || N < 4 || N % 4 || G < 1 ||
      groupsize < 1 || K % (32 / bits) ||
      (split & (split - 1)) || split < 1 || split > 16 || words_per_split < 1 ||
      (long long)split * words_per_split < K / (32 / bits) || (M + mt - 1) / mt > 65535)
    return cudaErrorInvalidValue;
#define GPTQ_GEMV(B, T)                                                                    \
  launch_mt<B, T, NW>(x, s0, s1, bias, out, M, K, N, G, groupsize, split, words_per_split, \
                      smem_bytes, stream)
#define GPTQ_GEMV_MT(B)                                                                    \
  (mt == 1 ? GPTQ_GEMV(B, 1) : mt == 2 ? GPTQ_GEMV(B, 2) : mt == 4 ? GPTQ_GEMV(B, 4)         \
   : mt == 8 ? GPTQ_GEMV(B, 8) : cudaErrorInvalidValue)
  cudaError_t e;
  switch (bits) {
    case 2: e = GPTQ_GEMV_MT(2); break;
    case 4: e = GPTQ_GEMV_MT(4); break;
    case 8: e = GPTQ_GEMV_MT(8); break;
    default: e = cudaErrorInvalidValue;
  }
#undef GPTQ_GEMV_MT
#undef GPTQ_GEMV
  return e;
}

}  // namespace gptq_gemv
