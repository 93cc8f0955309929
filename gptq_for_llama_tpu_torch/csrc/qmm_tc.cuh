// Tensor-core tile path of the dequant-GEMM (kernel 1 above the decode rows):
// y = x @ dequant(W) (+ bias) for M > 16, on bf16 mma.sync with fp32 sums;
// with two weight streams, kernel 2's fused gate/up above M = 16 (NW below).
//
// Replaces, with the GEMV of qmm_gemv.cuh and the fragments of qmm_frag.cuh,
// the TPU kernel gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel. Those
// take the decode rows (M <= 16), where the packed weight bytes bound the
// work; this path takes every M above, up to where operations bound it: at
// M = 1024 a 4096 x 4096 linear is 34.4 GFLOP (34.7 us at 989 TFLOP/s)
// against 7.5 us of bytes.
//
// Design:
//  - one block of 8 warps per BM x 128 tile of y (BM = 64, 128 or 256, the
//    wrapper's plan picks it from M); each warp owns a 32 x 32, 32 x 64 or
//    64 x 64 piece of it;
//  - the block walks K in slabs of 64 rows through a ring of cp.async stages:
//    x's BM x 64 bf16 tile, the slab's packed words (64 * BITS / 32 rows x
//    128 int32) and the scale and zero rows of the groups the slab touches;
//  - the block dequantizes a slab's words into a bf16 B tile in shared
//    memory, laid out [column][row] so that one word (32 / BITS rows of one
//    column) becomes one 16-byte store: c * s - z * s in fp32, rounded once,
//    which is bit-equal to PackedLinear.dequantize(torch.bfloat16) (both
//    products are exact in fp32), as qmm_t.cu does;
//  - two B tiles: slab t + 1 is dequantized while slab t's products run, so
//    one barrier per slab orders both; where the slab lies in one group (any
//    group size that is a multiple of 64) its scale and zero are read once
//    and the dequantization is spread between the k16 steps of the products;
//  - every row looks up its own group (min(r / groupsize, G - 1)), so a group
//    boundary inside a word (groupsize 40 at 2 bits), a ragged last group and
//    G = 1 all work; a slab that touches more than kMaxGroups groups (a group
//    size below 22) reads its scales and zeros from device memory instead;
//  - products: ldmatrix and mma.sync.m16n8k16 bf16 (mma_sync.cuh);
//  - epilogue: the bias, then a bf16 store; or, when the plan splits K
//    across blocks (too few tiles to fill the card, e.g. M = 100-136 at
//    N = 4096), fp32 partials that qmm_reduce_kernel sums in a fixed order.
// NW weight streams share x. NW = 2 is kernel 2's fused gate/up form
// (fused_mlp.cu): the block's 128 B-tile columns are 64 gate and 64 up
// columns, interleaved by n8 fragment (fragment 2p of a warp is gate columns
// c..c+7, fragment 2p + 1 up columns c..c+7), so every thread holds gate and
// up of the same outputs for the SiLU-mul epilogue (gptq::epilogue<2>), and
// the block has kernel 1's shared memory, accumulators and registers. The
// copies route each 16-byte chunk of words, scales and zeros to the stream
// and column its B-tile columns stand for; the dequantization and the
// products do not know there are two streams.
// Not yet: wgmma and TMA (Hopper's full tensor-core rate).
#pragma once

#include <limits.h>

#include "mma_sync.cuh"
#include "qmm_common.cuh"

namespace gptq_tc {

using namespace gptq_mma;

constexpr int kBN = 128;                 // B-tile columns per block (of y: kBN / NW)
constexpr int kBK = 64;                  // rows of W per slab
constexpr int kThreads = 256;
constexpr int kMaxGroups = 4;            // scale / zero rows of one stage
constexpr int kStride = kBK + 8;         // bf16 per smem row: 144 B, conflict-free ldmatrix

// The block shape of one row tile BM: 8 warps as kWarpsM x kWarpsN, a ring of
// kStages copies (4 where one block fills the SM, else 3 so that two fit).
template <int BM>
struct Shape {
  static_assert(BM == 64 || BM == 128 || BM == 256, "row tile");
  static constexpr int kWarpsM = BM == 64 ? 2 : 4;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;    // a warp's rows: 32, 32, 64
  static constexpr int kWN = kBN / kWarpsN;   // and columns: 32, 64, 64
  static constexpr int kMI = kWM / 16;        // m16 fragments of A
  static constexpr int kNP = kWN / 16;        // ldmatrix.x4 of B per k16 step (two n8 each)
  static constexpr int kStages = BM == 256 ? 4 : 3;
  static constexpr int kMinBlocks = BM == 256 ? 1 : 2;
};

// Shared memory of one block, in bytes: kStages stages of (x tile, the words,
// the scale rows and the zero rows of the block's kBN B-tile columns), then
// two B tiles. The same for one and two weight streams.
template <int BITS, int BM>
struct Layout {
  static constexpr int kWordRows = kBK * BITS / 32;
  static constexpr int kX = BM * kStride * 2;
  static constexpr int kW = kWordRows * kBN * 4;
  static constexpr int kSZ = kMaxGroups * kBN * 2;
  static constexpr int kStream = kW + 2 * kSZ;
  static constexpr int kStage = kX + kStream;
  static constexpr int kB = kBN * kStride * 2;
  static constexpr int kBytes = Shape<BM>::kStages * kStage + 2 * kB;
};

__device__ __forceinline__ int group_of(int r, int groupsize, int G) {
  return min(r / groupsize, G - 1);
}

// B-tile column bc of an NW-stream block: its stream and its column of y
// within the block (n8 fragments alternate between the streams)
template <int NW>
__device__ __forceinline__ int stream_of(int bc) {
  return NW == 1 ? 0 : (bc >> 3) & 1;
}
template <int NW>
__device__ __forceinline__ int out_col(int bc) {
  return NW == 1 ? bc : ((bc >> 4) << 3) | (bc & 7);
}

// grid: (ceil(N / (kBN / NW)), ceil(M / BM), split); block: kThreads;
// dynamic shared memory: Layout<BITS, BM>::kBytes. Split z takes slabs
// [z * slabs_per_split, (z + 1) * slabs_per_split); with split > 1 it writes
// partial[((w * split + z) * M + m) * N + n] (qmm_reduce_kernel's layout).
template <int BITS, int NW, int BM>
__global__ void __launch_bounds__(kThreads, Shape<BM>::kMinBlocks)
qmm_tile_kernel(const __nv_bfloat16* __restrict__ x, gptq::Stream s0, gptq::Stream s1,
                const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                float* __restrict__ partial, int M, int K, int N, int G, int groupsize,
                int slabs_per_split) {
  using Sh = Shape<BM>;
  using L = Layout<BITS, BM>;
  constexpr int S = Sh::kStages;
  constexpr int kIpw = 32 / BITS;                            // rows of W per word
  constexpr int kWords = L::kWordRows * kBN / kThreads;      // words a thread dequantizes
  constexpr int kSteps = kBK / 16;                           // k16 steps per slab
  static_assert(kWords >= 1 && kIpw % 2 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];

  const int n0 = blockIdx.x * (kBN / NW), m0 = blockIdx.y * BM;   // first column of y, first row
  const int split = gridDim.z;
  const int n_slabs = (K + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * slabs_per_split;
  const int t_count = max(0, min(n_slabs, t_begin + slabs_per_split) - t_begin);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / Sh::kWarpsN) * Sh::kWM;   // this warp's rows of the tile
  const int wn = (warp % Sh::kWarpsN) * Sh::kWN;   // and columns
  const int kw = K / kIpw;
  const int nl = tid % kBN;                        // the B-tile column this thread dequantizes
  const int col = n0 + out_col<NW>(nl);            // its column of W (and of y)

  // stream w's pointers, selected by value (a reference to a parameter would
  // put both streams in local memory)
  auto qweight_of = [&](int w) { return w == 0 ? s0.qweight : s1.qweight; };
  auto scales_of = [&](int w) { return w == 0 ? s0.scales : s1.scales; };
  auto zeros_of = [&](int w) { return w == 0 ? s0.zeros : s1.zeros; };
  const int my = stream_of<NW>(nl);                // the stream of this thread's column
  auto x_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * L::kStage);
  };
  auto words = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + st * L::kStage + L::kX);
  };
  auto scale_rows = [&](int st) {   // kMaxGroups scale rows, then kMaxGroups zero rows
    return reinterpret_cast<__nv_bfloat16*>(smem + st * L::kStage + L::kX + L::kW);
  };
  auto b_tile = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + S * L::kStage + buf * L::kB);
  };

  // slab t into stage st (every thread issues its share of the copies)
  auto load = [&](int t, int st) {
    const int k0 = t * kBK;
    __nv_bfloat16* xd = x_tile(st);
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), c8 = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c8 < K;   // K % 8 == 0: a chunk is all in or out
      cp_async16(xd + r * kStride + c8, x + (ok ? (size_t)(m0 + r) * K + k0 + c8 : 0), ok);
    }
    const int wr0 = k0 / kIpw;
    const int g_lo = group_of(k0, groupsize, G);
    const int g_hi = group_of(min(K, k0 + kBK) - 1, groupsize, G);
    // a 16-byte chunk of 4 words or 8 scales lies inside one n8 fragment:
    // one stream, consecutive columns of W
    uint32_t* wd = words(st);
    for (int c = tid; c < L::kWordRows * (kBN / 4); c += kThreads) {
      const int r = c / (kBN / 4), c4 = (c % (kBN / 4)) * 4;
      const int wc = n0 + out_col<NW>(c4);
      const bool ok = wr0 + r < kw && wc < N;
      cp_async16(wd + r * kBN + c4,
                 qweight_of(stream_of<NW>(c4)) + (ok ? (size_t)(wr0 + r) * N + wc : 0), ok);
    }
    if (g_hi - g_lo < kMaxGroups) {
      __nv_bfloat16* sd = scale_rows(st);
      for (int c = tid; c < 2 * kMaxGroups * (kBN / 8); c += kThreads) {
        const int which = c / (kMaxGroups * (kBN / 8));
        const int rem = c % (kMaxGroups * (kBN / 8));
        const int gr = rem / (kBN / 8), c8 = (rem % (kBN / 8)) * 8;
        const int wc = n0 + out_col<NW>(c8);
        const bool ok = g_lo + gr <= g_hi && wc < N;
        const int w = stream_of<NW>(c8);
        const __nv_bfloat16* src = which ? zeros_of(w) : scales_of(w);
        cp_async16(sd + (which * kMaxGroups + gr) * kBN + c8,
                   src + (ok ? (size_t)(g_lo + gr) * N + wc : 0), ok);
      }
    }
  };

  // one word of this thread's column -> the B tile: kIpw bf16, one store
  auto store_word = [&](__nv_bfloat16* bt, int wr, const uint32_t (&v)[kIpw / 2]) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(bt + nl * kStride + wr * kIpw);
    if constexpr (kIpw == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
    } else {
#pragma unroll
      for (int j = 0; j < kIpw / 2; j += 4)
        *reinterpret_cast<uint4*>(dst + j) = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  };

  // A slab whose rows lie in one group: the scale and zero of that group for
  // this thread's column, read once (zs = z * s).
  struct OneGroup {
    float sc, zs;
  };
  auto one_group = [&](int st) -> OneGroup {
    const __nv_bfloat16* sp = scale_rows(st) + nl;
    const float sc = __bfloat162float(sp[0]);
    return {sc, __bfloat162float(sp[kMaxGroups * kBN]) * sc};
  };
  // word u of this thread in stage st, one group: code * s - z * s
  auto dequant_word = [&](int t, int st, int buf, int u, OneGroup gz) {
    const int wr = tid / kBN + u * (kThreads / kBN);
    uint32_t v[kIpw / 2];
    if (t * kBK + wr * kIpw < K && col < N) {
      const uint32_t q = words(st)[wr * kBN + nl];
#pragma unroll
      for (int j = 0; j < kIpw; j += 2)
        v[j / 2] = pack_bf16(gptq::code_f<BITS>(q, j) * gz.sc - gz.zs,
                             gptq::code_f<BITS>(q, j + 1) * gz.sc - gz.zs);
    } else {
#pragma unroll
      for (int j = 0; j < kIpw / 2; ++j) v[j] = 0u;
    }
    store_word(b_tile(buf), wr, v);
  };
  // the whole of slab t, any groups: every word looks up its rows' groups
  auto dequant_any = [&](int t, int st, int buf) {
    const int k0 = t * kBK;
    const int g_lo = group_of(k0, groupsize, G);
    const int g_hi = group_of(min(K, k0 + kBK) - 1, groupsize, G);
    const bool staged = g_hi - g_lo < kMaxGroups;
    {
      // scale and zero of group g: the stage's copy, or device memory
      const __nv_bfloat16* sp = staged ? scale_rows(st) + nl : scales_of(my) + col;
      const __nv_bfloat16* zp = staged ? scale_rows(st) + kMaxGroups * kBN + nl : zeros_of(my) + col;
      const int gbase = staged ? g_lo : 0;
      const size_t gstride = staged ? kBN : (size_t)N;
      const uint32_t* wd = words(st);
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int wr = tid / kBN + u * (kThreads / kBN);
        const int r0 = k0 + wr * kIpw;   // first row of W in this word
        uint32_t v[kIpw / 2];
        if (r0 < K && col < N) {
          const uint32_t q = wd[wr * kBN + nl];
          int gi = group_of(r0, groupsize, G);
          int next = gi >= G - 1 ? INT_MAX : (gi + 1) * groupsize;   // first row of gi + 1
          float sc = __bfloat162float(sp[(gi - gbase) * gstride]);
          float zs = __bfloat162float(zp[(gi - gbase) * gstride]) * sc;
          float f[kIpw];
#pragma unroll
          for (int j = 0; j < kIpw; ++j) {
            if (r0 + j >= next) {   // a group boundary inside the word
              ++gi;
              next = gi >= G - 1 ? INT_MAX : next + groupsize;
              sc = __bfloat162float(sp[(gi - gbase) * gstride]);
              zs = __bfloat162float(zp[(gi - gbase) * gstride]) * sc;
            }
            f[j] = gptq::code_f<BITS>(q, j) * sc - zs;
          }
#pragma unroll
          for (int j = 0; j < kIpw; j += 2) v[j / 2] = pack_bf16(f[j], f[j + 1]);
        } else {
#pragma unroll
          for (int j = 0; j < kIpw / 2; ++j) v[j] = 0u;
        }
        store_word(b_tile(buf), wr, v);
      }
    }
  };
  auto in_one_group = [&](int t) {
    const int k0 = t * kBK;
    return group_of(k0, groupsize, G) == group_of(min(K, k0 + kBK) - 1, groupsize, G);
  };

  // fragment nt of a warp: B-tile columns wn + 8 nt ..; with NW = 2 even
  // fragments are gate columns, odd ones up columns
  float acc[Sh::kMI][2 * Sh::kNP][4];
#pragma unroll
  for (int i = 0; i < Sh::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * Sh::kNP; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // one k16 step of the products on x stage st and B tiles buf
  auto mma_step = [&](int st, int buf, int kk) {
    const __nv_bfloat16* xs = x_tile(st);
    uint32_t af[Sh::kMI][4];
#pragma unroll
    for (int mi = 0; mi < Sh::kMI; ++mi)
      ldsm_x4(af[mi], xs + (wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                          kk * 16 + (lane >> 4) * 8);
    const __nv_bfloat16* bt = b_tile(buf);
#pragma unroll
    for (int np = 0; np < Sh::kNP; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, bt + (wn + np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < Sh::kMI; ++mi) {
        mma16816(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma16816(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  };

  // Slab i: its copies land S - 2 iterations after they are issued; it is
  // dequantized into B tile i % 2 in iteration i - 1 (the prologue for i = 0)
  // and multiplied in iteration i. One barrier per iteration: after it, slab
  // i + 1 has landed, B tile i % 2 is written, and every warp is done with
  // slab i - 1 (its stage and B tile take slab i + S - 1 and slab i + 1).
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < t_count) load(t_begin + i, i);
    cp_async_commit();
  }
  if (t_count > 0) {
    cp_async_wait<S - 2>();
    __syncthreads();
    dequant_any(t_begin, 0, 0);
  }
  for (int i = 0; i < t_count; ++i) {
    cp_async_wait<S - 3>();
    __syncthreads();
    if (i + S - 1 < t_count) load(t_begin + i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    const int st = i % S, buf = i & 1;
    const bool next = i + 1 < t_count;
    const int nst = (i + 1) % S, nbuf = buf ^ 1;
    if (next && in_one_group(t_begin + i + 1)) {
      // dequantize slab i + 1 between the k16 steps of slab i's products
      const OneGroup gz = one_group(nst);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_step(st, buf, kk);
#pragma unroll
        for (int u = 0; u < kWords; ++u)
          if (u * kSteps / kWords == kk) dequant_word(t_begin + i + 1, nst, nbuf, u, gz);
      }
    } else {
      if (next) dequant_any(t_begin + i + 1, nst, nbuf);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) mma_step(st, buf, kk);
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < Sh::kMI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + gq + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 2 * Sh::kNP; nt += NW) {   // fragments nt .. nt + NW - 1: one y column pair
        // N % 8 == 0: the pair stays inside a row
        const int c = n0 + out_col<NW>(wn + nt * 8 + t4 * 2);
        if (c >= N) continue;
        if (split == 1) {
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v[NW];
#pragma unroll
            for (int w = 0; w < NW; ++w) v[w] = acc[mi][nt + w][half * 2 + e];
            y[e] = gptq::epilogue<NW>(v, bias, c + e);
          }
          *reinterpret_cast<uint32_t*>(out + (size_t)row * N + c) = pack_bf16(y[0], y[1]);
        } else {
#pragma unroll
          for (int w = 0; w < NW; ++w)
            *reinterpret_cast<float2*>(
                partial + ((size_t)(w * split + blockIdx.z) * M + row) * N + c) =
                make_float2(acc[mi][nt + w][half * 2], acc[mi][nt + w][half * 2 + 1]);
        }
      }
    }
  }
}

template <int BITS, int NW, int BM>
cudaError_t launch_tile(const __nv_bfloat16* x, gptq::Stream s0, gptq::Stream s1,
                        const __nv_bfloat16* bias, __nv_bfloat16* out, float* partial, int M,
                        int K, int N, int G, int groupsize, int split, int slabs_per_split,
                        int smem_bytes, cudaStream_t stream) {
  using L = Layout<BITS, BM>;
  // the wrapper's plan computes the same size; a disagreement is a fault
  if (smem_bytes != L::kBytes) return cudaErrorInvalidValue;
  auto kern = qmm_tile_kernel<BITS, NW, BM>;
  // once per instantiation (not per launch, so a CUDA-graph capture sees none)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  constexpr int kCols = kBN / NW;   // columns of y per block
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM, split);
  kern<<<grid, kThreads, L::kBytes, stream>>>(x, s0, s1, bias, out, partial, M, K, N, G,
                                              groupsize, slabs_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  return gptq::launch_reduce<NW>(partial, bias, out, M, N, split, stream);
}

}  // namespace gptq_tc
