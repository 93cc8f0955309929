// Grad-input of the dequant-GEMM on bf16 tensor cores: dx = g @ dequant(W)^T.
//
// Replaces gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_t_kernel (entry
// quant_matmul_t_pallas), the backward of every frozen packed linear when
// adapters train (LoRA). g (M, N) bf16, W the packed (K, N) weight in device
// row order; dx (M, K) bf16 in device row order (the wrapper applies the
// inverse act-order permutation). Each weight element is dequantized as the
// TPU kernel does, c * s - z * s in fp32 rounded once to bf16 (both products
// are exact in fp32, so this is bit-equal to PackedLinear.dequantize), and
// the product accumulates in fp32.
//
// What bounds it on the H100: operations at training row counts. At M = 1024
// a 4096 x 4096 linear is 34.4 GFLOP (34.7 us at 989 TFLOP/s) against 7.5 us
// for its bytes; down_proj's transpose and gate/up's are 93.4 us each.
// The scale varies along the reduction axis (it is indexed by n), so the
// forward kernel's dot-then-scale trick does not transpose: each slice of W
// is dequantized to bf16 in shared memory and the products are a plain bf16
// GEMM. Design (kernel 1's tile machinery, qmm_tc.cuh, turned round):
//  - one block of 8 warps per BM x 128 tile of dx (BM = 64, 128 or 256, the
//    wrapper's plan picks it from M); the block walks N, the reduction, in
//    slices of 64 through a ring of cp.async stages: g's BM x 64 tile, the
//    slice's packed words (128 * BITS / 32 word rows x 64 columns) and the
//    scale and zero rows of the groups the tile's 128 K rows touch;
//  - the dequantized slice is laid out [n][K-row], so the 32 / BITS rows one
//    word holds become one 16-byte store (8 bytes at 8 bits); the products
//    read it with ldmatrix.trans;
//  - two B tiles: slice t + 1 is dequantized between the k16 steps of slice
//    t's products, so one barrier per slice orders both;
//  - where the group size is a multiple of 32 / BITS no word straddles a
//    group, and a word reads its scale and zero once; otherwise (group size
//    40 at 2 bits) each row of the word finds its own group. A ragged last
//    group and G = 1 work either way; a tile that touches more than
//    kMaxGroups groups (a group size below 43) reads its scales and zeros
//    from device memory instead of the stage;
//  - products: ldmatrix and mma.sync.m16n8k16 bf16 with fp32 sums
//    (mma_sync.cuh);
//  - where the plan splits N across blocks (too few tiles to fill the card,
//    e.g. M = 128), each split writes fp32 partials and qmm_reduce_kernel
//    sums them in a fixed order, so dx stays deterministic.
#include <limits.h>

#include "mma_sync.cuh"
#include "qmm_common.cuh"
#include "qmm_wgmma.cuh"

namespace {

using namespace gptq_mma;

constexpr int kBK = 128;                 // columns of dx (rows of W) per block
constexpr int kBN = 64;                  // reduction slice
constexpr int kThreads = 256;
constexpr int kMaxGroups = 4;            // scale / zero rows of one stage
constexpr int kGStride = kBN + 8;        // bf16 per g row in smem: 144 B, conflict-free ldmatrix
constexpr int kBStride = kBK + 8;        // bf16 per B-tile row: 272 B, conflict-free

// The block shape of one row tile BM: 8 warps as kWarpsM x kWarpsN, a ring of
// kStages copies (4 where one block fills the SM, else 3 so that two fit).
template <int BM>
struct Shape {
  static_assert(BM == 64 || BM == 128 || BM == 256, "row tile");
  static constexpr int kWarpsM = BM == 64 ? 2 : 4;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;    // a warp's rows: 32, 32, 64
  static constexpr int kWN = kBK / kWarpsN;   // and columns: 32, 64, 64
  static constexpr int kMI = kWM / 16;        // m16 fragments of A
  static constexpr int kNP = kWN / 16;        // ldmatrix.x4.trans of B per k16 step
  static constexpr int kStages = BM == 256 ? 4 : 3;
  static constexpr int kMinBlocks = BM == 256 ? 1 : 2;
};

// Shared memory of one block, in bytes: kStages stages of (g tile, words,
// scale rows, zero rows), then two B tiles. ops/cuda/matmul_t.py's
// tile_smem_bytes computes the same.
template <int BITS, int BM>
struct Layout {
  static constexpr int kWordRows = kBK * BITS / 32;
  static constexpr int kG = BM * kGStride * 2;
  static constexpr int kW = kWordRows * kBN * 4;
  static constexpr int kSZ = kMaxGroups * kBN * 2;
  static constexpr int kStage = kG + kW + 2 * kSZ;
  static constexpr int kB = kBN * kBStride * 2;
  static constexpr int kBytes = Shape<BM>::kStages * kStage + 2 * kB;
};

// grid: (ceil(K / kBK), ceil(M / BM), split); block: kThreads; dynamic shared
// memory: Layout<BITS, BM>::kBytes. Split z takes slices
// [z * slices_per_split, (z + 1) * slices_per_split); with split > 1 it writes
// partial[(z * M + m) * K + k] (qmm_reduce_kernel's layout).
template <int BITS, int BM>
__global__ void __launch_bounds__(kThreads, Shape<BM>::kMinBlocks)
qmm_t_kernel(const __nv_bfloat16* __restrict__ g,   // (M, N)
             gptq::Stream w,                        // packed (K, N)
             __nv_bfloat16* __restrict__ dx,        // (M, K)
             float* __restrict__ partial,           // (split, M, K) when split > 1
             int M, int K, int N, int G, int groupsize, int slices_per_split) {
  using Sh = Shape<BM>;
  using L = Layout<BITS, BM>;
  constexpr int S = Sh::kStages;
  constexpr int kIpw = 32 / BITS;                          // rows of W per word
  constexpr int kWords = L::kWordRows * kBN / kThreads;    // words a thread dequantizes
  constexpr int kSteps = kBN / 16;                         // k16 steps per slice
  static_assert(kWords >= 1 && kIpw % 2 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];

  const int k0 = blockIdx.x * kBK, m0 = blockIdx.y * BM;
  const int split = gridDim.z;
  const int n_slices = (N + kBN - 1) / kBN;
  const int t_begin = blockIdx.z * slices_per_split;
  const int t_count = max(0, min(n_slices, t_begin + slices_per_split) - t_begin);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / Sh::kWarpsN) * Sh::kWM;   // this warp's rows of the tile
  const int wn = (warp % Sh::kWarpsN) * Sh::kWN;   // and columns
  const int kw = K / kIpw, w0 = k0 / kIpw;
  const int nl = tid % kBN;                        // the slice column this thread dequantizes

  // the groups of the tile's K rows: fixed for the block
  const int g_lo = min(k0 / groupsize, G - 1);
  const int g_hi = min((min(K, k0 + kBK) - 1) / groupsize, G - 1);
  const bool staged = g_hi - g_lo < kMaxGroups;

  auto g_tile = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * L::kStage); };
  auto words = [&](int st) { return reinterpret_cast<uint32_t*>(smem + st * L::kStage + L::kG); };
  auto scale_rows = [&](int st) {   // kMaxGroups scale rows, then kMaxGroups zero rows
    return reinterpret_cast<__nv_bfloat16*>(smem + st * L::kStage + L::kG + L::kW);
  };
  auto b_tile = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + S * L::kStage + buf * L::kB);
  };

  // slice t into stage st (every thread issues its share of the copies)
  auto load = [&](int t, int st) {
    const int n0 = t * kBN;
    __nv_bfloat16* gd = g_tile(st);
    for (int c = tid; c < BM * (kBN / 8); c += kThreads) {
      const int r = c / (kBN / 8), c8 = (c % (kBN / 8)) * 8;
      const bool ok = m0 + r < M && n0 + c8 < N;   // N % 8 == 0: a chunk is all in or out
      cp_async16(gd + r * kGStride + c8, g + (ok ? (size_t)(m0 + r) * N + n0 + c8 : 0), ok);
    }
    uint32_t* wd = words(st);
    for (int c = tid; c < L::kWordRows * (kBN / 4); c += kThreads) {
      const int r = c / (kBN / 4), c4 = (c % (kBN / 4)) * 4;
      const bool ok = w0 + r < kw && n0 + c4 < N;
      cp_async16(wd + r * kBN + c4, w.qweight + (ok ? (size_t)(w0 + r) * N + n0 + c4 : 0), ok);
    }
    if (staged) {
      __nv_bfloat16* sd = scale_rows(st);
      for (int c = tid; c < 2 * kMaxGroups * (kBN / 8); c += kThreads) {
        const int which = c / (kMaxGroups * (kBN / 8));
        const int rem = c % (kMaxGroups * (kBN / 8));
        const int gr = rem / (kBN / 8), c8 = (rem % (kBN / 8)) * 8;
        const bool ok = g_lo + gr <= g_hi && n0 + c8 < N;
        const __nv_bfloat16* src = which ? w.zeros : w.scales;
        cp_async16(sd + (which * kMaxGroups + gr) * kBN + c8,
                   src + (ok ? (size_t)(g_lo + gr) * N + n0 + c8 : 0), ok);
      }
    }
  };

  // the first group of a word's rows, starting at row r0
  auto first_group = [&](int r0) {
    int gi = min(r0 / groupsize, G - 1);
    return gi;
  };
  // this thread's kIpw bf16 of word row wr -> row nl of B tile buf, one store
  auto store_word = [&](int buf, int wr, const uint32_t (&v)[kIpw / 2]) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(b_tile(buf) + nl * kBStride + wr * kIpw);
    if constexpr (kIpw == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
    } else {
#pragma unroll
      for (int j = 0; j < kIpw / 2; j += 4)
        *reinterpret_cast<uint4*>(dst + j) = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  };

  // The one-group path (no word straddles a group, the tile's groups are
  // staged): each of this thread's words reads its scale and zero once, from
  // the staged row of its group, fixed for the block. Words past K and
  // columns past N need no test: past N the stage holds zeros, and B-tile
  // columns past K only feed dx columns that are never stored.
  const bool fast = groupsize % kIpw == 0 && staged;
  int grow[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u)
    grow[u] = (first_group(min(k0 + (tid / kBN + u * (kThreads / kBN)) * kIpw, K - 1)) - g_lo) *
              kBN;
  auto dequant_fast = [&](int st, int buf, int u) {
    const int wr = tid / kBN + u * (kThreads / kBN);
    const uint32_t q = words(st)[wr * kBN + nl];
    const __nv_bfloat16* sp = scale_rows(st) + grow[u] + nl;
    const float sc = __bfloat162float(sp[0]);
    const float zs = __bfloat162float(sp[kMaxGroups * kBN]) * sc;
    uint32_t v[kIpw / 2];
#pragma unroll
    for (int j = 0; j < kIpw; j += 2)
      v[j / 2] = pack_bf16(gptq::code_f<BITS>(q, j) * sc - zs,
                           gptq::code_f<BITS>(q, j + 1) * sc - zs);
    store_word(buf, wr, v);
  };
  // Any group size: every row of a word finds its group (a boundary inside a
  // word at group size 40 and 2 bits), from the stage or from device memory.
  auto dequant_any = [&](int t, int st, int buf) {
    const int col = t * kBN + nl;
    const __nv_bfloat16* sp = staged ? scale_rows(st) + nl : w.scales + col;
    const __nv_bfloat16* zp = staged ? scale_rows(st) + kMaxGroups * kBN + nl : w.zeros + col;
    const int gbase = staged ? g_lo : 0;
    const size_t gstride = staged ? kBN : (size_t)N;
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int wr = tid / kBN + u * (kThreads / kBN);
      const int r0 = k0 + wr * kIpw;   // first row of W in this word
      uint32_t v[kIpw / 2];
      if (r0 < K && col < N) {
        const uint32_t q = words(st)[wr * kBN + nl];
        int gi = first_group(r0);
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
      store_word(buf, wr, v);
    }
  };

  float acc[Sh::kMI][2 * Sh::kNP][4];
#pragma unroll
  for (int i = 0; i < Sh::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * Sh::kNP; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // one k16 step of the products on g stage st and B tile buf
  auto mma_step = [&](int st, int buf, int kk) {
    const __nv_bfloat16* gs = g_tile(st);
    const __nv_bfloat16* bt = b_tile(buf);
    uint32_t af[Sh::kMI][4];
#pragma unroll
    for (int mi = 0; mi < Sh::kMI; ++mi)
      ldsm_x4(af[mi], gs + (wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kGStride +
                          kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < Sh::kNP; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBStride + wn +
                            np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < Sh::kMI; ++mi) {
        mma16816(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma16816(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  };

  // the products of slice i on B tile buf, with slice i + 1 (stage nst)
  // dequantized into B tile buf ^ 1 between their k16 steps
  auto step = [&](int i, int st, int buf, int nst, bool next) {
    if (fast) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_step(st, buf, kk);
        if (next) {
#pragma unroll
          for (int u = 0; u < kWords; ++u)
            if (u * kSteps / kWords == kk) dequant_fast(nst, buf ^ 1, u);
        }
      }
    } else {
      if (next) dequant_any(t_begin + i + 1, nst, buf ^ 1);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) mma_step(st, buf, kk);
    }
  };
  auto dequant_first = [&]() {
    if (fast) {
#pragma unroll
      for (int u = 0; u < kWords; ++u) dequant_fast(0, 0, u);
    } else {
      dequant_any(t_begin, 0, 0);
    }
  };

  // Slice i: its copies land S - 2 iterations after they are issued; it is
  // dequantized into B tile i % 2 in iteration i - 1 (the prologue for i = 0)
  // and multiplied in iteration i. One barrier per iteration: after it, slice
  // i + 1 has landed, B tile i % 2 is written, and every warp is done with
  // slice i - 1 (its stage and B tile take slice i + S - 1 and slice i + 1).
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < t_count) load(t_begin + i, i);
    cp_async_commit();
  }
  if (t_count > 0) {
    cp_async_wait<S - 2>();
    __syncthreads();
    dequant_first();
  }
  for (int i = 0; i < t_count; ++i) {
    cp_async_wait<S - 3>();
    __syncthreads();
    if (i + S - 1 < t_count) load(t_begin + i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    step(i, i % S, i & 1, (i + 1) % S, i + 1 < t_count);
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
      for (int nt = 0; nt < 2 * Sh::kNP; ++nt) {
        const int c = k0 + wn + nt * 8 + t4 * 2;   // K is even: the pair stays inside a row
        if (c >= K) continue;
        const float lo = acc[mi][nt][half * 2], hi = acc[mi][nt][half * 2 + 1];
        if (split == 1)
          *reinterpret_cast<uint32_t*>(dx + (size_t)row * K + c) = pack_bf16(lo, hi);
        else
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * M + row) * K + c) =
              make_float2(lo, hi);
      }
    }
  }
}

template <int BITS, int BM>
cudaError_t launch(const __nv_bfloat16* g, gptq::Stream w, __nv_bfloat16* dx, float* partial,
                   int M, int K, int N, int G, int groupsize, int split, int slices_per_split,
                   int smem_bytes, cudaStream_t stream) {
  using L = Layout<BITS, BM>;
  // the wrapper's plan computes the same size; a disagreement is a fault
  if (smem_bytes != L::kBytes) return cudaErrorInvalidValue;
  auto kern = qmm_t_kernel<BITS, BM>;
  // once per instantiation (not per launch, so a CUDA-graph capture sees none)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((K + kBK - 1) / kBK, (M + BM - 1) / BM, split);
  kern<<<grid, kThreads, L::kBytes, stream>>>(g, w, dx, partial, M, K, N, G, groupsize,
                                              slices_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  return gptq::launch_reduce<1>(partial, nullptr, dx, M, K, split, stream);
}

}  // namespace

// g (M, N) bf16, contiguous, N % 8 == 0; qweight (K * bits / 32, N) int32;
// scales, zeros (G, N) bf16; dx (M, K) bf16; K a multiple of 32 / bits.
// bm: the row tile (64, 128, 256); split: blocks along N, each taking
// slices_per_split slices of 64 and writing partial (split, M, K) fp32 when
// split > 1; smem_bytes: the plan's size of the block's shared memory.
extern "C" int gptq_qmm_t(const void* g, const void* qweight, const void* scales,
                          const void* zeros, void* dx, void* partial, int M, int K, int N, int G,
                          int groupsize, int bits, int bm, int split, int slices_per_split,
                          int smem_bytes, void* stream) {
  const int n_slices = (N + kBN - 1) / kBN;
  if (M < 1 || K < 1 || N < 8 || N % 8 != 0 || G < 1 || groupsize < 1 ||
      (bits != 2 && bits != 4 && bits != 8) || K % (32 / bits) != 0 || split < 1 ||
      slices_per_split < 1 || (long long)split * slices_per_split < n_slices ||
      split > 65535 || (bm != 64 && bm != 128 && bm != 256) || (M + bm - 1) / bm > 65535 ||
      (split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const gptq::Stream w{static_cast<const int32_t*>(qweight),
                       static_cast<const __nv_bfloat16*>(scales),
                       static_cast<const __nv_bfloat16*>(zeros)};
  const auto gb = static_cast<const __nv_bfloat16*>(g);
  const auto db = static_cast<__nv_bfloat16*>(dx);
  const auto pb = static_cast<float*>(partial);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPTQ_TILE(B, R)                                                                     \
  launch<B, R>(gb, w, db, pb, M, K, N, G, groupsize, split, slices_per_split, smem_bytes, st)
#define GPTQ_TILES(B) (bm == 64 ? GPTQ_TILE(B, 64) : bm == 128 ? GPTQ_TILE(B, 128) : GPTQ_TILE(B, 256))
  cudaError_t e;
  switch (bits) {
    case 2: e = GPTQ_TILES(2); break;
    case 4: e = GPTQ_TILES(4); break;
    default: e = GPTQ_TILES(8); break;
  }
#undef GPTQ_TILES
#undef GPTQ_TILE
  return static_cast<int>(e);
}

// g (M, N) bf16 with N % 8 == 0; qweight (K * bits / 32, N) int32 with
// K % 8 == 0; scales, zeros (G, N) bf16, groupsize % 16 == 0 or G == 1; dx
// (M, K) bf16; partial (split, M, K) fp32 when split > 1; bm: the row tile
// (64, 128, 144, 256); slices_per_split: 64-wide slices of N per split;
// sz_rows: the scale rows of the groups a block's 128 rows of W touch (1, 2,
// 4 or 8); smem_bytes: the plan's size.
extern "C" int gptq_qmm_t_wgmma(const void* g, const void* qweight, const void* scales,
                                const void* zeros, void* dx, void* partial, int M, int K, int N,
                                int G, int groupsize, int bits, int bm, int split,
                                int slices_per_split, int sz_rows, int smem_bytes, void* stream) {
  const gptq::Stream w{static_cast<const int32_t*>(qweight),
                       static_cast<const __nv_bfloat16*>(scales),
                       static_cast<const __nv_bfloat16*>(zeros)};
  return static_cast<int>(gptq_wg::launch_bits<true, 1>(
      bits, bm, g, w, w, nullptr, static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), M,
      K, N, G, groupsize, split, slices_per_split, sz_rows, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}
