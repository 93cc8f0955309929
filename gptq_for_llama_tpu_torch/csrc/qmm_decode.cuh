// Batch-1 decode form of the dequant-GEMM, fed by TMA: kernel 1, y = x @
// dequant(W) (+ bias) (NW = 1, entry gptq_qmm_decode in qmm.cu), and kernel
// 2, silu(x @ dequant(Wg)) * (x @ dequant(Wu)) (NW = 2, entry
// gptq_fused_mlp_decode in fused_mlp.cu), at M = 1.
//
// Replaces, beside the register fragments of qmm_frag.cuh and the GEMV of
// qmm_gemv.cuh (which keep the other rows and group sizes), the TPU kernels
// gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel and
// gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel.
//
// What bounds it on the H100: the packed weight bytes with their scales and
// zeros (8.9 MB at 4096 x 4096 INT4-g128: 2.67 us at 3.35 TB/s; kernel 2's
// two streams at 4096 x 11008: 14.3 us). A launch is a few microseconds, so
// what an SM keeps in flight from its first cycle decides the rate. The
// fragment form and the GEMV issue every copy from the lanes (cp.async, 16
// bytes a lane, 24 KB of weight in flight an SM) and split K over a
// cluster whose blocks meet over distributed shared memory. This form:
//  - one producer thread keeps TMA loads in flight through an mbarrier ring
//    as deep as shared memory allows (up to 16 stages), from the kernel's
//    first instruction: each stage holds `rows` packed word rows of every
//    16-column strip of the block's columns as 2-D int32 boxes in the
//    weight's own layout (K * BITS / 32, N), and the scale and zero rows of
//    the groups those rows touch; x (M = 1, K * 2 bytes) is one bulk copy
//    ahead of the first stage. The word boxes use the 64-byte swizzle, so
//    the consumers' reads below hit 32 different banks;
//  - one block per `strips` x 16 columns, the fewest strips whose blocks
//    cover N in one wave (2 at N = 4096: 128 blocks, one an SM; 3 of each
//    weight for kernel 2 at N = 11008: 230 blocks, two an SM): the columns
//    alone fill the card, so no block meets another (no K split, no
//    cluster, no atomics);
//  - 16 consumer warps (8 where a block holds more than 3 strips, two
//    blocks an SM) take consecutive slices of each stage's rows and
//    release the stage through its empty barrier. The arithmetic is the
//    fragment form's (qmm_frag.cuh's dequant_pair, x_frag, affine): the
//    product is taken transposed, the weight the A operand of
//    mma.m16n8k16 (16 columns of a strip: lane group g holds columns g and
//    g + 8) and x the B operand; each weight is (c - z) * s rounded once to
//    bf16, as PackedLinear.dequantize rounds it, and the products sum in
//    fp32. A lane owns one word row of each K-block of 4 word rows; the rows
//    of an aligned 8-row octet go to lanes t = 0..3 as {0, 1, 4, 5} and then
//    {2, 3, 6, 7}, which under the 64-byte swizzle puts the warp's 32 word
//    reads on 32 banks and keeps each lane's rows inside one group (the
//    group size a multiple of 4 word rows, as the fragment form needs);
//  - the warps' sums meet once, in shared memory in warp order, and the
//    block's threads finish its columns with the epilogue (the bias, or
//    silu(g) * u in fp32, one rounding to bf16): the same bytes on every
//    launch and every CUDA-graph replay.
// The tensor maps are encoded on the host (once for each weight and box:
// cached_map_2d) and passed as __grid_constant__ parameters, so a captured
// launch replays over the same buffers; the body reads nothing on the host.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <functional>
#include <mutex>
#include <unordered_map>

#include "hopper.cuh"
#include "qmm_common.cuh"
#include "qmm_frag.cuh"
#include "qmm_wgmma.cuh"

namespace gptq_dec {

using namespace gptq_hopper;
using gptq_mma::mma16816;

constexpr int kStripCols = 16;               // columns of one word box (64 bytes)
constexpr int kMaxStages = 16;
constexpr int kSmemLimit = 232448;           // dynamic shared memory one block may have

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// Consumer warps of a block of `strips` strips (both weights together): 16 at
// one block an SM where the strips are few (at most 3), so that 4 warps a
// scheduler hide the latencies of the loads and the products; else 8, at two
// blocks an SM (the registers of 2 x 288 threads hold 6 strips' sums).
__host__ __device__ constexpr int consumer_warps(int strips) { return strips <= 3 ? 16 : 8; }

// One block's shared memory (ops/cuda/matmul.py's decode_smem_bytes
// computes the same): `stages` stages, each the word boxes ([rows][16] int32
// per strip of each stream) then each stream's scale and zero boxes
// ([sz_rows][16 * strips] bf16); x (K bf16); the warps' sums; the full and
// empty barriers; 1 KB to align the stages to the swizzle's atoms.
struct Layout {
  int words, sz_box, stage, ring, x, red, bars, bytes;
};
__host__ __device__ inline Layout layout(int nw, int strips, int rows, int sz_rows, int K,
                                         int stages) {
  const int warps = consumer_warps(nw * strips);
  Layout L;
  L.words = nw * strips * rows * 64;
  L.sz_box = align_up(sz_rows * strips * kStripCols * 2, 128);
  L.stage = align_up(L.words + nw * 2 * L.sz_box, 1024);
  L.ring = stages * L.stage;
  L.x = align_up(K * 2, 128);
  L.red = warps * nw * strips * kStripCols * 4;
  L.bars = 2 * stages * 8;
  L.bytes = 1024 + L.ring + L.x + L.red + L.bars;
  return L;
}

// `bytes` (a multiple of 16) from global `src` into shared memory at `dst`,
// counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Word (row r, column c) of a [rows][16] int32 box written by TMA under the
// 64-byte swizzle: 16-byte chunk c / 4 of row r lies at chunk (c / 4) ^ ((r
// >> 1) & 3) (address bits 4-5 XOR bits 7-8; the box 512-byte aligned).
__device__ __forceinline__ uint32_t word_at(const unsigned char* box, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(box + r * 64 + ((((c >> 2) ^ (r >> 1)) & 3) << 4) +
                                            (c & 3) * 4);
}

// grid: ceil(N / (16 NS)); block: kThreads; dynamic shared memory
// layout(NW, NS, rows, sz_rows, K, stages).bytes. Tensor maps: tw the words
// (K * BITS / 32, N) int32, box 16 x rows, 64-byte swizzle; ts, tz scales
// and zeros (G, N) bf16, box 16 NS x sz_rows; tw2, ts2, tz2 the up weight's
// (kernel 2; unused otherwise). x (1, K) bf16, out (1, N) bf16. NS, the
// strips of each weight a block, is a template parameter: the strips of an
// octet are unrolled without a branch, so their loads, dequantization and
// products interleave.
template <int BITS, int NW, int NS>
__global__ void __launch_bounds__(32 * (consumer_warps(NW * NS) + 1),
                                  consumer_warps(NW * NS) == 16 ? 1 : 2)
qmm_decode_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap ts,
                  const __grid_constant__ CUtensorMap tz, const __grid_constant__ CUtensorMap tw2,
                  const __grid_constant__ CUtensorMap ts2, const __grid_constant__ CUtensorMap tz2,
                  const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int K, int N, int G, int groupsize, int rows,
                  int sz_rows, int stages) {
  constexpr int kR = 32 / BITS;    // rows of K per word
  constexpr int kSteps = kR / 4;   // k16 steps of a word row
  constexpr int kXB = 2 * kR;      // bytes of x per word row
  constexpr int kStrips = NW * NS;
  constexpr int C = NS * kStripCols;   // columns of y a block
  constexpr int kWarps = consumer_warps(kStrips);
  constexpr int kChains = kWarps == 16 ? 2 : 1;   // product chains a strip
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = gptq_mma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  const Layout L = layout(NW, NS, rows, sz_rows, K, stages);
  const int n0 = blockIdx.x * C;
  const int kw = K / kR;                    // word rows
  const int n_st = (kw + rows - 1) / rows;  // stages of the whole reduction
  const uint32_t bars = base + L.ring + L.x + L.red;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (stages + st); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWarps);   // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: one thread issues every copy, stage by stage
    if (lane == 0) {
      tma_prefetch_desc(&tw);
      tma_prefetch_desc(&ts);
      tma_prefetch_desc(&tz);
      if constexpr (NW == 2) {
        tma_prefetch_desc(&tw2);
        tma_prefetch_desc(&ts2);
        tma_prefetch_desc(&tz2);
      }
      const uint32_t bytes = L.words + NW * 2 * sz_rows * C * 2;
      for (int i = 0; i < n_st; ++i) {
        const int st = i % stages, r0 = i * rows;
        if (i >= stages) mbar_wait(empty(st), (uint32_t)((i / stages - 1) & 1));
        const uint32_t sp = base + st * L.stage;
        mbar_expect_tx(full(st), bytes + (i == 0 ? K * 2 : 0));
        if (i == 0) bulk_load(base + L.ring, x, K * 2, full(st));
        const int g_lo = min(r0 * kR / groupsize, G - 1);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const CUtensorMap* mw = w == 0 ? &tw : &tw2;
#pragma unroll
          for (int j = 0; j < NS; ++j)
            tma_load_2d(sp + (w * NS + j) * rows * 64, mw, full(st), n0 + j * kStripCols, r0);
          tma_load_2d(sp + L.words + 2 * w * L.sz_box, w == 0 ? &ts : &ts2, full(st), n0, g_lo);
          tma_load_2d(sp + L.words + (2 * w + 1) * L.sz_box, w == 0 ? &tz : &tz2, full(st), n0,
                      g_lo);
        }
      }
    }
    return;
  }

  // consumers: lane (g, t); strip j's A rows g and g + 8 are its columns g
  // and g + 8 (strips NS.. the up weight's); K-block b of an octet is this
  // lane's word row rA + 2 b, summed into acc[j][b % kChains] (with few
  // strips, two chains of products a strip). A warp's items are its octets
  // in stage order: item n is octet n % per of its slice of stage n / per.
  // (Reading item n + 1 into a second register set ahead of item n's
  // products measured slower: 9.90 against 8.51 us at 4096 x 4096.)
  const int g = lane >> 2, t = lane & 3;
  const int rA = (t & 1) | ((t & 2) << 1);   // 0, 1, 4, 5
  const int slice = rows / kWarps;           // word rows of a stage a warp takes
  const int per = slice / 8;                 // octets of a stage a warp takes
  const unsigned char* xs = sbase + L.ring;
  // a word row's group: a shift where the group size is a power of two
  const int gs_shift = (groupsize & (groupsize - 1)) == 0 ? __ffs(groupsize) - 1 : -1;
  auto group = [&](int wr) {
    const int k0 = wr * kR;
    return min(gs_shift >= 0 ? k0 >> gs_shift : k0 / groupsize, G - 1);
  };
  // the items: every octet of the stages before the last, those of the last
  // that start inside K
  const int last = (n_st - 1) * rows + warp * slice;
  const int n_items = (n_st - 1) * per + max(0, min(per, (kw - last + 7) / 8));

  struct Octet {
    uint32_t xw[2][kR / 2];   // x over each K-block's word row (zero past K)
    gptq_frag::Affine<BITS> aa[kStrips], ab[kStrips];   // columns g, g + 8 of each strip
    uint32_t qa[2][kStrips], qb[2][kStrips];            // their words of each K-block
  };
  // item n's shared-memory reads into q (its stage has landed)
  auto load = [&](int n, Octet& q) {
    const int i = n / per, r0 = i * rows, o = warp * slice + 8 * (n - i * per);
    const unsigned char* sp = sbase + (i % stages) * L.stage;
    const int wr0 = r0 + o + rA;
    // this lane's two word rows of the octet lie in one group
    const int grow = group(wr0) - group(r0);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int wr = wr0 + 2 * b;
      const uint32_t* xp = reinterpret_cast<const uint32_t*>(xs + (wr < kw ? wr : 0) * kXB);
#pragma unroll
      for (int c = 0; c < kR / 2; ++c) q.xw[b][c] = wr < kw ? xp[c] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kStrips; ++j) {
      const int w = j / NS, col = (j % NS) * kStripCols + g;
      const __nv_bfloat16* sr = reinterpret_cast<const __nv_bfloat16*>(
          sp + L.words + 2 * w * L.sz_box) + grow * C + col;
      const __nv_bfloat16* zr = reinterpret_cast<const __nv_bfloat16*>(
          sp + L.words + (2 * w + 1) * L.sz_box) + grow * C + col;
      q.aa[j] = gptq_frag::affine<BITS>(sr[0], zr[0]);
      q.ab[j] = gptq_frag::affine<BITS>(sr[8], zr[8]);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const unsigned char* box = sp + j * rows * 64;
        q.qa[b][j] = word_at(box, o + rA + 2 * b, g);
        q.qb[b][j] = word_at(box, o + rA + 2 * b, g + 8);
      }
    }
  };
  float acc[kStrips][kChains][4];
#pragma unroll
  for (int j = 0; j < kStrips; ++j)
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[j][c][0] = acc[j][c][1] = acc[j][c][2] = acc[j][c][3] = 0.0f;
  auto compute = [&](const Octet& q) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t b0, b1;
        gptq_frag::x_frag<BITS>(q.xw[b], s, b0, b1);
#pragma unroll
        for (int j = 0; j < kStrips; ++j) {
          const uint32_t a[4] = {gptq_frag::dequant_pair<BITS>(q.qa[b][j], 2 * s, q.aa[j]),
                                 gptq_frag::dequant_pair<BITS>(q.qb[b][j], 2 * s, q.ab[j]),
                                 gptq_frag::dequant_pair<BITS>(q.qa[b][j], 2 * s + 1, q.aa[j]),
                                 gptq_frag::dequant_pair<BITS>(q.qb[b][j], 2 * s + 1, q.ab[j])};
          mma16816(acc[j][b % kChains], a, b0, b1);
        }
      }
    }
  };
  // after item n: a stage whose last item of this warp it was is released
  auto done = [&](int n) {
    if (n + 1 == n_items || (n + 1) / per != n / per) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((n / per) % stages));
    }
  };
  auto wait_for = [&](int n) {   // item n's stage has landed (n starts its stage)
    const int i = n / per;
    mbar_wait(full(i % stages), (uint32_t)((i / stages) & 1));
  };
  Octet q;
  for (int n = 0; n < n_items; ++n) {
    if (n % per == 0) wait_for(n);
    load(n, q);
    compute(q);
    done(n);
  }

  // red[warp][strip][column]: every B column holds x, so every lane's c0 /
  // c2 is its columns' sum; lanes t = 0 store them, the warps are added in
  // warp order
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + L.ring + L.x);
  if (t == 0) {
#pragma unroll
    for (int j = 0; j < kStrips; ++j) {
      float c0 = acc[j][0][0], c2 = acc[j][0][2];
#pragma unroll
      for (int c = 1; c < kChains; ++c) {
        c0 += acc[j][c][0];
        c2 += acc[j][c][2];
      }
      red[(warp * kStrips + j) * kStripCols + g] = c0;
      red[(warp * kStrips + j) * kStripCols + g + 8] = c2;
    }
  }
  named_barrier(1, 32 * kWarps);
  for (int c = tid; c < C; c += 32 * kWarps) {
    const int n = n0 + c;
    if (n >= N) break;
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += red[(k * kStrips + w * NS) * kStripCols + c];
      v[w] = sum;
    }
    out[n] = __float2bfloat16_rn(gptq::epilogue<NW>(v, bias, n));
  }
}

// gptq_wg::map_2d, each map encoded once: a map depends on its arguments
// alone, and an eager decode step launches kernels 1 and 2 about 200 times,
// where encoding three maps a launch cost the host more than the launch.
// Kept for every (pointer, shape, box) seen, cleared past 4096 of them; in
// an unnamed namespace, so each library keeps its own (a function-local
// static of an inline function is otherwise one symbol across libraries).
namespace {
inline bool cached_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                          int rows, int cols, int box_cols, int box_rows,
                          CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* ptr;
    int type, rows, cols, box_cols, box_rows, swizzle;
    bool operator==(const Key& o) const {
      return ptr == o.ptr && type == o.type && rows == o.rows && cols == o.cols &&
             box_cols == o.box_cols && box_rows == o.box_rows && swizzle == o.swizzle;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = std::hash<const void*>()(k.ptr);
      for (int v : {k.type, k.rows, k.cols, k.box_cols, k.box_rows, k.swizzle})
        h = h * 1000003u ^ static_cast<size_t>(v);
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  const Key key{ptr, static_cast<int>(type), rows, cols, box_cols, box_rows,
                static_cast<int>(swizzle)};
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = maps.find(key);
    if (it != maps.end()) {
      *map = it->second;
      return true;
    }
  }
  if (!gptq_wg::map_2d(map, type, elem, ptr, rows, cols, box_cols, box_rows, swizzle))
    return false;
  std::lock_guard<std::mutex> lock(mu);
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *map);
  return true;
}
}  // namespace

// One launch at M = 1: x (1, K) bf16; the packed weight (K * BITS / 32, N),
// scales and zeros (G, N) (kernel 2: w the gate's, w2 the up's, of one
// shape; kernel 1 ignores w2); out (1, N). Sets the dynamic shared memory
// attribute once per instantiation (not per launch, so a CUDA-graph capture
// sees none).
template <int BITS, int NW, int NS>
cudaError_t launch(const __nv_bfloat16* x, gptq::Stream w, gptq::Stream w2,
                   const __nv_bfloat16* bias, __nv_bfloat16* out, int K, int N, int G,
                   int groupsize, int rows, int sz_rows, int stages, int smem_bytes,
                   cudaStream_t stream) {
  constexpr int kR = 32 / BITS;
  constexpr int C = NS * kStripCols;
  const Layout L = layout(NW, NS, rows, sz_rows, K, stages);
  // the wrapper's plan computes the same size; a disagreement is a fault
  if (smem_bytes != L.bytes || L.bytes > kSmemLimit || K < 8 || K % 8 || N < 8 || N % 8 ||
      G < 1 || groupsize < 1 || groupsize % (4 * kR) ||
      (rows != 64 && rows != 128 && rows != 256) || rows % (8 * consumer_warps(NW * NS)) ||
      sz_rows < 1 || sz_rows > 256 ||
      stages < 1 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  auto kern = qmm_decode_kernel<BITS, NW, NS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  auto weight_maps = [&](gptq::Stream s, CUtensorMap* mw, CUtensorMap* ms, CUtensorMap* mz) {
    return cached_map_2d(mw, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, s.qweight, K / kR, N, kStripCols,
                         rows, CU_TENSOR_MAP_SWIZZLE_64B) &&
           cached_map_2d(ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, s.scales, G, N, C, sz_rows,
                         CU_TENSOR_MAP_SWIZZLE_NONE) &&
           cached_map_2d(mz, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, s.zeros, G, N, C, sz_rows,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  CUtensorMap tw, ts, tz, tw2, ts2, tz2;
  if (!weight_maps(w, &tw, &ts, &tz)) return cudaErrorInvalidValue;
  if constexpr (NW == 2) {
    if (!weight_maps(w2, &tw2, &ts2, &tz2)) return cudaErrorInvalidValue;
  } else {   // unused by kernel 1
    tw2 = tw;
    ts2 = ts;
    tz2 = tz;
  }
  constexpr int kThreads = 32 * (consumer_warps(NW * NS) + 1);
  kern<<<(N + C - 1) / C, kThreads, L.bytes, stream>>>(tw, ts, tz, tw2, ts2, tz2, x, bias, out, K,
                                                       N, G, groupsize, rows, sz_rows, stages);
  return cudaGetLastError();
}

// bits 2, 4 or 8 and the strips of each weight a block (kernel 1: 1-6;
// kernel 2: 1-3, as matmul.DEC_STRIPS) of one kernel
template <int NW>
cudaError_t launch_bits(int bits, const __nv_bfloat16* x, gptq::Stream w, gptq::Stream w2,
                        const __nv_bfloat16* bias, __nv_bfloat16* out, int K, int N, int G,
                        int groupsize, int strips, int rows, int sz_rows, int stages,
                        int smem_bytes, cudaStream_t stream) {
#define GPTQ_DEC(B, S)                                                                       \
  launch<B, NW, S>(x, w, w2, bias, out, K, N, G, groupsize, rows, sz_rows, stages,            \
                   smem_bytes, stream)
#define GPTQ_DEC_NS(B)                                                                       \
  (strips == 1 ? GPTQ_DEC(B, 1) : strips == 2 ? GPTQ_DEC(B, 2) : strips == 3 ? GPTQ_DEC(B, 3) \
   : NW == 1 && strips == 4 ? GPTQ_DEC(B, NW == 1 ? 4 : 1)                                   \
   : NW == 1 && strips == 5 ? GPTQ_DEC(B, NW == 1 ? 5 : 1)                                   \
   : NW == 1 && strips == 6 ? GPTQ_DEC(B, NW == 1 ? 6 : 1) : cudaErrorInvalidValue)
  switch (bits) {
    case 2: return GPTQ_DEC_NS(2);
    case 4: return GPTQ_DEC_NS(4);
    case 8: return GPTQ_DEC_NS(8);
    default: return cudaErrorInvalidValue;
  }
#undef GPTQ_DEC_NS
#undef GPTQ_DEC
}

}  // namespace gptq_dec
