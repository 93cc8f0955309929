// Fused quantized gate/up MLP: silu(x @ dequant(Wg)) * (x @ dequant(Wu)).
//
// Replaces gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel. x is read
// once for both weight streams and neither intermediate reaches device
// memory as bf16: the two fp32 sums meet in the epilogue. Five forms, chosen
// by the wrapper's plan (gptq_for_llama_tpu_torch/ops/cuda/matmul.py:plan,
// streams=2) from M and the group size:
//  - gptq_fused_mlp_decode: the batch-1 decode row, on qmm_decode.cuh (NW =
//    2: a TMA ring of both packed weights, each block the same columns of
//    the gate and the up weight), bound by the two packed weight streams
//    with their scales and zeros (2 x 23.9 MB at 4096x11008 INT4-g128:
//    14.3 us at 3.35 TB/s);
//  - gptq_fused_mlp: the one-launch GEMV of qmm_gemv.cuh (NW = 2) for the
//    batch-1 row where the group size does not suit the decode form;
//  - gptq_fused_mlp_frag: M <= 16, the weight dequantized straight into
//    mma.sync A fragments (qmm_frag.cuh, NW = 2);
//  - gptq_fused_mlp_wgmma: above that, where the group size is a multiple of
//    16 (or one group) and K and N of 8, the Hopper body of kernels 1 and 8
//    (qmm_wgmma.cuh, NW = 2: the gate and up weights dequantized into wgmma
//    A fragments by the two consumer warpgroups over one TMA ring of x),
//    bound by operations at large M (4 M K N flops: 2.99 ms at M = 16384);
//  - gptq_fused_mlp_tile: the other shapes above 16 rows, kernel 1's
//    mma.sync tiles with the two streams interleaved in one B tile
//    (qmm_tc.cuh, NW = 2).
// Each header describes its design. Plain C entry points, bound from Python
// with ctypes.
#include "qmm_common.cuh"
#include "qmm_decode.cuh"
#include "qmm_frag.cuh"
#include "qmm_gemv.cuh"
#include "qmm_tc.cuh"
#include "qmm_wgmma.cuh"

namespace {

struct Streams {
  gptq::Stream gate, up;
};

Streams streams(const void* qg, const void* sg, const void* zg, const void* qu, const void* su,
                const void* zu) {
  return {{static_cast<const int32_t*>(qg), static_cast<const __nv_bfloat16*>(sg),
           static_cast<const __nv_bfloat16*>(zg)},
          {static_cast<const int32_t*>(qu), static_cast<const __nv_bfloat16*>(su),
           static_cast<const __nv_bfloat16*>(zu)}};
}

}  // namespace

// x (M, K) bf16; qweights (K * bits / 32, N) int32 with N % 4 == 0; scales,
// zeros (G, N) bf16; mt, split, words_per_split, smem_bytes: kernel 1's
// gptq_qmm.
extern "C" int gptq_fused_mlp(const void* x, const void* qg, const void* sg, const void* zg,
                              const void* qu, const void* su, const void* zu, void* out, int M,
                              int K, int N, int G, int groupsize, int bits, int mt, int split,
                              int words_per_split, int smem_bytes, void* stream) {
  const Streams s = streams(qg, sg, zg, qu, su, zu);
  return static_cast<int>(gptq_gemv::launch<2>(
      bits, mt, static_cast<const __nv_bfloat16*>(x), s.gate, s.up, nullptr,
      static_cast<__nv_bfloat16*>(out), M, K, N, G, groupsize, split, words_per_split,
      smem_bytes, static_cast<cudaStream_t>(stream)));
}

// x (M, K) bf16, M <= 8 * nt, K % 8 == 0; qweights (K * bits / 32, N) int32
// with N % 8 == 0; scales, zeros (G, N) bf16 with groupsize a multiple of
// 128 / bits; nt: n8 tiles of rows (1 or 2); split: blocks along K, one
// cluster; kb_per_split: K-blocks of 128 / bits rows per split.
extern "C" int gptq_fused_mlp_frag(const void* x, const void* qg, const void* sg, const void* zg,
                                   const void* qu, const void* su, const void* zu, void* out,
                                   int M, int K, int N, int G, int groupsize, int bits, int nt,
                                   int split, int kb_per_split, int smem_bytes, void* stream) {
  const Streams s = streams(qg, sg, zg, qu, su, zu);
  return static_cast<int>(gptq_frag::launch_bits<2>(
      bits, nt, static_cast<const __nv_bfloat16*>(x), s.gate, s.up, nullptr,
      static_cast<__nv_bfloat16*>(out), M, K, N, G, groupsize, split, kb_per_split, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

// x (M, K) bf16 with K % 8 == 0; qweights (K * bits / 32, N) int32 with
// N % 8 == 0; scales, zeros (G, N) bf16; partial (2, split, M, N) fp32 when
// split > 1; bm: the row tile (64, 128, 256); smem_bytes: the plan's size of
// the block's shared memory. A block covers 64 columns of y.
extern "C" int gptq_fused_mlp_tile(const void* x, const void* qg, const void* sg, const void* zg,
                                   const void* qu, const void* su, const void* zu, void* out,
                                   void* partial, int M, int K, int N, int G, int groupsize,
                                   int bits, int bm, int split, int slabs_per_split,
                                   int smem_bytes, void* stream) {
  const int n_slabs = (K + gptq_tc::kBK - 1) / gptq_tc::kBK;
  if (M < 1 || K < 8 || K % 8 || N < 8 || N % 8 || G < 1 || groupsize < 1 || split < 1 ||
      slabs_per_split < 1 || (long long)split * slabs_per_split < n_slabs || split > 65535 ||
      (bm != 64 && bm != 128 && bm != 256) || (M + bm - 1) / bm > 65535 ||
      (split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Streams s = streams(qg, sg, zg, qu, su, zu);
  const auto xb = static_cast<const __nv_bfloat16*>(x);
  const auto ob = static_cast<__nv_bfloat16*>(out);
  const auto pb = static_cast<float*>(partial);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPTQ_TILE(B, R)                                                                     \
  gptq_tc::launch_tile<B, 2, R>(xb, s.gate, s.up, nullptr, ob, pb, M, K, N, G, groupsize,   \
                                split, slabs_per_split, smem_bytes, st)
#define GPTQ_TILES(B) (bm == 64 ? GPTQ_TILE(B, 64) : bm == 128 ? GPTQ_TILE(B, 128) : GPTQ_TILE(B, 256))
  cudaError_t e;
  switch (bits) {
    case 2: e = GPTQ_TILES(2); break;
    case 4: e = GPTQ_TILES(4); break;
    case 8: e = GPTQ_TILES(8); break;
    default: e = cudaErrorInvalidValue;
  }
#undef GPTQ_TILES
#undef GPTQ_TILE
  return static_cast<int>(e);
}

// x (M, K) bf16 with K % 8 == 0; qweights (K * bits / 32, N) int32 with
// N % 8 == 0; scales, zeros (G, N) bf16, groupsize % 16 == 0 or G == 1;
// partial (2, split, M, N) fp32 when split > 1; bm: the row tile (64, 128,
// 144, 256); slabs_per_split: 64-row slabs of K per split; sz_rows: the
// scale rows of the most groups a slab touches (1, 2 or 4); smem_bytes: the
// plan's size. A block covers 64 columns of y.
extern "C" int gptq_fused_mlp_wgmma(const void* x, const void* qg, const void* sg, const void* zg,
                                    const void* qu, const void* su, const void* zu, void* out,
                                    void* partial, int M, int K, int N, int G, int groupsize,
                                    int bits, int bm, int split, int slabs_per_split, int sz_rows,
                                    int smem_bytes, void* stream) {
  const Streams s = streams(qg, sg, zg, qu, su, zu);
  return static_cast<int>(gptq_wg::launch_bits<false, 2>(
      bits, bm, x, s.gate, s.up, nullptr, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), M, K, N, G, groupsize, split, slabs_per_split, sz_rows,
      smem_bytes, static_cast<cudaStream_t>(stream)));
}

// x (1, K) bf16 with K % 8 == 0; qweights (K * bits / 32, N) int32 with
// N % 8 == 0; scales, zeros (G, N) bf16 with groupsize a multiple of 128 /
// bits; strips: 16-column strips of each weight a block; rows, sz_rows,
// stages, smem_bytes: kernel 1's gptq_qmm_decode.
extern "C" int gptq_fused_mlp_decode(const void* x, const void* qg, const void* sg, const void* zg,
                                     const void* qu, const void* su, const void* zu, void* out,
                                     int K, int N, int G, int groupsize, int bits, int strips,
                                     int rows, int sz_rows, int stages, int smem_bytes,
                                     void* stream) {
  const Streams s = streams(qg, sg, zg, qu, su, zu);
  return static_cast<int>(gptq_dec::launch_bits<2>(
      bits, static_cast<const __nv_bfloat16*>(x), s.gate, s.up, nullptr,
      static_cast<__nv_bfloat16*>(out), K, N, G, groupsize, strips, rows, sz_rows, stages,
      smem_bytes, static_cast<cudaStream_t>(stream)));
}
