// Dequant-GEMM over bit-packed weights: y = x @ dequant(W) (+ bias).
//
// Replaces gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel. Five forms,
// chosen by the wrapper's plan (gptq_for_llama_tpu_torch/ops/cuda/matmul.py)
// from M and the group size: gptq_qmm_decode, the batch-1 decode form of
// qmm_decode.cuh (a TMA ring of the packed words, one block per column
// tile), at M = 1; gptq_qmm_frag, the register-fragment form of
// qmm_frag.cuh with one stream, for 2-16 rows; gptq_qmm, the one-launch GEMV
// of qmm_gemv.cuh, where the group size does not suit the fragments (and any
// M whose shape the tiles do not take); above 16 rows gptq_qmm_wgmma, the
// Hopper body of qmm_wgmma.cuh (wgmma fed by TMA), where the group size
// suits it and it measured faster, else gptq_qmm_tile, the mma.sync tiles of
// qmm_tc.cuh. Each header describes its bound and design. Plain C entry
// points, bound from Python with ctypes.
#include "qmm_common.cuh"
#include "qmm_decode.cuh"
#include "qmm_frag.cuh"
#include "qmm_gemv.cuh"
#include "qmm_tc.cuh"
#include "qmm_wgmma.cuh"

namespace {

gptq::Stream stream_of(const void* qweight, const void* scales, const void* zeros) {
  return {static_cast<const int32_t*>(qweight), static_cast<const __nv_bfloat16*>(scales),
          static_cast<const __nv_bfloat16*>(zeros)};
}

}  // namespace

// x (M, K) bf16; qweight (K * bits / 32, N) int32 with N % 4 == 0; scales,
// zeros (G, N) bf16; mt: rows per block (1, 2, 4, 8); split: blocks along K,
// one cluster (a power of two up to 16); smem_bytes: the plan's size of the
// block's shared memory.
extern "C" int gptq_qmm(const void* x, const void* qweight, const void* scales,
                        const void* zeros, const void* bias, void* out, int M, int K, int N,
                        int G, int groupsize, int bits, int mt, int split, int words_per_split,
                        int smem_bytes, void* stream) {
  const gptq::Stream s0 = stream_of(qweight, scales, zeros);
  return static_cast<int>(gptq_gemv::launch<1>(
      bits, mt, static_cast<const __nv_bfloat16*>(x), s0, s0,
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, K, N, G,
      groupsize, split, words_per_split, smem_bytes, static_cast<cudaStream_t>(stream)));
}

// x (M, K) bf16, M <= 8 * nt, K % 8 == 0; qweight (K * bits / 32, N) int32
// with N % 8 == 0; scales, zeros (G, N) bf16 with groupsize a multiple of
// 128 / bits; nt: n8 tiles of rows (1 or 2); split: blocks along K, one
// cluster; kb_per_split: K-blocks of 128 / bits rows per split.
extern "C" int gptq_qmm_frag(const void* x, const void* qweight, const void* scales,
                             const void* zeros, const void* bias, void* out, int M, int K, int N,
                             int G, int groupsize, int bits, int nt, int split, int kb_per_split,
                             int smem_bytes, void* stream) {
  const gptq::Stream s0 = stream_of(qweight, scales, zeros);
  return static_cast<int>(gptq_frag::launch_bits<1>(
      bits, nt, static_cast<const __nv_bfloat16*>(x), s0, s0,
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, K, N, G,
      groupsize, split, kb_per_split, smem_bytes, static_cast<cudaStream_t>(stream)));
}

// x (M, K) bf16 with K % 8 == 0; qweight (K * bits / 32, N) int32 with
// N % 8 == 0; scales, zeros (G, N) bf16; partial (split, M, N) fp32 when
// split > 1; bm: the row tile (64, 128, 256); smem_bytes: the plan's size of
// the block's shared memory.
extern "C" int gptq_qmm_tile(const void* x, const void* qweight, const void* scales,
                             const void* zeros, const void* bias, void* out, void* partial,
                             int M, int K, int N, int G, int groupsize, int bits, int bm,
                             int split, int slabs_per_split, int smem_bytes, void* stream) {
  const int n_slabs = (K + gptq_tc::kBK - 1) / gptq_tc::kBK;
  if (M < 1 || K < 8 || K % 8 || N < 8 || N % 8 || G < 1 || groupsize < 1 || split < 1 ||
      slabs_per_split < 1 || (long long)split * slabs_per_split < n_slabs || split > 65535 ||
      (bm != 64 && bm != 128 && bm != 256) || (M + bm - 1) / bm > 65535 ||
      (split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const gptq::Stream s0 = stream_of(qweight, scales, zeros);
  const auto xb = static_cast<const __nv_bfloat16*>(x);
  const auto bb = static_cast<const __nv_bfloat16*>(bias);
  const auto ob = static_cast<__nv_bfloat16*>(out);
  const auto pb = static_cast<float*>(partial);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPTQ_TILE(B, R)                                                                     \
  gptq_tc::launch_tile<B, 1, R>(xb, s0, s0, bb, ob, pb, M, K, N, G, groupsize, split,       \
                                slabs_per_split, smem_bytes, st)
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

// x (M, K) bf16 with K % 8 == 0; qweight (K * bits / 32, N) int32 with
// N % 8 == 0; scales, zeros (G, N) bf16, groupsize % 16 == 0 or G == 1;
// partial (split, M, N) fp32 when split > 1; bm: the row tile (64, 128, 144,
// 256); slabs_per_split: 64-row slabs of K per split; sz_rows: the scale rows
// of the most groups a slab touches (1, 2 or 4); smem_bytes: the plan's size.
extern "C" int gptq_qmm_wgmma(const void* x, const void* qweight, const void* scales,
                              const void* zeros, const void* bias, void* out, void* partial,
                              int M, int K, int N, int G, int groupsize, int bits, int bm,
                              int split, int slabs_per_split, int sz_rows, int smem_bytes,
                              void* stream) {
  const gptq::Stream w{static_cast<const int32_t*>(qweight),
                       static_cast<const __nv_bfloat16*>(scales),
                       static_cast<const __nv_bfloat16*>(zeros)};
  return static_cast<int>(gptq_wg::launch_bits<false, 1>(
      bits, bm, x, w, w, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), M, K, N, G, groupsize, split, slabs_per_split, sz_rows,
      smem_bytes, static_cast<cudaStream_t>(stream)));
}

// x (1, K) bf16 with K % 8 == 0; qweight (K * bits / 32, N) int32 with
// N % 8 == 0; scales, zeros (G, N) bf16 with groupsize a multiple of 128 /
// bits; strips: 16-column strips a block; rows: packed word rows a stage
// (64, 128, 256); sz_rows: the scale rows of the most groups a stage
// touches; stages: the ring's depth; smem_bytes: the plan's size.
extern "C" int gptq_qmm_decode(const void* x, const void* qweight, const void* scales,
                               const void* zeros, const void* bias, void* out, int K, int N,
                               int G, int groupsize, int bits, int strips, int rows, int sz_rows,
                               int stages, int smem_bytes, void* stream) {
  const gptq::Stream s0 = stream_of(qweight, scales, zeros);
  return static_cast<int>(gptq_dec::launch_bits<1>(
      bits, static_cast<const __nv_bfloat16*>(x), s0, s0, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), K, N, G, groupsize, strips, rows, sz_rows, stages,
      smem_bytes, static_cast<cudaStream_t>(stream)));
}
