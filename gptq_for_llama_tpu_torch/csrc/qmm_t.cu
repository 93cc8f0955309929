// Grad-input of the dequant-GEMM on bf16 tensor cores: dx = g @ dequant(W)^T.
//
// Replaces gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_t_kernel (entry
// quant_matmul_t_pallas), the backward of every frozen packed linear when
// adapters train (LoRA). g (M, N) bf16, W the packed (K, N) weight in device
// row order; dx (M, K) bf16 in device row order (the wrapper applies the
// inverse act-order permutation). Each weight element is dequantized as the
// TPU kernel does, c * s - z * s in fp32 rounded to bf16 (both products are
// exact in fp32, so this is also bit-equal to the plain version's
// (c - z) * s), and the product accumulates in fp32.
//
// What bounds it on the H100: operations at training row counts. At M = 1024
// a 4096 x 4096 linear is 34.4 GFLOP (34.7 us at 989 TFLOP/s) against 7.5 us
// for its bytes; down_proj's transpose and gate/up's are 93.4 us each.
// The scale varies along the reduction axis (it is indexed by n), so the
// forward kernel's dot-then-scale trick does not transpose. Design:
//  - one block of 8 warps per (128-row, 128-column) tile of dx; it loops over
//    N, the reduction, in slices of 64 inside the block, so nothing carries
//    across blocks and the result is deterministic;
//  - per slice, g's (128 x 64) tile is copied to shared memory with cp.async
//    while the block dequantizes W's (128 x 64) tile from its packed words
//    into shared memory as bf16. qweight packs consecutive K rows in one word
//    and is contiguous along N: a warp reads 32 neighbouring words (128 B,
//    coalesced) and writes 32 neighbouring bf16 of each of their rows. The
//    next slice's words are loaded into registers before this slice's
//    products, so their latency hides behind the tensor cores;
//  - the products are mma.sync.m16n8k16 bf16 with fp32 accumulators (the
//    fragment code of flash_prefill.cu, mma_sync.cuh); each warp owns a
//    32 x 64 piece of the tile.
// Not yet: wgmma and TMA, or a split of N for small M (M <= 128 gives only
// K / 128 blocks).
#include "mma_sync.cuh"
#include "qmm_common.cuh"

namespace {

using namespace gptq_mma;

constexpr int kBM = 128;                 // rows of g and dx per block
constexpr int kBK = 128;                 // columns of dx (rows of W) per block
constexpr int kBN = 64;                  // reduction slice per step
constexpr int kThreads = 256;
constexpr int kStride = kBN + 8;         // bf16 per smem row: 144 B, conflict-free ldmatrix

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qmm_t_kernel(const __nv_bfloat16* __restrict__ g,   // (M, N)
             gptq::Stream w,                        // packed (K, N)
             __nv_bfloat16* __restrict__ dx,        // (M, K)
             int M, int K, int N, int G, int groupsize) {
  constexpr int kIpw = 32 / BITS;                       // rows of W per packed word
  constexpr int kWordRows = kBK / kIpw;                 // packed rows of one tile
  constexpr int kWords = kWordRows * kBN / kThreads;    // packed words per thread and slice
  __shared__ __align__(16) __nv_bfloat16 gs[kBM * kStride];
  __shared__ __align__(16) __nv_bfloat16 ws[kBK * kStride];

  const int k0 = blockIdx.x * kBK, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32;   // this warp's rows of the tile
  const int wk = (warp & 1) * 64;    // and columns
  const int kw = K / kIpw, w0 = k0 / kIpw;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // this thread's words of a slice: packed row (tid / kBN) + u * (kThreads / kBN),
  // column tid % kBN
  const int nl = tid % kBN;
  uint32_t q[kWords];
  auto load_words = [&](int n0) {
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int wd = w0 + tid / kBN + u * (kThreads / kBN), col = n0 + nl;
      q[u] = (wd < kw && col < N) ? static_cast<uint32_t>(w.qweight[(size_t)wd * N + col]) : 0u;
    }
  };
  load_words(0);

  for (int n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();   // every warp is done with the previous slice
    for (int c = tid; c < kBM * (kBN / 8); c += kThreads) {
      const int r = c / (kBN / 8), c8 = (c % (kBN / 8)) * 8;
      const bool ok = m0 + r < M && n0 + c8 < N;
      cp_async16(gs + r * kStride + c8, g + (ok ? (size_t)(m0 + r) * N + n0 + c8 : 0), ok);
    }
    cp_async_commit();
    const int col = n0 + nl;
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int wr = tid / kBN + u * (kThreads / kBN);
      const int r0 = (w0 + wr) * kIpw;   // first row of W in this word
      __nv_bfloat16* dst = ws + wr * kIpw * kStride + nl;
      if (w0 + wr < kw && col < N) {
        int gi = min(r0 / groupsize, G - 1);
        int next = gi >= G - 1 ? 0x7fffffff : (gi + 1) * groupsize;   // first row of gi + 1
        float s = __bfloat162float(w.scales[(size_t)gi * N + col]);
        float zs = __bfloat162float(w.zeros[(size_t)gi * N + col]) * s;
#pragma unroll
        for (int j = 0; j < kIpw; ++j) {
          if (r0 + j >= next) {   // a group boundary inside the word
            ++gi;
            next = gi >= G - 1 ? 0x7fffffff : next + groupsize;
            s = __bfloat162float(w.scales[(size_t)gi * N + col]);
            zs = __bfloat162float(w.zeros[(size_t)gi * N + col]) * s;
          }
          dst[j * kStride] = __float2bfloat16_rn(gptq::code_f<BITS>(q[u], j) * s - zs);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kIpw; ++j) dst[j * kStride] = __float2bfloat16_rn(0.0f);
      }
    }
    cp_async_wait_all();
    __syncthreads();   // g's tile landed, W's tile is written
    if (n0 + kBN < N) load_words(n0 + kBN);

#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], gs + (wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                            kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ws + (wk + np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma16816(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row_lo = m0 + wm + mi * 16 + gq, row_hi = row_lo + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = k0 + wk + nt * 8 + t4 * 2;   // K is even: the pair stays inside a row
      if (c >= K) continue;
      if (row_lo < M)
        *reinterpret_cast<uint32_t*>(dx + (size_t)row_lo * K + c) =
            pack_bf16(acc[mi][nt][0], acc[mi][nt][1]);
      if (row_hi < M)
        *reinterpret_cast<uint32_t*>(dx + (size_t)row_hi * K + c) =
            pack_bf16(acc[mi][nt][2], acc[mi][nt][3]);
    }
  }
}

template <int BITS>
cudaError_t launch(const void* g, gptq::Stream w, void* dx, int M, int K, int N, int G,
                   int groupsize, cudaStream_t stream) {
  dim3 grid((K + kBK - 1) / kBK, (M + kBM - 1) / kBM);
  qmm_t_kernel<BITS><<<grid, kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(g), w,
                                                    static_cast<__nv_bfloat16*>(dx), M, K, N, G,
                                                    groupsize);
  return cudaGetLastError();
}

}  // namespace

// g (M, N) bf16, contiguous, N % 8 == 0; qweight (K * bits / 32, N) int32;
// scales, zeros (G, N) bf16; dx (M, K) bf16. K a multiple of 32 / bits.
extern "C" int gptq_qmm_t(const void* g, const void* qweight, const void* scales,
                          const void* zeros, void* dx, int M, int K, int N, int G,
                          int groupsize, int bits, void* stream) {
  if (M < 1 || K < 1 || N < 8 || N % 8 != 0 || G < 1 || groupsize < 1 || M > 65535 * kBM ||
      (bits != 2 && bits != 4 && bits != 8) || K % (32 / bits) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const gptq::Stream w{static_cast<const int32_t*>(qweight),
                       static_cast<const __nv_bfloat16*>(scales),
                       static_cast<const __nv_bfloat16*>(zeros)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return static_cast<int>(launch<2>(g, w, dx, M, K, N, G, groupsize, st));
    case 4: return static_cast<int>(launch<4>(g, w, dx, M, K, N, G, groupsize, st));
    default: return static_cast<int>(launch<8>(g, w, dx, M, K, N, G, groupsize, st));
  }
}
