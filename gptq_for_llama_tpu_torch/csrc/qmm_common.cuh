// Shared body of the dequant-GEMM kernels (qmm.cu: one packed weight stream;
// fused_mlp.cu: two streams with the SiLU-mul epilogue).
//
// Replaces the TPU kernels gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel
// and gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel.
//
// y[m, n] = sum_k x[m, k] * (code[k, n] - zero[g(k), n]) * scale[g(k), n]
//
// Weight layout: the reference wire layout, rows packed along K. One int32
// word holds 32/BITS consecutive K-rows of one column, little-endian, so a
// thread that owns 4 neighbouring columns reads 16 contiguous bytes per
// packed row and a warp reads 512 contiguous bytes: every weight byte is read
// once, coalesced.
//
// What bounds it on the H100: at decode (a few rows) the packed weight stream,
// i.e. device-memory bytes (a 4096x4096 INT4-g128 linear moves 8.9 MB with
// its scales and zeros: 2.66 us at 3.35 TB/s). The design keeps the weight
// bytes the only large traffic and spends few instructions per weight:
//  - dot-then-scale (the TPU kernel's trick): codes are converted to float
//    and dotted with x per group; the affine correction
//    s_g * (x_g . c_g - z_g * sum(x_g)) is applied once per group and column;
//  - codes become floats with one OR and one FADD (2^23 magic number) instead
//    of the quarter-rate integer-to-float conversion;
//  - x lives in shared memory as fp32 and is read as broadcast float4s;
//  - the grid splits K across blocks so that N = 4096 still fills 132 SMs
//    (32 column tiles x 17 K-splits at M = 1, K = 4096; the wrapper plans
//    the split, ops/cuda/matmul.py:plan); each block reduces its 8 warps in
//    shared memory, and a second small kernel sums the K-splits in a fixed
//    order (deterministic, no atomics).
// Kernel 1 uses this body only for decode (M <= 4); kernel 2 at M = 1, and
// up to 16 rows where its group size does not suit qmm_frag.cuh (a group
// boundary inside a K-block). Above that both run tensor cores (qmm_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gptq {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;                 // columns per thread (one int4 load)
constexpr int kTileN = 32 * kCols;       // columns per block
constexpr size_t kMaxSmem = 100 * 1024;  // dynamic shared memory cap (wrapper plans below it)

// 2^23 + c has c in its mantissa: exact for c < 2^23.
template <int BITS>
__device__ __forceinline__ float code_f(uint32_t w, int j) {
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  return __uint_as_float(((w >> (BITS * j)) & kMask) | 0x4B000000u) - 8388608.0f;
}

__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float out[4]) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  float2 fa = __bfloat1622float2(a);
  float2 fb = __bfloat1622float2(b);
  out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
}

struct Stream {
  const int32_t* qweight;        // (K*BITS/32, N)
  const __nv_bfloat16* scales;   // (G, N)
  const __nv_bfloat16* zeros;    // (G, N), effective zero (qzeros + 1)
};

// Epilogue of one output element from its fp32 sums (one per stream).
template <int NW>
__device__ __forceinline__ float epilogue(const float v[NW], const __nv_bfloat16* bias, int n) {
  if constexpr (NW == 1) {
    return bias != nullptr ? v[0] + __bfloat162float(bias[n]) : v[0];
  } else {
    const float g = v[0];
    return __fdividef(g, 1.0f + __expf(-g)) * v[1];   // silu(gate) * up, fp32
  }
}

// grid: (ceil(N / kTileN), split, ceil(M / MT)); block: kThreads.
// Dynamic shared memory: max(MT * rows_per_split, kWarps * NW * MT * kTileN) floats.
// split == gridDim.y; with split > 1 the block writes fp32 partials
// partial[((nw * split + y) * M + m) * N + n], else the finished output.
template <int BITS, int MT, int NW>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, Stream s0, Stream s1,
           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
           float* __restrict__ partial, int M, int K, int N, int G, int groupsize,
           int words_per_split) {
  constexpr int kIpw = 32 / BITS;   // codes per word
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = gridDim.y;
  const int kw = K / kIpw;
  const int w_begin = blockIdx.y * words_per_split;
  const int w_end = min(kw, w_begin + words_per_split);
  const int r_begin = w_begin * kIpw;
  const int rows = max(0, (w_end - w_begin) * kIpw);
  const int rows_pad = words_per_split * kIpw;   // smem row stride (multiple of 4)
  const int m0 = blockIdx.z * MT;
  const int col = blockIdx.x * kTileN + lane * kCols;
  const bool valid = col < N;

  // x rows [m0, m0+MT) x [r_begin, r_begin+rows) -> fp32 shared memory
  for (int i = tid; i < MT * rows; i += kThreads) {
    const int m = i / rows, r = i - m * rows;
    smem[m * rows_pad + r] =
        (m0 + m < M) ? __bfloat162float(x[(size_t)(m0 + m) * K + r_begin + r]) : 0.0f;
  }
  __syncthreads();

  float acc[NW][MT][kCols];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[w][m][c] = 0.0f;

  const int wpw = (w_end - w_begin + kWarps - 1) / kWarps;   // words per warp
  const int wa = w_begin + warp * wpw;
  const int wb = min(w_end, wa + wpw);

  float p[NW][MT][kCols];   // x . codes over the current group segment
  float sx[MT];             // sum of x over the current group segment
  int cur_g = -1;
  int next_b = 0;           // first row of the group after cur_g

  auto flush = [&]() {
    if (cur_g < 0) return;
    float sc[NW][kCols], zz[NW][kCols];
    if (valid) {
      load_bf16x4(s0.scales + (size_t)cur_g * N + col, sc[0]);
      load_bf16x4(s0.zeros + (size_t)cur_g * N + col, zz[0]);
      if constexpr (NW == 2) {
        load_bf16x4(s1.scales + (size_t)cur_g * N + col, sc[NW - 1]);
        load_bf16x4(s1.zeros + (size_t)cur_g * N + col, zz[NW - 1]);
      }
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int c = 0; c < kCols; ++c) { sc[w][c] = 0.0f; zz[w][c] = 0.0f; }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[w][m][c] += sc[w][c] * (p[w][m][c] - zz[w][c] * sx[m]);
  };
  auto start_group = [&](int g) {
    cur_g = g;
    next_b = (g >= G - 1) ? 0x7fffffff : (g + 1) * groupsize;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) p[w][m][c] = 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) sx[m] = 0.0f;
  };

  // one packed word (kCols columns per stream) into the group partials
  auto word = [&](int wd, const uint32_t (&q)[NW][kCols]) {
    const int r0 = wd * kIpw;
    const float* xr = smem + (r0 - r_begin);
    if (cur_g < 0 || r0 + kIpw > next_b) {
      const int g0 = min(r0 / groupsize, G - 1);
      const int end0 = (g0 >= G - 1) ? 0x7fffffff : (g0 + 1) * groupsize;
      if (r0 + kIpw > end0) {
        // a group boundary falls inside this word (groupsize not a multiple
        // of 32/BITS): accumulate row by row, flushing at each boundary
#pragma unroll
        for (int j = 0; j < kIpw; ++j) {
          const int r = r0 + j;
          if (cur_g < 0 || r >= next_b) {
            flush();
            start_group(min(r / groupsize, G - 1));
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xr[m * rows_pad + j];
            sx[m] += xv;
#pragma unroll
            for (int w = 0; w < NW; ++w)
#pragma unroll
              for (int c = 0; c < kCols; ++c) p[w][m][c] += xv * code_f<BITS>(q[w][c], j);
          }
        }
        return;
      }
      if (g0 != cur_g) {
        flush();
        start_group(g0);
      }
    }
#pragma unroll
    for (int j4 = 0; j4 < kIpw; j4 += 4) {
      float xv[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(xr + m * rows_pad + j4);
        xv[m][0] = v.x; xv[m][1] = v.y; xv[m][2] = v.z; xv[m][3] = v.w;
        sx[m] += (v.x + v.y) + (v.z + v.w);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float cf = code_f<BITS>(q[w][c], j4 + jj);
#pragma unroll
            for (int m = 0; m < MT; ++m) p[w][m][c] += xv[m][jj] * cf;
          }
      }
    }
  };

  // Row tiles of 4-8 (prefill) issue two words' loads before using either;
  // at decode (MT <= 2) a deeper batch costs registers and occupancy for no
  // gain (PERF.md, PR 1 findings).
  constexpr int kBatch = MT >= 4 ? 2 : 1;
  for (int wd0 = wa; wd0 < wb; wd0 += kBatch) {
    uint32_t q[kBatch][NW][kCols];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int wd = wd0 + u;
      if (valid && wd < wb) {
        const int4 a = *reinterpret_cast<const int4*>(s0.qweight + (size_t)wd * N + col);
        q[u][0][0] = a.x; q[u][0][1] = a.y; q[u][0][2] = a.z; q[u][0][3] = a.w;
        if constexpr (NW == 2) {
          const int4 b = *reinterpret_cast<const int4*>(s1.qweight + (size_t)wd * N + col);
          q[u][NW - 1][0] = b.x; q[u][NW - 1][1] = b.y;
          q[u][NW - 1][2] = b.z; q[u][NW - 1][3] = b.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int c = 0; c < kCols; ++c) q[u][w][c] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (wd0 + u < wb) word(wd0 + u, q[u]);
  }
  flush();

  // reduce the 8 warps' partial sums through shared memory (x is dead now)
  __syncthreads();
  float* red = smem;   // [kWarps][NW][MT][kTileN]
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      *reinterpret_cast<float4*>(red + ((warp * NW + w) * MT + m) * kTileN + lane * kCols) =
          make_float4(acc[w][m][0], acc[w][m][1], acc[w][m][2], acc[w][m][3]);
  __syncthreads();

  for (int i = tid; i < MT * kTileN; i += kThreads) {
    const int m = i / kTileN, cc = i - m * kTileN;
    const int n = blockIdx.x * kTileN + cc;
    if (m0 + m >= M || n >= N) continue;
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float t = 0.0f;
      for (int k = 0; k < kWarps; ++k) t += red[((k * NW + w) * MT + m) * kTileN + cc];
      v[w] = t;
    }
    if (split == 1) {
      out[(size_t)(m0 + m) * N + n] = __float2bfloat16_rn(epilogue<NW>(v, bias, n));
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w)
        partial[((size_t)(w * split + blockIdx.y) * M + m0 + m) * N + n] = v[w];
    }
  }
}

// Sums the K-splits in order (deterministic) and applies the epilogue.
template <int NW>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const __nv_bfloat16* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ out, int M, int N, int split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int n = (int)(i % N);
  float v[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    float t = 0.0f;
    for (int s = 0; s < split; ++s) t += partial[(size_t)(w * split + s) * M * N + i];
    v[w] = t;
  }
  out[i] = __float2bfloat16_rn(epilogue<NW>(v, bias, n));
}

inline size_t qmm_smem_bytes(int mt, int nw, int rows_per_split) {
  const size_t xb = (size_t)mt * rows_per_split * sizeof(float);
  const size_t rb = (size_t)kWarps * nw * mt * kTileN * sizeof(float);
  return xb > rb ? xb : rb;
}

template <int BITS, int MT, int NW>
cudaError_t launch_mt(const __nv_bfloat16* x, Stream s0, Stream s1, const __nv_bfloat16* bias,
                      __nv_bfloat16* out, float* partial, int M, int K, int N, int G,
                      int groupsize, int split, int words_per_split, cudaStream_t stream) {
  constexpr int kIpw = 32 / BITS;
  const size_t smem = qmm_smem_bytes(MT, NW, words_per_split * kIpw);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = qmm_kernel<BITS, MT, NW>;
  // once per instantiation (not per launch, so a CUDA-graph capture sees none)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kTileN - 1) / kTileN, split, (M + MT - 1) / MT);
  kern<<<grid, kThreads, smem, stream>>>(x, s0, s1, bias, out, partial, M, K, N, G, groupsize,
                                         words_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const size_t total = (size_t)M * N;
  qmm_reduce_kernel<NW><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(partial, bias, out,
                                                                             M, N, split);
  return cudaGetLastError();
}

template <int BITS, int NW>
cudaError_t launch_bits(int mt, const __nv_bfloat16* x, Stream s0, Stream s1,
                        const __nv_bfloat16* bias, __nv_bfloat16* out, float* partial, int M,
                        int K, int N, int G, int groupsize, int split, int words_per_split,
                        cudaStream_t stream) {
  switch (mt) {
    case 1: return launch_mt<BITS, 1, NW>(x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    case 2: return launch_mt<BITS, 2, NW>(x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    case 4: return launch_mt<BITS, 4, NW>(x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    case 8: return launch_mt<BITS, 8, NW>(x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int NW>
cudaError_t launch(int bits, int mt, const __nv_bfloat16* x, Stream s0, Stream s1,
                   const __nv_bfloat16* bias, __nv_bfloat16* out, float* partial, int M, int K,
                   int N, int G, int groupsize, int split, int words_per_split,
                   cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_bits<2, NW>(mt, x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    case 4: return launch_bits<4, NW>(mt, x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    case 8: return launch_bits<8, NW>(mt, x, s0, s1, bias, out, partial, M, K, N, G, groupsize, split, words_per_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gptq

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
