// Pieces shared by the dequant-GEMM kernels: kernel 1 (qmm.cu: one packed
// weight stream, optional bias) and kernel 2 (fused_mlp.cu: the gate and up
// streams with the SiLU-mul epilogue), in their three forms (the GEMV of
// qmm_gemv.cuh, the register fragments of qmm_frag.cuh and the tensor-core
// tiles of qmm_tc.cuh), and kernel 8 (qmm_t.cu).
//
// Replaces, with those forms, the TPU kernels
// gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel and
// gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel.
//
// y[m, n] = sum_k x[m, k] * (code[k, n] - zero[g(k), n]) * scale[g(k), n]
//
// Weight layout: the reference wire layout, rows packed along K. One int32
// word holds 32/BITS consecutive K-rows of one column, little-endian, so a
// thread that owns 4 neighbouring columns reads 16 contiguous bytes per
// packed row and a warp reads 512 contiguous bytes: every weight byte is read
// once, coalesced.
//
// Two ways to sum K-splits: the decode-width forms (GEMV and fragments) keep
// every split of an output tile in one thread block cluster and sum the
// blocks' partials over distributed shared memory in rank order
// (cluster_reduce: one launch, no atomics, the same bytes on every launch);
// the tiles and kernel 8 write fp32 partials that qmm_reduce_kernel sums in
// split order.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gptq {

// 2^23 + c has c in its mantissa: exact for c < 2^23.
template <int BITS>
__device__ __forceinline__ float code_f(uint32_t w, int j) {
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  return __uint_as_float(((w >> (BITS * j)) & kMask) | 0x4B000000u) - 8388608.0f;
}

// four bf16 (8 bytes) as floats
__device__ __forceinline__ void bf16x4_f(uint2 u, float out[4]) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
}

__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float out[4]) {
  bf16x4_f(*reinterpret_cast<const uint2*>(p), out);
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

// Whether unit u starts a run of `per` units: a mask where `per` is a power
// of two (the common group sizes), else a division.
__device__ __forceinline__ bool run_start(int u, int per) {
  return (per & (per - 1)) == 0 ? (u & (per - 1)) == 0 : u % per == 0;
}

constexpr int kMaxCluster = 16;   // blocks of one cluster (8 portable, 16 with the attribute)

// Floats of the receive buffer of cluster_reduce for `outs` outputs of NW
// floats: every rank's share of every block's sums.
__host__ __device__ constexpr int cluster_recv_floats(int nw, int outs) {
  return nw * (outs + kMaxCluster);
}

// The one-launch sum of K-splits. The block's `outs` outputs of NW floats
// each are finished by the cluster's C blocks in shares of per = ceil(outs /
// C): rank q finishes outputs [q * per, (q + 1) * per). sum(w, o) gives this
// block's sum of stream w at output o; each block pushes its sums to the
// owning rank's receive buffer over distributed shared memory (recv[(r * NW
// + w) * per + o - q * per], cluster_recv_floats(NW, outs) floats), one
// cluster barrier publishes them, and each block adds its share's partials
// in rank order from its own shared memory and hands them to store(o, v).
// No block touches another's shared memory after the barrier, so one
// barrier suffices. Every thread of every block must call it.
template <int NW, class Sum, class Store>
__device__ __forceinline__ void cluster_reduce(float* recv, int outs, Sum&& sum, Store&& store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int n = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int per = (outs + n - 1) / n;
  for (int i = (int)threadIdx.x; i < NW * outs; i += (int)blockDim.x) {
    const int w = i / outs, o = i - w * outs, q = o / per;
    cl.map_shared_rank(recv, q)[(r * NW + w) * per + o - q * per] = sum(w, o);
  }
  cl.sync();
  const int first = r * per;
  for (int j = (int)threadIdx.x; j < per && first + j < outs; j += (int)blockDim.x) {
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w] = 0.0f;
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int w = 0; w < NW; ++w) v[w] += recv[(s * NW + w) * per + j];
    }
    store(first + j, v);
  }
}

// Launches `kern` on grid (x, cluster, z) with clusters of 1 x cluster x 1
// blocks of `threads` threads.
template <class... Exp, class... Act>
cudaError_t launch_cluster(void (*kern)(Exp...), dim3 grid, int threads, int cluster,
                           size_t smem, cudaStream_t stream, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<Act&&>(args)...);
}

// Once per kernel instantiation (not per launch, so a CUDA-graph capture sees
// none): its dynamic shared memory, and clusters of up to 16 blocks.
template <class Kern>
cudaError_t cluster_attributes(Kern kern, int smem) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Sums the K-splits in order (deterministic) and applies the epilogue: VEC
// (4 where N % 4 == 0, else 1) consecutive outputs a thread, each split's
// VEC partials one load, the loads of all splits in flight together (one
// output a thread with scalar loads left them latency-bound: 16.3 us for
// kernel 2's 2 x 3 x 128 x 11008 partials, 2.2 TB/s).
template <int NW, int VEC>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const __nv_bfloat16* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ out, int M, int N, int split) {
  using Vec = typename std::conditional<VEC == 4, float4, float>::type;
  const size_t total = (size_t)M * N;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (i >= total) return;
  float v[VEC][NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    float t[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < split; ++s) {
      const Vec p = *reinterpret_cast<const Vec*>(partial + (size_t)(w * split + s) * total + i);
      const float* f = reinterpret_cast<const float*>(&p);
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] += f[e];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e][w] = t[e];
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    out[i + e] = __float2bfloat16_rn(epilogue<NW>(v[e], bias, (int)((i + e) % N)));
}

// Launches qmm_reduce_kernel over partial (NW, split, M, N) into out (M, N).
template <int NW>
cudaError_t launch_reduce(const float* partial, const __nv_bfloat16* bias, __nv_bfloat16* out,
                          int M, int N, int split, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  if (N % 4 == 0) {
    const size_t threads = total / 4;
    qmm_reduce_kernel<NW, 4><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        partial, bias, out, M, N, split);
  } else {
    qmm_reduce_kernel<NW, 1><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, bias, out, M, N, split);
  }
  return cudaGetLastError();
}

}  // namespace gptq

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
