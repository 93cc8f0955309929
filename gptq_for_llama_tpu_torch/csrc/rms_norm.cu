// RMSNorm over the last axis: y = (x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces gptq_for_llama_tpu/ops/pallas/norm.py:_rms_kernel (entry
// rms_norm_pallas). Statistics and both products are fp32; the result is
// rounded once to x's type, in the order of the TPU kernel and of the plain
// version: (x_f32 * r) * w_f32.
//
// What bounds it on the H100: bytes, x read once and y written once
// (2 * M * H * itemsize; 16 KB and 4.9 ns for one 4096-wide bf16 row at
// 3.35 TB/s, so a decode step's call is a launch, not a transfer). Design:
//  - one block per row; the block is one warp for a narrow row and up to 256
//    threads for a wide one (one 16-byte load per thread and pass);
//  - 16-byte loads where H and the pointers allow, else element loads: any M
//    and any H (the TPU kernel's padding to 8 rows is a tiling device of
//    that machine);
//  - the row is kept in shared memory as fp32 between the two passes (sum of
//    squares, then scale), so x is read from device memory once;
//  - the sum is reduced by warp shuffles, then across warps through shared
//    memory; every thread then holds the same r = rsqrtf(sum / H + eps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

template <typename T>
struct __align__(16) Vec {   // 16 bytes of T
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int H,
                float eps) {
  extern __shared__ __align__(16) float row[];   // H floats
  __shared__ float warp_sum[kMaxThreads / 32];
  const TX* xr = x + (size_t)blockIdx.x * H;
  TX* yr = out + (size_t)blockIdx.x * H;
  const int tid = threadIdx.x;

  float ss = 0.0f;
  if (VEC) {
    constexpr int N = Vec<TX>::kN;
    for (int i = tid * N; i < H; i += blockDim.x * N) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const Vec<TX>& vx = reinterpret_cast<const Vec<TX>&>(u);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(vx.v[j]);
        row[i + j] = f;
        ss += f * f;
      }
    }
  } else {
    for (int i = tid; i < H; i += blockDim.x) {
      const float f = to_f32(xr[i]);
      row[i] = f;
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_sum[i];   // same order in every thread
  const float r = rsqrtf(total / (float)H + eps);

  // each thread rescales the elements it staged itself
  if (VEC) {
    constexpr int N = Vec<TX>::kN;
    for (int i = tid * N; i < H; i += blockDim.x * N) {
      Vec<TX> vy;
#pragma unroll
      for (int j = 0; j < N; ++j) from_f32((row[i + j] * r) * to_f32(w[i + j]), &vy.v[j]);
      *reinterpret_cast<uint4*>(yr + i) = reinterpret_cast<const uint4&>(vy);
    }
  } else {
    for (int i = tid; i < H; i += blockDim.x) from_f32((row[i] * r) * to_f32(w[i]), &yr[i]);
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int M, int H, float eps,
                   cudaStream_t stream) {
  constexpr int N = 16 / sizeof(TX);
  const bool vec = H % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_thread = vec ? N : 1;
  int threads = ((H + per_thread - 1) / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = (size_t)H * sizeof(float);
  auto kernel = vec ? rms_norm_kernel<TX, TW, true> : rms_norm_kernel<TX, TW, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<M, threads, smem, stream>>>(static_cast<const TX*>(x), static_cast<const TW*>(w),
                                       static_cast<TX*>(out), H, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, out (M, H) contiguous, bf16 or fp32 (x_fp32); w (H,) bf16 or fp32 (w_fp32).
extern "C" int gptq_rms_norm(const void* x, const void* w, void* out, int M, int H, float eps,
                             int x_fp32, int w_fp32, void* stream) {
  if (M < 1 || H < 1 || (size_t)H * sizeof(float) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_fp32)
    e = w_fp32 ? launch<float, float>(x, w, out, M, H, eps, st)
               : launch<float, __nv_bfloat16>(x, w, out, M, H, eps, st);
  else
    e = w_fp32 ? launch<__nv_bfloat16, float>(x, w, out, M, H, eps, st)
               : launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, M, H, eps, st);
  return static_cast<int>(e);
}
