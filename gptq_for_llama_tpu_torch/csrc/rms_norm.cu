// RMSNorm over the last axis: y = (x * rsqrt(mean(x^2) + eps)) * w, with an
// optional residual add folded in: h = x + r, y = RMSNorm(h).
//
// Replaces gptq_for_llama_tpu/ops/pallas/norm.py:_rms_kernel (entry
// rms_norm_pallas), and with a residual the pair `x = x + o; rms_norm(x)` of
// gptq_for_llama_tpu/models/llama.py (the add there is XLA's). Statistics and
// both products are fp32; the result is rounded once to x's type, in the
// order of the TPU kernel and of the plain version: (h_f32 * r) * w_f32.
// With a residual, h = x + r is one fp32 add of the two values rounded once
// (RN) to x's type: bit-equal to torch's add in that type. The kernel writes
// that rounded h to a NEW tensor (never in place: the caller may still hold
// x and r, autograd may have saved them, and a captured graph may read them
// again) and normalizes the rounded h, so y is RMSNorm of what it returns.
//
// What bounds it on the H100: bytes. Alone, x read once and y written once
// (2 * M * H * itemsize; 16 KB and 4.9 ns for one 4096-wide bf16 row at
// 3.35 TB/s); with a residual, x and r read once, h and y written once
// ((3 + 1) * M * H * itemsize). At decode widths a call is a launch, not a
// transfer: the residual form's gain is the separate add launch it removes
// (one for every norm of the stack but layer 0's input norm), and at
// M = 16384 the add's own read of h. Design:
//  - one block per row; the block is one warp for a narrow row and up to 256
//    threads for a wide one (one 16-byte load per thread and pass);
//  - 16-byte loads where H and the pointers allow, else element loads: any M
//    and any H (the TPU kernel's padding to 8 rows is a tiling device of
//    that machine);
//  - the row (h, with a residual) is kept in shared memory as fp32 between
//    the two passes (sum of squares, then scale), so x and r are read from
//    device memory once;
//  - w is read in 8- or 16-byte vectors in the second pass (the eval row,
//    M = 16384, was slower with element loads: PERF.md section 6);
//  - the sum is reduced by warp shuffles, then across warps through shared
//    memory; every thread then holds the same r = rsqrtf(sum / H + eps).
//    One body serves both forms (ADD is a template flag), so a row is summed
//    in the same order with and without the residual.
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

// N values of w from w + i as fp32, in 8- or 16-byte loads (w + i is
// aligned to N * sizeof(TW) bytes on the vector path)
template <typename TW, int N>
__device__ __forceinline__ void load_w(const TW* __restrict__ w, float* out) {
  constexpr int kBytes = N * (int)sizeof(TW);
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / (int)sizeof(TW);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(w) + c);
      const TW* t = reinterpret_cast<const TW*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[c * kPer + j] = to_f32(t[j]);
    }
  } else {   // four bf16 beside an fp32 row
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(w));
    const TW* t = reinterpret_cast<const TW*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(t[j]);
  }
}

// h = x + r in x's type: one fp32 add, one rounding
template <typename TX>
__device__ __forceinline__ TX add_round(TX a, TX b) {
  TX h;
  from_f32(to_f32(a) + to_f32(b), &h);
  return h;
}

template <typename TX, typename TW, bool VEC, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const TX* __restrict__ x, const TX* __restrict__ res, const TW* __restrict__ w,
                TX* __restrict__ sum, TX* __restrict__ out, int H, float eps) {
  extern __shared__ __align__(16) float row[];   // H floats
  __shared__ float warp_sum[kMaxThreads / 32];
  const size_t base = (size_t)blockIdx.x * H;
  const TX* xr = x + base;
  TX* yr = out + base;
  const int tid = threadIdx.x;
  constexpr int N = Vec<TX>::kN;

  float ss = 0.0f;
  if (VEC) {
    for (int i = tid * N; i < H; i += blockDim.x * N) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const Vec<TX>& vx = reinterpret_cast<const Vec<TX>&>(u);
      if (ADD) {
        const uint4 ur = *reinterpret_cast<const uint4*>(res + base + i);
        const Vec<TX>& vr = reinterpret_cast<const Vec<TX>&>(ur);
        Vec<TX> vh;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          vh.v[j] = add_round(vx.v[j], vr.v[j]);
          const float f = to_f32(vh.v[j]);
          row[i + j] = f;
          ss += f * f;
        }
        *reinterpret_cast<uint4*>(sum + base + i) = reinterpret_cast<const uint4&>(vh);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_f32(vx.v[j]);
          row[i + j] = f;
          ss += f * f;
        }
      }
    }
  } else {
    for (int i = tid; i < H; i += blockDim.x) {
      TX v = xr[i];
      if (ADD) {
        v = add_round(v, res[base + i]);
        sum[base + i] = v;
      }
      const float f = to_f32(v);
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
    for (int i = tid * N; i < H; i += blockDim.x * N) {
      float wv[N];
      load_w<TW, N>(w + i, wv);
      Vec<TX> vy;
#pragma unroll
      for (int j = 0; j < N; ++j) from_f32((row[i + j] * r) * wv[j], &vy.v[j]);
      *reinterpret_cast<uint4*>(yr + i) = reinterpret_cast<const uint4&>(vy);
    }
  } else {
    for (int i = tid; i < H; i += blockDim.x) from_f32((row[i] * r) * to_f32(w[i]), &yr[i]);
  }
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TX, typename TW, bool ADD>
cudaError_t launch_form(const void* x, const void* res, const void* w, void* sum, void* out,
                        int M, int H, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(TX);
  const bool vec = H % N == 0 && aligned16(x) && aligned16(w) && aligned16(out) &&
                   (!ADD || (aligned16(res) && aligned16(sum)));
  const int per_thread = vec ? N : 1;
  int threads = ((H + per_thread - 1) / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = (size_t)H * sizeof(float);
  auto kernel = vec ? rms_norm_kernel<TX, TW, true, ADD> : rms_norm_kernel<TX, TW, false, ADD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<M, threads, smem, stream>>>(static_cast<const TX*>(x), static_cast<const TX*>(res),
                                       static_cast<const TW*>(w), static_cast<TX*>(sum),
                                       static_cast<TX*>(out), H, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* res, const void* w, void* sum, void* out, int M,
                   int H, float eps, cudaStream_t stream) {
  return res ? launch_form<TX, TW, true>(x, res, w, sum, out, M, H, eps, stream)
             : launch_form<TX, TW, false>(x, res, w, sum, out, M, H, eps, stream);
}

}  // namespace

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, out (M, H) contiguous, bf16 or fp32 (x_fp32); w (H,) bf16 or fp32
// (w_fp32). res and sum: both null (RMSNorm of x), or both (M, H) of x's type
// (sum = x + res, out = RMSNorm(sum)).
extern "C" int gptq_rms_norm(const void* x, const void* res, const void* w, void* sum, void* out,
                             int M, int H, float eps, int x_fp32, int w_fp32, void* stream) {
  if (M < 1 || H < 1 || (size_t)H * sizeof(float) > 227 * 1024 ||
      (res == nullptr) != (sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_fp32)
    e = w_fp32 ? launch<float, float>(x, res, w, sum, out, M, H, eps, st)
               : launch<float, __nv_bfloat16>(x, res, w, sum, out, M, H, eps, st);
  else
    e = w_fp32 ? launch<__nv_bfloat16, float>(x, res, w, sum, out, M, H, eps, st)
               : launch<__nv_bfloat16, __nv_bfloat16>(x, res, w, sum, out, M, H, eps, st);
  return static_cast<int>(e);
}

// One empty block of one warp: the launch floor that a decode-width call of
// the kernel above is timed against.
extern "C" int gptq_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
