// KV-cache storage dtypes on the card: bf16, f32, fp8-e4m3 and fp8-e5m2
// (each fp8 code one byte), read and written as the TPU kernels read and
// write them. The same rules as ops/kv_dtype.py, whose plain versions the
// kernels are held to:
//  - to_float mirrors gptq_for_llama_tpu/ops/pallas/attention.py:_load_f32:
//    an e4m3 code upcasts by integer bit math, so codes 0x7F and 0xFF read as
//    +-480, not NaN. Here the code's exponent and mantissa shifted into an
//    fp16 ((em << 7) | (sign << 15)) is the value times 2^-8 for normals and
//    subnormals alike (fp16's exponent bias is 8 above e4m3's, and its
//    exponent field 15 is finite), so one hardware fp16 -> fp32 conversion and
//    a multiply by 256 give the TPU kernel's value exactly, two codes a
//    byte permute; e5m2 is an fp16 with 8 low zero bits (exact, inf and NaN
//    included); f32 and bf16 load as they are.
//  - kernel 4 rounds that value to bf16 (its operand type), nearest even, as
//    ops/pallas/flash.py:_load_bf16 does: exact for every fp8 code.
//  - encode is JAX's astype from a bf16 (or f32) value: round to nearest even;
//    an e4m3 overflow (|x| > 464), inf or NaN becomes the NaN code 0x7F with
//    the sign, not 448 (satfinite saturates); e5m2 overflows to +-inf.
// No hardware fp8 conversion is used: the integer forms are exact by
// construction and give the same bits on every path.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gptq_kv {

struct e4m3 {   // float8_e4m3fn, one byte
  uint8_t x;
};
struct e5m2 {   // float8_e5m2, one byte
  uint8_t x;
};

// two e4m3 codes, at bits 0-7 and 16-23 of x, as the fp16 pair of their
// values times 2^-8
__device__ __forceinline__ float2 e4m3x2_scaled(uint32_t x) {
  const uint32_t h = ((x & 0x007F007Fu) << 7) | ((x & 0x00800080u) << 8);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

__device__ __forceinline__ float e4m3_float(uint32_t b) {
  return e4m3x2_scaled(b & 0xFFu).x * 256.0f;
}

__device__ __forceinline__ float e5m2_float(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)((b & 0xFFu) << 8)));
}

// JAX's astype of a bf16 value into an fp8 format of MAN mantissa bits and
// exponent bias BIAS; OVF is the code an overflow becomes (e4m3: NaN 0x7F,
// e5m2: inf 0x7C)
template <int MAN, int BIAS, uint32_t OVF>
__device__ __forceinline__ uint8_t fp8_from_bf16_value(float x) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = (bits >> 24) & 0x80u;
  const uint32_t a = bits & 0x7FFFFFFFu;
  if (a > 0x7F800000u) return (uint8_t)(MAN == 3 ? (0x7Fu | sign) : 0x7Fu);   // NaN
  constexpr int kShift = 23 - MAN;
  uint32_t code;
  if (a < ((uint32_t)(128 - BIAS) << 23)) {
    // subnormal: multiples of 2^(1 - BIAS - MAN), nearest even
    code = (uint32_t)__float2int_rn(fabsf(x) * (float)(1u << (BIAS - 1 + MAN)));
  } else {
    code = ((a + (1u << (kShift - 1)) - 1u + ((a >> kShift) & 1u)) >> kShift) -
           ((uint32_t)(127 - BIAS) << MAN);
  }
  if (a >= 0x7F800000u || code >= OVF) code = OVF;
  return (uint8_t)(code | sign);
}

// Kv<T>: reading and writing one cache element type
template <typename T>
struct Kv;

template <>
struct Kv<__nv_bfloat16> {
  __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 encode(__nv_bfloat16 v) { return v; }
  // 4 consecutive elements (8 bytes) as floats
  __device__ static void load4(const __nv_bfloat16* p, float (&f)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

template <>
struct Kv<float> {
  __device__ static float to_float(float v) { return v; }
  __device__ static float encode(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static void load4(const float* p, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
};

template <>
struct Kv<e4m3> {
  __device__ static float to_float(e4m3 v) { return e4m3_float(v.x); }
  __device__ static e4m3 encode(__nv_bfloat16 v) {
    return e4m3{fp8_from_bf16_value<3, 7, 0x7Fu>(__bfloat162float(v))};
  }
  __device__ static void load4(const e4m3* p, float (&f)[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const float2 a = e4m3x2_scaled(__byte_perm(u, 0u, 0x4140));   // codes 0, 1
    const float2 b = e4m3x2_scaled(__byte_perm(u, 0u, 0x4342));   // codes 2, 3
    f[0] = a.x * 256.0f;
    f[1] = a.y * 256.0f;
    f[2] = b.x * 256.0f;
    f[3] = b.y * 256.0f;
  }
};

template <>
struct Kv<e5m2> {
  __device__ static float to_float(e5m2 v) { return e5m2_float(v.x); }
  __device__ static e5m2 encode(__nv_bfloat16 v) {
    return e5m2{fp8_from_bf16_value<2, 15, 0x7Cu>(__bfloat162float(v))};
  }
  __device__ static void load4(const e5m2* p, float (&f)[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = e5m2_float(u >> (8 * i));
  }
};

// The cache dtype codes of the C entry points (ops/kv_dtype.py:KV_CODES)
enum Code { kBf16 = 0, kF32 = 1, kE4m3 = 2, kE5m2 = 3 };

// f(T{}) for the element type T of cache dtype ``code``; an unknown code is
// cudaErrorInvalidValue
template <typename F>
cudaError_t dispatch(int code, F&& f) {
  switch (code) {
    case kBf16: return f(__nv_bfloat16{});
    case kF32: return f(float{});
    case kE4m3: return f(e4m3{});
    case kE5m2: return f(e5m2{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gptq_kv

