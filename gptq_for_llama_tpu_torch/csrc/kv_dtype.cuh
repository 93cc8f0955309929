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
//    ops/pallas/flash.py:_load_bf16 does: exact for every fp8 code (bf16x8,
//    the same in both of its bodies; e4m3 there by the pair form
//    e4m3x2_bf16, which gives those bf16 bits without a float conversion).
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

// 8 consecutive elements of type T (in registers or shared memory) as 8 bf16
// in 16 bytes, nearest even: kernel 4's operands, as ops/pallas/flash.py's
// _load_bf16 reads the cache (exact for every fp8 code, e4m3's 0x7F / 0xFF
// as +-480; zeros stay zeros). Both bodies of kernel 4 convert through it:
// the mma.sync body's threads on a tile's way into shared memory, the wgmma
// body's producer warpgroup from its staging ring into the bf16 stage.
template <typename T>
__device__ __forceinline__ uint4 bf16x8(const T* x) {
  float f[2][4];
  Kv<T>::load4(x, f[0]);
  Kv<T>::load4(x + 4, f[1]);
  alignas(16) __nv_bfloat162 o[4] = {__floats2bfloat162_rn(f[0][0], f[0][1]),
                                     __floats2bfloat162_rn(f[0][2], f[0][3]),
                                     __floats2bfloat162_rn(f[1][0], f[1][1]),
                                     __floats2bfloat162_rn(f[1][2], f[1][3])};
  return *reinterpret_cast<const uint4*>(o);
}

// two e4m3 codes, at bits 8-15 and 24-31 of t (the other bits zero), as a
// bf16 pair without a float conversion: each code's sign to bit 15 of its
// lane and its exponent and mantissa to bits 4-10 give the bf16 of its value
// times 2^-120 (bf16's exponent bias is 120 above e4m3's; a subnormal code
// lands on a subnormal bf16 of the same mantissa, and exponent field 15 is
// finite), and one bf16 multiply by 2^120, exact, gives the value (0x7F /
// 0xFF: +-480, as _load_bf16 reads them; 0x80: -0). mul.bf16x2 keeps
// subnormal inputs (PTX has no .ftz for bf16). tests/test_torch_kv_dtype.py
// holds a numpy model of these bits to JAX's _load_bf16 on all 256 codes.
__device__ __forceinline__ uint32_t e4m3x2_bf16(uint32_t t) {
  const uint32_t b = (t & 0x80008000u) | ((t >> 4) & 0x07F007F0u);
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(b), "r"(0x7B807B80u));   // x 2^120
  return d;
}

// e4m3 through the pair form above: 4 byte permutes, 8 logic operations and 4
// multiplies for 8 codes, where the float route takes about 40 instructions
template <>
__device__ __forceinline__ uint4 bf16x8(const e4m3* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  return make_uint4(e4m3x2_bf16(__byte_perm(u.x, 0u, 0x1404)),    // codes 0, 1
                    e4m3x2_bf16(__byte_perm(u.x, 0u, 0x3424)),    // codes 2, 3
                    e4m3x2_bf16(__byte_perm(u.y, 0u, 0x1404)),
                    e4m3x2_bf16(__byte_perm(u.y, 0u, 0x3424)));
}

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

