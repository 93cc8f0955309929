// One-token (decode) attention over a dense KV cache.
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:_attn_kernel and
// :_attn_kernel_gqa (entry decode_attention). The kernel body, its bound and
// its design are in decode_attention_common.cuh. Plain C entry point, bound
// from Python with ctypes (gptq_for_llama_tpu_torch/ops/cuda/attention.py).
#include "decode_attention_common.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, H, D), k/v (B, S, Hkv, D) bf16. offs: device int32 (B,) per-row
// offsets, or null to use off_scalar for every row.
extern "C" int gptq_decode_attention(const void* q, const void* k, const void* v,
                                     const void* offs, int off_scalar, void* out, void* part,
                                     int B, int S, int Hkv, int G, int D, float scale,
                                     int nsplit, int chunk, void* stream) {
  const gptq_attn::Cache c{static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), nullptr, S, 0, 0, 0};
  return static_cast<int>(gptq_attn::launch<false>(q, c, offs, off_scalar, out, part, B, Hkv, G, D,
                                                   scale, nsplit, chunk,
                                                   static_cast<cudaStream_t>(stream)));
}
