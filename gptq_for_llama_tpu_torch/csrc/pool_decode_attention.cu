// One-token (decode) attention directly over a paged KV block pool.
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:pool_decode_attention
// (kernel bodies _attn_kernel / _attn_kernel_gqa with the block index routed
// through the slot's table row). The kernel body, its bound (the live bytes)
// and its design are in decode_attention_common.cuh. Plain C entry point,
// bound from Python with ctypes (gptq_for_llama_tpu_torch/ops/cuda/attention.py).
#include "decode_attention_common.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, H, D) bf16; pools (NB, BS, Hkv, D) bf16; tables (B, MB) int32:
// physical block of each logical block; offs (B,) int32: row b attends logical
// slots j <= offs[b], slot j at pool[tables[b, j / BS], j % BS]. BS must be a
// multiple of 8.
extern "C" int gptq_pool_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                          const void* tables, const void* offs, void* out,
                                          void* part, int B, int NB, int BS, int MB, int Hkv,
                                          int G, int D, float scale, int nsplit, int chunk,
                                          void* stream) {
  if (tables == nullptr || offs == nullptr || NB < 1 || MB < 1 || BS < gptq_attn::kMinBlock ||
      BS % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const gptq_attn::Cache c{static_cast<const __nv_bfloat16*>(k_pool),
                           static_cast<const __nv_bfloat16*>(v_pool),
                           static_cast<const int32_t*>(tables), MB * BS, NB, BS, MB};
  return static_cast<int>(gptq_attn::launch<true>(q, c, offs, 0, out, part, B, Hkv, G, D, scale,
                                                  nsplit, chunk,
                                                  static_cast<cudaStream_t>(stream)));
}
