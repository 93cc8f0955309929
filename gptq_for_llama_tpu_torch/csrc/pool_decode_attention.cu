// One-token (decode) attention directly over a paged KV block pool.
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:pool_decode_attention
// (kernel bodies _attn_kernel / _attn_kernel_gqa with the block index routed
// through the slot's table row): query row b attends logical slots
// j <= offset[b], slot j at pool[tables[b, j / BS], j % BS], over pools
// stored in bf16, f32, fp8-e4m3 or fp8-e5m2 and read in that type. Bound on the
// H100: the bytes of the live prefix. The body is kernel 3's,
// decode_attention_dense.cuh, with each warp's copy of a tile routed through
// one table entry (PAGED), under the same plan (ops/cuda/attention.py:
// decode_plan): no gathered view is built, and the result equals kernel 3's
// over the gathered view bit for bit. Plain C entry point, bound from Python
// with ctypes (gptq_for_llama_tpu_torch/ops/cuda/attention.py).
#include "decode_attention_dense.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, H, D) bf16; pools (NB, BS, Hkv, D) in the cache dtype ``kv``
// (gptq_kv::Code); tables (B, MB) int32:
// physical block of each logical block; offs (B,) int32. BS must be a
// multiple of 8; nsplit and chunk as for kernel 3 (the logical length
// MB * BS takes the place of the cache length).
extern "C" int gptq_pool_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                          const void* tables, const void* offs, void* out,
                                          void* part, int B, int NB, int BS, int MB, int Hkv,
                                          int G, int D, float scale, int nsplit, int chunk,
                                          int kv, void* stream) {
  if (tables == nullptr || offs == nullptr || NB < 1 || MB < 1 || BS < 1 ||
      (long long)MB * BS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const gptq_dense::Pages pg{static_cast<const int32_t*>(tables), BS, MB};
  return static_cast<int>(gptq_kv::dispatch(kv, [&](auto t) {
    using T = decltype(t);
    return gptq_dense::launch<T, false, true>(q, k_pool, v_pool, MB * BS, offs, 0, out, part, B,
                                              Hkv, G, D, scale, nsplit, chunk,
                                              static_cast<cudaStream_t>(stream),
                                              gptq_dense::Fold<T>{}, pg);
  }));
}
