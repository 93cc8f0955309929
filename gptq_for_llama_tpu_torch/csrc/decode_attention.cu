// One-token (decode) attention over a dense KV cache.
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:_attn_kernel and
// :_attn_kernel_gqa (entry decode_attention): query row b attends cache slots
// j <= offset[b], over a cache stored in bf16, f32, fp8-e4m3 or fp8-e5m2 and
// read in that type. Bound on the H100: the bytes of the live cache prefix. The
// body is decode_attention_dense.cuh's: chunks of 64-192 live slots planned on
// the host to fit one wave of blocks (ops/cuda/attention.py:decode_plan), K/V
// through a 4-stage cp.async ring with no block barrier per tile, per-warp
// exp2 online softmax merged at the end of the block, and a combine kernel,
// launched as a programmatic dependent launch, that sums the chunks in order.
// Plain C entry point, bound from Python with ctypes
// (gptq_for_llama_tpu_torch/ops/cuda/attention.py).
#include "decode_attention_dense.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, H, D) bf16, k/v (B, S, Hkv, D) in the cache dtype ``kv``
// (gptq_kv::Code: bf16, f32, e4m3, e5m2). offs: device int32 (B,) per-row
// offsets, or null to use off_scalar for every row.
extern "C" int gptq_decode_attention(const void* q, const void* k, const void* v,
                                     const void* offs, int off_scalar, void* out, void* part,
                                     int B, int S, int Hkv, int G, int D, float scale,
                                     int nsplit, int chunk, int kv, void* stream) {
  return static_cast<int>(gptq_kv::dispatch(kv, [&](auto t) {
    return gptq_dense::launch<decltype(t), false>(q, k, v, S, offs, off_scalar, out, part, B,
                                                  Hkv, G, D, scale, nsplit, chunk,
                                                  static_cast<cudaStream_t>(stream));
  }));
}
