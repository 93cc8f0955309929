// Fold decode attention over a dense KV cache: the stale prefix plus the
// current token's k/v, with an optional in-place write of that token's row.
//
// Replaces gptq_for_llama_tpu/ops/pallas/attention.py:_fused_attn_kernel
// (entry fused_decode_attention). Query row b attends cache slots
// j < offset[b] and the current token's k/v, softmax in fp32; at offset 0 the
// output is v_new. With write set, k_new / v_new land at slot offset[b] of
// the caches on rows whose write_mask is non-zero. The caches are stored in
// bf16, f32, fp8-e4m3 or fp8-e5m2 and read in that type; the current k/v are
// rounded to it (JAX's astype, an e4m3 overflow NaN) before they are folded
// in and written, as the TPU wrapper passes them. The TPU kernel copies the
// 8-row slab around that slot back over an aliased buffer (a DMA device of
// the TPU); here the first chunk's block of each (row, kv head) stores the
// one row.
//
// What bounds it on the H100: the bytes of the live cache prefix, as for
// decode_attention.cu (10 us at 2047 live slots of 7B's 32 heads at
// 3.35 TB/s); the fold adds one logit and one v row per head. The body is
// decode_attention_dense.cuh's (chunks of 64-192 slots, a 4-stage cp.async
// ring, per-warp exp2 softmax, a combine kernel in chunk order): the current
// token is folded in after the single chunk's merge, or in the combine
// kernel. Slots at or past offset[b] are zero-filled in shared memory and
// never read from the caches, so the row write cannot race a read.
#include "decode_attention_dense.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, H, D), k_new/v_new (B, Hkv, D) bf16; k/v (B, S, Hkv, D) in the cache
// dtype ``kv`` (gptq_kv::Code). offs: device int32 (B,) per-row offsets, or
// null to use off_scalar for every row. write_mask: device uint8 (B,) or null
// (every row is written).
extern "C" int gptq_fused_decode_attention(const void* q, void* k, void* v, const void* k_new,
                                           const void* v_new, const void* offs, int off_scalar,
                                           const void* write_mask, int write, void* out,
                                           void* part, int B, int S, int Hkv, int G, int D,
                                           float scale, int nsplit, int chunk, int kv,
                                           void* stream) {
  return static_cast<int>(gptq_kv::dispatch(kv, [&](auto t) {
    using T = decltype(t);
    const gptq_dense::Fold<T> f{static_cast<const __nv_bfloat16*>(k_new),
                                static_cast<const __nv_bfloat16*>(v_new), static_cast<T*>(k),
                                static_cast<T*>(v), static_cast<const uint8_t*>(write_mask),
                                write};
    return gptq_dense::launch<T, true>(q, k, v, S, offs, off_scalar, out, part, B, Hkv, G, D,
                                       scale, nsplit, chunk, static_cast<cudaStream_t>(stream),
                                       f);
  }));
}
