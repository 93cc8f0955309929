// Blocked-KV prefill attention at a cache offset, on bf16 tensor cores.
//
// Replaces gptq_for_llama_tpu/ops/pallas/flash.py:_flash_blocked_kernel
// (entry flash_prefill_blocked). SQ queries whose absolute positions start
// at q_offset attend cache slots j <= q_offset + i, j < SKV; the cache
// already holds the chunk's own k/v. GQA: query head h reads kv head
// h / (H / Hkv). Every bucketed and chunked serving prefill and the runner's
// prompt go through it.
//
// The offset is a 1-element int32 in device memory that every block reads
// itself, as the TPU kernel takes q_offset by scalar prefetch: the grid
// depends on SQ alone, so a launch captured in a CUDA graph replays at
// whatever offset the buffer holds. ``rows`` (optional, (B,) int32 in device
// memory) names the cache row each query batch row attends: a serving chunk
// attends its slot of the whole (Bkv, SKV, Hkv, D) cache, with no copy of the
// slot, and the TMA descriptors cover that whole cache, so a replay finds the
// same tensors whatever slot it serves. The wrapper picks the body from a
// host-side bound on offset + SQ (ops/cuda/flash.py).
//
// What bounds it on the H100: for a 100-token 7B prompt, bytes (q, the live
// K/V and the output: 3.3 MB, about 1 us at 3.35 TB/s); the operations
// (4 * SQ * live * D per head) take over for chunks of a few hundred
// queries. The bodies are kernel 5's (flash_common.cuh: 128-query blocks of
// two wgmma consumer warpgroups fed by a TMA producer warpgroup, or for short
// chunks 64-query blocks on mma.sync) with the offset read in: row i sits at
// q_offset + i, key tiles above a tile's causal limit are never loaded, slots
// past the limit are masked and never reach P V, so any SQ, SKV and offset
// works (the TPU kernel needs SQ % 128 == 0). A short chunk over a long cache
// gives few blocks; each reads only its live keys, so no split of the keys
// across blocks is needed there (PERF.md).
//
// The cache may be stored in bf16, f32, fp8-e4m3 or fp8-e5m2 and is read in
// that type, its tiles rounded to bf16 on their way into shared memory as the
// TPU kernel's _load_bf16 reads them (an f32 cache is rounded before q k^T;
// e4m3 codes 0x7F / 0xFF read as +-480); the bytes it reads shrink with the
// cache's itemsize. Both bodies take every cache dtype at D = 64, 80, 96 and
// 128, under the same plan as bf16: the mma.sync body rounds each tile in
// registers, the wgmma body's producer warpgroup converts TMA staging chunks
// into its bf16 stages (flash_common.cuh), so its output over such a cache
// equals its output over the cache decoded to bf16 bit for bit. At D = 256
// such a cache takes the mma.sync body only (no room for a staging ring).
#include "flash_common.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B, SQ, H, D) bf16; k/v (Bkv, SKV, Hkv, D) in the cache dtype ``kv``
// (gptq_kv::Code: bf16, f32, e4m3, e5m2); q_offset: device pointer to one
// int32; rows: device pointer to B int32, or null (batch row b attends cache
// row b; then Bkv == B). path: gptq_flash::kSync or kWgmma (a bf16 cache at
// D = 64, 80, 96, 128, 256, another at 64, 80, 96, 128).
extern "C" int gptq_flash_prefill_blocked(const void* q, const void* k, const void* v,
                                          void* out, int B, int SQ, int Bkv, int SKV, int H,
                                          int Hkv, int D, const int* q_offset, const int* rows,
                                          float scale, int path, int kv, void* stream) {
  if (D != gptq_flash::kHeadDim || B < 1 || SQ < 1 || Bkv < 1 || SKV < 1 || Hkv < 1 ||
      H % Hkv != 0 || q_offset == nullptr || (rows == nullptr && Bkv != B) || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gptq_kv::dispatch(kv, [&](auto t) {
    return gptq_flash::launch<true, decltype(t)>(q, k, v, out, B, SQ, Bkv, SKV, H, Hkv, q_offset,
                                                 rows, scale, path,
                                                 static_cast<cudaStream_t>(stream));
  }));
}

// The wgmma body's layout over a cache of dtype ``kv`` at this library's D
// into out[5]: K and V stages, keys of a staging chunk, staging slots,
// staging bytes, dynamic shared memory (zeros where the body does not take
// the dtype); ops/cuda/flash.py:wgmma_layout mirrors it.
extern "C" int gptq_flash_wgmma_layout(int kv, int* out) {
  return static_cast<int>(gptq_kv::dispatch(kv, [&](auto t) {
    gptq_flash::wgmma_layout<decltype(t)>(out);
    return cudaSuccess;
  }));
}
