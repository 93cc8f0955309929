// Blocked-KV prefill attention at a cache offset, on bf16 tensor cores.
//
// Replaces gptq_for_llama_tpu/ops/pallas/flash.py:_flash_blocked_kernel
// (entry flash_prefill_blocked). SQ queries whose absolute positions start
// at q_offset attend cache slots j <= q_offset + i, j < SKV; the cache
// already holds the chunk's own k/v. GQA: query head h reads kv head
// h / (H / Hkv). Every bucketed and chunked serving prefill and the runner's
// prompt go through it.
//
// What bounds it on the H100: for a 100-token 7B prompt, bytes (q, the live
// K/V and the output: 3.3 MB, about 1 us at 3.35 TB/s); the operations
// (4 * SQ * live * D per head) take over for chunks of a few hundred
// queries. The bodies are kernel 5's (flash_common.cuh: 128-query blocks of
// two wgmma consumer warpgroups fed by a TMA producer warpgroup, or for short
// chunks 64-query blocks on mma.sync; the wrapper's plan picks one from
// offset + SQ)
// with the offset compiled in: row i sits at q_offset + i, key tiles above a
// tile's causal limit are never loaded, slots past the limit are masked and
// never reach P V, so any SQ, SKV and offset works (the TPU kernel needs
// SQ % 128 == 0). A short chunk over a long cache gives few blocks; each
// reads only its live keys, so no split of the keys across blocks is needed
// there (PERF.md).
#include "flash_common.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int gptq_flash_prefill_blocked(const void* q, const void* k, const void* v,
                                          void* out, int B, int SQ, int SKV, int H, int Hkv,
                                          int D, int q_offset, float scale, int path,
                                          void* stream) {
  if (D != gptq_flash::kD || B < 1 || SQ < 1 || SKV < 1 || Hkv < 1 || H % Hkv != 0 ||
      q_offset < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gptq_flash::launch<true>(q, k, v, out, B, SQ, SKV, H, Hkv, q_offset,
                                                   scale, path,
                                                   static_cast<cudaStream_t>(stream)));
}
