// Causal self-attention with no cache, on bf16 tensor cores.
//
// Replaces gptq_for_llama_tpu/ops/pallas/flash.py:_flash_kernel (entry
// flash_prefill): q (B, S, H, D), k/v (B, S, Hkv, D), bf16, D = 128; query i
// attends keys j <= i; query head h reads kv head h / (H / Hkv). The body,
// its numerics, its bound and its design are in flash_common.cuh, shared
// with kernel 4 (flash_prefill_blocked.cu), which adds a cache offset.
#include "flash_common.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int gptq_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int H, int Hkv, int D, float scale, void* stream) {
  if (D != gptq_flash::kD || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gptq_flash::launch<false>(q, k, v, out, B, S, S, H, Hkv, 0, scale,
                                                    static_cast<cudaStream_t>(stream)));
}
