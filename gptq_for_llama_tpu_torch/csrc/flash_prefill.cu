// Causal self-attention with no cache, on bf16 tensor cores.
//
// Replaces gptq_for_llama_tpu/ops/pallas/flash.py:_flash_kernel (entry
// flash_prefill): q (B, S, H, D), k/v (B, S, Hkv, D), bf16, D the library's head
// dim (GPTQ_HEAD_DIM); query i
// attends keys j <= i; query head h reads kv head h / (H / Hkv). The two
// bodies (warp-specialised wgmma with TMA, and mma.sync for short S), their
// numerics, bound and design are in flash_common.cuh, shared with kernel 4
// (flash_prefill_blocked.cu), which adds a cache offset.
#include "flash_common.cuh"

extern "C" const char* gptq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dynamic shared memory of one block of body `path`, in bytes (0: the wgmma
// body does not run at this head dim)
extern "C" int gptq_flash_smem_bytes(int path) { return gptq_flash::smem_bytes(path); }

// path: gptq_flash::kSync (64-query mma.sync blocks) or kWgmma (128-query
// warp-specialised blocks, D = 64, 80, 96, 128, 256); the wrapper's plan
// picks it from S and D.
extern "C" int gptq_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int H, int Hkv, int D, float scale, int path,
                                  void* stream) {
  if (D != gptq_flash::kHeadDim || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gptq_flash::launch<false>(q, k, v, out, B, S, B, S, H, Hkv, nullptr,
                                                    nullptr, scale, path,
                                                    static_cast<cudaStream_t>(stream)));
}
