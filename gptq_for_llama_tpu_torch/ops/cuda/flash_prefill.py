"""Kernel 5, causal self-attention with no cache: CUDA wrapper, launch count
and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/flash.py:_flash_kernel`` (entry
``flash_prefill``), which the cache-less causal forward reaches: the GPTQ
calibration forward and the perplexity eval. The kernel is
``csrc/flash_prefill.cu`` (bf16 tensor cores, K/V streamed through shared
memory with an online softmax); it takes any S (the TPU kernel needs
S % 256 == 0 and K+V of a head in VMEM). The plain version is the fp32 masked
softmax of ``attention.attention_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .attention import attention_plain
from .matmul import check_tensor

SOURCE = "gptq_for_llama_tpu_torch/csrc/flash_prefill.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/flash.py:27"


def flash_prefill_plain(q, k, v, scale: float) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hkv, D): query i attends keys j <= i,
    softmax in fp32. Returns (B, S, H, D) in q's dtype."""
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    return attention_plain(q, k, v, scale, pos[None, :] <= pos[:, None])


def _entry():
    fn = build.library("flash_prefill").gptq_flash_prefill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 5 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_prefill_cuda(q, k, v, scale: float) -> torch.Tensor:
    """The kernel: q (B, S, H, 128) bf16, k/v (B, S, Hkv, 128) bf16 with
    H % Hkv == 0, all contiguous on the card. Anything else raises."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if d != 128 or hkv < 1 or h % hkv:
        raise ValueError(f"causal prefill kernel takes head_dim 128 and H % Hkv == 0; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    check_tensor(q, "q", torch.bfloat16)
    check_tensor(k, "k", torch.bfloat16, (b, s, hkv, d))
    check_tensor(v, "v", torch.bfloat16, (b, s, hkv, d))
    out = torch.empty_like(q)
    if b * s == 0:
        return out
    fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, hkv, d,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("flash_prefill"), err, "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0


def flash_prefill(q, k, v, scale: float) -> torch.Tensor:
    """Causal self-attention: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if q.is_cuda:
        return flash_prefill_cuda(q, k, v, scale)
    return flash_prefill_plain(q, k, v, scale)
