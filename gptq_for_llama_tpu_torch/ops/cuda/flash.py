"""Kernel 4, blocked prefill attention: dispatch, CUDA wrapper, launch count
and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/flash.py:_flash_blocked_kernel``
(entry ``flash_prefill_blocked``): SQ queries at absolute positions
``q_offset + i`` attend cache slots ``j <= q_offset + i``. The kernel is
``csrc/flash_prefill_blocked.cu`` on kernel 5's two bodies, picked by
``flash_prefill.plan`` from offset + SQ; it takes any SQ, SKV and offset (the TPU
kernel needs SQ % 128 == 0). The plain version is the masked softmax of
``attention.attention_plain`` in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .attention import attention_plain
from .flash_prefill import PATH_IDS, plan
from .grad import refuse_grad
from .matmul import check_tensor

SOURCE = "gptq_for_llama_tpu_torch/csrc/flash_prefill_blocked.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/flash.py:85"


def flash_prefill_blocked_plain(q, k, v, q_offset: int, scale: float) -> torch.Tensor:
    """q (B, SQ, H, D), k/v (B, SKV, Hkv, D): query i attends slots
    j <= q_offset + i, softmax in fp32. Returns (B, SQ, H, D) in q's dtype."""
    sq, skv = q.shape[1], k.shape[1]
    allowed = (torch.arange(skv, device=q.device)[None, :]
               <= torch.arange(sq, device=q.device)[:, None] + int(q_offset))
    return attention_plain(q, k, v, scale, allowed)


def _entry():
    fn = build.library("flash_prefill_blocked").gptq_flash_prefill_blocked
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_prefill_blocked_cuda(q, k, v, q_offset: int, scale: float) -> torch.Tensor:
    """The kernel: q (B, SQ, H, 128) bf16, k/v (B, SKV, Hkv, 128) bf16, a
    host-side integer offset. An fp8 cache raises."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d != 128 or h % hkv or int(q_offset) < 0:
        raise ValueError(f"blocked prefill kernel takes head_dim 128, H % Hkv == 0 and "
                         f"offset >= 0; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"offset {q_offset}")
    refuse_grad("flash_prefill_blocked", q, k, v)
    check_tensor(q, "q", torch.bfloat16)
    check_tensor(k, "k", torch.bfloat16, (b, skv, hkv, d))
    check_tensor(v, "v", torch.bfloat16, (b, skv, hkv, d))
    if sq == 0:
        return torch.empty_like(q)
    return _launch(q, k, v, q_offset, scale, plan(sq, int(q_offset)))


def _launch(q, k, v, q_offset: int, scale: float, path: str) -> torch.Tensor:
    """One launch of kernel 4 on checked operands through body ``path`` (a
    measurement may force one)."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, sq, k.shape[1], h, k.shape[2], d, int(q_offset), float(scale),
                   PATH_IDS[path], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("flash_prefill_blocked"), err, f"flash_prefill_blocked ({path})")
    flash_prefill_blocked_cuda.launches += 1
    return out


flash_prefill_blocked_cuda.launches = 0


def flash_prefill_blocked(q, k, v, q_offset: int, scale: float) -> torch.Tensor:
    """Cached prefill attention: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if q.is_cuda:
        return flash_prefill_blocked_cuda(q, k, v, q_offset, scale)
    return flash_prefill_blocked_plain(q, k, v, q_offset, scale)
