"""Kernel 5, causal self-attention with no cache: CUDA wrapper, launch count
and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/flash.py:_flash_kernel`` (entry
``flash_prefill``), which the cache-less causal forward reaches: the GPTQ
calibration forward and the perplexity eval. The kernel is
``csrc/flash_prefill.cu`` with two bodies in ``csrc/flash_common.cuh``:
128-query blocks of two ``wgmma`` warpgroups fed by a TMA producer
warpgroup, and for a short causal prefix the 64-query ``mma.sync`` blocks;
``plan`` picks one from offset + query count and the head dim, the same way
for kernel 4, so the two kernels stay bit-equal at offset 0. It takes any S
(the TPU kernel needs S % 256 == 0 and K+V of a head in VMEM). The plain
version is the fp32 masked softmax of ``attention.attention_plain``. The
kernels take the head dims of ``attention.HEAD_DIMS`` (one library each),
and so does the ``wgmma`` body (``WGMMA_HEAD_DIMS``: its tiles in sub-tiles
of 64, 16, 32, 64 and 64 dims at D = 64, 80, 96, 128 and 256; at 256 its K
and V tiles hold 80 keys, not 128); ``plan`` sends a short causal prefix to
the ``mma.sync`` body at every D. At D = 64, 80 and 96 the TPU package runs
XLA (its kernels need D % 128 == 0), which the plain version computes.
Where a gradient is wanted (LoRA training) the forward still launches the
kernel, inside ``_CausalAttention``, whose backward is the plain version's
gradient recomputed from the saved q/k/v (the TPU package differentiates its
XLA softmax; ``flash_prefill`` has no VJP there).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .attention import attention_plain, check_head_dim, count_forms, new_forms
from .grad import needs_grad, plain_grads, refuse_grad
from .matmul import check_tensor

SOURCE = "gptq_for_llama_tpu_torch/csrc/flash_prefill.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/flash.py:27"

# Kernels 4 and 5 run the 64-query mma.sync body where the longest causal
# prefix (offset + query rows) is at most SYNC_MAX_KEYS[D] keys, and the
# warp-specialised wgmma body above: the crossover measured on the card for
# each head dim (scripts/torch_flash_bodies.py, PERF.md section 6; at D =
# 128 one 128-key tile). At D = 256 (16 heads over 2, NVIDIA H100 80GB HBM3,
# 700 W) the bodies are within 4-15 % of each other up to 128 keys: kernel
# 4's prompts at offset 0 favour mma.sync (SQ = 100: 10.26 against 11.08 us;
# 128: 11.59 against 12.21), the chunks at an offset and kernel 5 wgmma
# (S = 128: 12.65 against 11.68); above, wgmma by 1.2-3.7x (kernel 4 SQ =
# 100 at offset 29: 13.06 against 10.82; kernel 5 S = 2048: 252.76 against
# 68.34).
SYNC_MAX_KEYS = {64: 192, 80: 160, 96: 160, 128: 128, 256: 128}
WGMMA_HEAD_DIMS = tuple(SYNC_MAX_KEYS)   # csrc/flash_common.cuh's wgmma_dim
PATH_IDS = {"sync": 0, "wgmma": 1}   # csrc/flash_common.cuh's Path


def plan(sq: int, q_offset: int = 0, d: int = 128) -> str:
    """The body kernels 4 and 5 launch for ``sq`` query rows at
    ``q_offset`` and head dim ``d``. A function of offset + SQ and D alone,
    so kernel 4 at offset 0 takes kernel 5's body and stays bit-equal to it.
    """
    return "sync" if q_offset + sq <= SYNC_MAX_KEYS[d] else "wgmma"


def flash_prefill_plain(q, k, v, scale: float) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hkv, D): query i attends keys j <= i,
    softmax in fp32. Returns (B, S, H, D) in q's dtype."""
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    return attention_plain(q, k, v, scale, pos[None, :] <= pos[:, None])


def _entry(d: int):
    fn = build.library("flash_prefill", d).gptq_flash_prefill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_prefill_cuda(q, k, v, scale: float) -> torch.Tensor:
    """The kernel: q (B, S, H, D) bf16, k/v (B, S, Hkv, D) bf16 with
    H % Hkv == 0 and D one of ``attention.HEAD_DIMS``, all contiguous on the
    card. Anything else raises."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"causal prefill kernel takes H % Hkv == 0; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    check_head_dim("causal prefill kernel", d)
    refuse_grad("flash_prefill", q, k, v)
    check_tensor(q, "q", torch.bfloat16)
    check_tensor(k, "k", torch.bfloat16, (b, s, hkv, d))
    check_tensor(v, "v", torch.bfloat16, (b, s, hkv, d))
    if b * s == 0:
        return torch.empty_like(q)
    return _launch(q, k, v, scale, plan(s, 0, d))


def _launch(q, k, v, scale: float, path: str) -> torch.Tensor:
    """One launch of kernel 5 on checked operands through body ``path`` (a
    measurement may force one)."""
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    err = _entry(d)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
                    k.shape[2], d, float(scale), PATH_IDS[path],
                    torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("flash_prefill", d), err, f"flash_prefill ({path})")
    flash_prefill_cuda.launches += 1
    count_forms(flash_prefill_cuda, k.dtype, d, path)
    return out


flash_prefill_cuda.launches = 0
# launches by head dim, and by body and head dim
flash_prefill_cuda.forms = new_forms(by_dtype=False, bodies=tuple(PATH_IDS))


def _flash_prefill(q, k, v, scale):
    if q.is_cuda:
        return flash_prefill_cuda(q, k, v, scale)
    return flash_prefill_plain(q, k, v, scale)


class _CausalAttention(torch.autograd.Function):
    """Forward through the kernel (the plain version on the CPU); backward:
    the plain version's gradient, recomputed from the saved q/k/v."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _flash_prefill(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return plain_grads(ctx, flash_prefill_plain, g, ctx.scale)


def flash_prefill(q, k, v, scale: float) -> torch.Tensor:
    """Causal self-attention: the kernel for a CUDA tensor, the plain version
    for a CPU tensor; through ``_CausalAttention`` where a gradient is
    wanted."""
    if needs_grad(q, k, v):
        return _CausalAttention.apply(q, k, v, scale)
    return _flash_prefill(q, k, v, scale)
