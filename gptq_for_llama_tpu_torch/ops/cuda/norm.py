"""Kernel 6, RMSNorm: dispatch, CUDA wrapper, launch count and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/norm.py:_rms_kernel`` (entry
``rms_norm_pallas``). The kernel is ``csrc/rms_norm.cu``: one block per row,
fp32 statistics, ``(x_f32 * r) * w_f32`` rounded once to x's dtype; its bound
on the H100 is the bytes of x and y. The plain version is the TPU package's
``models/common.rms_norm``. Where a gradient is wanted the forward still
launches the kernel, inside ``_RmsNorm``, whose backward is the plain
version's gradient (the TPU package differentiates its XLA norm; there is no
backward kernel to port).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .grad import needs_grad, plain_grads, refuse_grad

SOURCE = "gptq_for_llama_tpu_torch/csrc/rms_norm.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/norm.py:20"
_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis with fp32 statistics; returns x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def _entry():
    fn = build.library("rms_norm").gptq_rms_norm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel: x (..., H) bf16 or fp32, contiguous; weight (H,) bf16 or
    fp32. Any number of rows and any H up to 58,112 (the row is staged in
    shared memory as fp32)."""
    refuse_grad("rms_norm", x, weight)
    h = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"RMSNorm kernel takes bf16 or fp32, got x {x.dtype}, "
                        f"weight {weight.dtype}")
    if h < 1 or h * 4 > 227 * 1024:
        raise ValueError(f"RMSNorm kernel stages a row of at most 58,112 values, got H={h}")
    # no 16-byte alignment demanded: the kernel falls back to element loads
    if not (x.is_cuda and x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("RMSNorm kernel needs contiguous CUDA tensors")
    if tuple(weight.shape) != (h,) or x.device != weight.device:
        raise ValueError(f"weight: expected shape ({h},) on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    out = torch.empty_like(x)
    m = x.numel() // h
    if m == 0:
        return out
    fn = _entry()
    err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), m, h, float(eps),
             int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(build.library("rms_norm"), err, "rms_norm")
    rms_norm_cuda.launches += 1
    return out


rms_norm_cuda.launches = 0


def _rms_norm(x, weight, eps):
    if x.is_cuda:
        return rms_norm_cuda(x if x.is_contiguous() else x.contiguous(), weight, eps)
    return rms_norm_plain(x, weight, eps)


class _RmsNorm(torch.autograd.Function):
    """Forward through the kernel (the plain version on the CPU); backward:
    the plain version's gradient, recomputed from the saved x and weight with
    fp32 statistics."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        return plain_grads(ctx, rms_norm_plain, g, ctx.eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: the kernel for a CUDA tensor, the plain version for a CPU
    tensor; through ``_RmsNorm`` where a gradient is wanted."""
    if needs_grad(x, weight):
        return _RmsNorm.apply(x, weight, eps)
    return _rms_norm(x, weight, eps)
