"""Kernel 6, RMSNorm: dispatch, CUDA wrapper, launch count and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/norm.py:_rms_kernel`` (entry
``rms_norm_pallas``). The kernel is ``csrc/rms_norm.cu``: one block per row,
fp32 statistics, ``(x_f32 * r) * w_f32`` rounded once to x's dtype; its bound
on the H100 is the bytes it reads and writes. It has two forms, counted apart in
``rms_norm_cuda.forms``: ``alone`` (RMSNorm of x) and ``add``, which folds a
pending residual add into the same launch, ``h = x + r`` (torch's add in x's
dtype, written to a new tensor) and ``y = RMSNorm(h)``: the TPU package's
pair ``x = x + o; rms_norm(x)``. The plain versions are the TPU package's
``models/common.rms_norm``, after the torch add for the second form. Where a
gradient is wanted the forward still launches the kernel, inside
``_RmsNorm`` / ``_AddRmsNorm``, whose backward is the plain version's
gradient (the TPU package differentiates its XLA norm; there is no backward
kernel to port).
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


def add_rms_norm_plain(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                       eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """h = x + r, then RMSNorm of h: returns (h, y)."""
    h = x + r
    return h, rms_norm_plain(h, weight, eps)


def _entry():
    fn = build.library("rms_norm").gptq_rms_norm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, weight: torch.Tensor) -> int:
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
    return h


def _launch(x, r, weight, eps, h):
    """One launch on checked operands: returns (x + r or None, y)."""
    out = torch.empty_like(x)
    s = None if r is None else torch.empty_like(x)
    m = x.numel() // h
    if m == 0:
        return s, out
    fn = _entry()
    err = fn(x.data_ptr(), None if r is None else r.data_ptr(), weight.data_ptr(),
             None if s is None else s.data_ptr(), out.data_ptr(), m, h, float(eps),
             int(x.dtype == torch.float32), int(weight.dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(build.library("rms_norm"), err, "rms_norm")
    rms_norm_cuda.launches += 1
    rms_norm_cuda.forms["alone" if r is None else "add"] += 1
    return s, out


def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel: x (..., H) bf16 or fp32, contiguous; weight (H,) bf16 or
    fp32. Any number of rows and any H up to 58,112 (the row is staged in
    shared memory as fp32)."""
    refuse_grad("rms_norm", x, weight)
    return _launch(x, None, weight, eps, _check(x, weight))[1]


def add_rms_norm_cuda(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's residual form: h = x + r (a new tensor), y = RMSNorm(h),
    in one launch. r has x's shape, dtype and device and is contiguous; the
    rest as ``rms_norm_cuda``."""
    refuse_grad("add_rms_norm", x, r, weight)
    h = _check(x, weight)
    if r.shape != x.shape or r.dtype != x.dtype or r.device != x.device:
        raise ValueError(f"residual: expected {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(r.shape)} {r.dtype} on {r.device}")
    if not r.is_contiguous():
        raise ValueError("RMSNorm kernel needs a contiguous residual")
    return _launch(x, r, weight, eps, h)


rms_norm_cuda.launches = 0
rms_norm_cuda.forms = {"alone": 0, "add": 0}   # launches by form


def launch_floor(device) -> None:
    """One launch of an empty kernel (one block of one warp) on ``device``'s
    current stream: what a decode-width norm is timed against. Counted
    nowhere; no path of the model calls it."""
    fn = build.library("rms_norm").gptq_launch_floor
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    build.check(build.library("rms_norm"), fn(torch.cuda.current_stream(device).cuda_stream),
                "launch floor")


def _contig(t):
    return t if t.is_contiguous() else t.contiguous()


def _rms_norm(x, weight, eps):
    if x.is_cuda:
        return rms_norm_cuda(_contig(x), weight, eps)
    return rms_norm_plain(x, weight, eps)


def _add_rms_norm(x, r, weight, eps):
    if x.is_cuda:
        return add_rms_norm_cuda(_contig(x), _contig(r), weight, eps)
    return add_rms_norm_plain(x, r, weight, eps)


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


def _sum_and_norm(h, weight, eps):
    return h, rms_norm_plain(h, weight, eps)


class _AddRmsNorm(torch.autograd.Function):
    """Forward through the kernel's residual form (the plain version on the
    CPU); backward: the plain version's gradient for both outputs. It saves h
    (which it returns, so it costs no memory) in place of x and r: the add's
    gradient is the sum's, to both."""

    @staticmethod
    def forward(ctx, x, r, weight, eps):
        h, y = _add_rms_norm(x, r, weight, eps)
        ctx.save_for_backward(h, weight)
        ctx.eps = eps
        return h, y

    @staticmethod
    def backward(ctx, gh, gy):
        nx, nr, nw = ctx.needs_input_grad[:3]
        gsum, gw, _ = plain_grads(ctx, _sum_and_norm, (gh, gy), ctx.eps, need=(nx or nr, nw))
        return gsum if nx else None, gsum if nr else None, gw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: the kernel for a CUDA tensor, the plain version for a CPU
    tensor; through ``_RmsNorm`` where a gradient is wanted."""
    if needs_grad(x, weight):
        return _RmsNorm.apply(x, weight, eps)
    return _rms_norm(x, weight, eps)


def add_rms_norm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, y) = (x + r, RMSNorm(x + r)) in one launch of the kernel for a CUDA
    tensor, the plain version for a CPU tensor; through ``_AddRmsNorm`` where
    a gradient is wanted."""
    if needs_grad(x, r, weight):
        return _AddRmsNorm.apply(x, r, weight, eps)
    return _add_rms_norm(x, r, weight, eps)
