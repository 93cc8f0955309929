"""Kernel 8, the grad-input of the dequant-GEMM: dispatch, CUDA wrapper,
launch count and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_t_kernel`` (entry
``quant_matmul_t_pallas``): ``dx = g @ dequant(W)^T``, the backward of every
frozen packed linear when adapters train. The kernel is ``csrc/qmm_t.cu``
(bf16 tensor cores; the slab of W a block needs is dequantized into shared
memory as the TPU kernel does, ``c * s - z * s`` in fp32 rounded to bf16);
its bound on the H100 at training row counts is operations. The plain
version is ``g @ lin.dequantize(g.dtype).T``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .grad import refuse_grad
from .matmul import check_tensor
from ..linear import PackedLinear

SOURCE = "gptq_for_llama_tpu_torch/csrc/qmm_t.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/matmul.py:260"


def quant_matmul_t_plain(g2: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """g2 (M, N) -> (M, K) in device row order (before the inverse perm)."""
    return g2 @ lin.dequantize(g2.dtype).T


def _entry():
    fn = build.library("qmm_t").gptq_qmm_t
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def qmm_t_cuda(g2: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """dx = g2 @ dequant(lin)^T on the card. g2: (M, N) bf16 with N % 8 == 0;
    device bits 2/4/8. Returns (M, K) bf16 in device row order."""
    refuse_grad("qmm_t", g2, lin.scales, lin.zeros)
    k, n = lin.in_features, lin.out_features
    if lin.bits not in (2, 4, 8) or n % 8 or k % (32 // lin.bits):
        raise ValueError(f"grad-input kernel takes device bits 2/4/8, out_features % 8 == 0 "
                         f"and whole packed words along K; got K={k}, N={n}, bits={lin.bits}")
    groups = lin.scales.shape[0]
    check_tensor(g2, "g", torch.bfloat16, (g2.shape[0], n))
    check_tensor(lin.qweight, "qweight", torch.int32, (k * lin.bits // 32, n))
    check_tensor(lin.scales, "scales", torch.bfloat16, (groups, n))
    check_tensor(lin.zeros, "zeros", torch.bfloat16, (groups, n))
    if g2.device != lin.qweight.device:
        raise ValueError(f"g on {g2.device}, weights on {lin.qweight.device}")
    m = g2.shape[0]
    out = torch.empty((m, k), dtype=torch.bfloat16, device=g2.device)
    if m == 0:
        return out
    err = _entry()(g2.data_ptr(), lin.qweight.data_ptr(), lin.scales.data_ptr(),
                   lin.zeros.data_ptr(), out.data_ptr(), m, k, n, groups, lin.groupsize,
                   lin.bits, torch.cuda.current_stream(g2.device).cuda_stream)
    build.check(build.library("qmm_t"), err, "qmm_t")
    qmm_t_cuda.launches += 1
    return out


qmm_t_cuda.launches = 0


def quant_matmul_t(g: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """Grad-input of ``quant_matmul``: g (..., N) -> dx (..., K) in the
    input's order. The kernel for a CUDA tensor, the plain version for a CPU
    tensor; then the inverse act-order permutation (the TPU package's
    quant_matmul_t_pallas; the port has no K padding to drop)."""
    lead, k = g.shape[:-1], lin.in_features
    g2 = g.reshape(-1, lin.out_features)
    dx = qmm_t_cuda(g2.contiguous(), lin) if g.is_cuda else quant_matmul_t_plain(g2, lin)
    if lin.perm is not None:
        dx = dx.index_select(-1, torch.argsort(lin.perm))
    return dx.reshape(*lead, k)
