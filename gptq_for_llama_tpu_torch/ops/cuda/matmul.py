"""Kernel 1, the dequant-GEMM: CUDA wrapper, launch count and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel``. The kernel is
``csrc/qmm.cu``; its body, its bound on the H100 (the packed weight bytes at
decode) and its design (coalesced 16-byte word loads, dot-then-scale per
group, split-K with a deterministic second pass) are described in
``csrc/qmm_common.cuh``. The plain version is ``ops.linear.quant_matmul_plain``
(dequantize to the compute dtype, then matmul).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build
from .grad import refuse_grad
from ..linear import PackedLinear, quant_matmul_plain  # noqa: F401  (the plain version)

SOURCE = "gptq_for_llama_tpu_torch/csrc/qmm.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/matmul.py:68"

TILE_N = 128          # columns per block (32 lanes x 4 columns)
_X_SMEM_BYTES = 96 * 1024   # cap on the block's fp32 x slice in shared memory


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(m: int, k: int, n: int, bits: int, sms: int = 132, blocks_per_sm: int = 4):
    """(row tile MT, K-splits, packed words per split) for one launch.

    Enough blocks for ``blocks_per_sm`` per SM: a 4096-wide decode linear
    has only 32 column tiles, so K is split across blocks (17 ways at
    K = 4096 for 4 per SM). Kernel 1's decode blocks (48 registers) fit 5
    per SM; kernel 2's (76) fit 3, so it plans for 2 (PERF.md, PR 1)."""
    ipw = 32 // bits
    kw = k // ipw
    mt = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8
    tiles = -(-n // TILE_N) * -(-m // mt)
    split = max(1, min(-(-blocks_per_sm * sms // tiles), -(-kw // 8)))
    wps = -(-kw // split)
    wps = min(wps, max(1, _X_SMEM_BYTES // (mt * 4 * ipw)))
    return mt, -(-kw // wps), wps


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """What every kernel wrapper demands of its operands; raises otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous, 16-byte aligned tensor")


def check_packed(lin: PackedLinear, x2: torch.Tensor) -> None:
    k, n = lin.in_features, lin.out_features
    if lin.bits not in (2, 4, 8):
        raise ValueError(f"dequant-GEMM kernel takes device bits 2/4/8, got {lin.bits}")
    if n % 4 or k % (32 // lin.bits):
        raise ValueError(f"dequant-GEMM kernel needs out_features % 4 == 0 and whole "
                         f"packed words along K, got K={k}, N={n}, bits={lin.bits}")
    g = lin.scales.shape[0]
    check_tensor(x2, "x", torch.bfloat16, (x2.shape[0], k))
    check_tensor(lin.qweight, "qweight", torch.int32, (k * lin.bits // 32, n))
    check_tensor(lin.scales, "scales", torch.bfloat16, (g, n))
    check_tensor(lin.zeros, "zeros", torch.bfloat16, (g, n))
    if x2.device != lin.qweight.device:
        raise ValueError(f"x on {x2.device}, weights on {lin.qweight.device}")


def _entry():
    fn = build.library("qmm").gptq_qmm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
    return fn


def qmm_cuda(x2: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """y = x2 @ dequant(lin) + bias on the card. x2: (M, K) bf16, already
    permuted (act-order); returns (M, N) bf16."""
    refuse_grad("qmm", x2, lin.bias, lin.scales, lin.zeros)
    check_packed(lin, x2)
    if lin.bias is not None:
        check_tensor(lin.bias, "bias", torch.bfloat16, (lin.out_features,))
    m, k, n = x2.shape[0], lin.in_features, lin.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    if m == 0:
        return out
    mt, split, wps = plan(m, k, n, lin.bits, _sm_count(x2.device.index or 0))
    partial = (torch.empty((split, m, n), dtype=torch.float32, device=x2.device)
               if split > 1 else None)
    fn = _entry()
    err = fn(x2.data_ptr(), lin.qweight.data_ptr(), lin.scales.data_ptr(),
             lin.zeros.data_ptr(), None if lin.bias is None else lin.bias.data_ptr(),
             out.data_ptr(), None if partial is None else partial.data_ptr(),
             m, k, n, lin.scales.shape[0], lin.groupsize, lin.bits, mt, split, wps,
             torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(build.library("qmm"), err, "qmm")
    qmm_cuda.launches += 1
    return out


qmm_cuda.launches = 0
