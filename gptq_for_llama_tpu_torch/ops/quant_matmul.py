"""Quantized matmul dispatch: the CUDA dequant-GEMM for CUDA tensors, the
plain dequantize-then-matmul for CPU tensors, and their gradients.

Counterpart of ``gptq_for_llama_tpu/ops/quant_matmul.py``. Unlike the TPU
package there is no shape gate that falls back to XLA: the kernel takes every
shape this package produces (ragged last group, any M) or raises.

Differentiable in x (LoRA finetuning over frozen packed weights): where a
gradient is wanted the call goes through ``_QuantMatmul``, whose backward is
the grad-input kernel (``ops/cuda/matmul_t.py``), and the fused gate/up
through ``_FusedGateUp``, which recomputes through the unfused form so that
each branch's grad-input takes that kernel too (the TPU package's
``_quant_matmul_ad`` and ``_fused_mlp_ad``). The packed buffers get no
gradient. Without a gradient the kernels are called directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import matmul as cuda_matmul
from .cuda.grad import needs_grad
from .cuda.matmul_t import quant_matmul_t
from .cuda.mlp import fused_mlp, supports_fused
from .linear import PackedLinear, linear_apply, quant_matmul_plain


def _quant_matmul(x: torch.Tensor, lin: PackedLinear, dtype) -> torch.Tensor:
    if not x.is_cuda:
        return quant_matmul_plain(x, lin, dtype=dtype)
    if lin.perm is not None:
        x = x.index_select(-1, lin.perm)
    lead = x.shape[:-1]
    y = cuda_matmul.qmm_cuda(x.reshape(-1, lin.in_features).contiguous(), lin)
    return y.reshape(*lead, lin.out_features)


class _QuantMatmul(torch.autograd.Function):
    """y = x @ dequant(lin) + bias through kernel 1; dx = g @ dequant(lin)^T
    through kernel 8 and the inverse perm; a bias that requires grad gets the
    sum of g over the leading axes."""

    @staticmethod
    def forward(ctx, x, bias, lin, dtype):
        ctx.lin = lin
        return _quant_matmul(x, lin, dtype)

    @staticmethod
    def backward(ctx, g):
        dx = quant_matmul_t(g, ctx.lin) if ctx.needs_input_grad[0] else None
        db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.needs_input_grad[1] else None
        return dx, db, None, None


def quant_matmul(x: torch.Tensor, lin: PackedLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(lin) + bias for x of any leading shape (..., K)."""
    x = x.to(dtype)
    if needs_grad(x, lin.bias):
        return _QuantMatmul.apply(x, lin.bias, lin, dtype)
    return _quant_matmul(x, lin, dtype)


class _FusedGateUp(torch.autograd.Function):
    """silu(x @ gate) * (x @ up) through kernel 2; the backward recomputes the
    unfused form under autograd, so each branch runs kernel 1 and its
    grad-input kernel 8."""

    @staticmethod
    def forward(ctx, x, gate, up):
        ctx.save_for_backward(x)
        ctx.lins = (gate, up)
        return fused_mlp(x, gate, up)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gate, up = ctx.lins
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            y = (F.silu(quant_matmul(xx, gate, dtype=xx.dtype))
                 * quant_matmul(xx, up, dtype=xx.dtype))
        (dx,) = torch.autograd.grad(y, xx, g)
        return dx, None, None


def fused_gate_up(gate, up, x: torch.Tensor, act: str) -> torch.Tensor:
    """act(x @ gate) * (x @ up): the fused kernel when both linears are packed
    (not adapted) and fusable with SiLU, otherwise two applies and the
    activation."""
    if (act == "silu" and isinstance(gate, PackedLinear)
            and isinstance(up, PackedLinear) and supports_fused(gate, up)):
        if needs_grad(x):
            return _FusedGateUp.apply(x, gate, up)
        return fused_mlp(x, gate, up)
    from ..models.common import activation
    return activation(act)(linear_apply(gate, x)) * linear_apply(up, x)
