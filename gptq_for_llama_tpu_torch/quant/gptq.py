"""GPTQ one-shot weight quantization solver.

Counterpart of ``gptq_for_llama_tpu/quant/gptq.py``: Hessian accumulation
``H = (2 / nsamples) * sum_j X_j^T X_j`` (one-shot and streaming), and
``gptq_quantize``: dead columns, activation-order permutation by descending
diag(H), the damped Cholesky-inverse upper factor and the blockwise column
loop with error feedback. No custom kernel: ``torch.linalg`` and fp32
matmuls, on the device of the inputs.

The solver's products run in full fp32 (the reference's ``allow_tf32 =
False``, the TPU package's ``Precision.HIGHEST``): ``fp32_matmul`` turns TF32
off for its scope and restores the caller's setting. Gram sums accumulate in
fp64 and are rounded to fp32 once: on an H100 an fp32 GEMM over one 7B
calibration chunk (32,768 tokens) is 8.2e-5 of the largest entry off the
fp64 sums (chip_smoke.py), and on the synthetic corpus, whose tokens repeat
heavily, that left the damped Hessian indefinite (Cholesky failed on the
card). fp64 GEMM runs at the fp32 rate there. The TPU package's masked full-width ``lax.scan`` form exists only for
TPU memory; here one plain block loop serves every groupsize and width.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .quantizer import QuantConfig, find_params_weight, quantize_affine


class GPTQResult(NamedTuple):
    qweight: torch.Tensor   # (rows, cols) fake-quantized fp32 weight, original col order
    scale: torch.Tensor     # (rows, G)
    zero: torch.Tensor      # (rows, G)
    g_idx: torch.Tensor     # (cols,) int32 group index per column (original order)
    error: torch.Tensor     # scalar: sum((w - q)^2 / d^2) / 2


@contextlib.contextmanager
def fp32_matmul():
    """Full-fp32 matmuls (no TF32) inside the block; the caller's settings
    come back on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gram(x: torch.Tensor) -> torch.Tensor:
    """sum_t x_t^T x_t over every leading dim of x (..., cols), in fp64."""
    x2 = x.double().reshape(-1, x.shape[-1])
    return x2.T @ x2


def batch_hessian(x: torch.Tensor) -> torch.Tensor:
    """H = (2 / nsamples) * sum_j x_j^T x_j (fp32) for x (nsamples, tokens, cols)."""
    return ((2.0 / x.shape[0]) * gram(x)).float()


def update_hessian(h: torch.Tensor, nsamples: int, x: torch.Tensor):
    """Streaming update with one sample x (tokens, cols): returns
    (h * n/(n+1) + 2/(n+1) * x^T x, n + 1)."""
    n1 = nsamples + 1
    return h * (nsamples / n1) + ((2.0 / n1) * gram(x)).float(), n1


def _inverse_upper_factor(h: torch.Tensor) -> torch.Tensor:
    """Upper U with U^T U = H^-1 (the reference's cholesky -> cholesky_inverse
    -> cholesky(upper=True))."""
    chol = torch.linalg.cholesky(h)
    hinv = torch.cholesky_inverse(chol)
    return torch.linalg.cholesky(hinv, upper=True)


def gptq_quantize(w, h, cfg: QuantConfig, blocksize: int = 128, percdamp: float = 0.01,
                  groupsize: int = -1, actorder: bool = False) -> GPTQResult:
    """Quantize one linear weight w (rows, cols) = (out, in) with GPTQ against
    its Hessian h (cols, cols)."""
    with fp32_matmul():
        return _gptq(w.float().clone(), h.float().clone(), cfg, blocksize, percdamp,
                     groupsize, actorder)


def _gptq(w, h, cfg, blocksize, percdamp, groupsize, actorder):
    rows, cols = w.shape
    maxq = cfg.maxq
    dev = w.device
    scale, zero = find_params_weight(w, cfg)

    # dead columns: unit curvature, zero weight
    dead = torch.diagonal(h) == 0
    h[dead, dead] = 1.0
    w[:, dead] = 0.0

    perm = None
    if actorder:
        perm = torch.argsort(-torch.diagonal(h), stable=True)
        w = w[:, perm]
        h = h[perm][:, perm]

    damp = percdamp * torch.mean(torch.diagonal(h))
    h += torch.eye(cols, dtype=h.dtype, device=dev) * damp
    hinv = _inverse_upper_factor(h)

    gs = groupsize if groupsize != -1 else cols
    scales, zeros = ([scale], [zero]) if groupsize == -1 else ([], [])
    qout = torch.empty_like(w)
    losses = torch.empty_like(w)

    for i1 in range(0, cols, blocksize):
        i2 = min(i1 + blocksize, cols)
        w1 = w[:, i1:i2].clone()
        hinv1 = hinv[i1:i2, i1:i2]
        err1 = torch.empty_like(w1)
        for i in range(i2 - i1):
            c = i1 + i
            if groupsize != -1 and c % gs == 0:
                # group params from the block-stale weight: w gets the error
                # feedback only at block boundaries, the running block is w1
                scale, zero = find_params_weight(w[:, c:c + gs], cfg)
                scales.append(scale)
                zeros.append(zero)
            col = w1[:, i:i + 1]
            q = quantize_affine(col, scale, zero, maxq)
            e = (col - q) / hinv1[i, i]
            w1[:, i:] -= e * hinv1[i:i + 1, i:]
            w1[:, i:i + 1] = q      # q verbatim (the update can leave it 1 ulp off)
            err1[:, i:i + 1] = e
            losses[:, c:c + 1] = e * e
        qout[:, i1:i2] = w1
        if i2 < cols:
            w[:, i2:] -= err1 @ hinv[i1:i2, i2:]

    g_idx = torch.arange(cols, dtype=torch.int32, device=dev) // gs
    if actorder:
        invperm = torch.argsort(perm)
        qout = qout[:, invperm]
        g_idx = g_idx[invperm]
    error = losses.sum() / 2.0
    return GPTQResult(qout, torch.cat(scales, dim=1), torch.cat(zeros, dim=1), g_idx, error)


def rtn_quantize(w, cfg: QuantConfig, groupsize: int = -1) -> torch.Tensor:
    """Round-to-nearest fake quantization, optionally grouped along the
    in-features (cols % groupsize == 0)."""
    w = w.float()
    rows, cols = w.shape
    if groupsize == -1:
        scale, zero = find_params_weight(w, cfg)
        return quantize_affine(w, scale, zero, cfg.maxq)
    assert cols % groupsize == 0
    wg2 = w.reshape(rows, cols // groupsize, groupsize).transpose(0, 1).reshape(-1, groupsize)
    scale, zero = find_params_weight(wg2, cfg)
    q = quantize_affine(wg2, scale, zero, cfg.maxq)
    return q.reshape(cols // groupsize, rows, groupsize).transpose(0, 1).reshape(rows, cols)
