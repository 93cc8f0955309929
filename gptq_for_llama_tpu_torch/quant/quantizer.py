"""Affine min/max quantization parameter search.

Counterpart of ``gptq_for_llama_tpu/quant/quantizer.py``: per-channel or
per-tensor min/max with symmetric/asymmetric ranges, the zero-range guard
(xmin == xmax == 0 -> [-1, +1]), the optional MSE grid-shrink search and the
ternary "trits" mode (maxq = -1). Parameters are explicit tensors threaded
through plain functions; everything is fp32. ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the parameter search (the reference's
    Quantizer.configure(bits, perchannel, sym, mse, norm, grid, maxshrink,
    trits)).

    ``wire_safe`` clamps an asymmetric zero-point into [1, maxq]: the wire
    format stores ``zero - 1`` in unsigned words, so zero == 0 would wrap to
    maxq and dequantize as maxq + 1. Off by default to keep the reference's
    arithmetic."""

    bits: int = 4
    perchannel: bool = True
    sym: bool = False
    mse: bool = False
    norm: float = 2.4
    grid: int = 100
    maxshrink: float = 0.8
    trits: bool = False
    wire_safe: bool = False

    @property
    def maxq(self) -> int:
        return -1 if self.trits else (2 ** self.bits - 1)


def quantize_affine(x, scale, zero, maxq: int):
    """Fake-quantize: scale * (clamp(round(x/scale) + zero, 0, maxq) - zero);
    maxq < 0 is the ternary path."""
    if maxq < 0:
        return (x > scale / 2).to(x.dtype) * scale + (x < zero / 2).to(x.dtype) * zero
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def _recip(c: int) -> float:
    """The fp32 reciprocal of a constant divisor: XLA compiles x / c as
    x * (1/c), and the parameters must match the TPU package bit for bit."""
    return float(np.float32(1.0 / c))


def _minmax_ranges(x2d, sym: bool):
    """Per-row (xmin, xmax) of x2d (channels, elements) with the sign guards."""
    xmin = torch.clamp(x2d.amin(dim=1), max=0.0)
    xmax = torch.clamp(x2d.amax(dim=1), min=0.0)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    return xmin, xmax


def _params_from_range(xmin, xmax, cfg: QuantConfig):
    maxq = cfg.maxq
    if maxq < 0:  # trits: scale = xmax, zero = xmin
        return xmax, xmin
    scale = (xmax - xmin) * _recip(maxq)
    if cfg.sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
        if cfg.wire_safe:
            zero = torch.clamp(zero, 1.0, float(maxq))
    return scale, zero


def _mse_refine(x2d, xmin, xmax, scale, zero, cfg: QuantConfig):
    """Shrink the range by p = 1 - i/grid for i < maxshrink*grid and keep the
    per-row params minimizing sum(|q - x|^norm)."""
    maxq = cfg.maxq
    best = torch.full((x2d.shape[0],), float("inf"), dtype=torch.float32, device=x2d.device)
    # XLA contracts p = 1 - i/grid and xmax1 - xmin1 into FMAs; the fp64
    # forms below round once, as an FMA does, so the params match bit for bit
    ps = (1.0 - torch.arange(int(cfg.maxshrink * cfg.grid), dtype=torch.float64)
          * _recip(cfg.grid)).float().to(x2d.device)
    for p in ps:
        xmin1 = p * xmin
        scale1 = (p.double() * xmax.double() - xmin1.double()).float() * _recip(maxq)
        zero1 = zero if cfg.sym else torch.round(-xmin1 / scale1)
        if not cfg.sym and cfg.wire_safe and maxq >= 0:
            zero1 = torch.clamp(zero1, 1.0, float(maxq))
        q = quantize_affine(x2d, scale1[:, None], zero1[:, None], maxq)
        err = ((q - x2d).abs() ** cfg.norm).sum(dim=1)
        better = err < best
        best = torch.where(better, err, best)
        scale = torch.where(better, scale1, scale)
        zero = torch.where(better, zero1, zero)
    return scale, zero


def find_params_weight(w, cfg: QuantConfig):
    """(scale, zero), each (out_features, 1) fp32, for a weight (out, in...):
    per output row when ``perchannel``, else one pair broadcast to every row."""
    w = w.float()
    rows = w.shape[0]
    x2d = w.reshape(rows, -1) if cfg.perchannel else w.reshape(1, -1)
    xmin, xmax = _minmax_ranges(x2d, cfg.sym)
    scale, zero = _params_from_range(xmin, xmax, cfg)
    if cfg.mse:
        scale, zero = _mse_refine(x2d, xmin, xmax, scale, zero, cfg)
    if not cfg.perchannel:
        scale = scale.expand(rows)
        zero = zero.expand(rows)
    return scale[:, None], zero[:, None]


def find_params_activation(x, cfg: QuantConfig):
    """(scale, zero) broadcastable against an activation x of shape
    (tokens, features) or (batch, tokens, features): per feature when
    ``perchannel``, else per tensor."""
    x = x.float()
    shape = x.shape
    feat = shape[-1]
    x2d = x.reshape(-1, feat).T if cfg.perchannel else x.reshape(1, -1)
    xmin, xmax = _minmax_ranges(x2d, cfg.sym)
    scale, zero = _params_from_range(xmin, xmax, cfg)
    if cfg.mse:
        scale, zero = _mse_refine(x2d, xmin, xmax, scale, zero, cfg)
    if not cfg.perchannel:
        scale = scale.expand(feat)
        zero = zero.expand(feat)
    bshape = (1,) * (len(shape) - 1) + (feat,)
    return scale.reshape(bshape), zero.reshape(bshape)


def fake_quantize(x, scale, zero, cfg: QuantConfig):
    """Quantize-dequantize x with the given params (reference Quantizer.quantize)."""
    return quantize_affine(x.float(), scale, zero, cfg.maxq)
