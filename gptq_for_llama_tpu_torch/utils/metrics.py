"""Quantization quality metrics: SNR probe, precision upgrade ladder, tables.

Counterpart of ``gptq_for_llama_tpu/utils/metrics.py`` (reference:
utils/modelutils.py:16-83).
"""

from __future__ import annotations

import numpy as np
import torch


def snr_error(y_pred, y_real, reduction: str = "mean") -> torch.Tensor:
    """Noise/signal power ratio per leading row, then reduced:
    sum((pred - real)^2, -1) / (sum(real^2, -1) + 1e-7)."""
    y_pred = torch.as_tensor(y_pred).float()
    y_real = torch.as_tensor(y_real).float()
    if y_pred.shape != y_real.shape:
        raise ValueError(f"shape mismatch {tuple(y_pred.shape)} vs {tuple(y_real.shape)}")
    if y_pred.ndim == 1:
        y_pred, y_real = y_pred[None], y_real[None]
    y_pred = y_pred.reshape(y_pred.shape[0], -1)
    y_real = y_real.reshape(y_real.shape[0], -1)
    snr = ((y_pred - y_real) ** 2).sum(-1) / ((y_real ** 2).sum(-1) + 1e-7)
    if reduction == "mean":
        return snr.mean()
    if reduction == "sum":
        return snr.sum()
    if reduction == "none":
        return snr
    raise ValueError(f"Unsupported reduction {reduction!r}")


def gen_conditions(wbits: int, groupsize: int) -> list[tuple[int, int]]:
    """Precision-upgrade ladder of the observe path: halve groupsize down to
    32, then double wbits and reset groupsize; stop at wbits >= 8 with
    groupsize exhausted (g <= 32 ends any input)."""
    w, g = wbits, groupsize
    conditions = []
    while not (w >= 8 and (g == -1 or g <= 32)):
        if g > 32:
            g //= 2
        else:
            w *= 2
            g = groupsize
        conditions.append((int(w), int(g)))
    return conditions


def ascii_table(header: list[str], rows: list[list]) -> str:
    """Minimal fixed-width table."""
    srows = [[f"{c:.6f}" if isinstance(c, float) else str(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in srows)) if srows else len(h)
              for i, h in enumerate(header)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"

    return "\n".join([sep, fmt(header), sep] + [fmt(r) for r in srows] + [sep])


def dequant_weight_np(qweight, qzeros, scales, g_idx, bits: int) -> np.ndarray:
    """Host-side dense (out, in) weight from wire-format buffers."""
    from ..quant import packing
    codes = packing.unpack_rows(np.asarray(qweight), bits, k=len(g_idx))  # (K, N)
    zeros = packing.unpack_cols(np.asarray(qzeros), bits, n=codes.shape[1]) + 1
    g = np.asarray(g_idx)
    s = np.asarray(scales, np.float32)
    return (((codes - zeros[g]).astype(np.float32)) * s[g]).T
