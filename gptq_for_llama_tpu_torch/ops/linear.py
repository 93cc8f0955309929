"""Linear layers: dense dicts and bit-packed quantized linears.

Counterpart of ``gptq_for_llama_tpu/ops/linear.py``. ``PackedLinear`` keeps
the reference wire layout on the device (rows packed along K), with two
load-time transforms that ``to_wire`` inverts byte-exactly:

- act-order: rows are group-sorted once and the input permutation ``perm`` is
  stored, so the matmul applies a K-sized activation gather and sees monotone
  groups;
- INT3: codes are repacked as 4-bit nibbles (``wire_bits=3``), so kernels only
  ever unpack 2/4/8-bit words.

The TPU package's K padding and nibble interleave are TPU tiling devices and
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..quant import packing


@dataclasses.dataclass
class PackedLinear:
    """Quantized linear parameters in device layout.

    Device tensors (everything compute reads):
      qweight int32 (K*bits//32, N), rows group-sorted;
      scales  (G, N) compute dtype;
      zeros   (G, N) compute dtype: the effective zero (unpacked qzeros + 1),
              integer-valued <= 2^bits, exact in bf16;
      perm    int64 (K,) or None: input permutation (x[..., perm]);
      bias    (N,) or None.
    Host numpy buffers kept only so ``to_wire`` is byte-exact:
      qzeros (G, N*bits//32) int32, g_idx (K,) int32, scales_wire (G, N) fp16.
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    perm: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    bits: int
    groupsize: int
    in_features: int
    out_features: int
    qzeros: np.ndarray
    g_idx: np.ndarray
    scales_wire: np.ndarray
    wire_bits: Optional[int] = None
    # digest of g_idx, set iff perm is not None: two linears share an input
    # permutation iff their digests match (ops/cuda/mlp.supports_fused)
    perm_sig: Optional[int] = None

    @classmethod
    def from_wire(cls, qweight, qzeros, scales, g_idx, bits: int, bias=None,
                  dtype=torch.bfloat16, device=None) -> "PackedLinear":
        """Build the device layout from reference wire-format numpy buffers
        on ``device`` (None: the card)."""
        device = resolve_device(device)
        qweight = np.asarray(qweight)
        qzeros = np.asarray(qzeros)
        scales = np.asarray(scales)
        g_idx = np.asarray(g_idx).astype(np.int32)
        k = g_idx.shape[0]
        n = scales.shape[1]
        groupsize = -(-k // scales.shape[0])

        perm = perm_sig = None
        if np.any(np.diff(g_idx) < 0):  # act-order checkpoint: group-sort rows
            perm = np.argsort(g_idx, kind="stable").astype(np.int32)
            perm_sig = int.from_bytes(
                hashlib.blake2b(g_idx.tobytes(), digest_size=8).digest(), "little")

        zeros = packing.unpack_cols(qzeros, bits, n=n).astype(np.float32) + 1.0
        scales_wire = np.asarray(scales, np.float16)

        wire_bits = None
        if bits == 3:  # INT3 -> 4-bit nibble device codes; to_wire repacks
            codes = packing.unpack_rows(qweight, 3, k=k)
            qweight = packing.pack_rows(codes.astype(np.uint32), 4)
            wire_bits, bits = 3, 4

        def dev(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

        qweight = dev(qweight, torch.int32)
        if perm is not None:   # the row sort runs where the weight lives
            qweight = packing.gather_rows_packed_torch(qweight, dev(perm, torch.int64), bits)
        return cls(
            qweight=qweight,
            scales=dev(scales.astype(np.float32), dtype),
            zeros=dev(zeros, dtype),
            perm=None if perm is None else dev(perm, torch.int64),
            bias=None if bias is None else dev(np.asarray(bias, np.float32), dtype),
            bits=bits, groupsize=groupsize, in_features=k, out_features=n,
            qzeros=qzeros, g_idx=g_idx, scales_wire=scales_wire,
            wire_bits=wire_bits, perm_sig=perm_sig)

    def to_wire(self) -> dict:
        """Reference wire-format numpy buffers (original, unsorted row order)."""
        qweight = self.qweight
        k = self.in_features
        if self.perm is not None:
            qweight = packing.gather_rows_packed_torch(qweight, torch.argsort(self.perm),
                                                       self.bits)
        qweight = qweight.cpu().numpy()
        if self.wire_bits is not None and self.wire_bits != self.bits:
            # nibble device codes of an INT3 checkpoint: codes <= 7 narrow exactly
            codes = packing.unpack_rows(qweight, self.bits, k=k)
            qweight = packing.pack_rows(codes.astype(np.uint32), self.wire_bits)
        out = {"qweight": qweight, "qzeros": self.qzeros,
               "scales": self.scales_wire, "g_idx": self.g_idx}
        if self.bias is not None:
            out["bias"] = self.bias.float().cpu().numpy().astype(np.float16)
        return out

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dense (K_sorted, N) weight in device row order (after perm)."""
        k, n = self.in_features, self.out_features
        codes = packing.unpack_rows_torch(self.qweight, self.bits, k=k).float()
        g = self.scales.shape[0]
        s, z = self.scales.float(), self.zeros.float()
        if g * self.groupsize == k:
            w = (codes.reshape(g, self.groupsize, n) - z[:, None]) * s[:, None]
            return w.reshape(k, n).to(dtype)
        # ragged last group: row gather
        gid = torch.clamp(torch.arange(k, device=codes.device) // self.groupsize, max=g - 1)
        return ((codes - z[gid]) * s[gid]).to(dtype)


def quant_matmul_plain(x, lin: PackedLinear, dtype=torch.bfloat16):
    """Plain version of the dequant-GEMM (the TPU package's quant_matmul_xla):
    dequantize to the compute dtype, then matmul."""
    if lin.perm is not None:
        x = x.index_select(-1, lin.perm)
    y = torch.matmul(x.to(dtype), lin.dequantize(dtype))
    if lin.bias is not None:
        y = y + lin.bias
    return y


def linear_apply(lin, x, dtype=None):
    """Apply a dense ({'kernel': (K, N), 'bias': ...}) or packed linear.
    The compute dtype follows the activation unless overridden."""
    dtype = dtype or x.dtype
    if isinstance(lin, PackedLinear):
        from .quant_matmul import quant_matmul
        return quant_matmul(x, lin, dtype=dtype)
    y = torch.matmul(x.to(dtype), lin["kernel"].to(dtype))
    b = lin.get("bias")
    if b is not None:
        y = y + b.to(dtype)
    return y


def dense(kernel, bias=None):
    d = {"kernel": kernel}
    if bias is not None:
        d["bias"] = bias
    return d
