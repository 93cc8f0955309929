"""Bit-packing of quantized integer weights into int32 words.

Wire format (byte-compatible with the reference QuantLinear buffers and with
``gptq_for_llama_tpu.quant.packing``):

- ``qweight``  int32 (K // 32 * bits, N): codes packed along K, little-endian
  within each word; one word holds 32/bits consecutive K-rows of one column.
- ``qzeros``   int32 (G, N // 32 * bits): zero-points MINUS ONE, packed along N.
- ``scales``   fp16 (G, N).
- ``g_idx``    int32 (K,): group index per in-feature row.

3-bit uses the standard GPTQ scheme (32 values in 3 words, values 10 and 21
straddling word boundaries). Every code is masked to its width before packing,
so an out-of-range code (the zeros-1 wrap at zero 0) corrupts only its own slot.

The device layout of the port IS the wire layout: a column's packed words lie
along K, so neighbouring threads reading neighbouring columns make coalesced
4-byte loads. The numpy functions are the reference's; their ``*_torch``
twins (2/4/8 bits) give the same bytes on the card, where checkpoint packing
and the act-order row sort run.
"""

from __future__ import annotations

import numpy as np
import torch

SUPPORTED_BITS = (2, 3, 4, 8)


def _check_bits(bits: int) -> None:
    if bits not in SUPPORTED_BITS:
        raise NotImplementedError(f"Only {SUPPORTED_BITS} bits are supported, got {bits}.")


def pack_rows(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack integer codes (K, N) -> int32 (K*bits//32, N) along axis 0."""
    _check_bits(bits)
    codes = np.ascontiguousarray(codes).astype(np.uint32)
    k = codes.shape[0]
    if bits == 3:
        if k % 32 != 0:
            raise ValueError(f"3-bit packing needs K % 32 == 0, got {k}")
        v = codes.reshape(-1, 32, *codes.shape[1:]) & 0x7
        w0 = np.zeros_like(v[:, 0])
        for j in range(10):
            w0 |= v[:, j] << (3 * j)
        w0 |= (v[:, 10] & 0x3) << 30
        w1 = v[:, 10] >> 2
        for j in range(10):
            w1 |= v[:, 11 + j] << (3 * j + 1)
        w1 |= (v[:, 21] & 0x1) << 31
        w2 = v[:, 21] >> 1
        for j in range(10):
            w2 |= v[:, 22 + j] << (3 * j + 2)
        out = np.stack([w0, w1, w2], axis=1).reshape(-1, *codes.shape[1:])
    else:
        ipw = 32 // bits  # integers per word
        if k % ipw != 0:
            raise ValueError(f"{bits}-bit packing needs K % {ipw} == 0, got {k}")
        v = codes.reshape(-1, ipw, *codes.shape[1:])
        out = np.zeros_like(v[:, 0])
        for j in range(ipw):
            out |= (v[:, j] & ((1 << bits) - 1)) << (bits * j)
    return out.astype(np.int32)


def unpack_rows(packed: np.ndarray, bits: int, k: int | None = None) -> np.ndarray:
    """Unpack int32 (K*bits//32, N) -> int32 codes (K, N) along axis 0."""
    _check_bits(bits)
    packed = np.asarray(packed)
    w = (np.ascontiguousarray(packed).view(np.uint32) if packed.dtype == np.int32
         else packed.astype(np.uint32))
    if bits == 3:
        c = w.reshape(-1, 3, *w.shape[1:])
        w0, w1, w2 = c[:, 0], c[:, 1], c[:, 2]
        vals = [(w0 >> (3 * j)) & 0x7 for j in range(10)]
        vals.append(((w0 >> 30) & 0x3) | ((w1 & 0x1) << 2))
        vals += [(w1 >> (3 * j + 1)) & 0x7 for j in range(10)]
        vals.append(((w1 >> 31) & 0x1) | ((w2 & 0x3) << 1))
        vals += [(w2 >> (3 * j + 2)) & 0x7 for j in range(10)]
        out = np.stack(vals, axis=1).reshape(-1, *w.shape[1:])
    else:
        ipw = 32 // bits
        maxq = (1 << bits) - 1
        vals = [(w >> (bits * j)) & maxq for j in range(ipw)]
        out = np.stack(vals, axis=1).reshape(-1, *w.shape[1:])
    if k is not None:
        out = out[:k]
    return out.astype(np.int32)


def pack_cols(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack integer codes (G, N) -> int32 (G, N*bits//32) along the last axis
    (qzeros)."""
    return np.ascontiguousarray(np.swapaxes(pack_rows(np.swapaxes(codes, 0, -1), bits), 0, -1))


def unpack_cols(packed: np.ndarray, bits: int, n: int | None = None) -> np.ndarray:
    """Unpack int32 (G, N*bits//32) -> codes (G, N) along the last axis."""
    return np.ascontiguousarray(np.swapaxes(unpack_rows(np.swapaxes(packed, 0, -1), bits, k=n), 0, -1))


def quantize_weight_to_codes(w, scales: np.ndarray, zeros: np.ndarray,
                             g_idx: np.ndarray) -> torch.Tensor:
    """Integer codes (K, N), int64 on w's device, of a fake-quantized weight w
    (N, K) (out, in; a tensor or numpy): rint(w / scale + zero) in float64,
    per-out-channel per-group params scales/zeros (N, G), group index g_idx
    (K,). The reference computes round((w + scale * zero) / scale)."""
    w = torch.as_tensor(w)
    g = torch.as_tensor(np.asarray(g_idx), dtype=torch.long, device=w.device)
    s = torch.as_tensor(np.asarray(scales), device=w.device).double()[:, g]
    z = torch.as_tensor(np.asarray(zeros), device=w.device).double()[:, g]
    return torch.round(w.double() / s + z).long().T


def pack_quantized(w, scales: np.ndarray, zeros: np.ndarray, g_idx: np.ndarray,
                   bits: int) -> dict:
    """Wire buffers {'qweight','qzeros','scales','g_idx'} (numpy) of one linear
    from its fake-quantized weight w (N, K) (a tensor, on any device, or
    numpy), scales/zeros (N, G) and g_idx (K,): codes and the 2/4/8-bit pack
    on w's device, scales transposed to (G, N) fp16, qzeros offset by -1 (an
    unsigned wrap at zero 0, as the reference)."""
    codes = quantize_weight_to_codes(w, scales, zeros, g_idx)
    qweight = (pack_rows_torch(codes, bits).cpu().numpy() if bits in (2, 4, 8)
               else pack_rows(codes.cpu().numpy(), bits))
    z = np.rint(np.asarray(zeros).T.astype(np.float64)).astype(np.int64)
    return {
        "qweight": qweight,
        "qzeros": pack_cols((z - 1).astype(np.uint32), bits),
        "scales": np.asarray(scales).T.astype(np.float16),
        "g_idx": np.asarray(g_idx).astype(np.int32),
    }


def dequantize(qweight, qzeros, scales, g_idx, bits: int, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, N) weight from wire buffers (numpy or tensors):
    (code - (qzero + 1)) * scale, each row's group from g_idx. 3-bit words are
    unpacked on the host."""
    g_idx = torch.as_tensor(np.asarray(g_idx), dtype=torch.long)
    k = g_idx.shape[0]
    codes = torch.as_tensor(unpack_rows(np.asarray(qweight), bits, k=k))
    n = codes.shape[1]
    zeros = torch.as_tensor(unpack_cols(np.asarray(qzeros), bits, n=n)) + 1
    s = torch.as_tensor(np.asarray(scales)).float()[g_idx]
    return ((codes - zeros[g_idx]).float() * s).to(dtype)


def unpack_rows_torch(packed: torch.Tensor, bits: int, k: int | None = None) -> torch.Tensor:
    """Torch unpack of 2/4/8-bit words: int32 (K*bits//32, N) -> int32 (K, N).

    The device layout never holds 3-bit words (INT3 loads as 4-bit nibbles)."""
    if bits not in (2, 4, 8):
        raise NotImplementedError(f"torch unpack takes 2/4/8 bits, got {bits}")
    ipw = 32 // bits
    maxq = (1 << bits) - 1
    # arithmetic shifts are safe: the mask drops every sign-extended bit
    vals = [(packed >> (bits * j)) & maxq for j in range(ipw)]
    out = torch.stack(vals, dim=1).reshape(-1, packed.shape[1])
    return out if k is None else out[:k]


def pack_rows_torch(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Torch twin of ``pack_rows`` for 2/4/8 bits: integer codes (K, N) ->
    int32 (K*bits//32, N), each code masked to its width, the same bytes."""
    if bits not in (2, 4, 8):
        raise NotImplementedError(f"torch pack takes 2/4/8 bits, got {bits}")
    ipw = 32 // bits
    k, n = codes.shape
    if k % ipw:
        raise ValueError(f"{bits}-bit packing needs K % {ipw} == 0, got {k}")
    v = (codes.long() & ((1 << bits) - 1)).reshape(k // ipw, ipw, n)
    shifts = torch.arange(0, 32, bits, device=codes.device).reshape(1, ipw, 1)
    words = (v << shifts).sum(dim=1)        # disjoint bit fields: the sum is the OR
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def gather_rows_packed_torch(packed: torch.Tensor, perm: torch.Tensor, bits: int) -> torch.Tensor:
    """codes[perm] re-packed, 2/4/8 bits, on packed's device: out code-row r
    = in code-row perm[r]. perm must be a full-length permutation of all K
    code rows."""
    k = perm.shape[0]
    if k * bits != packed.shape[0] * 32:
        raise ValueError(f"gather_rows_packed needs a full-length permutation: perm has "
                         f"{k} rows, packed holds {packed.shape[0] * 32 // bits}")
    return pack_rows_torch(unpack_rows_torch(packed, bits, k=k)[perm.long()], bits)
