"""Shared model building blocks: norms, RoPE, KV cache, attention.

Counterpart of ``gptq_for_llama_tpu/models/common.py``, dense-cache subset.
fp32 is used for normalization statistics and softmax; everything else runs
in the compute dtype. RMSNorm, RoPE and the cache write are plain torch, as
the TPU package leaves them to XLA. Attention on a CUDA tensor always goes to
a kernel of ``ops/cuda``: with a cache offset to the decode or blocked prefill
kernel, without a cache (causal) to the causal prefill kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cuda.attention import attention_plain, decode_attention
from ..ops.cuda.flash import flash_prefill_blocked
from ..ops.cuda.flash_prefill import flash_prefill


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float, dtype=torch.float32):
    """cos/sin of shape (..., seq, dim) in the duplicated-half (HF) layout."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """Rotary embedding on q, k of shape (..., seq, heads, head_dim);
    cos/sin (..., seq, head_dim)."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return ((q * cos + rotate_half(q) * sin).to(q.dtype),
            (k * cos + rotate_half(k) * sin).to(k.dtype))


def update_kv_cache(cache_k, cache_v, k_new, v_new, offset, write_mask=None):
    """Write k/v at [offset, offset + s) of static-size caches, IN PLACE.

    cache_k/v: (B, max_len, Hkv, D); k_new/v_new: (B, s, Hkv, D); offset: an
    int (all rows aligned) or a (B,) tensor (every row at its own position).
    write_mask: optional (B,) bool with vector offsets; False rows keep their
    existing contents. Unlike the functional TPU version the caches are
    updated in place (no copy of the whole cache per token) and returned."""
    k_new = k_new.to(cache_k.dtype)
    v_new = v_new.to(cache_v.dtype)
    s = k_new.shape[1]
    if not isinstance(offset, torch.Tensor) or offset.ndim == 0:
        off = int(offset)
        cache_k[:, off:off + s] = k_new
        cache_v[:, off:off + s] = v_new
        return cache_k, cache_v
    b = cache_k.shape[0]
    rows = torch.arange(b, device=cache_k.device)[:, None]
    cols = offset.to(cache_k.device).long()[:, None] + torch.arange(s, device=cache_k.device)
    if write_mask is not None:
        m = write_mask.to(cache_k.device)[:, None, None, None]
        k_new = torch.where(m, k_new, cache_k[rows, cols])
        v_new = torch.where(m, v_new, cache_v[rows, cols])
    cache_k[rows, cols] = k_new
    cache_v[rows, cols] = v_new
    return cache_k, cache_v


def decode_mask(q_len: int, max_len: int, offset, dtype=torch.float32, device=None):
    """Additive mask: query i (at offset + i) sees slots j <= offset + i.
    Scalar offset -> (q_len, max_len); (B,) offset -> (B, 1, q_len, max_len)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    qi = torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(max_len, device=device)[None, :]
    if not isinstance(offset, torch.Tensor) or offset.ndim == 0:
        allowed = kj <= qi + offset
    else:
        allowed = (kj[None] <= qi[None] + offset[:, None, None])[:, None]
    return torch.where(allowed, 0.0, torch.finfo(dtype).min).to(dtype)


def causal_mask(q_len: int, kv_len: int, dtype=torch.float32, device=None):
    """Additive (q_len, kv_len) mask: query i attends kv <= i + kv_len - q_len."""
    qi = torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(kv_len, device=device)[None, :]
    return torch.where(kj <= qi + (kv_len - q_len), 0.0,
                       torch.finfo(dtype).min).to(dtype)


def apply_kv_cache(past_kv, k, v):
    """Cache protocol of every layer: past_kv is None (no cache) or
    (cache_k, cache_v, offset[, write_mask]) (dense static cache). Returns
    (k_eff, v_eff, present, offset_or_None)."""
    if past_kv is None:
        return k, v, (k, v), None
    cache_k, cache_v, offset = past_kv[:3]
    write_mask = past_kv[3] if len(past_kv) > 3 else None
    k, v = update_kv_cache(cache_k, cache_v, k, v, offset, write_mask=write_mask)
    return k, v, (k, v), offset


def attention_block(past_kv, q, k, v, mask, scale=None):
    """Cache write, then attention over the cache (the classic form):
    returns (attn_out, present). Without a cache the forward is causal."""
    k_eff, v_eff, present, off = apply_kv_cache(past_kv, k, v)
    out = sdpa(q, k_eff, v_eff, mask, scale, decode_offset=off, causal=past_kv is None)
    return out, present


def sdpa(q, k, v, mask=None, scale: float | None = None, decode_offset=None,
         causal: bool = False):
    """Scaled dot-product attention with fp32 softmax.

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), H a multiple of Hkv. mask:
    additive (Sq, Skv) or (B, 1, Sq, Skv). decode_offset DECLARES that the
    mask is exactly the causal-at-offset predicate: with Sq == 1 it goes to
    the decode-attention kernel, with Sq > 1 and a scalar offset to the
    blocked prefill kernel (gptq_for_llama_tpu/models/common.py:404-447).
    causal DECLARES that the mask is plain causal self-attention: the causal
    prefill kernel takes every Sq (the TPU package's Sq > 256 and VMEM gates
    exist only for its kernel). The kernels ignore ``mask``. On a CPU tensor
    each path takes its plain version; a CUDA tensor with any other mask
    raises, since no kernel applies an arbitrary mask."""
    sq, d = q.shape[1], q.shape[3]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if decode_offset is not None:
        scalar = not isinstance(decode_offset, torch.Tensor) or decode_offset.ndim == 0
        if sq == 1:
            return decode_attention(q, k, v, decode_offset, sc)
        if scalar:
            return flash_prefill_blocked(q, k, v, int(decode_offset), sc)
        if mask is None:
            mask = decode_mask(sq, k.shape[1], decode_offset)
    elif causal:
        return flash_prefill(q, k, v, sc)
    if q.is_cuda:
        raise NotImplementedError(
            "attention on the card runs only through its kernels: a cache offset "
            "(decode_offset) or causal self-attention (causal=True); no kernel takes an "
            "arbitrary mask")
    return attention_plain(q, k, v, sc, mask)


def activation(name: str):
    return {"silu": F.silu}[name]
