"""Shared model building blocks: norms, RoPE, KV cache, attention.

Counterpart of ``gptq_for_llama_tpu/models/common.py``: the dense cache and
the serving engine's cache protocol (per-slot offsets, paged block pools,
batched admission, the token-fused chunk+decode step). fp32 is used for
normalization statistics and softmax; everything else runs in the compute
dtype. RoPE and the cache writes are plain torch, as the TPU package leaves
them to XLA; a cache may be stored in bf16, f32 or fp8 (``ops/kv_dtype.py``)
and every write goes through its encoder (JAX's ``astype``) and the cache's
stored view (fp8 bytes as uint8). RMSNorm and attention on a CUDA tensor
always go to a kernel of ``ops/cuda``, which reads the cache in its stored
dtype: a decode row over a dense cache to the decode kernel (or, in
the fold form, to the fold kernel, which attends the stale prefix plus the
current token's k/v), over a block pool to the pool kernel, a chunk of
queries at a cache offset to the blocked prefill kernel, and causal
self-attention without a cache to the causal prefill kernel, which is also
the training forward (its gradient, and RMSNorm's, is the plain version's).
A residual add that feeds a norm is folded into the norm's launch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import kv_dtype
from ..ops.cuda.attention import (attention_plain, decode_attention, fused_decode_attention,
                                  pool_decode_attention)
from ..ops.cuda.flash import flash_prefill_blocked
from ..ops.cuda.flash_prefill import flash_prefill
# kernel 6 on the card, plain on the CPU; add_rms_norm is the TPU package's
# pair ``x = x + o; rms_norm(x)`` in one launch, returning (x + o, the norm)
from ..ops.cuda.norm import add_rms_norm, rms_norm  # noqa: F401
from ..ops.linear import PackedLinear, dense, linear_apply


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm with fp32 statistics, cast back to x's dtype
    (``gptq_for_llama_tpu/models/common.py:22-30``). The TPU package leaves it
    to XLA (no Pallas kernel), so ``F.layer_norm`` in fp32 is the port's form
    on both devices."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                     None if bias is None else bias.float(), eps)
    return y.to(x.dtype)


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


def apply_rope(q, k, cos, sin, rotary_dim: int | None = None):
    """Rotary embedding on q, k of shape (..., seq, heads, head_dim);
    cos/sin (..., seq, rotary_dim). A ``rotary_dim`` below head_dim rotates
    only the first rotary_dim dims of each head, in HF's half layout, and
    passes the rest (GPT-NeoX's rotary_pct; ``models/common.py:52-69`` of
    the TPU package)."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    if rotary_dim is None or rotary_dim == q.shape[-1]:
        return ((q * cos + rotate_half(q) * sin).to(q.dtype),
                (k * cos + rotate_half(k) * sin).to(k.dtype))
    out = []
    for t in (q, k):
        rot, rest = t[..., :rotary_dim], t[..., rotary_dim:]
        out.append(torch.cat([rot * cos + rotate_half(rot) * sin, rest], dim=-1).to(t.dtype))
    return tuple(out)


def update_kv_cache(cache_k, cache_v, k_new, v_new, offset, write_mask=None):
    """Write k/v at [offset, offset + s) of static-size caches, IN PLACE.

    cache_k/v: (B, max_len, Hkv, D); k_new/v_new: (B, s, Hkv, D); offset: a
    host int (all rows aligned), a (B,) tensor (every row at its own
    position) or a 1-element tensor (all rows at it; read on the device, as
    a CUDA graph needs). The caller keeps offset + s within the cache: a
    device offset is not checked on the host. write_mask: optional (B,) bool
    with tensor offsets; False rows keep their existing contents. Unlike the
    functional TPU version the caches are updated in place (no copy of the
    whole cache per token) and returned. The new k/v are encoded in the
    cache's dtype (``kv_dtype.encode``) and written through its stored view
    (an fp8 cache as bytes: torch has no CPU scatter for float8)."""
    ck, cv = kv_dtype.stored(cache_k), kv_dtype.stored(cache_v)
    k_new = kv_dtype.encode(k_new, cache_k.dtype)
    v_new = kv_dtype.encode(v_new, cache_v.dtype)
    s = k_new.shape[1]
    if not isinstance(offset, torch.Tensor):
        off = int(offset)
        ck[:, off:off + s] = k_new
        cv[:, off:off + s] = v_new
        return cache_k, cache_v
    # a scatter along the slots: 3 launches a layer in a decode graph where an
    # indexed write takes 6
    cols = offset.to(cache_k.device).reshape(-1).long()[:, None]
    if s > 1:
        cols = cols + torch.arange(s, device=cache_k.device)
    idx = cols[:, :, None, None].expand(k_new.shape)
    if write_mask is not None:
        m = write_mask.to(cache_k.device)[:, None, None, None]
        k_new = torch.where(m, k_new, ck.gather(1, idx))
        v_new = torch.where(m, v_new, cv.gather(1, idx))
    ck.scatter_(1, idx, k_new)
    cv.scatter_(1, idx, v_new)
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
    """Cache protocol of every layer. The caches and pools are written in
    place. past_kv forms (``max_live``, optional and last, is a host-side
    bound on offset + 1 over the rows, for the decode kernels' split plan):
      None                                    no cache (plain causal forward)
      (ck, cv, offset[, write_mask[, max_live]])
                                              dense static cache; offset an
                                              int (rows aligned) or (B,)
      ("fold", ck, cv, offset[, write_mask[, max_live]])
                                              the same cache, decoded in the
                                              fold form by ``attention_block``
                                              (one query token and one new k/v:
                                              attention over the stale prefix
                                              plus the current k/v, then the
                                              row write under the mask; the TPU
                                              package's GPTQ_TPU_CACHE_IMPL=pallas).
                                              With more tokens, as the dense
                                              form
      ("paged", kp, vp, tables, offset[, write_mask[, max_live]])
                                              one layer's block pool
                                              (NB, BS, Hkv, D); runtime/paged.py.
                                              One decode token per row, or one
                                              slot's chunk (one table row; a
                                              host-int offset, or a device one
                                              with its bound max_live)
      ("fresh", ck, cv, write_mask)           batched admission: every masked
      ("fresh_paged", kp, vp, tables, write_mask)
                                              row's prompt starts at cache
                                              position 0; the cache is written
                                              under the mask (paged: unmasked
                                              rows go to scratch block 0) and
                                              attention is causal over the
                                              fresh chunk alone
      ("grouped", ck, cv, offsets, live, slot, off0, b_dec[, max_live])
      ("grouped_paged", kp, vp, tables, offsets, live, slot, off0, b_dec[, max_live])
                                              token-fused serving step over one
                                              flat (1, B + C) token row: rows
                                              0..B-1 are one decode token per
                                              slot, rows B.. a prompt chunk of
                                              slot ``slot`` starting at
                                              ``off0``; b_dec = 0 (offsets and
                                              live None) is one slot's prompt
                                              or chunk alone. slot and off0 are
                                              host ints or 1-element int32
                                              tensors on the device (then
                                              max_live, the one bound of the
                                              decode rows' offset + 1 and of
                                              off0 + C, is required)
    An offset on the device is never read on the host (no ``int()``,
    ``.item()`` or host-sized slice of it), so a CUDA graph captured over a
    form replays at any offset and slot; ``max_live`` is the host-side bound
    the kernels plan from. Returns (k_eff, v_eff, present, offset): what
    attention reads (tensors, or ("pool", pool, tables) markers), what the
    layer returns as its cache, and the offset declaration for ``sdpa``
    (None: causal over k_eff)."""
    if past_kv is None:
        return k, v, (k, v), None
    if _is_fold(past_kv):
        past_kv = past_kv[1:]
    tag = past_kv[0] if isinstance(past_kv[0], str) else "dense"
    if tag in ("paged", "fresh_paged", "grouped_paged"):
        from ..runtime.paged import gather_prefix, paged_update_layer
    if tag == "fresh":
        _, ck, cv, wmask = past_kv
        zero = torch.zeros(k.shape[0], dtype=torch.long, device=k.device)
        ck, cv = update_kv_cache(ck, cv, k, v, zero, write_mask=wmask)
        return k, v, (ck, cv), None
    if tag == "fresh_paged":
        _, kp, vp, tables, wmask = past_kv
        kp, vp, _, _ = paged_update_layer(kp, vp, k, v, tables, 0, write_mask=wmask,
                                          gather=False)
        return k, v, (kp, vp), None
    if tag == "grouped":
        _, ck, cv, offsets, live, slot, off0, b_dec = past_kv[:8]
        _slot_write(ck, k[0, b_dec:], slot, off0)
        _slot_write(cv, v[0, b_dec:], slot, off0)
        if b_dec:
            update_kv_cache(ck, cv, k[0, :b_dec, None], v[0, :b_dec, None], offsets,
                            write_mask=live)
        return ck, cv, (ck, cv), ("grouped", offsets, slot, off0, b_dec, *past_kv[8:])
    if tag == "grouped_paged":
        _, kp, vp, tables, offsets, live, slot, off0, b_dec = past_kv[:9]
        paged_update_layer(kp, vp, k[:, b_dec:], v[:, b_dec:], _table_row(tables, slot), off0,
                           gather=False)
        if b_dec:
            paged_update_layer(kp, vp, k[0, :b_dec, None], v[0, :b_dec, None], tables, offsets,
                               write_mask=live, gather=False)
        return (("pool", kp, tables), ("pool", vp, tables), (kp, vp),
                ("grouped", offsets, slot, off0, b_dec, *past_kv[9:]))
    if tag == "paged":
        _, kp, vp, tables, offset = past_kv[:5]
        write_mask = past_kv[5] if len(past_kv) > 5 else None
        max_live = past_kv[6] if len(past_kv) > 6 else None
        s = k.shape[1]
        if s == 1:
            # decode step: attention reads the pool itself through the tables
            kp, vp, _, _ = paged_update_layer(kp, vp, k, v, tables, offset,
                                              write_mask=write_mask, gather=False)
            return (("pool", kp, tables), ("pool", vp, tables), (kp, vp),
                    _rows(offset, max_live))
        if tables.shape[0] == 1:
            # one slot's prefill chunk: gather only the blocks its queries can
            # see (up to the host bound, a device offset's max_live)
            seen = _chunk_bound(offset, s, max_live)
            kp, vp, _, _ = paged_update_layer(kp, vp, k, v, tables, offset,
                                              write_mask=write_mask, gather=False)
            return (gather_prefix(kp, tables[0], seen), gather_prefix(vp, tables[0], seen),
                    (kp, vp), _rows(offset, seen))
        # several rows' chunks over their full gathered views: no engine path
        # sends this (prefills go one slot at a time, admissions are "fresh")
        raise NotImplementedError(
            "a paged prefill takes one slot (one table row); batched admissions use the "
            "fresh_paged form")
    cache_k, cache_v, offset = past_kv[:3]
    write_mask = past_kv[3] if len(past_kv) > 3 else None
    max_live = past_kv[4] if len(past_kv) > 4 else None
    k, v = update_kv_cache(cache_k, cache_v, k, v, offset, write_mask=write_mask)
    return k, v, (k, v), _rows(offset, max_live)


def _rows(offset, max_live):
    """Per-row offsets with their host-side bound, for ``sdpa``."""
    return offset if max_live is None else ("rows", offset, max_live)


def _chunk_bound(off0, c: int, max_live) -> int:
    """The host-side bound on off0 + c that a chunk's kernels plan from:
    ``max_live`` (required for a device offset), never below off0 + c for a
    host one."""
    if isinstance(off0, torch.Tensor):
        if max_live is None:
            raise ValueError("a chunk at a device offset needs its host-side bound (max_live)")
        return int(max_live)
    return max(int(off0) + c, int(max_live or 0))


def _slot_write(cache, new, slot, off0) -> None:
    """new (C, Hkv, D) into cache[slot, off0:off0 + C], in place, encoded in
    the cache's dtype through its stored view; slot and off0 host ints, or
    1-element tensors on the device (an indexed write: no host read). The
    caller keeps off0 + C within the cache."""
    new = kv_dtype.encode(new, cache.dtype)
    view = kv_dtype.stored(cache)
    if not isinstance(slot, torch.Tensor) and not isinstance(off0, torch.Tensor):
        view[slot, off0:off0 + new.shape[0]] = new
        return
    dev = cache.device
    pos = torch.as_tensor(off0, device=dev).reshape(-1).long() + torch.arange(new.shape[0],
                                                                             device=dev)
    view.index_put_((torch.as_tensor(slot, device=dev).reshape(-1).long(), pos), new)


def _table_row(tables, slot):
    """Slot ``slot``'s block-table row, (1, MB): a host int slices, a device
    slot selects on the device."""
    if isinstance(slot, torch.Tensor):
        return tables.index_select(0, slot.reshape(-1))
    return tables[slot:slot + 1]


def _is_fold(past_kv) -> bool:
    # the type test comes first: a cache tensor compared with a string goes
    # through the tensor's slow __eq__, on every layer of every decode step
    return past_kv is not None and isinstance(past_kv[0], str) and past_kv[0] == "fold"


def attention_block(past_kv, q, k, v, mask, scale=None):
    """Cache write, then attention over the cache (the classic form):
    returns (attn_out, present). Without a cache, and for a fresh batched
    admission, the forward is causal over the new tokens.

    The fold form ("fold", ck, cv, offset[, write_mask[, max_live]]) with one
    query token and one new k/v runs the fold kernel over the STALE cache
    (slots below the offset, the current k/v folded in from registers, no
    write), then writes the row under the mask: the TPU package's sequence
    (``models/common.py:247-265``). A row whose mask is false still attends
    its own current k/v, which the classic form does not. Any other shape
    takes the dense form."""
    if _is_fold(past_kv) and q.shape[1] == 1 and k.shape[1] == 1:
        ck, cv, offset = past_kv[1:4]
        write_mask = past_kv[4] if len(past_kv) > 4 else None
        max_live = past_kv[5] if len(past_kv) > 5 else None
        sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
        out, _, _ = fused_decode_attention(q, ck, cv, k, v, offset, sc, write=False,
                                           max_live=max_live)
        ck, cv = update_kv_cache(ck, cv, k, v, offset, write_mask=write_mask)
        return out, (ck, cv)
    k_eff, v_eff, present, off = apply_kv_cache(past_kv, k, v)
    out = sdpa(q, k_eff, v_eff, mask, scale, decode_offset=off, causal=off is None)
    return out, present


def _grouped_attention(q, k, v, sc, offsets, slot, off0, b_dec, max_live=None):
    """The token-fused serving step (see apply_kv_cache "grouped"): the flat
    token rows split into the per-slot decode group and the one-slot chunk
    group, each attending its own view of the updated cache (b_dec = 0: the
    chunk alone). k/v are dense (B, S, Hkv, D) caches or ("pool", pool,
    tables) markers. The chunk runs kernel 4 at ``off0`` under the bound
    ``max_live``: over a dense cache on the slot's row of the whole cache (no
    copy, read in its stored dtype), over a pool on the blocks of the bound
    gathered through the slot's table row and cast to q's dtype (the TPU
    package's astype of that view, ``models/common.py:355-359``)."""
    q_chunk = q[:, b_dec:]                           # (1, C, H, D)
    bound = _chunk_bound(off0, q_chunk.shape[1], max_live)
    rows = slot.reshape(1) if isinstance(slot, torch.Tensor) else None
    if isinstance(k, tuple):
        from ..runtime.paged import gather_prefix
        (_, kp, tables), (_, vp, _) = k, v
        row = _table_row(tables, slot)[0]
        out_chunk = flash_prefill_blocked(q_chunk, gather_prefix(kp, row, bound).to(q.dtype),
                                          gather_prefix(vp, row, bound).to(q.dtype), off0, sc,
                                          bound)
        if b_dec:
            out_dec = pool_decode_attention(q[0, :b_dec, None], kp, vp, tables, offsets, sc,
                                            max_live)
    else:
        kc, vc = (k, v) if rows is not None else (k[slot:slot + 1], v[slot:slot + 1])
        out_chunk = flash_prefill_blocked(q_chunk, kc, vc, off0, sc, bound, rows)
        if b_dec:
            out_dec = decode_attention(q[0, :b_dec, None], k, v, offsets, sc, max_live)
    if not b_dec:
        return out_chunk
    return torch.cat([out_dec[:, 0][None], out_chunk], dim=1)


def sdpa(q, k, v, mask=None, scale: float | None = None, decode_offset=None,
         causal: bool = False):
    """Scaled dot-product attention with fp32 softmax.

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), H a multiple of Hkv, or
    ("pool", pool (NB, BS, Hkv, D), tables (B, MB)) markers of a paged decode
    step. mask: additive (Sq, Skv) or (B, 1, Sq, Skv). decode_offset DECLARES
    that the mask is exactly the causal-at-offset predicate: with Sq == 1 it
    goes to the decode-attention kernel (over a pool: the pool kernel), with
    Sq > 1 and one offset for every row to the blocked prefill kernel
    (gptq_for_llama_tpu/models/common.py:341-447): a host int, or a
    1-element tensor read on the device with its host-side bound on
    offset + Sq. It is an int, a tensor, ("rows", offsets, max_live) (offsets
    with a host-side bound on the live length) or the ("grouped", ...) marker
    of the token-fused serving step. causal DECLARES that the mask is plain
    causal self-attention: the causal prefill kernel takes every Sq (the TPU
    package's Sq > 256 and VMEM gates exist only for its kernel). The kernels
    ignore ``mask``. On a CPU tensor each path takes its plain version; a
    CUDA tensor with any other mask raises, since no kernel applies an
    arbitrary mask (so does a device offset for a chunk of queries without
    its bound, or with one offset per row)."""
    sq, d = q.shape[1], q.shape[3]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    max_live = None
    if isinstance(decode_offset, tuple):
        if decode_offset[0] == "grouped":
            return _grouped_attention(q, k, v, sc, *decode_offset[1:])
        _, decode_offset, max_live = decode_offset
    if isinstance(k, tuple):
        (_, kp, tables), (_, vp, _) = k, v
        if sq != 1 or decode_offset is None:
            raise ValueError("a block pool is attended one decode token per row at its offset")
        return pool_decode_attention(q, kp, vp, tables, decode_offset, sc, max_live)
    if decode_offset is not None:
        if sq == 1:
            return decode_attention(q, k, v, decode_offset, sc, max_live)
        if not isinstance(decode_offset, torch.Tensor):
            return flash_prefill_blocked(q, k, v, decode_offset, sc, max_live)
        if decode_offset.numel() == 1 and (max_live is not None or not q.is_cuda):
            return flash_prefill_blocked(q, k, v, decode_offset, sc, max_live)
        if mask is None:
            mask = decode_mask(sq, k.shape[1], decode_offset)
    elif causal:
        return flash_prefill(q, k, v, sc)
    if q.is_cuda:
        raise NotImplementedError(
            "attention on the card runs only through its kernels: a cache offset "
            "(decode_offset; a host int for a chunk of queries) or causal self-attention "
            "(causal=True); no kernel takes an arbitrary mask")
    return attention_plain(q, k, v, sc, mask)


def row_parallel_apply(lin, x, tp_ctx):
    """Apply a row-parallel (input-split) linear under tensor parallelism
    (``gptq_for_llama_tpu/models/common.py:466-500``).

    tp_ctx: None (no TP: a plain apply) or this rank's ``parallel.Mesh``.
    The activation x arrives split on its last dim (attention heads, ffn
    width) and ``lin`` holds this rank's rows of a weight split on
    in-features; the partial products are all-reduced over the tp group and
    the (replicated) bias is added once afterwards.

    Act-order / K-padded packed weights carry a device-row index map in
    ``perm`` (``parallel/tp_model.prepare_tp_params``): the activation is
    all-gathered and each rank takes its own device rows."""
    if tp_ctx is None:
        return linear_apply(lin, x)
    if isinstance(lin, PackedLinear):
        local = lin
        if lin.perm is not None:
            x = tp_ctx.all_gather(x, dim=-1).index_select(-1, lin.perm)
            local = dataclasses.replace(lin, perm=None, perm_sig=None)
        bias = lin.bias
        if bias is not None:
            local = dataclasses.replace(local, bias=None)
        y = tp_ctx.all_reduce(linear_apply(local, x))
        return y if bias is None else y + bias
    bias = lin.get("bias")
    y = tp_ctx.all_reduce(torch.matmul(x, lin["kernel"].to(x.dtype)))
    return y if bias is None else y + bias.to(y.dtype)


def gather_vocab(logits, tp_ctx):
    """The full-vocabulary logits of a vocab-split head: this rank's columns
    all-gathered over the tp group (the TPU package's out_specs over the tp
    axis). Without tp_ctx the logits as they are."""
    return logits if tp_ctx is None else tp_ctx.all_gather(logits, dim=-1)


def activation(name: str):
    """The MLP activation of a config's ``act`` (HF ACT2FN names): "gelu" is
    the exact erf GELU, "gelu_new" / "gelu_fast" the tanh form (up to 4e-4
    apart; ``gptq_for_llama_tpu/models/common.py:503-508``)."""
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="none"),
            "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_fast": lambda x: F.gelu(x, approximate="tanh")}[name]


def layer_norm_of(p, x, eps: float):
    """``layer_norm`` of x with a {"w", "b"} parameter dict (OPT, GPT-NeoX, GPT-2)."""
    return layer_norm(x, p["w"], p["b"], eps)


class DenseDraws:
    """The draws of a LayerNorm family's ``init_params``: drawn in fp32 from
    ``generator`` (a CPU torch.Generator), then moved to ``device`` in
    ``dtype``; (in, out) kernels at in ** -0.5 with zero biases, unit
    LayerNorms of width ``hidden``."""

    def __init__(self, generator: torch.Generator, dtype, device, hidden: int):
        self.gen, self.dtype, self.device, self.hidden = generator, dtype, device, hidden

    def randn(self, *shape, std=1.0):
        return self.to(torch.randn(*shape, generator=self.gen, dtype=torch.float32) * std)

    def to(self, t):
        return t.to(device=self.device, dtype=self.dtype)

    def lin(self, i: int, o: int, bias: bool = True):
        return dense(self.randn(i, o, std=i ** -0.5),
                     self.to(torch.zeros(o)) if bias else None)

    def ln(self):
        return {"w": self.to(torch.ones(self.hidden)), "b": self.to(torch.zeros(self.hidden))}


def head_of(head_input, logits, params, cfg, x, delta=None):
    """An arch's ``head``: its ``logits`` over its ``head_input``."""
    return logits(params, cfg, head_input(params, cfg, x, delta))


def causal_forward(embed, stack, head, params, cfg, input_ids: torch.Tensor, positions=None,
                   tp_ctx=None):
    """An arch's full-model causal forward without a cache, through its
    ``embed``, ``stack`` and ``head``: (B, S) -> (B, S, V) logits. Under
    tensor parallelism (``tp_ctx``, with this rank's shards and local cfg)
    the vocab-split logits are gathered."""
    s, dev = input_ids.shape[1], input_ids.device
    if positions is None:
        positions = torch.arange(s, device=dev)[None, :]
    x, delta = stack(params, cfg, embed(params, cfg, input_ids, positions), positions,
                     causal_mask(s, s, device=dev),
                     **({} if tp_ctx is None else {"tp_ctx": tp_ctx}))
    return gather_vocab(head(params, cfg, x, delta), tp_ctx)


def stack_layers(layer, params, cfg, x, positions, mask, past=None, rope=None, tp_ctx=None):
    """Every layer over x through the arch's ``layer``; past(li): layer li's
    cache form (None: no cache); tp_ctx: this rank's mesh under tensor
    parallelism. Returns (x, None): the stack of OPT, GPT-NeoX and GPT-2
    leaves no residual add pending (LLaMA's folds its adds into the next
    RMSNorm launch, ``llama.stack``)."""
    for li, lp in enumerate(params["layers"]):
        x, _, _ = layer(cfg, lp, x, positions, mask, None if past is None else past(li),
                        rope=rope, tp_ctx=tp_ctx)
    return x, None


def check_max_len(name: str, limit: int, n: int) -> None:
    """Refuse ``n`` positions past a learned table of ``limit`` (OPT, GPT-2):
    a real token there would read a clamped row and decode a wrong but
    plausible answer (the TPU package gives NaN; ROADMAP C)."""
    if n > limit:
        raise ValueError(f"{n} positions do not fit the {name} model's learned position "
                         f"table of {limit}")


def learned_positions(table, positions):
    """Rows of a learned position table at ``positions`` (a device tensor),
    clamped into the table: a pad row of a right-padded prefill or of a
    serving bucket may sit past it. JAX's ``jnp.take`` returns NaN there
    (its "fill" mode) and a torch gather on the card would raise a device
    assert, so the port reads the last row instead. Real rows never sit past
    the table: the runner, the engine and ``embed`` refuse a length past it
    (``check_max_len``), and a pad row's output is never read (ROADMAP C)."""
    return table[positions.clamp(0, table.shape[0] - 1)]
