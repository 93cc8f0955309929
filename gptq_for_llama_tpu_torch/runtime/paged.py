"""Paged KV cache: block-table memory management for continuous batching.

Counterpart of ``gptq_for_llama_tpu/runtime/paged.py``. Sequences share one
physical block pool per layer, (num_blocks, block_size, Hkv, D); each slot
owns a block table mapping logical block -> physical block, so memory scales
with the tokens actually held, not with slots * max_len. The allocator is
host code. Unlike the functional TPU version the pools are updated IN PLACE
and returned (as ``models.common.update_kv_cache`` does): every write is one
``index_put`` per pool, with no per-row Python loop. A pool is stored in the
KV dtype (bf16, f32 or fp8: ``ops/kv_dtype.py``) and written through its
encoder and stored view, as the dense cache is. Decode attention reads
the pool through the table inside its kernel
(``ops.cuda.attention.pool_decode_attention``); only a prefill chunk gathers
its one slot's logical view.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops import kv_dtype
from ..ops.cuda.attention import pool_decode_attention


@dataclasses.dataclass
class BlockAllocator:
    """Host-side free-list over the physical block pool.

    ``reserved`` low block indices are never handed out: the serving engine
    keeps block 0 as a scratch block, so the 0 filler in unowned block-table
    entries aliases no slot's cache (overshoot writes of a decode span land
    there harmlessly instead of corrupting a neighbour)."""

    num_blocks: int
    reserved: int = 0

    def __post_init__(self):
        self.free = list(range(self.num_blocks - 1, self.reserved - 1, -1))
        self.owned: dict[int, list[int]] = {}

    def alloc(self, slot: int, n: int) -> list[int]:
        if len(self.free) < n:
            raise MemoryError(f"paged KV pool exhausted: need {n}, "
                              f"have {len(self.free)} free blocks")
        blocks = [self.free.pop() for _ in range(n)]
        self.owned.setdefault(slot, []).extend(blocks)
        return blocks

    def release(self, slot: int):
        self.free.extend(reversed(self.owned.pop(slot, [])))

    def ensure_capacity(self, slot: int, tokens: int, block_size: int) -> list[int]:
        """Grow the slot's table so ``tokens`` positions fit; returns the new blocks."""
        have = len(self.owned.get(slot, []))
        need = -(-tokens // block_size) - have
        return self.alloc(slot, need) if need > 0 else []


class PagedKV:
    """Device pool (all layers stacked) + per-slot block tables, padded to
    the most blocks a slot can hold."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int, num_kv_heads: int,
                 head_dim: int, slots: int, max_len: int, dtype=torch.bfloat16, device=None):
        device = resolve_device(device)   # the card unless the caller asks for the CPU
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        # physical block per (slot, logical block); 0 is a valid block, unused
        # entries are masked by the offset so any filler value is safe
        self.tables = np.zeros((slots, self.max_blocks), np.int32)
        self.alloc = BlockAllocator(num_blocks)

    def tables_device(self) -> torch.Tensor:
        return torch.as_tensor(self.tables, device=self.k.device)


def _row_offsets(offset, b: int, device) -> torch.Tensor:
    return torch.as_tensor(offset, device=device).reshape(-1).expand(b).long()


def paged_write(k_pool, v_pool, k_new, v_new, tables, offsets):
    """Write one token per slot into every layer's pool, in place.

    k_pool/v_pool: (L, NB, BS, H, D); k_new/v_new: (L, B, 1, H, D); tables:
    (B, max_blocks) int32; offsets: (B,) (the position being written).
    Returns the pools."""
    bs = k_pool.shape[2]
    offs = _row_offsets(offsets, tables.shape[0], k_pool.device)
    phys = tables.long().gather(1, (offs // bs)[:, None])[:, 0]
    kv_dtype.stored(k_pool)[:, phys, offs % bs] = kv_dtype.encode(k_new[:, :, 0], k_pool.dtype)
    kv_dtype.stored(v_pool)[:, phys, offs % bs] = kv_dtype.encode(v_new[:, :, 0], v_pool.dtype)
    return k_pool, v_pool


def paged_gather(pool_layer, table):
    """(NB, BS, H, D) pool layer + (max_blocks,) table -> (max_blocks * BS, H, D):
    one slot's contiguous logical KV."""
    blocks = pool_layer[table.long()]
    mb, bs, h, d = blocks.shape
    return blocks.reshape(mb * bs, h, d)


def paged_update_layer(kp, vp, k_new, v_new, tables, offset, write_mask=None, gather=True):
    """One layer's paged-cache update (in place) + logical gather.

    kp/vp: (NB, BS, Hkv, D), this layer's pool; k_new/v_new (B, s, H, D);
    tables (B, MB); offset an int or a (B,) or 1-element tensor: the first
    position being written. s == 1 is the decode write; s > 1 is a prefill
    write and needs block-aligned offsets (it writes whole blocks, zero-padded
    past s: those positions are masked until the real token overwrites them
    before its first read). A host offset whose blocks run past the table
    raises; a device offset is not read on the host (a CUDA graph replays
    this write at any offset), so its block columns are clamped to the last
    one and the CALLER checks on the host that the write fits: the serving
    engine does before every chunk (``ServingEngine._check_fits``).
    Returns (kp, vp, k_eff, v_eff): the gathered logical
    (B, MB * BS, H, D) views, or (None, None) with gather=False.
    write_mask: optional (B,) bool. With s == 1 rows with False keep their
    pool contents; with s > 1 they are redirected to the reserved scratch
    block 0 (batched admission; the pool must carry that block)."""
    b, s, h, d = k_new.shape
    bs, mb = kp.shape[1], tables.shape[1]
    pools = kp, vp
    kp, vp = kv_dtype.stored(kp), kv_dtype.stored(vp)   # written as stored
    k_new = kv_dtype.encode(k_new, pools[0].dtype)
    v_new = kv_dtype.encode(v_new, pools[1].dtype)
    host = not isinstance(offset, torch.Tensor)   # one host int for every row: no device math
    tab = tables.long()

    if s == 1:
        if host:
            phys, off_in = tab[:, int(offset) // bs], int(offset) % bs
        else:
            offv = _row_offsets(offset, b, kp.device)
            phys, off_in = tab.gather(1, (offv // bs)[:, None])[:, 0], offv % bs
        k_row, v_row = k_new[:, 0], v_new[:, 0]
        if write_mask is not None:
            m = write_mask.to(kp.device)[:, None, None]
            k_row = torch.where(m, k_row, kp[phys, off_in])
            v_row = torch.where(m, v_row, vp[phys, off_in])
        kp[phys, off_in] = k_row
        vp[phys, off_in] = v_row
    else:
        nblk = -(-s // bs)
        pad = nblk * bs - s
        if pad:
            k_new = torch.nn.functional.pad(k_new, (0, 0, 0, 0, 0, pad))
            v_new = torch.nn.functional.pad(v_new, (0, 0, 0, 0, 0, pad))
        if host:
            base = int(offset) // bs
            phys = tab[:, base:base + nblk]
            if phys.shape[1] != nblk:
                raise ValueError(f"prefill of {s} tokens at {offset} does not fit a table of "
                                 f"{mb} blocks of {bs}")
        else:
            offv = _row_offsets(offset, b, kp.device)
            cols = (offv // bs)[:, None] + torch.arange(nblk, device=kp.device)
            phys = tab.gather(1, cols.clamp(max=mb - 1))
        if write_mask is not None:
            phys = torch.where(write_mask.to(kp.device)[:, None], phys, 0)
        kp[phys] = k_new.reshape(b, nblk, bs, h, d)
        vp[phys] = v_new.reshape(b, nblk, bs, h, d)

    kp, vp = pools
    if not gather:
        return kp, vp, None, None
    return kp, vp, kp[tab].reshape(b, mb * bs, h, d), vp[tab].reshape(b, mb * bs, h, d)


def gather_prefix(pool_layer, table_row, tokens: int):
    """The first ``tokens`` logical slots of one slot, rounded up to whole
    blocks: (1, ceil(tokens / BS) * BS, H, D). ``table_row`` (MB,) is the
    slot's table row on the device (selected there for a device slot), and
    ``tokens`` the host bound of the chunk's last query position (offset + C
    or above): what a prefill chunk attends, no block past the bound copied."""
    bs = pool_layer.shape[1]
    blocks = pool_layer[table_row[:-(-tokens // bs)].long()]
    return blocks.reshape(1, -1, *blocks.shape[2:])


def paged_decode_attention(q, k_pool_layer, v_pool_layer, tables, offsets, scale: float):
    """Single-token attention over the paged cache (one layer).

    q: (B, 1, H, D); pools: (NB, BS, Hkv, D); tables (B, MB); offsets (B,).
    The token's k/v must already be written at ``offsets``. Returns
    (B, 1, H, D): the pool kernel on the card, its plain version on the CPU."""
    return pool_decode_attention(q, k_pool_layer, v_pool_layer, tables, offsets, scale)
