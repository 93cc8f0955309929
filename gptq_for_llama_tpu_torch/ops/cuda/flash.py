"""Kernel 4, blocked prefill attention: dispatch, CUDA wrapper, launch count
and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/flash.py:_flash_blocked_kernel``
(entry ``flash_prefill_blocked``): SQ queries at absolute positions
``q_offset + i`` attend cache slots ``j <= q_offset + i``. As the TPU kernel
takes ``q_offset`` by scalar prefetch, the kernel reads it from a 1-element
int32 tensor on the card, so a CUDA graph captured over one launch replays at
any offset; a host int passed here becomes such a tensor. ``bound``, a host
int no smaller than offset + SQ, is all the launch plan reads:
``flash_prefill.plan`` picks one of kernel 5's two bodies from it
(``csrc/flash_prefill_blocked.cu``). ``rows`` (optional, (B,) int32 on the
card) names the cache row each query batch row attends, so a serving chunk
attends its slot of the whole cache, with no copy. It takes any SQ, SKV and
offset (the TPU kernel needs SQ % 128 == 0). The plain version is the masked
softmax of ``attention.attention_plain`` in fp32 and takes the same
arguments.

The cache may be stored in bf16, f32, fp8-e4m3 or fp8-e5m2
(``ops/kv_dtype.py``). The kernel reads it in that type and rounds K and V to
bf16, its operand type, as the TPU kernel's ``_load_bf16`` does: an f32 cache
is rounded before q k^T (kernels 3, 7 and 9 keep it in f32), an fp8 code is
exact in bf16 (e4m3 codes 0x7F / 0xFF read as +-480). The plain version reads
the cache through ``kv_dtype.decode`` into q's dtype, the same rule. The
kernel takes the head dims of ``attention.HEAD_DIMS``, one library each, and
both bodies at each of them over a bf16 cache, and at ``WGMMA_KV_HEAD_DIMS``
(64, 80, 96, 128) over the other dtypes, under the same plan
(``plan_kv``: bf16's crossover, but for f32 at D = 80 and 96,
``SYNC_ONLY_KV``, which keeps the ``mma.sync`` body): there the ``wgmma`` body's producer warpgroup
converts TMA staging chunks of the stored tiles into its bf16 stages
(``wgmma_layout``), so its output equals its output over the cache decoded to
bf16, bit for bit. At D = 256 such a cache takes the ``mma.sync`` body at
every length (``plan_kv``: no shared memory left for a staging ring), and the
``wgmma`` body forced there raises. It counts its launches by cache dtype, by
head dim, by body and head dim (``wgmma:d256``) and by body and cache dtype
(``wgmma:fp8``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kv_dtype
from . import build
from .attention import attention_plain, check_caches, check_head_dim, count_forms, new_forms
from .flash_prefill import PATH_IDS, plan
from .grad import refuse_grad
from .matmul import check_tensor

SOURCE = "gptq_for_llama_tpu_torch/csrc/flash_prefill_blocked.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/flash.py:85"


def flash_prefill_blocked_plain(q, k, v, q_offset, scale: float, bound=None,
                                rows=None) -> torch.Tensor:
    """q (B, SQ, H, D), k/v (Bkv, SKV, Hkv, D): query i attends slots
    j <= q_offset + i of cache row ``rows[b]`` (row b without ``rows``),
    softmax in fp32. A cache of another dtype than q's is read into q's dtype
    through ``kv_dtype.decode`` (the kernel's bf16 operands: ``_load_bf16``).
    ``q_offset``: a host int or a 1-element tensor (read where it lies: no
    host copy); ``bound`` is the kernel's plan bound, which changes nothing
    here. Returns (B, SQ, H, D) in q's dtype."""
    if rows is not None:
        k, v = k.index_select(0, rows.long()), v.index_select(0, rows.long())
    if k.dtype != q.dtype:
        k, v = kv_dtype.decode(k, q.dtype), kv_dtype.decode(v, q.dtype)
    sq, skv = q.shape[1], k.shape[1]
    off = q_offset.reshape(()).long() if isinstance(q_offset, torch.Tensor) else int(q_offset)
    allowed = (torch.arange(skv, device=q.device)[None, :]
               <= torch.arange(sq, device=q.device)[:, None] + off)
    return attention_plain(q, k, v, scale, allowed)


def _entry(d: int):
    fn = build.library("flash_prefill_blocked", d).gptq_flash_prefill_blocked
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 7 + [p, p, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def library_layout(d: int, dtype: torch.dtype) -> Layout | None:
    """The wgmma body's layout as the built library at head dim ``d``
    reports it for ``dtype`` (the card's build; None where the body does not
    take the dtype)."""
    lib = build.library("flash_prefill_blocked", d)
    out = (ctypes.c_int * 5)()
    build.check(lib, lib.gptq_flash_wgmma_layout(kv_dtype.KV_CODES[dtype], out),
                "gptq_flash_wgmma_layout")
    return Layout(*out) if out[4] else None


def _device_offset(q_offset, bound, sq: int, device) -> tuple[torch.Tensor, int]:
    """The offset as the kernel reads it, a 1-element int32 tensor on the
    card, and the plan bound. A host int becomes such a tensor (a fill, no
    host copy) and bounds itself (offset + SQ); a tensor must come with its
    host ``bound``, since nothing on the host may read it."""
    if isinstance(q_offset, torch.Tensor):
        if bound is None:
            raise ValueError("a device offset needs its host-side bound (>= offset + SQ)")
        if q_offset.device != device or q_offset.dtype != torch.int32 or q_offset.numel() != 1:
            raise ValueError(f"the offset must be one int32 on {device}, got "
                             f"{q_offset.dtype} {tuple(q_offset.shape)} on {q_offset.device}")
        off_t = q_offset.reshape(1)
    else:
        off = int(q_offset)
        if off < 0 or (bound is not None and bound < off + sq):
            raise ValueError(f"offset {off} must be >= 0 and bound {bound} >= offset + {sq}")
        bound = off + sq if bound is None else bound
        off_t = torch.full((1,), off, dtype=torch.int32, device=device)
    if int(bound) < sq:
        raise ValueError(f"bound {bound} is below the {sq} queries of the chunk")
    return off_t, int(bound)


# The head dims at which the wgmma body takes a cache of another dtype than
# bf16 (csrc/flash_common.cuh: wgmma_kv_dim)
WGMMA_KV_HEAD_DIMS = (64, 80, 96, 128)
SMEM_LIMIT = 232448   # dynamic shared memory a block may have (H100)
SLOT_BYTES, MAX_SLOTS = 16384, 4   # a staging slot at most, and the slots


class Layout(NamedTuple):
    """The wgmma body's shared memory over one cache dtype at one head dim
    (``csrc/flash_common.cuh``: ``WgmmaDims``): K and V stages, keys of a
    staging chunk, staging slots, staging bytes, dynamic shared memory."""
    stages: int
    chunk_keys: int
    slots: int
    staging_bytes: int
    smem: int


def wgmma_layout(d: int, dtype: torch.dtype) -> Layout | None:
    """A mirror of the wgmma body's layout at head dim ``d`` over a cache of
    ``dtype`` (None where the body does not take it). Q is a 128-row tile, K
    and V tiles hold 128 keys (80 at D = 256), all bf16 in sub-tiles of the
    widest swizzle (64, 32 or 16 dims). Over another dtype than bf16 a ring of
    up to 4 staging slots, each a chunk of a tile in the stored type (the most
    keys, halving, whose rows fit 16 KB), takes the room of a third bf16 stage
    where there is no other. 1 + 4 stages (+ 2 a slot, counted at 4 slots)
    mbarriers in 128-byte steps and 1 KB of alignment complete the block; the
    library's ``gptq_flash_wgmma_layout`` reports the same."""
    if dtype != torch.bfloat16 and d not in WGMMA_KV_HEAD_DIMS:
        return None
    box = 64 if d % 64 == 0 else 32 if d % 32 == 0 else 16
    keys = 80 if d == 256 else 128
    tile_q, tile_kv = 128 * (d // box) * 2 * box, keys * (d // box) * 2 * box
    staged = dtype != torch.bfloat16
    row = d * dtype.itemsize
    chunk = keys
    while chunk * row > SLOT_BYTES and chunk % 2 == 0 and chunk > 8:
        chunk //= 2
    slot, max_slots = chunk * row, MAX_SLOTS if staged else 0

    def bars(stages):
        return ((1 + 4 * stages + 2 * max_slots) * 8 + 127) // 128 * 128

    def room(stages):
        return SMEM_LIMIT - 1024 - bars(stages) - tile_q - 2 * stages * tile_kv

    stages = 2 if d == 256 else 3 if not staged or room(3) >= 2 * slot else 2
    slots = min(max_slots, room(stages) // slot) if staged else 0
    return Layout(stages, chunk if staged else 0, slots, slots * slot,
                  tile_q + 2 * stages * tile_kv + slots * slot + bars(stages) + 1024)


# Over f32 at D = 80 and 96 the wgmma body's producer warpgroup converts
# 32-key chunks of 320 / 384-byte rows more slowly than the consumers take
# them, and the mma.sync body won at every chunk measured, up to SQ = 100 at
# offset 1900 (70.73 against 82.86 us at D = 80, 78.01 against 86.43 at 96;
# NVIDIA H100 80GB HBM3, 700 W; scripts/torch_flash_bodies.py --kv f32), so
# kernel 4 keeps it there at every length. fp8 caches, and f32 at D = 64 and
# 128, cross where bf16 does (within the run-to-run spread at 256 keys).
SYNC_ONLY_KV = {(torch.float32, 80), (torch.float32, 96)}


def plan_kv(sq: int, q_offset: int, dtype: torch.dtype, d: int = 128) -> str:
    """The body kernel 4 launches over a cache of ``dtype`` at head dim
    ``d``: kernel 5's plan ``flash_prefill.plan`` (the ``mma.sync`` body up
    to ``flash_prefill.SYNC_MAX_KEYS[d]`` keys of offset + SQ, the ``wgmma`` body above),
    but the ``mma.sync`` body at every length over fp8 and f32 caches at D =
    256 (not in ``WGMMA_KV_HEAD_DIMS``) and over the ``SYNC_ONLY_KV`` pairs."""
    if dtype != torch.bfloat16 and (d not in WGMMA_KV_HEAD_DIMS or (dtype, d) in SYNC_ONLY_KV):
        return "sync"
    return plan(sq, q_offset, d)


def flash_prefill_blocked_cuda(q, k, v, q_offset, scale: float, bound=None,
                               rows=None) -> torch.Tensor:
    """The kernel: q (B, SQ, H, D) bf16, k/v (Bkv, SKV, Hkv, D) in one
    of the four cache dtypes (Bkv = B without ``rows``), D one of
    ``attention.HEAD_DIMS``, the offset a host int
    or a 1-element int32 tensor on the card (then with its host ``bound``),
    ``rows`` a (B,) int32 tensor on the card."""
    b, sq, h, d = q.shape
    bkv, skv, hkv = k.shape[0], k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"blocked prefill kernel takes H % Hkv == 0; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    check_head_dim("blocked prefill kernel", d)
    off_t, bound = _device_offset(q_offset, bound, sq, q.device)
    refuse_grad("flash_prefill_blocked", q, k, v)
    check_tensor(q, "q", torch.bfloat16)
    check_caches(k, v, (bkv, skv, hkv, d))
    if rows is None:
        if bkv != b:
            raise ValueError(f"{b} query rows over a cache of {bkv} rows need ``rows``")
    else:
        check_tensor(rows, "rows", torch.int32, (b,))
    if sq == 0:
        return torch.empty_like(q)
    return _launch(q, k, v, off_t, scale, plan_kv(sq, bound - sq, k.dtype, d), rows)


def _launch(q, k, v, q_offset, scale: float, path: str, rows=None) -> torch.Tensor:
    """One launch of kernel 4 on checked operands through body ``path`` (a
    measurement may force one; the ``wgmma`` body takes fp8 and f32 caches at
    ``WGMMA_KV_HEAD_DIMS`` only, and raises elsewhere); ``q_offset`` a host
    int or the offset tensor."""
    b, sq, h, d = q.shape
    if not isinstance(q_offset, torch.Tensor):
        q_offset = torch.full((1,), int(q_offset), dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    err = _entry(d)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, sq, k.shape[0], k.shape[1], h, k.shape[2], d, q_offset.data_ptr(),
                   None if rows is None else rows.data_ptr(), float(scale), PATH_IDS[path],
                   kv_dtype.KV_CODES[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("flash_prefill_blocked", d), err,
                f"flash_prefill_blocked ({path})")
    flash_prefill_blocked_cuda.launches += 1
    count_forms(flash_prefill_blocked_cuda, k.dtype, d, path)
    return out


flash_prefill_blocked_cuda.launches = 0
# launches by cache dtype, by head dim, by body and head dim, and by body and
# cache dtype
flash_prefill_blocked_cuda.forms = new_forms(bodies=tuple(PATH_IDS))


def flash_prefill_blocked(q, k, v, q_offset, scale: float, bound=None,
                          rows=None) -> torch.Tensor:
    """Cached prefill attention: the kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``q_offset`` a host int or a 1-element tensor
    (on the card with its host ``bound`` >= offset + SQ); ``rows``: the cache
    row of each query batch row."""
    if q.is_cuda:
        return flash_prefill_blocked_cuda(q, k, v, q_offset, scale, bound, rows)
    return flash_prefill_blocked_plain(q, k, v, q_offset, scale, bound, rows)
