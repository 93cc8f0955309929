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
exact in bf16 (e4m3 codes 0x7F / 0xFF read as +-480). A cache other than bf16
runs the ``mma.sync`` body at every length (``plan_kv``); the plain version
reads the cache through ``kv_dtype.decode`` into q's dtype, the same rule.
The kernel takes the head dims of ``attention.HEAD_DIMS``, one library each,
and over a bf16 cache both bodies at each of them (``flash_prefill.plan``);
it counts its launches by cache dtype, by head dim, and by body and head dim
(``wgmma:d256``).
"""

from __future__ import annotations

import ctypes

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


def plan_kv(sq: int, q_offset: int, dtype: torch.dtype, d: int = 128) -> str:
    """The body kernel 4 launches over a cache of ``dtype`` at head dim
    ``d``: kernel 5's plan (``flash_prefill.plan``: the ``mma.sync`` body
    for short prefixes, ``SYNC_MAX_KEYS[d]``, and the ``wgmma`` body above)
    for bf16, the ``mma.sync`` body at every length for fp8 and f32 caches
    (the ``wgmma`` body's TMA tiles take bf16 only)."""
    return plan(sq, q_offset, d) if dtype == torch.bfloat16 else "sync"


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
    measurement may force one; the ``wgmma`` body takes a bf16 cache only);
    ``q_offset`` a host int or the offset tensor."""
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
# launches by cache dtype, by head dim, and by body and head dim
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
