"""Kernels 3, 7 and 9, decode attention over a dense cache, over a paged block
pool, and in the fold form: dispatch, CUDA wrappers, launch counts, launch
plans and plain versions.

Kernel 3 replaces ``gptq_for_llama_tpu/ops/pallas/attention.py:_attn_kernel``
and ``:_attn_kernel_gqa`` (entry ``decode_attention``), kernel 9
``:_fused_attn_kernel`` (entry ``fused_decode_attention``): attention over the
stale prefix (slots below the offset) plus the current token's k/v folded into
the online softmax, with an optional in-place write of that token's row. Both
run ``csrc/decode_attention_dense.cuh`` (entries ``csrc/decode_attention.cu``
and ``csrc/fused_decode_attention.cu``): one block per (batch row, kv head,
chunk of live slots) serving the head's G query heads, K/V streamed through a
cp.async ring, reading only the live cache prefix (its bound on the H100:
those bytes). ``decode_plan`` sizes the chunks.

Kernel 7 replaces ``:pool_decode_attention`` (the same bodies with the block
index routed through the slot's table row): kernel 3's body with each warp's
copy of a tile routed through one table entry (entry
``csrc/pool_decode_attention.cu``), planned by ``decode_plan`` as kernel 3 over
the logical length; it builds no gathered view and equals kernel 3 over that
view bit for bit. The plain versions are the TPU package's ``_xla_decode_fallback``, for the
pool after a gather through the tables.

The caches and pools may be stored in bf16, f32, fp8-e4m3 or fp8-e5m2
(``ops/kv_dtype.py``); the kernels read them in that type (16-byte copies of
16 fp8, 8 bf16 or 4 f32 elements into a ring of the stored bytes) and upcast
each element as the TPU kernels' ``_load_f32`` does, and the plain versions
read through ``kv_dtype.decode``, the same rule. q and the fold form's
current k/v stay bf16; the fold form rounds the current k/v to the cache dtype
(``kv_dtype.round_to``) before it attends and writes them, as the TPU
wrapper passes ``k_new.astype(cache dtype)``. Another cache dtype raises.

Head dims: the kernels take D in ``HEAD_DIMS`` (64, 80, 96, 128, 256), one
library each (``build.PER_HEAD_DIM``), at every G <= 8 and cache dtype; the
plan (``decode_plan``) and the scratch (``partial_floats``) follow D, and
another D raises naming ROADMAP B6. At D = 64, 80 and 96 the TPU package runs
its XLA path (``_xla_decode_fallback``: its kernels need D % 128 == 0), which
the plain versions here compute; at 128 and 256 its Pallas kernels. The
kernels count their launches by cache dtype and by head dim
(``launch_counts()["decode_attention:d96"]``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kv_dtype
from . import build
from .grad import refuse_grad
from .matmul import _sm_count, check_tensor

SOURCE = "gptq_for_llama_tpu_torch/csrc/decode_attention.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/attention.py:66"
POOL_SOURCE = "gptq_for_llama_tpu_torch/csrc/pool_decode_attention.cu"
POOL_REPLACES = "gptq_for_llama_tpu/ops/pallas/attention.py:412"
FOLD_SOURCE = "gptq_for_llama_tpu_torch/csrc/fused_decode_attention.cu"
FOLD_REPLACES = "gptq_for_llama_tpu/ops/pallas/attention.py:191"
MAX_GROUP = 8   # query heads per kv head the kernels are instantiated for
HEAD_DIMS = build.HEAD_DIMS   # head dims the kernels take, one library each
HEAD_DIM = 128  # the head dim the plan functions default to
# kernels 3 and 9's layout (csrc/decode_attention_dense.cuh; checked against
# the library's gptq_dense_decode_layout when it is loaded)
TILE = 32       # cache slots per ring stage (4 warps x 8 slots)
RING = 4        # ring stages at most: a block has up to RING * TILE slots in flight
RING_BUDGET = 128 * 1024   # ring bytes the stages are fitted under
BLOCKS_PER_SM = 3   # resident blocks at most up to D = 128 (the registers are sized for it)
MAX_SPLIT = 64  # chunks per (row, kv head) the combine kernel takes
SMEM_PER_SM = 233472                      # the H100's 228 KB
BLOCK_SMEM_EXTRA = 3072                   # a block's static arrays and reserved KB, above its ring
MIN_CHUNK, MAX_CHUNK = 2 * TILE, 6 * TILE


def check_head_dim(what: str, d: int) -> None:
    """Raise for a head dim no library of the kernel takes."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: no kernel at head dim {d}; the kernels take {HEAD_DIMS} "
                         f"(ROADMAP B6)")


def max_blocks_per_sm(d: int = 128) -> int:
    """Resident blocks the kernels' registers are sized for: 3 up to D = 128,
    2 at D = 256."""
    return BLOCKS_PER_SM if d <= 128 else 2


def ring_stages(itemsize: int = 2, d: int = 128) -> int:
    """Ring stages of kernels 3, 7 and 9: RING while the ring fits RING_BUDGET
    (every cache dtype up to D = 128, bf16 and fp8 at 256), else what fits
    (f32 at D = 256: 2)."""
    return min(RING, RING_BUDGET // (4 * 2 * 8 * d * itemsize))


def ring_smem_bytes(itemsize: int = 2, d: int = 128) -> int:
    """Dynamic shared memory of one block of kernels 3, 7 and 9 over a cache
    of ``itemsize`` bytes an element at head dim ``d``: at D = 128 32 KB fp8,
    64 KB bf16, 128 KB f32."""
    return ring_stages(itemsize, d) * 4 * 2 * 8 * d * itemsize


def blocks_per_sm(itemsize: int = 2, d: int = 128) -> int:
    """Resident blocks of kernels 3, 7 and 9 an SM holds at this itemsize and
    head dim: ``max_blocks_per_sm``, or what the rings leave room for (f32 at
    D = 128: one)."""
    return max(1, min(max_blocks_per_sm(d),
                      SMEM_PER_SM // (ring_smem_bytes(itemsize, d) + BLOCK_SMEM_EXTRA)))


def check_caches(k, v, shape) -> int:
    """``check_tensor`` for a K/V pair of caches: one of the four cache
    dtypes, the same for both; returns its code for the C entry points."""
    if k.dtype not in kv_dtype.KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"the kernel takes k and v caches of one dtype among "
                        f"{tuple(kv_dtype.KV_CODES)}, got {k.dtype} and {v.dtype}")
    check_tensor(k, "k_cache", k.dtype, shape)
    check_tensor(v, "v_cache", v.dtype, shape)
    return kv_dtype.KV_CODES[k.dtype]


def attention_plain(q, k, v, scale: float, mask=None) -> torch.Tensor:
    """Softmax attention in fp32, the plain version of kernels 3 and 4.
    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) in any cache dtype, read through
    ``kv_dtype.decode`` (the TPU kernels' ``_load_f32``), H a multiple of
    Hkv. mask:
    None, a bool tensor (True = attend) or an additive float mask, either
    broadcastable to (B, H, Sq, Skv). Returns (B, Sq, H, D) in q's dtype."""
    h, hkv = q.shape[2], k.shape[2]
    kf, vf = kv_dtype.decode(k), kv_dtype.decode(v)
    if h != hkv:
        kf = kf.repeat_interleave(h // hkv, dim=2)
        vf = vf.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if mask is not None:
        logits = (logits.masked_fill(~mask, float("-inf")) if mask.dtype == torch.bool
                  else logits + mask.float())
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, offset, scale: float) -> torch.Tensor:
    """q (B, 1, H, D) attends cache slots j <= offset[b] of (B, S, Hkv, D)
    caches: the TPU package's _xla_decode_fallback."""
    offs = torch.as_tensor(offset, device=q.device).reshape(-1).expand(q.shape[0])
    live = torch.arange(k_cache.shape[1], device=q.device)[None, :] <= offs[:, None]
    return attention_plain(q, k_cache, v_cache, scale, live[:, None, None, :])


def _check_layout(lib: ctypes.CDLL, name: str, d: int) -> None:
    """Refuse a library whose head dim, tile, blocks, split or ring differ
    from the constants ``decode_plan`` plans with."""
    got = (ctypes.c_int * 7)()
    lib.gptq_dense_decode_layout(got)
    want = (d, TILE, max_blocks_per_sm(d), MAX_SPLIT,
            *(ring_smem_bytes(i, d) for i in (1, 2, 4)))
    if tuple(got) != want:
        raise RuntimeError(f"{name}: the kernel's layout (head dim, tile, blocks per SM, max "
                           f"split, ring bytes over fp8, bf16, f32) is {tuple(got)}, the "
                           f"plan's {want}")


def _entry(d: int):
    lib = build.library("decode_attention", d)
    fn = lib.gptq_decode_attention
    if fn.argtypes is None:
        _check_layout(lib, "decode_attention", d)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


class DecodePlan(NamedTuple):
    """Launch plan of kernels 3 and 9: ``nsplit`` chunks per (row, kv head),
    the grid's third dimension; chunk z covers slots [z * chunk, (z + 1) *
    chunk), the last one up to the row's own live bound."""
    nsplit: int
    chunk: int


def decode_plan(b: int, hkv: int, g: int, live: int, sms: int = 132,
                itemsize: int = 2, d: int = 128) -> DecodePlan:
    """A pure function of host ints: the batch, kv heads, query heads per kv
    head (the plan does not depend on it yet), a bound on the live slots of
    any row (the rows' own offsets still decide what each reads), the card's
    SM count, the cache's bytes an element and the head dim.

    A prefix of at most RING * TILE = 128 slots is one chunk: one pass, the
    whole prefix in flight at once, no combine kernel. A longer one is split
    so that the grid fits one wave of resident blocks (``blocks_per_sm``:
    three a SM with the 64 KB ring of a bf16 cache or the 32 KB of fp8, one
    with the 128 KB of f32): each block then streams its chunk through the
    ring while every other block does the same, and no second wave runs on
    a few SMs at the end. Chunks stay between MIN_CHUNK and MAX_CHUNK slots:
    at least two tiles a block, and short enough that rows of ragged lengths
    (serving) spread over many blocks."""
    def tiles(n):   # n slots rounded up to whole tiles
        return -(-n // TILE) * TILE

    live = max(int(live), 1)
    if live <= RING * TILE:
        return DecodePlan(1, tiles(live))
    nsplit = max(1, blocks_per_sm(itemsize, d) * sms // (b * hkv))
    chunk = min(max(tiles(-(-live // nsplit)), MIN_CHUNK), MAX_CHUNK)
    chunk = max(chunk, tiles(-(-live // MAX_SPLIT)))   # at most the chunks the combine stages
    return DecodePlan(-(-live // chunk), chunk)


def partial_floats(b: int, hkv: int, g: int, plan: DecodePlan, d: int = 128) -> int:
    """fp32 scratch the kernel writes for a split plan: per (row, kv head,
    chunk, query head) the unnormalized accumulator (D), then every row's max,
    then every row's denominator; none for one chunk."""
    return 0 if plan.nsplit == 1 else b * hkv * plan.nsplit * g * (d + 2)


def decode_attention_cuda(q, k_cache, v_cache, offset, scale: float,
                          max_live: int | None = None) -> torch.Tensor:
    """The kernel: q (B, 1, H, D) bf16, caches (B, S, Hkv, D) in one of the
    four cache dtypes (read in it), offset an int (every row) or an int32
    CUDA tensor () / (B,). D one of ``HEAD_DIMS`` and H / Hkv at most 8.

    Per-row offsets stay on the device, so the split over chunks is planned
    for the whole cache unless the caller knows a bound on the live length
    (``max_live``, a host int >= max(offset) + 1). The bound shapes the plan
    only: the offsets still decide what each row reads."""
    b, sq, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if sq != 1 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"decode attention kernel takes q (B, 1, H, D) with H/Hkv <= "
                         f"{MAX_GROUP}; got q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    check_head_dim("decode attention kernel", d)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    check_tensor(q, "q", torch.bfloat16)
    check_caches(k_cache, v_cache, (b, s, hkv, d))
    return _decode_launch(q, k_cache, v_cache, offset, float(scale),
                          plan_for(q, k_cache, offset, max_live))


def plan_for(q, k_cache, offset, max_live: int | None = None, fold: bool = False) -> DecodePlan:
    """The plan a launch of kernel 3 (``fold``: kernel 9) takes for these
    inputs: ``decode_plan`` at the live bound they give. Kernel 3 attends
    slots <= offset, the fold form slots below it (the plan then covers at
    least one slot); per-row offsets on the card give the whole cache unless
    ``max_live`` bounds it."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if isinstance(offset, torch.Tensor):
        live = s if max_live is None else min(max(int(max_live), 1), s)
    else:
        off = min(max(int(offset), 0), s - 1)
        live = max(off, 1) if fold else off + 1
    return decode_plan(b, hkv, h // hkv, live, _sm_count(q.device.index or 0),
                       k_cache.element_size(), d)


def _offsets(offset, b: int):
    """(per-row offsets on the card or None, the host offset for every row)."""
    if isinstance(offset, torch.Tensor):
        offs = offset.reshape(-1).expand(b).contiguous()
        check_tensor(offs, "offset", torch.int32, (b,))
        return offs, 0
    return None, int(offset)


def _decode_launch(q, k_cache, v_cache, offset, scale: float, plan: DecodePlan) -> torch.Tensor:
    """One launch of kernel 3 (and its combine kernel where the plan splits)
    on checked inputs under ``plan`` (a measurement may pass a plan with its
    chunk forced)."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    offs, off_scalar = _offsets(offset, b)
    n = partial_floats(b, hkv, h // hkv, plan, d)
    part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    out = torch.empty_like(q)
    fn = _entry(d)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             None if offs is None else offs.data_ptr(), off_scalar, out.data_ptr(),
             None if part is None else part.data_ptr(),
             b, s, hkv, h // hkv, d, scale, plan.nsplit, plan.chunk,
             kv_dtype.KV_CODES[k_cache.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("decode_attention", d), err, "decode_attention")
    decode_attention_cuda.launches += 1
    count_forms(decode_attention_cuda, k_cache.dtype, d)
    return out


def new_forms(by_dtype: bool = True, bodies: tuple = ()) -> dict:
    """Launch counts by cache dtype (``by_dtype``), by head dim (``d64`` ...
    ``d256``) and, for kernels of several bodies, by body and head dim
    (``wgmma:d96``) and, with ``by_dtype``, by body and cache dtype
    (``wgmma:fp8``)."""
    names = tuple(kv_dtype.KV_DTYPES) if by_dtype else ()
    return dict.fromkeys((*names, *(f"d{d}" for d in HEAD_DIMS),
                          *(f"{body}:d{d}" for body in bodies for d in HEAD_DIMS),
                          *(f"{body}:{name}" for body in bodies for name in names)), 0)


def count_forms(wrapper, dtype, d: int, body: str | None = None) -> None:
    """One launch of ``wrapper`` over a cache of ``dtype`` (where it counts
    by dtype) at head dim ``d``, through ``body`` where it has several."""
    name = kv_dtype.KV_NAMES[dtype]
    if name in wrapper.forms:
        wrapper.forms[name] += 1
    wrapper.forms[f"d{d}"] += 1
    if body is not None:
        wrapper.forms[f"{body}:d{d}"] += 1
        if f"{body}:{name}" in wrapper.forms:
            wrapper.forms[f"{body}:{name}"] += 1


decode_attention_cuda.launches = 0
decode_attention_cuda.forms = new_forms()   # launches by cache dtype and by head dim


def decode_attention(q, k_cache, v_cache, offset, scale: float,
                     max_live: int | None = None) -> torch.Tensor:
    """q (B, 1, H, D) attends slots <= offset of the caches: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, offset, scale, max_live)
    return decode_attention_plain(q, k_cache, v_cache, offset, scale)


# ---------------------------------------------------------------------------
# kernel 7: the same attention directly over a paged block pool
# ---------------------------------------------------------------------------

def supports_paged_decode(block_size: int, num_heads: int, num_kv_heads: int, head_dim: int,
                          itemsize: int = 2) -> bool:
    """What the pool kernel takes: blocks of a multiple of 8 slots, a head dim
    of ``HEAD_DIMS``, at most 8 query heads per kv head, a pool of 1, 2 or 4
    bytes an element (fp8, bf16, f32)."""
    return (block_size >= 8 and block_size % 8 == 0 and head_dim in HEAD_DIMS
            and itemsize in (1, 2, 4)
            and num_heads % num_kv_heads == 0 and num_heads // num_kv_heads <= MAX_GROUP)


def pool_decode_attention_plain(q, k_pool, v_pool, tables, offset, scale: float) -> torch.Tensor:
    """q (B, 1, H, D); pools (NB, BS, Hkv, D); tables (B, MB): row b attends
    logical slots j <= offset[b], slot j at pool[tables[b, j // BS], j % BS].
    Gathers each row's logical view, then ``decode_attention_plain``. Dead
    slots (past the offset, or in blocks the row does not own) are zeroed
    first: whatever they hold, a NaN included, must not reach the output."""
    b, (bs, hkv, d) = q.shape[0], k_pool.shape[1:]
    idx = tables.long()
    kd = kv_dtype.decode(k_pool[idx].reshape(b, -1, hkv, d))
    vd = kv_dtype.decode(v_pool[idx].reshape(b, -1, hkv, d))
    offs = torch.as_tensor(offset, device=q.device).reshape(-1).expand(b)
    live = (torch.arange(kd.shape[1], device=q.device)[None, :] <= offs[:, None])[:, :, None, None]
    return decode_attention_plain(q, torch.where(live, kd, 0.0), torch.where(live, vd, 0.0),
                                  offs, scale)


def _pool_entry(d: int):
    lib = build.library("pool_decode_attention", d)
    fn = lib.gptq_pool_decode_attention
    if fn.argtypes is None:
        _check_layout(lib, "pool_decode_attention", d)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def pool_plan_for(q, k_pool, tables, max_live: int | None = None,
                  sms: int | None = None) -> DecodePlan:
    """The plan a launch of kernel 7 takes: kernel 3's (``decode_plan``) at
    the live bound ``max_live`` gives, else the logical length MB * BS.
    ``sms``: the card's SM count (default: read from q's card)."""
    b, _, h, d = q.shape
    hkv = k_pool.shape[2]
    s = tables.shape[1] * k_pool.shape[1]
    live = s if max_live is None else min(max(int(max_live), 1), s)
    return decode_plan(b, hkv, h // hkv, live,
                       _sm_count(q.device.index or 0) if sms is None else sms,
                       k_pool.element_size(), d)


def pool_decode_attention_cuda(q, k_pool, v_pool, tables, offset, scale: float,
                               max_live: int | None = None) -> torch.Tensor:
    """The kernel: q (B, 1, H, D) bf16; pools (NB, BS, Hkv, D) in one of
    the four cache dtypes with BS a multiple of 8, D one of ``HEAD_DIMS``;
    tables (B, MB) int32;
    offset (B,) int32, all on the card.
    ``max_live`` as in ``decode_attention_cuda`` (default: the logical length
    MB * BS). Reads only logical blocks <= offset[b] // BS of each row, and
    only their table entries."""
    b, sq, h, d = q.shape
    nb, bs, hkv = k_pool.shape[:3]
    check_head_dim("pool decode attention kernel", d)
    if sq != 1 or h % hkv or not supports_paged_decode(bs, h, hkv, d, k_pool.element_size()):
        raise ValueError(f"pool decode attention kernel takes q (B, 1, H, D), H/Hkv <= "
                         f"{MAX_GROUP} and pools whose block size is a multiple of 8; got "
                         f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)} {k_pool.dtype}")
    refuse_grad("pool_decode_attention", q, k_pool, v_pool)
    check_tensor(q, "q", torch.bfloat16)
    code = check_caches(k_pool, v_pool, (nb, bs, hkv, d))
    if tables.ndim != 2 or tables.shape[0] != b:
        raise ValueError(f"tables: expected (B={b}, MB), got {tuple(tables.shape)}")
    mb = tables.shape[1]
    if not (tables.is_cuda and tables.dtype == torch.int32 and tables.is_contiguous()):
        raise ValueError("tables: the kernel takes a contiguous int32 CUDA tensor")
    if not isinstance(offset, torch.Tensor):
        raise TypeError("offset: the pool kernel takes per-row offsets, an int32 CUDA tensor")
    offs = offset.reshape(-1).expand(b).contiguous()
    check_tensor(offs, "offset", torch.int32, (b,))
    plan = pool_plan_for(q, k_pool, tables, max_live)
    n = partial_floats(b, hkv, h // hkv, plan, d)
    part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    out = torch.empty_like(q)
    fn = _pool_entry(d)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
             offs.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
             b, nb, bs, mb, hkv, h // hkv, d, float(scale), plan.nsplit, plan.chunk, code,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("pool_decode_attention", d), err, "pool_decode_attention")
    pool_decode_attention_cuda.launches += 1
    count_forms(pool_decode_attention_cuda, k_pool.dtype, d)
    return out


pool_decode_attention_cuda.launches = 0
pool_decode_attention_cuda.forms = new_forms()


def pool_decode_attention(q, k_pool, v_pool, tables, offset, scale: float,
                          max_live: int | None = None) -> torch.Tensor:
    """Decode attention over the block pool: the kernel for a CUDA tensor (a
    shape it does not take raises), the plain version for a CPU tensor."""
    if q.is_cuda:
        return pool_decode_attention_cuda(q, k_pool, v_pool, tables, offset, scale, max_live)
    return pool_decode_attention_plain(q, k_pool, v_pool, tables, offset, scale)


# ---------------------------------------------------------------------------
# kernel 9: the fold form, the current token's k/v from registers
# ---------------------------------------------------------------------------

def fused_decode_attention_plain(q, k_cache, v_cache, k_new, v_new, offset, scale: float,
                                 write_mask=None, write: bool = True, max_live=None):
    """q (B, 1, H, D) attends slots j < offset[b] of (B, S, Hkv, D) caches and
    the current token's k_new / v_new (B, 1, Hkv, D), softmax in fp32; at
    offset 0 the output is v_new. The current k/v are first rounded to the
    cache dtype (``kv_dtype.round_to``, the TPU wrapper's astype). With
    ``write``, they are stored at slot offset[b], in place, on rows whose
    ``write_mask`` (B,) bool is true (None: every row), through the cache's
    stored view (``kv_dtype.stored``). The cache at and past each row's offset
    is never read: whatever it holds, a NaN included, does not reach the
    output. Returns (out (B, 1, H, D), k_cache, v_cache). ``max_live`` plans
    the kernel only."""
    b, s = q.shape[0], k_cache.shape[1]
    offs = torch.as_tensor(offset, device=q.device).reshape(-1).expand(b).long()
    stale = torch.arange(s, device=q.device)[None, :] < offs[:, None]      # (B, S)
    keep = stale[:, :, None, None]
    kn, vn = kv_dtype.round_to(k_new, k_cache.dtype), kv_dtype.round_to(v_new, v_cache.dtype)
    k_all, v_all = (torch.cat([torch.where(keep, kv_dtype.decode(c), 0.0), kv_dtype.decode(n)],
                              dim=1) for c, n in ((k_cache, kn), (v_cache, vn)))
    live = torch.cat([stale, torch.ones(b, 1, dtype=torch.bool, device=q.device)], dim=1)
    out = attention_plain(q, k_all, v_all, scale, live[:, None, None, :])
    if write:   # fixed shapes (no boolean indexing), so a CUDA graph can hold it
        rows = torch.arange(b, device=q.device)
        for cache, new in ((k_cache, kn), (v_cache, vn)):
            cache, row = kv_dtype.stored(cache), kv_dtype.stored(new)[:, 0]
            if write_mask is not None:
                keep = ~write_mask.to(q.device).reshape(b, 1, 1)
                row = torch.where(keep, cache[rows, offs], row)
            cache[rows, offs] = row
    return out, k_cache, v_cache


def _fold_entry(d: int):
    lib = build.library("fused_decode_attention", d)
    fn = lib.gptq_fused_decode_attention
    if fn.argtypes is None:
        _check_layout(lib, "fused_decode_attention", d)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i, p, i, p, p] + [i] * 5 + [ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def fused_decode_attention_cuda(q, k_cache, v_cache, k_new, v_new, offset, scale: float,
                                write_mask=None, write: bool = True,
                                max_live: int | None = None):
    """The kernel: q (B, 1, H, D) bf16, caches (B, S, Hkv, D) in one of
    the four cache dtypes, k_new / v_new (B, 1, Hkv, D) bf16, D one of
    ``HEAD_DIMS``, offset an int
    (every row) or an int32 CUDA tensor () / (B,), write_mask None or a (B,)
    bool CUDA tensor. H / Hkv at most 8. ``max_live``
    as in ``decode_attention_cuda``: a host int >= max(offset) + 1 that shapes
    the split plan only. Returns (out, k_cache, v_cache), the caches written
    in place."""
    b, sq, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if sq != 1 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"fold decode attention kernel takes q (B, 1, H, D) with H/Hkv <= "
                         f"{MAX_GROUP}; got q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    check_head_dim("fold decode attention kernel", d)
    refuse_grad("fused_decode_attention", q, k_cache, v_cache, k_new, v_new)
    check_tensor(q, "q", torch.bfloat16)
    code = check_caches(k_cache, v_cache, (b, s, hkv, d))
    check_tensor(k_new, "k_new", torch.bfloat16, (b, 1, hkv, d))
    check_tensor(v_new, "v_new", torch.bfloat16, (b, 1, hkv, d))
    wm = None
    if write_mask is not None:
        wm = write_mask.reshape(-1).to(torch.uint8).contiguous()
        if not wm.is_cuda or wm.shape != (b,):
            raise ValueError(f"write_mask: expected a (B={b},) CUDA tensor, got "
                             f"{tuple(write_mask.shape)} on {write_mask.device}")
    offs, off_scalar = _offsets(offset, b)
    plan = plan_for(q, k_cache, offset, max_live, fold=True)
    n = partial_floats(b, hkv, h // hkv, plan, d)
    part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    out = torch.empty_like(q)
    fn = _fold_entry(d)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), None if offs is None else offs.data_ptr(), off_scalar,
             None if wm is None else wm.data_ptr(), int(bool(write)), out.data_ptr(),
             None if part is None else part.data_ptr(), b, s, hkv, h // hkv, d, float(scale),
             plan.nsplit, plan.chunk, code, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.library("fused_decode_attention", d), err, "fused_decode_attention")
    fused_decode_attention_cuda.launches += 1
    count_forms(fused_decode_attention_cuda, k_cache.dtype, d)
    return out, k_cache, v_cache


fused_decode_attention_cuda.launches = 0
fused_decode_attention_cuda.forms = new_forms()


def fused_decode_attention(q, k_cache, v_cache, k_new, v_new, offset, scale: float,
                           write_mask=None, write: bool = True, max_live: int | None = None):
    """Fold decode attention (and, with ``write``, the in-place row write):
    the kernel for a CUDA tensor (a shape it does not take raises), the plain
    version for a CPU tensor. Returns (out, k_cache, v_cache)."""
    fn = fused_decode_attention_cuda if q.is_cuda else fused_decode_attention_plain
    return fn(q, k_cache, v_cache, k_new, v_new, offset, scale, write_mask=write_mask,
              write=write, max_live=max_live)
