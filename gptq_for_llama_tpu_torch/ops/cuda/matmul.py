"""Kernel 1, the dequant-GEMM: CUDA wrapper, launch count and plain version;
and the launch plans of kernels 1 and 2 (``plan``).

Replaces ``gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel``. The kernel is
``csrc/qmm.cu`` with the forms that ``plan`` picks from M and the group
size: at M = 1 the batch-1 decode form (``csrc/qmm_decode.cuh``,
``"decode"``: one producer thread keeps TMA loads of the packed words, in
their own layout, in flight through an ``mbarrier`` ring; one block per
column tile, so the columns alone fill the card); up to ``FRAG_MAX_M`` rows
the weight dequantized straight into ``mma.sync`` fragments
(``csrc/qmm_frag.cuh``, one stream), bound by the packed weight bytes;
where the group size does not
suit them, the one-launch GEMV of ``csrc/qmm_gemv.cuh`` (a per-warp
``cp.async`` ring of the words, their scales and x; dot-then-scale per
group); both split K across the blocks of a thread block cluster, whose
partials meet in rank order in the same launch. Above that, bound by
operations, the Hopper body of ``csrc/qmm_wgmma.cuh`` (``"wgmma"``: the
weight dequantized into ``wgmma`` A fragments in registers, x fed by TMA
through an ``mbarrier`` ring; group sizes that are multiples of 16, or one
group), else the tensor-core tiles of ``csrc/qmm_tc.cuh`` (``"tile"``: the
slab dequantized to bf16 in shared memory, ``mma.sync`` with fp32 sums, a
``cp.async`` ring). The plain version is ``ops.linear.quant_matmul_plain``
(dequantize to the compute dtype, then matmul). Kernel 2 (``mlp.py``, two
weight streams) takes its plan from ``plan`` too (``streams=2``), with four
forms: the decode form at M = 1 (the GEMV where the group size does not
suit it), the fragments to 16 rows, above them the Hopper
body with the gate and up weights on its two consumer warpgroups (64 columns
of y a block) where ``wgmma_ok`` takes the shape, the tiles otherwise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from . import autotune, build
from .grad import refuse_grad
from ..linear import PackedLinear, quant_matmul_plain  # noqa: F401  (the plain version)

SOURCE = "gptq_for_llama_tpu_torch/csrc/qmm.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/matmul.py:68"

TILE_N = 128          # columns per block: the GEMV's (4 a lane); the tiles' B-tile columns
# The forms by M (measured crossovers, PERF.md section 6, NVIDIA H100 80GB
# HBM3, 700 W): at M = 1 both kernels take the decode form (DEC_MAX_M
# below) where the group size suits the fragments: kernel 1 8.54 against the
# fragments' 9.96 us at 4096 x 4096, 16.52 against 19.06 at 11008 x 4096;
# kernel 2 24.99 against its GEMV's 33.50 at 4096 x 11008
# (scripts/torch_decode_gemm_variants.py). Else kernel 1 takes the GEMV for
# M <= GEMV_MAX_M, kernel 2 for M <= FUSED_GEMV_MAX_M; both take the
# register-fragment form (csrc/qmm_frag.cuh) up to FRAG_MAX_M where the group
# size suits it (else the GEMV), the tiles above. Kernel 1's fragments beat
# its GEMV from M = 1 (9.42 against 10.68 us at 4096 x 4096, 17.56 against
# 25.55 at 11008 x 4096); kernel 2's GEMV beats its fragments at M = 1 only
# (33.40 against 35.49 us, M = 2: 38.69 against 35.80)
GEMV_MAX_M = 0
FUSED_GEMV_MAX_M = 1
FRAG_MAX_M = 16
# Above the fragment form kernels 1 and 2 take the Hopper body
# (csrc/qmm_wgmma.cuh) from WGMMA_MIN_M rows where its shapes allow
# (``wgmma_ok``), the mma.sync tiles otherwise: for kernel 1 the wgmma body
# measured faster at every M from the first
# above FRAG_MAX_M (M = 17: 12.13 against the tiles' 22.40 us at 4096 x 4096,
# 24.56 against 49.11 at 11008 x 4096; M = 1024: 51.74 against 144.51;
# scripts/torch_qmm_bodies.py, PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
WGMMA_MIN_M = FRAG_MAX_M + 1
CLUSTER_MAX = 8       # blocks of one cluster the plans take
CLUSTER_LIMIT = 16    # the most the kernels take (above 8: the non-portable attribute)
GEMV_WARPS = 8
GEMV_STAGES = {1: 8, 2: 4}   # csrc/qmm_gemv.cuh's ring depth by streams
FRAG_COLS, FRAG_WARPS, FRAG_STAGES = 32, 8, 3   # csrc/qmm_frag.cuh's block and ring
# The batch-1 decode form (csrc/qmm_decode.cuh) takes M <= DEC_MAX_M rows
# where the fragment form's group sizes hold (``frag_ok``) and its ring fits
# (``decode_geometry``): columns of a word box (a strip), the deepest ring
# and the word bytes of a stage it aims at; the strips of each weight a
# block holds, by streams (csrc/qmm_decode.cuh's instantiations)
DEC_MAX_M = 1
DEC_STRIP, DEC_MAX_STAGES = 16, 16
DEC_STAGE_BYTES = 16384
DEC_STRIPS = {1: (1, 2, 3, 4, 5, 6), 2: (1, 2, 3)}


def decode_warps(strips: int) -> int:
    """Consumer warps of a decode-form block of ``strips`` strips (both
    weights together; qmm_decode.cuh's ``consumer_warps``): 16 at one block
    an SM where they are at most 3, else 8 at two blocks an SM."""
    return 16 if strips <= 3 else 8
# the tile path's row tiles, slab depth and staged groups: csrc/qmm_tc.cuh's
TC_ROW_TILES, TC_TILE_K, TC_MAX_GROUPS = (64, 128, 256), 64, 4
# the Hopper body's row tiles (wgmma's N), weight columns a block (kernel 2:
# 64 columns of y, of each of its two weights), reduction a stage, deepest
# ring and bytes of a stage's scale (and zero) rows: csrc/qmm_wgmma.cuh's
WG_ROW_TILES, WG_COLS, WG_DEPTH, WG_MAX_STAGES, WG_SZ_BYTES = (64, 128, 144, 256), 128, 64, 8, 1024
SMEM_PER_SM = 233472      # the H100's shared memory of one SM (1 KB of it per block reserved)
SMEM_PER_BLOCK = 232448   # the most dynamic shared memory one block may have


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Plan(NamedTuple):
    path: str        # "decode" (csrc/qmm_decode.cuh), "gemv" (csrc/qmm_gemv.cuh), "frag"
                     # (csrc/qmm_frag.cuh), "tile" (csrc/qmm_tc.cuh) or "wgmma"
                     # (csrc/qmm_wgmma.cuh)
    mt: int          # rows per block: 1, 2, 4, 8 (gemv), 8, 16 (frag), 64, 128, 256 (tile),
                     # 64, 128, 144, 256 (wgmma); decode (one row): 16-column strips a block
    split: int       # blocks along K: none (decode), one cluster (gemv, frag: partial sums
                     # added in rank order in the launch), or partials summed by a second
                     # kernel (tile, wgmma)
    per_split: int   # packed word rows a stage (decode), packed words (gemv), K-blocks
                     # (frag) or 64-row slabs (tile, wgmma) per split
    smem: int        # dynamic shared memory of one block, bytes


def tile_smem_bytes(bits: int, bm: int = 128) -> int:
    """Shared memory of one tile block (qmm_tc.cuh's ``Layout``), one or two
    weight streams alike: a ring of stages (4 for BM = 256, else 3) of the x
    tile, the slab's words of the block's 128 B-tile columns and their scale
    and zero rows; then two bf16 B tiles. Rows padded by 8 bf16."""
    stride = TC_TILE_K + 8
    words = TC_TILE_K * bits // 32 * TILE_N * 4
    scale_zero = 2 * TC_MAX_GROUPS * TILE_N * 2
    stage = bm * stride * 2 + words + scale_zero
    return (4 if bm == 256 else 3) * stage + 2 * TILE_N * stride * 2


def wgmma_smem_bytes(bits: int, bm: int) -> int:
    """Shared memory of one block of the Hopper body (qmm_wgmma.cuh's
    ``Layout``), kernels 1, 2 and 8 alike: as many stages as fit (at most
    ``WG_MAX_STAGES``) of x's (g's) ``bm`` x 64 bf16 tile, the stage's packed
    words (64 x 128 weights: kernel 2's 64 columns of each of its two) and 1
    KB each of scale and zero rows; then the
    full and empty barriers, and 1 KB to align the stages to the 128-byte
    swizzle's atom."""
    stage = bm * WG_DEPTH * 2 + WG_DEPTH * WG_COLS * bits // 8 + 2 * WG_SZ_BYTES
    bars = 2 * WG_MAX_STAGES * 8
    stages = min(WG_MAX_STAGES, (SMEM_PER_BLOCK - bars - 1024) // stage)
    return stages * stage + bars + 1024


def wgmma_ok(k: int, n: int, bits: int, groupsize: int, groups: int) -> bool:
    """The Hopper body's shapes: TMA's 16-byte strides (K and N multiples of
    8) and every k16 step (kernel 8: every warp's 16 rows of W) inside one
    group."""
    return (bits in (2, 4, 8) and k % 8 == 0 and n % 8 == 0
            and (groups == 1 or groupsize % 16 == 0))


@lru_cache(maxsize=None)
def wgmma_sz_rows(span: int, k: int, groupsize: int, groups: int) -> int:
    """Scale (and zero) rows one stage of the Hopper body holds: the most
    groups that ``span`` rows of K from a multiple of ``span`` touch (kernel
    1's 64-row slab, kernel 8's 128 rows of W a block)."""
    def group(r):
        return min(r // groupsize, groups - 1)
    return max(group(min(k, t + span) - 1) - group(t) + 1 for t in range(0, k, span))


def wgmma_row_tile(m: int) -> int:
    """The Hopper body's row tile (wgmma's N): the smallest of
    ``WG_ROW_TILES`` that holds M up to 256 rows; above, 256 (measured
    fastest from M = 512 to 16384 at every LLaMA-7B width, split or not),
    unless 128-row tiles cover M in fewer rows."""
    if m <= WG_ROW_TILES[-1]:
        return next(b for b in WG_ROW_TILES if m <= b)
    return 256 if -(-m // 256) * 256 <= -(-m // 128) * 128 else 128


def tile_blocks_per_sm(bits: int, bm: int) -> int:
    """Resident tile blocks per SM: one at BM = 256 (235 registers a thread),
    else two (the 128-register cap of ``__launch_bounds__``) where their shared
    memory fits."""
    if bm == 256:
        return 1
    return max(1, min(2, SMEM_PER_SM // (tile_smem_bytes(bits, bm) + 1024)))


def cluster_recv_bytes(streams: int, outs: int) -> int:
    """The receive buffer of the one-launch K-split sum
    (``gptq::cluster_recv_floats``): every rank's share of ``outs`` outputs of
    ``streams`` fp32 sums, padded by the largest cluster."""
    return 4 * streams * (outs + CLUSTER_LIMIT)


def gemv_smem_bytes(bits: int, mt: int, streams: int) -> int:
    """Shared memory of one GEMV block (qmm_gemv.cuh's ``Layout``): per warp
    a ring of ``GEMV_STAGES`` stages, each of every lane's words and scales
    and zeros (16 + 16 B a stream) and ``mt`` rows of x over one word's rows
    (2 * 32 / bits B each, padded to 16 B); the ring then holds the 8 warps'
    fp32 sums; then the buffer that receives the cluster's partials of the
    block's share of the outputs."""
    stage = streams * 32 * 32 + -(-mt * 2 * (32 // bits) // 16) * 16
    ring = GEMV_WARPS * GEMV_STAGES[streams] * stage
    red = GEMV_WARPS * streams * mt * TILE_N * 4
    return max(ring, red) + cluster_recv_bytes(streams, mt * TILE_N)


def frag_rows_per_block(bits: int) -> int:
    """Rows of K in one K-block of the fragment form: 4 packed word-rows."""
    return 4 * (32 // bits)


def frag_cols(streams: int) -> int:
    """Columns of y one fragment-form block covers: 8 lane groups of 4
    columns of each stream (kernel 2), or of 8 columns of the one weight
    (kernel 1)."""
    return FRAG_COLS if streams == 2 else 2 * FRAG_COLS


def frag_smem_bytes(bits: int, nt: int) -> int:
    """Shared memory of one fragment-form block (qmm_frag.cuh's ``Layout``),
    one or two streams alike: per warp a ring of FRAG_STAGES stages, each of
    every lane's two words (32 B), its ``nt`` slices of x (32 / bits rows,
    bf16) and 256 B of scales and zeros; the ring then holds the 8 warps'
    fp32 sums; then the buffer that receives the cluster's partials of the
    block's share of the outputs."""
    stage = 32 * 32 + nt * 32 * 2 * (32 // bits) + 256
    outs = 8 * nt * FRAG_COLS
    return (max(FRAG_WARPS * FRAG_STAGES * stage, FRAG_WARPS * 2 * outs * 4)
            + cluster_recv_bytes(2, outs))


class Decode(NamedTuple):
    """The batch-1 decode form's launch geometry (``decode_geometry``)."""
    strips: int      # 16-column strips of y a block (of each weight, kernel 2)
    rows: int        # packed word rows a stage: 64, 128 or 256
    sz_rows: int     # scale (and zero) rows a stage holds
    stages: int      # the ring's depth
    smem: int        # dynamic shared memory of one block, bytes


def decode_smem_bytes(streams: int, strips: int, rows: int, sz_rows: int, k: int,
                      stages: int) -> int:
    """Shared memory of one decode-form block (qmm_decode.cuh's ``layout``):
    ``stages`` stages, each the word boxes (``rows`` x 64 bytes a strip of
    each weight) and each weight's scale and zero boxes (``sz_rows`` rows of
    the block's columns, 128-byte aligned), 1 KB aligned; x (K bf16); the
    warps' fp32 sums; the full and empty barriers; 1 KB of alignment."""
    def up(v, a):
        return -(-v // a) * a
    words = streams * strips * rows * 64
    stage = up(words + streams * 2 * up(sz_rows * strips * DEC_STRIP * 2, 128), 1024)
    red = decode_warps(streams * strips) * streams * strips * DEC_STRIP * 4
    return 1024 + stages * stage + up(k * 2, 128) + red + 2 * stages * 8


@lru_cache(maxsize=None)
def decode_geometry(k: int, n: int, bits: int, sms: int, streams: int, groupsize: int,
                    groups: int, rows: int | None = None,
                    strips: int | None = None) -> Decode | None:
    """How the decode form covers (1, K) @ (K, N): the fewest 16-column
    strips a block (of ``DEC_STRIPS``) whose blocks cover N in one wave, one
    block an SM up to 3 strips over both weights (16 consumer warps), two
    above (8 each: ``decode_warps``): 2 at N = 4096 (128 blocks), 3 of each
    weight for kernel 2 at N = 11008 (230 blocks); the most there are, in
    more than one wave, beyond. Then the deepest stage of the word rows 256,
    128, 64 whose words stay within ``DEC_STAGE_BYTES`` (the least that
    gives every warp an 8-row octet where none does); as many stages as the
    block's share of shared memory holds, up to ``DEC_MAX_STAGES`` and the
    stages K has. ``strips`` and ``rows`` force the block's strips and the
    stage's word rows (a launch under another shape's plan: a column's sums
    depend on the rows a stage and the consumer warps, which the strips
    set, and nothing else of the geometry). None where fewer than two stages fit
    (one where K has one), or the shape is not the fragment form's
    (``frag_ok``)."""
    if not frag_ok(k, n, bits, groupsize):
        return None
    units = -(-n // DEC_STRIP)

    def per_sm(s):
        return 1 if decode_warps(streams * s) == 16 else 2
    if strips is None:
        strips = next((s for s in DEC_STRIPS[streams] if s * per_sm(s) * sms >= units),
                      DEC_STRIPS[streams][-1])
    elif strips not in DEC_STRIPS[streams]:
        return None
    least = 8 * decode_warps(streams * strips)
    budget = SMEM_PER_BLOCK if per_sm(strips) == 1 else SMEM_PER_SM // 2 - 1024
    if rows is None:
        rows = next((r for r in (256, 128) if streams * strips * r * 64 <= DEC_STAGE_BYTES),
                    least)
    if rows < least:
        return None
    sz_rows = wgmma_sz_rows(rows * (32 // bits), k, groupsize, groups)
    if sz_rows > 256:
        return None
    n_st = -(-(k // (32 // bits)) // rows)
    for stages in range(min(DEC_MAX_STAGES, n_st), 0, -1):
        smem = decode_smem_bytes(streams, strips, rows, sz_rows, k, stages)
        if smem <= budget:
            return Decode(strips, rows, sz_rows, stages, smem) if stages >= min(2, n_st) else None
    return None


def frag_ok(k: int, n: int, bits: int, groupsize: int) -> bool:
    """The fragment form's shapes: whole 16-byte copies and every K-block
    inside one group."""
    return k % 8 == 0 and n % 8 == 0 and groupsize % frag_rows_per_block(bits) == 0


def row_tile(m: int, cols: int, sms: int) -> int:
    """The row tile of a tensor-core tile kernel (kernels 1 and 8): one tile
    covers M up to 256 rows (the padded rows cost less than a second row of
    tiles); above that, 256 where those tiles alone give every SM a block,
    else 128. ``cols``: column tiles of the output."""
    if m <= 256:
        return next(b for b in TC_ROW_TILES if m <= b)
    return 256 if cols * -(-m // 256) >= sms else 128


def reduction_split(tiles: int, slabs: int, slots: int, sms: int,
                    balance: bool = False, most: int | None = None) -> tuple[int, int]:
    """How many blocks share one output tile's reduction, and how many
    64-deep slabs each takes. Fewer tiles than SMs split the reduction: the
    split that fills every SM and costs the fewest waves x (slabs per block +
    2, a block's start-up: the first two slabs' copies in flight), the
    smallest such split, each split keeping at least 4 slabs. ``slots``:
    resident blocks on the card. ``balance`` (kernel 2, whose 64-column
    tiles at M <= 256 are 1-2 waves of long blocks): below two waves of
    tiles, the split of that cost from 1 up, so that a wave and a third
    becomes two even waves of shorter blocks. ``most`` caps the split."""
    split = 1
    if tiles < sms or (balance and tiles < 2 * slots):
        hi = max(1, slabs // 4) if most is None else max(1, min(slabs // 4, most))
        lo = 1 if balance else min(-(-sms // tiles), hi)
        split = min(range(lo, hi + 1),
                    key=lambda s: (-(-tiles * s // slots) * (-(-slabs // s) + 2), s))
    per = -(-slabs // split)
    return -(-slabs // per), per


def plan_of(path: str, mt: int, split: int, k: int, bits: int, streams: int = 1) -> Plan:
    """The plan of kernel 1 (``streams=1``) or 2 (``streams=2``) with the
    free choices ``path``, ``mt`` (rows per block) and ``split`` (blocks
    along K): each split's share of K (packed words, K-blocks or 64-row
    slabs), the tiles' split recounted so that none is empty, and the
    block's shared memory. Every plan of ``plan`` ends here, and so does a
    tuned one (``autotune``)."""
    if path == "gemv":
        per = -(-(k // (32 // bits)) // split)
        return Plan("gemv", mt, split, per, gemv_smem_bytes(bits, mt, streams))
    if path == "frag":
        per = -(-(-(-k // frag_rows_per_block(bits))) // split)
        return Plan("frag", mt, split, per, frag_smem_bytes(bits, mt // 8))
    if path not in ("tile", "wgmma"):
        raise ValueError(f"plan_of takes the forms gemv, frag, tile and wgmma (the decode "
                         f"form's plan is _decode_plan's), got {path!r}")
    slabs = -(-k // TC_TILE_K)
    per = -(-slabs // split)
    smem = tile_smem_bytes(bits, mt) if path == "tile" else wgmma_smem_bytes(bits, mt)
    return Plan(path, mt, -(-slabs // per), per, smem)


def _tile_plan(m: int, k: int, n: int, bits: int, sms: int, streams: int) -> Plan:
    """``row_tile`` over N's column tiles (128 / streams columns of y each),
    then ``reduction_split`` along K."""
    cols = -(-n // (TILE_N // streams))
    bm = row_tile(m, cols, sms)
    tiles = cols * -(-m // bm)
    slots = sms * tile_blocks_per_sm(bits, bm)
    split, _ = reduction_split(tiles, -(-k // TC_TILE_K), slots, sms, balance=streams == 2)
    return plan_of("tile", bm, split, k, bits, streams)


def wgmma_split(tiles: int, units: int, sms: int, streams: int = 1, bm: int = 64) -> int:
    """The wgmma body's split of the reduction (one block an SM): where the
    output tiles fill at most half the SMs, the split of the fewest waves x
    (stages per block + 2) from 1 up (``reduction_split`` balanced: 4 at M =
    128 and N = 4096, where filling all 132 SMs would cost a second wave; 2
    at M = 512); above, none for kernels 1 and 8 (86 tiles of N = 11008 at M
    = 128: unsplit 38.05 / 34.74 us against 38.64 / 36.73 split 3 for
    kernels 1 / 8). Kernel 2 (``streams=2``, 64 columns of y a tile) splits
    the same way below two waves of tiles, at most 2 ways at 256-row tiles,
    whose partials (2 x split x M x N fp32) cost the sum more: 172 tiles of
    N = 11008, M = 17 / 100 / 128 / 136 split 3: 55.2 / 72.3 / 76.0 / 77.8
    us (split 2: 58.7 / 72.3 / 75.0 / 80.1; none: 71.8 / 84.7 / 85.6 /
    87.7), M = 201 / 256 split 2: 98.9 / 106.9 (3: 102.4 / 113.2; none:
    106.9 / 108.7); 86 tiles of the tp 2 shard N = 5504 at M = 128 split 3:
    37.4 (2: 48.5, one wave and a third; none: 43.4). Each the fastest
    measured, NVIDIA H100 80GB HBM3, 700 W (scripts/torch_qmm_bodies.py)."""
    if tiles <= sms // 2:
        return reduction_split(tiles, units, sms, sms, balance=True)[0]
    if streams == 2 and tiles < 2 * sms:
        return reduction_split(tiles, units, sms, sms, balance=True,
                               most=2 if bm > 144 else None)[0]
    return 1


def _wgmma_plan(m: int, k: int, n: int, bits: int, sms: int, streams: int = 1) -> Plan:
    """``wgmma_row_tile`` over N's column tiles (128 columns of y a block for
    kernel 1, 64 for kernel 2), then ``wgmma_split`` along K."""
    bm = wgmma_row_tile(m)
    tiles = -(-n // (WG_COLS // streams)) * -(-m // bm)
    split = wgmma_split(tiles, -(-k // WG_DEPTH), sms, streams, bm)
    return plan_of("wgmma", bm, split, k, bits, streams)


def cluster_split(tiles: int, units: int, blocks: int, least: int,
                  cap: int = CLUSTER_MAX) -> tuple[int, int]:
    """The K split of the decode-width forms, one thread block cluster a
    tile: the smallest power of two (at most ``cap``) that brings ``tiles``
    x split to ``blocks``, each split keeping at least ``least`` of the
    ``units`` along K; then halved while its last split would be empty.
    Returns (split, units per split)."""
    split = 1
    while split < cap and tiles * split < blocks and units // (2 * split) >= least:
        split *= 2
    per = -(-units // split)
    while split > 1 and (split - 1) * per >= units:
        split //= 2
        per = -(-units // split)
    return split, per


def _gemv_plan(m: int, k: int, n: int, bits: int, sms: int, streams: int,
               cap: int = CLUSTER_MAX) -> Plan:
    """The GEMV: rows per block from M, then K split until two blocks sit on
    every SM (17 K-splits and a second kernel before; now a cluster: 8 at
    4096 x 4096 and 11008 x 4096, 4 for kernel 2's 86 column tiles; 2 and 16
    ways measured slower, PERF.md), each warp keeping at least one packed
    word."""
    mt = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8
    tiles = -(-n // TILE_N) * -(-m // mt)
    split, _ = cluster_split(tiles, k // (32 // bits), 2 * sms, GEMV_WARPS, cap)
    return plan_of("gemv", mt, split, k, bits, streams)


def _frag_plan(m: int, k: int, n: int, bits: int, sms: int, streams: int,
               cap: int = CLUSTER_MAX) -> Plan:
    """The fragment form: one block per ``frag_cols(streams)`` columns of y,
    its 8 warps on consecutive runs of K; where the column blocks leave more
    than a sixteenth of the SMs without one, K is split across a cluster too
    (2 ways at 4096 x 4096 and 11008 x 4096: 128 blocks, one an SM, measured
    faster than 4 or 8 ways, PERF.md), each split keeping at least two
    K-blocks a warp."""
    nt = 1 if m <= 8 else 2
    kbs = -(-k // frag_rows_per_block(bits))
    split, _ = cluster_split(-(-n // frag_cols(streams)), kbs, sms - sms // 16,
                             2 * FRAG_WARPS, cap)
    return plan_of("frag", 8 * nt, split, k, bits, streams)


def _decode_plan(m: int, k: int, n: int, bits: int, sms: int, streams: int, groupsize: int,
                 groups: int | None) -> Plan:
    """The decode form at M = 1 (``decode_geometry``): 16-column strips a
    block in ``mt``, word rows a stage in ``per_split``, no K split."""
    geo = (decode_geometry(k, n, bits, sms, streams, groupsize,
                           -(-k // groupsize) if groups is None else groups)
           if m <= DEC_MAX_M else None)
    if geo is None:
        raise ValueError(f"the decode form does not take M={m}, K={k}, N={n}, {bits}-bit, "
                         f"groupsize {groupsize}")
    return Plan("decode", geo.strips, 1, geo.rows, geo.smem)


def plan(m: int, k: int, n: int, bits: int, sms: int = 132, streams: int = 1,
         path: str | None = None, groupsize: int = 128, groups: int | None = None) -> Plan:
    """How one launch of kernel 1 (``streams=1``) or kernel 2 (``streams=2``)
    covers (M, K) @ (K, N).

    The decode form (``_decode_plan``) at M = 1 where ``decode_geometry``
    takes the shape; else the GEMV (``_gemv_plan``) up to ``GEMV_MAX_M``
    (kernel 1) or ``FUSED_GEMV_MAX_M`` (kernel 2) rows; the fragment form (``_frag_plan``)
    up to ``FRAG_MAX_M`` where ``groupsize`` puts every K-block in one group
    (``frag_ok``), else the GEMV; above that, for both kernels, the wgmma body
    (``_wgmma_plan``) where ``wgmma_ok`` takes the shape (``groups``: the
    scale rows, ceil(K / groupsize) unless given); else the tiles
    (``_tile_plan``) when K and N are multiples of 8 (16-byte copies), else
    the GEMV. ``path`` forces one (for measurements, through ``_launch``)."""
    if path is None:
        wide = k % 8 == 0 and n % 8 == 0
        groups_ = -(-k // groupsize) if groups is None else groups
        if m <= DEC_MAX_M and decode_geometry(k, n, bits, sms, streams, groupsize, groups_):
            path = "decode"
        elif m <= (GEMV_MAX_M if streams == 1 else FUSED_GEMV_MAX_M):
            path = "gemv"
        elif m <= FRAG_MAX_M:
            path = "frag" if frag_ok(k, n, bits, groupsize) else "gemv"
        elif m >= WGMMA_MIN_M and wgmma_ok(
                k, n, bits, groupsize, -(-k // groupsize) if groups is None else groups):
            path = "wgmma"
        else:
            path = "tile" if wide else "gemv"
    if path == "decode":
        return _decode_plan(m, k, n, bits, sms, streams, groupsize, groups)
    if path == "wgmma":
        return _wgmma_plan(m, k, n, bits, sms, streams)
    if path == "tile":
        return _tile_plan(m, k, n, bits, sms, streams)
    if path == "frag":
        if m > FRAG_MAX_M:
            raise ValueError("the fragment form takes M <= 16")
        return _frag_plan(m, k, n, bits, sms, streams)
    return _gemv_plan(m, k, n, bits, sms, streams)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """What every kernel wrapper demands of its operands; raises otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous, 16-byte aligned tensor")


def check_packed(lin: PackedLinear, x2: torch.Tensor) -> None:
    k, n = lin.in_features, lin.out_features
    if lin.bits not in (2, 4, 8):
        raise ValueError(f"dequant-GEMM kernel takes device bits 2/4/8, got {lin.bits}")
    if n % 4 or k % (32 // lin.bits):
        raise ValueError(f"dequant-GEMM kernel needs out_features % 4 == 0 and whole "
                         f"packed words along K, got K={k}, N={n}, bits={lin.bits}")
    g = lin.scales.shape[0]
    check_tensor(x2, "x", torch.bfloat16, (x2.shape[0], k))
    check_tensor(lin.qweight, "qweight", torch.int32, (k * lin.bits // 32, n))
    check_tensor(lin.scales, "scales", torch.bfloat16, (g, n))
    check_tensor(lin.zeros, "zeros", torch.bfloat16, (g, n))
    if x2.device != lin.qweight.device:
        raise ValueError(f"x on {x2.device}, weights on {lin.qweight.device}")


_ENTRIES = {"decode": "gptq_qmm_decode", "gemv": "gptq_qmm", "frag": "gptq_qmm_frag",
            "tile": "gptq_qmm_tile", "wgmma": "gptq_qmm_wgmma"}


def _entry(path: str):
    fn = getattr(build.library("qmm"), _ENTRIES[path])
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * (7 if path in ("tile", "wgmma") else 6)
                       + [i] * (11 if path == "wgmma" else 10) + [p])
        fn.restype = ctypes.c_int
    return fn


def plan_for(x2: torch.Tensor, lin: PackedLinear) -> Plan:
    """The plan ``qmm_cuda`` launches for x2 (M, K) on the card: the tuned
    one (``autotune.lookup``, kind "fwd"), else ``plan``'s."""
    m, sms = x2.shape[0], _sm_count(x2.device.index or 0)
    tuned = autotune.lookup("fwd", lin.in_features, lin.out_features, lin.bits, lin.groupsize,
                            m, sms, x2.device)
    return tuned or plan(m, lin.in_features, lin.out_features, lin.bits, sms,
                         groupsize=lin.groupsize, groups=lin.scales.shape[0])


def qmm_cuda(x2: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """y = x2 @ dequant(lin) + bias on the card. x2: (M, K) bf16, already
    permuted (act-order); returns (M, N) bf16. ``plan_for`` picks the form
    from M and the group size."""
    refuse_grad("qmm", x2, lin.bias, lin.scales, lin.zeros)
    check_packed(lin, x2)
    if lin.bias is not None:
        check_tensor(lin.bias, "bias", torch.bfloat16, (lin.out_features,))
    if x2.shape[0] == 0:
        return torch.empty((0, lin.out_features), dtype=torch.bfloat16, device=x2.device)
    return _launch(x2, lin, plan_for(x2, lin))


def _launch(x2: torch.Tensor, lin: PackedLinear, p: Plan) -> torch.Tensor:
    """One launch of kernel 1 on checked operands under plan ``p`` (a
    measurement may pass a plan with its path forced)."""
    m, k, n, groups = x2.shape[0], lin.in_features, lin.out_features, lin.scales.shape[0]
    if p.path == "decode":
        return _launch_decode(x2, lin, p)
    if p.path == "wgmma" and not wgmma_ok(k, n, lin.bits, lin.groupsize, groups):
        raise ValueError(f"qmm: the wgmma body does not take K={k}, N={n}, {lin.bits}-bit, "
                         f"groupsize {lin.groupsize} ({groups} groups)")
    tiled = p.path in ("tile", "wgmma")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    partial = (torch.empty((p.split, m, n), dtype=torch.float32, device=x2.device)
               if tiled and p.split > 1 else None)
    # the tiles' and the wgmma body's split sums fp32 partials in a second kernel
    scratch = (() if not tiled else (None if partial is None else partial.data_ptr(),))
    rows = p.mt // 8 if p.path == "frag" else p.mt
    sz_rows = ((wgmma_sz_rows(WG_DEPTH, k, lin.groupsize, groups),) if p.path == "wgmma"
               else ())
    err = _entry(p.path)(
        x2.data_ptr(), lin.qweight.data_ptr(), lin.scales.data_ptr(), lin.zeros.data_ptr(),
        None if lin.bias is None else lin.bias.data_ptr(), out.data_ptr(), *scratch,
        m, k, n, groups, lin.groupsize, lin.bits, rows, p.split, p.per_split, *sz_rows,
        p.smem, torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(build.library("qmm"), err, f"qmm ({p.path})")
    qmm_cuda.launches += 1
    qmm_cuda.forms[p.path] += 1
    return out


def decode_launch_geometry(x2: torch.Tensor, lin: PackedLinear, p: Plan,
                           streams: int = 1) -> Decode:
    """The decode form's geometry for a launch of plan ``p`` on x2's card:
    its strips (``p.mt``) and its stage's word rows (``p.per_split``), the
    ring this shape takes; raises where the form does not take the
    operands."""
    m, k, n = x2.shape[0], lin.in_features, lin.out_features
    geo = (decode_geometry(k, n, lin.bits, _sm_count(x2.device.index or 0), streams,
                           lin.groupsize, lin.scales.shape[0], p.per_split, p.mt)
           if m == 1 else None)
    if geo is None:
        raise ValueError(f"the decode form does not take M={m}, K={k}, N={n}, {lin.bits}-bit, "
                         f"groupsize {lin.groupsize} under plan {p}")
    return geo


def _launch_decode(x2: torch.Tensor, lin: PackedLinear, p: Plan) -> torch.Tensor:
    geo = decode_launch_geometry(x2, lin, p)
    k, n, groups = lin.in_features, lin.out_features, lin.scales.shape[0]
    out = torch.empty((1, n), dtype=torch.bfloat16, device=x2.device)
    err = _entry("decode")(
        x2.data_ptr(), lin.qweight.data_ptr(), lin.scales.data_ptr(), lin.zeros.data_ptr(),
        None if lin.bias is None else lin.bias.data_ptr(), out.data_ptr(), k, n, groups,
        lin.groupsize, lin.bits, geo.strips, geo.rows, geo.sz_rows, geo.stages, geo.smem,
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(build.library("qmm"), err, "qmm (decode)")
    qmm_cuda.launches += 1
    qmm_cuda.forms["decode"] += 1
    return out


qmm_cuda.launches = 0
qmm_cuda.forms = {"decode": 0, "gemv": 0, "frag": 0, "tile": 0, "wgmma": 0}   # launches by form
