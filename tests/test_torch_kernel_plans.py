"""The host-side launch plans of kernels 1 and 2 (``ops/cuda/matmul.plan``),
of kernel 8 (``ops/cuda/matmul_t.plan``), of kernels 4 and 5 (which body) and
of kernels 3, 7 and 9 (``ops/cuda/attention.decode_plan``), at LLaMA-7B's
widths. Pure arithmetic: no card, no nvcc.

Kernels 1 and 2 take the batch-1 decode form (``csrc/qmm_decode.cuh``: a
TMA ring of the packed words, one block per column tile, no K split) at M =
1 where the fragment form's group sizes hold. Kernel 1 takes the one-stream
register-fragment form up to ``FRAG_MAX_M`` rows (the one-launch GEMV where
the group size does not suit it, or at M <= ``GEMV_MAX_M``) and above them the Hopper body (``csrc/qmm_wgmma.cuh``:
wgmma fed by TMA) where its shapes allow, the mma.sync tiles otherwise;
kernel 8 the same two bodies; kernel 2 takes its GEMV at
M = 1, the fragment form up to ``FRAG_MAX_M`` and above it the Hopper body
(gate and up on its two consumer warpgroups, 64 columns of y a block) where
its shapes allow, kernel 1's tiles with two interleaved streams otherwise;
the decode-width forms split K across the blocks
of one thread block cluster; kernel 8 takes kernel 1's row tile and splits N
where its tiles do not fill the card. Kernels 3, 7 and 9 split the live
slots into chunks of whole tiles; a CPU model of the split and its combine
(the kernels' arithmetic in fp32 numpy), dense and routed through block
tables, is held against the TPU package's decode attention in interpret
mode."""

import pytest

from gptq_for_llama_tpu_torch.ops.cuda import matmul
from gptq_for_llama_tpu_torch.ops.cuda.matmul import (CLUSTER_LIMIT, CLUSTER_MAX, DEC_MAX_M,
                                                      FRAG_MAX_M, FUSED_GEMV_MAX_M, GEMV_MAX_M,
                                                      SMEM_PER_SM,
                                                      TC_ROW_TILES, WG_ROW_TILES, WGMMA_MIN_M,
                                                      Plan, frag_ok, plan, tile_blocks_per_sm,
                                                      tile_smem_bytes, wgmma_ok, wgmma_smem_bytes,
                                                      wgmma_sz_rows)

SMS = 132   # the H100 SXM's SMs
SMEM_PER_BLOCK = 232448   # the most dynamic shared memory one block may have
# every M the smoke gives the linears: decode, serving decode step, prompt,
# chunk, fused chunk + decode row, buckets, admission, LoRA batch, eval
SMOKE_MS = (1, 8, 100, 128, 136, 512, 1024, 2048, 16384)
# (K, N): q/k/v/o_proj, down_proj, gate/up_proj unfused (LoRA)
SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))


@pytest.mark.parametrize("k,n,m,want", [
    (4096, 4096, 1, ("decode", 2, 1, 128)), (4096, 4096, 4, ("frag", 8, 2, 64)),
    (11008, 4096, 1, ("decode", 2, 1, 128)), (11008, 4096, 4, ("frag", 8, 2, 172))])
def test_kernel_1_keeps_the_gemv_for_decode(k, n, m, want):
    """Kernel 1's decode plans at M = 1 and 4: at M = 1 the batch-1 decode
    form (2 strips a block, stages of 128 packed word rows); at M = 4 the
    one-stream fragment
    form, one block per 64 columns and K split 2 ways across a cluster (128
    blocks, one an SM), K-blocks of 32 rows per split; the GEMV (forced, or
    where the group size does not
    suit the fragments) takes 8 cluster splits of 64 or 172 packed words,
    one row per block at M = 1 and 8 at M = 8, and the wgmma body takes over
    from M = 17."""
    p = plan(m, k, n, 4, SMS)
    assert (p.path, p.mt, p.split, p.per_split) == want
    gemv = plan(1, k, n, 4, SMS, path="gemv")
    assert (gemv.mt, gemv.split, gemv.per_split) == (1, 8, k // 64)
    eight = plan(8, k, n, 4, SMS, path="gemv")
    assert (eight.mt, eight.split, eight.per_split) == (8, 8, k // 64)
    assert plan(8, k, n, 4, SMS).path == "frag" and plan(17, k, n, 4, SMS).path == "wgmma"
    assert plan(m, k, n, 4, SMS, groupsize=40).path == "gemv"


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kernel_1_takes_the_tiles_above_the_threshold(k, n, bits):
    """The fragment form up to FRAG_MAX_M rows (groupsize 128 suits it at
    every width), above it the tensor-core bodies: the wgmma body, which
    replaced the mma.sync tiles from WGMMA_MIN_M wherever it takes the
    shape (measured faster at every smoke M); the tiles forced cover K the
    same way."""
    assert WGMMA_MIN_M == FRAG_MAX_M + 1

    def want(m):
        return ("decode" if m <= DEC_MAX_M else "gemv" if m <= GEMV_MAX_M else
                "frag" if m <= FRAG_MAX_M else "wgmma")
    for m in range(1, 40):
        assert plan(m, k, n, bits, SMS).path == want(m)
    slabs = -(-k // matmul.TC_TILE_K)
    for m in SMOKE_MS:
        p = plan(m, k, n, bits, SMS)
        assert p.path == want(m)
        for q, tiles in ((p, WG_ROW_TILES), (plan(m, k, n, bits, SMS, path="tile"), TC_ROW_TILES)):
            if q.path in ("tile", "wgmma"):
                # the splits cover every 64-row slab, none is empty
                assert q.mt in tiles
                assert q.split * q.per_split >= slabs > (q.split - 1) * q.per_split


@pytest.mark.parametrize("k,n", SHAPES)
def test_kernel_1_tiles_fill_the_card_at_the_serving_chunk(k, n):
    """M = 100-136 at N = 4096 has one row of 32 tiles: the mma.sync tiles
    (two blocks an SM) split K until every SM has a block; the wgmma body
    (one block an SM) takes the split of the fewest waves x (slabs + 2)
    where its tiles fill at most half the SMs, one wave of blocks at N =
    4096 (4 ways: 128 blocks, measured fastest; 5 would start a second
    wave), and no split above (86 tiles at N = 11008, measured fastest);
    each split keeps at least 4 slabs."""
    slabs = -(-k // matmul.TC_TILE_K)
    for m in range(100, 137):
        p = plan(m, k, n, 4, SMS, path="tile")
        tiles = -(-n // matmul.TILE_N) * -(-m // p.mt)
        assert tiles * p.split >= SMS
        assert p.per_split >= 4
        w = plan(m, k, n, 4, SMS)
        tiles = -(-n // matmul.WG_COLS) * -(-m // w.mt)
        assert w.path == "wgmma" and w.per_split >= 4
        waves = -(-tiles * w.split // SMS)
        if tiles <= SMS // 2:
            assert all(waves * (w.per_split + 2) <= -(-tiles * s // SMS) * (-(-slabs // s) + 2)
                       for s in range(1, slabs // 4 + 1))
        else:   # 86 tiles at N = 11008: unsplit measured fastest
            assert w.split == 1
    assert plan(1024, 4096, 4096, 4, SMS, path="tile").split == 1   # 256 tiles: no split
    assert plan(1024, 4096, 4096, 4, SMS).split == 1   # 128 wgmma tiles of 256 rows: none


@pytest.mark.parametrize("m,want", [(5, 64), (9, 64), (64, 64), (65, 128), (100, 128), (128, 128),
                                    (129, 256), (136, 256), (256, 256), (512, 128),
                                    (1024, 128), (2048, 256), (16384, 256)])
def test_kernel_1_row_tile_covers_small_m_in_one_tile(m, want):
    """Up to 256 rows one row tile covers M; above that 256-row tiles where
    they alone give every SM a block (M >= 2048 at N = 4096), else 128. At
    M <= 16, where the dispatch takes the fragment form, the tiles forced."""
    assert plan(m, 4096, 4096, 4, SMS, path="tile").mt == want
    assert plan(m, 11008, 4096, 4, SMS, path="tile").mt == want


@pytest.mark.parametrize("k,n,m,want", [
    (4096, 4096, 100, (128, 8, 8)), (4096, 4096, 136, (256, 8, 8)),
    (4096, 4096, 512, (128, 2, 32)), (4096, 4096, 1024, (128, 1, 64)),
    (4096, 4096, 16384, (256, 1, 64)), (11008, 4096, 128, (128, 8, 22)),
    (11008, 4096, 512, (128, 2, 86)), (11008, 4096, 2048, (256, 1, 172)),
    (4096, 11008, 128, (128, 3, 22)), (4096, 11008, 1024, (256, 1, 64))])
def test_kernel_1_tile_plans_at_the_smoke_shapes(k, n, m, want):
    """The mma.sync tiles' row tile, K-splits and slabs per split at the
    shapes the smoke times (the fewest waves x (slabs per block + 2) among
    the splits that fill the card: 8 ways at the serving chunk, 2 at M =
    512, none above), forced: the wgmma body took these shapes over."""
    p = plan(m, k, n, 4, SMS, path="tile")
    assert p.path == "tile" and (p.mt, p.split, p.per_split) == want
    assert plan(m, k, n, 4, SMS).path == "wgmma"


def test_tile_path_needs_whole_16_byte_copies():
    """K or N not a multiple of 8 keeps the GEMV at any M (the tile path's
    copies move 8 bf16 or 4 words at a time)."""
    assert plan(512, 4100, 4096, 8, SMS).path == "gemv"
    assert plan(512, 4096, 4100, 4, SMS).path == "gemv"
    assert plan(512, 4096, 4104, 4, SMS).path == "wgmma"   # TMA's strides: multiples of 8 too
    assert plan(512, 4096, 4104, 4, SMS, groupsize=40).path == "tile"


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("streams,bm", [(1, 64), (1, 128), (1, 256), (2, 64), (2, 128)])
def test_tile_shared_memory_fits(bits, streams, bm):
    """The tile block asks for at most the 227 KB one block may have; at 2
    and 4 bits two blocks of 64 or 128 rows fit on an SM (228 KB each SM, 1
    KB of it reserved per block). Kernel 2's two streams share the block's
    128 B-tile columns (64 gate and 64 up columns of y), so its block has
    kernel 1's layout and fits the same: 110,592 B at 128 rows, two per SM."""
    smem = tile_smem_bytes(bits, bm)
    assert smem <= SMEM_PER_BLOCK
    two = 2 * (smem + 1024) <= SMEM_PER_SM
    assert tile_blocks_per_sm(bits, bm) == (2 if two and bm < 256 else 1)
    if bits < 8 and bm < 256:
        assert two
    if (bits, bm) == (4, 128):
        assert smem == 110592
    # the layout of csrc/qmm_tc.cuh: a ring of stages of x (bm x 72 bf16),
    # the words, 4 scale and 4 zero rows of 128 B-tile columns; two B tiles
    words = 64 * bits // 32 * 128 * 4
    stages = 4 if bm == 256 else 3
    assert smem == stages * (bm * 72 * 2 + words + 2 * 4 * 128 * 2) + 2 * 128 * 72 * 2
    for m in (bm // 2 + 1, bm):
        k, n = (4096, 4096) if streams == 1 else (4096, 11008)
        p = plan(m, k, n, bits, SMS, streams=streams, path="tile")
        if p.mt == bm:
            assert p.smem == smem


# kernel 2 (fused gate/up, 4096 x 11008) at every M of the smoke: path, row
# tile, K splits, packed words (gemv), K-blocks (frag) or 64-row slabs (wgmma)
# per split; and its tiles, forced, above 16 rows
KERNEL_2_PLANS = {1: ("decode", 3, 1, 64), 8: ("frag", 8, 1, 128), 100: ("wgmma", 128, 3, 22),
                  128: ("wgmma", 128, 3, 22), 136: ("wgmma", 144, 3, 22),
                  512: ("wgmma", 256, 1, 64), 1024: ("wgmma", 256, 1, 64),
                  2048: ("wgmma", 256, 1, 64), 16384: ("wgmma", 256, 1, 64)}
KERNEL_2_TILES = {100: ("tile", 128, 3, 22), 128: ("tile", 128, 3, 22), 136: ("tile", 256, 3, 22),
                  512: ("tile", 256, 1, 64), 1024: ("tile", 256, 1, 64),
                  2048: ("tile", 256, 1, 64), 16384: ("tile", 256, 1, 64)}


@pytest.mark.parametrize("m", SMOKE_MS)
def test_kernel_2_keeps_its_gemv_plan(m):
    """Kernel 2 takes the batch-1 decode form at M = 1 (3 strips of each
    weight a block, stages of 64 packed word rows of both), keeps its GEMV there (forced, or where the
    group size does not suit the decode form: the GEMV measured faster than
    the fragment form at M = 1, 32.17 against 38.55 us; at M = 2 the
    fragment form wins, 38.76 against 42.28; PERF.md), takes
    the register-fragment form at the serving decode step (M = 8, the
    fastest of the three forms there) and the Hopper body above (gate and
    up on its two consumer warpgroups: 64 columns of y a block, kernel 1's
    shared memory at the same row tile), at the row tile and split measured
    fastest (scripts/torch_qmm_bodies.py). The tiles, forced, keep kernel
    1's row tile over their 64-column tiles and a K split that turns the 172
    tiles of one row into two even waves at M = 100-136."""
    p = plan(m, 4096, 11008, 4, SMS, streams=2)
    assert p == Plan(*KERNEL_2_PLANS[m], p.smem)
    assert (p.path == "decode") == (m <= DEC_MAX_M)
    if m <= FUSED_GEMV_MAX_M:
        gemv = plan(m, 4096, 11008, 4, SMS, streams=2, path="gemv")
        assert gemv == Plan("gemv", 1, 4, 128, gemv.smem)
        assert plan(m, 4096, 11008, 4, SMS, streams=2, groupsize=40).path == "gemv"
    if p.path == "wgmma":
        assert p.smem == wgmma_smem_bytes(4, p.mt) <= SMEM_PER_BLOCK
        # 64 columns of y a block: kernel 1's 128-column tiles halved
        assert matmul.WG_COLS // 2 == 64 and -(-11008 // 64) == 172
        tile = plan(m, 4096, 11008, 4, SMS, streams=2, path="tile")
        assert tile == Plan(*KERNEL_2_TILES[m], tile.smem)
        assert tile.smem == tile_smem_bytes(4, tile.mt)
        # the same plan as kernel 1's tiles at the same columns of y (86
        # tiles of 128)
        assert tile == plan(m, 4096, 11008, 4, SMS, path="tile") or m >= 512


@pytest.mark.parametrize("k,n", [(4096, 11008), (512, 384), (1024, 256)])
@pytest.mark.parametrize("bits,gs", [(2, 64), (4, 128), (4, 32), (8, 32), (8, 16)])
def test_kernel_2_takes_the_fragment_form_up_to_16_rows(k, n, bits, gs):
    """At M = 1 kernel 2 takes the batch-1 decode form, from M = 2 to 16 the
    fragment form, where every K-block (4 packed word-rows, 128 / bits rows)
    lies in one group; its splits cover
    every K-block and each warp keeps at least two; one n8 tile of x's rows
    up to M = 8, two up to 16; from M = 17 the wgmma body (every group size
    here a multiple of 16), the tiles where ``wgmma_ok`` refuses the shape
    (a group size of 40)."""
    kb = 4 * (32 // bits)
    assert frag_ok(k, n, bits, gs) == (gs % kb == 0)
    for m in range(1, 40):
        p = plan(m, k, n, bits, SMS, streams=2, groupsize=gs)
        want = ("decode" if m <= DEC_MAX_M else "gemv" if m <= FUSED_GEMV_MAX_M else
                "frag" if m <= FRAG_MAX_M else "wgmma")
        assert p.path == want
        if m >= WGMMA_MIN_M:
            assert plan(m, k, n, bits, SMS, streams=2, groupsize=40).path == "tile"
        if p.path == "frag":
            kbs = -(-k // kb)
            assert p.mt == (8 if m <= 8 else 16)
            assert p.split * p.per_split >= kbs > (p.split - 1) * p.per_split
            assert p.split == 1 or p.per_split >= 2 * matmul.FRAG_WARPS
            assert p.smem == matmul.frag_smem_bytes(bits, p.mt // 8) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("gs", [40, 24, 6])
def test_kernel_2_group_sizes_the_fragment_form_does_not_take(gs):
    """A group size that puts a group boundary inside a K-block (groupsize
    40 at 4 bits: 32-row K-blocks) keeps the GEMV up to 16 rows; the tiles
    take such sizes above."""
    assert not frag_ok(520, 256, 4, gs)
    assert plan(8, 520, 256, 4, SMS, streams=2, groupsize=gs).path == "gemv"
    assert plan(100, 520, 256, 4, SMS, streams=2, groupsize=gs).path == "tile"
    with pytest.raises(ValueError):
        plan(17, 4096, 11008, 4, SMS, streams=2, path="frag")


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("nt", [1, 2])
def test_fragment_form_shared_memory(bits, nt):
    """qmm_frag.cuh's Layout: per warp 3 stages of the lanes' two words
    (32 B), their x slices (32 / bits bf16 per n8 tile) and 256 B of scales
    and zeros; 8 warps; then the buffer that receives the cluster's partials
    (2 streams x (8 nt rows x 32 columns + 16) fp32), kernels 1 and 2 alike.
    The blocks ``__launch_bounds__`` sizes the registers for fit an SM:
    three for one n8 tile of rows (the 7B serving step), two for two."""
    smem = matmul.frag_smem_bytes(bits, nt)
    ring = 8 * 3 * (32 * 32 + nt * 32 * 2 * (32 // bits) + 256)
    assert ring >= 8 * 2 * 8 * nt * 32 * 4   # the warps' sums fit the ring
    assert smem == ring + 4 * 2 * (8 * nt * 32 + CLUSTER_LIMIT)
    assert (3 if nt == 1 else 2) * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 4096), (4096, 11008), (512, 384),
                                 (1024, 256)])
@pytest.mark.parametrize("bits,gs", [(2, 64), (4, 128), (4, 32), (8, 32), (8, 16)])
def test_kernel_1_takes_the_fragment_form_up_to_16_rows(k, n, bits, gs):
    """Kernel 1 (one stream) takes the batch-1 decode form at M = 1 and the
    fragment form from M = 2 to 16 where every K-block (4 packed word-rows,
    128 / bits rows) lies in one group (the fragment form, forced, at M = 1
    too): a
    block covers 64 columns of y, one n8 tile of x's rows up to M = 8 and
    two up to 16; its splits cover every K-block, each warp keeps at least
    two, the cluster has at most CLUSTER_MAX blocks; the wgmma body from M =
    17 (every group size here a multiple of 16)."""
    kb = 4 * (32 // bits)
    assert frag_ok(k, n, bits, gs) == (gs % kb == 0)
    for m in range(1, 40):
        p = plan(m, k, n, bits, SMS, groupsize=gs)
        want = ("gemv" if m <= GEMV_MAX_M or (m <= FRAG_MAX_M and gs % kb) else
                "decode" if m <= DEC_MAX_M else "frag" if m <= FRAG_MAX_M else "wgmma")
        assert p.path == want
        if p.path == "decode":
            p = plan(m, k, n, bits, SMS, groupsize=gs, path="frag")
        if p.path == "frag":
            kbs = -(-k // kb)
            assert p.mt == (8 if m <= 8 else 16)
            assert p.split * p.per_split >= kbs > (p.split - 1) * p.per_split
            assert p.split == 1 or p.per_split >= 2 * matmul.FRAG_WARPS
            assert p.split & (p.split - 1) == 0 and p.split <= CLUSTER_MAX
            assert p.smem == matmul.frag_smem_bytes(bits, p.mt // 8) <= SMEM_PER_BLOCK
            # a split only where the column blocks alone leave SMs idle
            assert p.split == 1 or -(-n // 64) * p.split // 2 < SMS - SMS // 16


@pytest.mark.parametrize("gs", [40, 24, 6])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kernel_1_group_sizes_the_fragment_form_does_not_take(gs, bits):
    """A group size that puts a group boundary inside a K-block (40, 24 or 6
    rows against K-blocks of 64, 32 or 16) keeps kernel 1 on the GEMV up to
    16 rows; the mma.sync tiles take such sizes above (the wgmma body needs
    whole k16 steps in a group)."""
    k = 2 * 3 * 5 * 7 * 32   # whole packed words and K-blocks at every width
    assert not frag_ok(k, 256, bits, gs)
    for m in (1, 2, 8, 16):
        assert plan(m, k, 256, bits, SMS, groupsize=gs).path == "gemv"
    assert plan(17, k, 256, bits, SMS, groupsize=gs).path == "tile"


# the decode-width forms' K split at every width the smoke times, every bits,
# M = 1-16 and both kernels
DECODE_MS = (1, 2, 3, 4, 5, 8, 9, 16)


@pytest.mark.parametrize("k,n", SHAPES + ((512, 384), (1024, 256), (560, 256), (13824, 5120)))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("path", ["gemv", "frag"])
def test_decode_width_splits_cover_k_in_order(k, n, bits, streams, path):
    """One launch sums the K splits of the decode-width forms: the blocks of
    one cluster (a power of two, at most CLUSTER_MAX; at most CLUSTER_LIMIT
    when a measurement forces it) take consecutive runs of the packed words
    (GEMV) or K-blocks (fragments) in rank order, every run nonempty, and
    together they cover every one; each GEMV warp keeps at least one packed
    word and each fragment warp two K-blocks where K is split."""
    kw, kbs = k * bits // 32, -(-k // matmul.frag_rows_per_block(bits))
    make = matmul._gemv_plan if path == "gemv" else matmul._frag_plan
    for m in DECODE_MS:
        for cap in (CLUSTER_MAX, CLUSTER_LIMIT):
            p = make(m, k, n, bits, SMS, streams, cap=cap)
            units = kw if path == "gemv" else kbs
            assert p.path == path and p.split <= cap and p.split & (p.split - 1) == 0
            assert p.split * p.per_split >= units > (p.split - 1) * p.per_split
            runs = [(z * p.per_split, min(units, (z + 1) * p.per_split)) for z in range(p.split)]
            assert all(a < b for a, b in runs) and runs[-1][1] == units
            assert all(runs[i][1] == runs[i + 1][0] for i in range(p.split - 1))
            if p.split > 1:
                assert p.per_split >= (matmul.GEMV_WARPS if path == "gemv" else
                                       2 * matmul.FRAG_WARPS)
        assert make(m, k, n, bits, SMS, streams) == plan(m, k, n, bits, SMS, streams, path=path,
                                                          groupsize=128)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mt", [1, 2, 4, 8])
@pytest.mark.parametrize("streams", [1, 2])
def test_gemv_shared_memory(bits, mt, streams):
    """qmm_gemv.cuh's Layout: per warp a ring of 8 stages (4 with two
    streams), each of every lane's words and scales and zeros (16 + 16 B a
    stream) and mt rows of x over one word (2 * 32 / bits B each, padded to
    16 B); the warps' fp32 sums reuse the ring where they fit; then the
    cluster's receive buffer. Two blocks fit an SM."""
    stage = streams * 1024 + -(-mt * 64 // bits // 16) * 16
    ring = 8 * (8 if streams == 1 else 4) * stage
    red = 8 * streams * mt * 128 * 4
    smem = matmul.gemv_smem_bytes(bits, mt, streams)
    assert smem == max(ring, red) + 4 * streams * (mt * 128 + CLUSTER_LIMIT)
    assert 2 * (smem + 1024) <= SMEM_PER_SM
    assert plan(mt, 4096, 4096, bits, SMS, streams, path="gemv").smem == smem


def test_a_path_can_be_forced_for_measurement():
    assert plan(8, 4096, 4096, 4, SMS, path="tile").path == "tile"
    assert plan(512, 4096, 4096, 4, SMS).path == "wgmma"
    assert plan(512, 4096, 4096, 4, SMS, path="tile").path == "tile"
    assert plan(8, 4096, 4096, 4, SMS, path="wgmma").path == "wgmma"
    assert plan(8, 4096, 4096, 4, SMS, path="frag") == plan(8, 4096, 4096, 4, SMS)
    assert plan(512, 4096, 4096, 4, SMS, path="gemv") == plan(512, 4096, 4096, 4, SMS,
                                                              streams=1, path="gemv")
    assert plan(512, 4096, 4096, 4, SMS, path="gemv").mt == 8


# -- kernel 8, the grad-input dx (M, K) = g (M, N) @ dequant(W)^T --------------
from gptq_for_llama_tpu_torch.ops.cuda import matmul_t  # noqa: E402


@pytest.mark.parametrize("k,n,m,tile,wgmma", [
    (4096, 4096, 1, (64, 8, 8), None), (4096, 4096, 128, (128, 8, 8), (128, 4, 16)),
    (4096, 4096, 1024, (128, 1, 64), (256, 1, 64)), (4096, 4096, 2048, (256, 1, 64), (256, 1, 64)),
    (11008, 4096, 1, (64, 3, 22), None), (11008, 4096, 128, (128, 3, 22), (128, 1, 64)),
    (11008, 4096, 1024, (256, 1, 64), (256, 1, 64)),
    (11008, 4096, 2048, (256, 1, 64), (256, 1, 64)),
    (4096, 11008, 1, (64, 8, 22), None), (4096, 11008, 128, (128, 8, 22), (128, 4, 43)),
    (4096, 11008, 1024, (128, 1, 172), (256, 1, 172)),
    (4096, 11008, 2048, (256, 1, 172), (256, 1, 172))])
def test_kernel_8_plans_at_the_lora_widths(k, n, m, tile, wgmma):
    """Row tile, N-splits and 64-wide slices per split of kernel 8 at the
    three LoRA widths (q/k/v/o, down_proj's transpose: dx of width 11008,
    gate/up's: a reduction of 11008). From WGMMA_MIN_M rows the wgmma body
    (measured faster at every LoRA width and M): its row tile holds M up to
    256 rows, 256 above, and N is split to the fewest waves x (slices + 2)
    where dx's column tiles fill at most half the SMs (4 ways at M = 128 and
    K = 4096; none for dx's 86 column tiles at K = 11008, measured faster).
    Below, and forced, the mma.sync tiles: kernel 1's row tile over dx's
    128-wide column tiles; at the gradient check's M = 128 the 32 or 86
    tiles alone do not fill 132 SMs and N is split; from the training batch
    (M = 1024) up it is not."""
    p = matmul_t.plan(m, k, n, 4, SMS)
    assert p.path == ("wgmma" if wgmma else "tile")
    assert (p.mt, p.split, p.per_split) == (wgmma or tile)
    assert p.smem == (wgmma_smem_bytes if wgmma else matmul_t.tile_smem_bytes)(4, p.mt)
    t = matmul_t.plan(m, k, n, 4, SMS, path="tile")
    assert t.path == "tile" and (t.mt, t.split, t.per_split) == tile
    assert t.smem == matmul_t.tile_smem_bytes(4, t.mt)
    assert matmul_t.plan(m, k, n, 4, SMS, groupsize=40).path == "tile"


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 5, 64, 100, 128, 136, 300, 512, 1024, 2048, 16384])
def test_kernel_8_splits_cover_the_reduction_in_order(k, n, bits, m):
    """The splits take consecutive runs of N's 64-wide slices, each run
    nonempty and at least 4 slices long when N is split; with a split the
    tiles x splits fill every SM (the mma.sync tiles), or take the fewest
    waves (the wgmma body, one block an SM). The partial of split z covers
    slices [z * per, (z + 1) * per) and the second kernel sums z = 0, 1, ...
    in that order, so the plan alone fixes the order of the sums: dx is the
    same bytes on every launch."""
    slices = -(-n // matmul_t.SLICE_N)
    for path in ("tile", "wgmma"):
        p = matmul_t.plan(m, k, n, bits, SMS, path=path)
        assert p.path == path
        assert p.split * p.per_split >= slices > (p.split - 1) * p.per_split
        tiles = -(-k // matmul_t.TILE_K) * -(-m // p.mt)
        if p.split > 1:
            assert p.per_split >= 4 and tiles < 2 * SMS
            if path == "tile":
                assert tiles * p.split >= SMS and tiles < SMS
            else:
                waves = -(-tiles * p.split // SMS)
                assert waves * (p.per_split + 2) <= -(-tiles // SMS) * (slices + 2)
        assert p == matmul_t.plan(m, k, n, bits, SMS, path=path)
        if m <= 256:
            rows = TC_ROW_TILES if path == "tile" else WG_ROW_TILES
            assert p.mt == next(b for b in rows if m <= b)
    assert matmul_t.plan(m, k, n, bits, SMS).path == ("wgmma" if m >= WGMMA_MIN_M else "tile")


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("bm", TC_ROW_TILES)
def test_kernel_8_shared_memory_fits(bits, bm):
    """qmm_t.cu's Layout: a ring of stages (4 at BM = 256, else 3) of g's BM x
    64 tile (rows padded to 72), the slice's words (128 * bits / 32 rows x 64)
    and 4 scale and 4 zero rows of 64; then two 64 x 136 bf16 B tiles. One
    block fits; two fit on an SM at 2 and 4 bits below BM = 256."""
    smem = matmul_t.tile_smem_bytes(bits, bm)
    stages = 4 if bm == 256 else 3
    assert smem == stages * (bm * 72 * 2 + 128 * bits // 32 * 64 * 4 + 2 * 4 * 64 * 2) + \
        2 * 64 * 136 * 2
    assert smem <= SMEM_PER_BLOCK
    two = bm < 256 and 2 * (smem + 1024) <= SMEM_PER_SM
    assert matmul_t.blocks_per_sm(bits, bm) == (2 if two else 1)
    if bits < 8 and bm < 256:
        assert two


# -- the wgmma body of kernels 1 and 8 (csrc/qmm_wgmma.cuh) --------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gs", [16, 32, 48, 64, 128, 256, 40, 24, 6, 100])
def test_wgmma_body_takes_whole_k16_steps_in_a_group(bits, gs):
    """The wgmma body's shapes: every k16 step of kernel 1 (every warp's 16
    rows of W for kernel 8) in one group, so a group size that is a multiple
    of 16 or a single group (G = 1, any K); K and N multiples of 8 (TMA's
    16-byte strides); device bits 2, 4 and 8 (wire INT3 is stored as 4).
    Other shapes keep the mma.sync tiles, for both kernels."""
    k = 2 * 3 * 5 * 7 * 32
    assert wgmma_ok(k, 256, bits, gs, -(-k // gs)) == (gs % 16 == 0)
    assert wgmma_ok(k, 256, bits, k, 1) and wgmma_ok(520, 256, bits, 520, 1)
    assert not wgmma_ok(k, 252, bits, 128, -(-k // 128))
    assert not wgmma_ok(k + 4, 256, bits, 128, -(-(k + 4) // 128))
    assert not wgmma_ok(k, 256, 3, 128, -(-k // 128))
    want = "wgmma" if gs % 16 == 0 else "tile"
    assert plan(100, k, 256, bits, SMS, groupsize=gs).path == want
    assert matmul_t.plan(100, k, 256, bits, SMS, groupsize=gs).path == want


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("bm", WG_ROW_TILES)
def test_wgmma_shared_memory_fits(bits, bm):
    """qmm_wgmma.cuh's Layout: as many stages as fit, at most 8, of x's (g's)
    bm x 64 bf16 tile, the stage's packed words (64 x 128 weights) and 1 KB
    each of scale and zero rows; the barriers; 1 KB to align the stages to
    the 128-byte swizzle's atom. One block (384 threads) fits the 227 KB a
    block may have with a ring of at least 3 stages; each stage starts on a
    1 KB boundary."""
    smem = wgmma_smem_bytes(bits, bm)
    stage = bm * 64 * 2 + 64 * 128 * bits // 8 + 2 * 1024
    stages = (smem - 1024 - 128) // stage
    assert stages >= 3 and stage % 1024 == 0
    assert smem == min(8, (SMEM_PER_BLOCK - 128 - 1024) // stage) * stage + 128 + 1024
    assert smem <= SMEM_PER_BLOCK
    for kind, m in (("fwd", bm), ("bwd", bm)):
        p = (plan(m, 4096, 4096, bits, SMS) if kind == "fwd"
             else matmul_t.plan(m, 4096, 4096, bits, SMS))
        if p.mt == bm:
            assert p.smem == smem


@pytest.mark.parametrize("gs,groups", [(16, None), (32, None), (48, None), (64, None),
                                       (128, None), (1032, 1), (32, 33)])
def test_wgmma_stage_holds_the_groups_it_touches(gs, groups):
    """The scale and zero rows a stage holds (``wgmma_sz_rows``): the most
    groups a 64-row slab (kernel 1) or a block's 128 rows of W (kernel 8)
    touch, counted from the group of each row (a ragged last group read
    through min(r / groupsize, G - 1)); within the 4 rows of 256 bytes
    (kernel 1) or 8 rows of 128 bytes (kernel 8) the stage has room for."""
    k = 1032
    g = -(-k // gs) if groups is None else groups

    def touched(span):
        return max(len({min(r // gs, g - 1) for r in range(t, min(k, t + span))})
                   for t in range(0, k, span))
    for span, most in ((64, 4), (128, 8)):
        rows = wgmma_sz_rows(span, k, gs, g)
        assert rows == touched(span) <= most


@pytest.mark.parametrize("k,n", SHAPES + ((4096, 2048),))
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wgmma_splits_cover_the_reduction_in_order(k, n, bits):
    """Kernel 1's wgmma body at every M the smoke gives the linears and the
    ragged ones: the row tile is the smallest of 64, 128, 144, 256 that holds
    M (256 above, or 128 where its tiles pad fewer rows), the splits take
    consecutive runs of K's 64-row slabs, none empty, at least 4 slabs each
    when K is split, and where the tiles fill at most half the SMs the blocks
    (one an SM) take the fewest waves x (slabs + 2) of any split, elsewhere
    none; the plan alone fixes the order of the sums."""
    slabs = -(-k // matmul.WG_DEPTH)
    for m in (17, 40, 64, 100, 128, 130, 136, 200, 256, 300, 512, 1024, 2048, 16384):
        p = plan(m, k, n, bits, SMS)
        assert p.path == "wgmma" and p.smem == wgmma_smem_bytes(bits, p.mt)
        assert p.split * p.per_split >= slabs > (p.split - 1) * p.per_split
        if m <= 256:
            assert p.mt == next(b for b in WG_ROW_TILES if m <= b)
        else:
            assert p.mt in (128, 256) and -(-m // p.mt) * p.mt <= -(-m // 256) * 256
        tiles = -(-n // matmul.WG_COLS) * -(-m // p.mt)
        if p.split > 1:
            assert p.per_split >= 4
        cost = -(-tiles * p.split // SMS) * (p.per_split + 2)
        if tiles <= SMS // 2:   # from half the SMs' worth of tiles up K is not split
            assert all(cost <= -(-tiles * s // SMS) * (-(-slabs // s) + 2)
                       for s in range(1, max(1, slabs // 4) + 1))
        else:
            assert p.split == 1


@pytest.mark.parametrize("k,n", [(4096, 11008), (4096, 5504), (4096, 2816), (1024, 256),
                                 (4096, 4104)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kernel_2_wgmma_splits_cover_the_reduction_in_order(k, n, bits):
    """Kernel 2's wgmma body (two weight streams, 64 columns of y a block) at
    every M the smoke gives it and the ragged ones: kernel 1's row tiles and
    shared memory; the splits take consecutive runs of K's 64-row slabs, none
    empty, at least 4 slabs each when K is split, the same runs for the gate
    and up partials (one plan covers both streams: qmm_reduce_kernel<2>
    sums (2, split, M, N) in split order); the plan alone fixes the order of
    the sums, and a split is taken only where the 64-column tiles fill at
    most half the SMs or below two waves of them, there at most 2 ways at
    256-row tiles (``wgmma_split``)."""
    slabs = -(-k // matmul.WG_DEPTH)
    for m in (17, 40, 64, 100, 128, 130, 136, 200, 201, 256, 300, 512, 1024, 2048, 16384):
        p = plan(m, k, n, bits, SMS, streams=2)
        assert p.path == "wgmma" and p.smem == wgmma_smem_bytes(bits, p.mt)
        assert p.mt == matmul.wgmma_row_tile(m)
        assert p.split * p.per_split >= slabs > (p.split - 1) * p.per_split
        runs = [(z * p.per_split, min(slabs, (z + 1) * p.per_split)) for z in range(p.split)]
        assert all(a < b for a, b in runs) and runs[-1][1] == slabs
        assert all(runs[i][1] == runs[i + 1][0] for i in range(p.split - 1))
        if p.split > 1:
            assert p.per_split >= 4
        tiles = -(-n // 64) * -(-m // p.mt)
        assert p.split == matmul.wgmma_split(tiles, slabs, SMS, 2, p.mt)
        if p.split > 1:
            assert tiles <= SMS // 2 or (tiles < 2 * SMS and (p.mt <= 144 or p.split == 2))
        assert p == matmul.plan_of("wgmma", p.mt, p.split, k, bits, 2)


# the wgmma body's plans (row tile, K splits, slabs per split) at the smoke's
# shapes, each the fastest candidate measured there (scripts/torch_qmm_bodies.py)
WGMMA_PLANS = {
    (4096, 4096): {17: (64, 4, 16), 100: (128, 4, 16), 128: (128, 4, 16), 136: (144, 4, 16),
                   512: (256, 2, 32), 1024: (256, 1, 64), 2048: (256, 1, 64),
                   16384: (256, 1, 64)},
    (11008, 4096): {17: (64, 4, 43), 128: (128, 4, 43), 136: (144, 4, 43), 512: (256, 2, 86),
                    1024: (256, 1, 172), 2048: (256, 1, 172)},
    (4096, 11008): {128: (128, 1, 64), 1024: (256, 1, 64)},
    (4096, 2048): {128: (128, 8, 8)}}


@pytest.mark.parametrize("k,n", list(WGMMA_PLANS))
def test_kernel_1_form_at_the_smoke_shapes(k, n):
    """The form, row tile and split kernel 1 takes at the smoke's M (17,
    100, 128, 136, 512, 1024, 2048, 16384) and widths (LLaMA-7B's 4096 x
    4096, 11008 x 4096, 4096 x 11008 and tensor parallelism's q/k/v column
    shard 4096 x 2048): the wgmma body at the plan measured fastest."""
    for m, want in WGMMA_PLANS[(k, n)].items():
        p = plan(m, k, n, 4, SMS)
        assert (p.path, p.mt, p.split, p.per_split) == ("wgmma",) + want


# -- kernels 4 and 5, causal prefill attention: which body --------------------
from gptq_for_llama_tpu_torch.ops.cuda import flash_prefill  # noqa: E402


@pytest.mark.parametrize("sq,off,want", [
    (1, 0, "sync"), (32, 0, "sync"), (100, 0, "sync"), (128, 0, "sync"), (129, 0, "wgmma"),
    (512, 0, "wgmma"), (2048, 0, "wgmma"), (100, 28, "sync"), (100, 29, "wgmma"),
    (100, 128, "wgmma"), (128, 512, "wgmma"), (1, 2047, "wgmma")])
def test_flash_body_follows_the_causal_prefix(sq, off, want):
    """At D = 128 the 64-query mma.sync body takes a chunk whose whole causal
    prefix (offset + SQ) fits in one 128-key tile of the wgmma body: serving's
    admissions at bucket 32 and 128 and the runner's 100-token prompt, where
    it measured faster; everything longer takes the wgmma body. (The other
    head dims' crossovers: test_torch_head_dims.py.)"""
    assert flash_prefill.SYNC_MAX_KEYS[128] == 128
    assert flash_prefill.plan(sq, off) == want



# -- kernels 3 and 9, decode attention: the split plan -------------------------
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gptq_for_llama_tpu.ops.pallas import attention as jattn  # noqa: E402
from gptq_for_llama_tpu_torch.ops.cuda import attention  # noqa: E402
from gptq_for_llama_tpu_torch.ops.cuda.attention import (DecodePlan, decode_plan,  # noqa: E402
                                                         partial_floats)

# every row the smoke gives kernels 3 and 9: batch, kv heads, live bound
DECODE_B, DECODE_HKV = (1, 2, 8), (8, 32)
DECODE_LIVE = (1, 64, 65, 128, 256, 1501, 2048)


def chunk_bounds(plan: DecodePlan, live_row: int) -> list[tuple[int, int]]:
    """The (first, end) slots of each chunk with work for a row whose live
    bound is ``live_row``, in chunk order, as csrc/decode_attention_dense.cuh
    computes them: chunk z starts at z * chunk and ends a chunk later, the
    last one at the row's own bound; a chunk that starts at or past the bound
    exits at once and writes nothing."""
    out = []
    for z in range(plan.nsplit):
        first = z * plan.chunk
        end = live_row if z == plan.nsplit - 1 else min(live_row, first + plan.chunk)
        if first < end:
            out.append((first, end))
    return out


def _contiguous(bounds, live):
    assert bounds[0][0] == 0 and bounds[-1][1] == live
    for (_, end), (first, _) in zip(bounds, bounds[1:]):
        assert end == first


@pytest.mark.parametrize("live", DECODE_LIVE)
@pytest.mark.parametrize("hkv", DECODE_HKV)
@pytest.mark.parametrize("b", DECODE_B)
def test_decode_plan_covers_the_live_slots_in_whole_tiles(b, hkv, live):
    """Chunks are whole 32-slot tiles and cover [0, live) in order; at the
    bound every chunk has work and the last one reaches it; one pass (no
    combine, no partials) up to the ring's 128 slots; the partials are one
    accumulator row, max and denominator per (row, kv head, chunk, head)."""
    p = decode_plan(b, hkv, 4, live, SMS)
    assert p.chunk % attention.TILE == 0 and 1 <= p.nsplit <= attention.MAX_SPLIT
    bounds = chunk_bounds(p, live)
    assert len(bounds) == p.nsplit
    _contiguous(bounds, live)
    assert all(end - first == p.chunk for first, end in bounds[:-1])
    assert 0 < bounds[-1][1] - bounds[-1][0] <= p.chunk
    assert (p.nsplit == 1) == (live <= attention.RING * attention.TILE)
    assert partial_floats(b, hkv, 4, p) == (0 if p.nsplit == 1 else
                                            b * hkv * p.nsplit * 4 * (attention.HEAD_DIM + 2))


@pytest.mark.parametrize("bound,row", [(1, 300), (64, 2048), (128, 129), (300, 2048),
                                       (1501, 2048), (2048, 100)])
def test_a_row_past_the_plans_bound_is_read_in_full(bound, row):
    """A plan made for a smaller bound than a row's live length (a CUDA graph
    replayed at a longer length) still covers the row: its last chunk runs to
    the row's own bound. A row below the bound leaves the later chunks empty
    (their blocks exit at once)."""
    p = decode_plan(8, 32, 1, bound, SMS)
    bounds = chunk_bounds(p, row)
    _contiguous(bounds, row)
    assert len(bounds) == min(p.nsplit, -(-row // p.chunk))


@pytest.mark.parametrize("b,hkv,bound,lives", [
    (1, 32, 2048, (2048,)),        # kernel 3 at offset 2047
    (1, 32, 2047, (2047,)),        # kernel 9 there: the stale prefix
    (2, 8, 2048, (101, 1501)),     # kernel 3, GQA, per-row offsets planned for the cache
    (2, 8, 2048, (100, 1500))])    # kernel 9
def test_decode_plan_fills_the_card(b, hkv, bound, lives):
    """At the offset-2047 and GQA rows every SM gets a block with work, and
    the grid fits one wave of resident blocks."""
    p = decode_plan(b, hkv, 4, bound, SMS)
    assert hkv * sum(len(chunk_bounds(p, live)) for live in lives) >= SMS
    assert b * hkv * p.nsplit <= attention.BLOCKS_PER_SM * SMS


@pytest.mark.parametrize("b,hkv,live,want", [
    (1, 32, 1, (1, 32)), (1, 32, 128, (1, 128)), (1, 32, 129, (3, 64)), (1, 32, 266, (5, 64)),
    (1, 32, 2048, (11, 192)), (2, 8, 2048, (22, 96)), (8, 32, 1501, (8, 192)),
    (1, 32, 100000, (64, 1568))])
def test_decode_plans_at_the_smoke_rows(b, hkv, live, want):
    """The plans the smoke's rows take (batch-1 decode at offsets 0-265, the
    offset-2047, GQA and serving rows); a cache longer than 64 chunks of
    192 slots takes longer chunks (the combine stages 64)."""
    assert tuple(decode_plan(b, hkv, 1, live, SMS)) == want


LOG2E = np.float32(1.4426950408889634)


def _split_model(q, k, v, offs, scale, plan, fold=None, pool=None):
    """Kernels 3 and 9's arithmetic on the CPU, fp32: per (row, kv head, chunk)
    each of the 4 warps runs an online softmax in log2 units over its 8 slots
    of every 32-slot tile, the warps merge; one chunk writes the output, more
    write partials (accumulator, max, denominator: the kernel's layout) that
    the combine rescales and sums in chunk order, with the fold form's
    current token as one more slot. ``pool`` = (k_pool, v_pool, tables):
    kernel 7, the same arithmetic with each warp's 8 slots of a tile read
    through the one table entry of their block (k, v unused); a slice wholly
    past the live bound reads no entry. Returns (out, times each partial
    float was written)."""
    b, _, h, d = q.shape
    if pool is None:
        s, hkv = k.shape[1], k.shape[2]
    else:
        kp, vp, tables = pool
        bs, hkv = kp.shape[1], kp.shape[2]
        s = tables.shape[1] * bs
    g = h // hkv
    rows = b * hkv * plan.nsplit * g
    part = np.zeros(partial_floats(b, hkv, g, plan), np.float32)
    written = np.zeros(part.size, np.int32)
    out = np.zeros((b, 1, h, d), np.float32)
    tile, warp_slots = attention.TILE, attention.TILE // 4
    for bi in range(b):
        off = min(max(int(offs[bi]), 0), s - 1)
        live = off if fold is not None else off + 1
        for kv in range(hkv):
            qs = q[bi, 0, kv * g:(kv + 1) * g] * np.float32(scale) * LOG2E      # (G, D)
            if pool is None:
                def fetch(lo, hi, bi=bi, kv=kv):
                    return k[bi, lo:hi, kv], v[bi, lo:hi, kv]
            else:
                def fetch(lo, hi, bi=bi, kv=kv):   # one warp's slots: one block
                    assert lo % 8 == 0 and hi - lo <= 8 and lo // bs == (hi - 1) // bs
                    blk = tables[bi, lo // bs]
                    return kp[blk, lo % bs:lo % bs + hi - lo, kv], vp[blk, lo % bs:lo % bs + hi - lo, kv]
            lc = vn = None
            if fold is not None:
                lc = qs @ fold[0][bi, 0, kv]
                vn = fold[1][bi, 0, kv]
            chunks = []
            for first, end in chunk_bounds(plan, live):
                warps = []
                for w in range(4):
                    m = np.full(g, -np.inf, np.float32)
                    l_ = np.zeros(g, np.float32)
                    acc = np.zeros((g, d), np.float32)
                    for t0 in range(first, end, tile):
                        lo = t0 + w * warp_slots
                        hi = min(lo + warp_slots, end)
                        if lo >= hi:
                            continue
                        kr, vr = fetch(lo, hi)
                        x = qs @ kr.T                                              # (G, n)
                        m_new = np.maximum(m, x.max(axis=1))
                        alpha = np.exp2(m - m_new)
                        p = np.exp2(x - m_new[:, None])
                        l_ = l_ * alpha + p.sum(axis=1)
                        acc = acc * alpha[:, None] + p @ vr
                        m = m_new
                    warps.append((m, l_, acc))
                big = np.max([m for m, _, _ in warps], axis=0)
                e = [np.where(m == -np.inf, 0, np.exp2(m - big)).astype(np.float32)
                     for m, _, _ in warps]
                chunks.append((big, sum(ew * l_ for ew, (_, l_, _) in zip(e, warps)),
                               sum(ew[:, None] * acc for ew, (_, _, acc) in zip(e, warps))))
            if plan.nsplit > 1:   # the partials, at the kernel's indices
                for (big, l_, acc), (first, _) in zip(chunks, chunk_bounds(plan, live)):
                    row0 = ((bi * hkv + kv) * plan.nsplit + first // plan.chunk) * g
                    for gi in range(g):
                        for idx, val in ((slice((row0 + gi) * d, (row0 + gi + 1) * d), acc[gi]),
                                         (rows * d + row0 + gi, big[gi]),
                                         (rows * d + rows + row0 + gi, l_[gi])):
                            part[idx] = val
                            written[idx] += 1
            # the combine (or the single chunk's epilogue): chunk order
            top = np.max([c[0] for c in chunks] + ([lc] if lc is not None else []), axis=0)
            num = np.zeros((g, d), np.float32)
            den = np.zeros(g, np.float32)
            if lc is not None:
                den = np.exp2(lc - top)
                num = den[:, None] * vn[None, :]
            for big, l_, acc in chunks:
                wgt = np.exp2(big - top)
                num = num + wgt[:, None] * acc
                den = den + wgt * l_
            out[bi, 0, kv * g:(kv + 1) * g] = num / den[:, None]
    return out, written


def _decode_inputs(b, s, h, hkv, offs, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, 1, h, 128), (b, s, hkv, 128), (b, s, hkv, 128)))
    kn, vn = (rng.standard_normal((b, 1, hkv, 128)).astype(np.float32) for _ in range(2))
    return q, k, v, kn, vn, np.asarray(offs, np.int32)


# 64-slot chunks over the 300-slot cache (the combine runs), and a plan made
# for 128 slots, below most offsets (the last chunk runs to the row's own)
SPLIT_PLANS = {"whole cache": DecodePlan(5, 64), "bound below the offsets": DecodePlan(2, 64)}


@pytest.mark.parametrize("plan", sorted(SPLIT_PLANS))
@pytest.mark.parametrize("offs", [(5, 299), (0, 150)])
@pytest.mark.parametrize("h,hkv", [(8, 2), (8, 8)])
def test_split_model_matches_pallas_decode_attention(h, hkv, offs, plan):
    """Kernel 3's split and combine against the TPU package's decode
    attention in interpret mode, fp32: tests/test_torch_kernels.py's
    tolerance. G = 4 and G = 1."""
    q, k, v, _, _, off = _decode_inputs(2, 300, h, hkv, offs, seed=h + offs[0])
    got, written = _split_model(q, k, v, off, 128 ** -0.5, SPLIT_PLANS[plan])
    assert written.max() <= 1
    want = np.asarray(jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(off), 128 ** -0.5, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("plan", sorted(SPLIT_PLANS))
@pytest.mark.parametrize("offs", [(5, 299), (0, 150)])
@pytest.mark.parametrize("h,hkv", [(8, 2), (8, 8)])
def test_split_model_matches_pallas_fused_decode_attention(h, hkv, offs, plan):
    """Kernel 9's split and combine, the current token folded in as one more
    slot (offset 0: the output is v_new), against the TPU package's fused
    decode attention in interpret mode (no write), fp32."""
    q, k, v, kn, vn, off = _decode_inputs(2, 300, h, hkv, offs, seed=h + offs[0] + 1)
    got, written = _split_model(q, k, v, off, 128 ** -0.5, SPLIT_PLANS[plan], fold=(kn, vn))
    assert written.max() <= 1
    want, _, _ = jattn.fused_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, kn, vn, off)), 128 ** -0.5, interpret=True,
        write=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fold", [False, True])
def test_split_model_fills_the_partial_buffer(fold):
    """With every row at the plan's bound each chunk has work: the partials
    the kernel writes cover its scratch (``partial_floats``) exactly once."""
    plan = DecodePlan(5, 64)
    q, k, v, kn, vn, off = _decode_inputs(2, 300, 8, 2, (299, 299), seed=3)
    if fold:   # the stale prefix is slots below the offset: 299 live, 5 chunks
        _, written = _split_model(q, k, v, off, 0.09, plan, fold=(kn, vn))
    else:
        _, written = _split_model(q, k, v, off, 0.09, plan)
    assert written.size == partial_floats(2, 2, 4, plan) and (written == 1).all()


# -- kernel 7: kernel 3's body and plan, routed through the block tables -------
POOL_ROWS = [(8, 32, 1, 128, 16, 128), (8, 32, 1, 2048, 16, 128), (8, 32, 1, 1501, 16, 128),
             (8, 8, 4, 1501, 16, 128)]


@pytest.mark.parametrize("b,hkv,g,live,bs,mb", POOL_ROWS)
def test_kernel_7_takes_kernel_3s_plan(b, hkv, g, live, bs, mb):
    """At the smoke's pool rows (offsets 127, 2047, the serving offsets
    37..1500 with the engine's bound 1501, and their GQA form) kernel 7's
    plan is ``decode_plan`` at the same live bound, as kernel 3 over the
    gathered view; with no bound, the logical length MB * BS."""
    import torch
    q = torch.zeros(b, 1, hkv * g, 128)
    kp = torch.zeros(4, bs, hkv, 128)
    tables = torch.zeros(b, mb, dtype=torch.int32)
    assert attention.pool_plan_for(q, kp, tables, live, sms=SMS) == decode_plan(b, hkv, g, live, SMS)
    assert attention.pool_plan_for(q, kp, tables, None, sms=SMS) == decode_plan(b, hkv, g, mb * bs,
                                                                               SMS)
    assert not hasattr(attention, "pool_split_plan") and not hasattr(attention, "POOL_TILE")


def _pool_inputs(b, h, hkv, bs, mb, offs, seed):
    """A pool whose tables are a random permutation; the model's copy of the
    tables holds an out-of-range entry in every logical block past a row's
    live bound, so that reading one raises."""
    rng = np.random.RandomState(seed)
    nb = b * mb + 2
    kp, vp = (rng.standard_normal((nb, bs, hkv, 128)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((b, 1, h, 128)).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    off = np.asarray(offs, np.int32)
    guarded = tables.copy()
    for bi, o in enumerate(off):
        guarded[bi, o // bs + 1:] = 10 ** 6
    return q, kp, vp, tables, guarded, off


@pytest.mark.parametrize("plan", sorted(SPLIT_PLANS))
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
def test_pool_split_model_matches_pallas_pool_decode_attention(h, hkv, bs, plan):
    """Kernel 7's table-routed split and combine against the TPU package's
    pool_decode_attention in interpret mode, fp32, at tests/test_torch_kernels.py's
    tolerance: tables a random permutation, block sizes 8, 16 and 32, G = 4
    and G = 1, and a plan made for a bound below the rows' offsets (the last
    chunk runs to the row's own). JAX gets the clean tables: entries past a
    row's live bound are never read by the model."""
    mb = -(-320 // bs)
    q, kp, vp, tables, guarded, off = _pool_inputs(2, h, hkv, bs, mb, (5, 299), seed=bs + h)
    got, written = _split_model(q, None, None, off, 128 ** -0.5, SPLIT_PLANS[plan],
                                pool=(kp, vp, guarded))
    assert written.max() <= 1
    want = np.asarray(jattn.pool_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(off),
        128 ** -0.5, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_pool_split_model_equals_dense_model_on_the_gathered_view(bs):
    """Routing through the tables changes where each slot is read, not the
    order of the sums: on the gathered view the dense model gives the same
    bits (the card's kernels 7 and 3 likewise, tests/test_torch_cuda.py)."""
    mb = -(-320 // bs)
    q, kp, vp, tables, guarded, off = _pool_inputs(2, 8, 2, bs, mb, (100, 319), seed=bs)
    kd = kp[tables].reshape(2, mb * bs, 2, 128)
    vd = vp[tables].reshape(2, mb * bs, 2, 128)
    for plan in SPLIT_PLANS.values():
        dense, _ = _split_model(q, kd, vd, off, 0.09, plan)
        paged, _ = _split_model(q, None, None, off, 0.09, plan, pool=(kp, vp, guarded))
        assert np.array_equal(dense, paged)


# the batch-1 decode form at the smoke's shapes (K, N, streams): LLaMA-7B's
# q/k/v/o, down_proj and fused gate/up; its fused q/k/v; GPT-NeoX-20B's four
# linears; the TP shards (tp 2 and 4: q/k/v columns, o and the K-padded
# down_proj rows, gate/up) -> (strips of each weight a block, blocks, word
# rows a stage, consumer warps)
DECODE_SHAPES = {(4096, 4096, 1): (2, 128, 128, 16), (11008, 4096, 1): (2, 128, 128, 16),
                 (4096, 11008, 2): (3, 230, 64, 8), (4096, 12288, 1): (4, 192, 64, 8),
                 (6144, 18432, 1): (5, 231, 64, 8), (6144, 6144, 1): (3, 128, 128, 16),
                 (6144, 24576, 1): (6, 256, 64, 8), (24576, 6144, 1): (3, 128, 128, 16),
                 (4096, 2048, 1): (1, 128, 256, 16), (2048, 4096, 1): (2, 128, 128, 16),
                 (5632, 4096, 1): (2, 128, 128, 16), (2816, 4096, 1): (2, 128, 128, 16),
                 (4096, 1024, 1): (1, 64, 256, 16), (4096, 5504, 2): (2, 172, 64, 8),
                 (4096, 2816, 2): (2, 88, 64, 8)}


@pytest.mark.parametrize("k,n,streams", list(DECODE_SHAPES))
def test_decode_form_at_the_smoke_shapes(k, n, streams):
    """The batch-1 decode form (csrc/qmm_decode.cuh) at M = 1: the plan
    takes it at every shape of the smoke; its column tiles of 16 x strips
    cover N in one wave of blocks (one an SM with 16 consumer warps, two with
    8), none empty; its stages of word rows cover K in order, every warp's
    slice of a stage whole 8-row octets; a stage's scale rows hold every
    group its rows touch; its shared memory is the kernel's layout, within
    227 KB (half an SM's at two blocks an SM) with at least two stages; and
    K split across no block (one launch, no cluster)."""
    strips, blocks, rows, warps = DECODE_SHAPES[(k, n, streams)]
    groups = -(-k // 128)
    p = plan(1, k, n, 4, SMS, streams=streams)
    geo = matmul.decode_geometry(k, n, 4, SMS, streams, 128, groups)
    assert p == Plan("decode", geo.strips, 1, geo.rows, geo.smem) and p.split == 1
    assert (geo.strips, -(-n // (16 * geo.strips)), geo.rows, matmul.decode_warps(
        streams * geo.strips)) == (strips, blocks, rows, warps)
    cols = 16 * geo.strips
    assert blocks * cols >= n > (blocks - 1) * cols
    per_sm = 1 if warps == 16 else 2
    assert blocks <= per_sm * SMS
    assert rows % (8 * warps) == 0
    kw = k // 8
    n_st = -(-kw // rows)
    assert n_st * rows >= kw > (n_st - 1) * rows
    assert 2 <= geo.stages <= min(matmul.DEC_MAX_STAGES, n_st) or geo.stages == n_st == 1
    assert geo.sz_rows == max(min((min(kw, t + rows) * 8 - 1) // 128, groups - 1)
                              - min(t * 8 // 128, groups - 1) + 1 for t in range(0, kw, rows))
    assert geo.smem == matmul.decode_smem_bytes(streams, geo.strips, rows, geo.sz_rows, k,
                                                geo.stages)
    assert geo.smem <= (SMEM_PER_BLOCK if per_sm == 1 else SMEM_PER_SM // 2 - 1024)
    # the layout in csrc/qmm_decode.cuh: word boxes, scale and zero boxes,
    # x, the warps' sums, the barriers
    words = streams * geo.strips * rows * 64
    sz = -(-geo.sz_rows * cols * 2 // 128) * 128
    stage = -(-(words + streams * 2 * sz) // 1024) * 1024
    assert geo.smem == (1024 + geo.stages * stage + -(-k * 2 // 128) * 128
                        + warps * streams * cols * 4 + 2 * geo.stages * 8)


@pytest.mark.parametrize("gs,ok", [(128, True), (32, True), (64, True), (96, True), (40, False),
                                   (16, False)])
def test_decode_form_takes_the_fragment_forms_group_sizes(gs, ok):
    """The decode form needs every aligned 4-word-row block inside one group
    (the fragment form's ``frag_ok``: groupsize a multiple of 32 at 4 bits);
    other group sizes keep the GEMV at M = 1, and the form forced raises."""
    assert (matmul.decode_geometry(4096, 4096, 4, SMS, 1, gs, -(-4096 // gs)) is not None) == ok
    assert plan(1, 4096, 4096, 4, SMS, groupsize=gs).path == ("decode" if ok else "gemv")
    assert plan(1, 4096, 11008, 4, SMS, streams=2, groupsize=gs).path == (
        "decode" if ok else "gemv")
    if not ok:
        with pytest.raises(ValueError):
            plan(1, 4096, 4096, 4, SMS, groupsize=gs, path="decode")
    with pytest.raises(ValueError):
        plan(2, 4096, 4096, 4, SMS, path="decode")
