"""Kernel 1, the dequant-GEMM: CUDA wrapper, launch count and plain version;
and the launch plans of kernels 1 and 2 (``plan``).

Replaces ``gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_kernel``. The kernel is
``csrc/qmm.cu`` with three forms that ``plan`` picks from M and the group
size: up to ``FRAG_MAX_M`` rows, the batch-1 decode row included, the weight
dequantized straight into ``mma.sync`` fragments (``csrc/qmm_frag.cuh``, one
stream), bound by the packed weight bytes; where the group size does not
suit them, the one-launch GEMV of ``csrc/qmm_gemv.cuh`` (a per-warp
``cp.async`` ring of the words, their scales and x; dot-then-scale per
group); both split K across the blocks of a thread block cluster, whose
partials meet in rank order in the same launch. Above that the tensor-core
tiles of ``csrc/qmm_tc.cuh``, bound by operations (the slab dequantized to
bf16 in shared memory, ``mma.sync`` with fp32 sums, a ``cp.async`` ring). The
plain version is ``ops.linear.quant_matmul_plain`` (dequantize to the compute
dtype, then matmul). Kernel 2 (``mlp.py``, two weight streams) takes its plan
from ``plan`` too, with the same three forms.
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
# HBM3, 700 W): kernel 1 takes the GEMV for M <= GEMV_MAX_M, kernel 2 for
# M <= FUSED_GEMV_MAX_M; both take the register-fragment form
# (csrc/qmm_frag.cuh) up to FRAG_MAX_M where the group size suits it (else
# the GEMV), the tiles above. Kernel 1's fragments beat its GEMV from M = 1
# (9.42 against 10.68 us at 4096 x 4096, 17.56 against 25.55 at 11008 x
# 4096); kernel 2's GEMV beats its fragments at M = 1 only (33.40 against
# 35.49 us, M = 2: 38.69 against 35.80)
GEMV_MAX_M = 0
FUSED_GEMV_MAX_M = 1
FRAG_MAX_M = 16
CLUSTER_MAX = 8       # blocks of one cluster the plans take
CLUSTER_LIMIT = 16    # the most the kernels take (above 8: the non-portable attribute)
GEMV_WARPS = 8
GEMV_STAGES = {1: 8, 2: 4}   # csrc/qmm_gemv.cuh's ring depth by streams
FRAG_COLS, FRAG_WARPS, FRAG_STAGES = 32, 8, 3   # csrc/qmm_frag.cuh's block and ring
# the tile path's row tiles, slab depth and staged groups: csrc/qmm_tc.cuh's
TC_ROW_TILES, TC_TILE_K, TC_MAX_GROUPS = (64, 128, 256), 64, 4
SMEM_PER_SM = 233472      # the H100's shared memory of one SM (1 KB of it per block reserved)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Plan(NamedTuple):
    path: str        # "gemv" (csrc/qmm_gemv.cuh), "frag" (csrc/qmm_frag.cuh) or
                     # "tile" (csrc/qmm_tc.cuh)
    mt: int          # rows per block: 1, 2, 4, 8 (gemv), 8, 16 (frag), 64, 128, 256 (tile)
    split: int       # blocks along K: one cluster (gemv, frag: partial sums added in
                     # rank order in the launch), or partials summed by a second kernel (tile)
    per_split: int   # packed words (gemv), K-blocks (frag) or 64-row slabs (tile) per split
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
                    balance: bool = False) -> tuple[int, int]:
    """How many blocks share one output tile's reduction, and how many
    64-deep slabs each takes. Fewer tiles than SMs split the reduction: the
    split that fills every SM and costs the fewest waves x (slabs per block +
    2, a block's start-up: the first two slabs' copies in flight), the
    smallest such split, each split keeping at least 4 slabs. ``slots``:
    resident blocks on the card. ``balance`` (kernel 2, whose 64-column
    tiles at M <= 256 are 1-2 waves of long blocks): below two waves of
    tiles, the split of that cost from 1 up, so that a wave and a third
    becomes two even waves of shorter blocks."""
    split = 1
    if tiles < sms or (balance and tiles < 2 * slots):
        hi = max(1, slabs // 4)
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
    if path != "tile":
        raise ValueError(f"kernel 1's forms are gemv, frag and tile, got {path!r}")
    slabs = -(-k // TC_TILE_K)
    per = -(-slabs // split)
    return Plan("tile", mt, -(-slabs // per), per, tile_smem_bytes(bits, mt))


def _tile_plan(m: int, k: int, n: int, bits: int, sms: int, streams: int) -> Plan:
    """``row_tile`` over N's column tiles (128 / streams columns of y each),
    then ``reduction_split`` along K."""
    cols = -(-n // (TILE_N // streams))
    bm = row_tile(m, cols, sms)
    tiles = cols * -(-m // bm)
    slots = sms * tile_blocks_per_sm(bits, bm)
    split, _ = reduction_split(tiles, -(-k // TC_TILE_K), slots, sms, balance=streams == 2)
    return plan_of("tile", bm, split, k, bits, streams)


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


def plan(m: int, k: int, n: int, bits: int, sms: int = 132, streams: int = 1,
         path: str | None = None, groupsize: int = 128) -> Plan:
    """How one launch of kernel 1 (``streams=1``) or kernel 2 (``streams=2``)
    covers (M, K) @ (K, N).

    The GEMV (``_gemv_plan``) up to ``GEMV_MAX_M`` (kernel 1) or
    ``FUSED_GEMV_MAX_M`` (kernel 2) rows; the fragment form (``_frag_plan``)
    up to ``FRAG_MAX_M`` where ``groupsize`` puts every K-block in one group
    (``frag_ok``), else the GEMV; above that the tiles (``_tile_plan``) when
    K and N are multiples of 8 (16-byte copies), else the GEMV. ``path``
    forces one (for measurements, through ``_launch``)."""
    if path is None:
        wide = k % 8 == 0 and n % 8 == 0
        if m <= (GEMV_MAX_M if streams == 1 else FUSED_GEMV_MAX_M):
            path = "gemv"
        elif m <= FRAG_MAX_M:
            path = "frag" if frag_ok(k, n, bits, groupsize) else "gemv"
        else:
            path = "tile" if wide else "gemv"
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


_ENTRIES = {"gemv": "gptq_qmm", "frag": "gptq_qmm_frag", "tile": "gptq_qmm_tile"}


def _entry(path: str):
    fn = getattr(build.library("qmm"), _ENTRIES[path])
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (7 if path == "tile" else 6) + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return fn


def plan_for(x2: torch.Tensor, lin: PackedLinear) -> Plan:
    """The plan ``qmm_cuda`` launches for x2 (M, K) on the card: the tuned
    one (``autotune.lookup``, kind "fwd"), else ``plan``'s."""
    m, sms = x2.shape[0], _sm_count(x2.device.index or 0)
    tuned = autotune.lookup("fwd", lin.in_features, lin.out_features, lin.bits, lin.groupsize,
                            m, sms, x2.device)
    return tuned or plan(m, lin.in_features, lin.out_features, lin.bits, sms,
                         groupsize=lin.groupsize)


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
    m, k, n = x2.shape[0], lin.in_features, lin.out_features
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    partial = (torch.empty((p.split, m, n), dtype=torch.float32, device=x2.device)
               if p.path == "tile" and p.split > 1 else None)
    # the tiles' split sums fp32 partials in a second kernel
    scratch = (() if p.path != "tile" else
               (None if partial is None else partial.data_ptr(),))
    rows = p.mt // 8 if p.path == "frag" else p.mt
    err = _entry(p.path)(
        x2.data_ptr(), lin.qweight.data_ptr(), lin.scales.data_ptr(), lin.zeros.data_ptr(),
        None if lin.bias is None else lin.bias.data_ptr(), out.data_ptr(), *scratch,
        m, k, n, lin.scales.shape[0], lin.groupsize, lin.bits, rows, p.split, p.per_split,
        p.smem, torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(build.library("qmm"), err, f"qmm ({p.path})")
    qmm_cuda.launches += 1
    qmm_cuda.forms[p.path] += 1
    return out


qmm_cuda.launches = 0
qmm_cuda.forms = {"gemv": 0, "frag": 0, "tile": 0}   # launches by form
