"""Kernel 8, the grad-input of the dequant-GEMM: dispatch, CUDA wrapper,
launch count and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/matmul.py:_qmm_t_kernel`` (entry
``quant_matmul_t_pallas``): ``dx = g @ dequant(W)^T``, the backward of every
frozen packed linear when adapters train. The kernel is ``csrc/qmm_t.cu``
(bf16 tensor cores; each 64-wide slice of W a block needs is dequantized into
shared memory as the TPU kernel does, ``c * s - z * s`` in fp32 rounded to
bf16, through a ``cp.async`` ring and two B tiles); its bound on the H100 at
training row counts is operations. ``plan`` picks the row tile from M and
splits N across blocks where the tiles alone do not fill the card. The plain
version is ``g @ lin.dequantize(g.dtype).T``.
"""

from __future__ import annotations

import ctypes

import torch

from . import autotune, build
from .grad import refuse_grad
from .matmul import (TC_MAX_GROUPS, Plan, SMEM_PER_SM, _sm_count, check_tensor, reduction_split,
                     row_tile)
from ..linear import PackedLinear

SOURCE = "gptq_for_llama_tpu_torch/csrc/qmm_t.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/matmul.py:260"


TILE_K = 128    # columns of dx (rows of W) per block
SLICE_N = 64    # reduction slice of N per step


def tile_smem_bytes(bits: int, bm: int) -> int:
    """Shared memory of one block (qmm_t.cu's ``Layout``): a ring of stages (4
    for BM = 256, else 3) of g's BM x 64 tile, the slice's packed words and
    its scale and zero rows; then two bf16 B tiles of 64 x 128. Rows padded
    by 8 bf16."""
    words = TILE_K * bits // 32 * SLICE_N * 4
    scale_zero = 2 * TC_MAX_GROUPS * SLICE_N * 2
    stage = bm * (SLICE_N + 8) * 2 + words + scale_zero
    return (4 if bm == 256 else 3) * stage + 2 * SLICE_N * (TILE_K + 8) * 2


def blocks_per_sm(bits: int, bm: int) -> int:
    """Resident blocks per SM: one at BM = 256, else two (the 128-register
    cap of ``__launch_bounds__``) where their shared memory fits."""
    if bm == 256:
        return 1
    return max(1, min(2, SMEM_PER_SM // (tile_smem_bytes(bits, bm) + 1024)))


def plan(m: int, k: int, n: int, bits: int, sms: int = 132) -> Plan:
    """How one launch of kernel 8 covers dx (M, K) = g (M, N) @ W^T: kernel
    1's row tile over dx's 128-wide column tiles, then N split across blocks
    where the tiles do not fill the card (the fp32 partials are summed in a
    fixed order by a second kernel). ``per_split`` counts 64-wide slices."""
    cols = -(-k // TILE_K)
    bm = row_tile(m, cols, sms)
    tiles = cols * -(-m // bm)
    split, _ = reduction_split(tiles, -(-n // SLICE_N), sms * blocks_per_sm(bits, bm), sms)
    return plan_of(bm, split, n, bits)


def plan_of(bm: int, split: int, n: int, bits: int) -> Plan:
    """The plan of kernel 8 with the free choices ``bm`` (the row tile) and
    ``split`` (blocks along N): each split's 64-wide slices, the split
    recounted so that none is empty, and the block's shared memory. Every
    plan of ``plan`` ends here, and so does a tuned one (``autotune``)."""
    slices = -(-n // SLICE_N)
    per = -(-slices // split)
    return Plan("tile", bm, -(-slices // per), per, tile_smem_bytes(bits, bm))


def quant_matmul_t_plain(g2: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """g2 (M, N) -> (M, K) in device row order (before the inverse perm)."""
    return g2 @ lin.dequantize(g2.dtype).T


def _entry():
    fn = build.library("qmm_t").gptq_qmm_t
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return fn


def plan_for(g2: torch.Tensor, lin: PackedLinear) -> Plan:
    """The plan ``qmm_t_cuda`` launches for g2 (M, N) on the card: the tuned
    one (``autotune.lookup``, kind "bwd"), else ``plan``'s."""
    m, sms = g2.shape[0], _sm_count(g2.device.index or 0)
    tuned = autotune.lookup("bwd", lin.in_features, lin.out_features, lin.bits, lin.groupsize,
                            m, sms, g2.device)
    return tuned or plan(m, lin.in_features, lin.out_features, lin.bits, sms)


def check_operands(g2: torch.Tensor, lin: PackedLinear) -> None:
    """What kernel 8 demands of g2 (M, N) and the packed weight; raises
    otherwise."""
    k, n = lin.in_features, lin.out_features
    if lin.bits not in (2, 4, 8) or n % 8 or k % (32 // lin.bits):
        raise ValueError(f"grad-input kernel takes device bits 2/4/8, out_features % 8 == 0 "
                         f"and whole packed words along K; got K={k}, N={n}, bits={lin.bits}")
    groups = lin.scales.shape[0]
    check_tensor(g2, "g", torch.bfloat16, (g2.shape[0], n))
    check_tensor(lin.qweight, "qweight", torch.int32, (k * lin.bits // 32, n))
    check_tensor(lin.scales, "scales", torch.bfloat16, (groups, n))
    check_tensor(lin.zeros, "zeros", torch.bfloat16, (groups, n))
    if g2.device != lin.qweight.device:
        raise ValueError(f"g on {g2.device}, weights on {lin.qweight.device}")


def qmm_t_cuda(g2: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """dx = g2 @ dequant(lin)^T on the card. g2: (M, N) bf16 with N % 8 == 0;
    device bits 2/4/8. Returns (M, K) bf16 in device row order."""
    refuse_grad("qmm_t", g2, lin.scales, lin.zeros)
    check_operands(g2, lin)
    if g2.shape[0] == 0:
        return torch.empty((0, lin.in_features), dtype=torch.bfloat16, device=g2.device)
    return _launch(g2, lin, plan_for(g2, lin))


def _launch(g2: torch.Tensor, lin: PackedLinear, p: Plan) -> torch.Tensor:
    """One launch of kernel 8 on checked operands under plan ``p`` (a
    measurement may pass another plan)."""
    m, k, n, groups = g2.shape[0], lin.in_features, lin.out_features, lin.scales.shape[0]
    out = torch.empty((m, k), dtype=torch.bfloat16, device=g2.device)
    partial = (torch.empty((p.split, m, k), dtype=torch.float32, device=g2.device)
               if p.split > 1 else None)
    err = _entry()(g2.data_ptr(), lin.qweight.data_ptr(), lin.scales.data_ptr(),
                   lin.zeros.data_ptr(), out.data_ptr(),
                   None if partial is None else partial.data_ptr(), m, k, n, groups,
                   lin.groupsize, lin.bits, p.mt, p.split, p.per_split, p.smem,
                   torch.cuda.current_stream(g2.device).cuda_stream)
    build.check(build.library("qmm_t"), err, "qmm_t")
    qmm_t_cuda.launches += 1
    return out


qmm_t_cuda.launches = 0


def quant_matmul_t(g: torch.Tensor, lin: PackedLinear) -> torch.Tensor:
    """Grad-input of ``quant_matmul``: g (..., N) -> dx (..., K) in the
    input's order. The kernel for a CUDA tensor, the plain version for a CPU
    tensor; then the inverse act-order permutation (the TPU package's
    quant_matmul_t_pallas; the port has no K padding to drop)."""
    lead, k = g.shape[:-1], lin.in_features
    g2 = g.reshape(-1, lin.out_features)
    dx = qmm_t_cuda(g2.contiguous(), lin) if g.is_cuda else quant_matmul_t_plain(g2, lin)
    if lin.perm is not None:
        dx = dx.index_select(-1, torch.argsort(lin.perm))
    return dx.reshape(*lead, k)
