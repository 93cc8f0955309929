"""Kernel 2, the fused gate/up SiLU MLP: dispatch, CUDA wrapper, launch count
and plain version.

Replaces ``gptq_for_llama_tpu/ops/pallas/mlp.py:_fused_kernel``: computes
``silu(x @ dequant(Wg)) * (x @ dequant(Wu))`` with x read once and both sums
kept in fp32 until the epilogue. The kernel is ``csrc/fused_mlp.cu`` with
five forms that ``matmul.plan(..., streams=2)`` picks from M and the group
size (``fused_mlp_cuda.forms`` counts their launches): the batch-1 decode
form of ``csrc/qmm_decode.cuh`` (NW = 2, ``"decode"``: a TMA ring of both
packed weights, each block the same columns of gate and up) for the
decode row, the one-launch GEMV of ``csrc/qmm_gemv.cuh`` for that row where
the group size does not suit it (``"gemv"``); up to 16
rows the weight dequantized straight into ``mma.sync`` fragments
(``csrc/qmm_frag.cuh``, ``"frag"``); above that the Hopper body of kernels 1
and 8 (``csrc/qmm_wgmma.cuh``, NW = 2, ``"wgmma"``: gate and up on its two
consumer warpgroups over one TMA ring of x) where ``matmul.wgmma_ok`` takes
the shape, else kernel 1's ``mma.sync`` tiles with the gate and up columns
interleaved in one B tile (``csrc/qmm_tc.cuh``, NW = 2, ``"tile"``).
``matmul.plan(..., streams=2, path=...)`` forces a form for a measurement
(``_launch``); ``GPTQ_TORCH_TUNE_OVERRIDE='mlp:K4096:N11008:M1024=wgmma,256,1'``
pins one (``autotune``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import autotune, build
from .grad import refuse_grad
from .matmul import (WG_DEPTH, Plan, _sm_count, check_packed, decode_launch_geometry, plan,
                     wgmma_ok, wgmma_sz_rows)
from ..linear import PackedLinear, quant_matmul_plain

SOURCE = "gptq_for_llama_tpu_torch/csrc/fused_mlp.cu"
REPLACES = "gptq_for_llama_tpu/ops/pallas/mlp.py:27"


def supports_fused(gate: PackedLinear, up: PackedLinear) -> bool:
    """Same bits, groupsize and shape, no bias, and the IDENTICAL input
    permutation: the kernel applies one perm (gate's) to x
    (gptq_for_llama_tpu/ops/pallas/mlp.py:102-129)."""
    same = (gate.bits == up.bits and gate.groupsize == up.groupsize
            and gate.in_features == up.in_features
            and gate.out_features == up.out_features
            and gate.scales.shape == up.scales.shape
            and gate.bias is None and up.bias is None)
    if not same or (gate.perm is None) != (up.perm is None):
        return False
    if gate.perm is not None:
        return gate.perm is up.perm or (gate.perm_sig is not None
                                         and gate.perm_sig == up.perm_sig)
    return True


def fused_mlp_plain(x: torch.Tensor, gate: PackedLinear, up: PackedLinear) -> torch.Tensor:
    """Plain version: two dequantize-then-matmuls and silu(g) * u in x's dtype."""
    g = quant_matmul_plain(x, gate, dtype=x.dtype)
    u = quant_matmul_plain(x, up, dtype=x.dtype)
    return F.silu(g) * u


_ENTRIES = {"decode": "gptq_fused_mlp_decode", "gemv": "gptq_fused_mlp",
            "frag": "gptq_fused_mlp_frag", "tile": "gptq_fused_mlp_tile",
            "wgmma": "gptq_fused_mlp_wgmma"}


def _entry(path: str):
    fn = getattr(build.library("fused_mlp"), _ENTRIES[path])
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * (9 if path in ("tile", "wgmma") else 8)
                       + [i] * (11 if path == "wgmma" else 10) + [p])
        fn.restype = ctypes.c_int
    return fn


def plan_for(x2: torch.Tensor, gate: PackedLinear) -> Plan:
    """The plan ``fused_mlp_cuda`` launches for x2 (M, K) on the card: the
    tuned one (``autotune.lookup``, kind "mlp"), else ``plan``'s."""
    m, sms = x2.shape[0], _sm_count(x2.device.index or 0)
    tuned = autotune.lookup("mlp", gate.in_features, gate.out_features, gate.bits,
                            gate.groupsize, m, sms, x2.device)
    return tuned or plan(m, gate.in_features, gate.out_features, gate.bits, sms, streams=2,
                         groupsize=gate.groupsize, groups=gate.scales.shape[0])


def fused_mlp_cuda(x2: torch.Tensor, gate: PackedLinear, up: PackedLinear) -> torch.Tensor:
    """silu(x2 @ dequant(gate)) * (x2 @ dequant(up)) on the card. x2: (M, K)
    bf16, already permuted; returns (M, N) bf16."""
    if not supports_fused(gate, up):
        raise ValueError("fused gate/up kernel: gate and up differ in bits, groupsize, "
                         "shape, bias or input permutation")
    refuse_grad("fused_mlp", x2, gate.scales, gate.zeros, up.scales, up.zeros)
    check_packed(gate, x2)
    check_packed(up, x2)
    if x2.shape[0] == 0:
        return torch.empty((0, gate.out_features), dtype=torch.bfloat16, device=x2.device)
    return _launch(x2, gate, up, plan_for(x2, gate))


def _launch(x2: torch.Tensor, gate: PackedLinear, up: PackedLinear, p: Plan) -> torch.Tensor:
    """One launch of kernel 2 on checked operands under plan ``p`` (a
    measurement may pass a plan with its path forced)."""
    m, k, n, groups = x2.shape[0], gate.in_features, gate.out_features, gate.scales.shape[0]
    if p.path == "decode":
        geo = decode_launch_geometry(x2, gate, p, streams=2)
        out = torch.empty((1, n), dtype=torch.bfloat16, device=x2.device)
        err = _entry("decode")(
            x2.data_ptr(), gate.qweight.data_ptr(), gate.scales.data_ptr(),
            gate.zeros.data_ptr(), up.qweight.data_ptr(), up.scales.data_ptr(),
            up.zeros.data_ptr(), out.data_ptr(), k, n, groups, gate.groupsize, gate.bits,
            geo.strips, geo.rows, geo.sz_rows, geo.stages, geo.smem,
            torch.cuda.current_stream(x2.device).cuda_stream)
        build.check(build.library("fused_mlp"), err, "fused_mlp (decode)")
        fused_mlp_cuda.launches += 1
        fused_mlp_cuda.forms["decode"] += 1
        return out
    if p.path == "wgmma" and not wgmma_ok(k, n, gate.bits, gate.groupsize, groups):
        raise ValueError(f"fused_mlp: the wgmma body does not take K={k}, N={n}, "
                         f"{gate.bits}-bit, groupsize {gate.groupsize} ({groups} groups)")
    tiled = p.path in ("tile", "wgmma")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    partial = (torch.empty((2, p.split, m, n), dtype=torch.float32, device=x2.device)
               if tiled and p.split > 1 else None)
    # the tiles' and the wgmma body's split sums fp32 partials in a second kernel
    scratch = (() if not tiled else (None if partial is None else partial.data_ptr(),))
    rows = p.mt // 8 if p.path == "frag" else p.mt
    sz_rows = ((wgmma_sz_rows(WG_DEPTH, k, gate.groupsize, groups),) if p.path == "wgmma"
               else ())
    err = _entry(p.path)(
        x2.data_ptr(), gate.qweight.data_ptr(), gate.scales.data_ptr(), gate.zeros.data_ptr(),
        up.qweight.data_ptr(), up.scales.data_ptr(), up.zeros.data_ptr(), out.data_ptr(),
        *scratch, m, k, n, groups, gate.groupsize, gate.bits, rows, p.split, p.per_split,
        *sz_rows, p.smem, torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(build.library("fused_mlp"), err, f"fused_mlp ({p.path})")
    fused_mlp_cuda.launches += 1
    fused_mlp_cuda.forms[p.path] += 1
    return out


fused_mlp_cuda.launches = 0
fused_mlp_cuda.forms = {"decode": 0, "gemv": 0, "frag": 0, "tile": 0,
                        "wgmma": 0}   # launches by form


def fused_mlp(x: torch.Tensor, gate: PackedLinear, up: PackedLinear) -> torch.Tensor:
    """silu(x @ dequant(gate)) * (x @ dequant(up)) for x (..., K): the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if not x.is_cuda:
        return fused_mlp_plain(x, gate, up)
    if gate.perm is not None:
        x = x.index_select(-1, gate.perm)   # identical perm: supports_fused
    lead = x.shape[:-1]
    y = fused_mlp_cuda(x.reshape(-1, gate.in_features).contiguous(), gate, up)
    return y.reshape(*lead, gate.out_features)
