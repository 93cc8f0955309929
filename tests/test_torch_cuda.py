"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a) and nvcc; without one it skips.
The file imports nothing of JAX, so it also runs where only the port is
installed: ``python -m pytest tests/test_torch_cuda.py --noconftest`` (the
repository's conftest.py configures JAX).
"""

import json

import numpy as np
import pytest
import torch

from gptq_for_llama_tpu_torch.ops import cuda as kernels
from gptq_for_llama_tpu_torch.ops import kv_dtype
from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention, decode_attention_plain,
                                                         pool_decode_attention,
                                                         pool_decode_attention_plain)
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.ops.cuda.flash import (flash_prefill_blocked,
                                                     flash_prefill_blocked_plain)
from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import flash_prefill, flash_prefill_plain
from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import plan as flash_plan
from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp, fused_mlp_plain
from gptq_for_llama_tpu_torch.ops.cuda.norm import (add_rms_norm, add_rms_norm_plain, rms_norm,
                                                    rms_norm_plain)
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear, quant_matmul_plain
from gptq_for_llama_tpu_torch.ops.quant_matmul import quant_matmul
from gptq_for_llama_tpu_torch.quant import packing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def heuristic_plans(monkeypatch):
    """Kernels 1, 2 and 8 on their heuristic plans (GPTQ_TORCH_AUTOTUNE=0 for
    every runner and engine built here); a test of the race sets its own
    knobs. The tuner's state is reset before and after each test."""
    from gptq_for_llama_tpu_torch.ops.cuda import autotune
    monkeypatch.setenv(autotune.MODE_ENV, "0")
    autotune.reset_cache_for_tests()
    yield
    autotune.reset_cache_for_tests()


def _linear(k, n, bits, gs, seed, device, actorder=False, bias=False):
    rng = np.random.RandomState(seed)
    g = -(-k // gs)
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if actorder:
        p = rng.permutation(k)
        codes, g_idx = codes[p], g_idx[p]
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    return PackedLinear.from_wire(packing.pack_rows(codes, bits),
                                  packing.pack_cols(zeros - 1, bits),
                                  (rng.rand(g, n) * 0.02 + 0.005).astype(np.float16), g_idx,
                                  bits=bits, bias=rng.randn(n) if bias else None,
                                  dtype=torch.bfloat16, device=device)


def _close(got, want, rel):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def _row_rel(got, want):
    """Largest over output rows of |got - want| / |want|."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max()


def _rows_close(got, want, rel):
    """Every output row (all indices but the last) within ``rel`` of its own
    norm: a causal row i averages i + 1 values, so its size falls like
    1/sqrt(i + 1), and a bound on the largest value would let late rows
    carry errors as large as themselves."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()) <= rel


@pytest.mark.cuda
@pytest.mark.parametrize("bits,m,k,gs,actorder", [
    (4, 1, 4096, 128, False), (4, 37, 1024, 128, True), (2, 3, 512, 128, False),
    (8, 9, 512, 128, False), (3, 2, 512, 128, False), (4, 5, 520, 40, False),
    (4, 100, 1024, 1024, False)])
def test_qmm_matches_plain(card, bits, m, k, gs, actorder):
    """2e-2 * max|y|: the plain version rounds the dequantized weight to bf16
    before its matmul; the GEMV keeps it in fp32, the fragment form (M <= 16)
    and the tiles round it as the plain version does and sum in another
    order."""
    lin = _linear(k, 256, bits, gs, seed=m, device=card, actorder=actorder)
    x = torch.randn(m, k, device=card).bfloat16()
    assert _close(quant_matmul(x, lin), quant_matmul_plain(x, lin), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,m,k,n,gs,actorder,bias", [
    (4, 100, 1024, 512, 128, False, False), (2, 130, 1024, 256, 64, False, False),
    (8, 512, 512, 264, 128, False, False), (3, 130, 512, 256, 128, False, False),
    (4, 100, 520, 256, 40, False, False), (2, 130, 560, 256, 40, False, False),
    (4, 512, 1024, 256, 1024, False, False), (4, 130, 1024, 256, 128, True, False),
    (4, 100, 1024, 256, 128, False, True), (4, 130, 512, 11008, 128, False, False),
    (4, 100, 512, 128, 6, False, False), (8, 512, 1024, 512, 32, True, True),
    (4, 40, 520, 256, 40, False, True), (8, 200, 1024, 264, 128, True, False),
    (2, 256, 560, 512, 40, True, True),
    # wide enough that the plan does not split K
    (4, 1024, 1024, 4096, 128, False, False), (2, 1024, 560, 4096, 40, False, False),
    (8, 1024, 1024, 4104, 32, True, True), (4, 2048, 512, 4096, 1024, False, False),
    (3, 300, 1024, 8192, 128, False, True)])
def test_qmm_tile_path_matches_plain(card, bits, m, k, n, gs, actorder, bias):
    """Kernel 1's tensor-core bodies (M > 16) through the dispatch: 2, 4
    and 8 bits and wire INT3; groupsize 40 (at 2 bits a group boundary falls
    inside a packed word), a ragged K slab (520, 560), G = 1, groupsize 6 (a
    slab touches more groups than the stage holds: scales from device memory);
    act-order, a bias, a ragged column tile (264, 4104) and N = 11008. The
    group sizes that are multiples of 16 (and G = 1) take the wgmma body (row
    tiles 64, 128, 144, 256), the others the mma.sync tiles. Where the plan
    splits K (fp32 partials summed by a second kernel) the output is held to
    2e-2 * max|y|, as the GEMV; where it does not, both bodies sum the k16
    products in cuBLAS's order and the product is bit-equal to the plain
    version (with a bias, on the same linear without it: the plain version
    rounds the product to bf16 before adding the bias)."""
    import dataclasses
    from gptq_for_llama_tpu_torch.ops.cuda import matmul
    from gptq_for_llama_tpu_torch.ops.cuda.matmul import plan_for
    lin = _linear(k, n, bits, gs, seed=m + k, device=card, actorder=actorder, bias=bias)
    x = torch.randn(m, k, device=card).bfloat16()
    kernels.reset_launch_counts()
    got = quant_matmul(x, lin)
    torch.cuda.synchronize()
    p = plan_for(x, lin)
    body = ("wgmma" if matmul.wgmma_ok(k, n, lin.bits, lin.groupsize, lin.scales.shape[0])
            else "tile")
    assert kernels.launch_counts()["qmm"] == 1 and p.path == body
    assert kernels.launch_counts()[f"qmm:{body}"] == 1
    assert torch.isfinite(got.float()).all()
    assert _close(got, quant_matmul_plain(x, lin), 2e-2)
    if p.split == 1:
        bare = dataclasses.replace(lin, bias=None)
        assert torch.equal(quant_matmul(x, bare), quant_matmul_plain(x, bare))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 5, 8, 64])
def test_qmm_paths_agree_where_both_run(card, m):
    """Kernel 1's forms, forced, at M on either side of the thresholds (the
    fragment form up to 16 rows; the two tensor-core bodies at any M): each
    within 2e-2 * max|y| of the plain version."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul
    lin = _linear(1024, 512, 4, 128, seed=m, device=card, bias=True)
    x = torch.randn(m, 1024, device=card).bfloat16()
    want = quant_matmul_plain(x, lin)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for path in ("gemv", "tile", "wgmma") + (("frag",) if m <= matmul.FRAG_MAX_M else ()):
        p = matmul.plan(m, 1024, 512, 4, sms, path=path)
        assert p.path == path
        assert _close(matmul._launch(x, lin, p), want, 2e-2), path


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 20])
def test_fused_mlp_matches_plain(card, m):
    gate = _linear(512, 384, 4, 128, seed=1, device=card)
    up = _linear(512, 384, 4, 128, seed=2, device=card)
    x = torch.randn(m, 512, device=card).bfloat16()
    assert _close(fused_mlp(x, gate, up), fused_mlp_plain(x, gate, up), 2e-2)


def _gate_up(card, k, n, bits, gs, actorder):
    """Gate and up linears sharing one act-order permutation (as a GPTQ
    checkpoint's two MLP inputs do: the same Hessian order), else none."""
    gate = _linear(k, n, bits, gs, seed=k + bits, device=card, actorder=actorder)
    if not actorder:
        return gate, _linear(k, n, bits, gs, seed=k + bits + 1, device=card)
    rng = np.random.RandomState(k + bits + 1)
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    zeros = rng.randint(1, 2 ** bits, size=(gate.scales.shape[0], n)).astype(np.uint32)
    up = PackedLinear.from_wire(packing.pack_rows(codes, bits), packing.pack_cols(zeros - 1, bits),
                                (rng.rand(*zeros.shape) * 0.02 + 0.005).astype(np.float16),
                                gate.g_idx, bits=bits, dtype=torch.bfloat16, device=card)
    return gate, up


# (bits, K, N, groupsize, act-order): 2, 4 and 8 bits, wire INT3, ragged
# last groups (K = 1144: 9 groups of 128, the last 120 rows, and a last
# K-block half past K; K = 1056: groups of 118 as the wire derives them,
# which the wgmma body does not take), groupsize 40 (a boundary inside a
# packed word at 2 bits; neither the fragment form nor the wgmma body takes
# it), g16 and g32, act-order with gate and up sharing one permutation, a
# ragged last column block (264), and the tensor-parallel gate/up shards of
# LLaMA-7B: 4096 x 5504 (tp 2) and 4096 x 2816 (tp 4, its last 64 columns
# zero: scales and zeros 0, as tp_model pads a shard)
KERNEL_2_CASES = [(4, 1024, 512, 128, False), (2, 1024, 256, 64, False), (8, 512, 264, 32, False),
                  (3, 512, 256, 128, False), (4, 1144, 256, 128, False), (4, 1056, 256, 128, False),
                  (2, 560, 256, 40, False), (4, 1024, 512, 128, True), (8, 1024, 264, 128, True),
                  (4, 512, 256, 16, False), (4, 4096, 5504, 128, False),
                  (4, 4096, 2816, 128, False)]


def _zero_last_columns(lin, pad):
    """``lin`` with its last ``pad`` columns' scales and zeros 0: those
    columns dequantize to exactly 0, as a padded TP shard's do."""
    import dataclasses
    keep = torch.ones(lin.out_features, dtype=lin.scales.dtype, device=lin.scales.device)
    keep[-pad:] = 0
    return dataclasses.replace(lin, scales=(lin.scales * keep).contiguous(),
                               zeros=(lin.zeros * keep).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("bits,k,n,gs,actorder", KERNEL_2_CASES)
@pytest.mark.parametrize("m", [5, 8, 17, 100, 128, 136, 201, 1024])
def test_fused_mlp_forms_match_plain(card, bits, k, n, gs, actorder, m):
    """Kernel 2's tensor-core forms above 16 rows, forced: the mma.sync tiles
    (NW = 2, gate and up interleaved in one B tile) and, where
    ``matmul.wgmma_ok`` takes the shape, the Hopper body (gate and up on its
    two consumer warpgroups); up to 16 rows its fragment form; and the
    dispatch (the plan's form), against fused_mlp_plain: 1e-2 of each output
    row's norm and 2e-2 * max|y| (both sides sum in fp32 and round once to
    bf16; the plain version rounds g and u to bf16 before silu(g) * u). Each
    forced form launched twice is bit-equal, and a CUDA-graph replay of it
    bit-equal to the eager launch; a zero column is exactly 0. The readings
    are printed."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
    gate, up = _gate_up(card, k, n, bits, gs, actorder)
    if n == 2816:
        gate, up = _zero_last_columns(gate, 64), _zero_last_columns(up, 64)
    assert mlp.supports_fused(gate, up)
    x = torch.randn(m, k, device=card).bfloat16()
    want = fused_mlp_plain(x, gate, up)
    xp = x if gate.perm is None else x.index_select(-1, gate.perm).contiguous()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    groups = gate.scales.shape[0]
    wg = matmul.wgmma_ok(k, n, gate.bits, gate.groupsize, groups)
    forms = (["tile"] + (["wgmma"] if wg else [])
             + (["frag"] if m <= matmul.FRAG_MAX_M and
                matmul.frag_ok(k, n, gate.bits, gate.groupsize) else []))
    kernels.reset_launch_counts()
    for path in forms:
        p = matmul.plan(m, k, n, gate.bits, sms, streams=2, path=path, groupsize=gate.groupsize,
                        groups=groups)
        run = lambda: mlp._launch(xp, gate, up, p)   # noqa: E731
        got, again = run(), run()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = run()
        graph.replay()
        torch.cuda.synchronize()
        rel = float(_row_rel(got, want))
        print(f"kernel 2 {path} bits={bits} K={k} N={n} gs={gs} act={actorder} M={m} "
              f"[row tile {p.mt}, split {p.split}]: worst row rel {rel:.3e}")
        assert torch.isfinite(got.float()).all() and rel <= 1e-2, path
        assert _close(got, want, 2e-2), path
        assert torch.equal(got, again) and torch.equal(replayed, got), path
        if n == 2816:
            assert not got[:, -64:].any(), path
    got = fused_mlp(x, gate, up)
    assert float(_row_rel(got, want)) <= 1e-2
    counts = kernels.launch_counts()
    assert counts["fused_mlp"] == 4 * len(forms) + 1
    form = ("gemv" if m <= matmul.FUSED_GEMV_MAX_M else "frag" if m <= matmul.FRAG_MAX_M
            and matmul.frag_ok(k, n, gate.bits, gate.groupsize) else "gemv"
            if m <= matmul.FRAG_MAX_M else "wgmma" if wg else "tile")
    assert counts[f"fused_mlp:{form}"] == 1 + 4 * forms.count(form)


# twice the largest worst-row gap measured on the card between kernel 2's
# tensor-core forms and its GEMV, both forced (3.744e-3, 4096 x 11008 at
# M = 16384; 3.0e-3 to 3.7e-3 at every M of chip_smoke.py; PERF.md section 6,
# PR 8): both keep fp32 sums to the epilogue; the tensor-core forms round the
# weight to bf16 as the plain version does, the GEMV keeps it in fp32
GEMV_GAP = 7.5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 5, 8, 16, 17, 100, 136, 201])
def test_fused_mlp_tensor_core_forms_agree_with_the_gemv(card, m):
    """Kernel 2's tensor-core forms (the tiles, the wgmma body and, up to 16
    rows, the fragments) against its GEMV forced through a plan, at 4096 x
    11008 INT4-g128 (the 7B shape): within GEMV_GAP of each output row's
    norm. The reading is printed."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
    gate = _linear(4096, 11008, 4, 128, seed=5, device=card)
    up = _linear(4096, 11008, 4, 128, seed=6, device=card)
    x = torch.randn(m, 4096, device=card).bfloat16()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    gemv = mlp._launch(x, gate, up, matmul.plan(m, 4096, 11008, 4, sms, streams=2, path="gemv"))
    for path in ("tile", "wgmma", "frag") if m <= matmul.FRAG_MAX_M else ("tile", "wgmma"):
        got = mlp._launch(x, gate, up, matmul.plan(m, 4096, 11008, 4, sms, streams=2, path=path))
        rel = float(_row_rel(got, gemv))
        print(f"kernel 2 {path} vs gemv M={m}: worst row rel {rel:.3e}")
        assert rel <= GEMV_GAP, path


# (bits, K, N, groupsize, act-order, bias) of the decode-width forms: 2, 4
# and 8 bits; a ragged last group (K = 1144: 9 groups of 128, the last 120
# rows); group sizes the fragment form refuses, whose boundaries cut packed
# words (40; K = 576 in groups of 128, which the wire derives as 5 groups of
# 116); act-order; a bias; N = 264 (a ragged column block) and 4096 x 4096
DECODE_CASES_K1 = [(4, 1024, 512, 128, False, True), (2, 1024, 256, 64, False, False),
                   (8, 512, 264, 32, True, True), (4, 1144, 256, 128, False, False),
                   (4, 576, 256, 128, False, True), (4, 520, 256, 40, True, False),
                   (2, 560, 256, 40, False, True), (4, 4096, 4096, 128, False, False)]


def _decode_forms(matmul, k, n, bits, gs):
    """The decode-width forms that take the shape: the GEMV always, the
    fragment form where its group size suits it."""
    return ("gemv",) + (("frag",) if matmul.frag_ok(k, n, bits, gs) else ())


@pytest.mark.cuda
@pytest.mark.parametrize("bits,k,n,gs,actorder,bias", DECODE_CASES_K1)
def test_qmm_decode_forms_match_plain(card, bits, k, n, gs, actorder, bias):
    """Kernel 1's decode-width forms (the one-launch GEMV of qmm_gemv.cuh, the
    one-stream fragment form of qmm_frag.cuh), forced at M = 1-16 and at
    every cluster split the plans take (1 to 16 blocks along K), and the
    dispatch: within 2e-2 * max|y| of the plain version, finite, and two
    launches on the same inputs bit-identical (the split sums run in a fixed
    order)."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul
    lin = _linear(k, n, bits, gs, seed=k + bits, device=card, actorder=actorder, bias=bias)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m in (1, 2, 3, 4, 5, 8, 9, 16):
        x = torch.randn(m, k, device=card).bfloat16()
        xp = x if lin.perm is None else x.index_select(-1, lin.perm).contiguous()
        want = quant_matmul_plain(x, lin)
        for path in _decode_forms(matmul, k, n, lin.bits, lin.groupsize):
            make = matmul._gemv_plan if path == "gemv" else matmul._frag_plan
            for cap in (1, 2, 4, 8, 16):
                p = make(m, k, n, lin.bits, sms, 1, cap=cap)
                got = matmul._launch(xp, lin, p)
                again = matmul._launch(xp, lin, p)
                torch.cuda.synchronize()
                what = f"{path} M={m} split {p.split}"
                assert torch.isfinite(got.float()).all() and _close(got, want, 2e-2), what
                assert torch.equal(got, again), what
        kernels.reset_launch_counts()
        assert _close(quant_matmul(x, lin), want, 2e-2)
        form = matmul.plan_for(xp, lin).path
        assert kernels.launch_counts()[f"qmm:{form}"] == 1 and form != "tile"


@pytest.mark.cuda
@pytest.mark.parametrize("bits,k,n,gs,actorder", [(4, 1024, 512, 128, False),
                                                  (2, 1024, 256, 64, False),
                                                  (4, 1024, 264, 64, False),
                                                  (8, 512, 256, 32, True),
                                                  (4, 1144, 256, 128, False),
                                                  (4, 520, 256, 40, True)])
def test_fused_mlp_decode_forms_match_plain(card, bits, k, n, gs, actorder):
    """Kernel 2's GEMV (two streams, one launch) and its fragment form,
    forced at M = 1-16 and every cluster split, and the dispatch: within 1e-2
    of each output row's norm of the plain version (as the other forms of
    kernel 2), and two launches bit-identical."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
    gate, up = _gate_up(card, k, n, bits, gs, actorder)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m in (1, 2, 5, 8, 16):
        x = torch.randn(m, k, device=card).bfloat16()
        xp = x if gate.perm is None else x.index_select(-1, gate.perm).contiguous()
        want = fused_mlp_plain(x, gate, up)
        for path in _decode_forms(matmul, k, n, gate.bits, gate.groupsize):
            make = matmul._gemv_plan if path == "gemv" else matmul._frag_plan
            for cap in (1, 2, 4, 8, 16):
                p = make(m, k, n, gate.bits, sms, 2, cap=cap)
                got = mlp._launch(xp, gate, up, p)
                again = mlp._launch(xp, gate, up, p)
                torch.cuda.synchronize()
                what = f"{path} M={m} split {p.split}"
                assert torch.isfinite(got.float()).all() and _row_rel(got, want) <= 1e-2, what
                assert torch.equal(got, again), what
        assert _row_rel(fused_mlp(x, gate, up), want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("path", ["gemv", "frag"])
def test_decode_forms_replay_bit_equal_in_a_graph(card, streams, path):
    """A CUDA-graph replay of each decode-width form (kernel 1 and kernel 2,
    the GEMV and the fragment form, every split from 1 to 16, M = 1 and 8)
    equals its eager launch bit for bit, replayed twice and after the input
    changed in place (the graph reads x, and writes y, at the captured
    addresses)."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
    k, n = 1024, 512
    gate, up = _gate_up(card, k, n, 4, 128, False)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    make = matmul._gemv_plan if path == "gemv" else matmul._frag_plan
    for m in (1, 8):
        x = torch.randn(m, k, device=card).bfloat16()
        for cap in (1, 2, 4, 8, 16):
            p = make(m, k, n, 4, sms, streams, cap=cap)
            run = ((lambda: matmul._launch(x, gate, p)) if streams == 1 else
                   (lambda: mlp._launch(x, gate, up, p)))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = run()
            for _ in range(2):
                g.replay()
                torch.cuda.synchronize()
                assert torch.equal(y, run()), f"M={m} split {p.split}"
            x.copy_(torch.randn_like(x))
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, run()), f"M={m} split {p.split}, new x"


# (bits, K, N, groupsize, act-order, bias) of the batch-1 decode form
# (csrc/qmm_decode.cuh): the other decode-width forms' cases whose group
# size it takes (not 40, nor the 116 the wire derives at K = 576); N past
# the last 16-column strip (264), a ragged last group (K = 1032 in groups
# of 32), K past the last stage (K = 1144: 143 word rows), LLaMA-7B's 4096 x
# 4096 and down_proj, a TP shard of 2048 columns, wire INT3
DECODE_FORM_CASES = [c for c in DECODE_CASES_K1 if c[3] != 40 and c[1] != 576] + [
    (4, 1032, 512, 32, True, True), (4, 11008, 4096, 128, False, True),
    (4, 4096, 2048, 128, False, False), (3, 1024, 512, 128, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,k,n,gs,actorder,bias", DECODE_FORM_CASES)
def test_decode_form_matches_plain_twice_and_in_a_graph(card, bits, k, n, gs, actorder, bias):
    """The batch-1 decode form of kernels 1 and 2 (a TMA ring of the packed
    words, one block per column tile), through the dispatch at M = 1 and
    forced: within 2e-2 * max|y| of the plain version (kernel 2 also 1e-2 of
    the row's norm), finite, two launches bit-equal and a CUDA-graph replay
    bit-equal to the eager launch, replayed after x changed in place; the
    dispatch counts one decode launch of each kernel."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
    lin = _linear(k, n, bits, gs, seed=k + n, device=card, actorder=actorder, bias=bias)
    gate, up = _gate_up(card, k, n, bits, gs, actorder)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    x = torch.randn(1, k, device=card).bfloat16()
    kernels.reset_launch_counts()
    assert _close(quant_matmul(x, lin), quant_matmul_plain(x, lin), 2e-2)
    assert _row_rel(fused_mlp(x, gate, up), fused_mlp_plain(x, gate, up)) <= 1e-2
    counts = kernels.launch_counts()
    assert counts["qmm:decode"] == 1 and counts["fused_mlp:decode"] == 1
    for streams, w in ((1, lin), (2, gate)):
        xp = x if w.perm is None else x.index_select(-1, w.perm).contiguous()
        p = matmul.plan(1, k, n, w.bits, sms, streams=streams, path="decode",
                        groupsize=w.groupsize, groups=w.scales.shape[0])
        run = ((lambda: matmul._launch(xp, lin, p)) if streams == 1 else
               (lambda: mlp._launch(xp, gate, up, p)))
        want = (quant_matmul_plain(x, lin) if streams == 1 else fused_mlp_plain(x, gate, up))
        got, again = run(), run()
        torch.cuda.synchronize()
        what = f"kernel {streams} rows a stage {p.per_split}"
        assert torch.isfinite(got.float()).all() and _close(got, want, 2e-2), what
        assert streams == 1 or _row_rel(got, want) <= 1e-2, what
        assert torch.equal(got, again), what
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = run()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, got), what
        xp.copy_(torch.randn_like(xp))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, run()), what


# offsets on the edges of kernels 3 and 9's 32-slot tiles and of their 64- and
# 128-slot chunks, and the last slot of a 2048-slot cache
EDGES = (0, 63, 64, 127, 128, 255, 256, 2047)
SERVING = (37, 150, 300, 511, 512, 900, 1200, 1500)


def _decode_case(card, b, s, h, hkv, offs, seed=0, d=128):
    """Kernel 3's inputs at head dim ``d``, clean, and the caches again with
    NaN in every slot PAST each row's offset (slot offset[b] is attended): a
    kernel that read one would return NaN. The plain version multiplies a
    dead slot's V row by a zero weight, so it takes the clean caches."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=card).bfloat16()
    q, k, v = r(b, 1, h, d), r(b, s, hkv, d), r(b, s, hkv, d)
    off = torch.tensor(offs, dtype=torch.int32, device=card)
    dead = (torch.arange(s, device=card)[None, :] > off[:, None])[:, :, None, None]
    return q, k, v, k.masked_fill(dead, float("nan")), v.masked_fill(dead, float("nan")), off


# kernels 3 and 9's cases: the first three (two chunks at offset 299 under
# the plan for the 300-slot cache); every G from 1 to 8 (Hkv = 2) with 8 rows
# at the edge offsets; LLaMA-7B's heads over a 2048-slot cache: the GQA row
# (Hkv = 8), the last slot, the serving slots
DECODE_CASES = [(2, 300, 8, 8, (5, 299)), (2, 300, 8, 2, (5, 299)), (2, 300, 12, 4, (5, 299)),
                *[(8, 2048, 2 * g, 2, EDGES) for g in range(1, 9)],
                (2, 2048, 32, 8, (100, 1500)), (1, 2048, 32, 32, (2047,)),
                (8, 2048, 32, 32, SERVING)]
# the head dims other than 128 (ROADMAP B6): every G from 1 to 8 at the edge
# offsets, and each model's heads at the last slot (GPT-2 16 at D = 64,
# OPT-2.7B 32 at 80, NeoX-20B 64 at 96; 16 over 2 at 256)
NEW_DIMS = (64, 80, 96, 256)
DIM_HEADS = {64: (16, 16), 80: (32, 32), 96: (64, 64), 256: (16, 2)}
DIM_CASES = [*[(8, 2048, 2 * g, 2, EDGES, d) for d in NEW_DIMS for g in range(1, 9)],
             *[(1, 2048, *DIM_HEADS[d], (2047,), d) for d in NEW_DIMS]]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,offs,d", [(*c, 128) for c in DECODE_CASES] + DIM_CASES)
def test_decode_attention_matches_plain(card, b, s, h, hkv, offs, d):
    """1e-2 of each row's norm: both softmax in fp32; the kernel's output is
    bf16. Per-row offsets over caches holding NaN past each offset, with the
    plan made for the whole cache, for the true bound and for one below most
    offsets (the last chunk then runs to each row's own offset): no NaN, and
    two runs bit-equal (the chunks are summed in a fixed order). Then host
    int offsets: each row alone at its own, and every row at 77 (one chunk)
    and at the cache's last slot (chunks and the combine kernel). Head dims
    64, 80, 96, 128 and 256, each its own library."""
    scale = d ** -0.5
    q, k, v, pk, pv, off = _decode_case(card, b, s, h, hkv, offs, seed=b * h + hkv, d=d)
    want = decode_attention_plain(q, k, v, off, scale)
    for max_live in (None, max(offs) + 1, 100):
        got = decode_attention(q, pk, pv, off, scale, max_live)
        again = decode_attention(q, pk, pv, off, scale, max_live)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), f"max_live={max_live}: read a poisoned slot"
        assert _rows_close(got, want, 1e-2), f"max_live={max_live}"
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    for i, o in enumerate(offs):
        got = decode_attention(q[i:i + 1], pk[i:i + 1], pv[i:i + 1], o, scale)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and _rows_close(got, want[i:i + 1], 1e-2), o
    for o in (77, s - 1):
        assert _rows_close(decode_attention(q, k, v, o, scale),
                           decode_attention_plain(q, k, v, o, scale), 1e-2), o


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    """No plain fallback for a CUDA tensor: a cache dtype no kernel takes
    (fp16), k and v of two dtypes, fp32 inputs raise."""
    q = torch.randn(1, 1, 8, 128, device=card).bfloat16()
    k16 = torch.randn(1, 64, 8, 128, device=card).half()
    with pytest.raises(TypeError):
        decode_attention(q, k16, k16, 3, 0.1)
    with pytest.raises(TypeError):
        flash_prefill_blocked(q, k16, k16, 0, 0.1)
    k8 = k16.to(torch.float8_e4m3fn)
    with pytest.raises(TypeError, match="one dtype"):
        decode_attention(q, k8, k8.to(torch.float8_e5m2), 3, 0.1)
    lin = _linear(256, 128, 4, 128, seed=0, device=card)
    with pytest.raises(TypeError):
        quant_matmul(torch.randn(2, 256, device=card), lin, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,off,hkv,d", [(45, 0, 8, 128), (45, 77, 2, 128), (130, 3, 8, 128),
                                          *[(c, o, 2, d) for d in NEW_DIMS
                                            for c, o in ((45, 77), (130, 3))]])
def test_flash_prefill_blocked_matches_plain(card, sq, off, hkv, d):
    """Every head dim; the launch is counted under its head dim and under its
    body and head dim."""
    q = torch.randn(1, sq, 8, d, device=card).bfloat16()
    k = torch.randn(1, 256, hkv, d, device=card).bfloat16()
    v = torch.randn(1, 256, hkv, d, device=card).bfloat16()
    kernels.reset_launch_counts()
    assert _rows_close(flash_prefill_blocked(q, k, v, off, d ** -0.5),
                       flash_prefill_blocked_plain(q, k, v, off, d ** -0.5), 1e-2)
    counts = kernels.launch_counts()
    assert counts["flash_prefill_blocked"] == counts[f"flash_prefill_blocked:d{d}"] == 1
    body = flash_plan(sq, off, d)
    assert counts[f"flash_prefill_blocked:{body}:d{d}"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("sq,off,skv,h,hkv", [(512, 0, 512, 8, 2), (2048, 0, 2048, 4, 1),
                                              (128, 512, 640, 8, 2), (128, 512, 2048, 8, 8),
                                              (100, 0, 2048, 8, 2), (77, 1900, 2048, 4, 4)])
def test_flash_prefill_blocked_serving_rows(card, sq, off, skv, h, hkv):
    """Kernel 4 at the bucket (SQ = 512), the implicit bucket (2048), the
    serving chunk (128 at offset 512) over the gathered 640 slots and over a
    dense 2048-slot cache, the runner's prompt over its cache, and a ragged
    chunk near the end of the cache; GQA. Every output row within 1e-2 of its
    norm; the slots above a row's position hold NaN, which the kernel never
    reads."""
    gen = torch.Generator(device=card)
    gen.manual_seed(sq + off)
    q = torch.randn(1, sq, h, 128, generator=gen, device=card).bfloat16()
    k = torch.randn(1, skv, hkv, 128, generator=gen, device=card).bfloat16()
    v = torch.randn(1, skv, hkv, 128, generator=gen, device=card).bfloat16()
    want = flash_prefill_blocked_plain(q, k, v, off, 128 ** -0.5)
    k[:, off + sq:] = float("nan")
    v[:, off + sq:] = float("nan")
    kernels.reset_launch_counts()
    got = flash_prefill_blocked(q, k, v, off, 128 ** -0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill_blocked"] == 1
    assert torch.isfinite(got.float()).all() and _rows_close(got, want, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d", [(1, 1, 8, 8, 128), (2, 300, 8, 2, 128),
                                         (1, 2048, 4, 4, 128),
                                         *[(2, 300, 8, 2, d) for d in NEW_DIMS]])
def test_kernels_4_and_5_agree_without_an_offset(card, b, s, h, hkv, d):
    """At offset 0 with SQ = SKV kernel 4 computes kernel 5's function with
    the same body (csrc/flash_common.cuh): the outputs are bit-equal."""
    q = torch.randn(b, s, h, d, device=card).bfloat16()
    k = torch.randn(b, s, hkv, d, device=card).bfloat16()
    v = torch.randn(b, s, hkv, d, device=card).bfloat16()
    got4 = flash_prefill_blocked(q, k, v, 0, d ** -0.5)
    got5 = flash_prefill(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got4.view(torch.int16), got5.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d", [
    *[(*c, 128) for c in ((1, 1, 8, 8), (2, 63, 8, 2), (1, 64, 4, 4), (1, 65, 8, 8),
                          (2, 300, 8, 2), (1, 1000, 4, 1), (1, 2048, 4, 2), (1, 127, 4, 1),
                          (1, 128, 4, 4), (2, 129, 8, 1))],
    *[(*c, d) for d in NEW_DIMS for c in ((2, 63, 8, 2), (1, 1000, 8, 1))]])
def test_flash_prefill_matches_plain(card, b, s, h, hkv, d):
    """1e-2 of each row's norm: both softmax in fp32; the kernel rounds p and
    its output to bf16 (about 2^-9 relative each). S = 127-129 straddle the
    wgmma body's 128-query block and key tile (rows past S read as zeros).
    At every other D S = 63 runs the mma.sync body and S = 1000 the wgmma
    body (at D = 256 on 80-key K and V tiles)."""
    q = torch.randn(b, s, h, d, device=card).bfloat16()
    k = torch.randn(b, s, hkv, d, device=card).bfloat16()
    v = torch.randn(b, s, hkv, d, device=card).bfloat16()
    kernels.reset_launch_counts()
    got = flash_prefill(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill"] == 1
    assert kernels.launch_counts()[f"flash_prefill:d{d}"] == 1
    assert kernels.launch_counts()[f"flash_prefill:{flash_plan(s, 0, d)}:d{d}"] == 1
    assert torch.isfinite(got.float()).all()
    assert _rows_close(got, flash_prefill_plain(q, k, v, d ** -0.5), 1e-2)


# the head dims of both bodies besides 128 (GPT-2, OPT, GPT-NeoX; 256 with
# 80-key K and V tiles)
WGMMA_DIMS = (64, 80, 96, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["sync", "wgmma"])
@pytest.mark.parametrize("b,s,h,hkv,d", [
    *[(*c, 128) for c in ((1, 1, 8, 8), (2, 63, 8, 2), (1, 127, 4, 1), (1, 128, 4, 4),
                          (2, 129, 8, 1), (1, 1000, 4, 1), (2, 512, 8, 8))],
    *[(*c, d) for d in WGMMA_DIMS for c in ((1, 127, 4, 1), (2, 129, 8, 1), (1, 1000, 8, 2),
                                            (2, 512, 8, 8))]])
def test_flash_bodies_match_plain(card, path, b, s, h, hkv, d):
    """Both bodies of kernels 4 and 5, forced, whatever the plan would pick,
    at D = 128 and at the head dims whose sub-tiles take the 128-, 32- and
    64-byte swizzles (64, 80, 96) and at 256 (80-key K and V tiles), with
    GQA and ragged S (TMA's rows past S read as zeros): kernel 5 within 1e-2
    of each row's norm of the plain version, two launches bit-equal, and
    kernel 4 at offset 0 bit-equal to it."""
    from gptq_for_llama_tpu_torch.ops.cuda import flash, flash_prefill as fp
    gen = torch.Generator(device=card)
    gen.manual_seed(s + d)
    q = torch.randn(b, s, h, d, generator=gen, device=card).bfloat16()
    k = torch.randn(b, s, hkv, d, generator=gen, device=card).bfloat16()
    v = torch.randn(b, s, hkv, d, generator=gen, device=card).bfloat16()
    got5 = fp._launch(q, k, v, d ** -0.5, path)
    again = fp._launch(q, k, v, d ** -0.5, path)
    got4 = flash._launch(q, k, v, 0, d ** -0.5, path)
    torch.cuda.synchronize()
    assert torch.isfinite(got5.float()).all()
    assert _rows_close(got5, flash_prefill_plain(q, k, v, d ** -0.5), 1e-2)
    assert torch.equal(again.view(torch.int16), got5.view(torch.int16))
    assert torch.equal(got4.view(torch.int16), got5.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["sync", "wgmma"])
@pytest.mark.parametrize("sq,off,skv,hkv,d", [
    *[(*c, 128) for c in ((45, 0, 256, 8), (100, 0, 2048, 2), (130, 77, 1000, 8),
                          (77, 1900, 2048, 1), (300, 5, 512, 4))],
    *[(*c, d) for d in WGMMA_DIMS for c in ((100, 0, 2048, 2), (130, 77, 1000, 8),
                                            (77, 1900, 2048, 1), (300, 5, 512, 4))]])
def test_kernel_4_reads_nothing_past_the_causal_limit(card, path, sq, off, skv, hkv, d):
    """Kernel 4's bodies over a cache that holds NaN in every slot past the
    chunk's causal limit (off + SQ): a TMA tile copies whole slots, so the
    wgmma body zeroes V's rows past the limit (in every sub-tile) before P V
    (0 * NaN is NaN). Finite, and every row within 1e-2 of its norm of the
    plain version on the clean cache."""
    from gptq_for_llama_tpu_torch.ops.cuda import flash
    gen = torch.Generator(device=card)
    gen.manual_seed(sq + off + d)
    q = torch.randn(1, sq, 8, d, generator=gen, device=card).bfloat16()
    k = torch.randn(1, skv, hkv, d, generator=gen, device=card).bfloat16()
    v = torch.randn(1, skv, hkv, d, generator=gen, device=card).bfloat16()
    want = flash_prefill_blocked_plain(q, k, v, off, d ** -0.5)
    k[:, off + sq:] = float("nan")
    v[:, off + sq:] = float("nan")
    got = flash._launch(q, k, v, off, d ** -0.5, path)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and _rows_close(got, want, 1e-2)


@pytest.mark.cuda
def test_causal_sdpa_goes_through_kernel_5(card):
    """A cache-less causal sdpa on the card launches kernel 5 for any S; a
    cache-less call with another mask raises instead of running plain, and
    so does a head dim no library is built for (72; 64, 80, 96, 128 and 256
    are)."""
    q = torch.randn(1, 37, 8, 128, device=card).bfloat16()
    kernels.reset_launch_counts()
    common.sdpa(q, q, q, None, causal=True)
    assert kernels.launch_counts()["flash_prefill"] == 1
    with pytest.raises(NotImplementedError):
        common.sdpa(q, q, q, common.causal_mask(37, 37, device=card))
    with pytest.raises(TypeError):
        flash_prefill(q.float(), q.float(), q.float(), 0.1)
    k8 = q.to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        flash_prefill(q, k8, k8, 0.1)
    q72 = torch.randn(1, 8, 4, 72, device=card).bfloat16()
    with pytest.raises(ValueError, match="B6"):
        flash_prefill(q72, q72, q72, 0.1)


def _bf16_ulps(got, want) -> int:
    """Largest distance of two bf16 tensors in units of the last place."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(got) - line(want)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,h,wdtype", [(1, 4096, torch.bfloat16), (8, 4096, torch.bfloat16),
                                        (100, 4096, torch.float32), (7, 100, torch.bfloat16),
                                        (3, 33, torch.bfloat16), (2, 11008, torch.bfloat16),
                                        (5, 16384, torch.bfloat16)])
def test_rms_norm_matches_plain(card, m, h, wdtype):
    """1 bf16 ulp: the kernel sums the squares in another order than the plain
    version; the rest is the same fp32 arithmetic, rounded once. Odd H takes
    the element-load path, H = 16384 the opt-in shared memory."""
    x = (torch.randn(m, h, device=card) * 3).bfloat16()
    w = (1 + 0.1 * torch.randn(h, device=card)).to(wdtype)
    kernels.reset_launch_counts()
    got = rms_norm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rms_norm"] == 1
    assert _bf16_ulps(got, rms_norm_plain(x, w, 1e-6)) <= 1
    # a view that is not contiguous is copied, leading dims are rows
    x3 = x.reshape(m, 1, h).expand(m, 2, h)
    assert _bf16_ulps(rms_norm(x3, w, 1e-6), rms_norm_plain(x3, w, 1e-6)) <= 1


@pytest.mark.cuda
def test_rms_norm_fp32_and_refusals(card):
    x = torch.randn(6, 1000, device=card)
    w = torch.randn(1000, device=card)
    got, want = rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(TypeError):
        rms_norm(x.half(), w, 1e-5)
    with pytest.raises(ValueError):
        rms_norm(x, w[:999], 1e-5)


def _within_one_bf16_ulp(got, want):
    """Every element within one bf16 unit in the last place of ``want``'s
    element (2^(e - 7) for |want| in [2^e, 2^(e+1))), in any dtype."""
    got, want = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,h,dtype", [(1, 4096, torch.bfloat16), (8, 4096, torch.bfloat16),
                                       (100, 4096, torch.bfloat16),
                                       (16384, 4096, torch.bfloat16), (7, 200, torch.bfloat16),
                                       (8, 4096, torch.float32)])
def test_add_rms_norm_matches_plain(card, m, h, dtype):
    """Kernel 6's residual form against add_rms_norm_plain: h = x + r
    bit-equal (one fp32 add rounded once, as torch's add), y within 1 bf16
    ulp (the sum of squares is taken in another order; the rest is the same
    fp32 arithmetic, rounded once). One launch, counted as the add form."""
    gen = torch.Generator(device=card)
    gen.manual_seed(m + h)
    x = (torch.randn(m, h, generator=gen, device=card) * 3).to(dtype)
    r = torch.randn(m, h, generator=gen, device=card).to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=card)).bfloat16()
    kernels.reset_launch_counts()
    hs, y = add_rms_norm(x, r, w, 1e-6)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["rms_norm"], counts["rms_norm:add"], counts["rms_norm:alone"]) == (1, 1, 0)
    want_h, want_y = add_rms_norm_plain(x, r, w, 1e-6)
    assert hs.dtype == y.dtype == dtype
    assert torch.equal(hs, want_h)
    assert _within_one_bf16_ulp(y, want_y)
    assert hs.data_ptr() not in (x.data_ptr(), r.data_ptr())   # out of place


@pytest.mark.cuda
def test_add_rms_norm_refusals_and_launch_floor(card):
    """A residual of another shape, dtype or device is refused before any
    launch; the launch floor's empty kernel runs and is counted nowhere."""
    from gptq_for_llama_tpu_torch.ops.cuda import norm
    x = torch.randn(4, 256, device=card).bfloat16()
    w = torch.ones(256, device=card).bfloat16()
    kernels.reset_launch_counts()
    for r in (x[:, :128].contiguous(), x.float(), x.cpu()):
        with pytest.raises(ValueError, match="residual"):
            norm.add_rms_norm_cuda(x, r, w, 1e-6)
    norm.launch_floor(card)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rms_norm"] == 0


def _paged_case(card, b, h, hkv, bs, mb, offs, poison=True, d=128):
    """A pool whose tables are a random permutation (no two logical neighbours
    are physical neighbours), with NaN in every block no row owns and in every
    slot past a row's offset; head dim ``d``."""
    nb = b * mb + 3
    gen = torch.Generator(device=card)
    gen.manual_seed(b * 1000 + bs)
    kp = torch.randn(nb, bs, hkv, d, generator=gen, device=card).bfloat16()
    vp = torch.randn(nb, bs, hkv, d, generator=gen, device=card).bfloat16()
    q = torch.randn(b, 1, h, d, generator=gen, device=card).bfloat16()
    tables = torch.randperm(nb, generator=gen, device=card)[:b * mb].reshape(b, mb).int()
    off = torch.tensor(offs, dtype=torch.int32, device=card)
    if poison:
        owned = torch.zeros(nb, dtype=torch.bool, device=card)
        owned[tables.reshape(-1).long()] = True
        dead = torch.arange(mb * bs, device=card)[None, :] > off[:, None]       # (B, MB * BS)
        dead_pool = torch.zeros(nb, bs, dtype=torch.bool, device=card)
        dead_pool[tables.long()] = dead.reshape(b, mb, bs)
        dead_pool |= ~owned[:, None]
        kp[dead_pool] = float("nan")
        vp[dead_pool] = float("nan")
    return q, kp, vp, tables, off


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,bs,mb,offs,d", [
    *[(*c, 128) for c in (
        (3, 8, 8, 16, 24, (0, 37, 383)), (2, 8, 2, 8, 40, (5, 319)),
        (2, 12, 4, 24, 12, (100, 287)), (4, 4, 4, 32, 70, (63, 64, 1500, 2239)),
        (8, 32, 32, 16, 128, (37, 127, 128, 500, 900, 1500, 2000, 2047)))],
    *[(8, *DIM_HEADS[d], 16, 128, SERVING, d) for d in NEW_DIMS],
    *[(2, 16, 2, 8, 40, (5, 319), d) for d in NEW_DIMS]])
def test_pool_decode_attention_matches_plain(card, b, h, hkv, bs, mb, offs, d):
    """1e-2 of each row's norm, as kernel 3, over a POISONED pool: a kernel
    that read one slot past an offset, or one block a row does not own, would
    return NaN. The host-side bound on the live length changes the split over
    chunks only: with no bound, the true one, or one far too small (the last
    chunk runs to the row's own offset) the result is the same."""
    q, kp, vp, tables, off = _paged_case(card, b, h, hkv, bs, mb, offs, d=d)
    want = pool_decode_attention_plain(q, kp, vp, tables, off, d ** -0.5)
    assert torch.isfinite(want.float()).all()
    kernels.reset_launch_counts()
    for max_live in (None, max(offs) + 1, max(1, (max(offs) + 1) // 3)):
        got = pool_decode_attention(q, kp, vp, tables, off, d ** -0.5, max_live)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), f"max_live={max_live}: read a poisoned slot"
        assert _rows_close(got, want, 1e-2), f"max_live={max_live}"
    assert kernels.launch_counts()["pool_decode_attention"] == 3
    assert kernels.launch_counts()[f"pool_decode_attention:d{d}"] == 3
    assert kernels.launch_counts()["decode_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, *NEW_DIMS])
def test_pool_kernel_equals_dense_kernel_on_the_gathered_view(card, d):
    """Kernel 7 is kernel 3 with the slot address routed through the table:
    on the gathered logical view the dense kernel gives the same bits."""
    q, kp, vp, tables, off = _paged_case(card, 3, 8, 2, 16, 64, (0, 300, 1023), poison=False,
                                         d=d)
    kd = kp[tables.long()].reshape(3, -1, 2, d).contiguous()
    vd = vp[tables.long()].reshape(3, -1, 2, d).contiguous()
    for max_live in (None, 1024, 301):
        assert torch.equal(pool_decode_attention(q, kp, vp, tables, off, 0.09, max_live),
                           decode_attention(q, kd, vd, off, 0.09, max_live))
    # per-row offsets with a bound plan like the host int they bound
    one = torch.tensor([300] * 3, dtype=torch.int32, device=card)
    assert torch.equal(decode_attention(q, kd, vd, one, 0.09, max_live=301),
                       decode_attention(q, kd, vd, 300, 0.09))


@pytest.mark.cuda
def test_pool_kernel_refuses_what_it_does_not_take(card):
    q, kp, vp, tables, off = _paged_case(card, 2, 8, 8, 16, 4, (3, 40), poison=False)
    with pytest.raises(ValueError, match="multiple of 8"):
        pool_decode_attention(q, kp[:, :12].contiguous(), vp[:, :12].contiguous(), tables, off, 0.1)
    with pytest.raises(ValueError):   # 8-byte elements: no cache dtype
        pool_decode_attention(q, kp.double(), vp.double(), tables, off, 0.1)
    with pytest.raises(TypeError):
        pool_decode_attention(q, kp, vp, tables, 3, 0.1)
    with pytest.raises(ValueError):
        pool_decode_attention(q, kp, vp, tables.long(), off, 0.1)
    with pytest.raises(ValueError):   # a block pool is attended one token per row
        common.sdpa(q.expand(2, 4, 8, 128), ("pool", kp, tables), ("pool", vp, tables),
                    decode_offset=off)


@pytest.mark.cuda
def test_serving_protocol_goes_through_the_kernels(card):
    """One slot's prefill with a host-int offset launches kernel 4; the same
    offset as a (1,) tensor raises (no kernel takes an arbitrary mask); a
    fresh batched admission launches kernel 5; the fused chunk+decode step
    launches kernels 3 + 4 (dense) or 7 + 4 (paged)."""
    b, c, s, bs = 3, 16, 64, 16
    q = torch.randn(1, c, 8, 128, device=card).bfloat16()
    k = torch.randn(1, s, 8, 128, device=card).bfloat16()
    kernels.reset_launch_counts()
    common.sdpa(q, k, k, decode_offset=16)
    assert kernels.launch_counts()["flash_prefill_blocked"] == 1
    with pytest.raises(NotImplementedError):
        common.sdpa(q, k, k, decode_offset=torch.tensor([16], dtype=torch.int32, device=card))

    ck = torch.zeros(b, s, 8, 128, device=card).bfloat16()
    cv = torch.zeros_like(ck)
    admit = torch.tensor([True, False, True], device=card)
    qb = torch.randn(b, c, 8, 128, device=card).bfloat16()
    kernels.reset_launch_counts()
    out, _ = common.attention_block(("fresh", ck, cv, admit), qb, qb, qb, None)
    assert kernels.launch_counts()["flash_prefill"] == 1
    assert _rows_close(out, flash_prefill_plain(qb, qb, qb, 128 ** -0.5), 1e-2)
    assert torch.equal(ck[0, :c], qb[0]) and not ck[1].any()

    off = torch.tensor([c, 0, c], dtype=torch.int32, device=card)
    live = torch.tensor([True, False, True], device=card)
    qf = torch.randn(1, b + c, 8, 128, device=card).bfloat16()
    nb = b * (s // bs) + 1
    kp = torch.zeros(nb, bs, 8, 128, device=card).bfloat16()
    vp = torch.zeros_like(kp)
    tables = (torch.arange(b * (s // bs), device=card).reshape(b, -1) + 1).int()
    kp[tables[0, 0]], kp[tables[2, 0]] = ck[0, :bs], ck[2, :bs]
    vp[tables[0, 0]], vp[tables[2, 0]] = cv[0, :bs], cv[2, :bs]
    kernels.reset_launch_counts()
    dense, _ = common.attention_block(("grouped", ck, cv, off, live, 1, 0, b, c + 1),
                                      qf, qf, qf, None)
    paged, _ = common.attention_block(("grouped_paged", kp, vp, tables, off, live, 1, 0, b, c + 1),
                                      qf, qf, qf, None)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["decode_attention"], counts["pool_decode_attention"],
            counts["flash_prefill_blocked"]) == (1, 1, 2)
    assert torch.equal(dense[:, [0, 2]], paged[:, [0, 2]]) and torch.equal(dense[:, b:], paged[:, b:])


@pytest.mark.cuda
def test_serving_engine_on_the_card(card):
    """A narrow 2-layer LLaMA (head_dim 128, dense bf16 linears) served on the
    card, paged and dense, spans and chunks: the launch counts are what the
    forwards predict, and paged tokens equal dense ones (kernels 7 and 3 are
    the same arithmetic)."""
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime import GenRequest, ServingEngine
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128, max_seq_len=256)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16, device=card)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, size=n) for n in (5, 20, 33, 70, 9, 130)]

    def run(**kw):
        eng = ServingEngine("llama", cfg, params, batch_slots=4, max_seq_len=256,
                            prefill_buckets=(32, 128), **kw)
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=12))
        kernels.reset_launch_counts()
        res = eng.run()
        torch.cuda.synchronize()
        return res, eng.forwards, kernels.launch_counts()

    layers = cfg.num_layers
    for kw in (dict(decode_span=4), dict(prefill_chunk=32)):
        dense, fd, cd = run(**kw)
        paged, fp, cp = run(paged=True, **kw)
        assert fd == fp
        total = sum(fd.values())
        steps = fd["decode"] + fd["chunk+decode"]
        chunks = fd["prefill"] + fd["chunk"] + fd["chunk+decode"]
        assert cd["rms_norm"] == cp["rms_norm"] == (2 * layers + 1) * total
        assert cd["rms_norm:add"] == cp["rms_norm:add"] == 2 * layers * total
        assert cd["decode_attention"] == cp["pool_decode_attention"] == layers * steps
        assert cd["pool_decode_attention"] == cp["decode_attention"] == 0
        assert cd["flash_prefill_blocked"] == cp["flash_prefill_blocked"] == layers * chunks
        assert cd["flash_prefill"] == cp["flash_prefill"] == layers * fd["admit"]
        for uid in range(len(prompts)):
            assert len(dense[uid]) == 12
            np.testing.assert_array_equal(paged[uid], dense[uid], err_msg=f"{kw} request {uid}")


@pytest.mark.cuda
@pytest.mark.parametrize("bits,m,k,n,gs,actorder", [
    (4, 1, 512, 256, 128, False), (4, 37, 1024, 264, 128, True), (2, 130, 512, 256, 64, False),
    (8, 9, 512, 520, 128, False), (3, 200, 512, 256, 128, False), (4, 5, 520, 256, 40, False),
    (4, 300, 1024, 128, 1024, False)])
def test_qmm_t_matches_plain(card, bits, m, k, n, gs, actorder):
    """Kernel 8 (through the dispatch, inverse perm included) against the
    plain version on the card: every output row within 2e-2 of its norm. The
    kernel's dequantized weight is bit-equal to the plain one; the products
    accumulate in another order, and the plain matmul rounds to bf16."""
    from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import quant_matmul_t, quant_matmul_t_plain
    lin = _linear(k, n, bits, gs, seed=m, device=card, actorder=actorder)
    g = torch.randn(m, n, device=card).bfloat16()
    kernels.reset_launch_counts()
    got = quant_matmul_t(g, lin)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qmm_t"] == 1 and got.shape == (m, k)
    want = quant_matmul_t_plain(g, lin)
    if lin.perm is not None:
        want = want[:, torch.argsort(lin.perm)]
    assert _rows_close(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m", [(4096, 4096, 128), (11008, 4096, 128), (4096, 11008, 128),
                                   (4096, 4096, 1024), (1024, 512, 300)])
def test_qmm_t_plans_match_plain(card, k, n, m):
    """Kernel 8 at the gradient check's M = 128 on the three LoRA widths (the
    plan splits N 8, 3 and 8 ways: fp32 partials summed in a fixed order), at
    the training batch and on a small split case: every row within 2e-2 of its
    norm; where N is not split, bit-equal to the plain version; two launches
    give the same bytes."""
    from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import (plan_for, qmm_t_cuda,
                                                            quant_matmul_t_plain)
    lin = _linear(k, n, 4, 128, seed=k + n + m, device=card)
    g = torch.randn(m, n, device=card).bfloat16()
    got, again = qmm_t_cuda(g, lin), qmm_t_cuda(g, lin)
    want = quant_matmul_t_plain(g, lin)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rows_close(got, want, 2e-2)
    if plan_for(g, lin).split == 1:
        assert torch.equal(got, want)
    else:
        assert m < 1024


@pytest.mark.cuda
def test_tensor_core_bodies_hold_the_ragged_set(card):
    """Kernels 1, 2 and 8 with each tensor-core body forced (the mma.sync
    tiles and the wgmma body) on chip_smoke.py's ragged set (``hold_tc_cases``:
    every device bits value and wire INT3, g128, g64, g32, g16, G = 1,
    act-order, a bias, ragged M 17-300, a ragged last column tile and group,
    N = 11008, with and without a split): each within 2e-2 * max|plain|,
    without a split the tiles' product bit-equal (the wgmma body's ulps
    reported), two launches bit-equal and a CUDA-graph replay bit-equal to
    the eager launch."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    rows = chip_smoke.hold_tc_cases(torch, ("tile", "wgmma"))
    assert rows and all(r["ok"] for r in rows)
    assert {r["path"] for r in rows} == {"tile", "wgmma"}


@pytest.mark.cuda
@pytest.mark.parametrize("bits,k,gs,actorder", [(4, 512, 128, False), (2, 560, 40, False),
                                                (8, 520, 40, True), (3, 512, 64, False),
                                                (4, 1024, 1024, False), (4, 512, 6, False)])
def test_qmm_t_dequantizes_bit_equal(card, bits, k, gs, actorder):
    """g = I (M = N): each dx row is one column of W times 1.0, so dx = W^T
    exactly when the kernel's dequantized slices are bit-equal to
    PackedLinear.dequantize (a group boundary inside a word at 40 and 2 bits,
    a ragged last group, G = 1, scales from device memory at groupsize 6)."""
    from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import qmm_t_cuda
    n = 288   # a ragged last slice of 64; packs the zeros at 2 and 3 bits
    lin = _linear(k, n, bits, gs, seed=k + gs, device=card, actorder=actorder)
    got = qmm_t_cuda(torch.eye(n, device=card).bfloat16(), lin)
    torch.cuda.synchronize()
    assert torch.equal(got, lin.dequantize(torch.bfloat16).T.contiguous())


def _fold_case(card, b, s, h, hkv, offs, seed=0, d=128):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    def r(*shape):
        return torch.randn(*shape, generator=gen, device=card).bfloat16()
    q, kn, vn = r(b, 1, h, d), r(b, 1, hkv, d), r(b, 1, hkv, d)
    ck, cv = r(b, s, hkv, d), r(b, s, hkv, d)
    off = torch.tensor(offs, dtype=torch.int32, device=card)
    dead = (torch.arange(s, device=card)[None, :] >= off[:, None])[:, :, None, None]
    ck, cv = ck.masked_fill(dead, float("nan")), cv.masked_fill(dead, float("nan"))
    return q, ck, cv, kn, vn, off


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,offs,d", [
    *[(*c, 128) for c in (
        (1, 64, 8, 8, (0,)), (2, 300, 8, 2, (5, 299)), (3, 2048, 12, 4, (0, 700, 2047)),
        *[(8, 2048, 2 * g, 2, EDGES) for g in range(1, 9)],
        (2, 2048, 32, 8, (100, 1500)), (1, 2048, 32, 32, (2047,)), (8, 2048, 32, 32, SERVING))],
    *DIM_CASES, *[(1, 64, 8, 8, (0,), d) for d in NEW_DIMS]])
def test_fused_decode_attention_matches_plain(card, b, s, h, hkv, offs, d):
    """Kernel 9 against its plain version over caches that hold NaN at and
    past each row's offset: every output row within 1e-2 of its norm, no NaN,
    and after the write under a mixed mask the caches byte-equal the plain
    version's. Per-row offsets with the plan made for the whole cache, the
    true bound and one below most offsets (the last chunk runs to each row's
    own offset), two runs bit-equal; a host int offset; write and no write.
    Offset 0: the output is v_new; 2047: the write lands on the last slot."""
    from gptq_for_llama_tpu_torch.ops.cuda.attention import (fused_decode_attention,
                                                             fused_decode_attention_plain)
    q, ck, cv, kn, vn, off = _fold_case(card, b, s, h, hkv, offs, d=d)
    mask = torch.arange(b, device=card) % 2 == 0
    wk, wv = ck.clone(), cv.clone()
    want, _, _ = fused_decode_attention_plain(q, wk, wv, kn, vn, off, 0.09, write_mask=mask)
    assert torch.isfinite(want.float()).all()
    kernels.reset_launch_counts()
    for max_live in (None, max(offs) + 1, 100):
        got, _, _ = fused_decode_attention(q, ck, cv, kn, vn, off, 0.09, write=False,
                                           max_live=max_live)
        again, _, _ = fused_decode_attention(q, ck, cv, kn, vn, off, 0.09, write=False,
                                             max_live=max_live)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), f"max_live={max_live}: read a dead slot"
        assert _rows_close(got, want, 1e-2), f"max_live={max_live}"
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    got, gk, gv = fused_decode_attention(q, ck, cv, kn, vn, off, 0.09, write_mask=mask)
    torch.cuda.synchronize()
    assert gk is ck and _rows_close(got, want, 1e-2)
    assert torch.equal(ck.view(torch.int16), wk.view(torch.int16))
    assert torch.equal(cv.view(torch.int16), wv.view(torch.int16))
    if len(set(offs)) == 1:   # a host int, as the runner passes it
        got, _, _ = fused_decode_attention(q, ck, cv, kn, vn, offs[0], 0.09, write=False)
        assert _rows_close(got, want, 1e-2)
    assert kernels.launch_counts()["fused_decode_attention"] == 7 + (len(set(offs)) == 1)
    assert kernels.launch_counts()["decode_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True])
def test_decode_graph_replays_as_offsets_grow(card, fold):
    """A CUDA graph captured once, with per-row offsets on the card and the
    plan made for the live bound at capture (64 slots), replays right as the
    offsets grow far past that bound: the last chunk runs to each row's own
    offset. The fold form writes its row under a mask on every replay."""
    from gptq_for_llama_tpu_torch.ops.cuda.attention import (fused_decode_attention,
                                                             fused_decode_attention_plain)
    b, s, h, hkv = 3, 2048, 16, 4
    q, k, v, _, _, off = _decode_case(card, b, s, h, hkv, (10, 40, 63), seed=7)
    kn, vn = torch.randn(2, b, 1, hkv, 128, device=card).bfloat16()
    mask = torch.tensor([True, False, True], device=card)

    def step():
        if fold:
            return fused_decode_attention(q, k, v, kn, vn, off, 0.09, write_mask=mask,
                                          max_live=64)[0]
        return decode_attention(q, k, v, off, 0.09, max_live=64)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for offs in ((10, 40, 63), (100, 700, 64), (1500, 2047, 1024)):
        off.copy_(torch.tensor(offs, dtype=torch.int32, device=card))
        wk, wv = k.clone(), v.clone()
        graph.replay()
        torch.cuda.synchronize()
        if fold:
            want, _, _ = fused_decode_attention_plain(q, wk, wv, kn, vn, off, 0.09,
                                                      write_mask=mask)
            assert torch.equal(k.view(torch.int16), wk.view(torch.int16)), offs
            assert torch.equal(v.view(torch.int16), wv.view(torch.int16)), offs
        else:
            want = decode_attention_plain(q, k, v, off, 0.09)
        assert _rows_close(out, want, 1e-2), offs


@pytest.mark.cuda
def test_fold_runner_on_the_card(card):
    """A fold runner, teacher-forced with the classic runner's greedy tokens
    on a narrow model with head_dim 128: the same logits (every row within
    2e-2 of its norm: the current token enters the softmax in another
    order), kernel 9 launched on every decode step of every layer and kernel
    3 never."""
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128, max_seq_len=128)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16, device=card)
    prompt = np.random.RandomState(0).randint(1, 512, size=20)
    classic = ModelRunner("llama", cfg, params, max_seq_len=128, device=card)
    toks = torch.as_tensor(generate(classic, prompt, max_new_tokens=12, temperature=0.0),
                           device=card)
    logits = {}
    for impl in ("classic", "fold"):
        runner = ModelRunner("llama", cfg, params, max_seq_len=128, device=card, cache_impl=impl)
        runner.warmup(prefill_buckets=())   # the decode graphs, captured before the count
        lg, cache = runner.prefill(toks[:, :20], runner.init_cache())
        kernels.reset_launch_counts()
        rows = []
        for i in range(20, toks.shape[1]):
            lg, cache = runner.decode(toks[:, i:i + 1], cache)
            rows.append(lg[0, -1])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        steps = (toks.shape[1] - 20) * cfg.num_layers
        assert counts["fused_decode_attention"] == (steps if impl == "fold" else 0)
        assert counts["decode_attention"] == (0 if impl == "fold" else steps)
        logits[impl] = torch.stack(rows)
    assert _rows_close(logits["fold"], logits["classic"], 2e-2)


def _graph_model(card, max_len=300):
    """A narrow packed LLaMA (head_dim 128, 2 layers, INT4 g128) whose tokens
    depend on the prompt; the 300-slot cache has the buckets 128, 256, 300."""
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
                      max_seq_len=max_len)
    return cfg, gaussian_wire_llama(cfg, seed=0, device=card)


def _eager(owner):
    """``owner``'s graph bodies run eagerly: the same code, not captured."""
    owner.graphs.run = lambda key, body, restore=(), generators=(): body()
    return owner


@pytest.mark.cuda
@pytest.mark.parametrize("cache_impl", ["classic", "fold"])
def test_runner_graphs_equal_the_eager_step_loop(card, cache_impl):
    """From a 100-token prompt, 60 greedy tokens through decode_greedy_scan
    (graphs cut at the bucket of 128) equal the eager ``_step`` loop's, and
    each ``decode`` graph's logits, and forced_decode_scan's last, equal
    ``_step``'s bit for bit across the bucket boundary; kernel launches per
    decode forward are the eager path's. A sampled span (temperature 0.9)
    replays the draws the eager body makes with the same seed."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
    cfg, params = _graph_model(card)
    prompt = torch.as_tensor(np.random.RandomState(1).randint(1, 512, size=(1, 100)),
                             device=card)
    graph = ModelRunner("llama", cfg, params, max_seq_len=300, device=card,
                        cache_impl=cache_impl)
    eager = ModelRunner("llama", cfg, params, max_seq_len=300, device=card,
                        cache_impl=cache_impl)
    graph.warmup(prefill_buckets=())
    lg, cache = eager.prefill(prompt, eager.init_cache())
    tok, want, counts = lg[:, -1:].argmax(-1), [], []
    for _ in range(60):
        kernels.reset_launch_counts()
        lg, cache = eager._step(tok, cache)
        counts.append(kernels.launch_counts())
        tok = lg[:, -1:].float().argmax(-1)
        want.append(tok)
    lg, cache = graph.prefill(prompt, graph.init_cache())
    kernels.reset_launch_counts()
    before = dict(graph.forwards)
    toks, cache = graph.decode_greedy_scan(lg[:, -1:].argmax(-1), cache, 60)
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    assert torch.equal(toks, torch.cat(want, 1)) and cache.offset == 160
    assert graph.forwards["decode"] - before["decode"] >= 60
    per = {k: n / (graph.forwards["decode"] - before["decode"]) for k, n in got.items()}
    assert per == {k: float(n) for k, n in counts[0].items()}
    assert all(c == counts[0] for c in counts)
    assert per["fused_decode_attention" if cache_impl == "fold" else "decode_attention"] == 2
    lg, cache = graph.prefill(prompt, graph.init_cache())
    lge, cache_e = eager.prefill(prompt, eager.init_cache())
    for t in torch.cat(want, 1)[0, :40]:
        lg, cache = graph.decode(t.reshape(1, 1), cache)
        lge, cache_e = eager._step(t.reshape(1, 1), cache_e)
        assert torch.equal(lg.view(torch.int16), lge.view(torch.int16)), cache.offset
    # the teacher-forced scan's graphs end on the same logits
    lg, cache = graph.prefill(prompt, graph.init_cache())
    lg, cache = graph.forced_decode_scan(torch.cat(want, 1)[:, :40], cache)
    assert torch.equal(lg.view(torch.int16), lge.view(torch.int16)) and cache.offset == 140
    keys = {k for k in graph.graphs.keys()}
    assert {("decode", 128), ("decode", 256), ("decode", 300)} <= keys
    sampled = generate(graph, prompt[0].cpu().numpy(), 40, temperature=0.9, seed=4, span=8)
    ref = generate(_eager(eager), prompt[0].cpu().numpy(), 40, temperature=0.9, seed=4,
                   span=8)
    np.testing.assert_array_equal(sampled, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "paged", "fold"])
def test_engine_graph_spans_equal_eager_spans(card, mode):
    """The engine's decode spans (span 4) replayed from graphs give the
    tokens of the same bodies run eagerly, and the launches the forwards
    predict; the graphs are keyed by (span, mode, bucket)."""
    from gptq_for_llama_tpu_torch.runtime import GenRequest, ServingEngine
    cfg, params = _graph_model(card)
    kw = {"dense": {}, "paged": dict(paged=True, block_size=16),
          "fold": dict(cache_impl="fold")}[mode]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 512, size=n) for n in (5, 20, 33, 70, 9, 130)]

    def run(eager):
        eng = ServingEngine("llama", cfg, params, batch_slots=4, max_seq_len=300,
                            prefill_buckets=(32, 128), decode_span=4, **kw)
        if eager:
            _eager(eng)
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=40))
        kernels.reset_launch_counts()
        res = eng.run()
        torch.cuda.synchronize()
        return res, eng, kernels.launch_counts()

    want, _, _ = run(True)
    got, eng, counts = run(False)
    for uid in range(len(prompts)):
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=f"request {uid}")
    f, layers = eng.forwards, cfg.num_layers
    kernel = {"dense": "decode_attention", "paged": "pool_decode_attention",
              "fold": "fused_decode_attention"}[mode]
    assert counts[kernel] == layers * f["decode"] > 0
    assert counts["rms_norm"] == (2 * layers + 1) * sum(f.values())
    from gptq_for_llama_tpu_torch.runtime.graphs import kind
    # the decode spans' keys (the prefills have theirs): prompts of 5-130
    # tokens + 40, buckets 128 and 256
    keys = {k for k in eng.graphs.keys() if kind(k) == "decode"}
    assert 4 in {span for span, _, _ in keys} <= {1, 4}
    assert {m for _, m, _ in keys} == {"greedy"} and {b for _, _, b in keys} == {128, 256}


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [128, 512])
def test_kernel_4_device_offset_replays_at_any_offset_and_slot(card, bound):
    """Kernel 4 captured once over a whole 4-row cache with its offset and
    cache row in device buffers (offset 0, row 0), then replayed at other
    offsets and rows under the same bound (the plan: the mma.sync body at
    128, wgmma at 512): every replay bit-equal to an eager launch on that
    row at the same offset and plan, and within 1e-2 of each row's norm of
    the plain version; the cache holds NaN past every chunk's end."""
    from gptq_for_llama_tpu_torch.ops.cuda import flash
    sq, rows_, skv, h, hkv = 64, 4, 1024, 8, 2
    gen = torch.Generator(device=card)
    gen.manual_seed(bound)
    q = torch.randn(1, sq, h, 128, generator=gen, device=card).bfloat16()
    k = torch.randn(rows_, skv, hkv, 128, generator=gen, device=card).bfloat16()
    v = torch.randn(rows_, skv, hkv, 128, generator=gen, device=card).bfloat16()
    off = torch.zeros(1, dtype=torch.int32, device=card)
    slot = torch.zeros(1, dtype=torch.int32, device=card)

    def step():
        return flash_prefill_blocked(q, k, v, off, 128 ** -0.5, bound, slot)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for o, r in ((0, 0), (bound - sq, 3), (bound // 2 - 7, 1), (17, 2)):
        want = flash_prefill_blocked_plain(q, k[r:r + 1], v[r:r + 1], o, 128 ** -0.5)
        kc, vc = k.clone(), v.clone()
        kc[:, o + sq:], vc[:, o + sq:] = float("nan"), float("nan")
        k.copy_(kc)
        v.copy_(vc)
        off.fill_(o)
        slot.fill_(r)
        kernels.reset_launch_counts()
        graph.replay()
        eager = flash._launch(q, k[r:r + 1].contiguous(), v[r:r + 1].contiguous(), o,
                              128 ** -0.5, flash.plan(sq, bound - sq))
        torch.cuda.synchronize()
        assert kernels.launch_counts()["flash_prefill_blocked"] == 1   # the eager launch
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16)), (o, r)
        assert torch.isfinite(out.float()).all() and _rows_close(out, want, 1e-2), (o, r)
        k.copy_(torch.nan_to_num(k, nan=0.5))
        v.copy_(torch.nan_to_num(v, nan=0.5))


@pytest.mark.cuda
def test_runner_prefill_graphs_equal_the_eager_body(card):
    """The runner's prefill graphs against the same body run eagerly
    (``_step``): prompts of 37 and 100 tokens, then a second prefill of 40
    at offset 37 that replays the ("prefill", 64, 128) graph captured at
    offset 0, and a prefill of 60 at 140 (bucket 256): the logits and every
    layer's cache below the offset bit-equal, and the launches of a replay
    those of the eager body."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner
    cfg, params = _graph_model(card)
    rng = np.random.RandomState(4)
    graph = ModelRunner("llama", cfg, params, max_seq_len=300, device=card)
    eager = ModelRunner("llama", cfg, params, max_seq_len=300, device=card)
    graph.warmup(prefill_buckets=(37, 100))
    keys = set(graph.graphs.keys())
    for parts in ((37,), (100,), (37, 40), (100, 40, 60)):
        cg, ce = graph.init_cache(), eager.init_cache()
        for n in parts:
            ids = torch.as_tensor(rng.randint(1, 512, size=(1, n)), device=card)
            kernels.reset_launch_counts()
            lg, cg = graph.prefill(ids, cg)
            torch.cuda.synchronize()
            got = kernels.launch_counts()
            kernels.reset_launch_counts()
            le, ce = eager._step(ids, ce)
            torch.cuda.synchronize()
            if set(graph.graphs.keys()) == keys:   # a replay (a capture adds its warm call)
                assert got == kernels.launch_counts(), parts
            keys = set(graph.graphs.keys())
            assert torch.equal(lg.view(torch.int16), le.view(torch.int16)), parts
            m = cg.offset
            for a, b in zip(cg.k + cg.v, ce.k + ce.v):
                assert torch.equal(a[:, :m].view(torch.int16), b[:, :m].view(torch.int16))
    assert {("prefill", 64, 128), ("prefill", 128, 128), ("prefill", 64, 256)} <= \
        set(graph.graphs.keys())
    assert graph.graphs.replays[("prefill", 64, 128)] >= 3   # offsets 0 and 37


def _engine_cache_rows(eng):
    """Each slot's live cache rows (dense: its row to its offset; paged: the
    blocks of its table to its offset), per layer, k then v."""
    st, out = eng.state, []
    for i in range(eng.b):
        n = int(st["host_off"][i])
        for c in st["k"] + st["v"]:
            if eng.paged:
                blocks = st["tables"][i, :-(-n // eng.block_size)].long()
                out.append(c[blocks].reshape(-1, *c.shape[2:])[:n])
            else:
                out.append(c[i, :n])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(paged=True, block_size=16),
                                dict(prefill_chunk=32), dict(prefill_chunk=32, paged=True,
                                                             block_size=16,
                                                             fused_chunk_decode=False)],
                         ids=["dense", "paged", "chunk-fused", "paged-chunk-unfused"])
def test_engine_prefill_and_chunk_graphs_equal_eager_bodies(card, kw):
    """The engine's prefill, admission, chunk and chunk+decode graphs against
    the same bodies run eagerly: tokens, and every slot's cache rows at the
    end, bit-equal; every key of those kinds replayed at slots and offsets
    other than its capture's (more replays than keys); a second run with
    every graph captured makes the eager run's launches, and as many replays
    of each kind as forwards."""
    from gptq_for_llama_tpu_torch.runtime import GenRequest, ServingEngine
    from gptq_for_llama_tpu_torch.runtime.graphs import kind
    cfg, params = _graph_model(card)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, size=n) for n in (5, 20, 33, 70, 9, 130, 31, 100)]
    kinds = ("prefill", "admit", "chunk", "chunk+decode")

    def run(eng):
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=10))
        kernels.reset_launch_counts()
        res = eng.run()
        torch.cuda.synchronize()
        return res, kernels.launch_counts()

    def engine():
        return ServingEngine("llama", cfg, params, batch_slots=3, max_seq_len=300,
                             prefill_buckets=(32, 128), **kw)

    eng_e = _eager(engine())
    want, counts_e = run(eng_e)
    eng = engine()
    got, _ = run(eng)
    for uid in range(len(prompts)):
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=f"request {uid}")
    for a, b in zip(_engine_cache_rows(eng), _engine_cache_rows(eng_e)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    new = [k for k in eng.graphs.keys() if kind(k) in kinds]
    assert new and sum(eng.graphs.replays[k] for k in new) > len(new)
    before, f0 = dict(eng.graphs.replays), dict(eng.forwards)
    again, counts = run(eng)
    for uid in range(len(prompts)):
        np.testing.assert_array_equal(again[uid], want[uid], err_msg=f"request {uid}")
    assert counts == counts_e
    for kd in kinds:
        replays = sum(n - before.get(k, 0) for k, n in eng.graphs.replays.items()
                      if kind(k) == kd)
        assert replays == eng.forwards[kd] - f0[kd], kd


@pytest.mark.cuda
def test_two_caches_of_one_runner_one_after_the_other(card):
    """A runner's second sequence, after init_cache(), decodes what a fresh
    runner decodes (the graphs captured over the first replay into the same
    storage); the first sequence's handle then raises."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner
    cfg, params = _graph_model(card)
    rng = np.random.RandomState(3)
    a, b = (torch.as_tensor(rng.randint(1, 512, size=(1, n)), device=card) for n in (40, 120))

    def greedy(runner, prompt):
        lg, cache = runner.prefill(prompt, runner.init_cache())
        return runner.decode_greedy_scan(lg[:, -1:].argmax(-1), cache, 30)

    shared = ModelRunner("llama", cfg, params, max_seq_len=300, device=card)
    toks_a, cache_a = greedy(shared, a)
    toks_b, _ = greedy(shared, b)
    for prompt, toks in ((a, toks_a), (b, toks_b)):
        fresh = ModelRunner("llama", cfg, params, max_seq_len=300, device=card)
        assert torch.equal(greedy(fresh, prompt)[0], toks)
    with pytest.raises(ValueError, match="stale"):
        shared.decode(toks_a[:, -1:], cache_a)


@pytest.mark.cuda
def test_a_capture_that_must_fail_raises(card, tmp_path):
    """A decode body that reads a value to the host cannot be captured: the
    entry point raises, no graph is kept for it (the prompt's prefill graph
    stays) and nothing runs eagerly in its place. In a subprocess, so that
    the failed capture touches no other test's process."""
    import pathlib
    import subprocess
    import sys
    import textwrap
    root = pathlib.Path(__file__).resolve().parents[1]
    code = textwrap.dedent("""
        import torch
        from gptq_for_llama_tpu_torch.models import llama
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                          num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
                          max_seq_len=64)
        params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
        r = ModelRunner("llama", cfg, params, max_seq_len=64, device="cuda")
        step = r._one_step
        r._one_step = lambda ids, max_live: step(ids, max_live + int(ids.sum().item() * 0))
        lg, cache = r.prefill(torch.ones(1, 5, dtype=torch.long, device="cuda"), r.init_cache())
        try:
            r.decode(torch.ones(1, 1, dtype=torch.long, device="cuda"), cache)
        except Exception as e:
            assert list(r.graphs.keys()) == [("prefill", 16, 64)], r.graphs.keys()
            print("capture refused:", type(e).__name__)
            raise SystemExit(0)
        raise SystemExit(1)
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    print(run.stdout[-2000:], run.stderr[-2000:])
    assert run.returncode == 0 and "capture refused" in run.stdout


@pytest.mark.cuda
def test_pool_decode_graph_replays_as_offsets_grow(card):
    """Kernel 7 captured once with the plan for 64 live slots replays right as
    the offsets grow far past it (the last chunk runs to each row's own
    offset), as kernels 3 and 9 do: every replay against the plain version
    over NaN-free pools, rows within 1e-2 of their norm."""
    b, h, hkv, bs, mb = 3, 16, 4, 16, 128
    gen = torch.Generator(device=card)
    gen.manual_seed(8)
    nb = b * mb + 1
    q = torch.randn(b, 1, h, 128, generator=gen, device=card).bfloat16()
    kp = torch.randn(nb, bs, hkv, 128, generator=gen, device=card).bfloat16()
    vp = torch.randn(nb, bs, hkv, 128, generator=gen, device=card).bfloat16()
    tables = (1 + torch.randperm(b * mb, generator=torch.Generator().manual_seed(1)))
    tables = tables.reshape(b, mb).to(device=card, dtype=torch.int32)
    off = torch.tensor((10, 40, 63), dtype=torch.int32, device=card)

    def step():
        return pool_decode_attention(q, kp, vp, tables, off, 0.09, max_live=64)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for offs in ((10, 40, 63), (100, 700, 64), (1500, 2047, 1024)):
        off.copy_(torch.tensor(offs, dtype=torch.int32, device=card))
        graph.replay()
        torch.cuda.synchronize()
        want = pool_decode_attention_plain(q, kp, vp, tables, off, 0.09)
        assert _rows_close(out, want, 1e-2), offs


def _sum_and_norm(hy):
    """Both outputs of the residual form in one tensor, so that one cotangent
    reaches both."""
    return hy[0] * 0.5 + hy[1]


def _grads(fn, *xs):
    xs = [x.detach().requires_grad_() for x in xs]
    y = fn(*xs)
    gen = torch.Generator(device=y.device)
    gen.manual_seed(0)
    # a contiguous cotangent: randn_like would follow y's strides, which
    # differ between the kernel's output and the plain version's
    c = torch.randn(y.shape, generator=gen, device=y.device).to(y.dtype)
    return torch.autograd.grad(y, xs, c)


@pytest.mark.cuda
def test_autograd_functions_match_plain_on_card(card):
    """Each kernel's autograd Function (the forward launches the kernel, the
    backward is kernel 8 or the plain gradient) against the plain versions'
    own autograd on the same card tensors: every gradient within 2e-2 of the
    largest value (bf16 operands, the products accumulate in another order)."""
    from gptq_for_llama_tpu_torch.ops.quant_matmul import fused_gate_up
    lin = _linear(512, 256, 4, 128, seed=1, device=card, actorder=True)
    gate = _linear(256, 384, 4, 128, seed=2, device=card)
    up = _linear(256, 384, 4, 128, seed=3, device=card)
    x = torch.randn(2, 9, 512, device=card).bfloat16()
    x2 = torch.randn(2, 9, 256, device=card).bfloat16()
    w = (1 + 0.1 * torch.randn(256, device=card)).bfloat16()
    q = torch.randn(1, 70, 4, 128, device=card).bfloat16()
    kv = torch.randn(1, 70, 2, 128, device=card).bfloat16()
    cases = [
        (lambda t: quant_matmul(t, lin), lambda t: quant_matmul_plain(t, lin), (x,), "qmm_t", 1),
        (lambda t: fused_gate_up(gate, up, t, "silu"),
         lambda t: fused_mlp_plain(t, gate, up), (x2,), "qmm_t", 2),
        (lambda t, ww: rms_norm(t, ww, 1e-6), lambda t, ww: rms_norm_plain(t, ww, 1e-6),
         (x2, w), "rms_norm", 1),
        (lambda t, rr, ww: _sum_and_norm(add_rms_norm(t, rr, ww, 1e-6)),
         lambda t, rr, ww: _sum_and_norm(add_rms_norm_plain(t, rr, ww, 1e-6)),
         (x2, x2.flip(1), w), "rms_norm:add", 1),
        (lambda a, b, c: flash_prefill(a, b, c, 0.09),
         lambda a, b, c: flash_prefill_plain(a, b, c, 0.09), (q, kv, kv.flip(1)),
         "flash_prefill", 1)]
    for fn, plain, xs, kernel, launches in cases:
        kernels.reset_launch_counts()
        got = _grads(fn, *xs)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[kernel] == launches, kernel
        for a, b in zip(got, _grads(plain, *xs)):
            assert _close(a, b, 2e-2), kernel


@pytest.mark.cuda
def test_kernel_wrappers_refuse_to_drop_a_gradient(card):
    """A wrapper fed a tensor that requires grad, outside its Function and
    with grad mode on, raises; under no_grad it runs."""
    from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention_cuda,
                                                             fused_decode_attention_cuda)
    from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import flash_prefill_cuda
    from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda
    from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import qmm_t_cuda
    from gptq_for_llama_tpu_torch.ops.cuda.norm import add_rms_norm_cuda, rms_norm_cuda
    lin = _linear(256, 128, 4, 128, seed=0, device=card)
    x = torch.randn(3, 256, device=card).bfloat16().requires_grad_()
    g = torch.randn(3, 128, device=card).bfloat16().requires_grad_()
    q = torch.randn(1, 1, 8, 128, device=card).bfloat16().requires_grad_()
    c = torch.randn(1, 16, 8, 128, device=card).bfloat16()
    calls = [lambda: qmm_cuda(x, lin), lambda: qmm_t_cuda(g, lin),
             lambda: rms_norm_cuda(x, x[0].detach(), 1e-6),
             lambda: add_rms_norm_cuda(x, x.detach(), x[0].detach(), 1e-6),
             lambda: flash_prefill_cuda(q, q, q, 0.1),
             lambda: decode_attention_cuda(q, c, c, 3, 0.1),
             lambda: fused_decode_attention_cuda(q, c, c, c[:, :1], c[:, :1], 3, 0.1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="gradient"):
            call()
        with torch.no_grad():
            call()


@pytest.mark.cuda
def test_lora_step_on_neox_at_head_dim_96(card):
    """A LoRA step of a 2-layer GPT-NeoX-shaped model at head dim 96 (4
    heads, hidden 384, NeoX-20B's rotary share, activation and parallel
    residual) over 1 x 256 tokens, so the forward runs kernel 5's wgmma body
    at D = 96 (the backward is the plain version's gradient): every adapter's
    gradient on the card (bf16, kernels) against the CPU plain path in fp32,
    ||g_card - g_cpu|| / ||g_cpu|| within 3x what two correct runs differ by
    (the CPU plain path in bf16 against fp32), chip_smoke.py's LoRA rule."""
    import torch.nn.functional as F
    from chip_smoke import _tree_to_cpu
    from gptq_for_llama_tpu_torch.engine import attach_lora, join_lora, split_lora
    from gptq_for_llama_tpu_torch.models import neox
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_neox
    cfg = ModelConfig(arch="neox", vocab_size=512, hidden_size=384, intermediate_size=1536,
                      num_layers=2, num_heads=4, num_kv_heads=4, head_dim=96, max_seq_len=512,
                      norm_eps=1e-5, rotary_pct=0.25, act="gelu_fast", parallel_residual=True,
                      attn_bias=True, mlp_bias=True)
    params = gaussian_wire_neox(cfg, seed=0, device=card, dtype=torch.bfloat16)
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    adapters, skeleton = split_lora(attach_lora("neox", params, rank=8, generator=gen))
    for ab in adapters:   # b nonzero: every a has a live gradient
        ab["b"] = (torch.randn(ab["b"].shape, generator=gen, device=card) * 0.01).to(ab["b"].dtype)
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256)))

    def grads(skel, device, dtype):
        ads = [{k: v.detach().to(device=device, dtype=dtype).requires_grad_()
                for k, v in ab.items()} for ab in adapters]
        x = ids.to(device)
        logits = neox.forward(join_lora(skel, ads), cfg, x)
        F.cross_entropy(logits[:, :-1].flatten(0, 1).float(), x[:, 1:].flatten()).backward()
        return [(ab["a"].grad.float().cpu(), ab["b"].grad.float().cpu()) for ab in ads]

    kernels.reset_launch_counts()
    got = grads(skeleton, card, torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill:wgmma:d96"] == cfg.num_layers
    want = grads(_tree_to_cpu(skeleton, torch.float32), "cpu", torch.float32)
    cpu16 = grads(_tree_to_cpu(skeleton, torch.bfloat16), "cpu", torch.bfloat16)

    def worst(g):
        return max(float((x - r).norm() / r.norm())
                   for xx, rr in zip(g, want) for x, r in zip(xx, rr))

    assert worst(got) <= 3 * worst(cpu16), (worst(got), worst(cpu16))


@pytest.mark.cuda
def test_lora_gradient_check_fails_on_a_planted_kernel_8_fault(card, tmp_path):
    """chip_smoke.py's 2-layer 7B-width LoRA gradient check has teeth: a copy
    of the port whose kernel 8 (its wgmma body, which the check's shapes
    take) reads the scale and zero of the next group (built from scratch in
    a temporary directory) fails it. Prints the
    check's reading (run with -s or -rA to see it)."""
    import pathlib
    import shutil
    import subprocess
    import sys
    import textwrap
    root = pathlib.Path(__file__).resolve().parents[1]
    shutil.copytree(root / "gptq_for_llama_tpu_torch", tmp_path / "gptq_for_llama_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(root / "chip_smoke.py", tmp_path)
    # the check's linears (g128, M = 128) take kernel 8's wgmma body: its
    # producer loads the scale and zero rows of the next group instead
    src = tmp_path / "gptq_for_llama_tpu_torch" / "csrc" / "qmm_wgmma.cuh"
    text, good = src.read_text(), "const int g_lo = group_of(o0, groupsize, G);"
    assert text.count(good) == 1
    src.write_text(text.replace(good, "const int g_lo = group_of(o0 + groupsize, groupsize, G);"))
    code = textwrap.dedent("""
        import torch
        import chip_smoke
        smoke = chip_smoke.Smoke()
        smoke.phase_card(torch)
        smoke.phase_build(torch)
        try:
            smoke._lora_grad_check(torch, None, "all seven linears, kernel 8 off by a group",
                                   "lora")
        except AssertionError as e:
            print("planted fault caught:", e)
            raise SystemExit(0)
        raise SystemExit(1)
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=900)
    print(run.stdout[-4000:], run.stderr[-4000:])
    assert run.returncode == 0 and "planted fault caught" in run.stdout


# ---------------------------------------------------------------------------
# caches stored in fp8 (e4m3, e5m2) and f32: kernels 3, 4, 7 and 9 read them
# ---------------------------------------------------------------------------

KV_DTYPES = {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2, "f32": torch.float32}


def _poisoned(cache, dead):
    """A copy of ``cache`` whose ``dead`` slots hold the dtype's NaN (e4m3 has
    none that the kernels read as NaN: its NaN code reads as 480, which
    moves any output row that attends it far past the tolerance)."""
    out = cache.clone()
    nan = kv_dtype.encode(torch.tensor([float("nan")], device=cache.device), cache.dtype)
    view = kv_dtype.stored(out)
    view[dead.expand(out.shape)] = nan.to(view.dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, *NEW_DIMS])
@pytest.mark.parametrize("name", list(KV_DTYPES))
def test_kernels_3_7_9_read_each_cache_dtype(card, name, d):
    """Kernels 3, 7 and 9 over a cache stored in ``name``, poisoned past each
    offset, against their plain versions (``kv_dtype.decode``): 1e-2 of each
    row's norm, as the bf16 cases; kernel 7 equals kernel 3 over the gathered
    view bit for bit; kernel 9's masked write leaves the caches byte-equal to
    the plain write's, an e4m3 overflow stored as the NaN code."""
    from gptq_for_llama_tpu_torch.ops.cuda.attention import (fused_decode_attention,
                                                             fused_decode_attention_plain)
    dt = KV_DTYPES[name]
    b, s, h, hkv = 3, 640, 8, 2
    offs = (0, 300, 639)
    q, k, v, _, _, off = _decode_case(card, b, s, h, hkv, offs, seed=7, d=d)
    k, v = kv_dtype.round_to(k, dt), kv_dtype.round_to(v, dt)
    dead = (torch.arange(s, device=card)[None, :] > off[:, None])[:, :, None, None]
    pk, pv = _poisoned(k, dead), _poisoned(v, dead)
    want = decode_attention_plain(q, k, v, off, 0.09)
    kernels.reset_launch_counts()
    for max_live in (None, 640, 100):
        got = decode_attention(q, pk, pv, off, 0.09, max_live)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and _rows_close(got, want, 1e-2), max_live
    # kernel 7 over the same values in a permuted pool of 16-slot blocks
    bs, mb = 16, s // 16
    perm = torch.randperm(b * mb, device=card)
    tables = perm.reshape(b, mb).int()
    kp = torch.empty((b * mb, bs, hkv, d), dtype=dt, device=card)
    vp = torch.empty_like(kp)
    kv_dtype.stored(kp)[perm] = kv_dtype.stored(pk).reshape(b * mb, bs, hkv, d)
    kv_dtype.stored(vp)[perm] = kv_dtype.stored(pv).reshape(b * mb, bs, hkv, d)
    got7 = pool_decode_attention(q, kp, vp, tables, off, 0.09, 640)
    got3 = decode_attention(q, pk, pv, off, 0.09, 640)
    torch.cuda.synchronize()
    assert torch.equal(got7, got3)
    assert _rows_close(pool_decode_attention_plain(q, kp, vp, tables, off, 0.09), want, 1e-5)
    # kernel 9: the stale prefix plus the current k/v, then the masked write
    kn = torch.randn(b, 1, hkv, d, device=card).bfloat16()
    vn = torch.randn(b, 1, hkv, d, device=card).bfloat16()
    kn[0, 0, 0, :4] = torch.tensor([600.0, -600.0, 464.0, 465.0])   # e4m3: NaN, NaN, 448, NaN
    fdead = (torch.arange(s, device=card)[None, :] >= off[:, None])[:, :, None, None]
    ck, cv = _poisoned(k, fdead), _poisoned(v, fdead)
    wk, wv = ck.clone(), cv.clone()
    mask = torch.tensor([True, False, True], device=card)
    fwant, _, _ = fused_decode_attention_plain(q, wk, wv, kn, vn, off, 0.09, write_mask=mask)
    fgot, _, _ = fused_decode_attention(q, ck, cv, kn, vn, off, 0.09, write_mask=mask,
                                        max_live=640)
    torch.cuda.synchronize()
    for a, b_ in ((ck, wk), (cv, wv)):   # bytes: NaN where NaN
        assert torch.equal(a.view(torch.uint8), b_.view(torch.uint8))
    live = torch.isfinite(fwant.float()).reshape(b, -1).all(1)
    assert live[1:].all() and _rows_close(fgot[live], fwant[live], 1e-2)
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 4 and counts["pool_decode_attention"] == 1
    assert counts["fused_decode_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, *NEW_DIMS])
@pytest.mark.parametrize("name", list(KV_DTYPES))
@pytest.mark.parametrize("sq,off", [(100, 0), (128, 128), (512, 0)])
def test_kernel_4_reads_each_cache_dtype(card, name, sq, off, d):
    """Kernel 4 over a cache stored in ``name``, NaN past the causal limit
    where the dtype has one, through the body its plan names (``plan_kv``)
    and through each body forced (at D = 256 the mma.sync body alone: the
    wgmma body forced there raises): 1e-2 of each row's norm against the
    plain version (the cache read through ``_load_bf16``'s rule), each body
    bit-equal to itself over the cache decoded to bf16; a graph captured at
    offset 0 replays at ``off`` bit-equal to the eager launch."""
    from gptq_for_llama_tpu_torch.ops.cuda import flash
    dt = KV_DTYPES[name]
    q = torch.randn(1, sq, 8, d, device=card).bfloat16()
    k, v = (kv_dtype.round_to(torch.randn(1, 1024, 2, d, device=card), dt) for _ in range(2))
    dead = (torch.arange(1024, device=card) >= off + sq)[None, :, None, None]
    pk, pv = _poisoned(k, dead), _poisoned(v, dead)
    want = flash_prefill_blocked_plain(q, k, v, off, d ** -0.5)
    body = flash.plan_kv(sq, off, dt, d)
    kernels.reset_launch_counts()
    got = flash_prefill_blocked(q, pk, pv, off, d ** -0.5)
    assert kernels.launch_counts()[f"flash_prefill_blocked:{body}:{name}"] == 1
    dk, dv = kv_dtype.decode(pk, torch.bfloat16), kv_dtype.decode(pv, torch.bfloat16)
    bodies = ("sync", "wgmma") if d in flash.WGMMA_KV_HEAD_DIMS else ("sync",)
    for b in bodies:
        forced = flash._launch(q, pk, pv, off, d ** -0.5, b)
        decoded = flash._launch(q, dk, dv, off, d ** -0.5, b)
        torch.cuda.synchronize()
        assert torch.isfinite(forced.float()).all() and _rows_close(forced, want, 1e-2), b
        assert torch.equal(forced.view(torch.int16), decoded.view(torch.int16)), b
        if b == body:
            assert torch.equal(got.view(torch.int16), forced.view(torch.int16))
    if d == 256:
        assert body == "sync"
        with pytest.raises(RuntimeError):
            flash._launch(q, pk, pv, off, d ** -0.5, "wgmma")
    dev_off = torch.zeros(1, dtype=torch.int32, device=card)
    g = torch.cuda.CUDAGraph()
    flash_prefill_blocked(q, pk, pv, dev_off, d ** -0.5, off + sq)
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        y = flash_prefill_blocked(q, pk, pv, dev_off, d ** -0.5, off + sq)
    dev_off.fill_(off)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, got)


@pytest.mark.cuda
def test_e4m3_upcast_is_bit_equal_on_every_code(card):
    """Every e4m3 code (0x7F and 0xFF included) as the one live slot's V row:
    kernels 3, 7, 9 and 4 (both its bodies) return it as bf16 bit for bit, the value
    ``kv_dtype.decode`` gives (+-480 for the two NaN codes), but for code
    0x80 (-0): a sum that starts at +0 gives +0, so values are compared."""
    from gptq_for_llama_tpu_torch.ops.cuda.attention import fused_decode_attention
    codes = torch.arange(256, dtype=torch.int32, device=card).to(torch.uint8)
    v = torch.zeros(1, 64, 2, 128, dtype=torch.uint8, device=card)
    v[0, 0] = codes.reshape(2, 128)
    v = v.view(torch.float8_e4m3fn)
    k = torch.zeros_like(v)
    q = torch.randn(1, 1, 2, 128, device=card).bfloat16()
    want = kv_dtype.decode(v[:, :1], torch.bfloat16)
    assert want[0, 0, 0, 0x7F].item() == 480.0 and want[0, 0, 1, 0x7F].item() == -480.0
    got3 = decode_attention(q, k, v, 0, 0.09)
    tables = torch.arange(4, dtype=torch.int32, device=card)[None]
    got7 = pool_decode_attention(q, k.reshape(4, 16, 2, 128), v.reshape(4, 16, 2, 128), tables,
                                 torch.zeros(1, dtype=torch.int32, device=card), 0.09)
    # kernel 9 at offset 1: slot 0 and the current token, whose k/v are zero
    # and whose logit equals slot 0's: the output is half of slot 0's V row
    got9, _, _ = fused_decode_attention(q, k, v, torch.zeros(1, 1, 2, 128, device=card).bfloat16(),
                                        torch.zeros(1, 1, 2, 128, device=card).bfloat16(), 1,
                                        0.09, write=False)
    got4 = flash_prefill_blocked(q, k, v, 0, 0.09)
    # kernel 4 planned for 2048 keys: past the crossover, its wgmma body
    kernels.reset_launch_counts()
    got4w = flash_prefill_blocked(q, k, v, 0, 0.09, 2048)
    assert kernels.launch_counts()["flash_prefill_blocked:wgmma:fp8"] == 1
    torch.cuda.synchronize()
    for got in (got3, got7, got4, got4w):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(got9, (want.float() / 2).bfloat16())


def _fp8_pair(card, **kw):
    """Two runners of the narrow model over fp8-e4m3 caches."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner
    cfg, params = _graph_model(card)
    return cfg, [ModelRunner("llama", cfg, params, max_seq_len=300, device=card,
                             kv_dtype=torch.float8_e4m3fn, **kw) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("cache_impl", ["classic", "fold"])
def test_fp8_runner_graphs_equal_the_eager_step_loop(card, cache_impl):
    """Over fp8-e4m3 caches: the prefill graph's logits and caches, and 60
    greedy tokens through decode_greedy_scan's graphs (across the bucket of
    128), equal the eager bodies' bit for bit; the caches are fp8 and hold
    half a bf16 cache's bytes."""
    cfg, (graph, eager) = _fp8_pair(card, cache_impl=cache_impl)
    prompt = torch.as_tensor(np.random.RandomState(1).randint(1, 512, size=(1, 100)),
                             device=card)
    lg, cache = graph.prefill(prompt, graph.init_cache())
    lge, cache_e = _eager(eager).prefill(prompt, eager.init_cache())
    torch.cuda.synchronize()
    assert torch.equal(lg.view(torch.int16), lge.view(torch.int16))
    assert all(t.dtype == torch.float8_e4m3fn for t in (*cache.k, *cache.v))
    assert kv_dtype.cache_bytes(cache.k) == 2 * 300 * 2 * 128   # layers x slots x heads x dim
    tok = lg[:, -1:].argmax(-1)
    toks, cache = graph.decode_greedy_scan(tok, cache, 60)
    want, t = [], tok
    for _ in range(60):
        lge, cache_e = eager._step(t, cache_e)
        t = lge[:, -1:].float().argmax(-1)
        want.append(t)
    torch.cuda.synchronize()
    assert torch.equal(toks, torch.cat(want, 1)) and cache.offset == 160
    for a, b in zip((*cache.k, *cache.v), (*cache_e.k, *cache_e.v)):
        assert torch.equal(kv_dtype.stored(a)[:, :160], kv_dtype.stored(b)[:, :160])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "dense_chunked"])
def test_fp8_engine_graphs_equal_eager(card, mode):
    """A paged (block 16, spans of 4) and a dense chunked engine over fp8-e4m3
    pools: the graphs' tokens equal the same bodies run eagerly, and every
    request's cache row is fp8."""
    from gptq_for_llama_tpu_torch.runtime import GenRequest, ServingEngine
    cfg, params = _graph_model(card)
    kw = {"paged": dict(paged=True, block_size=16, decode_span=4),
          "dense_chunked": dict(prefill_chunk=32)}[mode]
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, size=n) for n in (5, 20, 33, 70, 9, 130)]

    def run(eager):
        eng = ServingEngine("llama", cfg, params, batch_slots=4, max_seq_len=300,
                            prefill_buckets=(32, 128), kv_dtype=torch.float8_e4m3fn, **kw)
        if eager:
            _eager(eng)
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=40))
        res = eng.run()
        torch.cuda.synchronize()
        return res, eng

    want, _ = run(True)
    got, eng = run(False)
    for uid in range(len(prompts)):
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=f"request {uid}")
    assert all(t.dtype == torch.float8_e4m3fn for t in (*eng.state["k"], *eng.state["v"]))
    assert eng.stats()["kv_dtype"] == "float8_e4m3fn"


@pytest.mark.cuda
def test_kv_encoder_on_the_card_equals_the_cpu_and_kernel_9(card):
    """``kv_dtype.encode`` on the card gives the CPU's bytes (held to JAX's
    ``astype`` by tests/test_torch_kv_dtype.py) for every bf16 bit pattern, in
    both fp8 formats, and kernel 9's in-kernel row write stores the same
    bytes; NaN inputs apart, whose sign and payload are each encoder's own."""
    from gptq_for_llama_tpu_torch.ops.cuda.attention import fused_decode_attention
    x = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    keep = ~torch.isnan(x.float())
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        cpu = kv_dtype.encode(x, dt)
        assert torch.equal(kv_dtype.encode(x.to(card), dt).cpu()[keep], cpu[keep])
        kn = x.reshape(8, 1, 64, 128).to(card)
        ck = torch.zeros(8, 16, 64, 128, dtype=dt, device=card)
        cv = torch.zeros_like(ck)
        q = torch.zeros(8, 1, 64, 128, device=card).bfloat16()
        fused_decode_attention(q, ck, cv, kn, kn, 3, 0.1)
        torch.cuda.synchronize()
        for c in (ck, cv):
            assert torch.equal(kv_dtype.stored(c)[:, 3].reshape(-1).cpu()[keep], cpu[keep])


# -- OPT, GPT-NeoX, GPT-2 (A11) and fused q/k/v (A4) --------------------------

def _arch_model(card, name, seed=0):
    """A 2-layer packed model of ``name`` at a small width whose head dim is
    the family's own (NeoX-20B 96, OPT-2.7B 80, GPT-2 64)."""
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime.random_model import GAUSSIAN_WIRE
    d = {"neox": 96, "opt": 80, "gpt2": 64}[name]
    spec = {"neox": dict(rotary_pct=0.25, act="gelu_fast", parallel_residual=True),
            "opt": dict(act="relu", pos_embedding="learned", tie_word_embeddings=True),
            "gpt2": dict(act="gelu_new", pos_embedding="learned", tie_word_embeddings=True)}
    heads = 8 if name == "opt" else 4   # hidden a multiple of the group size, 128
    cfg = ModelConfig(arch=name, vocab_size=512, hidden_size=heads * d, intermediate_size=1024,
                      num_layers=2, num_heads=heads, num_kv_heads=heads, head_dim=d,
                      max_seq_len=512,
                      norm_eps=1e-5, attn_bias=True, mlp_bias=True, **spec[name])
    return cfg, GAUSSIAN_WIRE[name](cfg, seed=seed, device=card, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["neox", "opt", "gpt2"])
def test_arch_runner_graphs_equal_the_eager_step_loop(card, name):
    """A new family's decode_greedy_scan graphs give the eager ``_step``
    loop's tokens, and its prefill and decode graphs its logits, bit for bit;
    the attention kernels launch under the family's head dim; learned
    positions come from the device offsets inside the graphs."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner
    cfg, params = _arch_model(card, name)
    d = cfg.head_dim
    prompt = torch.as_tensor(np.random.RandomState(2).randint(1, 512, size=(1, 50)),
                             device=card)
    graph = ModelRunner(name, cfg, params, max_seq_len=300, device=card)
    eager = _eager(ModelRunner(name, cfg, params, max_seq_len=300, device=card))
    lg, cache = eager._step(prompt, eager.init_cache())
    tok, want = lg[:, -1:].argmax(-1), []
    for _ in range(40):
        lg, cache = eager._step(tok, cache)
        tok = lg[:, -1:].float().argmax(-1)
        want.append(tok)
    lgg, cache = graph.prefill(prompt, graph.init_cache())
    lge, _ = eager._step(prompt, eager.init_cache())
    assert torch.equal(lgg.view(torch.int16), lge.view(torch.int16))
    kernels.reset_launch_counts()
    toks, cache = graph.decode_greedy_scan(lgg[:, -1:].argmax(-1), cache, 40)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert torch.equal(toks, torch.cat(want, 1)) and cache.offset == 90
    assert counts["decode_attention"] == counts[f"decode_attention:d{d}"] > 0
    assert counts["fused_mlp"] == counts["rms_norm"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "paged", "fold"])
def test_neox_engine_graphs_equal_eager(card, mode):
    """The serving engine over a NeoX-family model (D = 96): the graphs'
    tokens equal the same engine's with every body run eagerly, and the
    attention kernels launch under D = 96."""
    from gptq_for_llama_tpu_torch.runtime import GenRequest, ServingEngine
    cfg, params = _arch_model(card, "neox", seed=3)
    kw = {"dense": dict(prefill_chunk=64), "paged": dict(paged=True, block_size=16),
          "fold": dict(cache_impl="fold")}[mode]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, size=n) for n in (30, 90, 7, 150, 61)]
    out = []
    for eager in (False, True):
        eng = ServingEngine("neox", cfg, params, batch_slots=4, max_seq_len=256, device=card,
                            decode_span=4, **kw)
        if eager:
            _eager(eng)
        kernels.reset_launch_counts()
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=12))
        out.append(eng.run())
        counts = kernels.launch_counts()
        attn = {"dense": "decode_attention", "paged": "pool_decode_attention",
                "fold": "fused_decode_attention"}[mode]
        assert counts[attn] == counts[f"{attn}:d96"] > 0
    for uid in out[0]:
        np.testing.assert_array_equal(out[0][uid], out[1][uid])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 100])
def test_fused_qkv_columns_match_the_unfused_launches(card, m):
    """Kernel 1 over ``concat_outputs`` of q/k/v (4096 x 12288): its columns
    within kernel 1's tolerance of the three unfused launches (2e-2 of the
    largest; the plans may split K otherwise) and of the plain version, and
    bit-equal to the three launches under the fused launch's plan (the same
    K split); one launch in place of three."""
    from gptq_for_llama_tpu_torch.ops.cuda.matmul import _launch, plan_for
    lins = [_linear(4096, 4096, 4, 128, seed=s, device=card) for s in range(3)]
    fused = PackedLinear.concat_outputs(lins)
    x = torch.randn(m, 4096, device=card).bfloat16()
    kernels.reset_launch_counts()
    y = quant_matmul(x, fused)
    assert kernels.launch_counts()["qmm"] == 1
    unf = torch.cat([quant_matmul(x, lin) for lin in lins], dim=-1)
    forced = torch.cat([_launch(x, lin, plan_for(x, fused)) for lin in lins], dim=-1)
    torch.cuda.synchronize()
    assert _close(y, unf, 2e-2) and _close(y, quant_matmul_plain(x, fused), 2e-2)
    assert torch.equal(y, forced)


@pytest.mark.cuda
def test_runner_fuse_qkv_on_the_card(card):
    """ModelRunner(fuse_qkv=True) over a packed LLaMA: 3 kernel-1 launches a
    layer for a decode token in place of 5, and the greedy tokens of the
    fused and unfused runners agree where both are clear (the fused product
    may sum in another order)."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner
    cfg, params = _graph_model(card)
    prompt = torch.as_tensor(np.random.RandomState(3).randint(1, 512, size=(1, 40)),
                             device=card)
    per = {}
    for fuse in (False, True):
        r = ModelRunner("llama", cfg, params, max_seq_len=128, device=card, fuse_qkv=fuse)
        lg, cache = r.prefill(prompt, r.init_cache())
        kernels.reset_launch_counts()
        f0 = r.forwards["decode"]
        toks, _ = r.decode_greedy_scan(lg[:, -1:].argmax(-1), cache, 16)
        per[fuse] = kernels.launch_counts()["qmm"] / (r.forwards["decode"] - f0)
    assert per == {False: 5.0 * cfg.num_layers, True: 3.0 * cfg.num_layers}


def _offload_model(card, layers=4):
    """``_graph_model``'s LLaMA at ``layers`` layers, its parameters on the CPU
    (as the CLI loads them for --pre-layer) and on the card."""
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime.offload import map_tensors
    from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=layers, num_heads=2, num_kv_heads=2, head_dim=128,
                      max_seq_len=300)
    params = gaussian_wire_llama(cfg, seed=0, device=card)
    return cfg, params, map_tensors(params, lambda t: t.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("pre_layer", [0, 1, 3])
def test_offload_is_bit_equal_to_the_resident_runner(card, pre_layer):
    """OffloadRunner from host parameters, the streamed layers pinned: the
    prompt logits and 40 greedy tokens equal the resident runner's
    generate(span=1) bit for bit (the same step bodies: the prefill graph's,
    the decode graph's, here run eagerly), the cache-less forward equals
    ``llama.forward`` and the perplexity the resident eval's; every forward
    stages each streamed layer once; kernels 1, 2, 3, 4, 5 and 6 launch."""
    from gptq_for_llama_tpu_torch.engine import perplexity
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
    from gptq_for_llama_tpu_torch.runtime.offload import OffloadRunner, tensors
    cfg, params, host = _offload_model(card)
    off = OffloadRunner("llama", cfg, host, pre_layer, max_seq_len=300, device=card)
    assert all(t.is_pinned() for h in off.host_layers for t in tensors(h))
    assert all(t.is_cuda for s in off.layers.slots for t in tensors(s))
    res = ModelRunner("llama", cfg, params, max_seq_len=300, device=card)
    prompt = np.random.RandomState(5).randint(1, 512, size=37)
    kernels.reset_launch_counts()
    got = off.generate(prompt, max_new_tokens=40)
    counts = kernels.launch_counts()
    assert np.array_equal(got, generate(res, prompt, max_new_tokens=40, temperature=0.0, span=1))
    assert off.layers.staged_bytes == off.streamed_bytes * sum(off.forwards.values())
    assert all(counts[k] > 0 for k in ("qmm", "fused_mlp", "decode_attention",
                                       "flash_prefill_blocked", "rms_norm"))
    ids = torch.as_tensor(prompt[None], device=card)
    lo, _ = off.prefill(ids, off.init_cache())
    lr, _ = res.prefill(ids, res.init_cache())
    assert torch.equal(lo, lr)
    assert torch.equal(off.forward(ids), llama.forward(params, cfg, ids))
    stream = np.random.RandomState(6).randint(1, 512, size=4 * 64)
    assert off.perplexity(stream, 64) == perplexity("llama", cfg, params, stream, seqlen=64)


@pytest.mark.cuda
def test_offload_staging_waits_for_the_slot(card, monkeypatch):
    """Each layer held 2 ms on the compute stream before its kernels, so the
    copies run far ahead: with the side stream's wait for the slot's last
    reader the logits are the resident model's bit for bit; without it
    (``_after`` a no-op) layer i + 2's bytes land under layer i and the
    logits differ."""
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.runtime.offload import OffloadRunner
    cfg, params, host = _offload_model(card)
    real = llama.layer

    def held(*args, **kw):
        torch.cuda._sleep(4_000_000)   # about 2 ms of the H100's 1.98 GHz clock
        return real(*args, **kw)

    monkeypatch.setattr(llama, "layer", held)
    ids = torch.as_tensor(np.random.RandomState(7).randint(1, 512, size=(1, 64)), device=card)
    want = llama.forward(params, cfg, ids)
    off = OffloadRunner("llama", cfg, host, 0, max_seq_len=300, device=card)
    assert torch.equal(off.forward(ids), want)
    monkeypatch.setattr(off.layers, "_after", lambda slot: None)
    assert not torch.equal(off.forward(ids), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m", [("fwd", 8), ("mlp", 1), ("bwd", 256)])
def test_autotune_race_picks_a_valid_plan(card, tmp_path, monkeypatch, kind, m):
    """A race over four linears (pairs) of one shape on the card: every
    candidate timed once, the winner among them, written to the cache file
    under the card's name; the kernel's ``plan_for`` then takes it, and its
    output matches the plain version (kernel 1's tolerance); a second race is
    a cache hit."""
    from gptq_for_llama_tpu_torch.ops.cuda import autotune, matmul, matmul_t, mlp
    from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import quant_matmul_t_plain, qmm_t_cuda
    monkeypatch.setenv(autotune.MODE_ENV, "1")
    monkeypatch.setenv(autotune.PATH_ENV, str(tmp_path / "tune.json"))
    autotune.configure()
    lins = [_linear(1024, 2048, 4, 128, seed, card) for seed in range(4)]
    sms = matmul._sm_count(0)
    cands = autotune.candidates(kind, 1024, 2048, 4, 128, m, sms)
    if kind == "mlp":
        won = autotune.tune_mlp([(lins[0], lins[1]), (lins[2], lins[3])], m)
    else:
        won = autotune.tune_qmm(lins, m, kind)
    assert won in cands and autotune.measurements == len(cands)
    with open(tmp_path / "tune.json") as f:
        (name,) = json.load(f)["entries"]
    assert name.endswith(autotune.device_name(card))
    x = torch.randn(m, 2048 if kind == "bwd" else 1024, device=card).bfloat16()
    if kind == "fwd":
        assert matmul.plan_for(x, lins[0]) == won
        got, want = quant_matmul(x, lins[0]), quant_matmul_plain(x, lins[0])
    elif kind == "mlp":
        assert mlp.plan_for(x, lins[0]) == won
        got, want = fused_mlp(x, lins[0], lins[1]), fused_mlp_plain(x, lins[0], lins[1])
    else:
        assert matmul_t.plan_for(x, lins[0]) == won
        got, want = qmm_t_cuda(x, lins[0]), quant_matmul_t_plain(x, lins[0])
    torch.cuda.synchronize()
    assert _close(got, want, 2e-2)
    again = (autotune.tune_mlp([(lins[0], lins[1])], m) if kind == "mlp" else
             autotune.tune_qmm(lins, m, kind))
    assert again == won and autotune.measurements == len(cands)


@pytest.mark.cuda
def test_offload_streams_mixed_shapes_bit_equal_to_the_resident_runner(card):
    """Streamed layers of different shapes (INT4 g128, INT4 g64 act-order,
    INT8 g128 down_proj): each staged at its own shapes into views of the
    two byte slots, sized for the largest; the prompt logits and 24 greedy
    tokens equal the resident runner's generate(span=1) bit for bit."""
    from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
    from gptq_for_llama_tpu_torch.runtime.offload import OffloadRunner, map_tensors, tensors
    from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
    cfg, params, _ = _offload_model(card)
    other = gaussian_wire_llama(cfg, seed=1, groupsize=64, device=card, act_order=True)
    wide = gaussian_wire_llama(cfg, seed=2, bits=8, device=card)
    params["layers"][2] = other["layers"][2]
    params["layers"][3] = dict(params["layers"][3],
                               mlp=dict(params["layers"][3]["mlp"],
                                        down_proj=wide["layers"][3]["mlp"]["down_proj"]))
    host = map_tensors(params, lambda t: t.cpu())
    off = OffloadRunner("llama", cfg, host, 1, max_seq_len=300, device=card)
    assert len({tuple(t.shape for t in tensors(h)) for h in off.host_layers}) == 3
    res = ModelRunner("llama", cfg, params, max_seq_len=300, device=card)
    prompt = np.random.RandomState(7).randint(1, 512, size=29)
    got = off.generate(prompt, max_new_tokens=24)
    assert np.array_equal(got, generate(res, prompt, max_new_tokens=24, temperature=0.0, span=1))
    ids = torch.as_tensor(prompt[None], device=card)
    lo, _ = off.prefill(ids, off.init_cache())
    lr, _ = res.prefill(ids, res.init_cache())
    assert torch.equal(lo, lr)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_kernels_at_tp_shard_shapes_match_their_plain_versions(card, tp):
    """One LLaMA-7B-width layer, act-order, prepared for tp and cut into each
    rank's shards (``parallel/tp_model``): kernel 1 on every column shard
    (q/k/v) and row shard (o_proj; down_proj K-padded to 11264, its row map
    applied to the activation first, as ``row_parallel_apply`` does), kernel
    2 on the gate/up shards (tp 4: 2752 columns padded to 2816, the padded
    columns exactly 0), each against its plain version at M = 1 and 8; the
    rank's partial sums add up to the unsharded layer's output."""
    import dataclasses
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.parallel import tp_model
    from gptq_for_llama_tpu_torch.parallel.sharding import Mesh
    from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
    cfg = ModelConfig(arch="llama", vocab_size=256, hidden_size=4096, intermediate_size=11008,
                      num_layers=1, num_heads=32, num_kv_heads=32, head_dim=128, max_seq_len=64)
    params = gaussian_wire_llama(cfg, seed=3, device=card, act_order=True)
    prepared = tp_model.prepare_tp_params("llama", params, tp)
    gen = torch.Generator(device=card).manual_seed(tp)
    for m in (1, 8):
        x = torch.randn(m, 4096, generator=gen, device=card).bfloat16()
        h = torch.randn(m, 11008, generator=gen, device=card).bfloat16()
        down_sum = 0
        for r in range(tp):
            mesh = Mesh(tp=tp, dp=1, rank=r, tp_rank=r, dp_rank=0, device=card)
            lp = tp_model.shard_params("llama", prepared, mesh)["layers"][0]
            att, mlp = lp["self_attn"], lp["mlp"]
            for lin in (att["q_proj"], att["v_proj"]):
                assert lin.out_features == 4096 // tp
                assert _close(quant_matmul(x, lin), quant_matmul_plain(x, lin), 2e-2)
            o = dataclasses.replace(att["o_proj"], perm=None, perm_sig=None)
            xo = x[:, r * 4096 // tp:(r + 1) * 4096 // tp]
            assert _close(quant_matmul(xo, o), quant_matmul_plain(xo, o), 2e-2)
            y = fused_mlp(x, mlp["gate_proj"], mlp["up_proj"])
            assert _close(y, fused_mlp_plain(x, mlp["gate_proj"], mlp["up_proj"]), 2e-2)
            n_local = 11008 // tp
            assert y.shape[-1] == -(-n_local // 128) * 128
            assert torch.count_nonzero(y[:, n_local:]) == 0
            down = mlp["down_proj"]
            assert down.perm is not None and down.in_features == 11264 // tp
            # the gathered activation with the shards' zero pad columns
            pad = y.shape[-1] - n_local
            hg = torch.cat([torch.nn.functional.pad(c, (0, pad)) for c in h.split(n_local, -1)],
                           -1)
            xd = hg.index_select(-1, down.perm)
            local = dataclasses.replace(down, perm=None, perm_sig=None)
            got = quant_matmul(xd, local)
            assert _close(got, quant_matmul_plain(xd, local), 2e-2)
            down_sum = down_sum + got.float()
        full = params["layers"][0]["mlp"]["down_proj"]
        assert _close(down_sum.bfloat16(), quant_matmul_plain(h, full), 2e-2)
