"""A CPU model of the decode-width forms of kernels 1 and 2 held against the
TPU package's kernels and the port's plain versions.

The model repeats the arithmetic of ``csrc/qmm_decode.cuh``,
``csrc/qmm_gemv.cuh`` and ``csrc/qmm_frag.cuh`` in fp32 numpy under the plan
the wrapper launches (``ops/cuda/matmul.plan``): the batch-1 decode form
rounds each weight to bf16 as the plain version does, each of its 8 or 16
consumer warps sums its slice of every stage's word rows in fp32, stage by
stage, and the warps add in warp order (no K split); the GEMV keeps the
codes exact in fp32 and sums
x . codes per group segment of each warp's run of packed words, then applies
s_g * (x_g . c_g - z_g * sum(x_g)) (dot-then-scale; a word that a group
boundary cuts is summed row by row); the fragment form rounds each weight to
bf16 as the plain version does and sums each warp's K-blocks in fp32. Either
way the 8 warps of a block add in warp order, the blocks of a cluster (the K
splits) in rank order, and the epilogue adds the bias or takes silu(g) * u
in fp32 before one rounding to bf16.

Inputs are made from a seed with numpy and loaded by both packages. The
tolerance is the GEMV's on the card: 2e-2 * max|y|. The Pallas kernel runs in
interpret mode where it takes the shape (``supports``: no ragged last group,
N % 128 == 0, groups aligned to packed words); the XLA reference and the
port's plain version take every case.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear, quant_matmul_xla
from gptq_for_llama_tpu.ops.pallas import matmul as jmm
from gptq_for_llama_tpu.ops.pallas import mlp as jmlp
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu_torch.ops.cuda import matmul
from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp_plain
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear, quant_matmul_plain
from gptq_for_llama_tpu_torch.quant import packing

SMS = 132   # the H100 SXM's SMs
TOL = 2e-2  # of max|y|
F32 = np.float32


def _wire(k, n, bits, gs, seed, actorder=False, perm_seed=None):
    """Wire buffers: 2, 4 or 8 bits, groupsize ``gs`` (a ragged last group
    where it does not divide K), the rows shuffled by act-order."""
    rng = np.random.RandomState(seed)
    g = -(-k // gs)
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if actorder:
        p = np.random.RandomState(seed if perm_seed is None else perm_seed).permutation(k)
        codes, g_idx = codes[p], g_idx[p]
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    return dict(qweight=jpack.pack_rows(codes, bits), qzeros=jpack.pack_cols(zeros - 1, bits),
                scales=(rng.rand(g, n) * 0.02 + 0.005).astype(np.float16), g_idx=g_idx)


def _bf16(a):
    return torch.as_tensor(np.asarray(a, F32)).bfloat16().float().numpy()


def _device_arrays(lin):
    """What the kernels read, as fp32 numpy: codes (K, N) in device row order,
    scales and zeros (G, N) as bf16 values."""
    codes = packing.unpack_rows_torch(lin.qweight, lin.bits, k=lin.in_features).numpy()
    return (codes.astype(F32), lin.scales.float().numpy().astype(F32),
            lin.zeros.float().numpy().astype(F32))


def _gemv_partials(x, codes, s, z, bits, gs, plan):
    """Kernel 1/2's GEMV, one stream: fp32 (M, N) sums of each cluster rank
    (K split), each the 8 warps' sums added in warp order."""
    ipw = 32 // bits
    k = codes.shape[0]
    kw, g_count = k // ipw, s.shape[0]
    m = x.shape[0]
    inf = 1 << 62
    ranks = []
    for y in range(plan.split):
        w0, w1 = y * plan.per_split, min(kw, (y + 1) * plan.per_split)
        per_warp = -(-max(0, w1 - w0) // 8)
        block = np.zeros((m, codes.shape[1]), F32)
        for warp in range(8):
            wa = w0 + warp * per_warp
            st = {"g": -1, "next": 0, "acc": np.zeros_like(block), "p": None, "sx": None}

            def flush():
                if st["g"] >= 0:
                    g = st["g"]
                    st["acc"] += s[g] * (st["p"] - z[g] * st["sx"][:, None])

            def start(g):
                st["g"], st["next"] = g, inf if g >= g_count - 1 else (g + 1) * gs
                st["p"], st["sx"] = np.zeros_like(block), np.zeros(m, F32)

            for wd in range(wa, min(w1, wa + per_warp)):
                r0 = wd * ipw
                if st["g"] < 0 or r0 + ipw > st["next"]:
                    g0 = min(r0 // gs, g_count - 1)
                    end0 = inf if g0 >= g_count - 1 else (g0 + 1) * gs
                    if r0 + ipw > end0:   # a group boundary inside the word: row by row
                        for r in range(r0, r0 + ipw):
                            if st["g"] < 0 or r >= st["next"]:
                                flush()
                                start(min(r // gs, g_count - 1))
                            st["sx"] += x[:, r]
                            st["p"] += x[:, r, None] * codes[r]
                        continue
                    if g0 != st["g"]:
                        flush()
                        start(g0)
                for j4 in range(r0, r0 + ipw, 4):
                    xv = x[:, j4:j4 + 4]
                    st["sx"] += (xv[:, 0] + xv[:, 1]) + (xv[:, 2] + xv[:, 3])
                    for r in range(j4, j4 + 4):
                        st["p"] += x[:, r, None] * codes[r]
            flush()
            block += st["acc"]
        ranks.append(block)
    return ranks


def _frag_partials(x, codes, s, z, bits, gs, plan):
    """Kernel 1/2's fragment form, one stream: the weight rounded to bf16 as
    the plain version rounds it, each warp's run of K-blocks (128 / bits
    rows) summed in fp32, warps in order; one (M, N) sum per cluster rank."""
    k = codes.shape[0]
    gid = np.minimum(np.arange(k) // gs, s.shape[0] - 1)
    w = _bf16((codes - z[gid]) * s[gid])
    kb = matmul.frag_rows_per_block(bits)
    nkb = -(-k // kb)
    ranks = []
    for y in range(plan.split):
        b0, b1 = y * plan.per_split, min(nkb, (y + 1) * plan.per_split)
        per_warp = -(-max(0, b1 - b0) // 8)
        block = np.zeros((x.shape[0], codes.shape[1]), F32)
        for warp in range(8):
            acc = np.zeros_like(block)
            for b in range(b0 + warp * per_warp, min(b1, b0 + (warp + 1) * per_warp)):
                acc += x[:, b * kb:(b + 1) * kb] @ w[b * kb:(b + 1) * kb]
            block += acc
        ranks.append(block)
    return ranks


def _decode_partials(x, codes, s, z, bits, gs, plan, warps):
    """Kernel 1/2's batch-1 decode form, one stream: the weight rounded to
    bf16, warp w of ``warps`` summing rows [w * R / warps, (w + 1) * R /
    warps) of every stage of R = ``plan.per_split`` packed word rows in
    stage order, in fp32; the warps in order; one (M, N) sum (no K split)."""
    assert x.shape[0] <= matmul.DEC_MAX_M and plan.split == 1
    k = codes.shape[0]
    kr = 32 // bits
    kw = k // kr
    gid = np.minimum(np.arange(k) // gs, s.shape[0] - 1)
    w = _bf16((codes - z[gid]) * s[gid])
    rows = plan.per_split
    part = rows // warps
    assert part % 8 == 0   # whole octets a warp
    block = np.zeros((x.shape[0], codes.shape[1]), F32)
    for warp in range(warps):
        acc = np.zeros_like(block)
        for r0 in range(0, kw, rows):
            a, b = r0 + warp * part, min(kw, r0 + (warp + 1) * part)
            if a < b:
                acc += x[:, a * kr:b * kr] @ w[a * kr:b * kr]
        block += acc
    return [block]


def _model(x, lins, plan, bias=None, warps=None):
    """The kernel's output for plan ``plan`` (its form, rows and K split):
    each stream's rank sums added in rank order, then the epilogue, one
    rounding to bf16. The decode form's consumer warps are its geometry's
    on the H100 unless ``warps`` gives them."""
    if plan.path == "decode" and warps is None:
        lin = lins[0]
        geo = matmul.decode_geometry(lin.in_features, lin.out_features, lin.bits, SMS,
                                     len(lins), lin.groupsize, lin.scales.shape[0],
                                     plan.per_split, plan.mt)
        warps = matmul.decode_warps(len(lins) * geo.strips)
    sums = []
    for lin in lins:
        codes, s, z = _device_arrays(lin)
        total = np.zeros((x.shape[0], lin.out_features), F32)
        args = (x, codes, s, z, lin.bits, lin.groupsize, plan)
        parts = (_decode_partials(*args, warps) if plan.path == "decode" else
                 _gemv_partials(*args) if plan.path == "gemv" else _frag_partials(*args))
        for part in parts:
            total += part
        sums.append(total)
    if len(sums) == 2:
        g, u = sums
        with np.errstate(over="ignore"):   # exp(-g) = inf: silu(g) = -0, as __expf gives
            y = g / (F32(1) + np.exp(-g)) * u
    else:
        y = sums[0] if bias is None else sums[0] + bias
    return _bf16(y)


def _loaded(w, bits, bias=None):
    """The same wire buffers in both packages: the port's bf16 device layout
    (what the kernel reads) and JAX's fp32 one."""
    return (PackedLinear.from_wire(**w, bits=bits, bias=bias, dtype=torch.bfloat16, device="cpu"),
            JaxPackedLinear.from_wire(**w, bits=bits, bias=bias, dtype=jnp.float32))


def _close(got, want):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


# (bits, K, N, groupsize, act-order, bias): 2, 4 and 8 bits; a ragged last
# group (K = 1144: 9 groups of 128, the last 120 rows); group sizes the
# fragment form refuses, whose boundaries cut packed words (40 at 2 and 4
# bits; K = 576 in groups of 128, which the wire derives as 5 groups of 116);
# act-order; a bias
KERNEL_1_CASES = [(4, 512, 128, 128, False, False), (2, 512, 256, 64, False, True),
                  (8, 256, 128, 32, True, False), (4, 1144, 128, 128, False, True),
                  (4, 576, 128, 128, False, False), (8, 320, 128, 96, False, False),
                  (4, 520, 128, 40, False, False), (2, 560, 128, 40, True, True),
                  (4, 512, 256, 128, True, True)]


@pytest.mark.parametrize("bits,k,n,gs,actorder,bias", KERNEL_1_CASES)
@pytest.mark.parametrize("m", [1, 2, 8, 16])
def test_kernel_1_model_matches_pallas_and_plain(bits, k, n, gs, actorder, bias, m):
    """Kernel 1 under the plan the wrapper launches at M = 1 (the decode form
    where the group size suits it), 2, 8 and 16 (the fragment form where the
    group size suits it; else, and at M = 1, the GEMV),
    held against the Pallas kernel (interpret mode, where it takes the
    shape), JAX's XLA reference and the port's plain version."""
    rng = np.random.RandomState(100 * bits + m)
    w = _wire(k, n, bits, gs, seed=k + bits, actorder=actorder)
    b = rng.randn(n).astype(np.float16) if bias else None
    lin, jlin = _loaded(w, bits, b)
    x = _bf16(rng.standard_normal((m, k)))
    p = matmul.plan(m, k, n, bits, SMS, groupsize=lin.groupsize)
    frag = matmul.frag_ok(k, n, bits, lin.groupsize)
    assert p.path == ("gemv" if not frag else "decode" if m <= matmul.DEC_MAX_M else
                      "gemv" if m <= matmul.GEMV_MAX_M else "frag")
    xp = x if lin.perm is None else x[:, lin.perm.numpy()]
    got = _model(xp, [lin], p, None if b is None else _bf16(lin.bias.float().numpy()))
    _close(got, quant_matmul_plain(torch.as_tensor(x).bfloat16(), lin).float().numpy())
    _close(got, quant_matmul_xla(jnp.asarray(x), jlin, dtype=jnp.float32))
    if jmm.supports(jlin):
        _close(got, jmm.quant_matmul_pallas(jnp.asarray(x), jlin, interpret=True))


@pytest.mark.parametrize("path", ["gemv", "frag"])
@pytest.mark.parametrize("cap", [1, 2, 4, 8, 16])
def test_kernel_1_model_is_the_same_at_every_split(path, cap):
    """The K split of either form only regroups the fp32 sums: the model
    under clusters of 1 to 16 blocks stays within the tolerance of the
    plain version (4 bits, groupsize 32, act-order, a bias, M = 4, K deep
    enough for 16 splits of either form)."""
    rng = np.random.RandomState(cap)
    w = _wire(8192, 128, 4, 32, seed=7, actorder=True)
    lin, _ = _loaded(w, 4, rng.randn(128).astype(np.float16))
    x = _bf16(rng.standard_normal((4, 8192)))
    make = matmul._gemv_plan if path == "gemv" else matmul._frag_plan
    p = make(4, 8192, 128, 4, SMS, 1, cap=cap)
    assert p.split == cap and p.path == path
    got = _model(x[:, lin.perm.numpy()], [lin], p, _bf16(lin.bias.float().numpy()))
    _close(got, quant_matmul_plain(torch.as_tensor(x).bfloat16(), lin).float().numpy())


# (bits, K, N, groupsize, act-order) of kernel 2: gate and up share one
# act-order permutation, as a GPTQ checkpoint's two MLP inputs do
KERNEL_2_CASES = [(4, 512, 128, 128, False), (2, 512, 128, 64, False), (8, 256, 256, 32, True),
                  (4, 1144, 128, 128, False), (4, 520, 128, 40, False)]


@pytest.mark.parametrize("bits,k,n,gs,actorder", KERNEL_2_CASES)
@pytest.mark.parametrize("m", [1, 2, 8, 16])
def test_kernel_2_model_matches_pallas_and_plain(bits, k, n, gs, actorder, m):
    """Kernel 2 (the SiLU-mul epilogue over two streams) under the plan the
    wrapper launches: the decode form at M = 1 and the fragment form up to 16
    rows where the group size suits them, else the GEMV."""
    rng = np.random.RandomState(200 * bits + m)
    gate, jgate = _loaded(_wire(k, n, bits, gs, seed=k, actorder=actorder, perm_seed=5), bits)
    up, jup = _loaded(_wire(k, n, bits, gs, seed=k + 1, actorder=actorder, perm_seed=5), bits)
    x = _bf16(rng.standard_normal((m, k)))
    p = matmul.plan(m, k, n, bits, SMS, streams=2, groupsize=gate.groupsize)
    frag = matmul.frag_ok(k, n, bits, gate.groupsize)
    assert p.path == ("gemv" if not frag or (m > 1 and m <= matmul.FUSED_GEMV_MAX_M) else
                      "decode" if m <= matmul.DEC_MAX_M else "frag")
    xp = x if gate.perm is None else x[:, gate.perm.numpy()]
    got = _model(xp, [gate, up], p)
    _close(got, fused_mlp_plain(torch.as_tensor(x).bfloat16(), gate, up).float().numpy())
    if jmm.supports(jgate):
        _close(got, jmlp.fused_mlp_pallas(jnp.asarray(x), jgate, jup, interpret=True))


@pytest.mark.parametrize("rows,warps", [(64, 8), (128, 8), (128, 16), (256, 16)])
@pytest.mark.parametrize("streams", [1, 2])
def test_decode_model_is_the_same_at_every_stage_depth(rows, warps, streams):
    """The decode form's stage depth (packed word rows a stage) and its
    consumer warps (8 or 16, so each warp's slice of a stage) only regroup
    the fp32 sums: under 64, 128 and 256 rows a stage the model stays within
    the tolerance of the plain version
    and of JAX's XLA reference (4 bits, groupsize 32, act-order, K = 4104 =
    513 word rows: a ragged last stage and a last group of 8 rows; a bias
    for kernel 1, the SiLU-mul for kernel 2)."""
    rng = np.random.RandomState(rows + streams)
    k, n = 4104, 128
    lins = [_loaded(_wire(k, n, 4, 32, seed=s, actorder=True, perm_seed=3), 4,
                    rng.randn(n).astype(np.float16) if streams == 1 else None)
            for s in range(streams)]
    x = _bf16(rng.standard_normal((1, k)))
    p = matmul.Plan("decode", 1, 1, rows, 0)   # warps given: the strips are not read
    port = [lin for lin, _ in lins]
    xp = x[:, port[0].perm.numpy()]
    xt = torch.as_tensor(x).bfloat16()
    if streams == 1:
        got = _model(xp, port, p, _bf16(port[0].bias.float().numpy()), warps)
        _close(got, quant_matmul_plain(xt, port[0]).float().numpy())
        _close(got, quant_matmul_xla(jnp.asarray(x), lins[0][1], dtype=jnp.float32))
    else:
        got = _model(xp, port, p, warps=warps)
        _close(got, fused_mlp_plain(xt, *port).float().numpy())
