"""The port's kernel modules held against the TPU package's kernels.

Same numpy inputs through both packages. On this CPU host the port's
wrappers take their plain versions (CPU tensors); the JAX side runs its
Pallas kernels in interpret mode or its XLA references, as its own tests do.
The CUDA kernels themselves are held against their plain versions on the
card in tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear, quant_matmul_xla
from gptq_for_llama_tpu.ops.pallas import attention as jattn
from gptq_for_llama_tpu.ops.pallas import flash as jflash
from gptq_for_llama_tpu.ops.pallas import matmul as jmm
from gptq_for_llama_tpu.ops.pallas import mlp as jmlp
from gptq_for_llama_tpu.ops.pallas import norm as jnorm
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention, decode_attention_cuda,
                                                         pool_decode_attention,
                                                         pool_decode_attention_cuda,
                                                         pool_decode_attention_plain,
                                                         supports_paged_decode)
from gptq_for_llama_tpu_torch.ops.cuda.flash import flash_prefill_blocked
from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import (flash_prefill, flash_prefill_cuda,
                                                             flash_prefill_plain)
from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp, supports_fused
from gptq_for_llama_tpu_torch.ops.cuda.norm import rms_norm, rms_norm_cuda, rms_norm_plain
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.ops.quant_matmul import quant_matmul
from gptq_for_llama_tpu_torch.runtime import sample_logits


def _wire(k, n, bits, gs, seed, actorder=False, perm_seed=None):
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


def _pair(k, n, bits, gs, seed, **kw):
    """The same wire buffers loaded by both packages (fp32 compute)."""
    w = _wire(k, n, bits, gs, seed, **kw)
    return (PackedLinear.from_wire(**w, bits=bits, dtype=torch.float32, device="cpu"),
            JaxPackedLinear.from_wire(**w, bits=bits, dtype=jnp.float32))


# ---------------------------------------------------------------------------
# kernel 1: dequant-GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,m,actorder,k", [
    (2, 1, False, 128), (3, 5, False, 128), (4, 1, False, 128), (4, 33, True, 128),
    (8, 8, False, 128), (4, 3, False, 104), (3, 4, True, 128)])
def test_quant_matmul_plain_matches_xla(bits, m, actorder, k):
    """fp32, same arithmetic order up to the matmul: tight tolerance."""
    lin, jlin = _pair(k, 96, bits, 32, seed=bits + m, actorder=actorder)
    x = np.random.RandomState(1).standard_normal((m, k)).astype(np.float32)
    got = quant_matmul(torch.as_tensor(x), lin, dtype=torch.float32).numpy()
    want = np.asarray(quant_matmul_xla(jnp.asarray(x), jlin, dtype=jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)


@pytest.mark.parametrize("bits,actorder", [(2, False), (3, True), (4, False), (8, False)])
def test_quant_matmul_plain_matches_pallas_interpret(bits, actorder):
    """The Pallas kernel feeds bf16 inputs to the MXU: tests/test_pallas.py's
    3e-2 * max|y| tolerance."""
    lin, jlin = _pair(128, 128, bits, 32, seed=20 + bits, actorder=actorder)
    x = np.random.RandomState(2).standard_normal((5, 128)).astype(np.float32)
    got = quant_matmul(torch.as_tensor(x), lin, dtype=torch.float32).numpy()
    want = np.asarray(jmm.quant_matmul_pallas(jnp.asarray(x), jlin, interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max(), rtol=0)


def test_quant_matmul_bias_and_leading_dims():
    w = _wire(64, 128, 4, 32, seed=3)
    bias = np.linspace(-1, 1, 128).astype(np.float16)
    lin = PackedLinear.from_wire(**w, bits=4, bias=bias, dtype=torch.float32, device="cpu")
    jlin = JaxPackedLinear.from_wire(**w, bits=4, bias=bias, dtype=jnp.float32)
    x = np.random.RandomState(4).standard_normal((2, 5, 64)).astype(np.float32)
    got = quant_matmul(torch.as_tensor(x), lin, dtype=torch.float32).numpy()
    want = np.asarray(quant_matmul_xla(jnp.asarray(x), jlin, dtype=jnp.float32))
    assert got.shape == (2, 5, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# kernel 2: fused gate/up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("actorder", [False, True])
def test_fused_mlp_matches_pallas_interpret(actorder):
    """Act-order pair with IDENTICAL perms fuses; bf16-MXU tolerance."""
    gate, jgate = _pair(128, 128, 4, 32, seed=10, actorder=actorder, perm_seed=5)
    up, jup = _pair(128, 128, 4, 32, seed=11, actorder=actorder, perm_seed=5)
    assert supports_fused(gate, up) and jmlp.supports_fused(jgate, jup)
    x = np.random.RandomState(4).standard_normal((8, 128)).astype(np.float32)
    got = fused_mlp(torch.as_tensor(x), gate, up).numpy()
    want = np.asarray(jmlp.fused_mlp_pallas(jnp.asarray(x), jgate, jup, interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max(), rtol=0)


def test_supports_fused_rules():
    a, _ = _pair(64, 64, 4, 16, seed=1, actorder=True, perm_seed=1)
    b, _ = _pair(64, 64, 4, 16, seed=2, actorder=True, perm_seed=2)
    c, _ = _pair(64, 64, 4, 16, seed=3, actorder=True, perm_seed=1)
    plain, _ = _pair(64, 64, 4, 16, seed=4)
    assert supports_fused(a, c)                # identical perms
    assert not supports_fused(a, b)            # different perms
    assert not supports_fused(a, plain)        # one act-order, one not
    assert not supports_fused(plain, _pair(64, 64, 2, 16, seed=5)[0])   # bits differ
    w = _wire(64, 64, 4, 16, seed=6)
    biased = PackedLinear.from_wire(**w, bits=4, bias=np.ones(64, np.float16),
                                    dtype=torch.float32, device="cpu")
    assert not supports_fused(plain, biased)


# ---------------------------------------------------------------------------
# kernel 3: decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,offs", [(1, 8, 8, (5,)), (3, 8, 8, (0, 17, 31)),
                                          (2, 8, 2, (9, 30)), (2, 4, 1, (31, 3))])
def test_decode_attention_matches_pallas_interpret(b, h, hkv, offs):
    """fp32 softmax on both sides: tests/test_attention_kernel.py tolerance."""
    s, d = 32, 128
    rng = np.random.RandomState(h + hkv + b)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    off = np.asarray(offs, np.int32)
    got = decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                           torch.as_tensor(off), d ** -0.5).numpy()
    want = np.asarray(jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(off), d ** -0.5, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_decode_attention_wrapper_refuses_cpu_and_fp8():
    """The kernel wrapper never takes the plain path: CPU tensors raise, over
    a bf16 or an fp8 cache alike (the card reads fp8 caches, tests/
    test_torch_cuda.py)."""
    q = torch.zeros(1, 1, 4, 128)
    k = torch.zeros(1, 8, 4, 128)
    with pytest.raises(ValueError):
        decode_attention_cuda(q, k, k, 3, 0.1)
    k8 = k.to(torch.float8_e4m3fn)
    with pytest.raises((TypeError, ValueError)):
        decode_attention_cuda(q.bfloat16(), k8, k8, 3, 0.1)


# ---------------------------------------------------------------------------
# kernel 4: blocked prefill attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("off,hkv", [(0, 4), (128, 2)])
def test_flash_prefill_blocked_matches_pallas_interpret(off, hkv):
    """The Pallas kernel feeds bf16 to the MXU: 3e-2 * max|y|, as
    tests/test_longcontext.py."""
    b, sq, skv, h, d = 1, 128, 256, 4, 128
    rng = np.random.RandomState(off + hkv)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    got = flash_prefill_blocked(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                off, d ** -0.5).numpy()
    want = np.asarray(jflash.flash_prefill_blocked(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), jnp.int32(off),
                                                   d ** -0.5, interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("sq,off", [(1, 7), (5, 0), (9, 11)])
def test_sdpa_dispatch_matches_jax_sdpa(sq, off):
    """Port sdpa with a scalar decode offset (kernel dispatch, plain on CPU)
    against JAX sdpa with the explicit decode mask, fp32."""
    b, s, h, hkv, d = 2, 24, 4, 2, 16
    rng = np.random.RandomState(sq + off)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, sq, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = common.sdpa(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                      decode_offset=off).numpy()
    want = np.asarray(jcommon.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jcommon.decode_mask(sq, s, jnp.int32(off))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# kernel 5: causal prefill attention without a cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,hkv", [(256, 4), (256, 2), (512, 4), (512, 2)])
def test_flash_prefill_plain_matches_pallas_interpret(s, hkv):
    """The Pallas kernel feeds bf16 to the MXU: 3e-2 * max|y|, as kernel 4."""
    b, h, d = 1, 4, 128
    rng = np.random.RandomState(s + hkv)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = flash_prefill(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                        d ** -0.5).numpy()
    assert np.array_equal(got, flash_prefill_plain(torch.as_tensor(q), torch.as_tensor(k),
                                                   torch.as_tensor(v), d ** -0.5).numpy())
    want = np.asarray(jflash.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           d ** -0.5, interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("s,impl", [(100, ""), (512, "pallas")])
def test_sdpa_causal_matches_jax_sdpa(monkeypatch, s, impl):
    """Port sdpa(causal=True) (kernel 5 dispatch, plain on the CPU) against JAX
    sdpa(causal=True): its XLA masked softmax at S = 100 (fp32, 1e-5), its
    Pallas flash kernel in interpret mode at S = 512 (bf16 MXU, 3e-2 * max|y|)."""
    if impl:
        monkeypatch.setenv("GPTQ_TPU_ATTN_IMPL", impl)
    b, h, hkv, d = 2, 4, 2, 128
    rng = np.random.RandomState(s)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    mask = common.causal_mask(s, s)
    got = common.sdpa(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), mask,
                      causal=True).numpy()
    want = np.asarray(jcommon.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jcommon.causal_mask(s, s), causal=True))
    if impl:
        np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_flash_prefill_wrapper_refuses_cpu_and_bad_shapes():
    """The kernel wrapper never takes the plain path: CPU tensors, a head dim
    no library is built for (D = 72; 64, 80, 96, 128 and 256 are) and
    H % Hkv != 0 raise before any launch."""
    q = torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_prefill_cuda(q, q, q, 0.1)
    q72 = torch.zeros(1, 8, 4, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="B6"):
        flash_prefill_cuda(q72, q72, q72, 0.1)
    k3 = torch.zeros(1, 8, 3, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_prefill_cuda(q, k3, k3, 0.1)


# ---------------------------------------------------------------------------
# kernel 6: RMSNorm
# ---------------------------------------------------------------------------

def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units of the last place:
    the difference of their bit patterns on the monotonic integer line."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(got) - line(want)).abs().max())


@pytest.mark.parametrize("m,h", [(1, 128), (5, 256), (8, 4096), (3, 96)])
def test_rms_norm_plain_matches_pallas_interpret_and_jax(m, h):
    """bf16 in and out, fp32 inside: the plain version, the Pallas kernel in
    interpret mode and models/common.rms_norm agree to 1 bf16 ulp (the sum of
    squares is taken in another order; everything else is the same fp32
    arithmetic, rounded once)."""
    rng = np.random.RandomState(m + h)
    x = torch.as_tensor(rng.standard_normal((m, h)).astype(np.float32) * 3).bfloat16()
    w = torch.as_tensor(1 + 0.1 * rng.standard_normal(h).astype(np.float32)).bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    got = rms_norm(x, w, 1e-6)
    assert got.dtype == torch.bfloat16 and torch.equal(got, rms_norm_plain(x, w, 1e-6))
    assert common.rms_norm is rms_norm   # every norm of the model goes through kernel 6
    for want in (jnorm.rms_norm_pallas(jx, jw, 1e-6, interpret=True),
                 jcommon.rms_norm(jx, jw, 1e-6)):
        want = torch.as_tensor(np.array(want.astype(jnp.float32))).bfloat16()
        assert _bf16_ulps(got, want) <= 1


def test_rms_norm_fp32_leading_dims_and_wrapper_refusals():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    got = rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5).numpy()
    want = np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):   # the kernel wrapper never takes the plain path
        rms_norm_cuda(torch.as_tensor(x), torch.as_tensor(w), 1e-5)
    with pytest.raises(TypeError):
        rms_norm_cuda(torch.as_tensor(x).half(), torch.as_tensor(w), 1e-5)


# ---------------------------------------------------------------------------
# kernel 7: decode attention over the paged block pool
# ---------------------------------------------------------------------------

def _poison(kp, vp, tables, offs, bs):
    """NaN in every block no row owns and, per row, in every slot past its
    offset: what a kernel must never read."""
    kp, vp = kp.copy(), vp.copy()
    owned = np.zeros(kp.shape[0], bool)
    owned[tables.reshape(-1)] = True
    kp[~owned] = vp[~owned] = np.nan
    for row, off in zip(tables, offs):
        for lb, phys in enumerate(row):
            dead = np.arange(lb * bs, (lb + 1) * bs) > off
            kp[phys, dead] = vp[phys, dead] = np.nan
    return kp, vp


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("poisoned", [False, True])
def test_pool_decode_attention_plain_matches_pallas_interpret(dtype, tol, poisoned):
    """D = 128, GQA, varied live lengths, permuted physical blocks, as
    tests/test_paged.py runs the Pallas kernel; fp32, and bf16 pools at 2e-2.
    With a poisoned pool the TPU kernel still gets the clean one: in interpret
    mode it returns NaN for a row whose last live block holds a NaN past the
    offset (a zero weight times NaN), which its zero-initialised pools never
    do. What is held is that the port's result does not change."""
    rng = np.random.RandomState(0)
    b, h, hkv, d, bs, mb, nb = 3, 8, 4, 128, 16, 8, 32
    assert supports_paged_decode(bs, h, hkv, d) and jattn.supports_paged_decode(bs, h, hkv, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    offs = np.array([5, 37, 127], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    want = jattn.pool_decode_attention(jnp.asarray(q).astype(jdt), jnp.asarray(kp).astype(jdt),
                                       jnp.asarray(vp).astype(jdt), jnp.asarray(tables),
                                       jnp.asarray(offs), d ** -0.5, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    if poisoned:
        kp, vp = _poison(kp, vp, tables, offs, bs)
    args = (torch.as_tensor(q).to(tdt), torch.as_tensor(kp).to(tdt), torch.as_tensor(vp).to(tdt),
            torch.as_tensor(tables), torch.as_tensor(offs), d ** -0.5)
    got = pool_decode_attention(*args)
    assert torch.equal(got, pool_decode_attention_plain(*args)) and got.dtype == tdt
    assert np.isfinite(got.float().numpy()).all()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_pool_decode_attention_wrapper_refusals_and_supports():
    """The kernel wrapper never takes the plain path (CPU tensors raise), and
    what it does not take is said by supports_paged_decode, as the TPU
    package's gate of the same name."""
    q = torch.zeros(2, 1, 4, 128, dtype=torch.bfloat16)
    pool = torch.zeros(6, 16, 4, 128, dtype=torch.bfloat16)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        pool_decode_attention_cuda(q, pool, pool, tables, off, 0.1)
    with pytest.raises(ValueError, match="multiple of 8"):
        pool_decode_attention_cuda(q, pool[:, :12], pool[:, :12], tables, off, 0.1)
    assert supports_paged_decode(16, 32, 32, 128) and supports_paged_decode(8, 32, 4, 128)
    assert not supports_paged_decode(12, 32, 32, 128)       # block size % 8
    assert supports_paged_decode(16, 32, 32, 64)            # every built head dim (B6)
    assert not supports_paged_decode(16, 32, 32, 72)        # head_dim
    assert not supports_paged_decode(16, 32, 2, 128)        # 16 query heads per kv head
    # fp8, bf16 and f32 pools are read in their stored dtype; 8-byte elements are not
    assert all(supports_paged_decode(16, 32, 32, 128, n) for n in (1, 2, 4))
    assert not supports_paged_decode(16, 32, 32, 128, 8)
    # a dense decode takes the host-side bound on the live length and ignores it on the CPU
    k = torch.randn(2, 48, 4, 128)
    np.testing.assert_array_equal(decode_attention(q.float(), k, k, off, 0.1, max_live=1).numpy(),
                                  decode_attention(q.float(), k, k, off, 0.1).numpy())


# ---------------------------------------------------------------------------
# the serving protocol's dispatch, and sampling modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,off", [(8, 0), (8, 16), (5, 3)])
def test_one_row_prefill_with_host_offset_matches_jax_vector_offset(sq, off):
    """The TPU engine's per-slot prefills pass a (1,) offset vector and fall to
    the XLA softmax; the port passes the same offset as a host int, which the
    blocked prefill kernel takes on the card. Same function, fp32."""
    s, h, hkv, d = 32, 4, 2, 16
    rng = np.random.RandomState(sq + off)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((1, sq, h, d), (1, s, hkv, d), (1, s, hkv, d)))
    offs = jnp.asarray([off], jnp.int32)
    want = np.asarray(jcommon.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jcommon.decode_mask(sq, s, offs), decode_offset=offs))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = common.sdpa(tq, tk, tv, decode_offset=off).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the (1,) tensor form is still the same function on the CPU
    got_vec = common.sdpa(tq, tk, tv, decode_offset=torch.tensor([off], dtype=torch.int32))
    np.testing.assert_allclose(got_vec.numpy(), want, atol=1e-5, rtol=1e-5)
    # ("rows", offsets, max_live) is the per-row form with its host-side bound
    offs3 = torch.tensor([3, 9], dtype=torch.int32)
    q1 = torch.as_tensor(rng.standard_normal((2, 1, h, d)).astype(np.float32))
    k2 = torch.cat([tk, tk.flip(1)])
    np.testing.assert_array_equal(
        common.sdpa(q1, k2, k2, decode_offset=("rows", offs3, 10)).numpy(),
        common.sdpa(q1, k2, k2, decode_offset=offs3).numpy())


def test_sample_logits_modes():
    """mode="greedy" is the argmax whatever the params; "categorical" draws
    from the temperature-scaled softmax without tail filtering and keeps the
    argmax for temperature-0 rows; None is the general path. Held against the
    TPU package's sample_logits where both are deterministic."""
    from gptq_for_llama_tpu.runtime.runner import sample_logits as jsample
    import jax
    logits = np.log(np.array([[0.7, 0.2, 0.05, 0.05], [0.1, 0.1, 0.1, 0.7]], np.float32))
    tl, gen = torch.as_tensor(logits), torch.Generator()
    gen.manual_seed(0)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jsample(jnp.asarray(logits), key, 0.9, 0.5, mode="greedy"))
    np.testing.assert_array_equal(sample_logits(tl, gen, 0.9, 0.5, mode="greedy").numpy(), want)
    # temperature-0 rows take the argmax in every mode
    temps = torch.tensor([0.0, 1.0])
    jt = jnp.asarray([0.0, 1.0])
    for mode in ("categorical", None):
        for _ in range(20):
            assert int(sample_logits(tl, gen, temps, 1.0, mode=mode)[0]) == 0
        assert int(jsample(jnp.asarray(logits), key, jt, 1.0, mode=mode)[0]) == 0
    # categorical: no tail filter, so every token of row 0 turns up; the
    # general path at top_p 0.5 keeps the head only
    cat = {int(sample_logits(tl, gen, 1.0, 1.0, mode="categorical")[0]) for _ in range(300)}
    assert cat == {0, 1, 2, 3}
    assert {int(sample_logits(tl, gen, 1.0, 0.5)[0]) for _ in range(100)} == {0}
    freq = np.mean([int(sample_logits(tl, gen, 1.0, 1.0, mode="categorical")[1]) == 3
                    for _ in range(600)])
    assert abs(freq - 0.7) < 0.08
    with pytest.raises(ValueError):
        sample_logits(tl, gen, 1.0, 1.0, top_k=2, mode="categorical")
    with pytest.raises(ValueError):
        sample_logits(tl, gen, 1.0, 1.0, mode="argmax")
