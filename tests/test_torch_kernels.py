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
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.ops.cuda.attention import decode_attention, decode_attention_cuda
from gptq_for_llama_tpu_torch.ops.cuda.flash import flash_prefill_blocked
from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import (flash_prefill, flash_prefill_cuda,
                                                             flash_prefill_plain)
from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp, supports_fused
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.ops.quant_matmul import quant_matmul


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
    """The kernel wrapper never takes the plain path: CPU or fp8 inputs raise."""
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
    """The kernel wrapper never takes the plain path: CPU tensors, D != 128
    and H % Hkv != 0 raise before any launch."""
    q = torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_prefill_cuda(q, q, q, 0.1)
    q64 = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_prefill_cuda(q64, q64, q64, 0.1)
    k3 = torch.zeros(1, 8, 3, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_prefill_cuda(q, k3, k3, 0.1)
