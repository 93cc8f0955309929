"""Kernels 3, 4, 5, 7 and 9 at head dims other than 128 (ROADMAP B6).

The port's kernels take D = 64, 80, 96 and 256 (one library each); on this
CPU host the wrappers take their plain versions, held here against the TPU
package: at D = 64, 80 and 96 its XLA path (its Pallas kernels need
D % 128 == 0, so its models run ``_xla_decode_fallback`` and the masked
softmax of ``models/common.sdpa`` there), at D = 256 its Pallas kernels in
interpret mode. fp32 inputs; the tolerances are the ones tests/
test_torch_kernels.py states for the same kernels at D = 128. The kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.ops.pallas import attention as jattn
from gptq_for_llama_tpu.ops.pallas import flash as jflash
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu_torch.ops.cuda import attention, build, flash, flash_prefill
from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention,
                                                         decode_attention_cuda,
                                                         fused_decode_attention,
                                                         pool_decode_attention)
from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
from test_torch_model import _models

DIMS = (64, 80, 96, 256)


def _rand(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _jax_decode(q, k, v, offs, scale, d):
    """The TPU package's decode attention at head dim d: XLA below 128, the
    Pallas kernel in interpret mode at 256."""
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offs))
    if d % 128:
        return np.asarray(jattn._xla_decode_fallback(*args, scale))
    return np.asarray(jattn.decode_attention(*args, scale, interpret=True))


@pytest.mark.parametrize("d", DIMS)
def test_decode_and_pool_plain_match_jax_at_head_dim(d):
    """Kernel 3's plain version over a dense cache and kernel 7's over a
    block pool (tables a permutation) against the TPU package, per-row
    offsets, GQA (8 query heads over 2 kv heads). 2e-5 + 1e-4 relative, as
    at D = 128."""
    b, s, h, hkv, bs = 2, 64, 8, 2, 16
    q, k, v = _rand(d, (b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d))
    offs = np.array([5, 50], np.int32)
    sc = d ** -0.5
    want = _jax_decode(q, k, v, offs, sc, d)
    got = decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                           torch.as_tensor(offs), sc).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    mb = s // bs
    perm = np.random.RandomState(1).permutation(b * mb)
    tables = perm.reshape(b, mb).astype(np.int32)
    kp, vp = np.empty((b * mb, bs, hkv, d), np.float32), np.empty((b * mb, bs, hkv, d),
                                                                    np.float32)
    kp[perm], vp[perm] = k.reshape(b * mb, bs, hkv, d), v.reshape(b * mb, bs, hkv, d)
    got7 = pool_decode_attention(torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
                                 torch.as_tensor(tables), torch.as_tensor(offs), sc).numpy()
    want7 = np.asarray(jattn.pool_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(offs), sc, interpret=True))
    np.testing.assert_allclose(got7, want7, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got7, got, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("d", DIMS)
def test_fold_plain_matches_jax_at_head_dim(d):
    """Kernel 9's plain version (stale prefix + the current k/v, then the row
    write under the mask): at D = 256 against the Pallas fold kernel in
    interpret mode; below 128, where the TPU package has no fold kernel,
    against its XLA decode over the cache with the row written (the same
    function). The written caches are equal bit for bit."""
    b, s, h, hkv = 2, 32, 8, 2
    q, k, v, kn, vn = _rand(d + 1, (b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d),
                            (b, 1, hkv, d), (b, 1, hkv, d))
    offs = np.array([0, 20], np.int32)
    mask = np.array([True, False])
    sc = d ** -0.5
    out, kc, vc = fused_decode_attention(
        torch.as_tensor(q), torch.as_tensor(k.copy()), torch.as_tensor(v.copy()),
        torch.as_tensor(kn), torch.as_tensor(vn), torch.as_tensor(offs), sc,
        write_mask=torch.as_tensor(mask))
    kw, vw = k.copy(), v.copy()
    for row in np.nonzero(mask)[0]:
        kw[row, offs[row]], vw[row, offs[row]] = kn[row, 0], vn[row, 0]
    np.testing.assert_array_equal(kc.numpy(), kw)
    np.testing.assert_array_equal(vc.numpy(), vw)
    if d % 128:
        ka, va = k.copy(), v.copy()   # every row attends its own current k/v
        for row in range(b):
            ka[row, offs[row]], va[row, offs[row]] = kn[row, 0], vn[row, 0]
        want = _jax_decode(q, ka, va, offs, sc, d)
    else:
        want = np.asarray(jattn.fused_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(offs), sc, write_mask=jnp.asarray(mask), interpret=True)[0])
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("d", DIMS)
def test_prefill_plains_match_jax_at_head_dim(d):
    """Kernel 4's plain version (a chunk at an offset) and kernel 5's (causal,
    no cache) against the TPU package: its XLA masked softmax below 128
    (fp32, 1e-5), its Pallas kernels in interpret mode at 256 (bf16 MXU
    operands: 3e-2 * max|y|, as at D = 128)."""
    b, h, hkv = 1, 4, 2
    sq, skv, off, s5 = (128, 256, 128, 256) if d % 128 == 0 else (24, 64, 30, 40)
    q, k, v, q5, k5, v5 = _rand(d + 2, (b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                (b, s5, h, d), (b, s5, hkv, d), (b, s5, hkv, d))
    sc = d ** -0.5
    got4 = flash.flash_prefill_blocked(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), off, sc).numpy()
    got5 = flash_prefill.flash_prefill(torch.as_tensor(q5), torch.as_tensor(k5),
                                       torch.as_tensor(v5), sc).numpy()
    if d % 128:
        want4 = np.asarray(jcommon.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jcommon.decode_mask(sq, skv, jnp.int32(off)), sc))
        want5 = np.asarray(jcommon.sdpa(jnp.asarray(q5), jnp.asarray(k5), jnp.asarray(v5),
                                        jcommon.causal_mask(s5, s5), sc))
        tol4, tol5 = 1e-5, 1e-5
    else:
        want4 = np.asarray(jflash.flash_prefill_blocked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(off), sc,
            interpret=True))
        want5 = np.asarray(jflash.flash_prefill(jnp.asarray(q5), jnp.asarray(k5),
                                                jnp.asarray(v5), sc, interpret=True))
        tol4, tol5 = 3e-2 * np.abs(want4).max(), 3e-2 * np.abs(want5).max()
    np.testing.assert_allclose(got4, want4, atol=tol4, rtol=1e-5 if d % 128 else 0)
    np.testing.assert_allclose(got5, want5, atol=tol5, rtol=1e-5 if d % 128 else 0)


@pytest.mark.parametrize("d", (*DIMS, 128))
def test_plans_at_head_dim(d):
    """The host plans at every built head dim: kernels 4 and 5 take the
    mma.sync body up to the crossover measured for D (offset + SQ <= 192 keys
    at D = 64, 160 at 80 and 96, 128 at 128 and 256) and the wgmma body
    above, kernel 4 over every cache dtype up to D = 128 (at D = 256 fp8 and
    f32 caches, and f32 at D = 80 and 96, its measured crossover, take
    mma.sync at every length); kernels 3, 7 and 9 plan
    their ring and scratch from D, and the layout each library reports is
    what the plan uses (csrc/decode_attention_dense.cuh: 4 stages under 128
    KB, f32 at D = 256 two; two resident blocks at D = 256)."""
    assert d in build.HEAD_DIMS and f"decode_attention:d{d}" in build.targets()
    limit = {64: 192, 80: 160, 96: 160, 128: 128, 256: 128}[d]
    assert flash_prefill.SYNC_MAX_KEYS[d] == limit and d in flash_prefill.WGMMA_HEAD_DIMS
    for sq, off in ((16, 0), (300, 700), (2048, 0), (limit, 0), (limit - 100, 100),
                    (limit + 1, 0), (1, limit)):
        body = flash_prefill.plan(sq, off, d)
        assert body == ("sync" if off + sq <= limit else "wgmma")
        assert flash.plan_kv(sq, off, torch.bfloat16, d) == body
        for dt in (torch.float8_e4m3fn, torch.float8_e5m2, torch.float32):
            kept = d == 256 or (dt == torch.float32 and d in (80, 96))
            assert flash.plan_kv(sq, off, dt, d) == ("sync" if kept else body)
    for itemsize in (1, 2, 4):
        stages = attention.ring_stages(itemsize, d)
        ring = attention.ring_smem_bytes(itemsize, d)
        assert ring == stages * 64 * d * itemsize and ring <= 128 * 1024
        assert stages == (2 if (d, itemsize) == (256, 4) else 4)
        assert attention.blocks_per_sm(itemsize, d) * (ring + 3072) <= 233472
    assert attention.max_blocks_per_sm(d) == (2 if d == 256 else 3)
    p = attention.decode_plan(2, 8, 4, 2048, 132, 2, d)
    assert attention.partial_floats(2, 8, 4, p, d) == 2 * 8 * p.nsplit * 4 * (d + 2)
    assert p == attention.decode_plan(2, 8, 4, 2048, 132, 2, 128) or d == 256


@pytest.mark.parametrize("d", (*DIMS, 128))
def test_wgmma_layouts_fit_a_block(d):
    """The wgmma body's shared memory at D over each cache dtype (the mirror
    of csrc/flash_common.cuh's WgmmaDims, which the smoke's build phase holds
    against the library's own report) fits a block's 232,448 bytes: over bf16
    the rings as they were (3 stages, 2 at D = 256); over fp8 and f32 up to
    D = 128 a staging ring of 4 slots, each a whole chunk of a K or V tile in
    the stored type (the most keys, halving from 128, whose rows fit 16 KB),
    beside 3 bf16 stages, 2 at D = 128; no such layout at D = 256."""
    bf16 = {64: 115840, 80: 144512, 96: 173184, 128: 230528, 256: 230528}
    assert flash.SMEM_LIMIT == 232448
    assert flash.wgmma_layout(d, torch.bfloat16) == flash.Layout(2 if d == 256 else 3, 0, 0, 0,
                                                                   bf16[d])
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2, torch.float32):
        lay = flash.wgmma_layout(d, dt)
        if d == 256:
            assert lay is None
            continue
        row, chunk = d * dt.itemsize, lay.chunk_keys
        assert 128 % chunk == 0 and chunk * row <= 16384 and (chunk == 128 or 2 * chunk * row > 16384)
        assert lay.slots == 4 and lay.staging_bytes == 4 * chunk * row
        assert lay.stages == (2 if d == 128 else 3)
        tiles = (128 + 2 * lay.stages * 128) * d * 2
        assert tiles + lay.staging_bytes < lay.smem <= flash.SMEM_LIMIT


@pytest.mark.parametrize("d", (72, 112, 512))
def test_head_dims_without_a_kernel_raise_naming_b6(d):
    """A head dim no library is built for raises before any launch, naming
    ROADMAP B6 (no plain or library fallback on the card)."""
    q = torch.zeros(1, 1, 4, d, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 4, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="B6"):
        decode_attention_cuda(q, k, k, 3, 0.1)
    with pytest.raises(ValueError, match="B6"):
        flash.flash_prefill_blocked_cuda(q, k, k, 0, 0.1)
    with pytest.raises(ValueError, match="B6"):
        build.library("decode_attention", d)
    assert not attention.supports_paged_decode(16, 4, 4, d)


def test_llama_at_head_dim_256_runner_matches_jax():
    """A tiny LLaMA whose config reads head_dim 256 (2 query heads over 1 kv
    head, hidden 512, 2 layers, INT4-g128 wire weights), the layout the loader's
    ``head_dim`` admits and the smoke drives at full width: the port's runner
    against the TPU package's (fp32 on the CPU, both on their default paths):
    a prompt's prefill logits, a chunk prefilled at an offset, then greedy
    decode steps, logits close and tokens EQUAL."""
    jcfg, jparams, cfg, params = _models(seed=256, hidden_size=512, intermediate_size=256,
                                         num_heads=2, num_kv_heads=1, head_dim=256, gs=128)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(1, 12)).astype(np.int32)
    jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=32,
                        dtype=jnp.float32)
    r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32, dtype=torch.float32,
                    device="cpu")
    jcache, cache = jr.init_cache(), r.init_cache()
    want, got, toks = [], [], []
    for lo in (0, 6):   # the prompt, then a chunk at offset 6
        jl, jcache = jr.prefill(jnp.asarray(ids[:, lo:lo + 6]), jcache)
        lg, cache = r.prefill(torch.as_tensor(ids[:, lo:lo + 6]), cache)
        want.append(np.asarray(jl))
        got.append(lg.numpy())
    for _ in range(3):   # greedy: each package feeds its own argmax
        jtok, tok = np.asarray(want[-1][:, -1:].argmax(-1)), got[-1][:, -1:].argmax(-1)
        np.testing.assert_array_equal(tok, jtok)
        toks.append(int(tok[0, 0]))
        jl, jcache = jr.decode(jnp.asarray(jtok, jnp.int32), jcache)
        lg, cache = r.decode(torch.as_tensor(tok), cache)
        want.append(np.asarray(jl))
        got.append(lg.numpy())
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want, 1),
                               atol=2e-4, rtol=1e-3)
    assert cache.offset == 15 and len(toks) == 3
