"""The fold decode path (kernel 9's plain version, the "fold" cache form, the
runner's and the engine's cache_impl="fold") held against the TPU package's
fused_decode_attention and its GPTQ_TPU_CACHE_IMPL=pallas path.

Inputs come from numpy with a seed; both packages run fp32 on the CPU, the
TPU kernel in interpret mode, the port through its plain versions. Outputs
within 2e-5 (the same fp32 softmax, summed in another order), caches
byte-equal, greedy tokens equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.ops.pallas import attention as jattention
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.ops.cuda.attention import fused_decode_attention
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine, generate

from test_torch_serve import _np_llama


def _case(b, s, h, hkv, d=128, seed=0, offs=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    ck = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    cv = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    kn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    vn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    offs = rng.integers(0, s, size=(b,)) if offs is None else np.asarray(offs)
    return q, ck, cv, kn, vn, offs.astype(np.int32)


def _jax(q, ck, cv, kn, vn, offs, mask=None, write=True):
    out, k2, v2 = jattention.fused_decode_attention(
        *(jnp.asarray(a) for a in (q, ck, cv, kn, vn, offs)), q.shape[-1] ** -0.5,
        write_mask=None if mask is None else jnp.asarray(mask), interpret=True, write=write)
    return np.asarray(out), np.asarray(k2), np.asarray(v2)


def _port(q, ck, cv, kn, vn, offs, mask=None, write=True):
    ck, cv = torch.tensor(ck), torch.tensor(cv)
    out, k2, v2 = fused_decode_attention(
        torch.tensor(q), ck, cv, torch.tensor(kn), torch.tensor(vn), torch.tensor(offs),
        q.shape[-1] ** -0.5,
        write_mask=None if mask is None else torch.tensor(mask), write=write)
    assert k2 is ck and v2 is cv   # in place
    return out.numpy(), ck.numpy(), cv.numpy()


@pytest.mark.parametrize("write", [True, False])
@pytest.mark.parametrize("b,s,h,hkv", [(1, 256, 8, 8), (2, 256, 40, 40), (2, 128, 32, 8)])
def test_fold_plain_matches_jax_kernel(b, s, h, hkv, write):
    """MHA, 40 heads, GQA (the shapes of tests/test_cache_kernel.py), with
    and without the row write."""
    args = _case(b, s, h, hkv)
    want, got = _jax(*args, write=write), _port(*args, write=write)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    if not write:
        np.testing.assert_array_equal(got[1], args[1])


def test_fold_offset_zero_and_last_slot():
    """An empty prefix (the output is v_new) and a write to the last slot."""
    args = _case(2, 64, 8, 8, seed=1, offs=[0, 63])
    want, got = _jax(*args), _port(*args)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0][0], args[4][0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_fold_write_mask():
    """A row whose mask is false keeps its cache and still attends its own
    current k/v (from the inputs, not the unwritten cache)."""
    args = _case(3, 64, 8, 8, seed=2, offs=[5, 17, 60])
    mask = np.array([True, False, True])
    want, got = _jax(*args, mask=mask), _port(*args, mask=mask)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1][1], args[1][1])
    unmasked = _port(*args)
    np.testing.assert_allclose(got[0], unmasked[0], rtol=1e-6, atol=1e-6)


def test_fold_never_reads_at_or_past_the_offset():
    """NaN in every cache slot at and past each row's offset: the port stays
    finite and equals the TPU kernel on the clean cache; the written slot
    holds k_new / v_new, the later slots keep their NaN."""
    q, ck, cv, kn, vn, offs = _case(2, 128, 32, 8, seed=3, offs=[0, 77])
    want = _jax(q, ck, cv, kn, vn, offs)
    dead = np.arange(128)[None, :] >= offs[:, None]
    pk, pv = ck.copy(), cv.copy()
    pk[dead], pv[dead] = np.nan, np.nan
    got = _port(q, pk, pv, kn, vn, offs)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        live = ~dead.copy()
        live[np.arange(2), offs] = True
        np.testing.assert_array_equal(g[live], w[live])
        assert np.isnan(g[~live]).all()


def _count_jax_folds(monkeypatch):
    calls = []
    real = jattention.fused_decode_attention
    monkeypatch.setattr(jattention, "fused_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("GPTQ_TPU_CACHE_IMPL", "pallas")
    return calls


@pytest.mark.parametrize("masked", [False, True])
def test_attention_block_fold_matches_jax(monkeypatch, masked):
    """The port's ("fold", ...) cache form against the TPU package's
    attention_block under GPTQ_TPU_CACHE_IMPL=pallas (which must take its
    fold kernel): the same output, the same caches after the row write."""
    q, ck, cv, kn, vn, offs = _case(2, 64, 8, 8, seed=4, offs=[3, 60])
    mask = np.array([True, False]) if masked else None
    calls = _count_jax_folds(monkeypatch)
    jpast = (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(offs))
    if masked:
        jpast = jpast + (jnp.asarray(mask),)
    want, (wk, wv) = jcommon.attention_block(jpast, jnp.asarray(q), jnp.asarray(kn),
                                             jnp.asarray(vn), jcommon.decode_mask(1, 64, offs))
    assert calls, "the TPU package did not take its fold kernel"
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    past = ("fold", tk, tv, torch.tensor(offs)) + ((torch.tensor(mask),) if masked else ())
    got, (gk, gv) = common.attention_block(past, torch.tensor(q), torch.tensor(kn),
                                           torch.tensor(vn), None)
    assert gk is tk and gv is tv
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# head_dim 128 and 8 query heads: the shape the TPU package's fold kernel takes
# (supports_fused_decode), so its pallas path really runs
CFG = dict(arch="llama", vocab_size=64, hidden_size=64, intermediate_size=96, num_layers=2,
           num_heads=8, num_kv_heads=8, head_dim=128, max_seq_len=32)


def _models(**kw):
    cfg = dict(CFG, **kw)
    tree = _np_llama(cfg)
    return (JaxModelConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, tree), ModelConfig(**cfg),
            params_from_jax(tree, "cpu", torch.float32))


@pytest.mark.parametrize("kv_heads", [8, 2])
def test_fold_runner_greedy_matches_jax(monkeypatch, kv_heads):
    """10 greedy tokens of ModelRunner(cache_impl="fold") equal the TPU
    package's runner under GPTQ_TPU_CACHE_IMPL=pallas, and the classic
    runner's."""
    jcfg, jparams, cfg, params = _models(num_kv_heads=kv_heads)
    calls = _count_jax_folds(monkeypatch)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, size=6).astype(np.int32)
    jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=32,
                        dtype=jnp.float32)
    want = jax_generate(jr, prompt, max_new_tokens=10, temperature=0.0)
    assert calls, "the TPU package did not take its fold kernel"
    r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32, dtype=torch.float32,
                    device="cpu", cache_impl="fold")
    got = generate(r, prompt, max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(got, np.asarray(want))
    classic = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32,
                          dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(generate(classic, prompt, max_new_tokens=10, temperature=0.0),
                                  got)
    with pytest.raises(ValueError, match="cache_impl"):
        ModelRunner("llama", cfg, params, device="cpu", cache_impl="pallas")


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=8, fused_chunk_decode=False)],
                         ids=["bucketed", "chunked"])
def test_fold_engine_greedy_matches_jax(monkeypatch, kw):
    """The dense engine with cache_impl="fold" (single steps, then spans of
    4): every request's greedy tokens equal the TPU package's engine under
    GPTQ_TPU_CACHE_IMPL=pallas. Six requests on two slots, so slots retire
    and are backfilled while masked rows are decoded too."""
    jcfg, jparams, cfg, params = _models()
    calls = _count_jax_folds(monkeypatch)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in (3, 2, 17, 1, 11, 3)]
    jeng = JaxServingEngine("llama", jcfg, jparams, batch_slots=2, max_seq_len=32,
                            dtype=jnp.float32, prefill_buckets=(8, 32), **kw)
    for uid, p in enumerate(prompts):
        jeng.submit(JaxGenRequest(uid=uid, prompt=p.astype(np.int32), max_new_tokens=10,
                                  temperature=0.0))
    want = jeng.run()
    assert calls, "the TPU package did not take its fold kernel"
    for span in (1, 4):
        eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=32,
                            dtype=torch.float32, prefill_buckets=(8, 32), device="cpu",
                            cache_impl="fold", decode_span=span, **kw)
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=10))
        got = eng.run()
        assert set(got) == set(want) == set(range(len(prompts)))
        for uid in want:
            np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                          err_msg=f"span {span} request {uid}")
        assert eng.forwards["decode"] > 0
