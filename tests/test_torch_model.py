"""LLaMA forward and runner of the port held against the TPU package.

Weights: random wire buffers loaded by the TPU package through
``PackedLinear.from_wire`` (never bench.random_packed_llama, whose host
qzeros do not describe its device zeros), handed to the port as numpy with
``convert.params_from_jax``. Both run fp32 on the CPU, the port through its
plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.models import registry as jregistry
from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models import common, llama, registry
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.runtime import (ModelRunner, benchmark_decode, generate,
                                              sample_logits)
from gptq_for_llama_tpu_torch.runtime.random_model import (gaussian_wire_llama,
                                                           model_weight_bytes,
                                                           random_wire_llama)

CFG = dict(arch="llama", vocab_size=96, hidden_size=128, intermediate_size=256,
           num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32, max_seq_len=64)


def _jax_packed_llama(jcfg, seed, bits=4, gs=32, actorder=False):
    """JAX params whose packed linears come from random wire buffers."""
    rng = np.random.RandomState(seed)

    def packed(k, n):
        codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
        g = k // gs
        g_idx = (np.arange(k) // gs).astype(np.int32)
        if actorder:
            p = rng.permutation(k)
            codes, g_idx = codes[p], g_idx[p]
        zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
        return JaxPackedLinear.from_wire(
            jpack.pack_rows(codes, bits), jpack.pack_cols(zeros - 1, bits),
            (rng.rand(g, n) * 0.04 + 0.01).astype(np.float16), g_idx, bits=bits,
            dtype=jnp.float32)

    h, inter, v = jcfg.hidden_size, jcfg.intermediate_size, jcfg.vocab_size
    qh, kvh = jcfg.num_heads * jcfg.head_dim, jcfg.num_kv_heads * jcfg.head_dim
    layers = [{
        "input_layernorm": jnp.asarray(1 + 0.1 * rng.standard_normal(h), jnp.float32),
        "post_attention_layernorm": jnp.asarray(1 + 0.1 * rng.standard_normal(h), jnp.float32),
        "self_attn": {"q_proj": packed(h, qh), "k_proj": packed(h, kvh),
                      "v_proj": packed(h, kvh), "o_proj": packed(qh, h)},
        "mlp": {"gate_proj": packed(h, inter), "up_proj": packed(h, inter),
                "down_proj": packed(inter, h)},
    } for _ in range(jcfg.num_layers)]
    return {"embed_tokens": jnp.asarray(rng.standard_normal((v, h)), jnp.float32),
            "layers": layers, "norm": jnp.ones((h,), jnp.float32),
            "lm_head": {"kernel": jnp.asarray(rng.standard_normal((h, v)) / h ** 0.5,
                                              jnp.float32)}}


def _to_wire_tree(p):
    """The TPU package's hand-over format: wire dicts + bits, numpy arrays."""
    if isinstance(p, JaxPackedLinear):
        d = dict(p.to_wire())
        d["bits"] = p.wire_bits or p.bits
        return d
    if isinstance(p, dict):
        return {k: _to_wire_tree(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_to_wire_tree(v) for v in p]
    return np.asarray(p, np.float32)


def _models(seed=0, **kw):
    cfg_kw = dict(CFG, **{k: v for k, v in kw.items() if k in CFG})
    extra = {k: v for k, v in kw.items() if k not in CFG}
    jcfg, cfg = JaxModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jparams = _jax_packed_llama(jcfg, seed, **extra)
    params = params_from_jax(_to_wire_tree(jparams), "cpu", torch.float32)
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("kv_heads,actorder", [(4, False), (2, True), (1, False)])
def test_llama_forward_matches_jax(kv_heads, actorder):
    """MHA and GQA logits, fp32: both packages run the same algorithm."""
    jcfg, jparams, cfg, params = _models(seed=kv_heads, num_kv_heads=kv_heads,
                                         actorder=actorder)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, 11))
    want = np.asarray(jregistry.get_arch("llama").forward(jparams, jcfg, jnp.asarray(ids)))
    got = llama.forward(params, cfg, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_runner_prefill_decode_and_greedy_match_jax(kv_heads):
    """Runner prefill + decode logits against the JAX ModelRunner (fp32), and
    greedy tokens EQUAL over 10 steps (tests/test_runtime.py pattern)."""
    jcfg, jparams, cfg, params = _models(seed=10 + kv_heads, num_kv_heads=kv_heads)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(1, 9)).astype(np.int32)
    jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=32,
                        dtype=jnp.float32)
    r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32,
                    dtype=torch.float32, device="cpu")
    jcache, cache = jr.init_cache(), r.init_cache()
    jl, jcache = jr.prefill(jnp.asarray(ids[:, :5]), jcache)
    lg, cache = r.prefill(torch.as_tensor(ids[:, :5]), cache)
    want, got = [np.asarray(jl)], [lg.numpy()]
    for i in range(5, 9):
        jl, jcache = jr.decode(jnp.asarray(ids[:, i:i + 1]), jcache)
        lg, cache = r.decode(torch.as_tensor(ids[:, i:i + 1]), cache)
        want.append(np.asarray(jl))
        got.append(lg.numpy())
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want, 1),
                               atol=2e-4, rtol=1e-3)
    assert cache.offset == 9

    prompt = ids[0, :6]
    want_tok = jax_generate(jr, prompt, max_new_tokens=10, temperature=0.0)
    got_tok = generate(r, prompt, max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(got_tok, want_tok)
    # the on-device greedy loop gives the same tokens
    lg, cache = r.prefill(torch.as_tensor(prompt[None]), r.init_cache())
    toks, _ = r.decode_greedy_scan(lg[:, -1:].argmax(-1), cache, 9)
    np.testing.assert_array_equal(toks.numpy()[0], got_tok[0, 7:])
    # teacher-forced decode reproduces the prefill's last logits
    fl, _ = r.forced_decode_scan(torch.as_tensor(prompt[None]), r.init_cache())
    pl, _ = r.prefill(torch.as_tensor(prompt[None]), r.init_cache())
    np.testing.assert_allclose(fl.numpy()[:, -1], pl.numpy()[:, -1], atol=1e-4, rtol=1e-4)


def test_update_kv_cache_vector_offsets_and_write_mask():
    rng = np.random.RandomState(3)
    ck, cv = (rng.standard_normal((3, 10, 2, 4)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((3, 2, 2, 4)).astype(np.float32) for _ in range(2))
    off = np.array([0, 4, 8], np.int32)
    mask = np.array([True, False, True])
    jk, jv = jcommon.update_kv_cache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
                                     jnp.asarray(vn), jnp.asarray(off),
                                     write_mask=jnp.asarray(mask))
    tk, tv = common.update_kv_cache(torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy()),
                                    torch.as_tensor(kn), torch.as_tensor(vn),
                                    torch.as_tensor(off), write_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jk, _ = jcommon.update_kv_cache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
                                    jnp.asarray(vn), jnp.int32(3))
    tk, _ = common.update_kv_cache(torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy()),
                                   torch.as_tensor(kn), torch.as_tensor(vn), 3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_norm_rope_masks_match_jax():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(common.rms_norm(torch.as_tensor(x), torch.as_tensor(w),
                                               1e-6).numpy(),
                               np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
                               atol=1e-6, rtol=1e-6)
    pos = np.arange(7)[None] + 3
    cos, sin = common.rope_cos_sin(torch.as_tensor(pos), 8, 10000.0)
    jcos, jsin = jcommon.rope_cos_sin(jnp.asarray(pos), 8, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    q = rng.standard_normal((1, 7, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 7, 1, 8)).astype(np.float32)
    tq, tk = common.apply_rope(torch.as_tensor(q), torch.as_tensor(k), cos, sin)
    jq, jk = jcommon.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_array_equal(common.decode_mask(3, 9, 4).numpy(),
                                  np.asarray(jcommon.decode_mask(3, 9, jnp.int32(4))))
    offs = np.array([1, 5], np.int32)
    np.testing.assert_array_equal(common.decode_mask(2, 9, torch.as_tensor(offs)).numpy(),
                                  np.asarray(jcommon.decode_mask(2, 9, jnp.asarray(offs))))
    np.testing.assert_array_equal(common.causal_mask(4, 6).numpy(),
                                  np.asarray(jcommon.causal_mask(4, 6)))


def test_sampling():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[10.0, 9.0, -50.0, -50.0]])
    picks = {int(sample_logits(logits, gen, temperature=1.0, top_p=0.5)) for _ in range(50)}
    assert picks == {0}
    picks = {int(sample_logits(logits, gen, temperature=1.0, top_p=1.0, top_k=2))
             for _ in range(200)}
    assert picks == {0, 1}
    assert int(sample_logits(logits, gen, temperature=0.0)) == 0
    rows = sample_logits(torch.tensor([[0.0, 5.0], [5.0, 0.0]]), gen,
                         temperature=torch.tensor([0.0, 0.0]), top_p=1.0)
    assert rows.tolist() == [1, 0]


def test_generate_eos_and_stream():
    _, _, cfg, params = _models(seed=4)
    r = ModelRunner("llama", cfg, params, max_seq_len=40, dtype=torch.float32, device="cpu")
    seen = []
    out = generate(r, [1, 2, 3], max_new_tokens=6, temperature=0.0, stream=seen.append)
    eos = int(out[0, 3])
    cut = generate(r, [1, 2, 3], max_new_tokens=6, temperature=0.0, eos_token_id=eos)
    assert cut.shape == (1, 4) and len(seen) == 6
    held = generate(r, [1, 2, 3], max_new_tokens=6, temperature=0.0, eos_token_id=eos,
                    min_new_tokens=3)
    assert held.shape[1] >= 6 and eos not in held[0, 3:6]
    sampled = generate(r, [1, 2, 3], max_new_tokens=6, temperature=0.9, seed=5)
    np.testing.assert_array_equal(sampled, generate(r, [1, 2, 3], max_new_tokens=6,
                                                    temperature=0.9, seed=5))


def test_benchmark_decode_on_cpu_reports_no_device_memory():
    cfg = ModelConfig(**CFG)
    params = random_wire_llama(cfg, seed=1, groupsize=32, device="cpu", dtype=torch.float32)
    r = ModelRunner("llama", cfg, params, max_seq_len=16, dtype=torch.float32, device="cpu")
    res = benchmark_decode(r, np.arange(8)[None] % cfg.vocab_size, check=True, log=lambda s: 0)
    assert res["device"] == "cpu" and res["max_memory_bytes"] is None
    assert res["tokens"] == 8 and np.isfinite(res["ppl"]) and res["tokens_per_s"] > 0


def test_gaussian_wire_model_has_zero_mean_layers_and_live_tokens():
    """The model for checks that read tokens: weights like a quantized
    Gaussian, no column mean, every layer its own draw, reproducible from
    the seed; its greedy tokens depend on the prompt, while the uniform-code
    model of the speed runs emits one token whatever it is given."""
    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=8, num_heads=4, num_kv_heads=4, head_dim=64, max_seq_len=32)
    kw = dict(groupsize=32, device="cpu", dtype=torch.float32)
    params = gaussian_wire_llama(cfg, seed=0, **kw)
    a, b = (params["layers"][i]["mlp"]["down_proj"] for i in (0, 1))
    assert not torch.equal(a.qweight, b.qweight)
    # the two linears that write to the residual stream are a tenth as large
    for lin, k, std in ((params["layers"][0]["mlp"]["up_proj"], cfg.hidden_size, 0.02),
                        (a, cfg.intermediate_size, 0.002)):
        w = lin.dequantize(torch.float32)
        assert abs(w.mean().item()) < 5e-3 * std and 0.9 * std < w.std().item() < 1.1 * std
        assert w.mean(0).abs().max().item() < 5 * std / k ** 0.5
    assert 0.95 < params["embed_tokens"].std().item() < 1.05
    again = gaussian_wire_llama(cfg, seed=0, **kw)["layers"][1]["mlp"]["down_proj"]
    np.testing.assert_array_equal(again.qweight.numpy(), b.qweight.numpy())
    wire = a.to_wire()
    assert wire["qweight"].shape == (512 * 4 // 32, 256) and wire["scales"].dtype == np.float16

    def tokens(p):
        r = ModelRunner("llama", cfg, p, max_seq_len=32, dtype=torch.float32, device="cpu")
        return [generate(r, prompt, max_new_tokens=12, temperature=0.0)[0, len(prompt):].tolist()
                for prompt in ([1, 2, 3], [7, 100, 45, 9], [400, 2])]

    live, flat = tokens(params), tokens(random_wire_llama(cfg, seed=0, **kw))
    assert len({t for row in live for t in row}) >= 6 and live[0] != live[1] != live[2]
    assert len({t for row in flat for t in row}) == 1


def test_entry_points_need_the_card_unless_asked_for_cpu():
    cfg = ModelConfig(**CFG)
    params = random_wire_llama(cfg, seed=2, groupsize=32, device="cpu", dtype=torch.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRunner("llama", cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_wire_llama(cfg, seed=2, groupsize=32)
    from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
    w = params["layers"][0]["mlp"]["up_proj"].to_wire()
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"], bits=4)


def test_registry_and_weight_bytes():
    assert registry.get_arch("llama") is llama
    for name in ("opt", "neox", "gpt2"):   # every architecture of the TPU package is ported
        assert registry.get_arch(name).NAME == name
    with pytest.raises(ValueError, match="Unknown arch"):
        registry.get_arch("bloom")
    import bench
    for bits in (3, 4):
        cfg7 = dict(arch="llama", vocab_size=32000, hidden_size=4096,
                    intermediate_size=11008, num_layers=32, num_heads=32,
                    num_kv_heads=32, head_dim=128, max_seq_len=2048)
        assert model_weight_bytes(ModelConfig(**cfg7), bits=bits) == \
            bench.model_weight_bytes(JaxModelConfig(**cfg7), bits=bits)
    assert model_weight_bytes(ModelConfig(**cfg7)) == 3_702_521_856


def test_init_params_dense_forward_runs():
    cfg = ModelConfig(**CFG)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, 6), generator=torch.Generator().manual_seed(1))
    logits = llama.forward(params, cfg, ids)
    assert logits.shape == (1, 6, cfg.vocab_size) and torch.isfinite(logits).all()
    r = ModelRunner("llama", cfg, params, max_seq_len=16, dtype=torch.float32, device="cpu")
    lp, cache = r.prefill(ids, r.init_cache())
    torch.testing.assert_close(lp, logits, atol=2e-4, rtol=1e-3)
    assert jax.devices()[0].platform == "cpu"
