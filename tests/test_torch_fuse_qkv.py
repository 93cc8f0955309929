"""Fused q/k/v (ROADMAP A4) held against the TPU package.

``PackedLinear.concat_outputs``, ``llama.fuse_attention`` and ``fuse_qkv=``
on the runner and the serving engine: the same wire buffers through both
packages on the CPU (fp32, the port through its plain versions), the fused
device tensors and wire bytes equal, the logits within fp32 rounding and the
greedy tokens EQUAL.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import llama as jllama
from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models import llama
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine, generate

CFG = dict(arch="llama", vocab_size=96, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=64)


def _wire(k, n, seed, bits=4, gs=16, actorder=False, bias=False):
    """Wire buffers of one packed linear; every linear its own draw."""
    rng = np.random.RandomState(seed)
    g = k // gs
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if actorder:
        p = rng.permutation(k)
        codes, g_idx = codes[p], g_idx[p]
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    w = dict(qweight=jpack.pack_rows(codes, bits), qzeros=jpack.pack_cols(zeros - 1, bits),
             scales=(rng.rand(g, n) * 0.04 + 0.01).astype(np.float16), g_idx=g_idx)
    if bias:
        w["bias"] = rng.standard_normal(n).astype(np.float32) * 0.1
    return w


def _both(w, bits=4):
    return (PackedLinear.from_wire(**w, bits=bits, dtype=torch.float32, device="cpu"),
            JaxPackedLinear.from_wire(**w, bits=bits, dtype=jnp.float32))


@pytest.mark.parametrize("bits,biases", [(4, (True, False, True)), (2, (False,) * 3),
                                         (3, (False, True, False))])
def test_concat_outputs_matches_jax_bytes_and_wire(bits, biases):
    """The fused linear's scales, zeros and bias equal the TPU package's fused
    one (a missing bias is zeros), its codes are the three linears' side by
    side, its to_wire equals the TPU package's byte for byte and is the three
    wire buffers side by side, and its product equals the three products side
    by side (fp32, 1e-5)."""
    ns = (64, 32, 32)
    pairs = [_both(_wire(64, n, seed=i + bits, bits=bits, bias=b), bits)
             for i, (n, b) in enumerate(zip(ns, biases))]
    fused = PackedLinear.concat_outputs([p for p, _ in pairs])
    jfused = JaxPackedLinear.concat_outputs([j for _, j in pairs])
    assert fused.out_features == jfused.out_features == sum(ns)
    # the device codes side by side (the TPU package's device layout is its
    # own: its nibble interleave), the wire bytes equal below
    np.testing.assert_array_equal(fused.qweight.numpy(),
                                  torch.cat([p.qweight for p, _ in pairs], 1).numpy())
    np.testing.assert_array_equal(fused.scales.numpy(), np.asarray(jfused.scales))
    np.testing.assert_array_equal(fused.zeros.numpy(), np.asarray(jfused.zeros))
    if any(biases):
        np.testing.assert_array_equal(fused.bias.numpy(), np.asarray(jfused.bias))
    else:
        assert fused.bias is None and jfused.bias is None
    wire, jwire = fused.to_wire(), jfused.to_wire()
    for key in ("qweight", "qzeros", "scales", "g_idx"):
        assert np.asarray(wire[key]).tobytes() == np.asarray(jwire[key]).tobytes(), key
        if key != "g_idx":
            side = np.concatenate([p.to_wire()[key] for p, _ in pairs], axis=1)
            assert np.asarray(wire[key]).tobytes() == side.tobytes(), key
    x = torch.as_tensor(np.random.RandomState(0).standard_normal((3, 64)).astype(np.float32))
    from gptq_for_llama_tpu_torch.ops.linear import linear_apply
    np.testing.assert_allclose(linear_apply(fused, x).numpy(),
                               torch.cat([linear_apply(p, x) for p, _ in pairs], -1).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_concat_outputs_refuses_what_the_tpu_package_refuses():
    a = _both(_wire(64, 32, 0))[0]
    for other in (_wire(64, 32, 1, gs=32), _wire(64, 32, 2, bits=2)):
        bits = 2 if other["qweight"].shape[0] == 64 * 2 // 32 else 4
        with pytest.raises(ValueError, match="incompatible"):
            PackedLinear.concat_outputs([a, _both(other, bits)[0]])
    p1 = _both(_wire(64, 32, 3, actorder=True))[0]
    p2 = _both(_wire(64, 32, 4, actorder=True))[0]
    with pytest.raises(ValueError, match="permutation"):
        PackedLinear.concat_outputs([p1, p2])
    with pytest.raises(ValueError, match="permutation"):
        PackedLinear.concat_outputs([a, p1])


def _packed_tree(cfg, seed, actorder=False):
    """A packed LLaMA numpy tree in the hand-over format (wire dicts + bits)."""
    rng = np.random.RandomState(seed)
    h, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    qh, kvh = cfg["num_heads"] * cfg["head_dim"], cfg["num_kv_heads"] * cfg["head_dim"]
    count = iter(range(1000))

    def packed(k, n):
        w = _wire(k, n, seed * 100 + next(count), actorder=actorder)
        w["bits"] = 4
        return w

    layers = [{"input_layernorm": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
               "post_attention_layernorm": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
               "self_attn": {"q_proj": packed(h, qh), "k_proj": packed(h, kvh),
                             "v_proj": packed(h, kvh), "o_proj": packed(qh, h)},
               "mlp": {"gate_proj": packed(h, inter), "up_proj": packed(h, inter),
                       "down_proj": packed(inter, h)}} for _ in range(cfg["num_layers"])]
    return {"embed_tokens": rng.standard_normal((v, h)).astype(np.float32),
            "layers": layers, "norm": np.ones(h, np.float32),
            "lm_head": {"kernel": (rng.standard_normal((h, v)) / h ** 0.5).astype(np.float32)}}


def _jax_params(tree):
    def conv(t):
        if isinstance(t, dict) and "qweight" in t:
            w = {k: v for k, v in t.items() if k != "bits"}
            return JaxPackedLinear.from_wire(**w, bits=t["bits"], dtype=jnp.float32)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return jnp.asarray(t)
    return conv(tree)


def _models(seed=0, actorder=False):
    tree = _packed_tree(CFG, seed, actorder)
    return (ModelConfig(**CFG), params_from_jax(tree, "cpu", torch.float32),
            JaxModelConfig(**CFG), _jax_params(tree))


def test_fuse_attention_logits_match_jax_and_the_unfused_model():
    """Every layer fused, the caller's tree untouched and its tensors shared;
    the fused logits against the TPU package's fused model and the port's
    unfused one (fp32: 2e-4 + 1e-3 relative)."""
    cfg, params, jcfg, jparams = _models(seed=1)
    fused = llama.fuse_attention(params)
    assert all(set(lp["self_attn"]) == {"qkv_proj", "o_proj"} for lp in fused["layers"])
    assert all("q_proj" in lp["self_attn"] for lp in params["layers"])
    assert fused["embed_tokens"] is params["embed_tokens"]
    assert fused["layers"][0]["mlp"] is params["layers"][0]["mlp"]
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(2, 12))
    got = llama.forward(fused, cfg, torch.as_tensor(ids)).numpy()
    want = np.asarray(jllama.forward(jllama.fuse_attention(jparams), jcfg, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, llama.forward(params, cfg, torch.as_tensor(ids)).numpy(),
                               atol=2e-4, rtol=1e-3)
    # the taps feeding q/k/v stay as they were (quantization reads unfused params)
    x = torch.randn(1, 4, cfg.hidden_size)
    _, taps, _ = llama.layer(cfg, fused["layers"][0], x, torch.arange(4)[None], None)
    assert taps["self_attn.q_proj"] is taps["self_attn.k_proj"] is taps["self_attn.v_proj"]


def test_fuse_attention_leaves_act_order_layers_unfused(capsys):
    """Act-order q/k/v carry different input permutations: the layer stays
    unfused and the count goes to stderr, as in the TPU package."""
    cfg, params, _, _ = _models(seed=2, actorder=True)
    fused = llama.fuse_attention(params)
    assert all("q_proj" in lp["self_attn"] for lp in fused["layers"])
    assert "fuse_attention: fused 0/2 layers" in capsys.readouterr().err


def test_runner_fuse_qkv_greedy_tokens_match_jax():
    """ModelRunner(fuse_qkv=True): greedy tokens EQUAL the TPU package's
    runner with fuse_qkv=True, over the classic and the fold cache."""
    cfg, params, jcfg, jparams = _models(seed=3)
    prompt = np.arange(3, 11)
    jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=32,
                        dtype=jnp.float32, fuse_qkv=True)
    want = np.asarray(jax_generate(jr, prompt, max_new_tokens=10, temperature=0.0))
    for impl in ("classic", "fold"):
        r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32,
                        dtype=torch.float32, device="cpu", fuse_qkv=True, cache_impl=impl)
        assert all("qkv_proj" in lp["self_attn"] for lp in r.params["layers"])
        np.testing.assert_array_equal(generate(r, prompt, max_new_tokens=10, temperature=0.0),
                                      want)


PROMPTS = [np.array([1, 2, 3]), np.array([5, 6]), np.arange(3, 20), np.array([4]),
           np.arange(1, 12)]


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_engine_fuse_qkv_tokens_match_jax(kv):
    """ServingEngine(fuse_qkv=True), dense, paged, fold and chunked: greedy
    tokens EQUAL the TPU package's engine with fuse_qkv=True (its chunked
    engine for the chunked one: over fp8 a chunk attends its own k/v through
    the cache), over a cache stored in bf16 or fp8 (compute fp32)."""
    cfg, params, jcfg, jparams = _models(seed=4)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}[kv]
    wants = {}
    for ref, jkw in (("dense", dict()), ("chunked", dict(prefill_chunk=8))):
        jeng = JaxServingEngine("llama", jcfg, jparams, batch_slots=2, max_seq_len=32,
                                dtype=jnp.float32, prefill_buckets=(8, 32), fuse_qkv=True,
                                kv_dtype=jdt, **jkw)
        for uid, p in enumerate(PROMPTS):
            jeng.submit(JaxGenRequest(uid=uid, prompt=p.astype(np.int32), max_new_tokens=5,
                                      temperature=0.0))
        wants[ref] = {uid: np.asarray(t) for uid, t in jeng.run().items()}
    for kw in (dict(), dict(paged=True, block_size=8), dict(cache_impl="fold"),
               dict(prefill_chunk=8)):
        want = wants["chunked" if "prefill_chunk" in kw else "dense"]
        eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=32,
                            dtype=torch.float32, prefill_buckets=(8, 32), device="cpu",
                            fuse_qkv=True, kv_dtype=tdt, **kw)
        for uid, p in enumerate(PROMPTS):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=5))
        got = eng.run()
        assert set(got) == set(want)
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid], err_msg=f"{kw} request {uid}")
