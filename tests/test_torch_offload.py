"""The port's OffloadRunner held against the TPU package's OffloadRunner and
against the port's resident runner, fp32 on the CPU (tests/test_offload.py's
sizes: hidden 32, 4 layers). On the CPU the streamed layers are staged by
plain copies into the same two slots the card uses, so these tests run the
runner's own staging order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import registry as jregistry
from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.runtime.offload import OffloadRunner as JaxOffloadRunner
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
from gptq_for_llama_tpu_torch.runtime.offload import OffloadRunner, tensors

from test_torch_model import _jax_packed_llama, _to_wire_tree
import torch_archs

CFG = dict(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=4,
           num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=32)
PROMPT = np.array([3, 1, 4, 1, 5])


def _models(seed=0, **kw):
    cfg = dict(CFG, **kw)
    jcfg = JaxModelConfig(**cfg)
    jparams = jregistry.get_arch("llama").init_params(jcfg, jax.random.PRNGKey(seed),
                                                      dtype=jnp.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, ModelConfig(**cfg), params


def _offload(cfg, params, pre_layer=2, **kw):
    return OffloadRunner(cfg.arch, cfg, params, pre_layer=pre_layer, dtype=torch.float32,
                         max_seq_len=32, device="cpu", **kw)


def _resident(cfg, params, **kw):
    return ModelRunner(cfg.arch, cfg, params, max_seq_len=32, dtype=torch.float32,
                       device="cpu", **kw)


def test_offload_forward_and_perplexity_match_jax():
    """Logits of the streamed forward within JAX's own test's tolerance of
    the TPU package's OffloadRunner and of its arch.forward; perplexity
    within 1e-4 of JAX's streamed perplexity; every pass stages each
    streamed layer once."""
    jcfg, jparams, cfg, params = _models()
    ids = np.arange(10, dtype=np.int32)[None] % cfg.vocab_size
    jr = JaxOffloadRunner("llama", jcfg, jparams, pre_layer=2, dtype=jnp.float32)
    r = _offload(cfg, params)
    assert len(r.resident) == 2 and len(r.host_layers) == 2 and len(r.layers.slots) == 2
    got = r.forward(ids).numpy()
    for want in (np.asarray(jr.forward(ids)),
                 np.asarray(jregistry.get_arch("llama").forward(jparams, jcfg,
                                                                jnp.asarray(ids)))):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert r.layers.staged_bytes == r.streamed_bytes > 0
    stream = np.arange(64, dtype=np.int32) % cfg.vocab_size
    ppl, want = r.perplexity(stream, 16), jr.perplexity(stream, 16)
    assert np.isfinite(ppl) and abs(ppl - want) <= 1e-4 * want


def test_offload_generate_matches_jax_and_the_resident_runner():
    """Greedy tokens equal to the TPU package's offloaded generate and to
    the port's resident runner (spans of 32 through its graphs' bodies);
    sampled tokens equal to the resident runner's at the same seed, and
    ``generate(span=8)`` takes the per-token loop for this runner."""
    jcfg, jparams, cfg, params = _models(seed=1, vocab_size=128, max_seq_len=64)
    off, res = _offload(cfg, params), _resident(cfg, params)
    jr = JaxOffloadRunner("llama", jcfg, jparams, pre_layer=2, dtype=jnp.float32,
                          max_seq_len=32)
    got = off.generate(PROMPT, max_new_tokens=10)
    np.testing.assert_array_equal(got, np.asarray(jr.generate(PROMPT, max_new_tokens=10)))
    np.testing.assert_array_equal(got, generate(res, PROMPT, max_new_tokens=10, temperature=0.0))
    np.testing.assert_array_equal(generate(off, PROMPT, max_new_tokens=10, temperature=0.0,
                                           span=8), got)
    assert off.forwards == {"prefill": 2, "decode": 18}
    sampled = off.generate(PROMPT, max_new_tokens=6, temperature=0.7, top_p=0.9, seed=5)
    np.testing.assert_array_equal(sampled, generate(res, PROMPT, max_new_tokens=6,
                                                    temperature=0.7, top_p=0.9, seed=5))


def test_offload_generate_eos_stops():
    jcfg, jparams, cfg, params = _models(num_layers=2)
    off = _offload(cfg, params, pre_layer=1)
    p = np.array([1, 2, 3])
    full = off.generate(p, max_new_tokens=8)[0, len(p):]
    eos = int(full[2])
    stop_at = int(np.argmax(full == eos))
    got = off.generate(p, max_new_tokens=8, eos_token_id=eos)[0, len(p):]
    np.testing.assert_array_equal(got, full[:stop_at + 1])


@pytest.mark.parametrize("pre_layer", [0, 4, -1, 5])
def test_offload_pre_layer_bounds(pre_layer):
    """pre_layer 0 (every layer streamed) and num_layers (none) give the
    resident runner's greedy tokens; -1 and num_layers + 1 raise."""
    _, _, cfg, params = _models(seed=2)
    if not 0 <= pre_layer <= cfg.num_layers:
        with pytest.raises(ValueError, match="pre_layer"):
            _offload(cfg, params, pre_layer=pre_layer)
        return
    off = _offload(cfg, params, pre_layer=pre_layer)
    assert len(off.host_layers) == cfg.num_layers - pre_layer
    assert len(off.layers.slots) == min(2, cfg.num_layers - pre_layer)
    np.testing.assert_array_equal(
        off.generate(PROMPT, max_new_tokens=6),
        generate(_resident(cfg, params), PROMPT, max_new_tokens=6, temperature=0.0))


def test_offload_packed_int4_over_an_fp8_cache_matches_jax():
    """A packed INT4 tree (the TPU package's packed linears handed over by
    ``params_from_jax``) over an fp8-e4m3 cache: greedy tokens equal to the
    TPU package's offloaded generate over the same; the streamed layers'
    slots are packed linears with each layer's own metadata; the caller's
    tree keeps its tensors."""
    kw = dict(hidden_size=64, intermediate_size=128, head_dim=16)
    jcfg, cfg = JaxModelConfig(**dict(CFG, **kw)), ModelConfig(**dict(CFG, **kw))
    jparams = _jax_packed_llama(jcfg, seed=3, actorder=True)
    params = params_from_jax(_to_wire_tree(jparams), "cpu", torch.float32)
    before = [t.clone() for t in tensors(params)]
    off = _offload(cfg, params, kv_dtype=torch.float8_e4m3fn)
    jr = JaxOffloadRunner("llama", jcfg, jparams, pre_layer=2, dtype=jnp.float32,
                          max_seq_len=32, kv_dtype=jnp.float8_e4m3fn)
    got = off.generate(PROMPT, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(jr.generate(PROMPT, max_new_tokens=8)))
    assert off.kv_dtype == torch.float8_e4m3fn
    for i, view in enumerate(off.layers.views):
        host = off.host_layers[i]["mlp"]["down_proj"]
        lin = view["mlp"]["down_proj"]
        slot = off.layers.slots[i % 2]
        assert lin.qweight.untyped_storage().data_ptr() == slot.untyped_storage().data_ptr()
        assert lin.perm_sig == host.perm_sig and lin.g_idx is host.g_idx
    assert all(torch.equal(a, b) for a, b in zip(before, tensors(params)))


@pytest.mark.parametrize("arch", ["neox", "opt"])
def test_offload_other_families_match_jax(arch):
    """GPT-NeoX (parallel residual, partial rotary) and OPT (learned
    positions): greedy tokens equal to the TPU package's offloaded generate
    and to the port's resident runner."""
    cfg, params, jcfg, jparams = torch_archs.setup(arch, seed=4, num_layers=3)
    off = OffloadRunner(arch, cfg, params, pre_layer=1, dtype=torch.float32, max_seq_len=32,
                        device="cpu")
    jr = JaxOffloadRunner(arch, jcfg, jparams, pre_layer=1, dtype=jnp.float32, max_seq_len=32)
    got = off.generate(PROMPT, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(jr.generate(PROMPT, max_new_tokens=8)))
    np.testing.assert_array_equal(got, torch_archs.runner_tokens(cfg, params, PROMPT, 8))


def _mixed_layouts():
    """A 4-layer packed LLaMA whose layers differ in shape: layers 0-1 INT4
    g32 act-order, layer 2 the same but its down_proj INT8 g16 with no
    permutation, layer 3 INT2 g16 with no permutation (what ``--observe``'s
    upgrades, or a checkpoint without act-order in some layers, leave)."""
    kw = dict(hidden_size=64, intermediate_size=128, head_dim=16)
    jcfg, cfg = JaxModelConfig(**dict(CFG, **kw)), ModelConfig(**dict(CFG, **kw))
    a = _jax_packed_llama(jcfg, seed=7, actorder=True)
    b = _jax_packed_llama(jcfg, seed=8, bits=8, gs=16)
    c = _jax_packed_llama(jcfg, seed=9, bits=2, gs=16)
    layers = [a["layers"][0], a["layers"][1], dict(a["layers"][2]), c["layers"][3]]
    layers[2]["mlp"] = dict(layers[2]["mlp"], down_proj=b["layers"][2]["mlp"]["down_proj"])
    jparams = dict(a, layers=layers)
    return jcfg, jparams, cfg, params_from_jax(_to_wire_tree(jparams), "cpu", torch.float32)


def test_offload_streams_layers_of_mixed_shapes():
    """The streamed layers differ in group size, bits and permutation: each
    is staged at its own shapes into a slot sized for the largest, and the
    forward, perplexity and greedy tokens match the TPU package's
    OffloadRunner (which stages each layer at its own shapes) and the port's
    resident runner."""
    jcfg, jparams, cfg, params = _mixed_layouts()
    off = _offload(cfg, params, pre_layer=1)
    assert len({tuple(t.shape for t in tensors(h)) for h in off.host_layers}) == 3
    assert all(s.numel() >= off.layers.layer_bytes for s in off.layers.slots)
    assert off.layers.layer_bytes == max(off.layers.bytes_of) > min(off.layers.bytes_of)
    jr = JaxOffloadRunner("llama", jcfg, jparams, pre_layer=1, dtype=jnp.float32,
                          max_seq_len=32)
    ids = np.arange(10, dtype=np.int32)[None] % cfg.vocab_size
    np.testing.assert_allclose(off.forward(ids).numpy(), np.asarray(jr.forward(ids)),
                               atol=2e-4, rtol=1e-3)
    assert off.layers.staged_bytes == off.streamed_bytes == sum(off.layers.bytes_of)
    stream = np.arange(64, dtype=np.int32) % cfg.vocab_size
    ppl, want = off.perplexity(stream, 16), jr.perplexity(stream, 16)
    assert np.isfinite(ppl) and abs(ppl - want) <= 1e-4 * want
    got = off.generate(PROMPT, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(jr.generate(PROMPT, max_new_tokens=8)))
    np.testing.assert_array_equal(got, generate(_resident(cfg, params), PROMPT,
                                                max_new_tokens=8, temperature=0.0))
