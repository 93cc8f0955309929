"""Helpers of the port's OPT, GPT-NeoX and GPT-2 tests: one numpy weight tree
in the hand-over format of both packages, and the runs that hold the port's
runner and serving engine against the TPU package's on it.

Every weight is drawn on its own (no symmetric or shared draws), so a wrong
split of a fused projection, a wrong position offset or a swapped norm shows.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine, generate

CONFIGS = {
    "opt": dict(arch="opt", vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64, norm_eps=1e-5,
                act="relu", pos_embedding="learned", attn_bias=True, mlp_bias=True,
                tie_word_embeddings=True),
    "neox": dict(arch="neox", vocab_size=96, hidden_size=32, intermediate_size=64,
                 num_layers=2, num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64,
                 norm_eps=1e-5, rotary_pct=0.5, act="gelu", parallel_residual=True,
                 attn_bias=True, mlp_bias=True),
    "gpt2": dict(arch="gpt2", vocab_size=96, hidden_size=32, intermediate_size=64,
                 num_layers=2, num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64,
                 norm_eps=1e-5, act="gelu_new", pos_embedding="learned", attn_bias=True,
                 mlp_bias=True, tie_word_embeddings=True),
}

PROMPTS = [np.array([1, 2, 3]), np.array([5, 6]), np.arange(3, 20), np.array([4]),
           np.arange(1, 12)]


def np_tree(cfg: dict, seed: int = 0) -> dict:
    """A dense model of ``cfg``'s arch as a numpy tree, every tensor its own
    draw (biases and LayerNorm shifts included)."""
    rng = np.random.RandomState(seed)
    hid, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]

    def lin(i, o, bias=True):
        d = {"kernel": (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32)}
        if bias:
            d["bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
        return d

    def ln():
        return {"w": (1 + 0.1 * rng.standard_normal(hid)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(hid)).astype(np.float32)}

    def emb(*shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    arch = cfg["arch"]
    if arch == "opt":
        proj = cfg.get("word_embed_proj_dim") or hid
        layers = [{"self_attn_layer_norm": ln(), "final_layer_norm": ln(),
                   "self_attn": {n: lin(hid, hid) for n in
                                 ("q_proj", "k_proj", "v_proj", "out_proj")},
                   "fc1": lin(hid, inter), "fc2": lin(inter, hid)}
                  for _ in range(cfg["num_layers"])]
        tree = {"embed_tokens": emb(v, proj, std=0.5),
                "embed_positions": emb(cfg["max_seq_len"] + 2, hid, std=0.5),
                "layers": layers, "final_layer_norm": ln()}
        if cfg.get("word_embed_proj_dim"):
            tree["project_in"] = lin(proj, hid, bias=False)
            tree["project_out"] = lin(hid, proj, bias=False)
        tree["lm_head"] = {"kernel": np.ascontiguousarray(tree["embed_tokens"].T)}
        return tree
    if arch == "neox":
        layers = [{"input_layernorm": ln(), "post_attention_layernorm": ln(),
                   "attention": {"query_key_value": lin(hid, 3 * hid), "dense": lin(hid, hid)},
                   "mlp": {"dense_h_to_4h": lin(hid, inter), "dense_4h_to_h": lin(inter, hid)}}
                  for _ in range(cfg["num_layers"])]
        return {"embed_in": emb(v, hid), "layers": layers, "final_layer_norm": ln(),
                "embed_out": lin(hid, v, bias=False)}
    layers = [{"ln_1": ln(), "ln_2": ln(),
               "attn": {"c_attn": lin(hid, 3 * hid), "c_proj": lin(hid, hid)},
               "mlp": {"c_fc": lin(hid, inter), "c_proj": lin(inter, hid)}}
              for _ in range(cfg["num_layers"])]
    wte = emb(v, hid, std=0.5)
    return {"wte": wte, "wpe": emb(cfg["max_seq_len"], hid, std=0.5), "layers": layers,
            "ln_f": ln(), "lm_head": {"kernel": np.ascontiguousarray(wte.T)}}


def setup(arch: str, seed: int = 0, **kw):
    """(port cfg, port params (fp32, CPU), JAX cfg, JAX params) of one tree."""
    cfg = dict(CONFIGS[arch], **kw)
    tree = np_tree(cfg, seed)
    return (ModelConfig(**cfg), params_from_jax(tree, "cpu", torch.float32),
            JaxModelConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, tree))


def runner_tokens(cfg, params, prompt, max_new, **kw):
    r = ModelRunner(cfg.arch, cfg, params, batch_size=1, max_seq_len=48, dtype=torch.float32,
                    device="cpu", **kw)
    return generate(r, prompt, max_new_tokens=max_new, temperature=0.0)


def jax_runner_tokens(jcfg, jparams, prompt, max_new, **kw):
    jr = JaxModelRunner(jcfg.arch, jcfg, jparams, batch_size=1, max_seq_len=48,
                        dtype=jnp.float32, **kw)
    return np.asarray(jax_generate(jr, prompt, max_new_tokens=max_new, temperature=0.0))


def engine_tokens(cfg, params, prompts, max_new, **kw):
    eng = ServingEngine(cfg.arch, cfg, params, batch_slots=2, max_seq_len=32,
                        dtype=torch.float32, prefill_buckets=(8, 32), device="cpu", **kw)
    for uid, p in enumerate(prompts):
        eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=max_new))
    return eng.run(), eng


def jax_engine_tokens(jcfg, jparams, prompts, max_new, **kw):
    eng = JaxServingEngine(jcfg.arch, jcfg, jparams, batch_slots=2, max_seq_len=32,
                           dtype=jnp.float32, prefill_buckets=(8, 32), **kw)
    for uid, p in enumerate(prompts):
        eng.submit(JaxGenRequest(uid=uid, prompt=p.astype(np.int32), max_new_tokens=max_new,
                                 temperature=0.0))
    return {uid: np.asarray(t) for uid, t in eng.run().items()}


# the port's serving modes, each held to the TPU package's engine in the mode
# that computes the same function: its dense engine for the dense, paged and
# fold ones, its chunked engine for chunked prefill (over an fp8 cache a
# chunk attends its own k/v through the cache, so chunked and whole prefills
# differ in both packages)
ENGINE_MODES = {"dense": (dict(), "dense"), "paged": (dict(paged=True, block_size=8), "dense"),
                "fold": (dict(cache_impl="fold"), "dense"),
                "chunked": (dict(prefill_chunk=8), "chunked")}
JAX_MODES = {"dense": dict(), "chunked": dict(prefill_chunk=8)}


def check_engines(arch: str, kv: str):
    """Greedy tokens of the port's runner and of its engine in every mode of
    ENGINE_MODES EQUAL the TPU package's runner and engine, over a cache
    stored in ``kv`` ("bf16" or "fp8"; compute in fp32)."""
    cfg, params, jcfg, jparams = setup(arch, seed=len(kv))
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}[kv]
    prompt = np.arange(2, 9)
    np.testing.assert_array_equal(
        runner_tokens(cfg, params, prompt, 8, kv_dtype=tdt),
        jax_runner_tokens(jcfg, jparams, prompt, 8, kv_dtype=jdt))
    wants = {m: jax_engine_tokens(jcfg, jparams, PROMPTS, 5, kv_dtype=jdt, **kw)
             for m, kw in JAX_MODES.items()}
    for mode, (kw, ref) in ENGINE_MODES.items():
        got, eng = engine_tokens(cfg, params, PROMPTS, 5, kv_dtype=tdt, **kw)
        want = wants[ref]
        assert set(got) == set(want), mode
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid], err_msg=f"{mode} request {uid}")
        assert eng.forwards["decode"] > 0


def check_quantize_save_reload(arch_name: str, model_dir: str, out_dir: str):
    """The port quantizes a tiny HF checkpoint (GPTQ, 4-bit g16, on the CPU),
    packs and saves it; the saved directory reloads in the port with the
    packed linears' wire bytes unchanged and the same logits, and loads in
    the TPU package with logits within fp32 rounding of the port's."""
    from gptq_for_llama_tpu.models import hf_loader as jloader
    from gptq_for_llama_tpu.models import registry as jregistry
    from gptq_for_llama_tpu_torch.engine import (QuantizeSpec, pack_model, quantize_model,
                                                 save_packed)
    from gptq_for_llama_tpu_torch.models import hf_loader, registry
    from gptq_for_llama_tpu_torch.ops.linear import PackedLinear

    cfg, params = hf_loader.load_params(model_dir, dtype=torch.float32, seqlen=32, device="cpu")
    assert cfg.arch == arch_name
    windows = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(8, 32))
    spec = QuantizeSpec(wbits=4, groupsize=16, chunk=4)
    params, recs, _ = quantize_model(arch_name, cfg, params, windows, spec, verbose=False)
    arch = registry.get_arch(arch_name)
    assert len(recs) == cfg.num_layers * len(arch.LAYER_LINEARS)
    ids = torch.as_tensor(windows[:2, :16])
    fake = arch.forward(params, cfg, ids)
    params = pack_model(arch_name, cfg, params, recs, dtype=torch.float32)
    packed = arch.forward(params, cfg, ids)
    np.testing.assert_allclose(packed.numpy(), fake.numpy(), atol=2e-4, rtol=1e-3)
    save_packed(out_dir, arch_name, cfg, params, recs, spec)

    cfg2, p2 = hf_loader.load_params(out_dir, dtype=torch.float32, seqlen=32, device="cpu")
    assert cfg2 == cfg
    for li, (a, b) in enumerate(zip(params["layers"], p2["layers"])):
        for name in arch.LAYER_LINEARS:
            la, lb = (_path(t, name) for t in (a, b))
            assert isinstance(lb, PackedLinear), (li, name)
            for k, x in la.to_wire().items():
                assert np.asarray(x).tobytes() == np.asarray(lb.to_wire()[k]).tobytes(), k
    np.testing.assert_array_equal(arch.forward(p2, cfg2, ids).numpy(), packed.numpy())

    jcfg, jparams = jloader.load_params(out_dir, dtype=jnp.float32, seqlen=32)
    want = np.asarray(jregistry.get_arch(arch_name).forward(jparams, jcfg, jnp.asarray(ids)))
    np.testing.assert_allclose(packed.numpy(), want, atol=2e-4, rtol=1e-3)


def _path(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def check_hf_logits(arch_name: str, model_dir: str, hf_model):
    """The port's loader and forward on a tiny HF checkpoint against the TPU
    package's (fp32; 2e-4 + 1e-3 relative: the same arithmetic in another
    order) and against transformers' own forward (the same tolerance)."""
    from gptq_for_llama_tpu.models import hf_loader as jloader
    from gptq_for_llama_tpu.models import registry as jregistry
    from gptq_for_llama_tpu_torch.models import hf_loader, registry

    cfg, params = hf_loader.load_params(model_dir, dtype=torch.float32, device="cpu")
    jcfg, jparams = jloader.load_params(model_dir, dtype=jnp.float32)
    assert cfg.arch == jcfg.arch == arch_name
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 13))
    got = registry.get_arch(arch_name).forward(params, cfg, torch.as_tensor(ids)).numpy()
    want = np.asarray(jregistry.get_arch(arch_name).forward(jparams, jcfg, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    with torch.no_grad():
        hf = hf_model(torch.as_tensor(ids)).logits.numpy()
    np.testing.assert_allclose(got, hf, atol=2e-4, rtol=1e-3)


def check_tree_logits(arch_name: str, **kw):
    """``convert.params_from_jax`` of the TPU package's tree: the port's
    forward, and its runner's prefill, against the TPU package's forward."""
    from gptq_for_llama_tpu.models import registry as jregistry
    from gptq_for_llama_tpu_torch.models import registry

    cfg, params, jcfg, jparams = setup(arch_name, seed=3, **kw)
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(2, 11))
    want = np.asarray(jregistry.get_arch(arch_name).forward(jparams, jcfg, jnp.asarray(ids)))
    got = registry.get_arch(arch_name).forward(params, cfg, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    r = ModelRunner(arch_name, cfg, params, batch_size=2, max_seq_len=48, dtype=torch.float32,
                    device="cpu")
    lg, cache = r.prefill(torch.as_tensor(ids), r.init_cache())
    np.testing.assert_allclose(lg.numpy(), want, atol=2e-4, rtol=1e-3)
    assert cache.offset == ids.shape[1]
