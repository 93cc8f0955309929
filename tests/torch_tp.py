"""Weights and TPU-package reference runs of the port's tensor-parallel tests.

One numpy wire tree per case (every packed linear of every layer its own
draw, ``torch_tp_workers.wire_linear``), handed to the TPU package's
shard_map runner and engine on the conftest's virtual CPU devices here, and
to the port's ranks (``torch_tp_workers``) in their own processes. The
configurations are tests/test_tp_model.py's.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.parallel.sharding import TP_RULES as JAX_TP_RULES
from gptq_for_llama_tpu.parallel.sharding import make_mesh as jax_make_mesh
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine

import torch_archs
from torch_tp_workers import wire_linear

BASE = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=4, head_dim=32, max_seq_len=64)
CFGS = {
    "llama": dict(BASE, arch="llama"),
    "opt": dict(BASE, arch="opt", act="relu", pos_embedding="learned", norm_eps=1e-5,
                attn_bias=True, mlp_bias=True),
    "neox": dict(BASE, arch="neox", act="gelu", rotary_pct=0.25, parallel_residual=True,
                 norm_eps=1e-5),
    "gpt2": dict(BASE, arch="gpt2", act="gelu_new", pos_embedding="learned", norm_eps=1e-5,
                 attn_bias=True, mlp_bias=True),
}
# GQA (tests/test_tp_model.py:109): kv_heads=2 caps tp at 2
GQA = dict(BASE, arch="llama", num_heads=8, num_kv_heads=2, head_dim=16)
# the K-padded row-parallel case (tests/test_tp_model.py:215): 15 groups of
# 32 in down_proj, padded to 16
K_PADDED = dict(BASE, arch="llama", intermediate_size=480, num_layers=1)


def _get(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def _set(tree, dotted, value):
    parts = dotted.split(".")
    for part in parts[:-1]:
        tree = tree[part]
    tree[parts[-1]] = value


def wire_tree(cfg: dict, seed: int = 0, act_order: bool = False, bits: int = 4,
              gs: int = 32) -> dict:
    """A model of ``cfg`` as a numpy tree whose layer linears (TP_RULES'
    names) are packed wire buffers, each its own draw; embeddings, norms and
    the head dense."""
    rng = np.random.RandomState(seed)
    hid, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    if cfg["arch"] == "llama":
        qh, kvh = cfg["num_heads"] * cfg["head_dim"], cfg["num_kv_heads"] * cfg["head_dim"]
        dense = lambda i, o: {"kernel": np.zeros((i, o), np.float32)}   # noqa: E731
        norm = lambda: (1 + 0.1 * rng.standard_normal(hid)).astype(np.float32)   # noqa: E731
        tree = {"embed_tokens": rng.standard_normal((v, hid)).astype(np.float32),
                "layers": [{"input_layernorm": norm(), "post_attention_layernorm": norm(),
                            "self_attn": {"q_proj": dense(hid, qh), "k_proj": dense(hid, kvh),
                                          "v_proj": dense(hid, kvh), "o_proj": dense(qh, hid)},
                            "mlp": {"gate_proj": dense(hid, inter), "up_proj": dense(hid, inter),
                                    "down_proj": dense(inter, hid)}}
                           for _ in range(cfg["num_layers"])],
                "norm": norm(),
                "lm_head": {"kernel": (rng.standard_normal((hid, v)) / hid ** 0.5)
                            .astype(np.float32)}}
    else:
        tree = torch_archs.np_tree(cfg, seed)
    for lp in tree["layers"]:
        for name in JAX_TP_RULES[cfg["arch"]]:
            d = _get(lp, name)
            k, n = d["kernel"].shape
            _set(lp, name, wire_linear(rng, k, n, bits, gs, act_order, d.get("bias")))
    return tree


def jax_tree(tree):
    """The TPU package's fp32 params of a wire tree."""
    if isinstance(tree, dict):
        if "qweight" in tree:
            return JaxPackedLinear.from_wire(tree["qweight"], tree["qzeros"], tree["scales"],
                                             tree["g_idx"], bits=int(tree["bits"]),
                                             bias=tree.get("bias"), dtype=jnp.float32)
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(np.asarray(tree, np.float32))


def jax_run_steps(runner, ids, nsteps: int = 3, scan: int = 0) -> dict:
    """tests/test_tp_model.py's ``_run_steps`` (and a greedy scan), as
    ``torch_tp_workers.run_steps`` runs it in the port."""
    ids = jnp.asarray(ids.astype(np.int32))
    cache = runner.init_cache()
    logits, cache = runner.prefill(ids, cache)
    out = {"prefill": np.asarray(logits[:, -1], np.float32)}
    tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1).astype(jnp.int32)[:, None]
    toks = []
    for _ in range(nsteps):
        toks.append(np.asarray(tok)[:, 0])
        logits, cache = runner.decode(tok, cache)
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1).astype(jnp.int32)[:, None]
    toks.append(np.asarray(tok)[:, 0])
    out.update(logits=np.asarray(logits, np.float32), toks=np.stack(toks, 1))
    if scan:
        cache = runner.init_cache()
        logits, cache = runner.prefill(ids, cache)
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1).astype(jnp.int32)[:, None]
        out["scan"] = np.asarray(runner.decode_greedy_scan(tok, cache, steps=scan)[0])
    return out


def jax_runner(cfg: dict, tree: dict, tp: int, dp: int, batch: int, **kw):
    return JaxModelRunner(cfg["arch"], JaxModelConfig(**cfg), jax_tree(tree), batch_size=batch,
                          max_seq_len=32, dtype=jnp.float32, mesh=jax_make_mesh(tp=tp, dp=dp),
                          shard_map_tp=True, **kw)


def jax_engine(cfg: dict, tree: dict, prompts, tp: int, **kw) -> dict:
    """The TPU package's shard_map engine (tests/test_tp_model.py:165-200's
    settings): greedy tokens by request."""
    eng = JaxServingEngine(cfg["arch"], JaxModelConfig(**cfg), jax_tree(tree), batch_slots=2,
                           max_seq_len=32, dtype=jnp.float32, prefill_buckets=(8,),
                           mesh=jax_make_mesh(tp=tp, dp=1), shard_map_tp=True, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(JaxGenRequest(uid=uid, prompt=np.asarray(p, np.int32), max_new_tokens=5,
                                 temperature=0.0))
    return {uid: np.asarray(t) for uid, t in eng.run().items()}


def jax_config(cfg: dict):
    return JaxModelConfig(**cfg)
