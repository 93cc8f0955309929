"""GPT-NeoX architecture as plain functions over a dict of tensors.

Counterpart of ``gptq_for_llama_tpu/models/neox.py``: one fused
``query_key_value`` projection in HF's per-head interleaved layout
((B, S, H, 3 D), split per head), partial rotary embeddings (the first
``int(D * rotary_pct)`` dims of each head, in HF's half layout), parallel or
sequential residual, LayerNorm with bias and a GELU MLP. Attention runs the
cache forms and kernels of ``common.attention_block`` at head dim
hidden / heads (96 for GPT-NeoX-20B); the LayerNorms are plain fp32 torch,
as the TPU package leaves them to XLA. Kernel 6 (RMSNorm) is not on this path.
"""

from __future__ import annotations

import torch

from functools import partial

from .common import (DenseDraws, activation, apply_rope, attention_block, causal_forward,
                     head_of, layer_norm_of, rope_cos_sin, row_parallel_apply,
                     stack_layers)
from .config import ModelConfig
from .. import resolve_device
from ..ops.linear import linear_apply

NAME = "neox"

LAYER_LINEARS = ("attention.query_key_value", "attention.dense",
                 "mlp.dense_h_to_4h", "mlp.dense_4h_to_h")


def sequential_groups(true_sequential: bool):
    """The reference NeoX script has no true-sequential grouping."""
    return [list(LAYER_LINEARS)]


def rotary_dim(cfg: ModelConfig) -> int:
    return int(cfg.head_dim * cfg.rotary_pct)


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Random dense model for tests, drawn from ``generator`` (a CPU
    torch.Generator), then moved to ``device`` (the card unless the caller
    asks for the CPU)."""
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    d = DenseDraws(generator, dtype, resolve_device(device), hid)
    layers = [{"input_layernorm": d.ln(), "post_attention_layernorm": d.ln(),
               "attention": {"query_key_value": d.lin(hid, 3 * hid), "dense": d.lin(hid, hid)},
               "mlp": {"dense_h_to_4h": d.lin(hid, inter), "dense_4h_to_h": d.lin(inter, hid)}}
              for _ in range(cfg.num_layers)]
    return {"embed_in": d.randn(cfg.vocab_size, hid, std=0.02), "layers": layers,
            "final_layer_norm": d.ln(), "embed_out": d.lin(hid, cfg.vocab_size, bias=False)}


def embed(params, cfg: ModelConfig, input_ids: torch.Tensor, positions=None):
    return params["embed_in"][input_ids]


def step_rope(cfg: ModelConfig, positions: torch.Tensor, dtype):
    """The partial-rotary tables of one step, shared by every layer."""
    return rope_cos_sin(positions, rotary_dim(cfg), cfg.rope_theta, dtype=dtype)


def layer(cfg: ModelConfig, lp, x, positions, mask, past_kv=None, rope=None, tp_ctx=None):
    """One decoder layer. x: (B, S, H). Returns (y, taps, present_kv); the
    cache forms are ``common.apply_kv_cache``'s. tp_ctx: this rank's mesh
    under tensor parallelism (dense and dense_4h_to_h all-reduce)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    ln1 = layer_norm_of(lp["input_layernorm"], x, cfg.norm_eps)
    # HF GPTNeoX fused layout: (B, S, heads, 3 * head_dim), split per head
    qkv = linear_apply(lp["attention"]["query_key_value"], ln1).reshape(b, s, cfg.num_heads,
                                                                        3 * hd)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    rd = rotary_dim(cfg)
    cos, sin = rope if rope is not None else rope_cos_sin(positions, rd, cfg.rope_theta,
                                                          dtype=x.dtype)
    q, k = apply_rope(q, k, cos, sin, rotary_dim=rd)
    attn_out, present = attention_block(past_kv, q, k.contiguous(), v.contiguous(), mask)
    attn_out = attn_out.reshape(b, s, -1)
    attn_proj = row_parallel_apply(lp["attention"]["dense"], attn_out, tp_ctx)
    if cfg.parallel_residual:
        ln2 = layer_norm_of(lp["post_attention_layernorm"], x, cfg.norm_eps)
        act_out = activation(cfg.act)(linear_apply(lp["mlp"]["dense_h_to_4h"], ln2))
        y = x + attn_proj + row_parallel_apply(lp["mlp"]["dense_4h_to_h"], act_out, tp_ctx)
    else:
        attn_res = x + attn_proj
        ln2 = layer_norm_of(lp["post_attention_layernorm"], attn_res, cfg.norm_eps)
        act_out = activation(cfg.act)(linear_apply(lp["mlp"]["dense_h_to_4h"], ln2))
        y = attn_res + row_parallel_apply(lp["mlp"]["dense_4h_to_h"], act_out, tp_ctx)
    taps = {"attention.query_key_value": ln1, "attention.dense": attn_out,
            "mlp.dense_h_to_4h": ln2, "mlp.dense_4h_to_h": act_out}
    return y, taps, present


stack = partial(stack_layers, layer)   # (x, None): no residual add left pending


def head_input(params, cfg: ModelConfig, x, delta=None):
    """The activation feeding embed_out: the final LayerNorm. delta is
    always None (``stack``)."""
    return layer_norm_of(params["final_layer_norm"], x, cfg.norm_eps)


def logits(params, cfg: ModelConfig, h):
    return linear_apply(params["embed_out"], h)


head = partial(head_of, head_input, logits)
forward = partial(causal_forward, embed, stack, head)
