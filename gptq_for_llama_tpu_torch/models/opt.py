"""OPT architecture as plain functions over a dict of tensors.

Counterpart of ``gptq_for_llama_tpu/models/opt.py``: learned positions at
offset 2, ``project_in`` / ``project_out`` where ``word_embed_proj_dim``
differs from hidden, pre- or post-LayerNorm (``do_layer_norm_before``), ReLU
MLP, biased linears and a tied head. Attention runs the cache forms and
kernels of ``common.attention_block`` at head dim hidden / heads (80 for
OPT-2.7B); the LayerNorms are plain fp32 torch, as the TPU package leaves
them to XLA. Kernel 6 (RMSNorm) is not on this path.
"""

from __future__ import annotations

import torch

from functools import partial

from .common import (DenseDraws, activation, attention_block, causal_forward, head_of,
                     check_max_len, layer_norm_of, learned_positions,
                     row_parallel_apply, stack_layers)
from .config import ModelConfig
from .. import resolve_device
from ..ops.linear import dense, linear_apply

NAME = "opt"

LAYER_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "self_attn.out_proj", "fc1", "fc2")

POSITION_OFFSET = 2  # OPT's learned embedding offset


def sequential_groups(true_sequential: bool):
    """The reference OPT script has no true-sequential grouping."""
    return [list(LAYER_LINEARS)]


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Random dense model for tests, drawn from ``generator`` (a CPU
    torch.Generator), then moved to ``device`` (the card unless the caller
    asks for the CPU)."""
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    proj = cfg.word_embed_proj_dim or hid
    d = DenseDraws(generator, dtype, resolve_device(device), hid)
    layers = [{"self_attn_layer_norm": d.ln(), "final_layer_norm": d.ln(),
               "self_attn": {"q_proj": d.lin(hid, hid), "k_proj": d.lin(hid, hid),
                             "v_proj": d.lin(hid, hid), "out_proj": d.lin(hid, hid)},
               "fc1": d.lin(hid, inter), "fc2": d.lin(inter, hid)}
              for _ in range(cfg.num_layers)]
    params = {"embed_tokens": d.randn(cfg.vocab_size, proj, std=0.02),
              "embed_positions": d.randn(cfg.max_seq_len + POSITION_OFFSET, hid, std=0.02),
              "layers": layers, "final_layer_norm": d.ln()}
    if cfg.word_embed_proj_dim:
        params["project_in"] = d.lin(proj, hid, bias=False)
        params["project_out"] = d.lin(hid, proj, bias=False)
    params["lm_head"] = (dense(params["embed_tokens"].T) if cfg.tie_word_embeddings
                         else d.lin(proj, cfg.vocab_size, bias=False))
    return params


def max_positions(params) -> int:
    """The positions the learned table holds (its rows past the offset)."""
    return params["embed_positions"].shape[0] - POSITION_OFFSET


def embed(params, cfg: ModelConfig, input_ids: torch.Tensor, positions=None):
    """Token embedding (through ``project_in``) plus the learned position
    rows at positions + 2 (default 0 .. S-1); positions is a device tensor,
    so a CUDA graph reads the step's offsets, clamped into the table (only
    pad rows sit past it: ``registry.check_max_len``)."""
    check_max_len(NAME, max_positions(params), input_ids.shape[1])
    x = params["embed_tokens"][input_ids]
    if "project_in" in params:
        x = linear_apply(params["project_in"], x)
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return x + learned_positions(params["embed_positions"], positions + POSITION_OFFSET)


def step_rope(cfg: ModelConfig, positions: torch.Tensor, dtype):
    return None  # learned position embeddings (no rotary)


def layer(cfg: ModelConfig, lp, x, positions, mask, past_kv=None, rope=None, tp_ctx=None):
    """One decoder layer. x: (B, S, H). Returns (y, taps, present_kv); the
    cache forms are ``common.apply_kv_cache``'s. tp_ctx: this rank's mesh
    under tensor parallelism (out_proj and fc2 all-reduce)."""
    b, s, _ = x.shape
    residual = x
    h = layer_norm_of(lp["self_attn_layer_norm"], x, cfg.norm_eps) if cfg.do_layer_norm_before else x
    att = lp["self_attn"]
    q = linear_apply(att["q_proj"], h).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = linear_apply(att["k_proj"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = linear_apply(att["v_proj"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    attn_out, present = attention_block(past_kv, q, k, v, mask)
    attn_out = attn_out.reshape(b, s, -1)
    x = residual + row_parallel_apply(att["out_proj"], attn_out, tp_ctx)
    if not cfg.do_layer_norm_before:
        x = layer_norm_of(lp["self_attn_layer_norm"], x, cfg.norm_eps)

    residual = x
    h2 = layer_norm_of(lp["final_layer_norm"], x, cfg.norm_eps) if cfg.do_layer_norm_before else x
    act_out = activation(cfg.act)(linear_apply(lp["fc1"], h2))
    y = residual + row_parallel_apply(lp["fc2"], act_out, tp_ctx)
    if not cfg.do_layer_norm_before:
        y = layer_norm_of(lp["final_layer_norm"], y, cfg.norm_eps)

    taps = {"self_attn.q_proj": h, "self_attn.k_proj": h, "self_attn.v_proj": h,
            "self_attn.out_proj": attn_out, "fc1": h2, "fc2": act_out}
    return y, taps, present


stack = partial(stack_layers, layer)   # (x, None): no residual add left pending


def head_input(params, cfg: ModelConfig, x, delta=None):
    """The activation feeding lm_head: the final LayerNorm (pre-LN models)
    and ``project_out``. delta is always None (``stack``)."""
    if cfg.do_layer_norm_before and "final_layer_norm" in params:
        x = layer_norm_of(params["final_layer_norm"], x, cfg.norm_eps)
    if "project_out" in params:
        x = linear_apply(params["project_out"], x)
    return x


def logits(params, cfg: ModelConfig, h):
    """lm_head over ``head_input``'s output (tied: embed_tokens.T)."""
    return linear_apply(params["lm_head"], h)


head = partial(head_of, head_input, logits)
forward = partial(causal_forward, embed, stack, head)
