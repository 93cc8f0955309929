"""GPT-2 architecture as plain functions over a dict of tensors.

Counterpart of ``gptq_for_llama_tpu/models/gpt2.py``: learned positions at
offset 0, pre-LayerNorm blocks, one fused ``c_attn`` projection in HF's
block layout [all Q heads | all K | all V] (not NeoX's per-head interleave),
a tanh-GELU MLP and the head tied to ``wte``. HF's Conv1D weights are stored
(in, out), this layout's kernel, so the loader does not transpose them.
Attention runs the cache forms and kernels of ``common.attention_block`` at
head dim hidden / heads (64 for GPT-2); the LayerNorms are plain fp32 torch,
as the TPU package leaves them to XLA. Kernel 6 (RMSNorm) is not on this path.
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

NAME = "gpt2"

LAYER_LINEARS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")


def sequential_groups(true_sequential: bool):
    """One group, or with true-sequential attention before the MLP, as the
    TPU package orders them."""
    if true_sequential:
        return [["attn.c_attn"], ["attn.c_proj"], ["mlp.c_fc"], ["mlp.c_proj"]]
    return [list(LAYER_LINEARS)]


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Random dense model for tests, drawn from ``generator`` (a CPU
    torch.Generator), then moved to ``device`` (the card unless the caller
    asks for the CPU). The head is tied to ``wte``, as in HF's GPT2LMHeadModel."""
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    d = DenseDraws(generator, dtype, resolve_device(device), hid)
    layers = [{"ln_1": d.ln(), "ln_2": d.ln(),
               "attn": {"c_attn": d.lin(hid, 3 * hid), "c_proj": d.lin(hid, hid)},
               "mlp": {"c_fc": d.lin(hid, inter), "c_proj": d.lin(inter, hid)}}
              for _ in range(cfg.num_layers)]
    wte = d.randn(cfg.vocab_size, hid, std=0.02)
    return {"wte": wte, "wpe": d.randn(cfg.max_seq_len, hid, std=0.01), "layers": layers,
            "ln_f": d.ln(), "lm_head": dense(wte.T)}


def max_positions(params) -> int:
    """The positions the learned table holds."""
    return params["wpe"].shape[0]


def embed(params, cfg: ModelConfig, input_ids: torch.Tensor, positions=None):
    """Token embedding plus the learned position rows (default 0 .. S-1); a
    device tensor of positions, clamped into the table (only pad rows sit
    past it: ``registry.check_max_len``)."""
    check_max_len(NAME, max_positions(params), input_ids.shape[1])
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return params["wte"][input_ids] + learned_positions(params["wpe"], positions)


def step_rope(cfg: ModelConfig, positions: torch.Tensor, dtype):
    return None  # learned position embeddings (no rotary)


def layer(cfg: ModelConfig, lp, x, positions, mask, past_kv=None, rope=None, tp_ctx=None):
    """One decoder layer. x: (B, S, H). Returns (y, taps, present_kv); the
    cache forms are ``common.apply_kv_cache``'s. tp_ctx: this rank's mesh
    under tensor parallelism (both c_proj all-reduce; c_attn regrouped per
    shard by ``parallel/tp_model``)."""
    b, s, _ = x.shape
    h = cfg.num_heads * cfg.head_dim
    ln1 = layer_norm_of(lp["ln_1"], x, cfg.norm_eps)
    qkv = linear_apply(lp["attn"]["c_attn"], ln1)
    # HF GPT2Attention block layout: [all Q heads | all K | all V]; the
    # attention kernels take contiguous operands
    q, k, v = (qkv[..., i * h:(i + 1) * h].reshape(b, s, cfg.num_heads, cfg.head_dim)
               .contiguous() for i in range(3))
    attn_out, present = attention_block(past_kv, q, k, v, mask)
    attn_out = attn_out.reshape(b, s, -1)
    x = x + row_parallel_apply(lp["attn"]["c_proj"], attn_out, tp_ctx)
    ln2 = layer_norm_of(lp["ln_2"], x, cfg.norm_eps)
    act_out = activation(cfg.act)(linear_apply(lp["mlp"]["c_fc"], ln2))
    y = x + row_parallel_apply(lp["mlp"]["c_proj"], act_out, tp_ctx)
    taps = {"attn.c_attn": ln1, "attn.c_proj": attn_out, "mlp.c_fc": ln2,
            "mlp.c_proj": act_out}
    return y, taps, present


stack = partial(stack_layers, layer)   # (x, None): no residual add left pending


def head_input(params, cfg: ModelConfig, x, delta=None):
    """The activation feeding lm_head: the final LayerNorm. delta is always
    None (``stack``)."""
    return layer_norm_of(params["ln_f"], x, cfg.norm_eps)


def logits(params, cfg: ModelConfig, h):
    return linear_apply(params["lm_head"], h)


head = partial(head_of, head_input, logits)
forward = partial(causal_forward, embed, stack, head)
