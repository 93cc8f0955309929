"""LLaMA architecture as plain functions over a dict of tensors.

Counterpart of ``gptq_for_llama_tpu/models/llama.py``: RMSNorm -> q/k/v ->
RoPE -> cache write + attention -> o_proj -> RMSNorm -> fused gate/up SiLU ->
down_proj, pre-norm residuals. Linear kernels are stored (in, out) for
``x @ w``; packed linears are ``ops.linear.PackedLinear``.
"""

from __future__ import annotations

import torch

from .common import apply_rope, attention_block, causal_mask, rms_norm, rope_cos_sin
from .config import ModelConfig
from .. import resolve_device
from ..ops.linear import dense, linear_apply
from ..ops.quant_matmul import fused_gate_up

NAME = "llama"

LAYER_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def sequential_groups(true_sequential: bool):
    """Quantization order within a layer (reference: llama.py:86-90)."""
    if true_sequential:
        return [["self_attn.k_proj", "self_attn.v_proj", "self_attn.q_proj"],
                ["self_attn.o_proj"],
                ["mlp.up_proj", "mlp.gate_proj"],
                ["mlp.down_proj"]]
    return [list(LAYER_LINEARS)]


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Random dense model for tests, drawn from ``generator`` (a CPU
    torch.Generator; the tensors are then moved to ``device``, the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    h, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    hid, inter = cfg.hidden_size, cfg.intermediate_size

    def randn(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    def lin(i, o):
        return dense((randn(i, o) * i ** -0.5).to(device=device, dtype=dtype))

    def ones():
        return torch.ones(hid, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
            "self_attn": {"q_proj": lin(hid, h), "k_proj": lin(hid, kvh),
                          "v_proj": lin(hid, kvh), "o_proj": lin(h, hid)},
            "mlp": {"gate_proj": lin(hid, inter), "up_proj": lin(hid, inter),
                    "down_proj": lin(inter, hid)},
        })
    return {
        "embed_tokens": (randn(cfg.vocab_size, hid) * 0.02).to(device=device, dtype=dtype),
        "layers": layers,
        "norm": ones(),
        "lm_head": lin(hid, cfg.vocab_size),
    }


def embed(params, cfg: ModelConfig, input_ids: torch.Tensor, positions=None):
    return params["embed_tokens"][input_ids]


def step_rope(cfg: ModelConfig, positions: torch.Tensor, dtype):
    """RoPE tables of one step, shared by every layer."""
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype=dtype)


def layer(cfg: ModelConfig, lp, x, positions, mask, past_kv=None, rope=None):
    """One decoder layer. x: (B, S, H). Returns (y, taps, present_kv).

    past_kv: None (plain causal forward, ``mask`` applies) or
    (cache_k, cache_v, offset[, write_mask]); the caches are written in place
    and attention reads them through the kernels. taps maps each linear's
    dotted name to the activation feeding it."""
    h_attn_in = rms_norm(x, lp["input_layernorm"], cfg.norm_eps)
    att = lp["self_attn"]
    q = linear_apply(att["q_proj"], h_attn_in)
    k = linear_apply(att["k_proj"], h_attn_in)
    v = linear_apply(att["v_proj"], h_attn_in)
    b, s, _ = x.shape
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    cos, sin = rope if rope is not None else rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, dtype=x.dtype)
    q, k = apply_rope(q, k, cos, sin)
    attn_out, present = attention_block(past_kv, q, k, v, mask)
    attn_out = attn_out.reshape(b, s, -1)
    x = x + linear_apply(att["o_proj"], attn_out)

    h_mlp_in = rms_norm(x, lp["post_attention_layernorm"], cfg.norm_eps)
    mlp = lp["mlp"]
    h_down_in = fused_gate_up(mlp["gate_proj"], mlp["up_proj"], h_mlp_in, cfg.act)
    y = x + linear_apply(mlp["down_proj"], h_down_in)

    taps = {
        "self_attn.q_proj": h_attn_in, "self_attn.k_proj": h_attn_in,
        "self_attn.v_proj": h_attn_in, "self_attn.o_proj": attn_out,
        "mlp.gate_proj": h_mlp_in, "mlp.up_proj": h_mlp_in,
        "mlp.down_proj": h_down_in,
    }
    return y, taps, present


def head_input(params, cfg: ModelConfig, x):
    """The activation feeding lm_head (final norm output)."""
    return rms_norm(x, params["norm"], cfg.norm_eps)


def head(params, cfg: ModelConfig, x):
    """Final norm + lm_head."""
    return linear_apply(params["lm_head"], head_input(params, cfg, x))


def forward(params, cfg: ModelConfig, input_ids: torch.Tensor, positions=None):
    """Full-model causal forward without a cache: (B, S) -> (B, S, V) logits."""
    s = input_ids.shape[1]
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(s, device=dev)[None, :]
    x = embed(params, cfg, input_ids)
    mask = causal_mask(s, s, device=dev)
    for lp in params["layers"]:
        x, _, _ = layer(cfg, lp, x, positions, mask)
    return head(params, cfg, x)
