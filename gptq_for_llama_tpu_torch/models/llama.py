"""LLaMA architecture as plain functions over a dict of tensors.

Counterpart of ``gptq_for_llama_tpu/models/llama.py``: RMSNorm -> q/k/v ->
RoPE -> cache write + attention -> o_proj -> RMSNorm -> fused gate/up SiLU ->
down_proj, pre-norm residuals. Linear kernels are stored (in, out) for
``x @ w``; packed linears are ``ops.linear.PackedLinear``. Every residual add
that feeds a norm runs in the norm's launch (``add_rms_norm``): o_proj's
output in the post-attention norm, and, in ``stack``, each layer's down_proj
output in the next layer's input norm or in the final norm.
"""

from __future__ import annotations

from functools import partial

import torch

from .common import (add_rms_norm, apply_rope, attention_block, causal_forward, head_of,
                     rms_norm, rope_cos_sin, row_parallel_apply)
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


def layer(cfg: ModelConfig, lp, x, positions, mask, past_kv=None, rope=None, delta=None,
          defer=False, tp_ctx=None):
    """One decoder layer. x: (B, S, H). Returns (y, taps, present_kv).

    past_kv: None (plain causal forward, ``mask`` applies) or
    (cache_k, cache_v, offset[, write_mask]); the caches are written in place
    and attention reads them through the kernels. taps maps each linear's
    dotted name to the activation feeding it. delta: a residual add still
    pending from the layer before (its down_proj output): the layer's input
    is x + delta, added in the input norm's launch. defer: y is (x, down),
    the residual and this layer's pending add, in place of their sum.
    tp_ctx: this rank's ``parallel.Mesh`` under tensor parallelism (cfg is
    then the LOCAL per-shard config; o_proj and down_proj all-reduce over
    the tp group, ``row_parallel_apply``)."""
    if delta is None:
        h_attn_in = rms_norm(x, lp["input_layernorm"], cfg.norm_eps)
    else:
        x, h_attn_in = add_rms_norm(x, delta, lp["input_layernorm"], cfg.norm_eps)
    att = lp["self_attn"]
    if "qkv_proj" in att:   # the load-time fused projection (``fuse_attention``)
        qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        qkv = linear_apply(att["qkv_proj"], h_attn_in)
        # q and k leave RoPE as new tensors; v is copied out of the columns,
        # since the attention kernels take contiguous operands
        q, k, v = qkv[..., :qh], qkv[..., qh:qh + kvh], qkv[..., qh + kvh:].contiguous()
    else:
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
    x, h_mlp_in = add_rms_norm(x, row_parallel_apply(att["o_proj"], attn_out, tp_ctx),
                               lp["post_attention_layernorm"], cfg.norm_eps)

    mlp = lp["mlp"]
    h_down_in = fused_gate_up(mlp["gate_proj"], mlp["up_proj"], h_mlp_in, cfg.act)
    down = row_parallel_apply(mlp["down_proj"], h_down_in, tp_ctx)
    y = (x, down) if defer else x + down

    taps = {
        "self_attn.q_proj": h_attn_in, "self_attn.k_proj": h_attn_in,
        "self_attn.v_proj": h_attn_in, "self_attn.o_proj": attn_out,
        "mlp.gate_proj": h_mlp_in, "mlp.up_proj": h_mlp_in,
        "mlp.down_proj": h_down_in,
    }
    return y, taps, present


def fuse_attention(params):
    """Fuse each layer's packed q/k/v into one ``self_attn.qkv_proj``
    (``PackedLinear.concat_outputs``): one kernel-1 launch a layer in place
    of three, split into q, k and v at H * D and H * D + Hkv * D. The
    counterpart of ``gptq_for_llama_tpu/models/llama.py:fuse_attention``.
    Returns a copy of the tree whose edited dicts are new; the caller's
    params keep their q/k/v and every other tensor is shared. A layer whose
    q/k/v are dense or cannot concat (act-order: different input
    permutations) stays unfused, and the count is printed to stderr as the
    TPU package does. Quantization reads unfused params only."""
    from ..ops.linear import PackedLinear
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        att = lp["self_attn"]
        lins = [att.get(n) for n in ("q_proj", "k_proj", "v_proj")]
        fused = None
        if all(isinstance(lin, PackedLinear) for lin in lins):
            try:
                fused = PackedLinear.concat_outputs(lins)
            except ValueError:
                fused = None
        if fused is None:
            out["layers"].append(lp)
            continue
        att = {k: v for k, v in att.items() if k not in ("q_proj", "k_proj", "v_proj")}
        att["qkv_proj"] = fused
        lp = dict(lp)
        lp["self_attn"] = att
        out["layers"].append(lp)
    n_fused = sum(1 for lp in out["layers"] if "qkv_proj" in lp["self_attn"])
    if n_fused < len(out["layers"]):
        import sys
        print(f"fuse_attention: fused {n_fused}/{len(out['layers'])} layers "
              "(rest have dense or layout-incompatible q/k/v)", file=sys.stderr)
    return out


def stack(params, cfg: ModelConfig, x, positions, mask, past=None, rope=None, tp_ctx=None):
    """Every layer over x, each layer's down_proj output carried to the next
    one's input norm. past(li): layer li's cache form (None: no cache);
    tp_ctx: this rank's mesh under tensor parallelism.
    Returns (x, delta): the residual stream and the last layer's pending add,
    for ``head`` / ``head_input``; the hidden state is x + delta."""
    delta = None
    for li, lp in enumerate(params["layers"]):
        (x, delta), _, _ = layer(cfg, lp, x, positions, mask,
                                 None if past is None else past(li), rope=rope, delta=delta,
                                 defer=True, tp_ctx=tp_ctx)
    return x, delta


def head_input(params, cfg: ModelConfig, x, delta=None):
    """The activation feeding lm_head: the final norm of x (+ delta, added in
    the norm's launch)."""
    if delta is None:
        return rms_norm(x, params["norm"], cfg.norm_eps)
    return add_rms_norm(x, delta, params["norm"], cfg.norm_eps)[1]


def logits(params, cfg: ModelConfig, h):
    """lm_head over the final norm's output ``h``."""
    return linear_apply(params["lm_head"], h)


head = partial(head_of, head_input, logits)   # final norm + lm_head
forward = partial(causal_forward, embed, stack, head)
