"""Seeded random LLaMA weights in the packed wire format.

The logic of the TPU package's ``bench.random_wire_llama``: random wire
buffers (qweight, qzeros, scales, g_idx) loaded through
``PackedLinear.from_wire``, the path a real checkpoint takes. One host array
is drawn per unique shape, but every layer gets its own device buffers, so a
decode step reads the full model from device memory (3.70 GB for LLaMA-7B
INT4-g128).

Those weights serve for speed: uniform codes against random zeros give every
weight column a mean, and the layers share one draw, so the residual stream
runs into one direction and the model emits one token whatever the prompt.
``gaussian_wire_llama`` is the model for checks that read tokens: codes like
a quantized N(0, 0.02) weight around a mid zero, every layer its own draw.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import params_from_jax
from ..quant import packing


def random_wire_linear(rng: np.random.RandomState, k: int, n: int, groupsize: int = 128,
                       bits: int = 4) -> dict:
    """Random wire buffers of one (k -> n) packed linear, plus ``bits``."""
    g = -(-k // groupsize)
    return {
        "qweight": rng.randint(-2**31, 2**31, size=(k * bits // 32, n), dtype=np.int32),
        "qzeros": rng.randint(-2**31, 2**31, size=(g, n * bits // 32), dtype=np.int32),
        "scales": (rng.rand(g, n) * 0.004 + 0.001).astype(np.float16),
        "g_idx": (np.arange(k) // groupsize).astype(np.int32),
        "bits": bits,
    }


def random_wire_tree(cfg, seed: int = 0, groupsize: int = 128, bits: int = 4) -> dict:
    """numpy wire tree (the ``convert.params_from_jax`` hand-over format) of a
    random LLaMA. Layers share their host arrays. Embedding and lm_head are
    Gaussian, scaled so the logits spread over a few units."""
    rng = np.random.RandomState(seed)
    shape_cache = {}

    def packed(k, n):
        if (k, n) not in shape_cache:
            shape_cache[(k, n)] = random_wire_linear(rng, k, n, groupsize, bits)
        return shape_cache[(k, n)]

    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    ones = np.ones((h,), np.float32)
    layers = [{
        "input_layernorm": ones,
        "post_attention_layernorm": ones,
        "self_attn": {"q_proj": packed(h, qh), "k_proj": packed(h, kvh),
                      "v_proj": packed(h, kvh), "o_proj": packed(qh, h)},
        "mlp": {"gate_proj": packed(h, inter), "up_proj": packed(h, inter),
                "down_proj": packed(inter, h)},
    } for _ in range(cfg.num_layers)]
    emb = rng.standard_normal((v, h)).astype(np.float32) * 0.02
    head = rng.standard_normal((h, v)).astype(np.float32) * (2.0 / h ** 0.5)
    return {"embed_tokens": emb, "layers": layers, "norm": ones,
            "lm_head": {"kernel": head}}


def random_wire_llama(cfg, seed: int = 0, groupsize: int = 128, bits: int = 4,
                      device=None, dtype=torch.bfloat16) -> dict:
    """Random packed LLaMA parameters on ``device`` (own buffers per layer);
    ``None`` means the card."""
    return params_from_jax(random_wire_tree(cfg, seed, groupsize, bits),
                           resolve_device(device), dtype)


def gaussian_wire_linear(gen: torch.Generator, k: int, n: int, groupsize: int = 128,
                         bits: int = 4, std: float = 0.02) -> dict:
    """Wire buffers of one (k -> n) linear whose weight looks like a
    round-to-nearest quantized N(0, std): codes rint(mid + N(0, 1) * maxq / 6)
    clipped to the code range (3 sigma each side), the zero at mid in every
    group, group scales within 10 % of std * 6 / maxq. Drawn on ``gen``'s
    device; 2, 4 or 8 bits."""
    g = -(-k // groupsize)
    maxq, mid = 2 ** bits - 1, 2 ** (bits - 1)
    dev = gen.device
    codes = torch.randn(k, n, generator=gen, device=dev).mul_(maxq / 6).add_(mid).round_()
    codes = codes.clamp_(0, maxq).to(torch.int32)
    scales = (0.9 + 0.2 * torch.rand(g, n, generator=gen, device=dev)) * (std * 6 / maxq)
    return {
        "qweight": packing.pack_rows_torch(codes, bits).cpu().numpy(),
        "qzeros": packing.pack_cols(np.full((g, n), mid - 1, np.uint32), bits),
        "scales": scales.cpu().numpy().astype(np.float16),
        "g_idx": (np.arange(k) // groupsize).astype(np.int32),
        "bits": bits,
    }


def gaussian_wire_llama(cfg, seed: int = 0, groupsize: int = 128, bits: int = 4,
                        device=None, dtype=torch.bfloat16, branch_gain: float = 0.1) -> dict:
    """Packed LLaMA parameters on ``device`` (``None``: the card) whose logits
    depend on the prompt: every linear of every layer is its own
    ``gaussian_wire_linear`` draw, made on the device from ``seed``. The
    embedding has unit variance and the two linears that write to the residual
    stream (o_proj, down_proj) are drawn at ``branch_gain`` x 0.02, so a layer
    adds a fraction of the stream, as in a trained network: with every branch
    at full size a deep random network amplifies a rounding difference layer
    over layer, and two correct runs of it part. Same shapes and bytes per
    token as ``random_wire_llama``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def packed(k, n, std=0.02):
        return params_from_jax(gaussian_wire_linear(gen, k, n, groupsize, bits, std), device,
                               dtype)

    out_std = 0.02 * branch_gain
    ones = torch.ones(h, dtype=dtype, device=device)
    layers = [{
        "input_layernorm": ones.clone(),
        "post_attention_layernorm": ones.clone(),
        "self_attn": {"q_proj": packed(h, qh), "k_proj": packed(h, kvh),
                      "v_proj": packed(h, kvh), "o_proj": packed(qh, h, out_std)},
        "mlp": {"gate_proj": packed(h, inter), "up_proj": packed(h, inter),
                "down_proj": packed(inter, h, out_std)},
    } for _ in range(cfg.num_layers)]
    emb = torch.randn(v, h, generator=gen, device=device)
    head = torch.randn(h, v, generator=gen, device=device) * (2.0 / h ** 0.5)
    return {"embed_tokens": emb.to(dtype), "layers": layers, "norm": ones.clone(),
            "lm_head": {"kernel": head.to(dtype)}}


def model_weight_bytes(cfg, groupsize: int = 128, bits: int = 4) -> int:
    """Device bytes a decode token reads: packed codes, bf16 scales and zeros,
    and the dense bf16 lm_head. INT3 is stored as 4-bit nibbles on the device."""
    dev_bits = 4 if bits == 3 else bits
    h, inter = cfg.hidden_size, cfg.intermediate_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = [(h, qh), (h, kvh), (h, kvh), (qh, h), (h, inter), (h, inter), (inter, h)]
    per_layer = sum(k * n * dev_bits // 8 + (k // groupsize) * n * 2 * 2 for k, n in shapes)
    return cfg.num_layers * per_layer + cfg.vocab_size * h * 2
