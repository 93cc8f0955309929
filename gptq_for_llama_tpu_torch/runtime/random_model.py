"""Seeded random weights in the packed wire format: LLaMA, and the
``gaussian_wire_<arch>`` models of OPT, GPT-NeoX and GPT-2.

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
                         bits: int = 4, std: float = 0.02, g_idx=None) -> dict:
    """Wire buffers of one (k -> n) linear whose weight looks like a
    round-to-nearest quantized N(0, std): codes rint(mid + N(0, 1) * maxq / 6)
    clipped to the code range (3 sigma each side), the zero at mid in every
    group, group scales within 10 % of std * 6 / maxq. Drawn on ``gen``'s
    device; 2, 4 or 8 bits. ``g_idx``: the rows' groups (None: the natural
    order; ``act_order_g_idx`` for an act-order checkpoint's)."""
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
        "g_idx": (np.arange(k) // groupsize).astype(np.int32) if g_idx is None else g_idx,
        "bits": bits,
    }


def act_order_g_idx(gen: torch.Generator, k: int, groupsize: int) -> np.ndarray:
    """An act-order checkpoint's groups of k rows: the natural g_idx under a
    random permutation drawn from ``gen`` (GPTQ sorts the rows by the
    Hessian's diagonal, so the linears that read one activation share it)."""
    g_idx = (np.arange(k) // groupsize).astype(np.int32)
    return g_idx[torch.randperm(k, generator=gen, device=gen.device).cpu().numpy()]


def gaussian_wire_llama(cfg, seed: int = 0, groupsize: int = 128, bits: int = 4,
                        device=None, dtype=torch.bfloat16, branch_gain: float = 0.1,
                        act_order: bool = False) -> dict:
    """Packed LLaMA parameters on ``device`` (``None``: the card) whose logits
    depend on the prompt: every linear of every layer is its own
    ``gaussian_wire_linear`` draw, made on the device from ``seed``. The
    embedding has unit variance and the two linears that write to the residual
    stream (o_proj, down_proj) are drawn at a tenth of 0.02, so a layer
    adds a fraction of the stream, as in a trained network: with every branch
    at full size a deep random network amplifies a rounding difference layer
    over layer, and two correct runs of it part. Same shapes and bytes per
    token as ``random_wire_llama``. ``act_order``: an act-order checkpoint's
    rows, one permutation per activation a layer (q/k/v share theirs, gate/up
    theirs; o_proj and down_proj their own), as GPTQ leaves them."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def packed(k, n, std=0.02, g_idx=None):
        if act_order and g_idx is None:
            g_idx = act_order_g_idx(gen, k, groupsize)
        return params_from_jax(gaussian_wire_linear(gen, k, n, groupsize, bits, std, g_idx),
                               device, dtype)

    def layer():
        attn_in, mlp_in = ((act_order_g_idx(gen, h, groupsize) for _ in range(2)) if act_order
                           else (None, None))
        return {
            "input_layernorm": ones.clone(),
            "post_attention_layernorm": ones.clone(),
            "self_attn": {"q_proj": packed(h, qh, g_idx=attn_in),
                          "k_proj": packed(h, kvh, g_idx=attn_in),
                          "v_proj": packed(h, kvh, g_idx=attn_in),
                          "o_proj": packed(qh, h, out_std)},
            "mlp": {"gate_proj": packed(h, inter, g_idx=mlp_in),
                    "up_proj": packed(h, inter, g_idx=mlp_in),
                    "down_proj": packed(inter, h, out_std)},
        }

    out_std = 0.02 * branch_gain
    ones = torch.ones(h, dtype=dtype, device=device)
    layers = [layer() for _ in range(cfg.num_layers)]
    emb = torch.randn(v, h, generator=gen, device=device)
    head = torch.randn(h, v, generator=gen, device=device) * (2.0 / h ** 0.5)
    return {"embed_tokens": emb.to(dtype), "layers": layers, "norm": ones.clone(),
            "lm_head": {"kernel": head.to(dtype)}}


class _GaussianDraws:
    """The draws of one ``gaussian_wire_<arch>`` model, made on the device
    from ``seed``: INT4 g128 packed linears (``gaussian_wire_linear``, with a
    small Gaussian bias where asked), the residual writers at a tenth of the
    others' 0.02 (``out_std``), LayerNorms and embeddings."""

    GROUPSIZE, BITS = 128, 4
    out_std = 0.02 * 0.1

    def __init__(self, cfg, seed, device, dtype):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.cfg, self.dtype = cfg, dtype

    def randn(self, *shape, std=1.0):
        return (torch.randn(*shape, generator=self.gen, device=self.device) * std).to(self.dtype)

    def packed(self, k, n, std=0.02, bias=True):
        tree = gaussian_wire_linear(self.gen, k, n, self.GROUPSIZE, self.BITS, std)
        if bias:
            tree["bias"] = self.randn(n, std=0.02).float().cpu().numpy()
        return params_from_jax(tree, self.device, self.dtype)

    def ln(self):
        h = self.cfg.hidden_size
        return {"w": torch.ones(h, dtype=self.dtype, device=self.device),
                "b": torch.zeros(h, dtype=self.dtype, device=self.device)}

    def head(self, k, n):
        """A dense output head whose logits spread over a few units."""
        return {"kernel": self.randn(k, n, std=2.0 / k ** 0.5)}


def gaussian_wire_opt(cfg, seed: int = 0, device=None, dtype=torch.bfloat16) -> dict:
    """Packed OPT parameters on ``device`` (``None``: the card), drawn as
    ``gaussian_wire_llama`` draws LLaMA's: every linear its own
    ``gaussian_wire_linear`` with a Gaussian bias, out_proj and fc2 (the
    residual writers) at a tenth of 0.02, unit LayerNorms, unit
    Gaussian token embeddings and position rows at half that scale (so the
    tokens, not the positions, lead the stream). The head is a draw of its
    own in the tied head's place (``lm_head``), where a trained OPT ties it
    to the embedding: tied to a random embedding, a token's own row wins
    every logit by sqrt(width) and the model copies its input token, which
    would hide attention from the token checks."""
    d = _GaussianDraws(cfg, seed, device, dtype)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    proj = cfg.word_embed_proj_dim or h
    layers = [{"self_attn_layer_norm": d.ln(), "final_layer_norm": d.ln(),
               "self_attn": {"q_proj": d.packed(h, h), "k_proj": d.packed(h, h),
                             "v_proj": d.packed(h, h), "out_proj": d.packed(h, h, d.out_std)},
               "fc1": d.packed(h, inter), "fc2": d.packed(inter, h, d.out_std)}
              for _ in range(cfg.num_layers)]
    emb = d.randn(cfg.vocab_size, proj)
    params = {"embed_tokens": emb, "embed_positions": d.randn(cfg.max_seq_len + 2, h, std=0.5),
              "layers": layers, "final_layer_norm": d.ln()}
    if cfg.word_embed_proj_dim:
        params["project_in"] = d.packed(proj, h, bias=False)
        params["project_out"] = d.packed(h, proj, bias=False)
    params["lm_head"] = d.head(proj, cfg.vocab_size)
    return params


def gaussian_wire_neox(cfg, seed: int = 0, device=None, dtype=torch.bfloat16) -> dict:
    """Packed GPT-NeoX parameters on ``device`` (``None``: the card), drawn
    as ``gaussian_wire_opt`` draws OPT's: the fused query_key_value (K = hidden,
    N = 3 hidden), dense and the MLP packed with Gaussian biases, dense and
    dense_4h_to_h at a tenth of 0.02, a unit-variance embed_in and a
    dense embed_out."""
    d = _GaussianDraws(cfg, seed, device, dtype)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    layers = [{"input_layernorm": d.ln(), "post_attention_layernorm": d.ln(),
               "attention": {"query_key_value": d.packed(h, 3 * h),
                             "dense": d.packed(h, h, d.out_std)},
               "mlp": {"dense_h_to_4h": d.packed(h, inter),
                       "dense_4h_to_h": d.packed(inter, h, d.out_std)}}
              for _ in range(cfg.num_layers)]
    return {"embed_in": d.randn(cfg.vocab_size, h), "layers": layers,
            "final_layer_norm": d.ln(), "embed_out": d.head(h, cfg.vocab_size)}


def gaussian_wire_gpt2(cfg, seed: int = 0, device=None, dtype=torch.bfloat16) -> dict:
    """Packed GPT-2 parameters on ``device`` (``None``: the card), drawn as
    ``gaussian_wire_opt`` draws OPT's: c_attn in the [Q | K | V] block layout,
    the two c_proj at a tenth of 0.02, Gaussian biases, Gaussian wte
    and wpe, and the head a draw of its own in the tied head's place (see
    ``gaussian_wire_opt``)."""
    d = _GaussianDraws(cfg, seed, device, dtype)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    layers = [{"ln_1": d.ln(), "ln_2": d.ln(),
               "attn": {"c_attn": d.packed(h, 3 * h), "c_proj": d.packed(h, h, d.out_std)},
               "mlp": {"c_fc": d.packed(h, inter), "c_proj": d.packed(inter, h, d.out_std)}}
              for _ in range(cfg.num_layers)]
    return {"wte": d.randn(cfg.vocab_size, h), "wpe": d.randn(cfg.max_seq_len, h, std=0.5),
            "layers": layers, "ln_f": d.ln(), "lm_head": d.head(h, cfg.vocab_size)}


GAUSSIAN_WIRE = {"llama": gaussian_wire_llama, "opt": gaussian_wire_opt,
                 "neox": gaussian_wire_neox, "gpt2": gaussian_wire_gpt2}


def model_weight_bytes(cfg, groupsize: int = 128, bits: int = 4) -> int:
    """Device bytes a decode token reads: packed codes, bf16 scales and zeros,
    and the dense bf16 lm_head. INT3 is stored as 4-bit nibbles on the device."""
    dev_bits = 4 if bits == 3 else bits
    h, inter = cfg.hidden_size, cfg.intermediate_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = [(h, qh), (h, kvh), (h, kvh), (qh, h), (h, inter), (h, inter), (inter, h)]
    per_layer = sum(k * n * dev_bits // 8 + (k // groupsize) * n * 2 * 2 for k, n in shapes)
    return cfg.num_layers * per_layer + cfg.vocab_size * h * 2
