"""HuggingFace checkpoint loading: safetensors / torch .bin -> parameter dict.

Counterpart of ``gptq_for_llama_tpu/models/hf_loader.py``: the LLaMA, OPT,
GPT-NeoX and GPT-2 branches.
Tensors are read from disk into numpy (``engine/safetensors_io``, no
``safetensors`` package) and mapped to the functional layout: linear kernels
(in, out), norms and embeddings as tensors in the compute dtype (fp16 ->
bf16 by default). A linear whose ``<name>.qweight`` is present becomes a
``PackedLinear`` built from the wire buffers. Everything lands on ``device``
(None: the card).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from .. import resolve_device
from .config import ModelConfig, config_from_hf
from ..ops.linear import PackedLinear, dense


def read_flat_state(model_path: str) -> dict:
    """Every tensor of a HF checkpoint dir as {name: numpy array}."""
    from ..engine.safetensors_io import load_file
    flat = {}
    st_files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if st_files:
        for f in st_files:
            flat.update(load_file(f))
        return flat
    bin_files = sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin")))
    if bin_files:
        for f in bin_files:
            sd = torch.load(f, map_location="cpu", weights_only=True)
            for k, v in sd.items():
                flat[k] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        return flat
    raise FileNotFoundError(f"No safetensors or pytorch_model*.bin in {model_path}")


class _Mapper:
    """Pulls tensors from the flat dict, building dense or packed linears."""

    def __init__(self, flat: dict, dtype, device, default_bits: int = 4):
        self.flat = flat
        self.dtype = dtype
        self.device = device
        self.default_bits = default_bits
        self.meta_bits = {}  # per-linear bits from checkpoint metadata

    def tensor(self, key, dtype=None):
        return torch.from_numpy(np.asarray(self.flat[key])).to(
            device=self.device, dtype=dtype or self.dtype)

    def has(self, key):
        return key in self.flat

    def linear(self, prefix):
        """Dense (weight (out, in) -> kernel (in, out)) or packed GPTQ linear."""
        if f"{prefix}.qweight" in self.flat:
            bias = self.flat.get(f"{prefix}.bias")
            # per-tensor bits from shapes (qweight rows = K * bits / 32): mixed
            # --observe checkpoints; metadata overrides
            kdim = self.flat[f"{prefix}.g_idx"].shape[0]
            shape_bits = int(self.flat[f"{prefix}.qweight"].shape[0] * 32 // kdim)
            bits = self.meta_bits.get(prefix, shape_bits or self.default_bits)
            return PackedLinear.from_wire(
                self.flat[f"{prefix}.qweight"], self.flat[f"{prefix}.qzeros"],
                self.flat[f"{prefix}.scales"], self.flat[f"{prefix}.g_idx"], bits=bits,
                bias=None if bias is None else np.asarray(bias, np.float32),
                dtype=self.dtype, device=self.device)
        w = self.tensor(f"{prefix}.weight").T.contiguous()
        b = self.tensor(f"{prefix}.bias") if f"{prefix}.bias" in self.flat else None
        return dense(w, b)

    def norm(self, prefix):
        """A norm's weight, or {w, b} where it has a bias (LayerNorm)."""
        w = self.tensor(f"{prefix}.weight")
        if f"{prefix}.bias" in self.flat:
            return {"w": w, "b": self.tensor(f"{prefix}.bias")}
        return w

    def conv1d(self, prefix):
        """A transformers Conv1D (GPT-2): its weight is stored (in, out), this
        layout's kernel already, so no transpose; a packed one is a packed
        linear like any other (``gptq_for_llama_tpu/models/hf_loader.py:
        101-112``)."""
        if f"{prefix}.qweight" in self.flat:
            return self.linear(prefix)
        w = self.tensor(f"{prefix}.weight").contiguous()
        b = self.tensor(f"{prefix}.bias") if f"{prefix}.bias" in self.flat else None
        return dense(w, b)


def _infer_bits_from_shapes(flat: dict) -> int | None:
    for k in flat:
        if k.endswith(".qweight"):
            gk = k[:-len("qweight")] + "g_idx"
            if gk in flat:
                return int(flat[k].shape[0] * 32 // flat[gk].shape[0])
    return None


def load_params(model_path: str, cfg: ModelConfig | None = None, dtype=torch.bfloat16,
                wbits: int | None = None, seqlen: int | None = None, device=None):
    """Load a HF (or packed-GPTQ) checkpoint directory into (cfg, params) on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    if cfg is None:
        cfg = config_from_hf(model_path, seqlen=seqlen)
    loaders = {"llama": _load_llama, "opt": _load_opt, "neox": _load_neox,
               "gpt2": _load_gpt2}
    if cfg.arch not in loaders:
        raise ValueError(f"no loader for arch {cfg.arch!r}")
    flat = read_flat_state(model_path)
    m = _Mapper(flat, dtype, device, default_bits=wbits or _infer_bits_from_shapes(flat) or 4)
    meta_path = os.path.join(model_path, "quantize_config.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            qc = json.load(f)
        if wbits is None:  # an explicit wbits argument wins over metadata
            m.default_bits = int(qc.get("bits", m.default_bits))
        # per_layer keys are model-relative dotted paths; the flat keys carry
        # the HF prefix: map by dot-anchored suffix on each linear's g_idx key
        for name, over in qc.get("per_layer", {}).items():
            for k in flat:
                if k == f"{name}.g_idx" or k.endswith(f".{name}.g_idx"):
                    m.meta_bits[k[:-len(".g_idx")]] = int(over["bits"])
    return cfg, loaders[cfg.arch](m, cfg)


def _load_llama(m: _Mapper, cfg: ModelConfig):
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        layers.append({
            "input_layernorm": m.tensor(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": m.tensor(f"{p}.post_attention_layernorm.weight"),
            "self_attn": {n: m.linear(f"{p}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {n: m.linear(f"{p}.mlp.{n}")
                    for n in ("gate_proj", "up_proj", "down_proj")},
        })
    embed = m.tensor("model.embed_tokens.weight")
    lm_head = (m.linear("lm_head") if m.has("lm_head.weight") or m.has("lm_head.qweight")
               else dense(embed.T))
    return {"embed_tokens": embed, "layers": layers,
            "norm": m.tensor("model.norm.weight"), "lm_head": lm_head}


def _head(m: _Mapper, name: str, embed):
    """The output head: its own (dense or packed) linear where the checkpoint
    has one, else tied to the token embedding."""
    if m.has(f"{name}.weight") or m.has(f"{name}.qweight"):
        return m.linear(name)
    return dense(embed.T)


def _load_opt(m: _Mapper, cfg: ModelConfig):
    d = "model.decoder"
    layers = []
    for i in range(cfg.num_layers):
        p = f"{d}.layers.{i}"
        layers.append({
            "self_attn_layer_norm": m.norm(f"{p}.self_attn_layer_norm"),
            "final_layer_norm": m.norm(f"{p}.final_layer_norm"),
            "self_attn": {n: m.linear(f"{p}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "fc1": m.linear(f"{p}.fc1"),
            "fc2": m.linear(f"{p}.fc2"),
        })
    embed = m.tensor(f"{d}.embed_tokens.weight")
    params = {"embed_tokens": embed,
              "embed_positions": m.tensor(f"{d}.embed_positions.weight"),
              "layers": layers}
    if m.has(f"{d}.final_layer_norm.weight"):
        params["final_layer_norm"] = m.norm(f"{d}.final_layer_norm")
    for name in ("project_in", "project_out"):
        if m.has(f"{d}.{name}.weight") or m.has(f"{d}.{name}.qweight"):
            params[name] = m.linear(f"{d}.{name}")
    params["lm_head"] = _head(m, "lm_head", embed)
    return params


def _load_neox(m: _Mapper, cfg: ModelConfig):
    g = "gpt_neox"
    layers = []
    for i in range(cfg.num_layers):
        p = f"{g}.layers.{i}"
        layers.append({
            "input_layernorm": m.norm(f"{p}.input_layernorm"),
            "post_attention_layernorm": m.norm(f"{p}.post_attention_layernorm"),
            "attention": {"query_key_value": m.linear(f"{p}.attention.query_key_value"),
                          "dense": m.linear(f"{p}.attention.dense")},
            "mlp": {"dense_h_to_4h": m.linear(f"{p}.mlp.dense_h_to_4h"),
                    "dense_4h_to_h": m.linear(f"{p}.mlp.dense_4h_to_h")},
        })
    embed = m.tensor(f"{g}.embed_in.weight")
    return {"embed_in": embed, "layers": layers,
            "final_layer_norm": m.norm(f"{g}.final_layer_norm"),
            "embed_out": _head(m, "embed_out", embed)}


def _load_gpt2(m: _Mapper, cfg: ModelConfig):
    t = "transformer"
    layers = []
    for i in range(cfg.num_layers):
        p = f"{t}.h.{i}"
        layers.append({
            "ln_1": m.norm(f"{p}.ln_1"),
            "ln_2": m.norm(f"{p}.ln_2"),
            "attn": {"c_attn": m.conv1d(f"{p}.attn.c_attn"),
                     "c_proj": m.conv1d(f"{p}.attn.c_proj")},
            "mlp": {"c_fc": m.conv1d(f"{p}.mlp.c_fc"),
                    "c_proj": m.conv1d(f"{p}.mlp.c_proj")},
        })
    wte = m.tensor(f"{t}.wte.weight")
    return {"wte": wte, "wpe": m.tensor(f"{t}.wpe.weight"), "layers": layers,
            "ln_f": m.norm(f"{t}.ln_f"), "lm_head": _head(m, "lm_head", wte)}
