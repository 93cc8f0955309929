"""Packed-checkpoint I/O: pack, save, and quant-table export.

Counterpart of ``gptq_for_llama_tpu/engine/checkpoint.py``, LLaMA layout:

- ``pack_model``: fake-quantized dense kernels + QuantRecords -> PackedLinear
  leaves (the reference's make_quant_linear + QuantLinear.pack). The codes
  are re-derived from the kernel as the model holds it (bf16 in the CLI), on
  the kernel's device.
- ``save_packed``: params -> flat HF-named safetensors (``safetensors_io``)
  + config.json + quantize_config.json. The wire format is byte-compatible
  with the reference's QuantLinear state dicts and with the TPU package.
- ``export_quant_table``: toml + npy export (reference: utils/export.py).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..models.registry import get_arch
from ..ops.linear import PackedLinear
from ..quant import packing
from .quantize import QuantRecord, QuantizeSpec, get_path, layer_linears, set_path
from .safetensors_io import save_file


def _pack_linear(lin: dict, rec: QuantRecord, dtype) -> PackedLinear:
    wire = packing.pack_quantized(lin["kernel"].T, rec.scale, rec.zero, rec.g_idx, rec.wbits)
    bias = lin.get("bias")
    return PackedLinear.from_wire(
        wire["qweight"], wire["qzeros"], wire["scales"], wire["g_idx"], bits=rec.wbits,
        bias=None if bias is None else bias.float().cpu().numpy(), dtype=dtype,
        device=lin["kernel"].device)


def pack_model(arch_name: str, cfg, params, quantizers: dict[str, QuantRecord],
               dtype=torch.bfloat16):
    """Replace every quantized dense linear by its PackedLinear, on the device
    its kernel lives on. The kernel must be the fake-quantized one, so the
    integer codes round-trip exactly."""
    arch = get_arch(arch_name)
    for li, lp in enumerate(params["layers"]):
        for name in layer_linears(arch, lp):
            rec = quantizers.get(f"layers.{li}.{name}")
            lin = get_path(lp, name)
            if rec is not None and not isinstance(lin, PackedLinear):
                set_path(lp, name, _pack_linear(lin, rec, dtype))
    rec, lin = quantizers.get("lm_head"), params.get("lm_head")
    if rec is not None and isinstance(lin, dict):   # optional quantized output head
        params["lm_head"] = _pack_linear(lin, rec, dtype)
    return params


def _flat_linear(flat: dict, key: str, lin):
    if isinstance(lin, PackedLinear):
        for k, v in lin.to_wire().items():
            flat[f"{key}.{k}"] = v
        return
    flat[f"{key}.weight"] = lin["kernel"].T   # HF Linear stores (out, in)
    if lin.get("bias") is not None:
        flat[f"{key}.bias"] = lin["bias"]


def flatten_to_hf(arch_name: str, cfg, params) -> dict:
    """Params -> flat {HF key: CPU tensor or numpy array} state dict (the
    reference's state_dict). Wire buffers stay numpy, float tensors keep
    their dtype (bf16 included)."""
    if arch_name != "llama":
        raise NotImplementedError(f"arch {arch_name!r} is not yet ported "
                                  "to gptq_for_llama_tpu_torch (ROADMAP A11)")
    flat = {"model.embed_tokens.weight": params["embed_tokens"],
            "model.norm.weight": params["norm"]}
    if not cfg.tie_word_embeddings:   # a tied head is rebuilt from the embedding at load
        _flat_linear(flat, "lm_head", params["lm_head"])
    arch = get_arch(arch_name)
    for li, lp in enumerate(params["layers"]):
        p = f"model.layers.{li}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            flat[f"{p}.{norm}.weight"] = lp[norm]
        for name in arch.LAYER_LINEARS:
            _flat_linear(flat, f"{p}.{name}", get_path(lp, name))
    return {k: v.detach().cpu().contiguous() if isinstance(v, torch.Tensor) else v
            for k, v in flat.items()}


def save_packed(path: str, arch_name: str, cfg, params,
                quantizers: Optional[dict[str, QuantRecord]] = None,
                spec: Optional[QuantizeSpec] = None):
    """Save a packed checkpoint directory: model.safetensors, config.json (so
    the directory reloads without the original model dir) and
    quantize_config.json (bits/groupsize/sym/..., per-layer overrides)."""
    os.makedirs(path, exist_ok=True)
    save_file(flatten_to_hf(arch_name, cfg, params), os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config_dict(arch_name, cfg), f, indent=2)

    meta: dict = {"quant_method": "gptq"}
    if spec is not None:
        meta.update(bits=spec.wbits, group_size=spec.groupsize, sym=spec.sym,
                    true_sequential=spec.true_sequential, desc_act=spec.act_order,
                    damp_percent=spec.percdamp)
    if quantizers:
        # the header says what the buffers are when uniform (--nearest records
        # whole-row groups as -1 whatever the spec); mixed tensors get
        # per_layer overrides
        gss = {r.groupsize for r in quantizers.values()}
        bss = {r.wbits for r in quantizers.values()}
        if len(gss) == 1:
            meta["group_size"] = next(iter(gss))
        if len(bss) == 1:
            meta["bits"] = next(iter(bss))
        per_layer = {k: {"bits": r.wbits, "group_size": r.groupsize}
                     for k, r in quantizers.items()
                     if r.wbits != meta.get("bits") or r.groupsize != meta.get("group_size")}
        if per_layer:
            meta["per_layer"] = per_layer
    with open(os.path.join(path, "quantize_config.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _hf_config_dict(arch_name: str, cfg) -> dict:
    """Minimal HF-style config.json so a saved dir reloads via config_from_hf."""
    if arch_name != "llama":
        raise NotImplementedError(f"arch {arch_name!r} is not yet ported "
                                  "to gptq_for_llama_tpu_torch (ROADMAP A11)")
    return {"model_type": "llama", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "hidden_act": cfg.act, "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_word_embeddings}


def export_quant_table(quantizers: dict[str, QuantRecord], quant_dir: str, fmt: str = "toml"):
    """Per-linear quant params as a toml manifest + one .npy per tensor."""
    if fmt != "toml":
        raise ValueError(f"Unsupported export format {fmt!r}")
    os.makedirs(quant_dir, exist_ok=True)
    lines = []
    for name, rec in quantizers.items():
        os.makedirs(os.path.join(quant_dir, name), exist_ok=True)
        scale_p = os.path.join(name, "scale.npy")
        np.save(os.path.join(quant_dir, scale_p), rec.scale.astype(np.float16))
        lines.append(f"[{name}]")
        lines.append(f'scale = "{scale_p}"')
        if not rec.sym:  # asym: the zero-point is part of the grid
            zero_p = os.path.join(name, "zero.npy")
            np.save(os.path.join(quant_dir, zero_p), rec.zero.astype(np.float16))
            lines.append(f'zero = "{zero_p}"')
        gid_p = os.path.join(name, "g_idx.npy")
        np.save(os.path.join(quant_dir, gid_p), rec.g_idx.astype(np.int32))
        lines.append(f'group_ids = "{gid_p}"')
        lines.append(f"sym = {str(rec.sym).lower()}")
        lines.append(f"wbits = {rec.wbits}")
        if rec.groupsize != -1:
            lines.append(f"groupsize = {rec.groupsize}")
        lines.append("")
    with open(os.path.join(quant_dir, "quant.toml"), "w") as f:
        f.write("\n".join(lines))
