"""Attach trainable LoRA adapters to a (quantized) model's linears.

Counterpart of ``gptq_for_llama_tpu/engine/lora.py``: freeze the packed
weights, train rank-r deltas. The recipe, on the card (or on the CPU with
parameters made with ``device="cpu"``):

    gen = torch.Generator().manual_seed(0)
    params = attach_lora("llama", params, rank=8, generator=gen)
    adapters, skeleton = split_lora(params)            # trainables | frozen
    leaves = [t.requires_grad_() for ab in adapters for t in (ab["a"], ab["b"])]
    opt = torch.optim.Adam(leaves, lr=1e-3)

    logits = arch.forward(join_lora(skeleton, adapters), cfg, ids)
    loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1).float(),
                                             labels.flatten())
    loss.backward()                                    # a/b get gradients
    opt.step()

Grad-input through each frozen packed linear runs the grad-input kernel
(``ops/cuda/matmul_t.py``) on the card.
"""

from __future__ import annotations

import torch

from ..models.registry import get_arch
from ..ops.linear import PackedLinear
from ..ops.lora import LoraLinear, join_lora, split_lora  # re-export
from ..ops.lora import map_leaves
from .quantize import get_path, set_path

__all__ = ["attach_lora", "split_lora", "join_lora", "LoraLinear"]


def _lin_dims(lin):
    if isinstance(lin, PackedLinear):
        return lin.in_features, lin.out_features, lin.scales.dtype, lin.scales.device
    kernel = lin["kernel"]
    return kernel.shape[0], kernel.shape[1], kernel.dtype, kernel.device


def attach_lora(arch_name: str, params: dict, rank: int, generator: torch.Generator,
                alpha: float = 16.0, targets=None) -> dict:
    """Wrap target per-layer linears in LoraLinear: a ~ N(0, 0.01) in the
    linear's dtype, drawn from ``generator`` (on its own device) and moved to
    the linear's device; b = 0, so the initial delta is exactly zero and the
    forward output is unchanged.

    targets: iterable of layer-relative dotted paths (default: every linear
    of the architecture's LAYER_LINEARS). Returns a tree whose edited dicts
    are copies; the caller's params are untouched (tensors shared)."""
    arch = get_arch(arch_name)
    targets = tuple(targets) if targets is not None else arch.LAYER_LINEARS
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = map_leaves(lambda leaf: leaf, lp)   # new dicts, shared tensors
        for name in targets:
            try:
                lin = get_path(lp, name)
            except (KeyError, TypeError):
                continue
            if isinstance(lin, LoraLinear):
                continue
            k, n, dtype, device = _lin_dims(lin)
            a = torch.randn((k, rank), generator=generator, dtype=torch.float32,
                            device=generator.device) * 0.01
            set_path(lp, name, LoraLinear(lin, a.to(device=device, dtype=dtype),
                                          torch.zeros((rank, n), dtype=dtype, device=device),
                                          alpha))
        out["layers"].append(lp)
    return out
