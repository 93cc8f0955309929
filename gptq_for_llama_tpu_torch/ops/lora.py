"""Low-rank adapters (LoRA) over frozen quantized linears.

Counterpart of ``gptq_for_llama_tpu/ops/lora.py``. An adapter wraps any
linear (``PackedLinear`` or a dense dict):

    y = base(x) + (x @ a) @ b * (alpha / r)

Gradients reach (a, b) through plain autograd and earlier layers through
``quant_matmul``'s autograd Function (the grad-input kernel on the card).
The packed buffers are never differentiated: ``split_lora`` / ``join_lora``
separate the adapter tensors (the only trainable ones) from the frozen
skeleton of the parameter tree (dicts and lists, as ``models/llama.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class LoraLinear:
    """A frozen linear plus a rank-r trainable delta.

    base: PackedLinear or dense {'kernel', ...} dict (frozen).
    a: (K, r); b: (r, N). b starts at zero, so the initial delta is exactly
    zero. alpha: scaling numerator."""

    base: Any
    a: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    alpha: float = 16.0


def lora_apply(lin: LoraLinear, x: torch.Tensor, dtype) -> torch.Tensor:
    """base(x) + the scaled low-rank delta, computed in the base dtype."""
    from .linear import linear_apply   # late import: linear imports this module
    y = linear_apply(lin.base, x, dtype)
    r = lin.a.shape[-1]
    delta = (x.to(dtype) @ lin.a.to(dtype)) @ lin.b.to(dtype)
    return y + delta * (lin.alpha / r)


def map_leaves(fn, tree):
    """``fn`` on every leaf of a parameter tree of dicts and lists (a
    PackedLinear or a LoraLinear is a leaf); the dicts and lists are new, the
    leaves are ``fn``'s."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def split_lora(params):
    """-> (adapters, skeleton): adapters is a list of {'a', 'b'} dicts (the
    only trainable tensors, in tree order); skeleton is params with those
    slots emptied. ``join_lora(skeleton, adapters)`` restores the tree."""
    adapters = []

    def strip(n):
        if isinstance(n, LoraLinear):
            adapters.append({"a": n.a, "b": n.b})
            return dataclasses.replace(n, a=None, b=None)
        return n

    return adapters, map_leaves(strip, params)


def join_lora(skeleton, adapters):
    it = iter(adapters)

    def put(n):
        if isinstance(n, LoraLinear):
            ab = next(it)
            return dataclasses.replace(n, a=ab["a"], b=ab["b"])
        return n

    return map_leaves(put, skeleton)
