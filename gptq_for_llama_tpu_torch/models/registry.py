"""Architecture registry: every architecture of the TPU package is ported.

Counterpart of ``gptq_for_llama_tpu/models/registry.py``: one module a family
with the same surface (``LAYER_LINEARS``, ``sequential_groups``,
``init_params``, ``embed``, ``step_rope``, ``layer``, ``stack``,
``head_input``, ``logits``, ``head``, ``forward``).
"""

from __future__ import annotations

from . import gpt2, llama, neox, opt
from .common import check_max_len

ARCHS = {m.NAME: m for m in (llama, opt, neox, gpt2)}
# the token embedding of each family's tree (its device and dtype are the model's)
EMBED_KEYS = ("embed_tokens", "embed_in", "wte")


def get_arch(name: str):
    if name not in ARCHS:
        raise ValueError(f"Unknown arch {name!r}; supported: {sorted(ARCHS)}")
    return ARCHS[name]


def embed_weight(params):
    """The token embedding of a parameter tree of any family."""
    for key in EMBED_KEYS:
        if key in params:
            return params[key]
    raise KeyError(f"no token embedding among {EMBED_KEYS} in the parameter tree")


def check_positions(arch, params, max_len: int) -> None:
    """Refuse a cache of ``max_len`` positions past the arch's learned
    position table (OPT, GPT-2; the rotary families have none)."""
    if hasattr(arch, "max_positions"):
        check_max_len(arch.NAME, arch.max_positions(params), max_len)
