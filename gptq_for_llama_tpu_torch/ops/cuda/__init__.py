"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the kernel's wrapper (``*_cuda``, with a plain-int launch
count ``.launches`` that it raises by one per kernel launch), the plain
PyTorch version (``*_plain``) and a dispatching function that takes the plain
version only for a CPU tensor: a CUDA tensor launches the kernel or raises.
Sources live in ``gptq_for_llama_tpu_torch/csrc`` and are built by
``build.py`` at first use.
"""

from __future__ import annotations

from . import attention, flash, flash_prefill, matmul, mlp

# name -> (module, wrapper): the kernels of the decode path (prefill at a
# cache offset, then decode steps) and of the cache-less causal forward
# (calibration, perplexity)
KERNELS = {
    "qmm": (matmul, matmul.qmm_cuda),
    "fused_mlp": (mlp, mlp.fused_mlp_cuda),
    "decode_attention": (attention, attention.decode_attention_cuda),
    "flash_prefill_blocked": (flash, flash.flash_prefill_blocked_cuda),
    "flash_prefill": (flash_prefill, flash_prefill.flash_prefill_cuda),
}


def reset_launch_counts() -> None:
    for _, wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, (_, wrapper) in KERNELS.items()}
