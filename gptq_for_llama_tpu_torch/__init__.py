"""PyTorch/CUDA port of gptq_for_llama_tpu for NVIDIA Hopper (H100).

Mirrors the TPU package's module names. Plain tensor code is PyTorch; each
Pallas kernel of the TPU package has a hand-written CUDA C++ counterpart for
sm_90a (``csrc/``), built with nvcc at first use (``ops/cuda/build.py``). The package
imports torch and numpy, never jax and nothing of ``gptq_for_llama_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return device
