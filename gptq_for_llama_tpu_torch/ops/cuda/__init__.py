"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel has a wrapper (``*_cuda``, with a plain-int launch count
``.launches`` that it raises by one per kernel launch), a plain PyTorch
version (``*_plain``) and a dispatching function that takes the plain version
only for a CPU tensor: a CUDA tensor launches the kernel or raises. Where a
gradient is wanted the dispatches of kernels 1, 2, 5 and 6 run them inside
autograd Functions, and every wrapper refuses to run outside one
(``grad.py``). Sources live in ``gptq_for_llama_tpu_torch/csrc`` and are
built by ``build.py`` at first use.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import attention, flash, flash_prefill, matmul, matmul_t, mlp, norm


class Kernel(NamedTuple):
    wrapper: Callable   # launches the kernel; counts in ``wrapper.launches``
    source: str         # the CUDA source, relative to the repository root
    replaces: str       # file:line of the TPU kernel it replaces


# every TPU kernel of the repository has its counterpart here: the kernels of
# the decode path (prefill at a cache offset, then classic or fold decode
# steps), of the cache-less causal forward (calibration, perplexity, batched
# admission, LoRA training), of every norm, of paged serving, and the
# grad-input of the packed linears (LoRA backward)
KERNELS = {
    "qmm": Kernel(matmul.qmm_cuda, matmul.SOURCE, matmul.REPLACES),
    "fused_mlp": Kernel(mlp.fused_mlp_cuda, mlp.SOURCE, mlp.REPLACES),
    "decode_attention": Kernel(attention.decode_attention_cuda, attention.SOURCE,
                               attention.REPLACES),
    "flash_prefill_blocked": Kernel(flash.flash_prefill_blocked_cuda, flash.SOURCE,
                                    flash.REPLACES),
    "flash_prefill": Kernel(flash_prefill.flash_prefill_cuda, flash_prefill.SOURCE,
                            flash_prefill.REPLACES),
    "rms_norm": Kernel(norm.rms_norm_cuda, norm.SOURCE, norm.REPLACES),
    "pool_decode_attention": Kernel(attention.pool_decode_attention_cuda,
                                    attention.POOL_SOURCE, attention.POOL_REPLACES),
    "qmm_t": Kernel(matmul_t.qmm_t_cuda, matmul_t.SOURCE, matmul_t.REPLACES),
    "fused_decode_attention": Kernel(attention.fused_decode_attention_cuda,
                                     attention.FOLD_SOURCE, attention.FOLD_REPLACES),
}


# kernels counted by form as well: kernels 1 and 2's GEMV, fragments and
# tiles, kernel 1's and kernel 8's wgmma body, kernel 6 alone or with the residual add folded in, and kernels 3, 4,
# 5, 7 and 9 by the cache dtype they read (bf16, f32, fp8, fp8_e5m2) and by
# head dim (d64, d80, d96, d128, d256)
_BY_FORM = {"qmm": matmul.qmm_cuda, "fused_mlp": mlp.fused_mlp_cuda, "rms_norm": norm.rms_norm_cuda,
            "qmm_t": matmul_t.qmm_t_cuda,
            "decode_attention": attention.decode_attention_cuda,
            "flash_prefill_blocked": flash.flash_prefill_blocked_cuda,
            "flash_prefill": flash_prefill.flash_prefill_cuda,
            "pool_decode_attention": attention.pool_decode_attention_cuda,
            "fused_decode_attention": attention.fused_decode_attention_cuda}


def reset_launch_counts() -> None:
    for kernel in KERNELS.values():
        kernel.wrapper.launches = 0
    for wrapper in _BY_FORM.values():
        wrapper.forms = dict.fromkeys(wrapper.forms, 0)


def launch_counts() -> dict[str, int]:
    """Launches per kernel, then kernels 1's, 2's and 6's by form
    ("qmm:gemv", "fused_mlp:tile", "rms_norm:add", ...) and kernels 3, 4, 5,
    7 and 9's by cache dtype ("decode_attention:fp8", ...) and by head dim
    ("decode_attention:d96", ...)."""
    counts = {name: kernel.wrapper.launches for name, kernel in KERNELS.items()}
    for name, wrapper in _BY_FORM.items():
        counts.update({f"{name}:{form}": n for form, n in wrapper.forms.items()})
    return counts


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys as ``launch_counts``) to the counts: a CUDA graph
    adds the launches it recorded at capture on every replay, and takes back
    those of the capture itself, which launched nothing
    (``runtime/graphs.py``)."""
    for key, n in delta.items():
        name, _, form = key.partition(":")
        if form:
            _BY_FORM[name].forms[form] += n
        else:
            KERNELS[name].wrapper.launches += n
