"""KV-cache storage dtypes: the names, the encoder every cache write goes
through and the decoder every plain read goes through.

Counterpart of the TPU package's ``kv_dtype`` (``cli/main.py:97-113``,
``runtime/runner.py:158,175``): a cache is stored in bf16, f32, fp8-e4m3
(``torch.float8_e4m3fn``) or fp8-e5m2 (``torch.float8_e5m2``); compute stays
in the model's dtype.

``encode`` is the byte-for-byte counterpart of JAX's ``astype`` into the cache
dtype: round to nearest even from the f32 value (a bf16 value is exact in
f32). Where torch's own conversion saturates an e4m3 overflow to 448, JAX
writes the NaN code: |x| > 464 (the tie at 464 rounds to 448), inf and NaN
give 0x7F with the input's sign. e5m2 overflows to +-inf. A NaN input is
written as a NaN code (JAX's sign and payload rules are not kept). It is
plain torch (torch's conversion within range, the rest repaired), so one
code path runs on the CPU and on the card and a CUDA graph can hold it; fp8
bytes are written through a ``torch.uint8`` view of the cache (``stored``),
since torch has no CPU scatter, gather or masked fill for float8. The CUDA
kernels encode by integer bit math (``csrc/kv_dtype.cuh``), held byte-equal
to it.

``decode`` mirrors the TPU kernels' loads bit for bit:
``gptq_for_llama_tpu/ops/pallas/attention.py:_load_f32`` (kernels 3, 7 and 9)
and ``ops/pallas/flash.py:_load_bf16`` (kernel 4). An e4m3 code upcasts by
integer bit math (bf16 bits (em << 4) + (120 << 7) for a normal, man * 2^-9
for a subnormal), which equals ``astype`` on every code but 0x7F and 0xFF:
those read as +-480, not NaN. e5m2 and f32 read as ``astype`` does (an f32
cache read into bf16 rounds to nearest even). The CUDA kernels decode the
same way (``csrc/kv_dtype.cuh``).
"""

from __future__ import annotations

import torch

# the CLIs' --kv-dtype names (gptq_for_llama_tpu/cli/main.py:108-113)
KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "fp8": torch.float8_e4m3fn,
             "fp8_e5m2": torch.float8_e5m2}
KV_NAMES = {dtype: name for name, dtype in KV_DTYPES.items()}
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# the cache dtype codes of the CUDA entry points (csrc/kv_dtype.cuh:Code)
KV_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}


def kv_dtype(name):
    """The storage dtype of a --kv-dtype name (None: the compute dtype)."""
    return None if name is None else KV_DTYPES[name]


def check_kv_dtype(dtype: torch.dtype) -> torch.dtype:
    """Refuse a storage dtype that no cache path takes."""
    if dtype not in KV_DTYPES.values():
        raise TypeError(f"a KV cache is stored in one of {tuple(KV_DTYPES.values())}, "
                        f"got {dtype}")
    return dtype


def stored(cache: torch.Tensor) -> torch.Tensor:
    """The view every write of ``cache`` goes through: its bytes for fp8, the
    cache itself otherwise. ``encode`` gives values of the view's dtype."""
    return cache.view(torch.uint8) if cache.dtype in FP8 else cache


def encode(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (bf16 or f32) as a cache of ``dtype`` stores it: for fp8 the
    bytes (uint8, JAX's ``astype``), else ``x.to(dtype)``. Every decode step
    writes through it, so it is a few elementwise launches: torch's own
    conversion rounds to nearest even as JAX's does within range, and only
    e4m3's overflow is repaired. e4m3: clamped to +-448 first (JAX rounds
    (448, 464] down to 448, where torch's conversion may write NaN), then
    |x| > 464 and inf take the NaN code with their sign (0x7E | 1 = 0x7F).
    e5m2 overflows to +-inf in both. A NaN input is written as a NaN code,
    its sign and payload torch's."""
    if dtype not in FP8:
        return x.to(dtype)
    code = (x.clamp(-448.0, 448.0) if dtype == torch.float8_e4m3fn else x).to(dtype)
    code = code.view(torch.uint8)
    return code | (x.abs() > 464.0) if dtype == torch.float8_e4m3fn else code


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` by ``encode``: a tensor of that dtype."""
    y = encode(x, dtype)
    return y.view(dtype) if dtype in FP8 else y


def decode(t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A cache (block) read as the TPU kernels read it, in ``dtype`` (f32:
    ``_load_f32``; bf16: ``_load_bf16``)."""
    if t.dtype != torch.float8_e4m3fn:
        return t.to(dtype)
    u = t.view(torch.uint8).to(torch.int32)
    em = u & 0x7F
    normal = ((em << 4) + (120 << 7)).to(torch.int16).view(torch.bfloat16).float()
    sub = (em & 0x7).float() * 2.0 ** -9
    val = torch.where((em >> 3) == 0, sub, normal)
    return torch.where((u & 0x80) != 0, -val, val).to(dtype)


def cache_bytes(caches) -> int:
    """Bytes held by an iterable of cache tensors."""
    return sum(t.numel() * t.element_size() for t in caches)
