"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a) and nvcc; without one it skips.
The file imports nothing of JAX, so it also runs where only the port is
installed: ``python -m pytest tests/test_torch_cuda.py --noconftest`` (the
repository's conftest.py configures JAX).
"""

import numpy as np
import pytest
import torch

from gptq_for_llama_tpu_torch.ops import cuda as kernels
from gptq_for_llama_tpu_torch.ops.cuda.attention import decode_attention, decode_attention_plain
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.ops.cuda.flash import (flash_prefill_blocked,
                                                     flash_prefill_blocked_plain)
from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import flash_prefill, flash_prefill_plain
from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp, fused_mlp_plain
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear, quant_matmul_plain
from gptq_for_llama_tpu_torch.ops.quant_matmul import quant_matmul
from gptq_for_llama_tpu_torch.quant import packing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _linear(k, n, bits, gs, seed, device, actorder=False):
    rng = np.random.RandomState(seed)
    g = -(-k // gs)
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if actorder:
        p = rng.permutation(k)
        codes, g_idx = codes[p], g_idx[p]
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    return PackedLinear.from_wire(packing.pack_rows(codes, bits),
                                  packing.pack_cols(zeros - 1, bits),
                                  (rng.rand(g, n) * 0.02 + 0.005).astype(np.float16), g_idx,
                                  bits=bits, dtype=torch.bfloat16, device=device)


def _close(got, want, rel):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def _rows_close(got, want, rel):
    """Every output row (all indices but the last) within ``rel`` of its own
    norm: a causal row i averages i + 1 values, so its size falls like
    1/sqrt(i + 1), and a bound on the largest value would let late rows
    carry errors as large as themselves."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()) <= rel


@pytest.mark.cuda
@pytest.mark.parametrize("bits,m,k,gs,actorder", [
    (4, 1, 4096, 128, False), (4, 37, 1024, 128, True), (2, 3, 512, 128, False),
    (8, 9, 512, 128, False), (3, 2, 512, 128, False), (4, 5, 520, 40, False),
    (4, 100, 1024, 1024, False)])
def test_qmm_matches_plain(card, bits, m, k, gs, actorder):
    """2e-2 * max|y|: the plain version rounds the dequantized weight to bf16
    before its matmul; the kernel keeps it in fp32."""
    lin = _linear(k, 256, bits, gs, seed=m, device=card, actorder=actorder)
    x = torch.randn(m, k, device=card).bfloat16()
    assert _close(quant_matmul(x, lin), quant_matmul_plain(x, lin), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 20])
def test_fused_mlp_matches_plain(card, m):
    gate = _linear(512, 384, 4, 128, seed=1, device=card)
    up = _linear(512, 384, 4, 128, seed=2, device=card)
    x = torch.randn(m, 512, device=card).bfloat16()
    assert _close(fused_mlp(x, gate, up), fused_mlp_plain(x, gate, up), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (12, 4)])
def test_decode_attention_matches_plain(card, h, hkv):
    """1e-2 of each row's norm: both softmax in fp32; the kernel's output is
    bf16."""
    q = torch.randn(2, 1, h, 128, device=card).bfloat16()
    k = torch.randn(2, 300, hkv, 128, device=card).bfloat16()
    v = torch.randn(2, 300, hkv, 128, device=card).bfloat16()
    off = torch.tensor([5, 299], dtype=torch.int32, device=card)
    assert _rows_close(decode_attention(q, k, v, off, 128 ** -0.5),
                       decode_attention_plain(q, k, v, off, 128 ** -0.5), 1e-2)
    for o in (77, 299):   # one chunk; two chunks and the combine kernel
        assert _rows_close(decode_attention(q, k, v, o, 128 ** -0.5),
                           decode_attention_plain(q, k, v, o, 128 ** -0.5), 1e-2)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    """No plain fallback for a CUDA tensor: fp8 caches, fp32 inputs raise."""
    q = torch.randn(1, 1, 8, 128, device=card).bfloat16()
    k8 = torch.randn(1, 64, 8, 128, device=card).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        decode_attention(q, k8, k8, 3, 0.1)
    with pytest.raises(TypeError):
        flash_prefill_blocked(q, k8, k8, 0, 0.1)
    lin = _linear(256, 128, 4, 128, seed=0, device=card)
    with pytest.raises(TypeError):
        quant_matmul(torch.randn(2, 256, device=card), lin, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,off,hkv", [(45, 0, 8), (45, 77, 2), (130, 3, 8)])
def test_flash_prefill_blocked_matches_plain(card, sq, off, hkv):
    q = torch.randn(1, sq, 8, 128, device=card).bfloat16()
    k = torch.randn(1, 256, hkv, 128, device=card).bfloat16()
    v = torch.randn(1, 256, hkv, 128, device=card).bfloat16()
    kernels.reset_launch_counts()
    assert _rows_close(flash_prefill_blocked(q, k, v, off, 128 ** -0.5),
                       flash_prefill_blocked_plain(q, k, v, off, 128 ** -0.5), 1e-2)
    assert kernels.launch_counts()["flash_prefill_blocked"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv", [(1, 1, 8, 8), (2, 63, 8, 2), (1, 64, 4, 4),
                                       (1, 65, 8, 8), (2, 300, 8, 2), (1, 1000, 4, 1),
                                       (1, 2048, 4, 2)])
def test_flash_prefill_matches_plain(card, b, s, h, hkv):
    """1e-2 of each row's norm: both softmax in fp32; the kernel rounds p and
    its output to bf16 (about 2^-9 relative each)."""
    q = torch.randn(b, s, h, 128, device=card).bfloat16()
    k = torch.randn(b, s, hkv, 128, device=card).bfloat16()
    v = torch.randn(b, s, hkv, 128, device=card).bfloat16()
    kernels.reset_launch_counts()
    got = flash_prefill(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_prefill"] == 1
    assert torch.isfinite(got.float()).all()
    assert _rows_close(got, flash_prefill_plain(q, k, v, 128 ** -0.5), 1e-2)


@pytest.mark.cuda
def test_causal_sdpa_goes_through_kernel_5(card):
    """A cache-less causal sdpa on the card launches kernel 5 for any S; a
    cache-less call with another mask raises instead of running plain."""
    q = torch.randn(1, 37, 8, 128, device=card).bfloat16()
    kernels.reset_launch_counts()
    common.sdpa(q, q, q, None, causal=True)
    assert kernels.launch_counts()["flash_prefill"] == 1
    with pytest.raises(NotImplementedError):
        common.sdpa(q, q, q, common.causal_mask(37, 37, device=card))
    with pytest.raises(TypeError):
        flash_prefill(q.float(), q.float(), q.float(), 0.1)
    k8 = q.to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        flash_prefill(q, k8, k8, 0.1)
    q64 = torch.randn(1, 8, 4, 64, device=card).bfloat16()
    with pytest.raises(ValueError):
        flash_prefill(q64, q64, q64, 0.1)
