"""Gradients through the port's kernel dispatches held against the TPU package.

The grad-input of a packed linear (kernel 8's plain version) against JAX's
``quant_matmul_t_pallas`` in interpret mode, and ``torch.autograd.grad``
through ``quant_matmul``, ``fused_gate_up``, ``rms_norm``, ``add_rms_norm`` and the cache-less
causal attention (their autograd Functions, whose forward is the plain
version on the CPU) against ``jax.grad`` of the same loss on the TPU
package's XLA path, fp32. Inputs come from numpy with a seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.ops import quant_matmul as jqm
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.ops.pallas import matmul as pmm
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import quant_matmul_t
from gptq_for_llama_tpu_torch.ops.cuda.norm import add_rms_norm, rms_norm
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.ops.quant_matmul import fused_gate_up, quant_matmul


def _wire(k, n, bits, gs, seed, actorder=False):
    """Reference wire buffers of a random packed linear (tests/test_autograd.py)."""
    rng = np.random.RandomState(seed)
    g = k // gs
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    scales = (rng.rand(g, n) * 0.02 + 0.005).astype(np.float32)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if actorder:
        g_idx = g_idx[rng.permutation(k)]
    return (jpack.pack_rows(codes, bits), jpack.pack_cols(zeros - 1, bits), scales, g_idx, bits)


def _both(wire, bias=None):
    """The same wire buffers as a JAX and a port PackedLinear, fp32."""
    jlin = JaxPackedLinear.from_wire(*wire[:4], bits=wire[4], bias=bias, dtype=jnp.float32)
    lin = PackedLinear.from_wire(*wire[:4], bits=wire[4], bias=bias, dtype=torch.float32,
                                 device="cpu")
    return jlin, lin


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_grad_input_plain_matches_jax_kernel(bits, m):
    """Kernel 8's plain version (through the dispatch) against the TPU
    kernel in interpret mode. 3e-2 of the largest value: the TPU kernel
    rounds g and the dequantized weight to bf16 (and z * s before that)."""
    jlin, lin = _both(_wire(128, 256, bits, 32, seed=bits))
    assert pmm.supports(jlin)
    g = np.random.RandomState(10 + bits).standard_normal((m, 256)).astype(np.float32)
    want = np.asarray(pmm.quant_matmul_t_pallas(jnp.asarray(g), jlin, interpret=True))
    got = quant_matmul_t(torch.as_tensor(g), lin).numpy()
    assert got.shape == (m, 128)
    assert _rel(got, want) <= 3e-2


def test_grad_input_actorder_unpadded_k():
    """act-order: the inverse permutation after the product. K = 2176 (68
    groups of 32), which the TPU package pads to 2304 and the port does not."""
    jlin, lin = _both(_wire(2176, 128, 4, 32, seed=5, actorder=True))
    assert jlin.k_padded == 2304 and lin.perm is not None and lin.in_features == 2176
    g = np.random.RandomState(11).standard_normal((2, 2, 128)).astype(np.float32) * 0.1
    want = np.asarray(pmm.quant_matmul_t_pallas(jnp.asarray(g), jlin, interpret=True))
    got = quant_matmul_t(torch.as_tensor(g), lin).numpy()
    assert got.shape == (2, 2, 2176)
    assert _rel(got, want) <= 3e-2


def _torch_grads(fn, *arrays):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*xs)
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in xs]


def _jax_grads(fn, *arrays):
    loss, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("actorder,bias", [(False, False), (True, False), (False, True)])
def test_quant_matmul_grad_matches_jax(actorder, bias):
    """d/dx of sum(quant_matmul(x)^2) through ``_QuantMatmul`` (the plain
    forward, then the grad-input path and the inverse perm) against jax.grad
    of the XLA path: 1e-4 of the largest value, fp32. With a bias, the bias
    takes the forward and the gradient is held against the dense product."""
    rng = np.random.RandomState(1)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32) if bias else None
    jlin, lin = _both(_wire(64, 128, 4, 32, seed=2, actorder=actorder), bias=b)
    x = rng.standard_normal((4, 3, 64)).astype(np.float32)
    loss, (gx,) = _torch_grads(lambda t: (quant_matmul(t, lin, dtype=torch.float32) ** 2).sum(), x)
    jloss, (jgx,) = _jax_grads(lambda t: jnp.sum(jqm.quant_matmul(t, jlin, jnp.float32) ** 2), x)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert _rel(gx, jgx) <= 1e-4
    if bias:
        # the bias, trained: its gradient is the sum of the cotangent
        bt = torch.tensor(b, requires_grad=True)
        lin.bias = bt
        xt = torch.tensor(x)
        (quant_matmul(xt, lin, dtype=torch.float32) ** 2).sum().backward()
        y = xt @ lin.dequantize(torch.float32)[torch.argsort(lin.perm)] if lin.perm is not None \
            else xt @ lin.dequantize(torch.float32)
        np.testing.assert_allclose(bt.grad.numpy(), (2 * (y + bt.detach())).sum((0, 1)).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_fused_gate_up_grad_matches_jax():
    """d/dx through ``_FusedGateUp`` (the fused forward; the backward
    recomputes the unfused form, each branch through the grad-input path)
    against jax.grad of the TPU package's fused_gate_up on its XLA path:
    1e-4 of the largest value, fp32."""
    jgate, gate = _both(_wire(64, 96, 4, 32, seed=11))
    jup, up = _both(_wire(64, 96, 4, 32, seed=12))
    x = np.random.RandomState(13).standard_normal((2, 5, 64)).astype(np.float32)
    loss, (gx,) = _torch_grads(lambda t: (fused_gate_up(gate, up, t, "silu") ** 2).sum(), x)
    jloss, (jgx,) = _jax_grads(lambda t: jnp.sum(jqm.fused_gate_up(jgate, jup, t, "silu") ** 2),
                               x)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert _rel(gx, jgx) <= 1e-4


def test_rms_norm_grad_matches_jax():
    """d/dx and d/dweight through ``_RmsNorm`` against jax.grad of the TPU
    package's rms_norm: 1e-4 of the largest value, fp32."""
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((3, 7, 48)) * 2).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    c = rng.standard_normal((3, 7, 48)).astype(np.float32)
    loss, grads = _torch_grads(lambda t, ww: (rms_norm(t, ww, 1e-6) * torch.tensor(c)).sum(), x, w)
    jloss, jgrads = _jax_grads(lambda t, ww: jnp.sum(jcommon.rms_norm(t, ww, 1e-6) * c), x, w)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    for g, jg in zip(grads, jgrads):
        assert _rel(g, jg) <= 1e-4


@pytest.mark.parametrize("outputs", ["sum and norm", "norm"])
def test_add_rms_norm_grad_matches_jax(outputs):
    """d/dx, d/dr and d/dweight through ``_AddRmsNorm`` (h = x + r and the
    norm of h in one call; its backward recomputes the plain version's
    gradient from the saved h) against jax.grad of the TPU package's pair
    ``h = x + o; rms_norm(h)``, with the loss reading both outputs or the
    norm alone: 1e-4 of the largest value, fp32, as the norm's own test."""
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((3, 7, 48)) * 2).astype(np.float32)
    r = rng.standard_normal((3, 7, 48)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    c = rng.standard_normal((3, 7, 48)).astype(np.float32)
    d = rng.standard_normal((3, 7, 48)).astype(np.float32) * (outputs != "norm")

    def port(a, b, ww):
        hs, y = add_rms_norm(a, b, ww, 1e-6)
        return (y * torch.tensor(c)).sum() + (hs * torch.tensor(d)).sum()

    def ref(a, b, ww):
        hs = a + b
        return jnp.sum(jcommon.rms_norm(hs, ww, 1e-6) * c) + jnp.sum(hs * d)

    loss, grads = _torch_grads(port, x, r, w)
    jloss, jgrads = _jax_grads(ref, x, r, w)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    for g, jg in zip(grads, jgrads):
        assert _rel(g, jg) <= 1e-4
    # the weight alone wants a gradient: the sum's output carries none
    tw = torch.tensor(w, requires_grad=True)
    port(torch.tensor(x), torch.tensor(r), tw).backward()
    assert _rel(tw.grad.numpy(), jgrads[2]) <= 1e-4


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_causal_attention_grad_matches_jax(h, hkv):
    """d/dq, d/dk, d/dv through the cache-less causal attention_block
    (``_CausalAttention``) against jax.grad of the TPU package's
    attention_block without a cache: 1e-4 of the largest value, fp32."""
    rng = np.random.RandomState(4)
    s, d = 12, 32
    q = rng.standard_normal((2, s, h, d)).astype(np.float32)
    k = rng.standard_normal((2, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, d)).astype(np.float32)
    c = rng.standard_normal((2, s, h, d)).astype(np.float32)
    mask = jcommon.causal_mask(s, s)

    def port(a, b, e):
        out, _ = common.attention_block(None, a, b, e, None)
        return (out * torch.tensor(c)).sum()

    def ref(a, b, e):
        out, _ = jcommon.attention_block(None, a, b, e, mask)
        return jnp.sum(out * c)

    loss, grads = _torch_grads(port, q, k, v)
    jloss, jgrads = _jax_grads(ref, q, k, v)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    for g, jg in zip(grads, jgrads):
        assert _rel(g, jg) <= 1e-4


def test_functions_are_taken_only_where_a_gradient_is_wanted():
    """The autograd Functions wrap the calls only when grad mode is on and an
    input requires grad; otherwise the dispatch is called directly (no graph
    under inference_mode, nothing to drop)."""
    _, lin = _both(_wire(64, 128, 4, 32, seed=6))
    x = torch.randn(2, 64)
    assert quant_matmul(x, lin, dtype=torch.float32).grad_fn is None
    w = torch.ones(64)
    assert rms_norm(x, w, 1e-6).grad_fn is None
    xr = x.clone().requires_grad_()
    assert type(quant_matmul(xr, lin, dtype=torch.float32).grad_fn).__name__ == "_QuantMatmulBackward"
    assert type(rms_norm(xr, w, 1e-6).grad_fn).__name__ == "_RmsNormBackward"
    with torch.inference_mode():
        assert quant_matmul(xr, lin, dtype=torch.float32).grad_fn is None
    q = torch.randn(1, 5, 2, 32, requires_grad=True)
    out, _ = common.attention_block(None, q, q, q, None)
    assert type(out.grad_fn).__name__ == "_CausalAttentionBackward"
