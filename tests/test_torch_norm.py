"""Kernel 6's residual form on the CPU, held against the TPU package.

``add_rms_norm_plain`` (the plain version of the kernel's residual form,
``h = x + r`` then RMSNorm of h) against the TPU package's pair ``x = x + o;
rms_norm(x)``: the sum through JAX's add, the norm through
``models/common.rms_norm`` and ``rms_norm_pallas`` in interpret mode. Inputs
come from numpy with a seed; H = 200 is not a multiple of 8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.ops.pallas import norm as jnorm
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.ops.cuda import norm
from gptq_for_llama_tpu_torch.ops.cuda.norm import (add_rms_norm, add_rms_norm_cuda,
                                                    add_rms_norm_plain, rms_norm_plain)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def _inputs(m, h, name, seed):
    tdt, jdt = DTYPES[name]
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((m, h)) * 3).astype(np.float32)
    o = rng.standard_normal((m, h)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    torch_in = [torch.as_tensor(a).to(tdt) for a in (x, o, w)]
    jax_in = [jnp.asarray(a).astype(jdt) for a in (x, o, w)]
    return torch_in, jax_in


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy().astype(np.float64)
    return np.asarray(t.astype(jnp.float32), np.float64)


def _within_one_bf16_ulp(got, want):
    """Every element of ``got`` within one bf16 unit in the last place of the
    matching element of ``want`` (2^(e - 7) for |want| in [2^e, 2^(e+1))):
    for bf16 outputs one step on the bf16 grid, for fp32 the same width."""
    got, want = _np(got), _np(want)
    with np.errstate(divide="ignore"):   # a zero in want leaves no room: ulp 0
        ulp = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
    return bool((np.abs(got - want) <= ulp).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h", [256, 200])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_add_rms_norm_plain_matches_jax_pair(m, h, dtype):
    """h is bit-equal to JAX's x + o in the same dtype; y is bit-equal to
    rms_norm_plain(h) and within 1 bf16 ulp of the TPU package's rms_norm
    and of rms_norm_pallas (interpret mode) applied to JAX's sum: the sum of
    squares is taken in another order, the rest is the same fp32 arithmetic
    rounded once."""
    (x, o, w), (jx, jo, jw) = _inputs(m, h, dtype, seed=10 * m + h)
    hs, y = add_rms_norm_plain(x, o, w, 1e-6)
    jh = jx + jo
    assert hs.dtype == y.dtype == x.dtype
    np.testing.assert_array_equal(_np(hs), _np(jh))
    assert torch.equal(y, rms_norm_plain(hs, w, 1e-6))
    for want in (jcommon.rms_norm(jh, jw, 1e-6), jnorm.rms_norm_pallas(jh, jw, 1e-6,
                                                                       interpret=True)):
        assert _within_one_bf16_ulp(y, want)


def test_add_rms_norm_dispatch_on_the_cpu():
    """On a CPU tensor the dispatch is the plain version, leading dims are
    rows, and the model's helper is this dispatch; the kernel's wrapper never
    takes the plain path."""
    (x, o, w), _ = _inputs(6, 64, "bf16", seed=0)
    x3, o3 = x.reshape(2, 3, 64), o.reshape(2, 3, 64)
    got, want = add_rms_norm(x3, o3, w, 1e-5), add_rms_norm_plain(x, o, w, 1e-5)
    assert got[0].shape == got[1].shape == (2, 3, 64)
    assert all(torch.equal(g.reshape(6, 64), v) for g, v in zip(got, want))
    assert common.add_rms_norm is add_rms_norm
    with pytest.raises(ValueError):
        add_rms_norm_cuda(x, o, w, 1e-5)


def test_launch_counts_by_form_reset():
    """Kernel 6's launches are counted in total and by form, and a reset
    zeroes both."""
    from gptq_for_llama_tpu_torch.ops import cuda as kernels
    norm.rms_norm_cuda.forms["add"] += 3
    norm.rms_norm_cuda.launches += 3
    assert kernels.launch_counts()["rms_norm:add"] >= 3
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    assert counts["rms_norm"] == counts["rms_norm:add"] == counts["rms_norm:alone"] == 0
