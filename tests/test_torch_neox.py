"""The port's GPT-NeoX (ROADMAP A11) held against the TPU package's.

Tiny HF checkpoints (tests/hf_tiny.py) and a numpy tree through both
packages on the CPU, fp32, the port through its plain versions: the loader,
the per-head interleaved query_key_value split, partial rotary, parallel and
sequential residual, the runner and every serving mode (bf16 and fp8
caches), and quantize -> save -> reload. Helpers: tests/torch_archs.py.
"""

import numpy as np
import pytest
import torch

import hf_tiny
import torch_archs
from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu_torch.models import common


@pytest.mark.parametrize("kw", [dict(), dict(parallel=False, rotary_pct=0.25)],
                         ids=["parallel", "sequential+rotary-quarter"])
def test_neox_hf_checkpoint_logits_match_jax_and_hf(tmp_path, kw):
    d, model = hf_tiny.tiny_neox_dir(tmp_path / "neox", **kw)
    torch_archs.check_hf_logits("neox", d, model)


@pytest.mark.parametrize("kw", [dict(), dict(parallel_residual=False, rotary_pct=0.25)],
                         ids=["parallel", "sequential+rotary-quarter"])
def test_neox_params_from_jax_forward_and_prefill_match_jax(kw):
    torch_archs.check_tree_logits("neox", **kw)


def test_partial_rotary_and_activations_match_jax():
    """apply_rope at rotary_dim 24 of 96 (NeoX-20B's split) rotates only the
    first 24 dims of each head, as the TPU package does; the activations
    match to 1e-6, "gelu" being the exact erf form and "gelu_new" the tanh
    one (apart by more than that)."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    q, k = (rng.standard_normal((1, 5, 2, 96)).astype(np.float32) for _ in range(2))
    pos = np.arange(5)[None] + 7
    cos, sin = common.rope_cos_sin(torch.as_tensor(pos), 24, 10000.0)
    jcos, jsin = jcommon.rope_cos_sin(jnp.asarray(pos), 24, 10000.0)
    tq, tk = common.apply_rope(torch.as_tensor(q), torch.as_tensor(k), cos, sin, rotary_dim=24)
    jq, jk = jcommon.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin, rotary_dim=24)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_array_equal(tq.numpy()[..., 24:], q[..., 24:])
    x = rng.standard_normal(1000).astype(np.float32) * 3
    for name in ("relu", "gelu", "gelu_new", "gelu_fast", "silu"):
        np.testing.assert_allclose(common.activation(name)(torch.as_tensor(x)).numpy(),
                                   np.asarray(jcommon.activation(name)(jnp.asarray(x))),
                                   atol=1e-6, rtol=1e-6)
    assert np.abs(common.activation("gelu")(torch.as_tensor(x)).numpy()
                  - common.activation("gelu_new")(torch.as_tensor(x)).numpy()).max() > 1e-5
    w, b = rng.standard_normal(96).astype(np.float32), rng.standard_normal(96).astype(np.float32)
    np.testing.assert_allclose(
        common.layer_norm(torch.as_tensor(q), torch.as_tensor(w), torch.as_tensor(b),
                          1e-5).numpy(),
        np.asarray(jcommon.layer_norm(jnp.asarray(q), jnp.asarray(w), jnp.asarray(b), 1e-5)),
        atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_neox_runner_and_engine_tokens_match_jax(kv):
    torch_archs.check_engines("neox", kv)


def test_neox_quantize_save_reload(tmp_path):
    d, _ = hf_tiny.tiny_neox_dir(tmp_path / "neox")
    torch_archs.check_quantize_save_reload("neox", d, str(tmp_path / "packed"))
