"""The port's OPT (ROADMAP A11) held against the TPU package's.

Tiny HF checkpoints (tests/hf_tiny.py) and a numpy tree through both
packages on the CPU, fp32, the port through its plain versions: the loader
(pre- and post-LayerNorm, project_in/out), the forward, learned positions at
offset 2 in the runner and every serving mode (bf16 and fp8 caches), and
quantize -> save -> reload. Helpers: tests/torch_archs.py.
"""

import pytest

import hf_tiny
import torch_archs


@pytest.mark.parametrize("kw", [dict(), dict(do_layer_norm_before=False, word_embed_proj_dim=16)],
                         ids=["pre-ln", "post-ln+project-in-out"])
def test_opt_hf_checkpoint_logits_match_jax_and_hf(tmp_path, kw):
    d, model = hf_tiny.tiny_opt_dir(tmp_path / "opt", **kw)
    torch_archs.check_hf_logits("opt", d, model)


@pytest.mark.parametrize("kw", [dict(), dict(do_layer_norm_before=False, word_embed_proj_dim=16)],
                         ids=["pre-ln", "post-ln+project-in-out"])
def test_opt_params_from_jax_forward_and_prefill_match_jax(kw):
    torch_archs.check_tree_logits("opt", **kw)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_opt_runner_and_engine_tokens_match_jax(kv):
    torch_archs.check_engines("opt", kv)


def test_opt_quantize_save_reload(tmp_path):
    d, _ = hf_tiny.tiny_opt_dir(tmp_path / "opt")
    torch_archs.check_quantize_save_reload("opt", d, str(tmp_path / "packed"))
