"""The port's GPT-2 (ROADMAP A11) held against the TPU package's.

A tiny HF checkpoint (tests/hf_tiny.py; its Conv1D weights load without a
transpose) and a numpy tree through both packages on the CPU, fp32, the port
through its plain versions: the loader, the [Q | K | V] block split of
c_attn, learned positions at offset 0, the tied head, the runner and every
serving mode (bf16 and fp8 caches), and quantize -> save -> reload.
Helpers: tests/torch_archs.py.
"""

import numpy as np
import pytest
import torch

import hf_tiny
import torch_archs
from gptq_for_llama_tpu_torch.engine.evaluate import perplexity
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.models.registry import get_arch
from gptq_for_llama_tpu_torch.runtime import ModelRunner, ServingEngine


def test_gpt2_hf_checkpoint_logits_match_jax_and_hf(tmp_path):
    d, model = hf_tiny.tiny_gpt2_dir(tmp_path / "gpt2")
    torch_archs.check_hf_logits("gpt2", d, model)


def test_gpt2_params_from_jax_forward_and_prefill_match_jax():
    torch_archs.check_tree_logits("gpt2")


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_gpt2_runner_and_engine_tokens_match_jax(kv):
    torch_archs.check_engines("gpt2", kv)


def test_gpt2_quantize_save_reload(tmp_path):
    d, _ = hf_tiny.tiny_gpt2_dir(tmp_path / "gpt2")
    torch_archs.check_quantize_save_reload("gpt2", d, str(tmp_path / "packed"))


def test_learned_positions_clamp_past_the_table():
    """A pad row's position past the table reads the last row (JAX's take
    returns NaN there, a gather on the card would assert; ROADMAP C), real
    rows read their own."""
    table = torch.arange(12.0).reshape(6, 2)
    got = common.learned_positions(table, torch.tensor([[0, 5, 6, 40]]))
    np.testing.assert_array_equal(got.numpy(), table[[0, 5, 5, 5]][None].numpy())


@pytest.mark.parametrize("arch", ["opt", "gpt2"])
def test_lengths_past_the_position_table_raise(arch):
    """A cache or a sequence longer than the learned position table (64 rows
    past OPT's offset, 64 for GPT-2) is refused on the runner, the engine,
    the forward and the perplexity eval: a real token there would read a
    clamped row and decode a wrong but plausible answer. The table's own
    length is taken."""
    cfg, params, _, _ = torch_archs.setup(arch)
    table = cfg.max_seq_len
    mod = get_arch(arch)
    assert mod.max_positions(params) == table
    ModelRunner(arch, cfg, params, max_seq_len=table, dtype=torch.float32, device="cpu")
    ServingEngine(arch, cfg, params, batch_slots=1, max_seq_len=table, dtype=torch.float32,
                  device="cpu")
    with pytest.raises(ValueError, match="position table"):
        ModelRunner(arch, cfg, params, max_seq_len=table + 1, dtype=torch.float32,
                    device="cpu")
    with pytest.raises(ValueError, match="position table"):
        ServingEngine(arch, cfg, params, batch_slots=1, max_seq_len=table + 1,
                      dtype=torch.float32, device="cpu")
    ids = torch.arange(table + 1)[None, :] % cfg.vocab_size
    assert mod.forward(params, cfg, ids[:, :table]).shape == (1, table, cfg.vocab_size)
    with pytest.raises(ValueError, match="position table"):
        mod.forward(params, cfg, ids)
    with pytest.raises(ValueError, match="position table"):
        perplexity(arch, cfg, params, np.arange(3 * table) % cfg.vocab_size,
                   seqlen=table + 1)
