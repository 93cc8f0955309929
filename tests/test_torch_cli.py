"""The port's CLI on the CPU: quantize -> pack -> save -> quant table, then
reload -> perplexity -> decode benchmark, in-process on a tests/hf_tiny.py
model with ``--device cpu``. What the CLI reports equals the API calls on
the same checkpoint; without ``--device`` and without a card it raises, and
flags of slices not ported yet raise."""

import json
import os

import numpy as np
import pytest
import torch

from gptq_for_llama_tpu_torch.cli.main import main
from gptq_for_llama_tpu_torch.data import get_loaders
from gptq_for_llama_tpu_torch.engine import perplexity
from gptq_for_llama_tpu_torch.models import hf_loader
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.runtime import ModelRunner, benchmark_decode

import hf_tiny


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d, _ = hf_tiny.tiny_llama_dir(tmp_path_factory.mktemp("cli") / "model")
    return d


def test_cli_quantize_save_reload_eval_benchmark(model_dir, tmp_path):
    packed, qdir = str(tmp_path / "packed"), str(tmp_path / "qt")
    rep = main([model_dir, "synthetic", "--wbits", "4", "--groupsize", "16", "--nsamples", "8",
                "--chunk", "4", "--act-order", "--true-sequential", "--seqlen", "32",
                "--save", packed, "--quant-directory", qdir, "--device", "cpu"])
    assert set(rep["quantize_split"]) == {"forward", "hessian", "solver"}
    assert os.path.exists(os.path.join(packed, "model.safetensors"))
    assert os.path.exists(os.path.join(qdir, "quant.toml"))

    # --seqlen 256: the synthetic test stream is 50,000 tokens, so 195 windows
    rep = main([model_dir, "synthetic", "--load", packed, "--eval", "--seqlen", "256",
                "--benchmark", "48", "--check", "--device", "cpu"])
    cfg, params = hf_loader.load_params(packed, seqlen=256, device="cpu")
    assert isinstance(params["layers"][1]["mlp"]["down_proj"], PackedLinear)
    _, test = get_loaders("synthetic", seed=0, seqlen=256, model=cfg)
    ppl = perplexity("llama", cfg, params, test, seqlen=256)
    assert np.isfinite(ppl) and rep["ppl"]["synthetic"] == ppl

    train, _ = get_loaders("synthetic", nsamples=1, seed=0, seqlen=256, model=cfg)
    runner = ModelRunner("llama", cfg, params, max_seq_len=48, device="cpu")
    bench = benchmark_decode(runner, train.reshape(-1)[:48][None], check=True)
    assert rep["benchmark"]["tokens"] == 48 and rep["benchmark"]["device"] == "cpu"
    assert rep["benchmark"]["ppl"] == bench["ppl"]


def test_cli_needs_the_card_unless_told_cpu(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([model_dir, "synthetic", "--eval", "--seqlen", "32"])


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"], ["--distributed"],
                                   ["--pre-layer", "1"],
                                   ["--pre-layer", "1", "--kv-dtype", "fp8"]])
def test_cli_unported_flags_raise(model_dir, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main([model_dir, "synthetic", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--fuse-attn", "--tp", "2"],
                                   ["--fuse-attn", "--pre-layer", "1"]])
def test_cli_fuse_attn_keeps_the_tpu_packages_refusals(model_dir, flags):
    """--fuse-attn is ported (A4); with --tp or --pre-layer it is a parser
    error, as in gptq_for_llama_tpu/cli/main.py:120-125."""
    with pytest.raises(SystemExit):
        main([model_dir, "synthetic", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--eval", "--seqlen", "65"],
                                   ["--benchmark", "80", "--seqlen", "80"]])
def test_cli_refuses_lengths_past_the_position_table(tmp_path, flags):
    """A GPT-2 of 64 learned positions: an eval window or a benchmark cache
    longer than its table raises (a real token past it would read a clamped
    row)."""
    d, _ = hf_tiny.tiny_gpt2_dir(tmp_path / "gpt2")
    with pytest.raises(ValueError, match="position table"):
        main([d, "synthetic", "--device", "cpu", *flags])


def test_cli_writes_its_report(model_dir, tmp_path):
    """--report writes the dict the CLI returns as JSON (how a caller in
    another process reads the launches and the ppl)."""
    path = str(tmp_path / "report.json")
    rep = main([model_dir, "synthetic", "--benchmark", "16", "--check", "--device", "cpu",
                "--report", path])
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert rep["benchmark"]["tokens"] == 16 and "benchmark" in rep["launches"]
