"""The port's CLI on the CPU: quantize -> pack -> save -> quant table, then
reload -> perplexity -> decode benchmark, in-process on a tests/hf_tiny.py
model with ``--device cpu``. What the CLI reports equals the API calls on
the same checkpoint; without ``--device`` and without a card it raises, and
flags of slices not ported yet raise. ``--pre-layer`` (offloaded eval and
benchmark) gives the resident run's numbers."""

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
                                   ["--distributed", "--pre-layer", "1"],
                                   ["--dp", "2", "--kv-dtype", "fp8"]])
def test_cli_unported_flags_raise(model_dir, flags, monkeypatch):
    """The flags of A18 are ported, also beside others: --tp 2 runs two
    ranks and returns rank 0's report; --dp 2 without a quantization runs
    in this process (only calibration splits over dp); --distributed joins
    the group the environment names, and without one raises (no silent
    single-process run)."""
    for var in ("GPTQ_TPU_COORDINATOR", "GPTQ_TPU_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT",
                "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    argv = [model_dir, "synthetic", "--device", "cpu", *flags]
    if "--distributed" in flags:
        with pytest.raises(ValueError, match="environment variable"):
            main(argv)
        return
    rep = main(argv)
    assert set(rep["phases"]) == {"load"} and rep["ppl"] == {}


@pytest.fixture(scope="module")
def packed_4_layers(tmp_path_factory):
    """A 4-layer tiny LLaMA, RTN-quantized to 4 bits and saved."""
    d = tmp_path_factory.mktemp("offload")
    model, _ = hf_tiny.tiny_llama_dir(d / "model", layers=4)
    main([model, "synthetic", "--nearest", "--wbits", "4", "--groupsize", "16", "--seqlen", "32",
          "--save", str(d / "packed"), "--device", "cpu"])
    return model, str(d / "packed")


@pytest.mark.parametrize("kv", [None, "fp8"])
def test_cli_pre_layer_matches_the_resident_run(packed_4_layers, kv):
    """--pre-layer 2 (two of four layers streamed) --eval --benchmark 8
    --check: the perplexity and the benchmark's check ppl equal the resident
    run's, over a bf16 and an fp8 cache; the offloaded run loads the
    checkpoint on the CPU and reports its streaming phase."""
    model, packed = packed_4_layers
    flags = [model, "synthetic", "--load", packed, "--eval", "--seqlen", "256", "--benchmark",
             "8", "--check", "--device", "cpu"] + ([] if kv is None else ["--kv-dtype", kv])
    resident, offload = main(flags), main(flags + ["--pre-layer", "2"])
    assert np.isfinite(resident["ppl"]["synthetic"])
    assert offload["ppl"] == resident["ppl"]
    assert offload["benchmark"]["ppl"] == resident["benchmark"]["ppl"]
    assert offload["benchmark"]["kv_dtype"] == resident["benchmark"]["kv_dtype"]
    assert "offload" in offload["phases"] and "offload" not in resident["phases"]


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


@pytest.fixture(scope="module")
def dp_checkpoints(model_dir, tmp_path_factory):
    """The tiny LLaMA quantized (GPTQ 4-bit g16, act-order) and saved with
    calibration on one rank and split over two (--dp 2: two gloo ranks)."""
    d, outs = tmp_path_factory.mktemp("dp"), {}
    for dp in ("1", "2"):
        outs[dp] = str(d / f"dp{dp}")
        rep = main([model_dir, "synthetic", "--wbits", "4", "--groupsize", "16", "--nsamples",
                    "8", "--chunk", "4", "--act-order", "--true-sequential", "--seqlen", "32",
                    "--save", outs[dp], "--device", "cpu", "--dp", dp])
        assert set(rep["quantize_split"]) == {"forward", "hessian", "solver"}
    return outs


def test_cli_dp_calibration_matches_one_rank(dp_checkpoints):
    """--dp 2 --device cpu: calibration split over two ranks, the Gram sums
    all-reduced; rank 0 saves a checkpoint whose g_idx equals a one-rank
    run's and whose dequantized weights match it on at least 99.9 % of
    entries (the solver rule of tests/test_torch_quant.py)."""
    _, a = hf_loader.load_params(dp_checkpoints["1"], seqlen=32, device="cpu",
                                 dtype=torch.float32)
    _, b = hf_loader.load_params(dp_checkpoints["2"], seqlen=32, device="cpu",
                                 dtype=torch.float32)
    for la, lb in zip(a["layers"], b["layers"]):
        for part in ("self_attn", "mlp"):
            for name, lin in la[part].items():
                other = lb[part][name]
                np.testing.assert_array_equal(lin.g_idx, other.g_idx)
                same = np.isclose(lin.dequantize(torch.float32).numpy(),
                                  other.dequantize(torch.float32).numpy(), rtol=1e-3, atol=0)
                assert same.mean() >= 0.999, (part, name, same.mean())


def test_cli_tp_benchmark_matches_the_unsharded_run(model_dir, dp_checkpoints):
    """--tp 2 --device cpu on the act-order g16 checkpoint: two gloo ranks;
    the decode benchmark runs the tensor-parallel runner (its check ppl
    within bf16 rounding of the unsharded run's: the row-parallel sums round
    per shard), the eval the whole model on rank 0 (equal), and rank 0's
    report comes back."""
    flags = [model_dir, "synthetic", "--load", dp_checkpoints["1"], "--eval", "--seqlen", "64",
             "--benchmark", "16", "--check", "--device", "cpu"]
    one, two = main(flags), main(flags + ["--tp", "2"])
    assert two["ppl"] == one["ppl"] and np.isfinite(one["ppl"]["synthetic"])
    assert two["benchmark"]["tokens"] == 16
    np.testing.assert_allclose(two["benchmark"]["ppl"], one["benchmark"]["ppl"], rtol=2e-2)


def test_cli_tp_keeps_the_tpu_packages_refusals(model_dir):
    """--tp with --pre-layer is a parser error (gptq_for_llama_tpu/cli/
    main.py:123-125); --tp above the machine's cards raises before any rank
    starts (a card a rank, as the TPU package's make_mesh needs a device a
    shard)."""
    with pytest.raises(SystemExit):
        main([model_dir, "synthetic", "--device", "cpu", "--tp", "2", "--pre-layer", "1"])
    cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="need a card each"):
        main([model_dir, "synthetic", "--tp", str(max(2, cards + 1))])


@pytest.mark.cuda
def test_cli_tp_on_the_card(model_dir, dp_checkpoints):
    """On the card a rank takes a card of its own (NCCL): with fewer cards
    than --tp the CLI raises before any rank starts; with enough, --tp 2's
    benchmark check ppl is the unsharded run's within bf16 rounding. The
    kernels at the shards' shapes: tests/test_torch_cuda.py
    ``test_kernels_at_tp_shard_shapes_match_their_plain_versions``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    flags = [model_dir, "synthetic", "--load", dp_checkpoints["1"], "--seqlen", "64",
             "--benchmark", "16", "--check"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need a card each"):
            main(flags + ["--tp", "2"])
        return
    one, two = main(flags), main(flags + ["--tp", "2"])
    np.testing.assert_allclose(two["benchmark"]["ppl"], one["benchmark"]["ppl"], rtol=2e-2)
