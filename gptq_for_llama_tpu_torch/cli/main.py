"""Command-line entry point: quantize / pack / save / eval / benchmark / generate.

Counterpart of ``gptq_for_llama_tpu/cli/main.py``, with the same flag surface
and one addition, ``--device``: the CLI runs on the card unless it is given
``--device cpu`` (the plain PyTorch versions), and without a card and without
that flag it raises. Flags of slices not ported yet raise NotImplementedError
naming their ROADMAP item. ``--pre-layer N`` runs eval, the benchmark and
generation through ``runtime/offload.OffloadRunner``: the first N layers on
the card, the rest streamed from pinned host memory.

Usage:
  python -m gptq_for_llama_tpu_torch MODEL_DIR DATASET --wbits 4 --groupsize 128 \\
      --true-sequential --act-order --save out_dir [--eval]
  python -m gptq_for_llama_tpu_torch MODEL_DIR DATASET --load out_dir --eval \\
      --benchmark 2048 --check
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gptq_for_llama_tpu_torch")
    p.add_argument("model", type=str, help="HF checkpoint directory (fp16/fp32 or packed)")
    p.add_argument("dataset", type=str, nargs="?", default="wikitext2",
                   choices=["wikitext2", "ptb", "c4", "ptb-new", "c4-new", "synthetic"],
                   help="calibration/eval dataset")
    # quantization
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--nearest", action="store_true", help="RTN baseline")
    p.add_argument("--wbits", type=int, default=16, choices=[2, 3, 4, 8, 16])
    p.add_argument("--trits", action="store_true")
    p.add_argument("--groupsize", type=int, default=-1)
    p.add_argument("--sym", action="store_true")
    p.add_argument("--act-order", action="store_true")
    p.add_argument("--true-sequential", action="store_true")
    p.add_argument("--observe", action="store_true")
    p.add_argument("--quantize-lm-head", action="store_true",
                   help="GPTQ the output head too (beyond the reference)")
    p.add_argument("--mse", action="store_true")
    p.add_argument("--chunk", type=int, default=16,
                   help="calibration samples per forward microbatch")
    # eval / io
    p.add_argument("--eval", action="store_true")
    p.add_argument("--new-eval", action="store_true")
    p.add_argument("--save", "--save_safetensors", dest="save", type=str, default="",
                   help="directory to save the packed checkpoint (safetensors)")
    p.add_argument("--load", type=str, default="", help="packed checkpoint directory to load")
    p.add_argument("--quant-directory", type=str, default=None,
                   help="export toml+npy quant table here")
    p.add_argument("--resume-dir", type=str, default=None,
                   help="mid-quantization checkpoint dir (resume on re-run)")
    p.add_argument("--seqlen", type=int, default=None)
    # runtime
    p.add_argument("--benchmark", type=int, default=0, help="decode-benchmark over N tokens")
    p.add_argument("--check", action="store_true", help="PPL check during benchmark")
    p.add_argument("--test-generation", action="store_true")
    p.add_argument("--text", type=str, default="the quick brown fox")
    p.add_argument("--max-new-tokens", type=int, default=50)
    p.add_argument("--min-new-tokens", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--tp", type=int, default=None, help="tensor-parallel degree")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel devices for the quantize phase")
    p.add_argument("--distributed", action="store_true", help="multi-host initialization")
    p.add_argument("--fuse-attn", action="store_true", dest="fuse_attn",
                   help="fuse q/k/v into one packed projection at load")
    p.add_argument("--pre-layer", type=int, default=None, dest="pre_layer",
                   help="keep only the first N layers device-resident (CPU offload)")
    p.add_argument("--kv-dtype", type=str, default=None, dest="kv_dtype",
                   choices=["bf16", "f32", "fp8", "fp8_e5m2"],
                   help="KV-cache STORAGE dtype (fp8 = float8_e4m3fn: half the cache memory "
                        "and decode-attention traffic; compute stays bf16)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of the eval/benchmark here")
    p.add_argument("--report", type=str, default=None,
                   help="also write the returned report (ppl, benchmark, phase seconds, "
                        "kernel launches by phase) to this JSON file")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the plain PyTorch versions on the CPU; default: the card")
    return p


# flag -> (is it set, ROADMAP item of the slice that ports it)
_UNPORTED = {
    "--tp": (lambda a: bool(a.tp and a.tp > 1), "A18"),
    "--dp": (lambda a: bool(a.dp and a.dp > 1), "A18"),
    "--distributed": (lambda a: a.distributed, "A18"),
}


def main(argv=None) -> dict:
    """Run the CLI; returns what it printed as a dict: "ppl" {dataset: ppl},
    "benchmark" (the decode benchmark's result), "quantize_split" (seconds in
    calibration forwards, Hessians and the solver), "phases" (seconds per
    phase), "launches" ({phase: {kernel: launches}}, which CUDA kernels each
    phase went through) and, on the card, "peak_memory" ({phase: bytes})."""
    parser = build_parser()
    args = parser.parse_args(argv)
    # the TPU package's refusals (gptq_for_llama_tpu/cli/main.py:120-125)
    tp_on = bool(args.tp and args.tp > 1)
    if args.fuse_attn and tp_on:
        parser.error("--fuse-attn is incompatible with --tp: shard_map TP "
                     "shards q/k/v separately (TP_RULES)")
    if args.pre_layer is not None and (tp_on or args.fuse_attn):
        parser.error("--pre-layer (offloaded generation) supports neither "
                     "--tp nor --fuse-attn")
    for flag, (is_set, item) in _UNPORTED.items():
        if is_set(args):
            raise NotImplementedError(f"{flag} is not yet ported to gptq_for_llama_tpu_torch "
                                      f"(ROADMAP {item})")
    from .. import resolve_device
    from ..data import get_loaders
    from ..engine import (QuantizeSpec, export_quant_table, pack_model, perplexity,
                          quantize_model, save_packed)
    from ..models import hf_loader
    from ..ops import cuda as kernels
    from ..ops.kv_dtype import kv_dtype
    from ..utils.profiling import PhaseTimer, device_trace

    device = resolve_device(args.device)
    timer = PhaseTimer()
    trace = ((lambda: device_trace(args.profile_dir)) if args.profile_dir
             else contextlib.nullcontext)

    report = {"ppl": {}, "benchmark": None, "quantize_split": {}, "launches": {},
              "peak_memory": {}}
    cuda = device.type == "cuda"

    @contextlib.contextmanager
    def phase(name):
        before = kernels.launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        with timer.phase(name):
            yield
        after = kernels.launch_counts()
        report["launches"][name] = {k: after[k] - before[k] for k in after}
        if cuda:
            report["peak_memory"][name] = torch.cuda.max_memory_allocated(device)

    t0 = time.time()
    model_dir = args.load or args.model
    quantizing = not args.load and (args.wbits < 16 or args.nearest)
    # --pre-layer is for a model that does not fit the card: a checkpoint that
    # is only run is loaded on the CPU, and the offload runner moves the
    # resident part to the card (a quantization runs on the card first)
    offloaded = args.pre_layer is not None and (args.eval or args.benchmark
                                                 or args.test_generation)
    with phase("load"):
        cfg, params = hf_loader.load_params(
            model_dir, seqlen=args.seqlen, dtype=torch.bfloat16,
            device="cpu" if offloaded and not quantizing else device)
    seqlen = args.seqlen or cfg.max_seq_len
    print(f"loaded {cfg.arch} from {model_dir} on {device} ({time.time() - t0:.1f}s)")

    def loaders(ds, **kw):
        return get_loaders(ds, seed=args.seed, seqlen=seqlen,
                           model=args.model if ds != "synthetic" else cfg, **kw)

    quantizers = {}
    spec = QuantizeSpec(
        wbits=args.wbits, groupsize=args.groupsize, sym=args.sym, trits=args.trits,
        mse=args.mse, percdamp=args.percdamp, act_order=args.act_order,
        true_sequential=args.true_sequential, nearest=args.nearest, observe=args.observe,
        chunk=args.chunk, quantize_lm_head=args.quantize_lm_head)

    if quantizing:
        train, _ = loaders(args.dataset, nsamples=args.nsamples)
        tq = time.time()
        with phase("quantize"):
            params, quantizers, _ = quantize_model(cfg.arch, cfg, params, train, spec,
                                                   resume_dir=args.resume_dir,
                                                   timings=report["quantize_split"])
        print(f"quantized in {time.time() - tq:.1f}s")

    if args.quant_directory:
        if quantizers:
            export_quant_table(quantizers, args.quant_directory)
            print(f"quant table exported to {args.quant_directory}")
        else:
            print("WARNING: --quant-directory ignored — no quantization ran this invocation "
                  "(quant params are not recoverable from a packed checkpoint alone)")

    if args.save:
        if quantizers:
            with phase("pack+save"):
                params = pack_model(cfg.arch, cfg, params, quantizers)
                save_packed(args.save, cfg.arch, cfg, params, quantizers, spec)
            print(f"packed checkpoint saved to {args.save}")
        elif args.load:
            # re-export a loaded packed checkpoint: to_wire is byte-exact; the
            # original quantize_config describes the buffers
            with phase("pack+save"):
                save_packed(args.save, cfg.arch, cfg, params, None, None)
                src_qc = os.path.join(args.load, "quantize_config.json")
                if os.path.exists(src_qc):
                    shutil.copy(src_qc, os.path.join(args.save, "quantize_config.json"))
            print(f"packed checkpoint re-exported to {args.save}")
        else:
            print("WARNING: --save ignored — nothing was quantized "
                  "(use --wbits < 16, --nearest, or --load)")

    bench_ids = None
    if args.benchmark:
        # the reference benchmarks the first seeded calibration window, so the
        # --check ppl is comparable run to run
        train, _ = loaders(args.dataset, nsamples=1)
        stream = np.asarray(train).reshape(-1)
        bench_ids = stream[:min(args.benchmark, len(stream))][None]

    # --pre-layer with --eval / --benchmark: one OffloadRunner serves both, with
    # the resident benchmark's cache length (the same decode plans)
    offload = None
    if args.pre_layer is not None and (args.eval or args.benchmark):
        from ..runtime.offload import OffloadRunner
        with phase("offload"):
            offload = OffloadRunner(
                cfg.arch, cfg, params, args.pre_layer, device=device,
                max_seq_len=seqlen if bench_ids is None else max(bench_ids.shape[1], 32),
                kv_dtype=kv_dtype(args.kv_dtype))
        print(f"offload: layers {args.pre_layer}/{cfg.num_layers} on {device}, the rest "
              f"streamed, {offload.streamed_bytes / 2**20:.1f} MiB a forward")

    if args.eval:
        datasets = ["wikitext2", "ptb", "c4"] if args.dataset != "synthetic" else ["synthetic"]
        if args.new_eval and args.dataset != "synthetic":
            datasets = ["wikitext2", "ptb-new", "c4-new"]
        for ds in datasets:
            _, test = loaders(ds)
            with phase(f"eval:{ds}"), trace():
                if offload is not None:
                    ppl = offload.perplexity(test, seqlen=seqlen)
                else:
                    ppl = perplexity(cfg.arch, cfg, params, test, seqlen=seqlen, verbose=True)
            print(f"{ds} perplexity: {ppl:.4f}")
            report["ppl"][ds] = ppl

    if args.benchmark:
        from ..runtime import ModelRunner, benchmark_decode
        with phase("benchmark"), trace():
            runner = offload or ModelRunner(
                cfg.arch, cfg, params, batch_size=1, max_seq_len=max(bench_ids.shape[1], 32),
                device=device, kv_dtype=kv_dtype(args.kv_dtype), fuse_qkv=args.fuse_attn)
            res = benchmark_decode(runner, bench_ids, check=args.check)
        print(json.dumps(res))
        report["benchmark"] = res

    if args.test_generation:
        from transformers import AutoTokenizer
        from ..runtime import ModelRunner, generate
        from ..runtime.offload import OffloadRunner
        tokenizer = AutoTokenizer.from_pretrained(args.model)
        ids = np.asarray(tokenizer(args.text)["input_ids"], np.int64)
        max_len = len(ids) + args.max_new_tokens
        if args.pre_layer is not None:
            runner = OffloadRunner(cfg.arch, cfg, params, args.pre_layer, max_seq_len=max_len,
                                   device=device, kv_dtype=kv_dtype(args.kv_dtype))
        else:
            runner = ModelRunner(cfg.arch, cfg, params, batch_size=1, max_seq_len=max_len,
                                 device=device, kv_dtype=kv_dtype(args.kv_dtype),
                                 fuse_qkv=args.fuse_attn)
        out = generate(runner, ids, args.max_new_tokens, temperature=args.temperature,
                       top_p=args.top_p, min_new_tokens=args.min_new_tokens,
                       eos_token_id=tokenizer.eos_token_id,
                       stream=lambda t: print(tokenizer.decode(t), end="", flush=True))
        print()
        print(tokenizer.decode(out[0]))

    if timer.totals:
        print(timer.summary())
        if args.profile_dir:
            print(f"device trace written to {args.profile_dir}")
    report["phases"] = dict(timer.totals)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f)
    return report


if __name__ == "__main__":
    main()
