#!/usr/bin/env python3
"""End-to-end readings of the PyTorch/CUDA port on one GPU, for comparing two
trees in one call (run it once per tree, in turns: parent, change, change,
parent).

    python3 scripts/torch_e2e_ab.py [--root TREE] [--label NAME] [--json PATH]
                                    [--legs 7b,decode,serve,eval,lora,neox,d256,kvdtype]

``--root`` names the checkout whose package is driven (default: this
script's own); the script uses only what every tree since tensor
parallelism has. Kernels 1, 2 and 8 run on their heuristic plans
(GPTQ_TORCH_AUTOTUNE=0) except the tuned LoRA step. Readings, each with the
card's name and power limit:

- LLaMA-7B (INT4 g128 ``gaussian_wire_llama``, seed 0, 32 layers, cache
  2048): the prefill of 37, 100 and 201 tokens through its CUDA graph, host
  ms of a synchronized call and device ms (CUDA events), median of 5;
- batch-1 decode (``decode``): the LLaMA-7B decode graph's device ms at
  offsets 164 and 2047 (a graph replay after the offset is set, CUDA
  events, best of three means of 8), the host ms a token of 64 greedy
  tokens through ``decode_greedy_scan``'s graphs after a 100-token prompt
  (median of 3, after a run that captures), and GPT-NeoX-20B's decode graph
  at offset 164 the same way (``chip_smoke.ARCH_CONFIGS``, INT4 g128
  ``gaussian_wire_neox``);
- dense serving with chunked prefill (chunk 128, span 8) on 8 slots, the
  smoke's 12 requests (prompts 37-600, 48 new tokens): tok/s and ttft p50 of
  the second run (every graph captured by the first);
- the perplexity eval forward, 8 windows x 2048 tokens through the 32 layers
  (M = 16384 at every linear): tok/s, median of 3;
- a LoRA step (rank 8 on all 224 linears, batch 2 x 512, Adam): median ms of
  steps 2-9 (after five steps that warm the allocator and autograd up), in
  turns: the heuristic plans, plans raced by ``ops/cuda/autotune.py`` into
  a fresh cache (kernel 1 forward and kernel 8 backward at M = 1024; the
  race's seconds beside) twice, the heuristic again;
- GPT-NeoX-20B (44 layers, 64 heads of 96, INT4 g128 ``gaussian_wire_neox``):
  the prefill of 37 and 100 tokens as above;
- LLaMA at head dim 256 (``d256``: LLaMA-7B's widths, 16 query heads of 256
  over 2 kv heads, 2 layers, INT4 g128 ``gaussian_wire_llama``, seed 256, the
  smoke's ``LLAMA_256``): the prefill of 37, 100 and 201 tokens as above and
  the perplexity eval's forward (``window_nll``) at 8 x 2048, tok/s, median
  of 3;
- LLaMA-7B over fp8-e4m3 KV caches (``kvdtype``): the runner's 201-token
  prefill graph as above, dense serving as above (chunk 128, span 8) and the
  same with ``cache_impl="fold"`` (kernel 9, unfused chunks), tok/s and ttft
  p50 of the second run each, and kernel 4's launches by body over fp8 in the
  leg (``flash_prefill_blocked:sync:fp8`` / ``:wgmma:fp8``, where the tree
  counts them).

``--legs`` runs a subset of the readings, in the order above but for
``kvdtype``, which runs right after ``serve``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

LEGS = ("7b", "decode", "serve", "eval", "lora", "neox", "d256", "kvdtype")
# LLaMA-7B's widths at head dim 256 (chip_smoke.py's LLAMA_256, repeated here
# because an earlier tree's smoke may not have it)
LLAMA_256 = dict(arch="llama", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_layers=2, num_heads=16, num_kv_heads=2, head_dim=256, max_seq_len=2048)


def log(msg):
    print(msg, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--json", default=None)
    ap.add_argument("--legs", default=",".join(LEGS))
    args = ap.parse_args()
    legs = set(args.legs.split(","))
    if not legs <= set(LEGS):
        ap.error(f"--legs takes names among {','.join(LEGS)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["GPTQ_TORCH_AUTOTUNE"] = "0"
    import torch
    if not torch.cuda.is_available():
        print("torch_e2e_ab: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from gptq_for_llama_tpu_torch.engine import attach_lora, join_lora, split_lora
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.ops.cuda import autotune, build
    from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine
    from gptq_for_llama_tpu_torch.runtime.random_model import GAUSSIAN_WIRE, gaussian_wire_llama
    sys.path.insert(0, root)
    from chip_smoke import ARCH_CONFIGS, LLAMA_7B, replay_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    tag = f"[e2e {args.label or root}]"
    report = {"root": root, "card": card}
    t0 = time.perf_counter()
    keys = ["qmm", "fused_mlp", "rms_norm", "qmm_t"] + [
        f"{n}:d{d}" for n in ("flash_prefill", "flash_prefill_blocked", "decode_attention")
        for d in (128, 96, 256)]
    build.start(keys)
    build.wait(keys)
    log(f"{tag} build {time.perf_counter() - t0:.1f} s")

    def prefill_ms(runner, lens, rng):
        out = {}
        for n in lens:
            ids = torch.as_tensor(rng.randint(1, runner.cfg.vocab_size, size=(1, n)), device="cuda")
            host, dev = [], []
            for _ in range(6):
                cache = runner.init_cache()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                t = time.perf_counter()
                start.record()
                runner.prefill(ids, cache)
                end.record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
                dev.append(start.elapsed_time(end))
            out[n] = {"host_ms": statistics.median(host[1:]),
                      "device_ms": statistics.median(dev[1:])}
        return out

    def decode_ms(runner, offsets, scan=True):
        """The decode graph's device ms at each offset; with ``scan``, the
        host ms a token of decode_greedy_scan's graphs too."""
        out = {}
        if scan:
            ids = torch.as_tensor(np.random.RandomState(0).randint(1, runner.cfg.vocab_size,
                                                                   size=(1, 100)), device="cuda")
            host = []
            for _ in range(4):   # the first captures the scan's graphs
                cache = runner.init_cache()
                logits, cache = runner.prefill(ids, cache)
                tok = logits[:, -1:].float().argmax(-1)
                torch.cuda.synchronize()
                t = time.perf_counter()
                runner.decode_greedy_scan(tok, cache, 64)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) / 64 * 1e3)
            out["scan_host_ms_per_token"] = statistics.median(host[1:])
        offs = runner._store.offs
        for o in offsets:
            out[f"graph_device_ms_at_{o}"] = replay_ms(
                torch, runner.graphs, ("decode", 256 if o < 256 else 2048),
                lambda o=o: offs.fill_(o))
        return out

    def serve_runs(**kw):
        """The 12 requests on 8 slots, dense, chunk 128, span 8, twice: tok/s
        and ttft p50 of each run (the second with every graph captured)."""
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab_size, size=n)
                   for n in (37, 50, 100, 120, 200, 300, 450, 600, 64, 90, 256, 512)]
        eng = ServingEngine("llama", cfg, params, batch_slots=8, max_seq_len=2048,
                            prefill_buckets=(32, 128, 512), prefill_chunk=128, decode_span=8,
                            **kw)
        runs = []
        for _ in range(2):
            for uid, p in enumerate(prompts):
                eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=48))
            torch.cuda.synchronize()
            t = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            tokens = sum(len(r) for r in results.values())
            runs.append({"tok_s": tokens / dt, "ttft_p50_s": eng.stats()["ttft_p50_s"]})
        del eng
        torch.cuda.empty_cache()
        return runs

    cfg = ModelConfig(**LLAMA_7B)
    if legs & {"7b", "decode", "serve", "eval", "lora", "kvdtype"}:
        params = gaussian_wire_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)

    # -- LLaMA-7B prefill ----------------------------------------------------
    if "7b" in legs:
        runner = ModelRunner("llama", cfg, params, dtype=torch.bfloat16, device="cuda")
        runner.warmup(prefill_buckets=(37, 100, 201))
        report["prefill_7b"] = prefill_ms(runner, (37, 100, 201), np.random.RandomState(0))
        log(f"{tag} 7B prefill " + ", ".join(f"{n}: host {r['host_ms']:.3f} ms, device "
                                             f"{r['device_ms']:.3f} ms"
                                             for n, r in report["prefill_7b"].items())
            + f" | {card}")
        del runner
        torch.cuda.empty_cache()

    # -- batch-1 decode: the decode graphs, the scan's host loop ---------------
    if "decode" in legs:
        runner = ModelRunner("llama", cfg, params, dtype=torch.bfloat16, device="cuda")
        runner.warmup(prefill_buckets=(100,))
        report["decode_7b"] = decode_ms(runner, (164, 2047))
        del runner
        torch.cuda.empty_cache()
        ncfg = ModelConfig(**ARCH_CONFIGS["neox"])
        nparams = GAUSSIAN_WIRE["neox"](ncfg, seed=0, device="cuda", dtype=torch.bfloat16)
        runner = ModelRunner("neox", ncfg, nparams, dtype=torch.bfloat16, device="cuda")
        runner.warmup(prefill_buckets=(100,))
        report["decode_neox20b"] = decode_ms(runner, (164,), scan=False)
        del runner, nparams
        torch.cuda.empty_cache()
        d7, dn = report["decode_7b"], report["decode_neox20b"]
        log(f"{tag} decode, batch 1: LLaMA-7B decode graph {d7['graph_device_ms_at_164']:.4f} / "
            f"{d7['graph_device_ms_at_2047']:.4f} ms device at offset 164 / 2047, scan graphs "
            f"{d7['scan_host_ms_per_token']:.4f} ms/token host; NeoX-20B decode graph "
            f"{dn['graph_device_ms_at_164']:.4f} ms device at offset 164 | {card}")

    # -- dense serving, chunk 128 ----------------------------------------------
    if "serve" in legs:
        runs = report["serve_dense_chunk128"] = serve_runs()
        log(f"{tag} dense serving chunk 128, 8 slots, 12 x 48: second run {runs[1]['tok_s']:.1f} "
            f"tok/s, ttft p50 {runs[1]['ttft_p50_s']} s (first {runs[0]['tok_s']:.1f}) | {card}")

    # -- LLaMA-7B over fp8-e4m3 caches: prefill graph, dense and fold serving ----
    if "kvdtype" in legs:
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        fp8 = torch.float8_e4m3fn
        kernels.reset_launch_counts()
        runner = ModelRunner("llama", cfg, params, dtype=torch.bfloat16, device="cuda",
                             kv_dtype=fp8)
        runner.warmup(prefill_buckets=(201,))
        pre = report["kv_fp8_prefill_7b"] = prefill_ms(runner, (201,), np.random.RandomState(0))
        del runner
        torch.cuda.empty_cache()
        dense = report["kv_fp8_serve_dense"] = serve_runs(kv_dtype=fp8)
        fold = report["kv_fp8_serve_fold"] = serve_runs(kv_dtype=fp8, fused_chunk_decode=False,
                                                        cache_impl="fold")
        counts = kernels.launch_counts()
        bodies = report["kv_fp8_kernel4_launches"] = {
            b: counts.get(f"flash_prefill_blocked:{b}:fp8") for b in ("sync", "wgmma")}
        log(f"{tag} fp8-e4m3 KV: 7B 201-token prefill graph host {pre[201]['host_ms']:.3f} ms, "
            f"device {pre[201]['device_ms']:.3f} ms; dense serving chunk 128 second run "
            f"{dense[1]['tok_s']:.1f} tok/s, ttft p50 {dense[1]['ttft_p50_s']} s (first "
            f"{dense[0]['tok_s']:.1f}); fold serving {fold[1]['tok_s']:.1f} tok/s, ttft p50 "
            f"{fold[1]['ttft_p50_s']} s (first {fold[0]['tok_s']:.1f}); kernel 4 launches over "
            f"fp8 by body {bodies} | {card}")

    # -- eval forward, 8 x 2048 ------------------------------------------------
    if "eval" in legs:
        ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (8, 2048)),
                              device="cuda")
        times = []
        with torch.no_grad():
            for _ in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                llama.forward(params, cfg, ids)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        report["eval_tok_s"] = ids.numel() / statistics.median(times[1:])
        log(f"{tag} eval forward 8 x 2048, 32 layers: {report['eval_tok_s']:.1f} tok/s | {card}")
        del ids
        torch.cuda.empty_cache()

    # -- LoRA step, heuristic then tuned plans ----------------------------------
    if "lora" in legs:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        adapters, skeleton = split_lora(attach_lora("llama", params, rank=8, generator=gen,
                                                    alpha=16.0))
        leaves = [t.requires_grad_() for ab in adapters for t in (ab["a"], ab["b"])]
        ids = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 512)),
                              device="cuda")
        opt = torch.optim.Adam(leaves, lr=1e-4)

        def lora_ms(steps=9):
            times = []
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = llama.forward(join_lora(skeleton, adapters), cfg, ids)
                loss = F.cross_entropy(logits[:, :-1].flatten(0, 1).float(),
                                       ids[:, 1:].flatten())
                loss.backward()
                opt.step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            return statistics.median(times[1:])

        report["lora_step_ms"] = {"warm": lora_ms(5)}   # the allocator and autograd warm up
        report["lora_step_ms"]["heuristic"] = lora_ms()
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["GPTQ_TORCH_AUTOTUNE"] = "1"
            os.environ["GPTQ_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
            autotune.configure()
            t = time.perf_counter()
            # every packed linear: kernels 1 and 8
            linears, _ = autotune.collect(params, "none")
            autotune.ensure_linears(linears, ids.numel())
            autotune.ensure_linears(linears, ids.numel(), kind="bwd")
            race_s = time.perf_counter() - t
            report["lora_step_ms"]["tuned"] = lora_ms()
            report["lora_step_ms"]["tuned_again"] = lora_ms()
            with open(os.path.join(tmp, "autotune.json")) as f:
                report["lora_tuned_plans"] = json.load(f)["entries"]
            os.environ["GPTQ_TORCH_AUTOTUNE"] = "0"
            autotune.configure()
        report["lora_step_ms"]["heuristic_again"] = lora_ms()
        report["lora_race_s"] = race_s
        lora = report["lora_step_ms"]
        log(f"{tag} LoRA step 2 x 512, rank 8 on 224 linears, ms in turns: heuristic "
            f"{lora['heuristic']:.1f}, tuned {lora['tuned']:.1f}, tuned "
            f"{lora['tuned_again']:.1f}, heuristic {lora['heuristic_again']:.1f} (race "
            f"{race_s:.1f} s; plans "
            f"{report['lora_tuned_plans']}) | {card}")
        del adapters, skeleton, leaves, opt, params
        torch.cuda.empty_cache()

    # -- GPT-NeoX-20B prefill --------------------------------------------------
    if "neox" in legs:
        ncfg = ModelConfig(**ARCH_CONFIGS["neox"])
        nparams = GAUSSIAN_WIRE["neox"](ncfg, seed=0, device="cuda", dtype=torch.bfloat16)
        runner = ModelRunner("neox", ncfg, nparams, dtype=torch.bfloat16, device="cuda")
        runner.warmup(prefill_buckets=(37, 100))
        report["prefill_neox20b"] = prefill_ms(runner, (37, 100), np.random.RandomState(0))
        log(f"{tag} NeoX-20B prefill " + ", ".join(f"{n}: host {r['host_ms']:.3f} ms, device "
                                                   f"{r['device_ms']:.3f} ms"
                                                   for n, r in report["prefill_neox20b"].items())
            + f" | {card}")
        del runner, nparams
        torch.cuda.empty_cache()

    # -- LLaMA at head dim 256, 2 layers -----------------------------------------
    if "d256" in legs:
        from gptq_for_llama_tpu_torch.engine.evaluate import window_nll
        from gptq_for_llama_tpu_torch.models.registry import get_arch
        dcfg = ModelConfig(**LLAMA_256)
        dparams = gaussian_wire_llama(dcfg, seed=256, device="cuda", dtype=torch.bfloat16)
        runner = ModelRunner("llama", dcfg, dparams, dtype=torch.bfloat16, device="cuda")
        runner.warmup(prefill_buckets=(37, 100, 201))
        report["prefill_d256"] = prefill_ms(runner, (37, 100, 201), np.random.RandomState(0))
        del runner
        ids = torch.as_tensor(np.random.RandomState(1).randint(0, dcfg.vocab_size, (8, 2048)),
                              device="cuda")
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            window_nll(get_arch("llama"), dcfg, dparams, ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        report["eval_d256_tok_s"] = ids.numel() / statistics.median(times[1:])
        log(f"{tag} LLaMA D=256 (16 heads over 2, 2 layers at 7B width): prefill "
            + ", ".join(f"{n}: host {r['host_ms']:.3f} ms, device {r['device_ms']:.3f} ms"
                        for n, r in report["prefill_d256"].items())
            + f"; eval forward 8 x 2048 {report['eval_d256_tok_s']:.1f} tok/s | {card}")
        del dparams, ids
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
