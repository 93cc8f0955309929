#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gptq_for_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py [--json PATH] [--phases build,kernels,...]

Phases, in order, on one card:
  card     the card is there; prints nvidia-smi's name and power limit.
  build    builds every kernel of csrc/ with nvcc (timed) and prints the
           ptxas register / spill lines.
  kernels  each kernel against its plain PyTorch version on the card at the
           shapes LLaMA-7B prefill, decode, calibration, eval, serving and LoRA
           training give it:
           error vs the stated tolerance (attention: per output row, relative
           to the row's norm), kernel / plain / library-call time (CUDA events
           around a CUDA-graph replay of many launches, weights cycled
           through copies larger than the 50 MB L2), and the bound. Kernel
           2's rows time every form forced beside kernel 1 run twice;
           kernel 7's rows time kernel 3 over the gathered view and require
           the two outputs bit-equal; kernel 6's rows time it alone and with
           the residual add folded in, beside ``x + r`` then the norm alone,
           and an empty kernel's launch (the launch floor). Kernel 4's rows
           run its device-offset form (the offset, and for the dense serving
           chunk the cache row, read from the card) and replay a graph
           captured at offset 0 and slot 0 at the row's own, bit-equal to
           the eager launch.
  e2e      a random wire-format LLaMA at 7B width and 2 layers: prefill and
           8 greedy steps on the card (bf16, kernels) against the same
           weights on the CPU (fp32, plain versions).
  full     LLaMA-7B INT4-g128, 32 layers (seeded zero-mean codes, every layer
           its own draw, so the tokens depend on the prompt), batch 1:
           ``generate`` (spans of 32, CUDA graphs) greedily for three prompts
           of ragged lengths, 64 tokens each; every kernel of the decode path
           must launch. The same tokens, bit for bit, through the eager
           ``_step`` loop, ``decode_greedy_scan``'s graphs and
           ``generate(span=1)``, with the same launches per decode forward,
           and ``forced_decode_scan`` over them ends on the loop's logits.
           Each prompt's prefill graph (the prompt right-padded to S_pad),
           and a second prefill at an offset replaying the graph captured at
           offset 0, bit-equal to the body run eagerly (logits, caches below
           the offset), with host and device ms of both; every prefill of
           the second generate pass a replay.
           Prints the host loop's ms/token (eager, graphs, span 1), the decode
           graph's device time, the decode step's two plans (each offset's
           bucket, the whole cache) at offsets 37, 1000 and 2047, capture
           seconds, the graph pool's memory, tok/s, peak memory and the
           roofline share.
  fold     the decode path with cache_impl="fold" on the same model: the same
           prompts through the fold kernel (attention over the stale cache with
           the current k/v folded in, then the row write), tokens held to the
           classic runner where its top-2 margin is clear and to the fold
           runner's eager step loop bit for bit, 32 fold launches and no
           classic decode launch per decode forward, the device step as a CUDA
           graph beside the classic one; then the serve phase's 12 requests on
           the dense engine with cache_impl="fold", held like the serve runs
           and to the same engine with its spans run eagerly.
  lora     LoRA finetuning over the frozen packed 7B model: rank-8 adapters
           on all seven linears of every layer, Adam steps on a fixed batch of
           2 x 512 tokens through the grad-input kernel; loss per step, ms per
           forward / backward, peak memory, launches per step against the
           path's prediction; the loss falls, every b moves, the packed
           buffers stay byte-identical. Then every adapter's gradient of a
           2-layer 7B-width model on the card against the CPU fp32 plain path,
           with all seven linears adapted and with gate/up frozen (fused).
  quantize the quantize -> pack -> save -> reload -> perplexity path through
           the CLI, in-process: a dense F16 LLaMA checkpoint at 7B width and
           2 layers written from a seed, then ``--wbits 4 --groupsize 128
           --act-order --true-sequential --nsamples 128 --save OUT --eval``
           and ``--load OUT --eval --benchmark 128 --check``. Prints s/layer
           (forwards, Hessians, solver), eval tok/s, peak memory and launches
           per path; checks GPTQ against RTN, the card's Hessian against fp64,
           the solver card vs CPU, the reloaded wire bytes, and a window's NLL
           card vs the fp32 CPU plain path.
  serve    continuous-batching serving of the ``full`` phase's LLaMA-7B through
           ``ServingEngine``: 12 greedy requests (prompts of 37..600 tokens, 48
           new tokens each) on 8 slots, paged KV (block 16, span 8, over a pool
           poisoned with NaN; and span 1), then a dense cache with chunked
           prefill (chunk 128), fused with the decode step and not. Tokens are
           held against the single-sequence runner where its top-2 margin is
           clear, the k/v every request left in the cache at its retirement
           against the runner's cache, paged against dense, launch counts
           against the forwards the engine made, and the graphs' tokens and
           retired caches, bit for bit, against the same engine with every
           step run eagerly (paged span 8 and span 1, dense fused). Each
           graph engine runs the requests a second time with every graph
           captured: the same tokens, replays of each prefill, admission,
           chunk and chunk+decode key equal to those forwards, at most 16
           such keys. Then the serving CLI (``--demo``, paged) on the
           2-layer checkpoint the ``quantize`` phase saved. Prints tok/s,
           ttft and latency percentiles of both runs, steps, peak memory,
           graphs, capture seconds per kind of key, the replays at another
           slot or offset than their capture's, and pool memory; a decode
           step's host time
           through the graph, its device time and the eager body's time at
           span 1 and span 8 (the host share).
  kvdtype  KV caches stored in fp8-e4m3, fp8-e5m2 and f32 (``ops/kv_dtype.py``):
           kernels 3, 9, 7 and 4 over each at the ``kernels`` phase's shapes
           (3, 9: B = 1 at offsets 0 / 127 / 2047, GQA, 8 serving slots; 9's
           masked row write with values past e4m3's range, caches byte-equal;
           7: the four serving rows, bit-equal to kernel 3 on the gathered
           view; 4: SQ = 100 / 128 / 512), each against its plain version at
           the bf16 rows' tolerance, over caches holding the dtype's NaN code
           past each offset; timed beside the plain version and the library's
           upcast of the live cache to bf16 plus SDPA; bound at the cache's
           own bytes. All 256 e4m3 codes read bit-equal by 3, 7, 9 and 4.
           LLaMA-7B over an fp8-e4m3 cache: the full phase's prompts through
           generate(span=32) twice, the prefill graphs and the decode loops
           bit-equal to their eager bodies, ms/token host and device, the
           cache's bytes half a bf16 cache's; the serve phase's 12 requests on
           8 slots paged (span 8), dense chunk 128 and dense fold, each run
           twice, the paged tokens and caches held to the fp8 runner, the KV
           bytes half a bf16 engine's. The 2-layer 7B-width model over each
           dtype against the fp32 CPU path over the same dtype (2e-2), graphs
           bit-equal to the eager loop; the CLIs ``--benchmark 128 --check``
           and ``serve --demo 12 --paged`` with ``--kv-dtype`` each dtype.
  archs    OPT, GPT-NeoX and GPT-2 at their published widths, and head dims
           other than 128 (ARCH_CONFIGS: GPT-NeoX-20B, D = 96, 44 layers;
           OPT-2.7B, D = 80, 32 layers; GPT-2 medium, D = 64, 24 layers; INT4
           g128 ``gaussian_wire_<arch>`` weights). Kernels 3, 9, 7, 4 and 5
           at D = 64, 80, 96 and 256 over every cache dtype (kernel 5: bf16)
           against their plain versions (1e-2 of each row's norm) over caches
           holding the dtype's NaN code past each offset, two launches
           bit-equal, kernel 7 bit-equal to kernel 3 on the gathered view,
           kernel 4 at offset 0 bit-equal to kernel 5, each timed beside the
           library's upcast plus SDPA and its bound. Kernel 1 at LLaMA-7B's
           fused q/k/v (4096 x 12288, its columns against the three unfused
           launches) and at NeoX-20B's linears with their biases. Each
           family at 2 layers on the card against the CPU (logits 2e-2,
           greedy tokens where clear). Each at full depth: ``generate``
           through the graphs (ms/token, the decode graph's device time,
           launches by head dim) and 8-slot serving (NeoX: paged span 8,
           dense chunk 128, dense fold, and the fold runner; OPT: paged;
           GPT-2: dense chunked), each run twice (tok/s, ttft). NeoX
           quantize -> save -> reload -> eval -> benchmark through the CLI on
           a 2-layer dense F16 checkpoint it writes (calibration on kernel 5
           at D = 96, reloaded wire bytes equal). LLaMA-7B with
           ``fuse_qkv=True``: kernel-1 launches per decode token (96 against
           160) and ms/token beside the unfused runner, and the fused 2-layer
           7B-width model on the card against the unfused CPU path.
  offload  LLaMA-7B with layers 8-31 streamed from pinned host memory
           (``runtime/offload.OffloadRunner``, cache 512): a 37-token prompt
           and 32 greedy tokens through ``generate``, tokens and prompt
           logits bit-equal to the resident runner's ``generate(span=1)``;
           ms/token beside the H2D bound (the streamed bytes over a plain
           pinned copy's rate, measured here), the share of the copy time
           hidden under compute, peak memory beside the resident runner's
           (at least 20 streamed layers' bytes less). Then the CLI with
           ``--pre-layer 1 --eval --benchmark 32 --check`` on the quantize
           phase's checkpoint, its ppl equal to the resident CLI run's.
  autotune the measured race of kernels 1, 2 and 8 (``ops/cuda/autotune.py``)
           into a fresh cache file at LLaMA-7B's shapes (kernel 1 at 4096 x
           4096 and 11008 x 4096, M 1, 8, 1024; kernel 2 at 4096 x 11008, M
           1 and 8; kernel 8 at 4096 x 4096, M 1024), each candidate's time
           over a graph of the model's own linears of the shape, the winner
           against its plain version; the 7B decode graph at offsets 164 and
           2047 and an 8-slot serving decode step, tuned against heuristic,
           in turns; a fresh process's ``ModelRunner.warmup`` on the same
           file makes no measurement. Every other phase runs with
           GPTQ_TORCH_AUTOTUNE=0 (the heuristic plans).
  profile  torch.profiler over eager decode steps of a 4-layer 7B-width
           model: device time per kernel, the device busy share and the
           elementwise add launches per step (the ``full`` phase prints the
           same for its 32-layer decode step).

Exits non-zero, with no result line, on any failure or when no CUDA device
is present. Otherwise the line before last is the kernels JSON and the last
line is {"ok": true, "device": {...}}. ``--phases`` runs only the phases
named (e.g. ``build,kernels`` to time the kernels alone; the card phase
always runs) and then prints no result line: the launch checks need every
phase. Needs no network; imports nothing of
JAX or of the TPU package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 2**20
PHASES = ("build", "kernels", "e2e", "full", "fold", "lora", "quantize", "serve", "kvdtype",
          "archs", "offload", "autotune", "profile")
# kernels each path must launch: the decode path (prefill at a cache offset,
# then decode steps), the calibration forward, the perplexity eval, paged
# serving (bucketed and batched admission, spans) and dense serving with
# chunked prefill
# ("qmm:<form>", "fused_mlp:<form>": kernels 1 and 2 by form: kernel 1's
# fragment form and kernel 2's GEMV at batch-1 decode, the fragment forms at
# the 8-slot serving step, the tiles at prefill, eval and LoRA;
# "rms_norm:<form>": kernel 6 alone, at layer 0's input norm, and with the
# residual add folded in, at every other norm: every path runs both)
NORMS = {"rms_norm", "rms_norm:alone", "rms_norm:add"}
PATHS = {"decode": {"qmm", "fused_mlp", "decode_attention", "flash_prefill_blocked",
                    "qmm:frag", "qmm:tile", "fused_mlp:gemv", "fused_mlp:tile"} | NORMS,
         "quantize": {"flash_prefill"} | NORMS,
         "eval": {"flash_prefill", "qmm", "fused_mlp", "qmm:tile", "fused_mlp:tile"} | NORMS,
         "serve:paged": {"qmm", "fused_mlp", "pool_decode_attention", "flash_prefill_blocked",
                         "flash_prefill", "qmm:frag", "qmm:tile", "fused_mlp:frag",
                         "fused_mlp:tile"} | NORMS,
         "serve:dense": {"qmm", "fused_mlp", "decode_attention", "flash_prefill_blocked",
                         "qmm:frag", "qmm:tile", "fused_mlp:frag", "fused_mlp:tile"} | NORMS,
         # the CLI's demo prompts all have one length: every admission is batched
         "serve:cli": {"qmm", "fused_mlp", "pool_decode_attention", "flash_prefill"} | NORMS,
         # the decode path with cache_impl="fold", in the runner and the dense engine
         "fold": {"qmm", "fused_mlp", "fused_decode_attention", "flash_prefill_blocked",
                  "qmm:frag", "qmm:tile", "fused_mlp:gemv", "fused_mlp:tile"} | NORMS,
         "serve:fold": {"qmm", "fused_mlp", "fused_decode_attention", "flash_prefill_blocked",
                        "qmm:frag", "qmm:tile", "fused_mlp:frag", "fused_mlp:tile"} | NORMS,
         # LoRA training steps (every linear adapted: gate/up unfused), and the
         # gradient check with gate/up frozen (the fused MLP and its backward)
         "lora": {"qmm", "flash_prefill", "qmm_t", "qmm:tile"} | NORMS,
         "lora:fused": {"qmm", "fused_mlp", "flash_prefill", "qmm_t", "qmm:tile",
                        "fused_mlp:tile"} | NORMS,
         # kernels 3, 4, 7 and 9 by the cache dtype they read: the 7B decode
         # path and serving over fp8-e4m3 caches, the CLIs with --kv-dtype fp8
         # (a paged chunk attends its gathered prefix cast to bf16, as the TPU
         # package's astype does)
         "kvdtype:decode": {"qmm", "fused_mlp", "decode_attention:fp8",
                            "flash_prefill_blocked:fp8"} | NORMS,
         "kvdtype:serve:paged": {"qmm", "fused_mlp", "pool_decode_attention:fp8"} | NORMS,
         "kvdtype:serve:dense": {"qmm", "fused_mlp", "decode_attention:fp8",
                                 "flash_prefill_blocked:fp8"} | NORMS,
         "kvdtype:serve:fold": {"qmm", "fused_mlp", "fused_decode_attention:fp8",
                                "flash_prefill_blocked:fp8"} | NORMS,
         "kvdtype:cli": {"qmm", "fused_mlp", "decode_attention:fp8"} | NORMS,
         "kvdtype:serve:cli": {"qmm", "fused_mlp", "pool_decode_attention:fp8"} | NORMS,
         # OPT, GPT-NeoX and GPT-2 (phase archs): the attention kernels counted
         # by head dim (NeoX-20B 96, OPT-2.7B 80, GPT-2 64); no kernel 2 or 6
         # (no gated MLP, LayerNorm in plain torch as the TPU package's XLA)
         "arch:neox:decode": {"qmm", "qmm:tile", "decode_attention", "decode_attention:d96",
                              "flash_prefill_blocked", "flash_prefill_blocked:d96"},
         "arch:neox:serve:paged": {"qmm", "pool_decode_attention", "pool_decode_attention:d96",
                                   "flash_prefill:d96"},
         "arch:neox:serve:dense": {"qmm", "decode_attention:d96", "flash_prefill_blocked:d96"},
         "arch:neox:fold": {"qmm", "fused_decode_attention", "fused_decode_attention:d96"},
         "arch:neox:quantize": {"flash_prefill", "flash_prefill:d96"},
         "arch:opt:decode": {"qmm", "qmm:tile", "decode_attention:d80",
                             "flash_prefill_blocked:d80"},
         "arch:opt:serve:paged": {"qmm", "pool_decode_attention:d80", "flash_prefill:d80"},
         "arch:gpt2:decode": {"qmm", "qmm:tile", "decode_attention:d64",
                              "flash_prefill_blocked:d64"},
         "arch:gpt2:serve:dense": {"qmm", "decode_attention:d64", "flash_prefill_blocked:d64"},
         # LLaMA-7B decode steps with q/k/v fused (one kernel-1 launch a layer for them)
         "fuse_qkv:decode": {"qmm", "fused_mlp", "decode_attention"} | NORMS,
         # the offloaded LLaMA-7B's generate (24 of 32 layers streamed), the
         # offloaded CLI's eval and decode benchmark (phase offload)
         "offload": {"qmm", "fused_mlp", "decode_attention", "flash_prefill_blocked",
                     "qmm:frag", "qmm:tile", "fused_mlp:gemv", "fused_mlp:tile"} | NORMS,
         "offload:eval": {"flash_prefill", "qmm", "fused_mlp", "qmm:tile",
                          "fused_mlp:tile"} | NORMS,
         "offload:benchmark": {"qmm", "fused_mlp", "decode_attention"} | NORMS,
         # LLaMA-7B's generate under the raced plans and under the heuristic
         # ones (phase autotune; the forms the race picks are its own)
         "autotune:tuned": {"qmm", "fused_mlp", "decode_attention",
                            "flash_prefill_blocked"} | NORMS,
         "autotune:heuristic": {"qmm", "fused_mlp", "decode_attention",
                                "flash_prefill_blocked"} | NORMS}
# the rows at which kernel 1's rows also time every form forced (the decode
# widths around the forms' crossovers), as kernel 2's rows do
FORCED_MS = (1, 2, 4, 5, 8, 16)
LLAMA_7B = dict(arch="llama", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128, max_seq_len=2048)
# the published configurations (HF config.json) of phase archs, full depth
ARCH_CONFIGS = {
    # EleutherAI/gpt-neox-20b
    "neox": dict(arch="neox", vocab_size=50432, hidden_size=6144, intermediate_size=24576,
                 num_layers=44, num_heads=64, num_kv_heads=64, head_dim=96, max_seq_len=2048,
                 norm_eps=1e-5, rotary_pct=0.25, act="gelu_fast", parallel_residual=True,
                 attn_bias=True, mlp_bias=True),
    # facebook/opt-2.7b
    "opt": dict(arch="opt", vocab_size=50272, hidden_size=2560, intermediate_size=10240,
                num_layers=32, num_heads=32, num_kv_heads=32, head_dim=80, max_seq_len=2048,
                norm_eps=1e-5, act="relu", pos_embedding="learned", attn_bias=True,
                mlp_bias=True, tie_word_embeddings=True),
    # openai-community/gpt2-medium
    "gpt2": dict(arch="gpt2", vocab_size=50257, hidden_size=1024, intermediate_size=4096,
                 num_layers=24, num_heads=16, num_kv_heads=16, head_dim=64, max_seq_len=1024,
                 norm_eps=1e-5, act="gelu_new", pos_embedding="learned", attn_bias=True,
                 mlp_bias=True, tie_word_embeddings=True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the bf16 peak."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def row_rel_errs(got, want):
    """|got - want| / |want| of every output row (all indices but the last)."""
    g, w = got.float(), want.float()
    return (g - w).norm(dim=-1) / w.norm(dim=-1)


def row_rel_err(got, want) -> float:
    """Largest over output rows of ``row_rel_errs``. A causal row i averages
    i + 1 values, so its size falls like 1/sqrt(i + 1); an error bound set
    from the largest value of the whole output would let late rows be wrong by
    as much as they are."""
    return row_rel_errs(got, want).max().item()


def bf16_ulps(torch, got, want) -> int:
    """Largest distance of two bf16 tensors in units of the last place: the
    difference of their bit patterns on the monotonic integer line."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(got) - line(want)).abs().max())


def graph_ms(torch, fns, iters: int = 60) -> float:
    """Device time of one call: ``iters`` calls (cycling ``fns``, one per
    weight copy) captured in a CUDA graph, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del g
    return best


def replay_ms(torch, graphs, key, reset, iters: int = 8) -> float:
    """Device time of one replay of the port's own graph ``key`` of
    ``graphs`` (``runtime/graphs.Graphs``): ``reset()`` (an offset fill, a
    microsecond-sized launch) then the replay, ``iters`` times between CUDA
    events, best of three."""
    reset()
    graphs.replay(key)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            reset()
            graphs.replay(key)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def graph_replay(torch, fn, move):
    """``fn()`` captured in a CUDA graph (one warm call first), then
    ``move()`` (device buffers set to other values than at capture) and one
    replay: returns the replay's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    move()
    g.replay()
    torch.cuda.synchronize()
    del g
    return out


def bits_equal(a, b) -> bool:
    """Two 2-byte tensors equal bit for bit (NaN where NaN)."""
    import torch
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int16),
                                              b.contiguous().view(torch.int16))


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(3 * L2_BYTES / max(nbytes, 1)))


def write_dense_llama(torch, path: str, layers: int, seed: int) -> int:
    """A dense LLaMA HF checkpoint at 7B width (hidden 4096, intermediate
    11008, 32 heads, vocab 32000) and ``layers`` layers, stored F16 as
    published LLaMA checkpoints are: matrices N(0, 0.02) (the HF LLaMA
    initializer range) drawn on the card from ``seed``, norms 1. Returns the
    bytes written."""
    from gptq_for_llama_tpu_torch.engine.safetensors_io import save_file
    h, inter, vocab = 4096, 11008, 32000
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.02).half().cpu()

    ones = torch.ones(h, dtype=torch.float16)
    flat = {"model.embed_tokens.weight": w(vocab, h), "model.norm.weight": ones,
            "lm_head.weight": w(vocab, h)}
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h), "self_attn.v_proj": (h, h),
              "self_attn.o_proj": (h, h), "mlp.gate_proj": (inter, h), "mlp.up_proj": (inter, h),
              "mlp.down_proj": (h, inter)}
    for i in range(layers):
        p = f"model.layers.{i}"
        flat[f"{p}.input_layernorm.weight"] = ones
        flat[f"{p}.post_attention_layernorm.weight"] = ones
        for name, shape in shapes.items():
            flat[f"{p}.{name}.weight"] = w(*shape)
    os.makedirs(path, exist_ok=True)
    save_file(flat, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": vocab, "hidden_size": h,
                   "intermediate_size": inter, "num_hidden_layers": layers,
                   "num_attention_heads": 32, "num_key_value_heads": 32, "rms_norm_eps": 1e-6,
                   "max_position_embeddings": 2048, "hidden_act": "silu",
                   "tie_word_embeddings": False}, f)
    return sum(t.numel() * t.element_size() for t in flat.values())


def write_dense_arch(torch, name: str, path: str, layers: int, seed: int) -> int:
    """A dense F16 HF checkpoint of ``name`` (ARCH_CONFIGS) at its published
    width and ``layers`` layers: the arch's ``init_params`` from ``seed``,
    saved in the HF layout through ``engine.checkpoint.flatten_to_hf`` with
    its config.json. Returns the bytes written."""
    from gptq_for_llama_tpu_torch.engine.checkpoint import _hf_config_dict, flatten_to_hf
    from gptq_for_llama_tpu_torch.engine.safetensors_io import save_file
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.models.registry import get_arch
    cfg = ModelConfig(**dict(ARCH_CONFIGS[name], num_layers=layers))
    params = get_arch(name).init_params(cfg, torch.Generator().manual_seed(seed),
                                        dtype=torch.float16, device="cpu")
    flat = flatten_to_hf(name, cfg, params)
    os.makedirs(path, exist_ok=True)
    save_file(flat, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config_dict(name, cfg), f)
    return sum(t.numel() * t.element_size() for t in flat.values())


def _nonzero(counts: dict) -> str:
    """Launch counts without the kernels and forms that did not launch."""
    return json.dumps({k: v for k, v in counts.items() if v})


def _tree_to_cpu(tree, dtype):
    """A parameter tree on the CPU in ``dtype``: each packed linear rebuilt
    from its own wire buffers, adapters and dense tensors copied."""
    import dataclasses
    from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
    from gptq_for_llama_tpu_torch.ops.lora import LoraLinear, map_leaves

    def leaf(x):
        if isinstance(x, LoraLinear):
            return dataclasses.replace(x, base=map_leaves(leaf, x.base))
        if isinstance(x, PackedLinear):
            w = x.to_wire()
            return PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"],
                                          bits=x.wire_bits or x.bits, bias=w.get("bias"),
                                          dtype=dtype, device="cpu")
        return None if x is None else x.to(device="cpu", dtype=dtype)

    return map_leaves(leaf, tree)


def solver_agreement(got, want) -> dict:
    """How closely two GPTQResults (CPU tensors) agree: the fraction of group
    scales within 1e-5 relative, of zeros equal, of integer codes equal, the
    largest code difference and the relative difference of the error."""
    gq, gs, gz, gg, ge = (t.double().numpy() if hasattr(t, "numpy") else t for t in got)
    wq, ws, wz, wg, we = (t.double().numpy() if hasattr(t, "numpy") else t for t in want)
    gi, wi = gg.astype(np.int64), wg.astype(np.int64)
    if not np.array_equal(gi, wi):
        raise AssertionError("solver: group indices differ")
    gc = np.rint(gq / gs[:, gi] + gz[:, gi])
    wc = np.rint(wq / ws[:, wi] + wz[:, wi])
    return {"scales_close": float((np.abs(gs - ws) <= 1e-5 * np.abs(ws)).mean()),
            "zeros_equal": float((gz == wz).mean()),
            "codes_equal": float((gc == wc).mean()),
            "codes_max_diff": int(np.abs(gc - wc).max()),
            "error_rel": float(abs(float(ge) - float(we)) / abs(float(we)))}


class Smoke:
    def __init__(self):
        self.card = ""
        self.launches = {}  # path -> {kernel name: launches on that path}
        self.report = {"kernels": {}}
        self.entries = {}   # kernel name -> JSON entry
        self.serve_entries = {}   # kernel name -> the same at its serving shape
        self.paths = {}     # "kernel shape" -> kernel 1's path on that row
        self.sq2048 = None  # kernel 4 and kernel 5 at SQ = SKV = 2048, offset 0
        self.tmp = None     # scratch directory of the quantize and serve phases
        self.model7b = None  # (cfg, params) of the full phase, served again
        self.kv_entries = {}  # kernel -> {cache dtype: its row of the kernels line}
        self.dim_entries = {}  # kernel -> {"d<D>": {cache dtype: its row}} (phase archs)
        self._classic_tokens = None   # an arch's classic generate tokens (phase archs)

    # -- phase 1 ---------------------------------------------------------------
    def phase_card(self, torch):
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise RuntimeError("no CUDA device")
        self.card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        log(self.card)
        name = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
            f"sm_{cap[0]}{cap[1]} count {torch.cuda.device_count()}")
        if cap != (9, 0):
            raise RuntimeError(f"kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
        if "SXM" not in name and "HBM3" not in name:
            log(f"[card] {name} is not an H100 SXM part: the 3.35 TB/s / 989 TFLOP/s "
                "peaks used for bounds and roofline shares do not match it")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.report["card"] = self.card

    # -- phase 2 ---------------------------------------------------------------
    def phase_build(self, torch):
        from gptq_for_llama_tpu_torch.ops.cuda import build
        t0 = time.perf_counter()
        built = build.build_all()
        dt = time.perf_counter() - t0
        log(f"[build] {len(built)} libraries built in {dt:.1f} s ({self.card})")
        for name, text in sorted(built.items()):
            for line in text.splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling entry", "arning")):
                    log(f"[ptxas {name}] {line.strip()}")
        self.report["build_s"] = dt
        # ptxas reports static shared memory only; the tile kernels size theirs
        # at launch
        from gptq_for_llama_tpu_torch.ops.cuda import matmul, matmul_t
        from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import PATH_IDS
        fn = build.library("flash_prefill").gptq_flash_smem_bytes
        smem = {f"flash {body}": fn(i) for body, i in PATH_IDS.items()}
        for bits in (2, 4, 8):
            for bm in matmul.TC_ROW_TILES:   # kernels 1 and 2 alike
                smem[f"qmm / fused_mlp tile {bits}-bit BM={bm}"] = matmul.tile_smem_bytes(bits, bm)
                smem[f"qmm_t {bits}-bit BM={bm}"] = matmul_t.tile_smem_bytes(bits, bm)
            for nt in (1, 2):   # kernels 1 and 2 alike
                smem[f"qmm / fused_mlp frag {bits}-bit M<={8 * nt}"] = matmul.frag_smem_bytes(bits,
                                                                                          nt)
            for mt in (1, 2, 4, 8) if hasattr(matmul, "gemv_smem_bytes") else ():
                for streams, name in ((1, "qmm"), (2, "fused_mlp")):
                    smem[f"{name} gemv {bits}-bit MT={mt}"] = matmul.gemv_smem_bytes(bits, mt,
                                                                                     streams)
        from gptq_for_llama_tpu_torch.ops.cuda import attention
        for name, itemsize in (("fp8", 1), ("bf16", 2), ("f32", 4)):   # layout checked at load
            smem[f"decode ring (kernels 3, 7, 9), {name} cache"] = attention.ring_smem_bytes(itemsize)
        log("[build] dynamic shared memory per block (bytes): "
            + ", ".join(f"{k} {v}" for k, v in smem.items()))
        self.report["dynamic_smem_bytes"] = smem

    # -- phase 3 ---------------------------------------------------------------
    def _record(self, kernel, shape, err, tol, ms, plain_ms, lib_ms, nbytes, flops, main=False,
                row_rel=None, ref_max=None, ulps=None, serve=False, path=None, extra=None):
        """One kernel row. The check is ``err <= tol``; where ``row_rel`` (the
        per-row relative error) is given, ``row_rel <= tol``; where ``ulps``
        (the distance in bf16 units of the last place) is given, ``ulps <= tol``.
        ``main`` marks the kernel's row of the kernels line, ``serve`` the row
        at the shape of the serving decode step (or, for the prefill kernels,
        of a serving chunk or admission), printed beside it. ``path`` names
        kernel 1's or 2's form (``gemv``, ``frag`` or ``tile``) or kernel 6's
        (``alone`` or ``add``); ``extra`` adds measured keys."""
        b_ms, b_by = bound(nbytes, flops)
        checked = ulps if ulps is not None else err if row_rel is None else row_rel
        ok = checked <= tol
        row = {"shape": shape, "max_abs_err": err, "row_rel_err": row_rel, "max_abs_ref": ref_max,
               "bf16_ulps": ulps, "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "ok": ok, "path": path, **(extra or {})}
        self.report["kernels"].setdefault(kernel, []).append(row)
        if path is not None:
            self.paths[f"{kernel} {shape}"] = path
        what = (f"max_abs_err {err:.3e}, {ulps} bf16 ulp (tol {tol})" if ulps is not None else
                f"max_abs_err {err:.3e} (tol {tol:.3e})" if row_rel is None else
                f"max_abs_err {err:.3e}, max|plain| {ref_max:.3e}, worst row rel {row_rel:.3e} "
                f"(tol {tol:.3e})")
        plan = (extra or {}).get("plan")
        forced = (extra or {}).get("forced_chunk_ms")
        log(f"[kernel {kernel}] {shape}{'' if path is None else f' [{path}]'}: {what} "
            f"{'ok' if ok else 'FAIL'} | kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library {'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
            f"bound {b_ms * 1e3:.2f} us ({b_by})"
            + ("" if plan is None else
               f" | plan: {plan['chunks']} chunks of {plan['chunk']} slots, {plan['blocks']} "
               f"blocks, {plan['blocks_with_work']} with work")
            + ("" if forced is None else
               " | forced chunks: " + ", ".join(f"{c} slots {t * 1e3:.2f} us"
                                                for c, t in forced.items()))
            + f" | {self.card}")
        if not ok:
            raise AssertionError(f"{kernel} {shape}: kernel disagrees with its plain version "
                                 f"({checked} > {tol})")
        entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "shape": shape, "path": path}
        if main:
            self.entries[kernel] = entry
        if serve:
            self.serve_entries[kernel] = entry

    def _linears(self, torch, rng, k, n, count):
        from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_linear
        w = random_wire_linear(rng, k, n, 128, 4)
        return [PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"],
                                       bits=4, dtype=torch.bfloat16, device="cuda")
                for _ in range(count)]

    @staticmethod
    def _lin_bytes(lin):
        return (lin.qweight.numel() * 4 + lin.scales.numel() * 2 + lin.zeros.numel() * 2)

    @staticmethod
    def _plan_log(plan, hkv, lives):
        """What a row of kernels 3 and 9 logs of the plan it took (from
        ``attention.plan_for``, the wrapper's own): chunks, slots per chunk,
        the grid's blocks and those with work. Chunk z of a row with L live
        slots has work where z * chunk < L; the others exit at once."""
        work = hkv * sum(min(plan.nsplit, -(-live // plan.chunk)) for live in lives)
        return {"plan": {"chunks": plan.nsplit, "chunk": plan.chunk,
                         "blocks": len(lives) * hkv * plan.nsplit, "blocks_with_work": work}}

    def phase_kernels(self, torch):
        import torch.nn.functional as F
        from gptq_for_llama_tpu_torch.ops.cuda import attention
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (
            decode_attention_cuda, decode_attention_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.flash import (
            flash_prefill_blocked_cuda, flash_prefill_blocked_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.flash import _launch as flash_launch
        from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import plan as flash_plan
        from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import flash_prefill_cuda
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import plan_for, qmm_cuda
        from gptq_for_llama_tpu_torch.ops.linear import quant_matmul_plain

        rng = np.random.RandomState(1234)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        bf = torch.bfloat16

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf)

        # kernel 1: tolerance 2e-2 * max|plain| where the sums run in another
        # order than the plain version's: the GEMV (the batch-1 row) keeps the
        # dequantized weight in fp32 where the plain version rounds it to bf16,
        # the fragment form (M <= 16) and tiles with K split sum fp32 partials.
        # Tiles without a split round the weight as the plain version does and
        # sum the k16 products in cuBLAS's order: held to 0 bf16 ulp
        # (bit-equal).
        # M: the batch-1 decode step, the decode widths on either side of the
        # forms' crossovers (2, 4, 5, 16) and a prompt, then what serving gives
        # the linears: 8 slots' decode step, a chunk (128), the fused
        # chunk+decode row (8 + 128), the buckets (128, 512, 2048) and a
        # batched admission (8 x 128 = 1024); the LoRA step's unfused gate/up
        # (4096 x 11008) at its batch (2 x 512) and at the gradient check's
        # (128). At M <= 16 every form is forced too (FORCED_MS)
        ms_of = (1, 2, 4, 5, 8, 16, 100, 128, 136, 512, 1024, 2048)
        for k, n, what, rows in ((4096, 4096, "q_proj", ms_of), (11008, 4096, "down_proj", ms_of),
                                 (4096, 11008, "gate_proj", (128, 1024))):
            lins = self._linears(torch, rng, k, n, copies_for(k * n // 2))
            lin = lins[0]
            wdq = [lin.dequantize(bf) for _ in range(copies_for(k * n * 2))]
            for m in rows:
                x = randn(m, k)
                y = qmm_cuda(x, lin)
                p = plan_for(x, lin)
                path = p.path
                ref = quant_matmul_plain(x, lin, bf)
                err = (y.float() - ref.float()).abs().max().item()
                exact = path == "tile" and p.split == 1
                tol = 0 if exact else 2e-2 * ref.float().abs().max().item()
                iters = 60 if m <= 136 else 6
                ms = graph_ms(torch, [lambda l=l: qmm_cuda(x, l) for l in lins], iters=iters)
                pms = graph_ms(torch, [lambda l=l: quant_matmul_plain(x, l, bf) for l in lins],
                               iters=min(iters, 10))
                lms = graph_ms(torch, [lambda w=w: torch.matmul(x, w) for w in wdq], iters=iters)
                nbytes = m * k * 2 + self._lin_bytes(lin) + m * n * 2
                extra = {"form": {"path": p.path, "rows": p.mt, "split": p.split}}
                if m in FORCED_MS and what != "gate_proj":
                    extra["forced_ms"] = self._kernel1_forms(torch, x, lins, ref, tol, what)
                self._record("qmm", f"{what} {k}x{n} M={m}", err, tol, ms, pms, lms, nbytes,
                             2 * m * k * n, main=(what == "q_proj" and m == 1),
                             serve=(what == "q_proj" and m == 8), path=path,
                             ulps=bf16_ulps(torch, y, ref) if exact else None, extra=extra)
            del lins, wdq
        self._qmm_tile_cases(torch, rng)
        k, n = 4096, 11008
        gates = self._linears(torch, rng, k, n, copies_for(k * n))
        ups = self._linears(torch, rng, k, n, len(gates))
        for m in ms_of:
            self._kernel2_row(torch, randn, gates, ups, m, 60 if m <= 136 else 6,
                              main=(m == 1), serve=(m == 8))
        del gates, ups
        # kernels 3-5: tolerance 1e-2 of each output row's norm: both sides
        # softmax in fp32, the output is rounded to bf16 (2^-9 relative);
        # kernel 5 also rounds p to bf16. Kernel 3 runs over caches holding NaN
        # past each offset (the plain version, whose zero weights would carry a
        # NaN, reads the clean copy); the offset-2047, GQA and serving rows also
        # hold and time the plan forced to chunks of 64 to 512 slots
        d, s = 128, 2048
        serving = (37, 150, 300, 511, 512, 900, 1200, 1500)   # kernel 7's mixed row, dense
        for b, h, hkv, offs in ((1, 32, 32, 0), (1, 32, 32, 127), (1, 32, 32, 2047),
                                (2, 32, 8, (100, 1500)), (8, 32, 32, serving)):
            ncopy = copies_for(2 * b * s * hkv * d * 2)
            q = randn(b, 1, h, d)
            caches = [(randn(b, s, hkv, d), randn(b, s, hkv, d)) for _ in range(ncopy)]
            off_t = torch.tensor(offs if isinstance(offs, tuple) else [offs] * b,
                                 dtype=torch.int32, device="cuda")
            # a host int, as the runner passes it, except for per-row offsets;
            # the serving row also passes the engine's host-side bound
            off_arg = off_t if isinstance(offs, tuple) else offs
            max_live = max(offs) + 1 if offs == serving else None
            kc, vc = caches[0]
            dead = (torch.arange(s, device="cuda")[None, :] > off_t[:, None])[:, :, None, None]
            pk, pv = kc.masked_fill(dead, float("nan")), vc.masked_fill(dead, float("nan"))
            y = decode_attention_cuda(q, pk, pv, off_arg, d ** -0.5, max_live)
            ref = decode_attention_plain(q, kc, vc, off_t, d ** -0.5)
            torch.cuda.synchronize()
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"decode_attention offsets {offs}: a slot past the offset "
                                     f"was read")
            plan = attention.plan_for(q, kc, off_arg, max_live)
            extra = self._plan_log(plan, hkv, [min(o, s - 1) + 1 for o in off_t.tolist()])
            forced = {}
            if offs in (2047, (100, 1500), serving):
                bound = s if max_live is None else max_live   # the live bound of these rows
                for chunk in (64, 128, 192, 256, 512):
                    forced[chunk] = attention.DecodePlan(-(-bound // chunk), chunk)
                    yf = attention._decode_launch(q, pk, pv, off_arg, d ** -0.5, forced[chunk])
                    torch.cuda.synchronize()
                    if not (torch.isfinite(yf.float()).all() and row_rel_err(yf, ref) <= 1e-2):
                        raise AssertionError(f"decode_attention offsets {offs}, plan forced to "
                                             f"{chunk}-slot chunks: disagrees with the plain "
                                             f"version ({row_rel_err(yf, ref)})")
            del pk, pv
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            ms = graph_ms(torch, [lambda c=c: decode_attention_cuda(q, c[0], c[1], off_arg,
                                                                    d ** -0.5, max_live)
                                  for c in caches])
            pms = graph_ms(torch, [lambda c=c: decode_attention_plain(q, c[0], c[1], off_t,
                                                                      d ** -0.5)
                                   for c in caches], iters=10)
            live = torch.arange(s, device="cuda")[None, :] <= off_t[:, None]
            mask = live[:, None, None, :]
            qt = q.transpose(1, 2)
            gqa = {"enable_gqa": True} if h != hkv else {}
            lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                qt, c[0].transpose(1, 2), c[1].transpose(1, 2), attn_mask=mask, **gqa)
                for c in caches])
            live_slots = int((off_t.clamp(max=s - 1) + 1).sum().item())
            nbytes = 2 * b * h * d * 2 + live_slots * hkv * d * 2 * 2
            if forced:
                extra["forced_chunk_ms"] = {
                    chunk: graph_ms(torch, [lambda c=c, p=p: attention._decode_launch(
                        q, c[0], c[1], off_arg, d ** -0.5, p) for c in caches])
                    for chunk, p in forced.items()}
            self._record("decode_attention",
                         f"B={b} H={h} Hkv={hkv} S={s} offset={offs} (NaN past each offset)",
                         err, 1e-2, ms, pms, lms, nbytes, 4 * live_slots * h * d,
                         main=(h == hkv and offs == 127), row_rel=rel, ref_max=ref_max,
                         serve=(offs == serving), extra=extra)
            del caches
        # kernel 4, its offset a 1-element int32 tensor on the card (the form
        # every step's graph captures) and its plan bound offset + SQ (PR 11's
        # rows ran the same plans from a host offset): a 100-token prompt of
        # the runner over its 2048-slot cache, then what serving gives it. A
        # chunk of 128 at offsets 0, 128 and 512 over the off + 128 slots its
        # queries see (the paged gather) and over a whole cache; a bucket-512
        # prompt over its gathered 512 slots and over the dense cache; the
        # implicit 2048 bucket. Then the dense serving chunk as its graph runs
        # it: slot 5's row of a whole 8-slot cache through ``rows``, planned
        # for the bucket 1024. Every row also replays a graph captured at
        # offset 0 (and slot 0) at its own offset and slot, bit-equal to the
        # eager launch.
        b, h, hkv = 1, 32, 32
        for sq, off, skv, slots, bnd in ((100, 0, s, 1, None), (100, 128, s, 1, None),
                                         (128, 0, 128, 1, None), (128, 128, 256, 1, None),
                                         (128, 512, 640, 1, None), (128, 512, s, 1, None),
                                         (512, 0, 512, 1, None), (512, 0, s, 1, None),
                                         (2048, 0, s, 1, None), (100, 512, s, 8, 1024),
                                         (128, 512, s, 8, 1024)):
            bnd = off + sq if bnd is None else bnd
            ncopy = copies_for(2 * slots * skv * hkv * d * 2)
            q = randn(b, sq, h, d)
            caches = [(randn(slots, skv, hkv, d), randn(slots, skv, hkv, d))
                      for _ in range(ncopy)]
            kc, vc = caches[0]
            slot = slots - 3 if slots > 1 else 0
            rows = torch.tensor([slot], dtype=torch.int32, device="cuda") if slots > 1 else None
            off_t = torch.tensor([off], dtype=torch.int32, device="cuda")
            y = flash_prefill_blocked_cuda(q, kc, vc, off_t, d ** -0.5, bnd, rows)
            ref = flash_prefill_blocked_plain(q, kc[slot:slot + 1], vc[slot:slot + 1], off,
                                              d ** -0.5)
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            # a graph captured at offset 0 and slot 0, replayed at this row's
            g_off = torch.zeros(1, dtype=torch.int32, device="cuda")
            g_rows = None if rows is None else torch.zeros(1, dtype=torch.int32, device="cuda")
            replayed = graph_replay(torch, lambda: flash_prefill_blocked_cuda(
                q, kc, vc, g_off, d ** -0.5, bnd, g_rows),
                lambda: (g_off.fill_(off), g_rows is None or g_rows.fill_(slot)))
            if not torch.equal(replayed, y):
                raise AssertionError(f"kernel 4 SQ={sq} offset={off}: a graph replay at the "
                                     f"offset differs from the eager launch")
            iters = 60 if sq <= 128 else 6
            ms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_cuda(q, c[0], c[1], off_t,
                                                                         d ** -0.5, bnd, rows)
                                  for c in caches], iters=iters)
            pms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_plain(
                q, c[0], c[1], off_t, d ** -0.5, bnd, rows) for c in caches],
                iters=min(iters, 10))
            allowed = (torch.arange(skv, device="cuda")[None, :]
                       <= torch.arange(sq, device="cuda")[:, None] + off)
            qt = q.transpose(1, 2)
            lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                qt, c[0][slot:slot + 1].transpose(1, 2), c[1][slot:slot + 1].transpose(1, 2),
                attn_mask=allowed) for c in caches], iters=iters)
            pairs = sum(off + i + 1 for i in range(sq))
            nbytes = 2 * b * sq * h * d * 2 + b * (off + sq) * hkv * d * 2 * 2
            extra = {"body": flash_plan(sq, bnd - sq), "bound_keys": bnd,
                     "replay_bit_equal": True, "cache_rows": slots}
            if sq <= 512:
                for body in ("sync", "wgmma"):
                    extra[f"{body}_ms"] = graph_ms(torch, [
                        lambda c=c, body=body: flash_launch(q, c[0], c[1], off_t, d ** -0.5, body,
                                                            rows)
                        for c in caches], iters=iters)
                log(f"[kernel flash_prefill_blocked] SQ={sq} offset={off} SKV={skv} rows={slots} "
                    f"bound={bnd}: bodies forced, mma.sync {extra['sync_ms'] * 1e3:.2f} us, "
                    f"wgmma {extra['wgmma_ms'] * 1e3:.2f} us (plan: {extra['body']}) | "
                    f"{self.card}")
            if sq == skv == 2048:   # kernel 5 computes the same function: same run, same inputs
                k5 = graph_ms(torch, [lambda c=c: flash_prefill_cuda(q, c[0], c[1], d ** -0.5)
                                      for c in caches], iters=iters)
                extra["kernel5_ms"] = k5
                self.sq2048 = {"shape": f"B={b} SQ=SKV={sq} H={h} offset 0", "ms": ms,
                               "kernel5_ms": k5, "library_ms": lms}
                log(f"[kernel flash_prefill_blocked] SQ=SKV={sq} offset 0: kernel 4 "
                    f"{ms * 1e3:.2f} us, kernel 5 {k5 * 1e3:.2f} us at the same shape "
                    f"({ms / k5:.3f}x) | {self.card}")
            where = "" if slots == 1 else f" slot {slot} of {slots} bound={bnd}"
            self._record("flash_prefill_blocked", f"B={b} SQ={sq} H={h} Hkv={hkv} "
                         f"SKV={skv} offset={off}{where} (device offset)", err, 1e-2, ms, pms,
                         lms, nbytes, 4 * b * h * pairs * d, main=(sq == 100 and off == 0),
                         row_rel=rel, ref_max=ref_max, serve=(sq == 128 and slots > 1),
                         extra=extra)
            del caches
        self._kernel5(torch, F, randn)
        self._kernel6(torch, F, randn)
        self._kernel7(torch, F, gen)
        self._kernel8(torch, rng, randn)
        self._kernel9(torch, F, randn)
        self._ppl_eval_linears(torch, rng, randn)
        torch.cuda.synchronize()

    def _kernel1_forms(self, torch, x, lins, ref, tol, what):
        """Kernel 1 with every form it has forced (the GEMV, the fragment form
        up to 16 rows where the package has it, the tiles) at x's rows: each
        held to the plain version within ``tol`` (2e-2 * max|plain|), timed
        over the weight copies; the forms' times are logged and returned."""
        from gptq_for_llama_tpu_torch.ops.cuda import matmul
        lin = lins[0]
        m, k, n = x.shape[0], lin.in_features, lin.out_features
        sms = matmul._sm_count(0)
        tol = max(tol, 2e-2 * ref.float().abs().max().item())
        forms = ("gemv", "frag", "tile") if hasattr(matmul, "frag_cols") else ("gemv", "tile")
        forced = {}
        for path in forms:
            fp = matmul.plan(m, k, n, lin.bits, sms, path=path)
            err = (matmul._launch(x, lin, fp).float() - ref.float()).abs().max().item()
            if err > tol:
                raise AssertionError(f"qmm {what} M={m} ({path} forced): error {err} > {tol}")
            forced[path] = graph_ms(torch, [lambda l=l, fp=fp: matmul._launch(x, l, fp)
                                            for l in lins])
        log(f"[kernel qmm] {what} {k}x{n} M={m}: forms forced "
            + ", ".join(f"{a} {t * 1e3:.2f} us" for a, t in forced.items()) + f" | {self.card}")
        return forced

    def _kernel2_row(self, torch, randn, gates, ups, m, iters, main=False, serve=False):
        """Kernel 2 at 4096 x 11008 and M rows through the dispatch (the plan's
        form), then every form it has (GEMV, the fragment form up to 16 rows,
        the tiles), forced, each held to the plain version and timed, and
        kernel 1 run twice at the same shape (the unfused gate and up). The
        tolerance is 2e-2 * max|plain| (kernel 1's: the GEMV keeps the weight
        in fp32, the tensor-core forms sum in another order), and 1e-2 of each
        row's norm; the worst row's gap between each tensor-core form and the
        forced GEMV is logged (tests/test_torch_cuda.py's GEMV_GAP)."""
        from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda
        from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp_cuda, fused_mlp_plain
        k, n = gates[0].in_features, gates[0].out_features
        x = randn(m, k)
        pairs = list(zip(gates, ups))
        y = fused_mlp_cuda(x, gates[0], ups[0])
        p = mlp.plan_for(x, gates[0])
        ref = fused_mlp_plain(x, gates[0], ups[0])
        err = (y.float() - ref.float()).abs().max().item()
        tol = 2e-2 * ref.float().abs().max().item()
        rel = row_rel_err(y, ref)
        if rel > 1e-2:
            raise AssertionError(f"fused_mlp M={m}: worst row {rel} of its norm off the plain "
                                 f"version")
        ms = graph_ms(torch, [lambda g=g, u=u: fused_mlp_cuda(x, g, u) for g, u in pairs],
                      iters=iters)
        pms = graph_ms(torch, [lambda g=g, u=u: fused_mlp_plain(x, g, u) for g, u in pairs],
                       iters=min(iters, 10))
        sms = matmul._sm_count(0)
        forced, gap, outs = {}, {}, {}
        for path in ("gemv", "frag", "tile"):
            if path == "frag" and m > matmul.FRAG_MAX_M:
                continue
            fp = matmul.plan(m, k, n, 4, sms, streams=2, path=path)
            outs[path] = mlp._launch(x, gates[0], ups[0], fp)
            frel = row_rel_err(outs[path], ref)
            if frel > 1e-2:
                raise AssertionError(f"fused_mlp M={m} ({path} forced): worst row {frel}")
            forced[path] = graph_ms(torch, [lambda g=g, u=u, fp=fp: mlp._launch(x, g, u, fp)
                                            for g, u in pairs],
                                    iters=iters if path != "gemv" or m <= 136 else 2)
        for path in ("frag", "tile"):
            if path in outs:
                gap[path] = row_rel_err(outs[path], outs["gemv"])
        k1 = 2 * graph_ms(torch, [lambda g=g: qmm_cuda(x, g) for g in gates], iters=iters)
        extra = {"form": {"path": p.path, "rows": p.mt, "split": p.split},
                 "forced_ms": forced, "gap_to_gemv": gap, "kernel1_x2_ms": k1}
        log(f"[kernel fused_mlp] M={m}: forms forced "
            + ", ".join(f"{a} {t * 1e3:.2f} us" for a, t in forced.items())
            + f"; kernel 1 twice at {k}x{n} {k1 * 1e3:.2f} us; worst row vs the forced GEMV "
            + ", ".join(f"{a} {g:.3e}" for a, g in gap.items()) + f" | {self.card}")
        nbytes = m * k * 2 + 2 * self._lin_bytes(gates[0]) + m * n * 2
        self._record("fused_mlp", f"gate+up {k}x{n} M={m}", err, tol, ms, pms, None, nbytes,
                     4 * m * k * n, main=main, serve=serve, path=p.path, row_rel=None,
                     extra=dict(extra, row_rel_plain=rel))
        del x, y, ref, outs

    def _qmm_tile_cases(self, torch, rng):
        """Kernel 1's tile path on ragged cases through the dispatch (no
        timing): 2, 4 and 8 bits and wire INT3; groupsize 40 (at 2 bits a
        group boundary inside a packed word), a ragged K slab (520, 560), G =
        1, groupsize 6 (scales from device memory); act-order, a bias, a ragged
        column tile and N = 11008; row tiles of 64 (M = 40), 128 (M = 100,
        512) and 256 (M = 130, 200, 256). Where the plan splits K, held to the
        plain version at 2e-2 * max|y|; where it does not (the last five
        cases, wide enough to fill the card), the product is bit-equal (with
        a bias, on the same linear without it: the plain version rounds the
        product to bf16 before adding the bias)."""
        import dataclasses
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import plan_for, qmm_cuda
        from gptq_for_llama_tpu_torch.ops.linear import PackedLinear, quant_matmul_plain
        from gptq_for_llama_tpu_torch.ops.quant_matmul import quant_matmul
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_linear
        rows = []
        for bits, m, k, n, gs, actorder, bias in (
                (4, 100, 1024, 512, 128, False, False), (2, 130, 1024, 256, 64, False, False),
                (8, 512, 512, 264, 128, False, False), (3, 130, 512, 256, 128, False, False),
                (4, 100, 520, 256, 40, False, False), (2, 130, 560, 256, 40, False, False),
                (4, 512, 1024, 256, 1024, False, False), (4, 130, 1024, 256, 128, True, False),
                (4, 100, 1024, 256, 128, False, True), (4, 130, 4096, 11008, 128, False, False),
                (4, 100, 512, 128, 6, False, False), (8, 512, 1024, 512, 32, True, True),
                (4, 40, 520, 256, 40, False, True), (8, 200, 1024, 264, 128, True, False),
                (2, 256, 560, 512, 40, True, True),
                (4, 1024, 1024, 4096, 128, False, False), (2, 1024, 560, 4096, 40, False, False),
                (8, 1024, 1024, 4104, 32, True, True), (4, 2048, 512, 4096, 1024, False, False),
                (3, 300, 1024, 8192, 128, False, True)):
            w = random_wire_linear(rng, k, n, gs, bits)
            if actorder:
                w["g_idx"] = w["g_idx"][rng.permutation(k)]
            lin = PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"],
                                         bits=bits, bias=rng.randn(n) if bias else None,
                                         dtype=torch.bfloat16, device="cuda")
            x = torch.as_tensor(rng.randn(m, k), dtype=torch.bfloat16, device="cuda")
            before = qmm_cuda.launches
            y = quant_matmul(x, lin)
            p = plan_for(x, lin)
            path = p.path if qmm_cuda.launches == before + 1 else None
            ref = quant_matmul_plain(x, lin)
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2e-2 * ref.float().abs().max().item()
            ok = path == "tile" and bool(torch.isfinite(y.float()).all()) and err <= tol
            ulps = None
            if p.split == 1:
                bare = dataclasses.replace(lin, bias=None)
                ulps = bf16_ulps(torch, quant_matmul(x, bare), quant_matmul_plain(x, bare))
                ok = ok and ulps == 0
            what = (f"bits {bits} M={m} K={k} N={n} groupsize {gs}"
                    f"{' act-order' if actorder else ''}{' bias' if bias else ''}")
            held = "" if ulps is None else f", product {ulps} bf16 ulp (tol 0)"
            log(f"[kernel qmm] tile case {what} [{path}, split {p.split}]: max_abs_err {err:.3e} "
                f"(tol {tol:.3e}){held} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"qmm tile case {what}: path {path}, error {err} > {tol} "
                                     f"or {ulps} bf16 ulp")
            rows.append({"case": what, "path": path, "split": p.split, "max_abs_err": err,
                         "tol": tol, "product_bf16_ulps": ulps})
        self.report["qmm_tile_cases"] = rows

    def _kernel5(self, torch, F, randn):
        """Kernel 5 at the shapes of 7B quantization and eval: one window, the
        calibration forward (16 windows, the CLI's --chunk) and the eval batch
        (8 windows), then GQA, a ragged S, serving's batched admissions (8
        slots at buckets 32 and 128) and the LoRA step's forward (2 x 512).
        Tolerance 1e-2 of each output row's norm, as kernels 3-4. Each row
        names the body its plan takes; the rows of up to 512 queries also time
        both bodies forced (the plan's threshold)."""
        from gptq_for_llama_tpu_torch.ops.cuda import flash_prefill as fp
        from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import (flash_prefill_cuda,
                                                                     flash_prefill_plain)
        d = 128
        for b, s, h, hkv, what in ((1, 2048, 32, 32, "one window"),
                                   (16, 2048, 32, 32, "calibration chunk"),
                                   (8, 2048, 32, 32, "eval batch"), (1, 2048, 32, 8, "GQA"),
                                   (1, 1000, 32, 32, "ragged"),
                                   (8, 32, 32, 32, "admission, bucket 32"),
                                   (8, 128, 32, 32, "admission, bucket 128"),
                                   (2, 512, 32, 32, "LoRA forward")):
            ncopy = copies_for(b * s * (2 * h + 2 * hkv) * d * 2)
            ins = [(randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d))
                   for _ in range(ncopy)]
            q, k, v = ins[0]
            y = flash_prefill_cuda(q, k, v, d ** -0.5)
            ref = flash_prefill_plain(q, k, v, d ** -0.5)
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            del y, ref
            ms = graph_ms(torch, [lambda t=t: flash_prefill_cuda(*t, d ** -0.5) for t in ins],
                          iters=20)
            pms = graph_ms(torch, [lambda t=t: flash_prefill_plain(*t, d ** -0.5)
                                   for t in ins[:1]], iters=1 if b > 8 else 2)
            gqa = {"enable_gqa": True} if h != hkv else {}
            lms = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2), t[2].transpose(1, 2),
                is_causal=True, **gqa) for t in ins], iters=20)
            pairs = s * (s + 1) // 2   # the causal half, diagonal included
            nbytes = b * s * (2 * h + 2 * hkv) * d * 2
            extra = {"body": fp.plan(s)}
            if s <= 512:
                for body in ("sync", "wgmma"):
                    extra[f"{body}_ms"] = graph_ms(torch, [
                        lambda t=t, body=body: fp._launch(*t, d ** -0.5, body) for t in ins],
                        iters=20)
                log(f"[kernel flash_prefill] {what} B={b} S={s}: bodies forced, mma.sync "
                    f"{extra['sync_ms'] * 1e3:.2f} us, wgmma {extra['wgmma_ms'] * 1e3:.2f} us "
                    f"(plan: {extra['body']}) | {self.card}")
            self._record("flash_prefill", f"{what} B={b} S={s} H={h} Hkv={hkv}", err, 1e-2,
                         ms, pms, lms, nbytes, 4 * b * h * pairs * d, main=(b == 8 and s == 2048),
                         row_rel=rel, ref_max=ref_max, serve=(b == 8 and s == 128), extra=extra)
            del ins
            torch.cuda.empty_cache()

    def _kernel6(self, torch, F, randn):
        """Kernel 6 at 7B's width: the decode step (M = 1), the serving decode
        step (8 slots), a prompt (100) and the eval batch (16384 rows), alone
        and in the residual form (h = x + r, y = RMSNorm(h), one launch: every
        norm of the stack but layer 0's input norm). y is held to 1 bf16 ulp
        of its plain version (the sum of squares is taken in another order;
        the rest is the same fp32 arithmetic, rounded once), h bit-equal to
        torch's add. The residual form's library call is ``x + r`` followed by
        ``F.rms_norm``, both timed. Inputs cycle through at most 8 copies: a
        norm's input was written by the kernel before it, so the caller finds
        it in the L2 unless it is larger. Then the launch floor: an empty
        kernel timed the same way."""
        from gptq_for_llama_tpu_torch.ops.cuda import norm
        from gptq_for_llama_tpu_torch.ops.cuda.norm import rms_norm_cuda, rms_norm_plain
        h, eps = 4096, 1e-6
        w = (1 + 0.1 * randn(h).float()).bfloat16()
        lib = getattr(F, "rms_norm", None)
        for m in (1, 8, 100, 16384):
            iters = 60 if m <= 100 else 6
            xs = [randn(m, h, scale=3.0) for _ in range(min(8, copies_for(2 * m * h * 2)))]
            y = rms_norm_cuda(xs[0], w, eps)
            ref = rms_norm_plain(xs[0], w, eps)
            torch.cuda.synchronize()
            ulps = bf16_ulps(torch, y, ref)
            err = (y.float() - ref.float()).abs().max().item()
            ms = graph_ms(torch, [lambda x=x: rms_norm_cuda(x, w, eps) for x in xs], iters=iters)
            pms = graph_ms(torch, [lambda x=x: rms_norm_plain(x, w, eps) for x in xs],
                           iters=iters)
            lms = None if lib is None else graph_ms(
                torch, [lambda x=x: lib(x, (h,), w, eps) for x in xs], iters=iters)
            self._record("rms_norm", f"M={m} H={h}", err, 1, ms, pms, lms,
                         2 * m * h * 2 + h * 2, 4 * m * h, ulps=ulps, path="alone")
            del xs
            xrs = [(randn(m, h, scale=3.0), randn(m, h))
                   for _ in range(min(8, copies_for(4 * m * h * 2)))]
            hs, y = norm.add_rms_norm_cuda(*xrs[0], w, eps)
            ref_h, ref = norm.add_rms_norm_plain(*xrs[0], w, eps)
            torch.cuda.synchronize()
            h_ulps, ulps = bf16_ulps(torch, hs, ref_h), bf16_ulps(torch, y, ref)
            if h_ulps != 0:
                raise AssertionError(f"rms_norm add M={m}: h is {h_ulps} bf16 ulp off x + r")
            err = (y.float() - ref.float()).abs().max().item()
            ms = graph_ms(torch, [lambda a=a, b=b: norm.add_rms_norm_cuda(a, b, w, eps)
                                  for a, b in xrs], iters=iters)
            pms = graph_ms(torch, [lambda a=a, b=b: norm.add_rms_norm_plain(a, b, w, eps)
                                   for a, b in xrs], iters=iters)
            lms = None if lib is None else graph_ms(
                torch, [lambda a=a, b=b: lib(a + b, (h,), w, eps) for a, b in xrs], iters=iters)
            # what the path ran before the add moved into the norm: torch's
            # add, then the kernel alone
            before = graph_ms(torch, [lambda a=a, b=b: rms_norm_cuda(a + b, w, eps)
                                      for a, b in xrs], iters=iters)
            log(f"[kernel rms_norm] M={m}: x + r then the kernel alone {before * 1e3:.2f} us")
            self._record("rms_norm", f"M={m} H={h} + residual", err, 1, ms, pms, lms,
                         4 * m * h * 2 + h * 2, 5 * m * h, main=(m == 8), ulps=ulps,
                         serve=(m == 8), path="add",
                         extra={"h_bf16_ulps": h_ulps, "add_then_alone_ms": before})
            del xrs
        dev = torch.device("cuda")
        floor = graph_ms(torch, [lambda: norm.launch_floor(dev)], iters=60)
        log(f"[kernel rms_norm] launch floor (an empty kernel, one block of one warp, timed "
            f"as the rows above): {floor * 1e3:.2f} us | {self.card}")
        self.report["launch_floor_ms"] = floor

    def _kernel7(self, torch, F, gen):
        """Kernel 7 at the serving shapes: 8 slots, block 16, 128 blocks per
        slot (2048 slots), the tables a random permutation of the pool (no two
        logical neighbours are physical neighbours). The pool is POISONED: NaN
        in every block no row owns and in every slot past a row's offset, so a
        kernel that read one would return NaN. Tolerance 1e-2 of each output
        row's norm, as kernel 3. The library call is the gather through the
        tables plus SDPA under the live mask, both inside the timed region, on
        a copy of the pool taken before the poison (0 x NaN is NaN in SDPA's
        weighted sum, and zeroing the dead slots would be timed work that the
        library call does not need). Each launch of a timed run reads another
        region of the pool (copies larger than the L2). Each row also runs
        kernel 3 over the gathered dense view of the same pool, which kernel
        7 must equal bit for bit (one body, one plan), and times it beside."""
        from gptq_for_llama_tpu_torch.ops.cuda import attention
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention_cuda,
                                                                 pool_decode_attention_cuda,
                                                                 pool_decode_attention_plain)
        b, h, d, bs, mb = 8, 32, 128, 16, 128
        bf = torch.bfloat16
        mixed = (37, 150, 300, 511, 512, 900, 1200, 1500)
        for hkv, offs, what in ((32, (127,) * b, "offsets 127"), (32, (2047,) * b, "offsets 2047"),
                                (32, mixed, "offsets 37..1500"), (8, mixed, "GQA, offsets 37..1500")):
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            live_slots = int((off + 1).sum().item())
            live_bytes = live_slots * hkv * d * 2 * 2
            ncopy = copies_for(live_bytes)
            nb = ncopy * b * mb + 1
            kp = (torch.randn(nb, bs, hkv, d, generator=gen, device="cuda", dtype=bf))
            vp = (torch.randn(nb, bs, hkv, d, generator=gen, device="cuda", dtype=bf))
            q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(bf)
            perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1   # block 0: scratch
            tables = [perm[i * b * mb:(i + 1) * b * mb].reshape(b, mb).int().contiguous()
                      for i in range(ncopy)]
            # poison: every slot past its row's offset, and the scratch block
            # (the one block no row owns: the permutation hands out all others)
            dead = (torch.arange(mb * bs, device="cuda")[None, :] > off[:, None]).reshape(b, mb, bs)
            dead_pool = torch.zeros(nb, bs, dtype=torch.bool, device="cuda")
            dead_pool[0] = True
            for t in tables:
                dead_pool[t.long()] = dead
            kp_clean, vp_clean = kp.clone(), vp.clone()
            kp[dead_pool] = float("nan")
            vp[dead_pool] = float("nan")
            max_live = max(offs) + 1   # the engine's host-side bound
            y = pool_decode_attention_cuda(q, kp, vp, tables[0], off, d ** -0.5, max_live)
            ref = pool_decode_attention_plain(q, kp, vp, tables[0], off, d ** -0.5)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(ref.float()).all()):
                raise AssertionError(f"pool_decode_attention {what}: a poisoned slot was read")
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            ms = graph_ms(torch, [lambda t=t: pool_decode_attention_cuda(
                q, kp, vp, t, off, d ** -0.5, max_live) for t in tables])
            pms = graph_ms(torch, [lambda t=t: pool_decode_attention_plain(
                q, kp, vp, t, off, d ** -0.5) for t in tables], iters=10)
            mask = (torch.arange(mb * bs, device="cuda")[None, :] <= off[:, None])[:, None, None, :]
            qt = q.transpose(1, 2)
            gqa = {"enable_gqa": True} if h != hkv else {}

            def library(t):
                idx = t.long()
                kd = kp_clean[idx].reshape(b, mb * bs, hkv, d)
                vd = vp_clean[idx].reshape(b, mb * bs, hkv, d)
                return F.scaled_dot_product_attention(qt, kd.transpose(1, 2), vd.transpose(1, 2),
                                                      attn_mask=mask, **gqa)

            lib_err = row_rel_err(library(tables[0]).transpose(1, 2), ref)
            if not lib_err <= 1e-2:
                raise AssertionError(f"pool_decode_attention {what}: the library yardstick "
                                     f"computes another function ({lib_err})")
            lms = graph_ms(torch, [lambda t=t: library(t) for t in tables], iters=10)
            views = [(kp[t.long()].reshape(b, mb * bs, hkv, d),
                      vp[t.long()].reshape(b, mb * bs, hkv, d)) for t in tables]
            y3 = decode_attention_cuda(q, views[0][0], views[0][1], off, d ** -0.5, max_live)
            torch.cuda.synchronize()
            if not torch.equal(y, y3):
                raise AssertionError(f"pool_decode_attention {what}: differs from kernel 3 over "
                                     f"the gathered view ({row_rel_err(y, y3)})")
            k3 = graph_ms(torch, [lambda c=c: decode_attention_cuda(q, c[0], c[1], off, d ** -0.5,
                                                                    max_live) for c in views])
            plan = attention.pool_plan_for(q, kp, tables[0], max_live)
            extra = dict(self._plan_log(plan, hkv, [o + 1 for o in offs]),
                         kernel3_gathered_ms=k3, equal_to_kernel3=True)
            log(f"[kernel pool_decode_attention] {what}: kernel 7 {ms * 1e3:.2f} us, kernel 3 "
                f"over the gathered view {k3 * 1e3:.2f} us ({ms / k3:.3f}x), outputs equal "
                f"| {self.card}")
            self._record("pool_decode_attention",
                         f"B={b} H={h} Hkv={hkv} BS={bs} MB={mb} {what}", err, 1e-2, ms, pms, lms,
                         2 * b * h * d * 2 + live_bytes + b * 4 + live_slots // bs * 4,
                         4 * live_slots * h * d, main=(hkv == 32 and offs == mixed),
                         row_rel=rel, ref_max=ref_max, serve=(hkv == 32 and offs == mixed),
                         extra=extra)
            del kp, vp, kp_clean, vp_clean, tables, views
            torch.cuda.empty_cache()

    def _kernel8(self, torch, rng, randn):
        """Kernel 8, the grad-input of the packed linears, at the LoRA phase's
        training batch (M = 1024 tokens), at 2048 and at the gradient check's
        128: q_proj's 4096 x 4096, down_proj's transpose (dx of width K =
        11008 from g of width 4096) and gate/up's (K = 4096 from N = 11008),
        plus one act-order linear through the dispatch (the inverse
        permutation). Tolerance 2e-2 of each output row's norm: both sides use
        the same bf16 weight (bit-equal dequantization) and accumulate in fp32
        in another order; the plain matmul rounds to bf16 at the end, as the
        kernel does. Then g = I on q_proj's linear: dx = W^T bit-exactly when
        the kernel's dequantized slices are bit-equal to
        PackedLinear.dequantize."""
        from gptq_for_llama_tpu_torch.ops.cuda.matmul_t import (plan_for, qmm_t_cuda,
                                                                quant_matmul_t,
                                                                quant_matmul_t_plain)
        from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_linear
        bf = torch.bfloat16
        for k, n, what in ((4096, 4096, "q_proj"), (11008, 4096, "down_proj^T"),
                           (4096, 11008, "gate/up^T")):
            lins = self._linears(torch, rng, k, n, copies_for(k * n // 2))
            wdq = [lins[0].dequantize(bf) for _ in range(copies_for(k * n * 2))]
            for m in (128, 1024, 2048):
                g = randn(m, n)
                y = qmm_t_cuda(g, lins[0])
                ref = quant_matmul_t_plain(g, lins[0])
                err = (y.float() - ref.float()).abs().max().item()
                rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
                iters = 20 if m <= 128 else 6
                ms = graph_ms(torch, [lambda l=l: qmm_t_cuda(g, l) for l in lins], iters=iters)
                pms = graph_ms(torch, [lambda l=l: quant_matmul_t_plain(g, l) for l in lins],
                               iters=6)
                lms = graph_ms(torch, [lambda w=w: torch.matmul(g, w.T) for w in wdq],
                               iters=iters)
                p = plan_for(g, lins[0])
                nbytes = m * n * 2 + self._lin_bytes(lins[0]) + m * k * 2
                self._record("qmm_t", f"{what} dx = g @ W^T, K={k} N={n} M={m}", err, 2e-2, ms,
                             pms, lms, nbytes, 2 * m * k * n, main=(what == "q_proj" and m == 1024),
                             row_rel=rel, ref_max=ref_max,
                             extra={"row_tile": p.mt, "split": p.split,
                                    "bit_equal": bool(torch.equal(y, ref))})
            if what == "q_proj":
                eye = torch.eye(n, device="cuda", dtype=bf)
                if not torch.equal(qmm_t_cuda(eye, lins[0]), wdq[0].T.contiguous()):
                    raise AssertionError("qmm_t: g = I does not give W^T: the dequantized "
                                         "slices differ from PackedLinear.dequantize")
                log(f"[kernel qmm_t] g = I, K={k} N={n}: dx == dequantize(W)^T bit-exactly ok")
            del lins, wdq
        # act-order: rows group-sorted on the device, the dispatch un-permutes
        w = random_wire_linear(rng, 4096, 4096, 128, 4)
        w["g_idx"] = w["g_idx"][rng.permutation(4096)]
        lin = PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"], bits=4,
                                     dtype=bf, device="cuda")
        g = randn(1024, 4096)
        y = quant_matmul_t(g, lin)
        ref = quant_matmul_t_plain(g, lin)[:, torch.argsort(lin.perm)]
        err = (y.float() - ref.float()).abs().max().item()
        rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
        ms = graph_ms(torch, [lambda: quant_matmul_t(g, lin)], iters=6)
        pms = graph_ms(torch, [lambda: quant_matmul_t_plain(g, lin)[:, torch.argsort(lin.perm)]],
                       iters=6)
        wd = lin.dequantize(bf)[torch.argsort(lin.perm)]
        lms = graph_ms(torch, [lambda: torch.matmul(g, wd.T)], iters=6)
        self._record("qmm_t", "q_proj act-order (dispatch, inverse perm) K=4096 N=4096 M=1024",
                     err, 2e-2, ms, pms, lms, 1024 * 4096 * 4 + self._lin_bytes(lin),
                     2 * 1024 * 4096 * 4096, row_rel=rel, ref_max=ref_max)
        del lin, wd, g
        torch.cuda.empty_cache()

    def _kernel9(self, torch, F, randn):
        """Kernel 9, fold decode attention, at 7B's heads: B = 1 at offsets 0,
        127, 2047, GQA (Hkv = 8), and 8 serving slots at offsets 37..1500 with
        the engine's host-side bound; then the row write under a mixed mask.
        Every cache slot at and past a row's offset holds NaN, so a kernel that
        read one would return NaN. Tolerance 1e-2 of each output row's norm,
        as kernel 3; after the write both caches are byte-equal to the plain
        version's. The library call is SDPA over the cache with the current
        token written, under the live mask, on a poison-free copy."""
        from gptq_for_llama_tpu_torch.ops.cuda import attention
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (fused_decode_attention_cuda,
                                                                 fused_decode_attention_plain)
        d, s = 128, 2048
        serving = (37, 150, 300, 511, 512, 900, 1200, 1500)
        for b, h, hkv, offs in ((1, 32, 32, 0), (1, 32, 32, 127), (1, 32, 32, 2047),
                                (2, 32, 8, (100, 1500)), (8, 32, 32, serving)):
            ncopy = copies_for(2 * b * s * hkv * d * 2)
            q, kn, vn = randn(b, 1, h, d), randn(b, 1, hkv, d), randn(b, 1, hkv, d)
            off_t = torch.tensor(offs if isinstance(offs, tuple) else [offs] * b,
                                 dtype=torch.int32, device="cuda")
            off_arg = off_t if isinstance(offs, tuple) else offs
            max_live = max(offs) + 1 if offs == serving else None
            clean = [(randn(b, s, hkv, d), randn(b, s, hkv, d)) for _ in range(ncopy)]
            dead = (torch.arange(s, device="cuda")[None, :] >= off_t[:, None])[:, :, None, None]
            kc, vc = (c.masked_fill(dead, float("nan")) for c in clean[0])
            y, _, _ = fused_decode_attention_cuda(q, kc, vc, kn, vn, off_arg, d ** -0.5,
                                                  write=False, max_live=max_live)
            ref, _, _ = fused_decode_attention_plain(q, kc, vc, kn, vn, off_t, d ** -0.5,
                                                     write=False)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(ref.float()).all()):
                raise AssertionError(f"fused_decode_attention offsets {offs}: a slot at or past "
                                     f"the offset was read")
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            ms = graph_ms(torch, [lambda c=c: fused_decode_attention_cuda(
                q, c[0], c[1], kn, vn, off_arg, d ** -0.5, write=False, max_live=max_live)
                for c in clean])
            pms = graph_ms(torch, [lambda c=c: fused_decode_attention_plain(
                q, c[0], c[1], kn, vn, off_t, d ** -0.5, write=False) for c in clean], iters=10)
            rows = torch.arange(b, device="cuda")
            for kk, vv in clean:   # the library reads the cache with the row written
                kk[rows, off_t.long()] = kn[:, 0]
                vv[rows, off_t.long()] = vn[:, 0]
            mask = (torch.arange(s, device="cuda")[None, :] <= off_t[:, None])[:, None, None, :]
            qt = q.transpose(1, 2)
            gqa = {"enable_gqa": True} if h != hkv else {}
            lib_err = row_rel_err(F.scaled_dot_product_attention(
                qt, clean[0][0].transpose(1, 2), clean[0][1].transpose(1, 2), attn_mask=mask,
                **gqa).transpose(1, 2), ref)
            if not lib_err <= 1e-2:
                raise AssertionError(f"fused_decode_attention: the library yardstick computes "
                                     f"another function ({lib_err})")
            lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                qt, c[0].transpose(1, 2), c[1].transpose(1, 2), attn_mask=mask, **gqa)
                for c in clean])
            stale = int(off_t.clamp(max=s - 1).sum().item())
            nbytes = 2 * b * h * d * 2 + (stale + b) * hkv * d * 2 * 2
            self._record("fused_decode_attention",
                         f"B={b} H={h} Hkv={hkv} S={s} offset={offs} (no write)", err, 1e-2, ms,
                         pms, lms, nbytes, 4 * (stale + b) * h * d,
                         main=(h == hkv and offs == 127), row_rel=rel, ref_max=ref_max,
                         serve=(offs == serving),
                         extra=self._plan_log(attention.plan_for(q, kc, off_arg, max_live, True),
                                              hkv, [min(o, s - 1) for o in off_t.tolist()]))
            del clean, kc, vc
        # the in-place row write under a mixed mask (serving slots; rows whose
        # mask is false keep their cache and still attend their current k/v)
        b, h = 8, 32
        off_t = torch.tensor(serving, dtype=torch.int32, device="cuda")
        q, kn, vn = randn(b, 1, h, d), randn(b, 1, h, d), randn(b, 1, h, d)
        dead = (torch.arange(s, device="cuda")[None, :] >= off_t[:, None])[:, :, None, None]
        kc, vc = (randn(b, s, h, d).masked_fill(dead, float("nan")) for _ in range(2))
        wk, wv = kc.clone(), vc.clone()
        wmask = torch.arange(b, device="cuda") % 3 != 1
        y, _, _ = fused_decode_attention_cuda(q, kc, vc, kn, vn, off_t, d ** -0.5,
                                              write_mask=wmask, max_live=max(serving) + 1)
        ref, _, _ = fused_decode_attention_plain(q, wk, wv, kn, vn, off_t, d ** -0.5,
                                                 write_mask=wmask)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int16), b_.view(torch.int16))
                   for a, b_ in ((kc, wk), (vc, wv)))
        if not same:
            raise AssertionError("fused_decode_attention: the caches after the masked write "
                                 "differ from the plain version's")
        err = (y.float() - ref.float()).abs().max().item()
        rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
        ms = graph_ms(torch, [lambda: fused_decode_attention_cuda(
            q, kc, vc, kn, vn, off_t, d ** -0.5, write_mask=wmask, max_live=max(serving) + 1)])
        pms = graph_ms(torch, [lambda: fused_decode_attention_plain(
            q, wk, wv, kn, vn, off_t, d ** -0.5, write_mask=wmask)], iters=10)
        stale = sum(serving)
        written = int(wmask.sum().item())
        nbytes = 2 * b * h * d * 2 + (stale + b) * h * d * 2 * 2 + written * h * d * 2 * 2
        self._record("fused_decode_attention", f"B={b} H={h} offsets 37..1500, write under the "
                     f"mask {wmask.int().tolist()} (caches byte-equal)", err, 1e-2, ms, pms, None,
                     nbytes, 4 * (stale + b) * h * d, row_rel=rel, ref_max=ref_max,
                     extra=self._plan_log(attention.plan_for(q, kc, off_t, max(serving) + 1,
                                                             True), h, serving))
        del kc, vc, wk, wv
        torch.cuda.empty_cache()

    def _ppl_eval_linears(self, torch, rng, randn):
        """Kernels 1-2 at the perplexity-eval M (8 windows x 2048 tokens);
        kernel 2's row carries kernel 1 run twice at its shape."""
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import plan_for, qmm_cuda
        from gptq_for_llama_tpu_torch.ops.linear import quant_matmul_plain
        bf, m = torch.bfloat16, 16384
        for k, n, what in ((4096, 4096, "q_proj"), (11008, 4096, "down_proj")):
            lin = self._linears(torch, rng, k, n, 1)[0]
            x = randn(m, k)
            y = qmm_cuda(x, lin)
            p = plan_for(x, lin)
            ref = quant_matmul_plain(x, lin, bf)
            err = (y.float() - ref.float()).abs().max().item()
            exact = p.path == "tile" and p.split == 1   # as phase_kernels' rows
            tol = 0 if exact else 2e-2 * ref.float().abs().max().item()
            ulps = bf16_ulps(torch, y, ref) if exact else None
            wdq = lin.dequantize(bf)
            ms = graph_ms(torch, [lambda: qmm_cuda(x, lin)], iters=2)
            pms = graph_ms(torch, [lambda: quant_matmul_plain(x, lin, bf)], iters=2)
            lms = graph_ms(torch, [lambda: torch.matmul(x, wdq)], iters=2)
            nbytes = m * k * 2 + self._lin_bytes(lin) + m * n * 2
            self._record("qmm", f"{what} {k}x{n} M={m}", err, tol, ms, pms, lms, nbytes,
                         2 * m * k * n, path=p.path, ulps=ulps)
            del x, y, ref, wdq
        k, n = 4096, 11008
        gate, up = (self._linears(torch, rng, k, n, 1)[0] for _ in range(2))
        self._kernel2_row(torch, randn, [gate], [up], m, 2)
        torch.cuda.empty_cache()

    # -- phase 4 ---------------------------------------------------------------
    def phase_e2e(self, torch):
        from gptq_for_llama_tpu_torch.convert import params_from_jax
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_tree

        cfg = ModelConfig(arch="llama", vocab_size=32000, hidden_size=4096,
                          intermediate_size=11008, num_layers=2, num_heads=32,
                          num_kv_heads=32, head_dim=128, max_seq_len=64)
        tree = random_wire_tree(cfg, seed=7)
        prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, 37)
        t0 = time.perf_counter()
        err, scale, agreed, compared = self._hold_to_cpu(
            torch, "e2e", "llama", cfg, params_from_jax(tree, "cuda", torch.bfloat16),
            params_from_jax(tree, "cpu", torch.float32), prompt, 8)
        self.report["e2e"] = {"max_abs_err": err, "max_abs_ref": scale, "rel_tol": 2e-2,
                              "tokens_compared": compared, "tokens_agreed": agreed,
                              "seconds": time.perf_counter() - t0}

    # -- phase 5 ---------------------------------------------------------------
    def phase_full(self, torch):
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
        from gptq_for_llama_tpu_torch.runtime.graphs import bucket_for
        from gptq_for_llama_tpu_torch.runtime.random_model import (gaussian_wire_llama,
                                                                   model_weight_bytes)

        cfg = ModelConfig(**LLAMA_7B)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # zero-mean codes, every layer its own draw: the logits depend on the
        # prompt, so the token checks of this phase and of ``serve`` are live
        params = gaussian_wire_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[full] 7B INT4-g128 random wire weights made in {time.perf_counter() - t0:.1f} s")
        self.model7b = (cfg, params)
        runner = ModelRunner("llama", cfg, params, dtype=torch.bfloat16, device="cuda")
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (37, 100, 201)]
        new = 64
        t0 = time.perf_counter()
        runner.warmup(prefill_buckets=tuple(len(p) for p in prompts))
        log(f"[full] warmup (the prefill graphs of the prompts' lengths, keys "
            f"{sorted(k for k in runner.graphs.keys() if k[0] == 'prefill')}; the one-step "
            f"decode graph of each bucket {runner.decode_buckets}) in "
            f"{time.perf_counter() - t0:.1f} s, of it {runner.graphs.capture_s:.1f} s capturing")
        prefills = self._prefill_graphs_vs_eager(torch, runner, prompts)

        # generate (spans of 32 through decode_sample_scan's graphs): the first
        # pass captures what warmup did not, the second only replays
        for rep in range(2):
            kernels.reset_launch_counts()
            f0, p0 = sum(runner.forwards.values()), runner.forwards["prefill"]
            r0 = dict(runner.graphs.replays)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [generate(runner, p, max_new_tokens=new, temperature=0.0) for p in prompts]
            torch.cuda.synchronize()
            t_gen = time.perf_counter() - t0
            counts = kernels.launch_counts()
            forwards = sum(runner.forwards.values()) - f0
            self.check_path("decode", counts)
            self.check_norms("full generate", counts, forwards, cfg.num_layers)
            replayed = sum(n - r0.get(k, 0) for k, n in runner.graphs.replays.items()
                           if k[0] == "prefill")
            if replayed != runner.forwards["prefill"] - p0:
                raise AssertionError(f"full: {runner.forwards['prefill'] - p0} prefill forwards, "
                                     f"{replayed} of them graph replays")
            if rep == 0:
                outs, t_first = got, t_gen
            elif any(not np.array_equal(a, b) for a, b in zip(outs, got)):
                raise AssertionError("full: two generate runs of the same prompts differ")
        log(f"[full] generate(span=32): 3 requests x {new} new tokens in {t_first:.2f} s with "
            f"the captures, {t_gen:.2f} s replaying ({t_gen / (3 * new) * 1e3:.3f} ms/token, "
            f"prefills included; each prefill a graph replay); launches {counts}")
        for p, o in zip(prompts, outs):
            if o.shape != (1, len(p) + new) or not ((o >= 0) & (o < cfg.vocab_size)).all():
                raise AssertionError(f"full: bad generate output {o.shape}")
        distinct = len(set(np.concatenate([np.asarray(o)[0, len(p):]
                                           for p, o in zip(prompts, outs)]).tolist()))
        log(f"[full] {distinct} distinct tokens among the {3 * new} generated")
        if distinct < 8:
            raise AssertionError("full: the model's tokens do not depend on the prompt")
        loop = self._graphs_vs_eager(torch, "full", runner, prompts, outs, new)

        # prefill logits, then the device time of one decode step: the bucket's
        # graph replayed at offset 164, the offsets reset before each replay
        cache = runner.init_cache()
        logits, cache = runner.prefill(torch.as_tensor(prompts[1][None], device="cuda"), cache)
        if not torch.isfinite(logits.float()).all() or logits.shape != (1, 100, cfg.vocab_size):
            raise AssertionError("full: prefill logits not finite / wrong shape")
        step_ids = logits[:, -1:].float().argmax(-1)
        offs = runner._store.offs

        def at(o):
            return lambda: offs.fill_(o)

        dev_ms = replay_ms(torch, runner.graphs, ("decode", 256), at(164))
        # the two plans: each offset's bucket, and the whole cache (bucket 2048)
        plans = {o: {"bucket": replay_ms(torch, runner.graphs,
                                         ("decode", bucket_for(o + 1, runner.decode_buckets)),
                                         at(o)),
                     "whole": replay_ms(torch, runner.graphs, ("decode", 2048), at(o))}
                 for o in (37, 1000, 2047)}
        cache = runner.init_cache()   # the offsets are the handle's again
        _, cache = runner.prefill(torch.as_tensor(prompts[1][None], device="cuda"), cache)
        peak = torch.cuda.max_memory_allocated()
        # the eager step's kernels, elementwise adds counted (a residual add
        # outside the norms would be 2 per layer), then the graph's replays
        self._profile_steps(torch, "full-profile", "eager decode steps of LLaMA-7B, 32 layers, "
                            "batch 1", lambda: runner._step(step_ids, cache), 2)
        self._profile_steps(torch, "full-graph-profile", "decode graph replays of LLaMA-7B, "
                            "32 layers, batch 1", lambda: runner.decode(step_ids, cache), 4)
        wbytes = model_weight_bytes(cfg)
        roof_tok_s = PEAK_BYTES_PER_S / wbytes
        graphs = {"count": len(runner.graphs), "capture_s": runner.graphs.capture_s,
                  "pool_bytes": runner.graphs.pool_bytes()}
        log(f"[full] decode: host loop {loop['eager_ms']:.3f} ms/token eager (the _step loop), "
            f"{loop['graph_ms']:.3f} ms/token through decode_greedy_scan's graphs, "
            f"{loop['span1_ms']:.3f} through generate(span=1) (one decode graph a token); the "
            f"device step as a graph {dev_ms:.3f} ms/token at offset 164 ({1e3 / dev_ms:.1f} "
            f"tok/s); roofline {roof_tok_s:.1f} tok/s ({wbytes} B/token at 3.35 TB/s): share "
            f"{1e3 / loop['graph_ms'] / roof_tok_s:.4f} (graph device step "
            f"{1e3 / dev_ms / roof_tok_s:.4f}); peak memory {peak / 2**30:.2f} GiB | {self.card}")
        bucket_ms = " / ".join(f"{plans[o]['bucket']:.3f}" for o in plans)
        whole_ms = " / ".join(f"{plans[o]['whole']:.3f}" for o in plans)
        log(f"[full] the decode step's two plans, ms at offsets 37 / 1000 / 2047: each offset's "
            f"bucket {bucket_ms}; the whole cache {whole_ms} | {self.card}")
        log(f"[full] graphs: {graphs['count']} captured, {graphs['capture_s']:.1f} s capturing "
            f"(warm calls included), pool {graphs['pool_bytes'] / 2**20:.1f} MiB; by kind "
            f"{runner.graphs.by_kind()} | {self.card}")
        log(f"[full] generate(span=32) {t_gen / (3 * new) * 1e3:.3f} ms/token (its prefills as "
            f"graphs) beside the scan's {loop['graph_ms']:.3f} ms/token | {self.card}")
        self.report["full"] = {"generate_s": t_gen, "generate_first_s": t_first,
                               "prefill": prefills, "graphs_by_kind": runner.graphs.by_kind(),
                               "launches": counts, "ms_per_token": loop["graph_ms"],
                               "eager_ms_per_token": loop["eager_ms"],
                               "span1_ms_per_token": loop["span1_ms"],
                               "generate_ms_per_token": t_gen / (3 * new) * 1e3,
                               "tok_s": 1e3 / loop["graph_ms"], "graph_ms_per_token": dev_ms,
                               "plans_ms": plans, "graphs": graphs,
                               "launches_per_decode_forward": loop["per_forward"],
                               "roofline_tok_s": roof_tok_s,
                               "roofline_share": 1e3 / loop["graph_ms"] / roof_tok_s,
                               "peak_memory_bytes": peak, "weight_bytes": wbytes}

    def _prefill_graphs_vs_eager(self, torch, runner, prompts):
        """Each prompt's prefill through its graph (captured by ``warmup``) and
        through the same body run eagerly (``_step``), then a second prefill
        of the first prompt at its own length's offset, which replays the
        graph captured at offset 0: the logits and every layer's cache below
        the offset bit-equal. Per prefill the host ms (a synchronized call)
        of both, the graph's device ms (CUDA events around replays at the
        same offset) and the eager call's ms on CUDA events."""
        from gptq_for_llama_tpu_torch.runtime.graphs import bucket_for
        from gptq_for_llama_tpu_torch.runtime.runner import prefill_len
        rows = {}
        offs = runner._store.offs
        cases = [(p, None) for p in prompts] + [(prompts[0], prompts[0])]
        for p, first in cases:
            ids = torch.as_tensor(p[None], device="cuda")
            times, seen = {}, {}
            for how in ("graph", "eager", "graph", "eager"):   # the second pass is timed
                cache = runner.init_cache()
                if first is not None:
                    _, cache = runner.prefill(torch.as_tensor(first[None], device="cuda"), cache)
                off = cache.offset
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                lg, cache = (runner.prefill if how == "graph" else runner._step)(ids, cache)
                end.record()
                torch.cuda.synchronize()
                times[how] = ((time.perf_counter() - t0) * 1e3, start.elapsed_time(end))
                seen[how] = (lg.clone(), [c[:, :cache.offset].contiguous().view(torch.uint8)
                                          for c in cache.k + cache.v])   # any cache dtype
            lg, cs = seen["graph"]
            le, ce = seen["eager"]
            if not torch.equal(lg, le) or not all(torch.equal(a, b) for a, b in zip(cs, ce)):
                raise AssertionError(f"full: the prefill graph of {len(p)} tokens at offset "
                                     f"{off} differs from its body run eagerly")
            s_pad = prefill_len(len(p), runner.max_len - off)
            key = ("prefill", s_pad, bucket_for(off + s_pad, runner.decode_buckets))
            dev = replay_ms(torch, runner.graphs, key, lambda o=off: offs.fill_(o), iters=4)
            name = f"{len(p)} at offset {off}"
            rows[name] = {"key": list(key), "graph_host_ms": times["graph"][0],
                          "graph_device_ms": dev, "eager_host_ms": times["eager"][0],
                          "eager_events_ms": times["eager"][1]}
            log(f"[full] prefill of {len(p)} tokens at offset {off} (graph {key}): graph "
                f"{times['graph'][0]:.3f} ms host, {dev:.3f} ms device; eager body "
                f"{times['eager'][0]:.3f} ms host ({times['eager'][1]:.3f} ms on events); "
                f"logits and cache below the offset bit-equal | {self.card}")
            del seen, lg, le, cs, ce
        return rows

    def _graphs_vs_eager(self, torch, label, runner, prompts, outs, new):
        """Every prompt's greedy tokens through the eager ``_step`` loop (the
        decode body, not captured), through ``decode_greedy_scan``'s graphs
        and through ``generate(span=1)`` (one decode graph a token): all equal
        to ``outs`` (generate with spans of 32), bit for bit, and kernel
        launches per decode forward equal between the eager loop and the
        graphs; ``forced_decode_scan`` over the same tokens ends on the eager
        loop's logits, bit for bit. Host ms/token of each, the scans' second
        pass (no capture)."""
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import generate
        per, ms, last = {}, {}, {}
        for rep in range(2):
            for how in ("eager", "graph"):
                launched, forwards, elapsed = {}, 0, 0.0
                for p, o in zip(prompts, outs):
                    lg, cache = runner.prefill(torch.as_tensor(p[None], device="cuda"),
                                               runner.init_cache())
                    tok = lg[:, -1:].float().argmax(-1)
                    torch.cuda.synchronize()
                    kernels.reset_launch_counts()
                    f0 = runner.forwards["decode"]
                    t0 = time.perf_counter()
                    if how == "eager":
                        toks = [tok]
                        for _ in range(new - 1):
                            lg, cache = runner._step(toks[-1], cache)
                            toks.append(lg[:, -1:].float().argmax(-1))
                        got = torch.cat(toks, 1).cpu().numpy()
                        last[len(p)] = lg   # teacher-forced by the first new - 1 tokens
                    else:
                        rest, cache = runner.decode_greedy_scan(tok, cache, new - 1)
                        got = torch.cat([tok, rest], 1).cpu().numpy()
                    elapsed += time.perf_counter() - t0
                    forwards += runner.forwards["decode"] - f0
                    for k, n in kernels.launch_counts().items():
                        launched[k] = launched.get(k, 0) + n
                    if not np.array_equal(got[0], o[0, len(p):]):
                        raise AssertionError(f"{label}: {how} tokens differ from generate's "
                                             f"for the {len(p)}-token prompt")
                per[how] = {k: n / forwards for k, n in launched.items() if n}
                ms[how] = elapsed / (len(prompts) * (new - 1)) * 1e3
        for p, o in zip(prompts, outs):   # forced_decode_scan's graphs end where the loop did
            _, cache = runner.prefill(torch.as_tensor(p[None], device="cuda"), runner.init_cache())
            ids = torch.as_tensor(o[:, len(p):len(p) + new - 1], device="cuda")
            lg, cache = runner.forced_decode_scan(ids, cache)
            if not torch.equal(lg.view(torch.int16), last[len(p)].view(torch.int16)):
                raise AssertionError(f"{label}: forced_decode_scan's last logits differ from the "
                                     f"eager loop's for the {len(p)}-token prompt")
        if per["eager"] != per["graph"]:
            raise AssertionError(f"{label}: launches per decode forward {per['graph']} through "
                                 f"the graphs, {per['eager']} eager")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, o in zip(prompts, outs):
            if not np.array_equal(generate(runner, p, max_new_tokens=new, temperature=0.0,
                                           span=1), o):
                raise AssertionError(f"{label}: generate(span=1) differs from span 32")
        span1 = (time.perf_counter() - t0) / (len(prompts) * new) * 1e3
        log(f"[{label}] graphs vs eager: the 3 prompts x {new} greedy tokens equal bit for bit "
            f"through the eager _step loop, decode_greedy_scan's graphs, generate(span=1) and "
            f"generate(span=32), forced_decode_scan's last logits the loop's; launches per "
            f"decode forward equal ({per['graph']})")
        return {"eager_ms": ms["eager"], "graph_ms": ms["graph"], "span1_ms": span1,
                "per_forward": per["graph"]}

    # -- phase 6 ---------------------------------------------------------------
    def phase_fold(self, torch):
        """The decode path with cache_impl="fold" on the full phase's 7B model:
        the same three prompts, 64 greedy tokens each, through kernel 9 (32
        launches per decode forward, kernel 3 none), held to the classic
        runner where its top-2 margin is clear and bit for bit to the fold
        runner's own eager step loop; the device step as a graph beside the
        classic one; then the serve phase's 12 requests on the dense engine
        with cache_impl="fold", held like the other serving runs and to the
        same engine's eager spans."""
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
        cfg, params = self.model7b
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (37, 100, 201)]   # full's
        new = 64
        fold = ModelRunner("llama", cfg, params, device="cuda", cache_impl="fold")
        classic = ModelRunner("llama", cfg, params, device="cuda")
        fold.warmup(prefill_buckets=(16,))
        classic.warmup(prefill_buckets=())
        kernels.reset_launch_counts()
        f0 = dict(fold.forwards)
        t0 = time.perf_counter()
        outs = [generate(fold, p, max_new_tokens=new, temperature=0.0) for p in prompts]
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        counts = kernels.launch_counts()
        decodes = fold.forwards["decode"] - f0["decode"]
        self.check_path("fold", counts)
        self.check_norms("fold generate", counts,
                         decodes + fold.forwards["prefill"] - f0["prefill"], cfg.num_layers)
        per_token = counts["fused_decode_attention"] / decodes
        if per_token != cfg.num_layers or counts["decode_attention"] != 0:
            raise AssertionError(f"fold: {per_token} fold launches per decode forward and "
                                 f"{counts['decode_attention']} of kernel 3 (want "
                                 f"{cfg.num_layers} and 0)")
        results = {i: o[0, len(p):] for i, (p, o) in enumerate(zip(prompts, outs))}
        ref, _ = self._forced_reference(torch, classic, prompts, results)
        compared, total, same = self._hold_to_reference("fold runner", results, ref)
        log(f"[fold] generate: 3 requests x {new} new tokens in {t_gen:.2f} s; kernel 9 "
            f"{per_token:.0f} launches per decode forward, kernel 3 none; {compared}/{total} "
            f"positions clear the classic runner's margin, all agree ({same}/{total} agree in "
            f"all); launches {counts}")
        loop = self._graphs_vs_eager(torch, "fold", fold, prompts, outs, new)
        dev_ms = {}
        for name, runner in (("classic", classic), ("fold", fold)):
            runner.init_cache()
            offs = runner._store.offs
            dev_ms[name] = replay_ms(torch, runner.graphs, ("decode", 256),
                                     lambda o=offs: o.fill_(164))
            runner.init_cache()
        log(f"[fold] decode device step as a CUDA graph: fold {dev_ms['fold']:.3f} ms/token, "
            f"classic {dev_ms['classic']:.3f} ms/token (offset 164); fold host loop "
            f"{loop['eager_ms']:.3f} ms/token eager, {loop['graph_ms']:.3f} through the graphs "
            f"| {self.card}")
        del fold, classic
        torch.cuda.empty_cache()

        rng = np.random.RandomState(0)   # the serve phase's requests
        sprompts = [rng.randint(1, cfg.vocab_size, size=n) for n in self.SERVE_LENS]
        kw = dict(prefill_chunk=128, decode_span=8, fused_chunk_decode=False, cache_impl="fold")
        served, eng = self._serve_run(torch, "dense fold chunk 128 unfused", "serve:fold",
                                      sprompts, **kw)
        self._serve_step_times(torch, eng, "dense fold", profile=False)
        eager, eng_e = self._serve_run(torch, "dense fold eager", None, sprompts, eager=True,
                                       **kw)
        self._hold_equal("dense fold engine, graphs vs eager", served, eager)
        self._hold_caches("dense fold engine, graphs vs eager", eng, eng_e)
        del eng_e
        runner = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=2048, device="cuda")
        sref, cache_err = self._forced_reference(torch, runner, sprompts, served, eng.snaps)
        scompared, stotal, ssame = self._hold_to_reference("dense fold", served, sref)
        log(f"[fold] dense fold engine vs the single-sequence runner: {scompared}/{stotal} "
            f"positions clear the margin, all agree; {ssame}/{stotal} agree in all; every "
            f"request's cache at its retirement within {cache_err['worst']:.2e} of the "
            f"runner's per row, {cache_err['mean']:.2e} in the mean; kernel 9 "
            f"{eng.forwards['decode'] * cfg.num_layers} launches = {cfg.num_layers} x "
            f"{eng.forwards['decode']} decode forwards")
        self.report["fold"] = {
            "generate_s": t_gen, "launches": counts, "compared": compared, "positions": total,
            "agree": same, "graph_ms_per_token": dev_ms, "host_loop": loop,
            "serve": {"compared": scompared, "positions": stotal, "agree": ssame,
                      "cache_row_rel_err": cache_err}}
        del eng, runner
        torch.cuda.empty_cache()

    # -- phase 7 ---------------------------------------------------------------
    LORA_STEPS = 6

    def phase_lora(self, torch):
        """LoRA finetuning over the frozen packed 7B model (the full phase's,
        32 layers): rank-8 adapters (alpha 16) on all seven linears of every
        layer, a fixed batch of 2 x 512 seeded token ids whose labels are the
        ids shifted by one, ``LORA_STEPS`` Adam steps. Per step: the loss,
        forward / backward / optimizer ms, and the launches, held against what
        the path predicts: forward 7 x 32 of kernel 1 (gate/up adapted, so
        unfused), 2 x 32 + 1 of kernel 6 (2 x 32 with the residual add folded
        in), 32 of kernel 5; backward one kernel 8
        for every packed linear whose input needs a gradient, 7 x 32 - 3 (layer
        0's q/k/v read the embedding, which needs none). Checks: the loss
        falls, every b moved, every packed buffer is byte-identical after
        training. Then the 2-layer gradient check (``_lora_grad_check``)."""
        import torch.nn.functional as F
        from gptq_for_llama_tpu_torch.engine import attach_lora, get_path, join_lora, split_lora
        from gptq_for_llama_tpu_torch.models import llama
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        cfg, params = self.model7b
        layers = cfg.num_layers
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        adapters, skeleton = split_lora(attach_lora("llama", params, rank=8, generator=gen,
                                                    alpha=16.0))
        leaves = [t.requires_grad_() for ab in adapters for t in (ab["a"], ab["b"])]
        packed = [get_path(lp, n) for lp in params["layers"] for n in llama.LAYER_LINEARS]
        frozen = [(lin.qweight.clone(), lin.scales.clone(), lin.zeros.clone()) for lin in packed]
        ids = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 512)),
                              device="cuda")
        opt = torch.optim.Adam(leaves, lr=1e-4)
        want_fwd = dict.fromkeys(kernels.launch_counts(), 0)   # kernels 1's, 2's, 6's forms
        want_fwd.update(qmm=7 * layers, rms_norm=2 * layers + 1, flash_prefill=layers)
        if "rms_norm:add" in want_fwd:
            want_fwd.update({"rms_norm:add": 2 * layers, "rms_norm:alone": 1})
        if "qmm:tile" in want_fwd:   # 2 x 512 rows: every linear on the tiles
            want_fwd["qmm:tile"] = 7 * layers
        if "flash_prefill:d128" in want_fwd:   # kernel 5 counted by head dim
            want_fwd["flash_prefill:d128"] = layers
        want_bwd = dict.fromkeys(want_fwd, 0)
        want_bwd.update(qmm_t=7 * layers - 3)

        def step():
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            logits = llama.forward(join_lora(skeleton, adapters), cfg, ids)
            loss = F.cross_entropy(logits[:, :-1].flatten(0, 1).float(), ids[:, 1:].flatten())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd = kernels.launch_counts()
            kernels.reset_launch_counts()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bwd = kernels.launch_counts()
            opt.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            return float(loss.detach()), (t1 - t0, t2 - t1, t3 - t2), fwd, bwd

        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(self.LORA_STEPS):
            loss, dt, fwd, bwd = step()
            losses.append(loss)
            times.append(dt)
            self.check_path("lora", {k: fwd[k] + bwd[k] for k in fwd})
            if fwd != want_fwd or bwd != want_bwd:
                raise AssertionError(f"lora step {i}: launches forward {fwd}, backward {bwd}; "
                                     f"the path predicts {want_fwd}, {want_bwd}")
            log(f"[lora] step {i}: loss {loss:.5f}, forward {dt[0] * 1e3:.1f} ms, backward "
                f"{dt[1] * 1e3:.1f} ms, Adam {dt[2] * 1e3:.1f} ms")
        peak = torch.cuda.max_memory_allocated()
        if not losses[-1] < losses[0] - 0.02:
            raise AssertionError(f"lora: the loss did not fall: {losses}")
        still = sum(int(ab["b"].detach().abs().max().item() == 0) for ab in adapters)
        if still:
            raise AssertionError(f"lora: {still} of {len(adapters)} b never moved")
        for lin, (qw, sc, zr) in zip(packed, frozen):
            if not (torch.equal(lin.qweight, qw) and torch.equal(lin.scales, sc)
                    and torch.equal(lin.zeros, zr)):
                raise AssertionError("lora: a packed buffer changed during training")
        med = [float(np.median([t[j] for t in times[1:]])) * 1e3 for j in range(3)]
        log(f"[lora] 32-layer 7B-width INT4 g128, rank 8 on all 7 linears ({len(adapters)} "
            f"adapters, {sum(t.numel() for t in leaves)} trainable values), batch 2 x 512: loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f} in {len(losses)} Adam steps; median step "
            f"{sum(med):.1f} ms (forward {med[0]:.1f}, backward {med[1]:.1f}, Adam {med[2]:.1f}); "
            f"peak memory {peak / 2**30:.2f} GiB; launches per step forward {want_fwd}, "
            f"backward {want_bwd}; every b moved, all {len(packed)} packed linears "
            f"byte-identical | {self.card}")
        self.report["lora"] = {"losses": losses, "step_s": times, "median_ms": med,
                               "peak_memory_bytes": peak, "launches_forward": want_fwd,
                               "launches_backward": want_bwd}
        self._profile_steps(torch, "lora-profile", "LoRA training step(s) of LLaMA-7B, 2 x 512 "
                            "tokens", lambda: step(), 1)
        del adapters, skeleton, leaves, frozen, opt
        torch.cuda.empty_cache()
        self._lora_grad_check(torch, None, "all seven linears", "lora")
        self._lora_grad_check(torch, ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                                      "self_attn.o_proj", "mlp.down_proj"),
                              "attention + down_proj (gate/up fused)", "lora:fused")

    def _lora_grad_check(self, torch, targets, label, path):
        """Every adapter's gradient on the card (bf16, kernels) against the
        CPU plain path in fp32, for the same seeded 2-layer model at 7B width
        with adapters whose b is nonzero, on one batch of 1 x 128 tokens:
        ||g_card - g_cpu|| / ||g_cpu|| of each a and b. The limit is 3x what
        two correct runs differ by, measured in this run: the same CPU plain
        path in bf16 against fp32."""
        import torch.nn.functional as F
        from gptq_for_llama_tpu_torch.engine import attach_lora, join_lora, split_lora
        from gptq_for_llama_tpu_torch.models import llama
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
        cfg = ModelConfig(**dict(LLAMA_7B, num_layers=2))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        params = gaussian_wire_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        adapters, skeleton = split_lora(attach_lora("llama", params, rank=8, generator=gen,
                                                    targets=targets))
        for ab in adapters:   # b nonzero: every a has a live gradient
            ab["b"] = (torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01
                       ).to(ab["b"].dtype)
        ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 128)))

        def grads(skel, device, dtype):
            ads = [{k: v.detach().to(device=device, dtype=dtype).requires_grad_()
                    for k, v in ab.items()} for ab in adapters]
            t0 = time.perf_counter()
            x = ids.to(device)
            logits = llama.forward(join_lora(skel, ads), cfg, x)
            loss = F.cross_entropy(logits[:, :-1].flatten(0, 1).float(), x[:, 1:].flatten())
            loss.backward()
            out = [(ab["a"].grad.float().cpu(), ab["b"].grad.float().cpu()) for ab in ads]
            return float(loss.detach()), out, time.perf_counter() - t0

        kernels.reset_launch_counts()
        card_loss, card, t_card = grads(skeleton, "cuda", torch.bfloat16)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        self.check_path(path, counts)
        cpu32_loss, cpu32, t32 = grads(_tree_to_cpu(skeleton, torch.float32), "cpu",
                                       torch.float32)
        cpu16_loss, cpu16, t16 = grads(_tree_to_cpu(skeleton, torch.bfloat16), "cpu",
                                       torch.bfloat16)

        def worst(got):
            return max(float((g - r).norm() / r.norm())
                       for gg, rr in zip(got, cpu32) for g, r in zip(gg, rr))

        floor, err = worst(cpu16), worst(card)
        limit = 3 * floor
        log(f"[lora] 2-layer 7B-width gradient check, adapters on {label} ({len(adapters)}): "
            f"worst adapter ||g_card - g_cpu32|| / ||g_cpu32|| {err:.3e}; two correct runs (CPU "
            f"bf16 vs fp32) {floor:.3e}; limit 3x that {limit:.3e}; loss card {card_loss:.5f}, "
            f"CPU fp32 {cpu32_loss:.5f}, bf16 {cpu16_loss:.5f}; card {t_card:.2f} s, CPU "
            f"{t32:.1f} / {t16:.1f} s; launches {counts}")
        if not err <= limit:
            raise AssertionError(f"lora gradients on the card ({label}) are {err} off the CPU "
                                 f"fp32 path; two correct runs differ by {floor}")
        self.report.setdefault("lora_grad_check", {})[label] = {
            "worst_rel": err, "bf16_vs_fp32": floor, "limit": limit, "launches": counts,
            "loss": {"card": card_loss, "cpu_fp32": cpu32_loss, "cpu_bf16": cpu16_loss}}
        del params, adapters, skeleton
        torch.cuda.empty_cache()

    def check_path(self, path, counts):
        """Record one run's launch counts under its path (runs of one path add
        up); fail if a kernel of the path never launched in this run."""
        acc = self.launches.setdefault(path, {})
        for k, v in counts.items():
            acc[k] = acc.get(k, 0) + v
        # kernels 1's, 2's and 6's forms are counted by packages that have them
        # (an A/B run drives an earlier package with this script)
        missing = sorted(k for k in PATHS[path]
                         if counts.get(k, 0) == 0 and (":" not in k or k in counts))
        if missing:
            raise AssertionError(f"{path} path: kernels never launched: {missing}")

    @staticmethod
    def check_norms(label, counts, forwards, layers):
        """Kernel 6 on a path of whole forwards through the stack: 2L + 1
        launches per forward, 2L of them with the residual add folded in and
        one alone (layer 0's input norm). Checked where the package counts
        the forms (an A/B run drives an earlier package with this script)."""
        if "rms_norm:add" not in counts:
            return
        want = {"rms_norm": (2 * layers + 1) * forwards,
                "rms_norm:add": 2 * layers * forwards, "rms_norm:alone": forwards}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{label}: kernel 6 launched {got} in {forwards} forwards of "
                                 f"{layers} layers; the stack predicts {want}")

    # -- phase 8 ---------------------------------------------------------------
    def phase_quantize(self, torch):
        from gptq_for_llama_tpu_torch.cli.main import main as cli
        from gptq_for_llama_tpu_torch.ops import cuda as kernels

        layers = 2
        model, out = os.path.join(self.tmp, "model"), os.path.join(self.tmp, "packed")
        t0 = time.perf_counter()
        nbytes = write_dense_llama(torch, model, layers, seed=11)
        log(f"[quantize] dense F16 LLaMA at 7B width, {layers} layers: {nbytes / 2**30:.2f} GiB "
            f"written in {time.perf_counter() - t0:.1f} s")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep1 = cli([model, "synthetic", "--wbits", "4", "--groupsize", "128", "--act-order",
                    "--true-sequential", "--nsamples", "128", "--save", out, "--eval"])
        t_first = time.perf_counter() - t0
        peak_q = rep1["peak_memory"]["quantize"]
        t0 = time.perf_counter()
        rep2 = cli([model, "synthetic", "--load", out, "--eval", "--benchmark", "128", "--check"])
        t_second = time.perf_counter() - t0
        peak_e = rep2["peak_memory"]["eval:synthetic"]

        self.check_path("quantize", rep1["launches"]["quantize"])
        self.check_path("eval", rep2["launches"]["eval:synthetic"])
        for rep in (rep1, rep2):
            ev = rep["launches"]["eval:synthetic"]
            if ev.get("flash_prefill", 0) == 0:
                raise AssertionError("eval: the causal prefill kernel never launched")
            self.check_norms("eval", ev, ev["flash_prefill"] // layers, layers)
        q = rep1["launches"]["quantize"]
        if "rms_norm:add" in q and not q["rms_norm:alone"] >= q["rms_norm:add"] == q[
                "flash_prefill"]:
            # the engine calls one layer at a time: one norm of each form per call
            raise AssertionError(f"quantize: kernel 6 {q}: want one residual-form launch per "
                                 f"layer call (one causal attention each) and as many alone")
        ppl1, ppl2 = rep1["ppl"]["synthetic"], rep2["ppl"]["synthetic"]
        ppl_rel = abs(ppl1 - ppl2) / ppl2
        if not (math.isfinite(ppl1) and math.isfinite(ppl2)) or ppl_rel > 1e-4:
            raise AssertionError(f"quantize: ppl {ppl1} after quantizing vs {ppl2} reloaded")
        split = {k: v / layers for k, v in rep1["quantize_split"].items()}
        eval_tokens = (50_000 // 2048) * 2048   # the synthetic test stream, whole windows
        tok_s = eval_tokens / rep2["phases"]["eval:synthetic"]
        bench = rep2["benchmark"]
        log(f"[quantize] CLI quantize+pack+save+eval {t_first:.1f} s, reload+eval+benchmark "
            f"{t_second:.1f} s; phases {json.dumps(rep1['phases'])} / "
            f"{json.dumps(rep2['phases'])}")
        log(f"[quantize] s/layer: forwards {split['forward']:.3f}, Hessians "
            f"{split['hessian']:.3f}, solver {split['solver']:.3f} "
            f"(total {sum(split.values()):.3f}) | {self.card}")
        log(f"[quantize] ppl {ppl1:.4f} (after quantize) vs {ppl2:.4f} (reloaded), rel "
            f"{ppl_rel:.2e}; eval {eval_tokens} tokens at {tok_s:.1f} tok/s; decode benchmark "
            f"{bench['tokens_per_s']:.1f} tok/s, check ppl {bench.get('ppl', float('nan')):.4f}; "
            f"peak memory {peak_q / 2**30:.2f} GiB (quantize) / {peak_e / 2**30:.2f} GiB "
            f"(eval) | {self.card}")
        log(f"[quantize] launches: quantize {rep1['launches']['quantize']}; eval "
            f"{rep2['launches']['eval:synthetic']}; benchmark {rep2['launches']['benchmark']}")
        self.report["quantize"] = {
            "layers": layers, "s_per_layer": split, "ppl_after_quantize": ppl1,
            "ppl_reloaded": ppl2, "eval_tokens": eval_tokens, "eval_tok_s": tok_s,
            "benchmark": bench, "peak_memory_bytes": {"quantize": peak_q, "eval": peak_e},
            "phases": [rep1["phases"], rep2["phases"]],
            "peak_memory_by_phase": [rep1["peak_memory"], rep2["peak_memory"]],
            "launches": [rep1["launches"], rep2["launches"]]}
        self._quantize_checks(torch, model, out)

    def _quantize_checks(self, torch, model, out):
        from gptq_for_llama_tpu_torch.data import get_loaders
        from gptq_for_llama_tpu_torch.engine.evaluate import window_nll
        from gptq_for_llama_tpu_torch.engine.quantize import get_path
        from gptq_for_llama_tpu_torch.models import hf_loader
        from gptq_for_llama_tpu_torch.models.common import causal_mask
        from gptq_for_llama_tpu_torch.models.registry import get_arch
        from gptq_for_llama_tpu_torch.quant import packing
        from gptq_for_llama_tpu_torch.quant.gptq import (batch_hessian, fp32_matmul,
                                                         gptq_quantize, rtn_quantize)
        from gptq_for_llama_tpu_torch.quant.quantizer import QuantConfig

        arch = get_arch("llama")
        res = self.report["quantize"]
        # reloaded wire buffers are byte-equal to the saved ones
        flat = hf_loader.read_flat_state(out)
        cfg, packed = hf_loader.load_params(out, device="cuda")
        nbuf = 0
        for li, lp in enumerate(packed["layers"]):
            for name in arch.LAYER_LINEARS:
                for k, v in get_path(lp, name).to_wire().items():
                    ref = flat[f"model.layers.{li}.{name}.{k}"]
                    if v.dtype != ref.dtype or v.tobytes() != ref.tobytes():
                        raise AssertionError(f"reload: layers.{li}.{name}.{k} differs")
                    nbuf += 1
        log(f"[quantize] reload: {nbuf} wire buffers byte-equal to the saved file")

        # GPTQ beats RTN on one calibration chunk, every linear of layer 0
        _, dense = hf_loader.load_params(model, device="cuda")
        train, test = get_loaders("synthetic", nsamples=128, seed=0, seqlen=2048, model=cfg)
        ids = torch.as_tensor(train[:16], dtype=torch.long, device="cuda")
        pos = torch.arange(2048, device="cuda")[None, :]
        with torch.inference_mode():
            x = arch.embed(dense, cfg, ids)
            _, taps, _ = arch.layer(cfg, dense["layers"][0], x, pos,
                                    causal_mask(2048, 2048, device="cuda"))
        rtn_cfg = QuantConfig(bits=4, wire_safe=True)
        rows = []
        with fp32_matmul():
            for name in arch.LAYER_LINEARS:
                xt = taps[name].reshape(-1, taps[name].shape[-1]).float()
                w = get_path(dense["layers"][0], name)["kernel"].float()          # (in, out)
                wire = get_path(packed["layers"][0], name).to_wire()
                wq = packing.dequantize(wire["qweight"], wire["qzeros"], wire["scales"],
                                        wire["g_idx"], 4).cuda()
                wr = rtn_quantize(w.T, rtn_cfg, groupsize=128).T
                e_g = float(((xt @ (wq - w)) ** 2).sum())
                e_r = float(((xt @ (wr - w)) ** 2).sum())
                rows.append((name, e_g, e_r))
                del xt, wq, wr
        for name, e_g, e_r in rows:
            log(f"[quantize] layer 0 {name}: |X(Wq-W)|^2 GPTQ {e_g:.4e} vs RTN {e_r:.4e} "
                f"({e_g / e_r:.3f})")
        worse = [n for n, e_g, e_r in rows if not e_g < e_r]
        if worse:
            raise AssertionError(f"GPTQ not below RTN on one calibration chunk: {worse}")
        res["gptq_vs_rtn"] = {n: {"gptq": g, "rtn": r} for n, g, r in rows}

        # the card's Hessian against fp64 on the CPU, same taps (one chunk);
        # beside it what a plain fp32 GEMM and a TF32 one would give
        xt = taps["self_attn.q_proj"].reshape(-1, cfg.hidden_size)
        ref = 2.0 * (lambda a: a.T @ a)(xt.double().cpu())
        scale = ref.abs().max().item()

        def rel(h):
            return (h.double().cpu() - ref).abs().max().item() / scale

        h_rel = rel(batch_hessian(xt[None]))
        with fp32_matmul():
            xf = xt.float()
            fp32_rel = rel(2.0 * (xf.T @ xf))
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_rel = rel(2.0 * (xf.T @ xf))
        torch.backends.cuda.matmul.allow_tf32 = old
        log(f"[quantize] Hessian of q_proj on {xt.shape[0]} tokens: card vs fp64 CPU "
            f"{h_rel:.2e} (tol 1e-4); a plain fp32 GEMM gives {fp32_rel:.2e}, TF32 "
            f"{tf32_rel:.2e}")
        if h_rel > 1e-4:
            raise AssertionError(f"card Hessian disagrees with fp64: {h_rel}")
        if not tf32_rel > 1e-4:   # the control: the limit must reject a TF32 GEMM
            raise AssertionError(f"the 1e-4 Hessian limit does not reject TF32 ({tf32_rel})")
        del taps, x, xf
        res["hessian_rel"] = {"card": h_rel, "fp32_gemm": fp32_rel, "tf32_gemm": tf32_rel}

        # the solver on the card vs on the CPU, same W and a full-rank H
        w = get_path(dense["layers"][0], "self_attn.k_proj")["kernel"].float().T.contiguous()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        xg = torch.randn(1, 8192, cfg.hidden_size, generator=gen, device="cuda")
        with fp32_matmul():
            h = 2.0 * (lambda a: a.T @ a)(xg[0])
        args = dict(cfg=QuantConfig(bits=4, wire_safe=True), groupsize=128, actorder=True)
        t0 = time.perf_counter()
        got = gptq_quantize(w, h, **args)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = gptq_quantize(w.cpu(), h.cpu(), **args)
        t_cpu = time.perf_counter() - t0
        stats = solver_agreement([a.cpu() if isinstance(a, torch.Tensor) else a for a in got],
                                 want)
        log(f"[quantize] gptq_quantize 4096x4096 act-order g128, card {t_card:.2f} s vs CPU "
            f"{t_cpu:.2f} s: scales within 1e-5 {stats['scales_close']:.6f}, zeros equal "
            f"{stats['zeros_equal']:.6f}, codes equal {stats['codes_equal']:.6f} (max diff "
            f"{stats['codes_max_diff']}), error rel {stats['error_rel']:.2e}")
        if not (stats["scales_close"] >= 0.999 and stats["zeros_equal"] >= 0.999
                and stats["codes_equal"] >= 0.999 and stats["error_rel"] <= 1e-4):
            raise AssertionError(f"solver card vs CPU: {stats}")
        res["solver_card_vs_cpu"] = dict(stats, card_s=t_card, cpu_s=t_cpu)
        del dense, xg, h

        # one 512-token window's NLL: the packed model on the card (bf16,
        # kernels) vs on the CPU (fp32, plain versions)
        win = np.asarray(test[:512])[None]
        _, packed_cpu = hf_loader.load_params(out, device="cpu", dtype=torch.float32)
        nll_card = window_nll(arch, cfg, packed, torch.as_tensor(win, device="cuda")).item()
        nll_cpu = window_nll(arch, cfg, packed_cpu, torch.as_tensor(win)).item()
        nll_rel = abs(nll_card - nll_cpu) / abs(nll_cpu)
        log(f"[quantize] 512-token window NLL: card {nll_card:.4f} vs CPU fp32 {nll_cpu:.4f}, "
            f"rel {nll_rel:.2e} (tol 1e-2)")
        if not math.isfinite(nll_card) or nll_rel > 1e-2:
            raise AssertionError(f"window NLL card vs CPU: rel {nll_rel}")
        res["window_nll"] = {"card": nll_card, "cpu": nll_cpu, "rel": nll_rel}

    # -- phase 9 ---------------------------------------------------------------
    SERVE_LENS = (37, 50, 100, 120, 200, 300, 450, 600, 64, 90, 256, 512)
    SERVE_NEW = 48

    def _forced_reference(self, torch, runner, prompts, results, snaps=None):
        """The single-sequence runner, teacher-forced with each request's served
        tokens (prefill, then one decode step per token, as ``generate`` runs
        them): per request the runner's argmax at every position and whether
        its top-2 margin is clear. The rule of the e2e phase: a served token
        must equal the runner's wherever the margin exceeds 2 * 2e-2 * max|logit|
        (batch-8 and batch-1 GEMMs round differently, so a near-tie may flip).

        With ``snaps`` (``_snapshotting``: the k/v each request's slot held when
        the request retired) EVERY request's cache is also held against the
        runner's, per (position, head) row relative to the row's norm: every
        layer's k/v at every position depends on all that came before it, so a
        wrong cache, table or offset shows here even where the argmax does not
        move, in a slot that was backfilled later too. The limits: every row
        within 1e-1 and the mean over all rows within 2e-2. A row that is
        missing, stale or another request's is off by about 1.4 (independent
        rows); two CORRECT bf16 runs of 32 layers that differ only in how the
        prompt was cut up (bucket, chunks, batch) are 2e-2 to 3e-2 apart in
        their worst row (the serve phase measures and prints it), since every
        rounding of the residual stream turns a difference far below the last
        place into a whole one.
        Returns (reference, {"worst", "mean"} of the cache rows or None)."""
        rel_tol, row_tol, out, worst, total, count = 2e-2, 1e-1, {}, 0.0, 0.0, 0
        if snaps is not None and sorted(snaps) != list(range(len(prompts))):
            raise AssertionError(f"caches were kept for requests {sorted(snaps)} only")
        for uid, p in enumerate(prompts):
            toks = torch.as_tensor(np.asarray(results[uid], np.int64), device="cuda")[None]
            logits, cache = runner.prefill(torch.as_tensor(p[None], device="cuda"),
                                           runner.init_cache())
            rows = [logits[0, -1].float()]
            for i in range(toks.shape[1] - 1):
                logits, cache = runner.decode(toks[:, i:i + 1], cache)
                rows.append(logits[0, -1].float())
            ref = torch.stack(rows)
            top2 = ref.topk(2, dim=-1)
            clear = (top2.values[:, 0] - top2.values[:, 1]) > 2 * rel_tol * ref.abs().max()
            out[uid] = (top2.indices[:, 0].cpu().numpy(), clear.cpu().numpy())
            if snaps is not None:
                i, held, ks, vs = snaps[uid]
                n = cache.offset
                if n != held:
                    raise AssertionError(f"slot {i}: the engine held {held} positions of "
                                         f"request {uid}, the runner {n}")
                for li in range(len(cache.k)):
                    for got, want in ((ks[li], cache.k[li]), (vs[li], cache.v[li])):
                        errs = row_rel_errs(got, want[0, :n])
                        err = errs.max().item()
                        worst = max(worst, err)
                        total, count = total + errs.sum().item(), count + errs.numel()
                        if not err <= row_tol:
                            raise AssertionError(f"slot {i} (request {uid}), layer {li}: the "
                                                 f"engine's cache is {err} off the runner's")
        if snaps is None:
            return out, None
        if not total / count <= rel_tol:
            raise AssertionError(f"the engine's caches are {total / count} off the runner's in "
                                 f"the mean over {count} rows")
        return out, {"worst": worst, "mean": total / count}

    @staticmethod
    def _snapshotting(engine_cls):
        """``engine_cls`` that keeps in ``snaps`` {uid: (slot, positions, k, v)}
        a copy of the k/v (per layer, the first ``positions`` rows of the
        slot's logical view) that each request's slot held when the request
        retired. A retired slot's rows stay as they were until the slot is
        given to the next request, so the copy is taken at the head of
        ``_admit``, and by the caller after the run for each slot's last one."""
        class Snapshotting(engine_cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.snaps = {}
                # (key, captured already, slot, chunk offset) of every one-slot
                # step: which replays ran at another slot or offset than the
                # capture of their graph. Weak references: a cycle through
                # the engine would keep its caches alive past ``del``
                self.slot_calls, self._slot_at = [], None
                me, graphs = weakref.proxy(self), weakref.proxy(self.graphs)
                run = type(self.graphs).run

                def recording(key, body, restore=(), generators=()):
                    if key[0] in ("prefill", "chunk", "chunk+decode"):
                        me.slot_calls.append((key, key in graphs, *me._slot_at))
                    return run(graphs, key, body, restore, generators)

                self.graphs.run = recording

            def _load_slot(self, state, i, ids, off0, last_idx):
                self._slot_at = (i, off0)
                super()._load_slot(state, i, ids, off0, last_idx)

            def snapshot_retired(self):
                st = self.state
                for i, slot in enumerate(self.slots):
                    if slot.req is None or not slot.done or slot.req.uid in self.snaps:
                        continue
                    n = int(st["host_off"][i])

                    def view(c):
                        if not self.paged:
                            return c[i, :n].clone()
                        blocks = st["tables"][i, :-(-n // self.block_size)].long()
                        return c[blocks].reshape(-1, *c.shape[2:])[:n].clone()

                    self.snaps[slot.req.uid] = (i, n, [view(c) for c in st["k"]],
                                                [view(c) for c in st["v"]])

            def _admit(self, state):
                self.snapshot_retired()
                super()._admit(state)

        return Snapshotting

    @staticmethod
    def _hold_to_reference(what, results, reference):
        """Fail if a served token differs from the runner's where the margin is
        clear; returns (compared, positions, raw agreement)."""
        compared = total = same = 0
        for uid, (argmax, clear) in reference.items():
            got = np.asarray(results[uid])
            bad = np.nonzero(clear & (got != argmax))[0]
            if bad.size:
                raise AssertionError(f"{what}: request {uid} token {bad[0]} is {got[bad[0]]}, the "
                                     f"single-sequence runner says {argmax[bad[0]]} with a clear "
                                     f"margin")
            compared += int(clear.sum())
            total += len(got)
            same += int((got == argmax).sum())
        if compared == 0:
            raise AssertionError(f"{what}: no token cleared the margin; the check is dead")
        return compared, total, same

    @staticmethod
    def _hold_to_run(what, results, other, reference):
        """Two runs of the same requests: equal up to each request's first
        difference, which must sit where the reference's margin is not clear
        (both have the same history up to there)."""
        equal = 0
        for uid, (_, clear) in reference.items():
            a, b = np.asarray(results[uid]), np.asarray(other[uid])
            diff = np.nonzero(a != b)[0] if len(a) == len(b) else np.array([min(len(a), len(b))])
            if diff.size and (diff[0] >= len(clear) or clear[diff[0]]):
                raise AssertionError(f"{what}: request {uid} differs at token {diff[0]} where the "
                                     f"runner's margin is clear")
            equal += int(not diff.size)
        return equal

    def _serve_run(self, torch, label, path, prompts, poison=False, eager=False, **kw):
        """One ``ServingEngine.run`` over the 12 requests on the 7B model: the
        tokens, the engine's stats, and the launch counts held against the
        forwards the engine made; then a second run of the same requests with
        every graph captured: the same tokens, no capture, every prefill,
        admission, chunk and chunk+decode forward a replay, and its tok/s and
        ttft beside the first run's. ``eager``: every step of the engine runs
        its body eagerly, not captured (a reference for the graphs' tokens and
        caches; no check of its own)."""
        from gptq_for_llama_tpu_torch.runtime import ServingEngine
        from gptq_for_llama_tpu_torch.runtime.graphs import kind
        cfg, params = self.model7b
        eng = self._snapshotting(ServingEngine)("llama", cfg, params, batch_slots=8,
                                                max_seq_len=2048, prefill_buckets=(32, 128, 512),
                                                **kw)
        if eager:
            eng.graphs.run = lambda key, body, restore=(), generators=(): body()
        if poison:   # every pool block starts as NaN: no block is owned yet
            eng._new_cache = lambda shape: [
                torch.full(shape, float("nan"), dtype=torch.bfloat16, device="cuda")
                for _ in range(cfg.num_layers)]
        results, dt, counts, peak = self._serve_once(torch, eng, prompts)
        eng.snapshot_retired()   # the last request of each slot
        if eager:
            tokens = sum(len(r) for r in results.values())
            log(f"[serve] {label}: {tokens} tokens in {dt:.2f} s = {tokens / dt:.1f} tok/s "
                f"aggregate; {eng.steps} engine steps, forwards {eng.forwards} | {self.card}")
            self.report.setdefault("serve", {})[label] = {"seconds": dt, "tokens": tokens,
                                                          "tok_s": tokens / dt}
            return results, eng
        self.check_path(path, counts)
        self._hold_launches(label, counts, eng.forwards, eng)
        tokens = sum(len(r) for r in results.values())
        if sorted(results) != list(range(len(prompts))) or tokens != len(prompts) * self.SERVE_NEW:
            raise AssertionError(f"{label}: {len(results)} results, {tokens} tokens")
        for r in results.values():
            if not ((r >= 0) & (r < cfg.vocab_size)).all():
                raise AssertionError(f"{label}: token out of the vocabulary")
        stats = eng.stats()
        distinct = len(set(np.concatenate(list(results.values())).tolist()))
        if distinct < 8:
            raise AssertionError(f"{label}: {distinct} distinct tokens: the model's tokens do not "
                                 f"depend on the prompt, so the token checks are dead")
        f = dict(eng.forwards)
        log(f"[serve] {label}: {tokens} tokens ({distinct} distinct) in {dt:.2f} s = "
            f"{tokens / dt:.1f} tok/s aggregate; "
            f"ttft p50/p95 {stats['ttft_p50_s']}/{stats['ttft_p95_s']} s, latency p50/p95 "
            f"{stats['latency_p50_s']}/{stats['latency_p95_s']} s; {eng.steps} engine steps, "
            f"forwards {f}; peak memory {peak / 2**30:.2f} GiB | {self.card}")
        by_kind = eng.graphs.by_kind()
        keys = sorted(eng.graphs.keys(), key=str)
        log(f"[serve] {label}: launches {counts}; {len(keys)} graphs captured in "
            f"{eng.graphs.capture_s:.1f} s (warm calls included), pool "
            f"{(eng.graphs.pool_bytes() or 0) / 2**20:.1f} MiB; by kind {by_kind}; keys {keys} "
            f"| {self.card}")
        # the prefill, admission and chunk keys of an engine at max_len 2048:
        # at most 4 + 2 + 5 + 5, whatever the requests
        if sum(kind(k) != "decode" for k in keys) > 16:
            raise AssertionError(f"{label}: more than 16 prefill, admission and chunk graphs")
        # the one-slot steps replayed at another slot or offset than their capture's
        first = {}
        for key, captured, slot, off0 in eng.slot_calls:
            first.setdefault(key, (slot, off0))
        moved = {"slot": sum(c and s != first[k][0] for k, c, s, _ in eng.slot_calls),
                 "offset": sum(c and o != first[k][1] for k, c, _, o in eng.slot_calls)}
        if eng.slot_calls and not moved["slot"]:
            raise AssertionError(f"{label}: no prefill or chunk graph replayed at another slot")
        if eng.prefill_chunk and not moved["offset"]:
            raise AssertionError(f"{label}: no chunk graph replayed at another offset")
        # the second run: every graph captured, every step a replay
        r0 = dict(eng.graphs.replays)
        again, dt2, counts2, _ = self._serve_once(torch, eng, prompts)
        self._hold_equal(f"{label}, the second run", again, results)
        if sorted(eng.graphs.keys(), key=str) != keys:
            raise AssertionError(f"{label}: the second run captured a new graph")
        f2 = {k: n - f[k] for k, n in eng.forwards.items()}
        self._hold_launches(f"{label} (second run)", counts2, f2, eng)
        replays = {}
        for key, n in eng.graphs.replays.items():
            replays[kind(key)] = replays.get(kind(key), 0) + n - r0.get(key, 0)
        for kd in ("prefill", "admit", "chunk", "chunk+decode"):
            if replays.get(kd, 0) != f2[kd]:
                raise AssertionError(f"{label}: {f2[kd]} {kd} forwards in the second run, "
                                     f"{replays.get(kd, 0)} graph replays")
        stats2 = eng.stats()
        log(f"[serve] {label}, second run (every graph captured, every step a replay: "
            f"{replays}): {tokens / dt2:.1f} tok/s aggregate (first run {tokens / dt:.1f}); "
            f"ttft p50/p95 {stats2['ttft_p50_s']}/{stats2['ttft_p95_s']} s (first run "
            f"{stats['ttft_p50_s']}/{stats['ttft_p95_s']}); latency p50/p95 "
            f"{stats2['latency_p50_s']}/{stats2['latency_p95_s']} s; one-slot replays at another "
            f"slot / offset than the capture's: {moved['slot']} / {moved['offset']} | {self.card}")
        self.report.setdefault("serve", {})[label] = {
            "seconds": dt, "tokens": tokens, "distinct_tokens": distinct, "tok_s": tokens / dt,
            "stats": stats, "second_run": {"seconds": dt2, "tok_s": tokens / dt2,
                                           "stats": stats2, "replays": replays},
            "steps": eng.steps, "forwards": f, "launches": counts,
            "peak_memory_bytes": peak, "replays_moved": moved,
            "graphs": {"count": len(keys), "capture_s": eng.graphs.capture_s,
                       "pool_bytes": eng.graphs.pool_bytes(), "by_kind": by_kind,
                       "keys": [str(k) for k in keys]}}
        return results, eng

    def _serve_once(self, torch, eng, prompts):
        """Submit the requests and run the engine: (results, seconds, launch
        counts, peak memory)."""
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import GenRequest
        for uid, p in enumerate(prompts):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=self.SERVE_NEW))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return results, dt, kernels.launch_counts(), torch.cuda.max_memory_allocated()

    def _hold_launches(self, label, counts, f, eng):
        """The launches of a run against what its forwards ``f`` predict."""
        layers = self.model7b[0].num_layers
        total = sum(f.values())
        steps = f["decode"] + f["chunk+decode"]
        fold = not eng.paged and eng.cache_impl == "fold"   # dense decode steps fold
        want = {"rms_norm": (2 * layers + 1) * total, "qmm": 5 * layers * total,
                "fused_mlp": layers * total,
                "pool_decode_attention": layers * steps if eng.paged else 0,
                "decode_attention": 0 if eng.paged else layers * (steps - fold * f["decode"]),
                "flash_prefill_blocked": layers * (f["prefill"] + f["chunk"] + f["chunk+decode"]),
                "flash_prefill": layers * f["admit"], "qmm_t": 0,
                "fused_decode_attention": layers * f["decode"] if fold else 0}
        if {k: counts[k] for k in want} != want:   # kernel 2's forms are checked by path
            raise AssertionError(f"{label}: launches {counts} but the forwards {f} predict {want}")
        self.check_norms(label, counts, total, layers)

    @staticmethod
    def _hold_caches(what, eng, ref):
        """The k/v every request left at its retirement (``snaps``), bit-equal
        between two engines that ran the same requests."""
        if sorted(eng.snaps) != sorted(ref.snaps):
            raise AssertionError(f"{what}: caches of requests {sorted(eng.snaps)} against "
                                 f"{sorted(ref.snaps)}")
        for uid, (_, n, ks, vs) in eng.snaps.items():
            _, m, kr, vr = ref.snaps[uid]
            if n != m or not all(bits_equal(a, b) for a, b in zip(ks + vs, kr + vr)):
                raise AssertionError(f"{what}: request {uid}'s cache at its retirement differs")
        log(f"[serve] {what}: the caches of all {len(eng.snaps)} requests at their retirement "
            f"equal bit for bit")

    @staticmethod
    def _hold_equal(what, results, other):
        """Two runs that must agree token for token (the same bodies, captured
        or not)."""
        if sorted(results) != sorted(other):
            raise AssertionError(f"{what}: requests {sorted(results)} against {sorted(other)}")
        for uid in results:
            if not np.array_equal(results[uid], other[uid]):
                raise AssertionError(f"{what}: request {uid} differs: {results[uid][:12]} ... "
                                     f"against {other[uid][:12]} ...")
        log(f"[serve] {what}: all {len(results)} requests equal token for token")

    def _serve_step_times(self, torch, eng, label="paged", profile=True):
        """Where a serving decode step's time goes, at span 1 and span 8 (8
        slots over the cache the run left, every slot live at its last
        offset): the host time per step through the graph
        (``_decode_span``: the loads, the replay, the host read), the graph's
        device time (CUDA events around replays), and the same body run
        eagerly on the host clock; for the paged engine the eager step under
        torch.profiler (device time per kernel). ``label`` names the engine's
        cache: paged, dense or dense fold (kernels 7, 3 and 9)."""
        state = eng.state
        live0 = state["live"].copy()
        state["live"][:] = True
        offsets = state["host_off"].tolist()
        rows = {}
        with torch.inference_mode():
            for span in (1, 8):
                bucket = eng._span_bucket(state, span)
                key = (span, "greedy", bucket)
                eng._decode_span(state, span, "greedy")   # captures the graph if new
                torch.cuda.synchronize()
                n = 8
                t0 = time.perf_counter()
                for _ in range(n):
                    eng._decode_span(state, span, "greedy")
                host_ms = (time.perf_counter() - t0) / n / span * 1e3
                off0 = state["off"].clone()
                off0.copy_(torch.from_numpy(state["host_off"]).to(torch.int32))
                dev_ms = replay_ms(torch, eng.graphs, key,
                                   lambda: state["off"].copy_(off0), iters=4) / span
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    eng._load(state)
                    eng._decode_body(state, span, "greedy", bucket)
                torch.cuda.synchronize()
                eager_ms = (time.perf_counter() - t0) / n / span * 1e3
                rows[span] = {"host_ms": host_ms, "graph_ms": dev_ms, "eager_ms": eager_ms,
                              "host_share": 1 - dev_ms / host_ms, "bucket": bucket}
                log(f"[serve] {label} decode, 8 slots at offsets {offsets}, span {span} "
                    f"(bucket {bucket}): {host_ms:.3f} ms a step through the graph on the host "
                    f"clock, {dev_ms:.3f} ms of device time (host share "
                    f"{1 - dev_ms / host_ms:.3f}); the body eager {eager_ms:.3f} ms a step; "
                    f"{8e3 / host_ms:.1f} / {8e3 / dev_ms:.1f} / {8e3 / eager_ms:.1f} tok/s | "
                    f"{self.card}")
            if profile:
                bucket = eng._span_bucket(state, 1)

                def step():
                    eng._load(state)
                    eng._decode_step(state, state["toks_t"], state["live_t"], bucket)

                self._profile_steps(torch, "serve-profile", f"eager {label} decode steps of "
                                    "LLaMA-7B, 8 slots", step, 4)
        state["live"][:] = live0
        key = "decode_step" if label == "paged" else f"decode_step {label}"
        self.report.setdefault("serve", {})[key] = {"spans": rows, "offsets": offsets,
                                                    "host_ms": rows[1]["eager_ms"],
                                                    "graph_ms": rows[1]["graph_ms"]}

    def phase_serve(self, torch):
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        cfg, params = self.model7b
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in self.SERVE_LENS]
        res = self.report.setdefault("serve", {})

        # how far batch-8 and batch-1 logits of the same sequence are apart:
        # the rounding the token rule has to allow for
        ids = torch.as_tensor(np.stack([prompts[2]] * 8), device="cuda")
        r8 = ModelRunner("llama", cfg, params, batch_size=8, max_seq_len=128, device="cuda")
        r1 = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=128, device="cuda")
        l8, c8 = r8.prefill(ids, r8.init_cache())
        l1, c1 = r1.prefill(ids[:1], r1.init_cache())
        tok = l1[:, -1:].float().argmax(-1)
        d8, _ = r8.decode(tok.expand(8, 1).contiguous(), c8)
        d1, _ = r1.decode(tok, c1)
        diff = (d8[0].float() - d1[0].float()).abs().max().item()
        scale = d1.float().abs().max().item()
        n = ids.shape[1]
        floor = torch.cat([row_rel_errs(a[0, :n], b[0, :n]).flatten()
                           for ca, cb in ((c8.k, c1.k), (c8.v, c1.v)) for a, b in zip(ca, cb)])
        log(f"[serve] two correct runs, one sequence prefilled at batch 8 and at batch 1: decode "
            f"logits max abs diff {diff:.4f}, max |logit| {scale:.3f}, rel {diff / scale:.2e}; "
            f"k/v cache rows worst {floor.max().item():.2e}, mean {floor.mean().item():.2e} of "
            f"the row's norm (the cache check allows 1e-1 / 2e-2)")
        res["batch8_vs_batch1_rel"] = diff / scale
        res["batch8_vs_batch1_cache_rows"] = {"worst": floor.max().item(),
                                              "mean": floor.mean().item()}
        del floor
        del r8, r1, c8, c1, l8, l1, d8, d1

        # paged, span 8, over a pool that starts as NaN everywhere; the same
        # with every step's body run eagerly first (the graphs' reference)
        eager, eng_e = self._serve_run(torch, "paged span 8 (poisoned pool) eager", None,
                                       prompts, poison=True, eager=True, paged=True,
                                       block_size=16, decode_span=8)
        paged, eng = self._serve_run(torch, "paged span 8 (poisoned pool)", "serve:paged",
                                     prompts, poison=True, paged=True, block_size=16,
                                     decode_span=8)
        self._hold_equal("paged span 8, graphs vs eager", paged, eager)
        self._hold_caches("paged span 8, graphs vs eager", eng, eng_e)
        del eng_e
        state, host_off = eng.state, eng.state["host_off"]
        for i in range(eng.b):   # what each slot's last request wrote holds no NaN
            blocks = state["tables"][i].long()
            for li in range(cfg.num_layers):
                for pool in (state["k"][li], state["v"][li]):
                    live = pool[blocks].reshape(-1, *pool.shape[2:])[:int(host_off[i])]
                    if not torch.isfinite(live.float()).all():
                        raise AssertionError(f"paged: NaN in the live cache of slot {i}, layer {li}")
        log(f"[serve] paged: the live prefix of every slot (offsets {host_off.tolist()}) holds "
            f"no NaN in any of {cfg.num_layers} layers after a run over a pool poisoned with NaN")

        runner = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=2048, device="cuda")
        t0 = time.perf_counter()
        ref, cache_err = self._forced_reference(torch, runner, prompts, paged, eng.snaps)
        t_ref = time.perf_counter() - t0
        del eng, state
        torch.cuda.empty_cache()
        compared, total, same = self._hold_to_reference("paged", paged, ref)
        log(f"[serve] paged vs the single-sequence runner (teacher-forced, {t_ref:.1f} s): "
            f"{compared}/{total} positions clear the margin, all agree; {same}/{total} agree "
            f"in all; the k/v each of the {len(prompts)} requests left in the pool at its "
            f"retirement are within {cache_err['worst']:.2e} of the runner's cache per row (tol "
            f"1e-1), {cache_err['mean']:.2e} in the mean (tol 2e-2), all layers")
        res["paged_vs_runner"] = {"compared": compared, "positions": total, "agree": same,
                                  "cache_row_rel_err": cache_err}

        # the same without spans, over a clean pool: what a span saves on this
        # card. The tokens may part only at a near-tie: a row's decode attention
        # is split by the longest row's length, which a span knows less exactly
        span1, eng = self._serve_run(torch, "paged span 1", "serve:paged", prompts, paged=True,
                                     block_size=16, decode_span=1)
        self._serve_step_times(torch, eng)
        eager, eng_e = self._serve_run(torch, "paged span 1 eager", None, prompts, eager=True,
                                       paged=True, block_size=16, decode_span=1)
        self._hold_equal("paged span 1, graphs vs eager", span1, eager)
        self._hold_caches("paged span 1, graphs vs eager", eng, eng_e)
        del eng_e
        del eng
        torch.cuda.empty_cache()
        equal = self._hold_to_run("span 8 (poisoned pool) vs span 1 (clean pool)", paged, span1,
                                  ref)
        a, b = res["paged span 8 (poisoned pool)"], res["paged span 1"]
        log(f"[serve] span 8 vs span 1: {a['tok_s']:.1f} vs {b['tok_s']:.1f} tok/s "
            f"({a['seconds']:.2f} vs {b['seconds']:.2f} s, {a['steps']} vs {b['steps']} engine "
            f"steps); {equal}/{len(prompts)} requests identical, the others first differ where "
            f"the runner's margin is not clear | {self.card}")

        # dense cache, chunked prefill: fused with the decode step, and not
        fused, eng = self._serve_run(torch, "dense chunk 128 fused", "serve:dense", prompts,
                                     prefill_chunk=128, decode_span=8)
        self._serve_step_times(torch, eng, "dense", profile=False)
        eager, eng_e = self._serve_run(torch, "dense chunk 128 fused eager", None, prompts,
                                       eager=True, prefill_chunk=128, decode_span=8)
        self._hold_equal("dense chunk 128 fused, graphs vs eager", fused, eager)
        self._hold_caches("dense chunk 128 fused, graphs vs eager", eng, eng_e)
        del eng_e
        ref_d, cache_err = self._forced_reference(torch, runner, prompts, fused, eng.snaps)
        del eng
        torch.cuda.empty_cache()
        compared, total, same = self._hold_to_reference("dense chunked", fused, ref_d)
        log(f"[serve] dense chunked vs the single-sequence runner: {compared}/{total} positions "
            f"clear the margin, all agree; {same}/{total} agree in all; the dense cache of "
            f"each of the {len(prompts)} requests at its retirement is within "
            f"{cache_err['worst']:.2e} of the runner's per row, {cache_err['mean']:.2e} in the "
            f"mean")
        res["dense_vs_runner"] = {"compared": compared, "positions": total, "agree": same,
                                  "cache_row_rel_err": cache_err}
        equal = self._hold_to_run("paged vs dense", paged, fused, ref)
        log(f"[serve] paged vs dense chunked: {equal}/{len(prompts)} requests identical, the "
            f"others first differ where the runner's margin is not clear")
        unfused, eng = self._serve_run(torch, "dense chunk 128 unfused", "serve:dense", prompts,
                                       prefill_chunk=128, decode_span=8, fused_chunk_decode=False)
        del eng, runner
        torch.cuda.empty_cache()
        equal = self._hold_to_run("fused vs unfused", fused, unfused, ref_d)
        log(f"[serve] fused vs unfused chunk+decode: {equal}/{len(prompts)} requests identical, "
            f"the others first differ where the runner's margin is not clear")
        self.model7b = None
        del params
        torch.cuda.empty_cache()
        self._serve_cli(torch, kernels)

    def _serve_cli(self, torch, kernels):
        """The serving CLI on the 2-layer 7B-width checkpoint the quantize phase
        packed: load, 12 demo requests of 100 tokens on 8 slots, paged, the
        CLI's default span (1)."""
        from gptq_for_llama_tpu_torch.cli.serve import main as serve_cli
        from gptq_for_llama_tpu_torch.models import hf_loader
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        model, packed = os.path.join(self.tmp, "model"), os.path.join(self.tmp, "packed")
        n, plen, new = 12, 100, 32
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep = serve_cli([model, "--load", packed, "--demo", str(n), "--demo-prompt-len",
                         str(plen), "--max-new-tokens", str(new), "--paged", "--quiet"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
        self.check_path("serve:cli", counts)
        stats, reqs = rep["stats"], rep["requests"]
        if (stats["requests"] != n or stats["tokens"] != n * new or not stats["paged"]
                or [r["uid"] for r in reqs] != list(range(n))
                or any(r["prompt_tokens"] != plen or len(r["tokens"]) != new for r in reqs)):
            raise AssertionError(f"serve CLI: unexpected output {stats}")
        cfg, params = hf_loader.load_params(packed, device="cuda")
        rng = np.random.RandomState(0)   # the CLI's demo prompts, from its --seed
        prompts = [rng.randint(1, cfg.vocab_size, size=(plen,)) for _ in range(n)]
        runner = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=plen + new + 1,
                             device="cuda")
        results = {r["uid"]: np.asarray(r["tokens"]) for r in reqs}
        ref, _ = self._forced_reference(torch, runner, prompts, results)
        compared, total, same = self._hold_to_reference("serve CLI", results, ref)
        log(f"[serve] CLI --demo {n} --paged on the packed 2-layer checkpoint: {dt:.1f} s with "
            f"the load, {stats['tok_s']} tok/s, ttft p50 {stats['ttft_p50_s']} s; "
            f"{compared}/{total} positions clear the runner's margin, all agree ({same}/{total} "
            f"agree in all); launches {counts} | {self.card}")
        self.report["serve"]["cli"] = {"seconds": dt, "stats": stats, "launches": counts,
                                       "compared": compared, "agree": same}

    # -- phase 10: KV caches stored in fp8 (e4m3, e5m2) and f32 ----------------
    KV_NAMES = ("fp8", "fp8_e5m2", "f32")

    def phase_kvdtype(self, torch):
        """Kernels 3, 4, 7 and 9 over caches stored in fp8-e4m3, fp8-e5m2 and
        f32 at their bf16 rows' shapes, then LLaMA-7B decode and serving over
        fp8-e4m3 caches at full width, the e5m2 and f32 legs at 2 layers, and
        the CLIs with --kv-dtype."""
        self.kv_entries = {}
        for name in self.KV_NAMES:
            self._kv_kernel_rows(torch, name)
        self._kv_upcast_codes(torch)
        self._kv_full(torch)
        self._kv_serve(torch)
        self._kv_two_layers(torch)
        self._kv_clis(torch)

    def _kv_record(self, kernel, name, shape, y, ref, ms, pms, lms, nbytes, flops, main=False,
                   extra=None):
        """A kernel row over a ``name`` cache: 1e-2 of each output row's norm,
        as the bf16 rows; ``main`` keeps it as the dtype's row of the kernels
        line."""
        err = (y.float() - ref.float()).abs().max().item()
        self._record(kernel, f"{name} cache, {shape}", err, 1e-2, ms, pms, lms, nbytes, flops,
                     row_rel=row_rel_err(y, ref), ref_max=ref.float().abs().max().item(),
                     extra=dict(extra or {}, kv_dtype=name))
        if main:
            row = self.report["kernels"][kernel][-1]
            self.kv_entries.setdefault(kernel, {})[name] = {
                k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}

    @staticmethod
    def _kv_poison(torch, cache, dead):
        """A copy of ``cache`` holding the dtype's NaN code in every slot that
        ``dead`` (a bool mask of its two leading dims) marks. e4m3's (0x7F)
        reads as 480 in the kernels, which moves any row that attends it far
        past the tolerance; e5m2's and f32's are NaN."""
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        out = cache.clone()
        nan = kv_dtype.encode(torch.tensor([float("nan")], device="cuda"), cache.dtype)
        view = kv_dtype.stored(out)
        view[dead] = nan.to(view.dtype)
        return out

    @staticmethod
    def _kv_equal(torch, a, b):
        """Two caches equal byte for byte (NaN where NaN)."""
        return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    def _kv_kernel_rows(self, torch, name):
        """Kernels 3, 9, 7 and 4 over a ``name`` cache at the bf16 rows' shapes
        (phase ``kernels``), each against its plain version on the same cache
        (``kv_dtype.decode``), with the cache poisoned past each offset. The
        library call upcasts the live cache to bf16 and runs SDPA, both
        timed; the bound counts the cache at its own bytes. Kernel 9's row
        write, with values past e4m3's range, is held byte-equal to the plain
        write."""
        import torch.nn.functional as F
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (
            decode_attention_cuda, decode_attention_plain, fused_decode_attention_cuda,
            fused_decode_attention_plain, pool_decode_attention_cuda, pool_decode_attention_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.flash import (flash_prefill_blocked_cuda,
                                                             flash_prefill_blocked_plain)
        dt = kv_dtype.KV_DTYPES[name]
        isz = torch.empty((), dtype=dt).element_size()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4321)
        bf = torch.bfloat16

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(bf)

        def cache(*shape):   # seeded N(0, 1) values stored in dt, encoded in pieces
            out = torch.empty(shape, dtype=dt, device="cuda")
            flat = kv_dtype.stored(out).view(-1)
            for i in range(0, flat.numel(), 1 << 26):
                n = min(1 << 26, flat.numel() - i)
                flat[i:i + n] = kv_dtype.encode(torch.randn(n, generator=gen, device="cuda"), dt)
            return out

        def up(c, n):   # the library's upcast of the live prefix
            return c[:, :n].to(bf).transpose(1, 2)

        d, s = 128, 2048
        serving = (37, 150, 300, 511, 512, 900, 1200, 1500)
        for fold in (False, True):
            kernel = "fused_decode_attention" if fold else "decode_attention"
            for b, h, hkv, offs in ((1, 32, 32, 0), (1, 32, 32, 127), (1, 32, 32, 2047),
                                    (2, 32, 8, (100, 1500)), (8, 32, 32, serving)):
                ncopy = copies_for(2 * b * s * hkv * d * isz)
                q = randn(b, 1, h, d)
                kn, vn = randn(b, 1, hkv, d), randn(b, 1, hkv, d)
                caches = [(cache(b, s, hkv, d), cache(b, s, hkv, d)) for _ in range(ncopy)]
                off_t = torch.tensor(offs if isinstance(offs, tuple) else [offs] * b,
                                     dtype=torch.int32, device="cuda")
                off_arg = off_t if isinstance(offs, tuple) else offs
                max_live = max(offs) + 1 if offs == serving else None
                kc, vc = caches[0]
                pos = torch.arange(s, device="cuda")[None, :]
                dead = (pos >= off_t[:, None]) if fold else (pos > off_t[:, None])
                pk, pv = self._kv_poison(torch, kc, dead), self._kv_poison(torch, vc, dead)
                if fold:
                    y, _, _ = fused_decode_attention_cuda(q, pk, pv, kn, vn, off_arg, d ** -0.5,
                                                          write=False, max_live=max_live)
                    ref, _, _ = fused_decode_attention_plain(q, kc, vc, kn, vn, off_t, d ** -0.5,
                                                             write=False)

                    def run(c):
                        return fused_decode_attention_cuda(q, c[0], c[1], kn, vn, off_arg,
                                                           d ** -0.5, write=False,
                                                           max_live=max_live)

                    def plain(c):
                        return fused_decode_attention_plain(q, c[0], c[1], kn, vn, off_t,
                                                            d ** -0.5, write=False)
                else:
                    y = decode_attention_cuda(q, pk, pv, off_arg, d ** -0.5, max_live)
                    ref = decode_attention_plain(q, kc, vc, off_t, d ** -0.5)

                    def run(c):
                        return decode_attention_cuda(q, c[0], c[1], off_arg, d ** -0.5, max_live)

                    def plain(c):
                        return decode_attention_plain(q, c[0], c[1], off_t, d ** -0.5)
                torch.cuda.synchronize()
                if not torch.isfinite(y.float()).all():
                    raise AssertionError(f"{kernel} {name} offsets {offs}: a dead slot was read")
                del pk, pv
                live = int((off_t.clamp(max=s - 1) + (0 if fold else 1)).sum().item())
                n = int(off_t.max().item()) + 1
                mask = (pos[:, :n] <= off_t[:, None])[:, None, None, :]
                qt = q.transpose(1, 2)
                gqa = {"enable_gqa": True} if h != hkv else {}
                if fold:   # the library reads the cache with the current row written
                    rows_ = torch.arange(b, device="cuda")
                    for kk, vv in caches:
                        kv_dtype.stored(kk)[rows_, off_t.long()] = kv_dtype.encode(kn[:, 0], dt)
                        kv_dtype.stored(vv)[rows_, off_t.long()] = kv_dtype.encode(vn[:, 0], dt)
                lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                    qt, up(c[0], n), up(c[1], n), attn_mask=mask, **gqa) for c in caches])
                ms = graph_ms(torch, [lambda c=c: run(c) for c in caches])
                pms = graph_ms(torch, [lambda c=c: plain(c) for c in caches], iters=10)
                nbytes = 2 * b * h * d * 2 + (live + (b if fold else 0)) * hkv * d * isz * 2
                self._kv_record(kernel, name, f"B={b} H={h} Hkv={hkv} S={s} offset={offs} "
                                f"(dead slots poisoned{', no write' if fold else ''})", y, ref,
                                ms, pms, lms, nbytes, 4 * (live + (b if fold else 0)) * h * d,
                                main=(h == hkv and offs == 127))
                del caches, kc, vc
        # kernel 9's row write under a mixed mask, values past e4m3's range in
        # the current k (its NaN code, written as JAX's astype writes it)
        b, h = 8, 32
        off_t = torch.tensor(serving, dtype=torch.int32, device="cuda")
        q, kn, vn = randn(b, 1, h, d), randn(b, 1, h, d), randn(b, 1, h, d)
        kn[:, 0, 0, :4] = torch.tensor([600.0, -600.0, 464.0, 465.0], device="cuda").to(bf)
        dead = torch.arange(s, device="cuda")[None, :] >= off_t[:, None]
        kc, vc = (self._kv_poison(torch, cache(b, s, h, d), dead) for _ in range(2))
        wk, wv = kc.clone(), vc.clone()
        wmask = torch.arange(b, device="cuda") % 3 != 1
        y, _, _ = fused_decode_attention_cuda(q, kc, vc, kn, vn, off_t, d ** -0.5,
                                              write_mask=wmask, max_live=max(serving) + 1)
        ref, _, _ = fused_decode_attention_plain(q, wk, wv, kn, vn, off_t, d ** -0.5,
                                                 write_mask=wmask)
        torch.cuda.synchronize()
        if not all(self._kv_equal(torch, a, b_) for a, b_ in ((kc, wk), (vc, wv))):
            raise AssertionError(f"fused_decode_attention {name}: the caches after the masked "
                                 f"write differ from the plain version's")
        ms = graph_ms(torch, [lambda: fused_decode_attention_cuda(
            q, kc, vc, kn, vn, off_t, d ** -0.5, write_mask=wmask, max_live=max(serving) + 1)])
        pms = graph_ms(torch, [lambda: fused_decode_attention_plain(
            q, wk, wv, kn, vn, off_t, d ** -0.5, write_mask=wmask)], iters=10)
        written = int(wmask.sum().item())
        nbytes = 2 * b * h * d * 2 + (sum(serving) + b) * h * d * isz * 2 + \
            written * h * d * isz * 2
        self._kv_record("fused_decode_attention", name,
                        f"B={b} H={h} offsets 37..1500, write under the mask "
                        f"{wmask.int().tolist()}, k_new up to 600 (caches byte-equal)", y, ref,
                        ms, pms, None, nbytes, 4 * (sum(serving) + b) * h * d)
        del kc, vc, wk, wv
        torch.cuda.empty_cache()
        # kernel 7 at the serving shapes over a poisoned pool; bit-equal to
        # kernel 3 over the gathered view
        b, h, bs, mb = 8, 32, 16, 128
        mixed = serving
        for hkv, offs, what in ((32, (127,) * b, "offsets 127"),
                                (32, (2047,) * b, "offsets 2047"), (32, mixed, "offsets 37..1500"),
                                (8, mixed, "GQA, offsets 37..1500")):
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            live = int((off + 1).sum().item())
            ncopy = copies_for(live * hkv * d * isz * 2)
            nb = ncopy * b * mb + 1
            kp, vp = cache(nb, bs, hkv, d), cache(nb, bs, hkv, d)
            q = randn(b, 1, h, d)
            perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
            tables = [perm[i * b * mb:(i + 1) * b * mb].reshape(b, mb).int().contiguous()
                      for i in range(ncopy)]
            dead = (torch.arange(mb * bs, device="cuda")[None, :] > off[:, None]).reshape(b, mb,
                                                                                          bs)
            dead_pool = torch.zeros(nb, bs, dtype=torch.bool, device="cuda")
            dead_pool[0] = True
            for t in tables:
                dead_pool[t.long()] = dead
            kp_clean, vp_clean = kp.clone(), vp.clone()
            kp = self._kv_poison(torch, kp, dead_pool)
            vp = self._kv_poison(torch, vp, dead_pool)
            max_live = max(offs) + 1
            y = pool_decode_attention_cuda(q, kp, vp, tables[0], off, d ** -0.5, max_live)
            ref = pool_decode_attention_plain(q, kp, vp, tables[0], off, d ** -0.5)
            view_k = kp[tables[0].long()].reshape(b, mb * bs, hkv, d)
            view_v = vp[tables[0].long()].reshape(b, mb * bs, hkv, d)
            y3 = decode_attention_cuda(q, view_k, view_v, off, d ** -0.5, max_live)
            torch.cuda.synchronize()
            if not torch.isfinite(y.float()).all() or not torch.equal(y, y3):
                raise AssertionError(f"pool_decode_attention {name} {what}: a poisoned slot was "
                                     f"read, or kernel 3 over the gathered view differs")
            del view_k, view_v
            mask = (torch.arange(max_live, device="cuda")[None, :] <= off[:, None])[:, None, None]
            qt = q.transpose(1, 2)
            gqa = {"enable_gqa": True} if h != hkv else {}
            nlb = -(-max_live // bs)   # the logical blocks the library gathers

            def library(t):
                idx = t[:, :nlb].long()
                kd = kp_clean[idx].reshape(b, nlb * bs, hkv, d)[:, :max_live]
                vd = vp_clean[idx].reshape(b, nlb * bs, hkv, d)[:, :max_live]
                return F.scaled_dot_product_attention(qt, kd.to(bf).transpose(1, 2),
                                                      vd.to(bf).transpose(1, 2),
                                                      attn_mask=mask, **gqa)

            ms = graph_ms(torch, [lambda t=t: pool_decode_attention_cuda(
                q, kp, vp, t, off, d ** -0.5, max_live) for t in tables])
            pms = graph_ms(torch, [lambda t=t: pool_decode_attention_plain(
                q, kp, vp, t, off, d ** -0.5) for t in tables], iters=10)
            lms = graph_ms(torch, [lambda t=t: library(t) for t in tables], iters=10)
            self._kv_record("pool_decode_attention", name,
                            f"B={b} H={h} Hkv={hkv} BS={bs} MB={mb} {what} (poisoned pool, "
                            f"equal to kernel 3 on the gathered view)", y, ref, ms, pms, lms,
                            2 * b * h * d * 2 + live * hkv * d * isz * 2 + b * 4 + live // bs * 4,
                            4 * live * h * d, main=(hkv == 32 and offs == mixed))
            del kp, vp, kp_clean, vp_clean, tables
            torch.cuda.empty_cache()
        # kernel 4 (its mma.sync body for every cache but bf16) at a prompt, a
        # serving chunk and a bucket, the cache poisoned past the causal limit
        b, h, hkv = 1, 32, 32
        for sq, off, skv in ((100, 0, s), (128, 128, 256), (512, 0, 512)):
            ncopy = copies_for(2 * skv * hkv * d * isz)
            q = randn(b, sq, h, d)
            caches = [(cache(b, skv, hkv, d), cache(b, skv, hkv, d)) for _ in range(ncopy)]
            kc, vc = caches[0]
            dead = (torch.arange(skv, device="cuda") >= off + sq)[None, :]
            pk, pv = self._kv_poison(torch, kc, dead), self._kv_poison(torch, vc, dead)
            off_t = torch.tensor([off], dtype=torch.int32, device="cuda")
            y = flash_prefill_blocked_cuda(q, pk, pv, off_t, d ** -0.5, off + sq)
            ref = flash_prefill_blocked_plain(q, kc, vc, off, d ** -0.5)
            torch.cuda.synchronize()
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"flash_prefill_blocked {name} SQ={sq}: a dead slot was read")
            del pk, pv
            n = off + sq
            allowed = (torch.arange(n, device="cuda")[None, :]
                       <= torch.arange(sq, device="cuda")[:, None] + off)
            qt = q.transpose(1, 2)
            iters = 60 if sq <= 128 else 6
            ms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_cuda(
                q, c[0], c[1], off_t, d ** -0.5, off + sq) for c in caches], iters=iters)
            pms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_plain(
                q, c[0], c[1], off_t, d ** -0.5) for c in caches], iters=min(iters, 10))
            lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                qt, up(c[0], n), up(c[1], n), attn_mask=allowed) for c in caches], iters=iters)
            pairs = sum(off + i + 1 for i in range(sq))
            self._kv_record("flash_prefill_blocked", name,
                            f"B={b} SQ={sq} H={h} Hkv={hkv} SKV={skv} offset={off} (device "
                            f"offset, dead slots poisoned) [sync]", y, ref, ms, pms, lms,
                            2 * b * sq * h * d * 2 + b * n * hkv * d * isz * 2,
                            4 * b * h * pairs * d, main=(sq == 100))
            del caches, kc, vc
        torch.cuda.empty_cache()

    def _kv_upcast_codes(self, torch):
        """Every e4m3 code (0x7F and 0xFF included) as the one live slot's V
        row: kernels 3, 7 and 4 return it as bf16 as ``kv_dtype.decode``
        gives it (+-480 for the two NaN codes); kernel 9, with the current
        token's k/v zero, half of it. Equal bit for bit but for code 0x80
        (-0), which a sum started at +0 returns as +0: values are compared."""
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention_cuda,
                                                                 fused_decode_attention_cuda,
                                                                 pool_decode_attention_cuda)
        from gptq_for_llama_tpu_torch.ops.cuda.flash import flash_prefill_blocked_cuda
        codes = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8)
        v = torch.zeros(1, 64, 2, 128, dtype=torch.uint8, device="cuda")
        v[0, 0] = codes.reshape(2, 128)
        v = v.view(torch.float8_e4m3fn)
        k = torch.zeros_like(v)
        q = torch.randn(1, 1, 2, 128, device="cuda").bfloat16()
        want = kv_dtype.decode(v[:, :1], torch.bfloat16)
        zero = torch.zeros(1, 1, 2, 128, device="cuda").bfloat16()
        off = torch.zeros(1, dtype=torch.int32, device="cuda")
        tables = torch.arange(4, dtype=torch.int32, device="cuda")[None]
        got = {"decode_attention": decode_attention_cuda(q, k, v, 0, 0.09),
               "pool_decode_attention": pool_decode_attention_cuda(
                   q, k.reshape(4, 16, 2, 128), v.reshape(4, 16, 2, 128), tables, off, 0.09),
               "flash_prefill_blocked": flash_prefill_blocked_cuda(q, k, v, off, 0.09, 1)}
        fold, _, _ = fused_decode_attention_cuda(q, k, v, zero, zero, 1, 0.09, write=False)
        torch.cuda.synchronize()
        bad = [n for n, y in got.items() if not torch.equal(y, want)]
        if not torch.equal(fold, (want.float() / 2).bfloat16()):
            bad.append("fused_decode_attention")
        if bad or want[0, 0, 0, 0x7F].item() != 480.0 or want[0, 0, 1, 0x7F].item() != -480.0:
            raise AssertionError(f"e4m3 upcast: kernels {bad} differ from the decoder on the 256 "
                                 f"codes")
        # the encoder on the card against the CPU's (held to JAX's astype by the
        # CPU tests) and kernel 9's row write, on every bf16 bit pattern but NaN
        x = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
        keep = ~torch.isnan(x.float())
        for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
            cpu = kv_dtype.encode(x, dt)
            kn = x.reshape(8, 1, 64, 128).to("cuda")
            ck = torch.zeros(8, 16, 64, 128, dtype=dt, device="cuda")
            fused_decode_attention_cuda(torch.zeros_like(kn), ck, ck.clone(), kn, kn, 3, 0.1)
            card = kv_dtype.encode(kn, dt).reshape(-1).cpu()
            written = kv_dtype.stored(ck)[:, 3].reshape(-1).cpu()
            if not (torch.equal(card[keep], cpu[keep]) and torch.equal(written[keep], cpu[keep])):
                raise AssertionError(f"{dt}: the encoder on the card or kernel 9's row write "
                                     f"differs from the CPU encoder")
        log("[kvdtype] the encoder on the card and kernel 9's row write equal the CPU encoder "
            "(JAX's astype) on all 65536 bf16 bit patterns but NaN, in e4m3 and e5m2")
        log("[kvdtype] e4m3 upcast: kernels 3, 7, 9 and 4 read all 256 codes equal to "
            "kv_dtype.decode (the TPU kernels' _load_f32 / _load_bf16; bit for bit but -0): 0x7F "
            "and 0xFF as +-480")
        self.report.setdefault("kvdtype", {})["e4m3_all_codes_bit_equal"] = True

    def _kv_full(self, torch):
        """LLaMA-7B INT4-g128, 32 layers, batch 1, over an fp8-e4m3 cache: the
        full phase's prompts (37, 100, 201 tokens), 64 greedy tokens each
        through generate(span=32) twice, the prefill graphs and the decode
        loops held bit for bit against their bodies run eagerly (the helpers
        of the full phase); host and device ms per token, the prefill graphs'
        ms, the cache's bytes beside a bf16 cache's."""
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
        from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
        cfg = ModelConfig(**LLAMA_7B)
        params = gaussian_wire_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        self.model7b = (cfg, params)
        runner = ModelRunner("llama", cfg, params, device="cuda", kv_dtype=torch.float8_e4m3fn)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (37, 100, 201)]
        new = 64
        torch.cuda.reset_peak_memory_stats()
        runner.warmup(prefill_buckets=tuple(len(p) for p in prompts))
        cache = runner.init_cache()
        kv_bytes = kv_dtype.cache_bytes((*cache.k, *cache.v))
        bf16_bytes = 2 * cfg.num_layers * 2048 * cfg.num_kv_heads * cfg.head_dim * 2
        if kv_bytes * 2 != bf16_bytes:
            raise AssertionError(f"kvdtype: the fp8 cache holds {kv_bytes} B, a bf16 one "
                                 f"{bf16_bytes}")
        prefills = self._prefill_graphs_vs_eager(torch, runner, prompts)
        for rep in range(2):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [generate(runner, p, max_new_tokens=new, temperature=0.0) for p in prompts]
            torch.cuda.synchronize()
            t_gen = time.perf_counter() - t0
            counts = kernels.launch_counts()
            self.check_path("kvdtype:decode", counts)
            if rep == 0:
                first = outs
            elif any(not np.array_equal(a, b) for a, b in zip(first, outs)):
                raise AssertionError("kvdtype: two generate runs of the same prompts differ")
        distinct = len(set(np.concatenate([o[0, len(p):] for p, o in zip(prompts, outs)]).tolist()))
        if distinct < 8:
            raise AssertionError("kvdtype: the model's tokens do not depend on the prompt")
        loop = self._graphs_vs_eager(torch, "kvdtype", runner, prompts, outs, new)
        runner.init_cache()
        offs = runner._store.offs
        dev_ms = replay_ms(torch, runner.graphs, ("decode", 256), lambda: offs.fill_(164))
        runner.init_cache()
        peak = torch.cuda.max_memory_allocated()
        log(f"[kvdtype] LLaMA-7B over an fp8-e4m3 cache ({kv_bytes} B, bf16 {bf16_bytes} B): "
            f"generate(span=32) {t_gen / (3 * new) * 1e3:.3f} ms/token (prefills included); "
            f"host loop {loop['graph_ms']:.3f} ms/token through decode_greedy_scan's graphs, "
            f"{loop['span1_ms']:.3f} through generate(span=1), {loop['eager_ms']:.3f} eager; "
            f"the decode graph {dev_ms:.3f} ms device at offset 164; peak memory "
            f"{peak / 2**30:.2f} GiB; launches {counts} | {self.card}")
        self.report.setdefault("kvdtype", {})["full"] = {
            "kv_bytes": kv_bytes, "bf16_kv_bytes": bf16_bytes, "prefill": prefills,
            "generate_ms_per_token": t_gen / (3 * new) * 1e3, "host_loop": loop,
            "graph_ms_per_token": dev_ms, "peak_memory_bytes": peak, "launches": counts}
        del runner
        torch.cuda.empty_cache()

    def _kv_serve(self, torch):
        """The serve phase's 12 requests on 8 slots of the 7B model over
        fp8-e4m3 pools: paged (block 16, span 8), dense chunk 128 fused, dense
        fold; each run twice (``_serve_run``: the second with every graph
        captured), the paged run's tokens held to the fp8 single-sequence
        runner where its margin is clear, the KV bytes beside a bf16
        engine's."""
        from gptq_for_llama_tpu_torch.runtime import ModelRunner, ServingEngine
        cfg, params = self.model7b
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in self.SERVE_LENS]
        fp8 = torch.float8_e4m3fn
        res = self.report.setdefault("kvdtype", {}).setdefault("serve", {})
        runs = (("fp8 paged span 8", "kvdtype:serve:paged",
                 dict(paged=True, block_size=16, decode_span=8)),
                ("fp8 dense chunk 128 fused", "kvdtype:serve:dense",
                 dict(prefill_chunk=128, decode_span=8)),
                ("fp8 dense fold chunk 128", "kvdtype:serve:fold",
                 dict(prefill_chunk=128, decode_span=8, fused_chunk_decode=False,
                      cache_impl="fold")))
        runner = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=2048, device="cuda",
                             kv_dtype=fp8)
        for label, path, kw in runs:
            served, eng = self._serve_run(torch, label, path, prompts, kv_dtype=fp8, **kw)
            bf16 = ServingEngine("llama", cfg, params, batch_slots=8, max_seq_len=2048,
                                 prefill_buckets=(32, 128, 512), **kw)
            bf16._start()
            kv_bytes, bf16_bytes = eng.kv_bytes(), bf16.kv_bytes()
            del bf16
            torch.cuda.empty_cache()
            if kv_bytes * 2 != bf16_bytes:
                raise AssertionError(f"{label}: the fp8 KV holds {kv_bytes} B, bf16's "
                                     f"{bf16_bytes}")
            line = {"kv_bytes": kv_bytes, "bf16_kv_bytes": bf16_bytes}
            if "paged" in kw:
                # tokens only: two correct fp8 caches of one sequence differ by
                # whole fp8 steps wherever their bf16 inputs straddle a rounding
                # boundary (2.7e-2 of a row's norm in the mean at 7B, 8 slots),
                # past the bf16 cache check's limits
                ref, _ = self._forced_reference(torch, runner, prompts, served)
                compared, total, same = self._hold_to_reference(label, served, ref)
                line.update(compared=compared, positions=total, agree=same)
                log(f"[kvdtype] {label} vs the fp8 single-sequence runner: {compared}/{total} "
                    f"positions clear the margin, all agree; {same}/{total} agree in all")
            log(f"[kvdtype] {label}: KV {kv_bytes} B, a bf16 engine's {bf16_bytes} B | "
                f"{self.card}")
            res[label] = line
            del eng
            torch.cuda.empty_cache()
        del runner
        self.model7b = None
        del params
        torch.cuda.empty_cache()

    def _kv_two_layers(self, torch):
        """A 2-layer 7B-width model (the e2e phase's weights) over caches in
        each dtype: the card's logits (prefill, then steps teacher-forced by
        the plain path's tokens; fp8: the e2e phase's 37-token prompt and 8
        steps, e5m2 and f32: 16 and 4) within 2e-2 of the fp32 CPU path over
        the same cache dtype, tokens equal where the plain top-2 margin
        exceeds twice that; 24 greedy tokens through decode_greedy_scan's
        graphs equal the eager step loop's bit for bit (the e5m2 and f32
        end-to-end legs)."""
        from gptq_for_llama_tpu_torch.convert import params_from_jax
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_tree
        cfg = ModelConfig(arch="llama", vocab_size=32000, hidden_size=4096,
                          intermediate_size=11008, num_layers=2, num_heads=32,
                          num_kv_heads=32, head_dim=128, max_seq_len=64)
        tree = random_wire_tree(cfg, seed=7)
        gparams = params_from_jax(tree, "cuda", torch.bfloat16)
        cparams = params_from_jax(tree, "cpu", torch.float32)
        rel_tol = 2e-2
        out = self.report.setdefault("kvdtype", {}).setdefault("two_layers", {})
        for name in self.KV_NAMES:
            # the e2e phase's prompt and steps for fp8; the CPU path is the
            # cost, so the e5m2 and f32 legs run a shorter prompt
            plen, steps = (37, 8) if name == "fp8" else (16, 4)
            prompt = torch.as_tensor(np.random.RandomState(7).randint(0, cfg.vocab_size,
                                                                      (1, plen)))
            dt = kv_dtype.KV_DTYPES[name]
            gpu = ModelRunner("llama", cfg, gparams, device="cuda", kv_dtype=dt)
            cpu = ModelRunner("llama", cfg, cparams, dtype=torch.float32, device="cpu",
                              kv_dtype=dt)
            lc, cc = cpu.prefill(prompt, cpu.init_cache())
            ref, toks = [lc[0].float()], []
            tok = lc[:, -1:].argmax(-1)
            for _ in range(steps):
                toks.append(tok)
                lc, cc = cpu.decode(tok, cc)
                ref.append(lc[0].float())
                tok = lc[:, -1:].argmax(-1)
            lg, cg = gpu.prefill(prompt.cuda(), gpu.init_cache())
            got = [lg[0].float().cpu()]
            for tok in toks:
                lg, cg = gpu.decode(tok.cuda(), cg)
                got.append(lg[0].float().cpu())
            ref_all, got_all = torch.cat(ref), torch.cat(got)
            scale = ref_all.abs().max().item()
            err = (got_all - ref_all).abs().max().item()
            if not torch.isfinite(got_all).all() or err > rel_tol * scale:
                raise AssertionError(f"kvdtype {name}: 2-layer logits {err / scale} off the "
                                     f"CPU path (tol {rel_tol})")
            compared = agreed = 0
            for r, g in zip(ref, got):
                top2 = r.topk(2, dim=-1)
                sel = (top2.values[:, 0] - top2.values[:, 1]) > 2 * rel_tol * scale
                compared += int(sel.sum())
                agreed += int((g.argmax(-1) == top2.indices[:, 0])[sel].sum())
            if compared == 0 or agreed != compared:
                raise AssertionError(f"kvdtype {name}: 2-layer tokens disagree with the CPU "
                                     f"path ({agreed}/{compared})")
            # graphs against the eager bodies, 24 greedy tokens
            lg, cg = gpu.prefill(prompt.cuda(), gpu.init_cache())
            first = lg[:, -1:].float().argmax(-1)
            scan, _ = gpu.decode_greedy_scan(first, cg, 24)
            lg, ce = gpu._step(prompt.cuda(), gpu.init_cache())
            t, eager = lg[:, -1:].float().argmax(-1), []
            for _ in range(24):
                lg, ce = gpu._step(t, ce)
                t = lg[:, -1:].float().argmax(-1)
                eager.append(t)
            torch.cuda.synchronize()
            if not torch.equal(scan, torch.cat(eager, 1)):
                raise AssertionError(f"kvdtype {name}: the 2-layer graphs' tokens differ from "
                                     f"the eager loop's")
            log(f"[kvdtype] {name} cache, 2-layer 7B width, a {plen}-token prompt and {steps} "
                f"steps: logits max abs err {err:.4f}, "
                f"max |ref| {scale:.3f}, rel {err / scale:.4f} (tol {rel_tol}) against the fp32 "
                f"CPU path over the same cache dtype; tokens {agreed}/{compared} agree where the "
                f"margin is clear; 24 greedy tokens through the graphs equal the eager loop's")
            out[name] = {"max_abs_err": err, "max_abs_ref": scale, "tokens_compared": compared,
                         "tokens_agreed": agreed}
            del gpu, cpu
        del gparams, cparams
        torch.cuda.empty_cache()

    def _kv_clis(self, torch):
        """The CLIs with --kv-dtype on the 2-layer checkpoint the quantize
        phase packed: ``--load OUT --benchmark 128 --check`` and ``serve
        --demo N --paged`` for each dtype (N = 12 for fp8, 4 for the others);
        the cache and the pool in it, the kernels of the path launched on it."""
        from gptq_for_llama_tpu_torch.cli.main import main as cli
        from gptq_for_llama_tpu_torch.cli.serve import main as serve_cli
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        model, packed = os.path.join(self.tmp, "model"), os.path.join(self.tmp, "packed")
        out = self.report.setdefault("kvdtype", {}).setdefault("cli", {})
        for name in self.KV_NAMES:
            kernels.reset_launch_counts()
            rep = cli([model, "synthetic", "--load", packed, "--benchmark", "128", "--check",
                       "--kv-dtype", name])
            counts = kernels.launch_counts()
            bench = rep["benchmark"]
            if (bench["kv_dtype"] != str(kv_dtype.KV_DTYPES[name]).replace("torch.", "")
                    or not np.isfinite(bench["ppl"]) or counts[f"decode_attention:{name}"] == 0):
                raise AssertionError(f"kvdtype CLI --benchmark --kv-dtype {name}: {bench}, "
                                     f"launches {counts}")
            if name == "fp8":
                self.check_path("kvdtype:cli", counts)
            kernels.reset_launch_counts()
            n = 12 if name == "fp8" else 4
            srep = serve_cli([model, "--load", packed, "--demo", str(n), "--demo-prompt-len",
                              "100", "--max-new-tokens", "32", "--paged", "--quiet",
                              "--kv-dtype", name])
            scounts = kernels.launch_counts()
            stats = srep["stats"]
            if (stats["requests"] != n or stats["tokens"] != n * 32
                    or stats["kv_dtype"] != bench["kv_dtype"]
                    or scounts[f"pool_decode_attention:{name}"] == 0):
                raise AssertionError(f"kvdtype serve CLI --kv-dtype {name}: {stats}, launches "
                                     f"{scounts}")
            if name == "fp8":
                self.check_path("kvdtype:serve:cli", scounts)
            log(f"[kvdtype] CLIs --kv-dtype {name}: --benchmark 128 --check ppl "
                f"{bench['ppl']:.3f}, {bench['tokens_per_s']:.1f} tok/s, KV {bench['kv_bytes']} B; "
                f"serve --demo {n} --paged {stats['tok_s']} tok/s, ttft p50 {stats['ttft_p50_s']} "
                f"s, KV {stats['kv_bytes']} B | {self.card}")
            out[name] = {"benchmark": bench, "serve": stats}

    # -- phase 11 --------------------------------------------------------------
    def phase_archs(self, torch):
        """OPT, GPT-NeoX and GPT-2 at their published widths, kernels 3, 4, 5,
        7 and 9 at head dims 64, 80, 96 and 256, kernel 1 at the fused q/k/v
        and NeoX shapes, and LLaMA-7B with fused q/k/v."""
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        self.dim_entries = {}
        seconds = {}

        def step(what, fn, *args):
            t0 = time.perf_counter()
            fn(torch, *args)
            torch.cuda.empty_cache()
            seconds[what] = time.perf_counter() - t0
            log(f"[archs] {what} in {seconds[what]:.1f} s")

        for d in (64, 80, 96, 256):
            step(f"kernel rows at D = {d}", self._dim_kernel_rows, d)
        step("kernel 1 at the fused q/k/v and NeoX-20B shapes", self._qmm_arch_rows)
        for name in ("neox", "opt", "gpt2"):
            step(f"{name} 2 layers against the CPU", self._arch_two_layers, name)
        runs = {"neox": ("paged", "dense", "fold"), "opt": ("paged",), "gpt2": ("dense",)}
        for name, modes in runs.items():
            step(f"{name} at full depth: generate, serving {'/'.join(modes)}", self._arch_full,
                 name, modes)
        step("neox quantize -> save -> reload -> eval", self._arch_quantize, "neox")
        step("LLaMA-7B with fused q/k/v", self._fuse_qkv)
        self.report.setdefault("archs", {})["seconds"] = seconds
        kernels.reset_launch_counts()

    def _dim_kernel_rows(self, torch, d):
        """Kernels 3, 9, 7, 4 and 5 at head dim ``d`` over every cache dtype
        (kernel 5: bf16), at the head counts of the model that has it (64:
        GPT-2 medium's 16, 80: OPT-2.7B's 32, 96: GPT-NeoX-20B's 64; 256: 16
        query heads over 2 kv heads, G = 8), each against its plain version
        (1e-2 of each output row's norm, as at D = 128) over caches holding
        the dtype's NaN code past each offset, two launches bit-equal, kernel
        7 bit-equal to kernel 3 over the gathered view, kernel 4 at offset 0
        bit-equal to kernel 5; timed beside the library's upcast of the live
        cache to bf16 plus SDPA and beside the bound at the cache's bytes."""
        import torch.nn.functional as F
        from gptq_for_llama_tpu_torch.ops import kv_dtype
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (
            decode_attention_cuda, decode_attention_plain, fused_decode_attention_cuda,
            fused_decode_attention_plain, pool_decode_attention_cuda, pool_decode_attention_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.flash import (flash_prefill_blocked_cuda,
                                                             flash_prefill_blocked_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import (flash_prefill_cuda,
                                                                     flash_prefill_plain)
        bf = torch.bfloat16
        gen = torch.Generator(device="cuda")
        gen.manual_seed(d)
        h, hkv_mha = {64: (16, 16), 80: (32, 32), 96: (64, 64), 256: (16, 2)}[d]
        g_row = 8 if d == 256 else 4   # the GQA row's query heads per kv head
        s, sc = 2048, d ** -0.5
        serving = (37, 150, 300, 511, 512, 900, 1200, 1500)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(bf)

        def rec(kernel, name, shape, y, ref, ms, pms, lms, nbytes, flops, main=False):
            err = (y.float() - ref.float()).abs().max().item()
            self._record(kernel, f"D={d} {name} cache, {shape}", err, 1e-2, ms, pms, lms,
                         nbytes, flops, row_rel=row_rel_err(y, ref),
                         ref_max=ref.float().abs().max().item(),
                         extra={"head_dim": d, "kv_dtype": name})
            if main:
                row = self.report["kernels"][kernel][-1]
                self.dim_entries.setdefault(kernel, {}).setdefault(f"d{d}", {})[name] = {
                    k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}

        for name, dt in kv_dtype.KV_DTYPES.items():
            isz = torch.empty((), dtype=dt).element_size()

            def cache(*shape):
                out = torch.empty(shape, dtype=dt, device="cuda")
                flat = kv_dtype.stored(out).view(-1)
                for i in range(0, flat.numel(), 1 << 26):
                    n = min(1 << 26, flat.numel() - i)
                    flat[i:i + n] = kv_dtype.encode(torch.randn(n, generator=gen, device="cuda"),
                                                    dt)
                return out

            def up(c, n):
                return c[:, :n].to(bf).transpose(1, 2)

            bf16 = name == "bf16"
            # kernels 3 and 9: batch 1 at offset 2047 (MHA), and kernel 3's GQA row
            rows = [("decode_attention", 1, hkv_mha, (2047,)),
                    ("fused_decode_attention", 1, hkv_mha, (2047,))]
            if bf16 or d == 256:
                rows.append(("decode_attention", 2, h // g_row, (100, 1500)))
            for kernel, b, hkv, offs in rows:
                fold = kernel == "fused_decode_attention"
                ncopy = copies_for(2 * b * s * hkv * d * isz)
                q = randn(b, 1, h, d)
                kn, vn = randn(b, 1, hkv, d), randn(b, 1, hkv, d)
                caches = [(cache(b, s, hkv, d), cache(b, s, hkv, d)) for _ in range(ncopy)]
                off_t = torch.tensor(offs, dtype=torch.int32, device="cuda")
                kc, vc = caches[0]
                pos = torch.arange(s, device="cuda")[None, :]
                dead = (pos >= off_t[:, None]) if fold else (pos > off_t[:, None])
                pk, pv = self._kv_poison(torch, kc, dead), self._kv_poison(torch, vc, dead)
                if fold:
                    def run(c):
                        return fused_decode_attention_cuda(q, c[0], c[1], kn, vn, off_t, sc,
                                                           write=False)[0]

                    def plain(c):
                        return fused_decode_attention_plain(q, c[0], c[1], kn, vn, off_t, sc,
                                                            write=False)[0]
                else:
                    def run(c):
                        return decode_attention_cuda(q, c[0], c[1], off_t, sc)

                    def plain(c):
                        return decode_attention_plain(q, c[0], c[1], off_t, sc)
                y, y2 = run((pk, pv)), run((pk, pv))
                ref = plain((kc, vc))
                torch.cuda.synchronize()
                if not torch.isfinite(y.float()).all() or not torch.equal(y, y2):
                    raise AssertionError(f"{kernel} D={d} {name} offsets {offs}: a dead slot was "
                                         f"read, or two launches differ")
                del pk, pv
                live = int((off_t + (0 if fold else 1)).sum().item())
                n = int(off_t.max().item()) + 1
                mask = (pos[:, :n] <= off_t[:, None])[:, None, None, :]
                qt = q.transpose(1, 2)
                gqa = {"enable_gqa": True} if h != hkv else {}
                lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                    qt, up(c[0], n), up(c[1], n), attn_mask=mask, **gqa) for c in caches])
                ms = graph_ms(torch, [lambda c=c: run(c) for c in caches])
                pms = graph_ms(torch, [lambda c=c: plain(c) for c in caches], iters=6)
                extra_slots = b if fold else 0
                rec(kernel, name, f"B={b} H={h} Hkv={hkv} S={s} offsets={offs} (dead slots "
                    f"poisoned, two launches bit-equal{', no write' if fold else ''})", y, ref,
                    ms, pms, lms, 2 * b * h * d * 2 + (live + extra_slots) * hkv * d * isz * 2,
                    4 * (live + extra_slots) * h * d, main=(b == 1))
                del caches, kc, vc
            # kernel 7: the eight serving slots over a poisoned pool, bit-equal
            # to kernel 3 over the gathered view
            b, bs, mb, hkv = 8, 16, 128, hkv_mha
            off = torch.tensor(serving, dtype=torch.int32, device="cuda")
            live = int((off + 1).sum().item())
            nb = b * mb + 1
            kp, vp = cache(nb, bs, hkv, d), cache(nb, bs, hkv, d)
            q = randn(b, 1, h, d)
            perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
            tables = perm.reshape(b, mb).int().contiguous()
            dead = (torch.arange(mb * bs, device="cuda")[None, :] > off[:, None]).reshape(b, mb,
                                                                                          bs)
            dead_pool = torch.zeros(nb, bs, dtype=torch.bool, device="cuda")
            dead_pool[0] = True
            dead_pool[tables.long()] = dead
            kp_clean, vp_clean = kp.clone(), vp.clone()
            kp, vp = self._kv_poison(torch, kp, dead_pool), self._kv_poison(torch, vp, dead_pool)
            max_live = max(serving) + 1
            y = pool_decode_attention_cuda(q, kp, vp, tables, off, sc, max_live)
            ref = pool_decode_attention_plain(q, kp, vp, tables, off, sc)
            y3 = decode_attention_cuda(q, kp[tables.long()].reshape(b, mb * bs, hkv, d),
                                       vp[tables.long()].reshape(b, mb * bs, hkv, d), off, sc,
                                       max_live)
            torch.cuda.synchronize()
            if not torch.isfinite(y.float()).all() or not torch.equal(y, y3):
                raise AssertionError(f"pool_decode_attention D={d} {name}: a poisoned slot was "
                                     f"read, or kernel 3 over the gathered view differs")
            del y3
            nlb = -(-max_live // bs)
            mask = (torch.arange(max_live, device="cuda")[None, :] <= off[:, None])[:, None, None]
            qt = q.transpose(1, 2)
            gqa = {"enable_gqa": True} if h != hkv else {}

            def library():
                idx = tables[:, :nlb].long()
                kd = kp_clean[idx].reshape(b, nlb * bs, hkv, d)[:, :max_live]
                vd = vp_clean[idx].reshape(b, nlb * bs, hkv, d)[:, :max_live]
                return F.scaled_dot_product_attention(qt, kd.to(bf).transpose(1, 2),
                                                      vd.to(bf).transpose(1, 2), attn_mask=mask,
                                                      **gqa)

            ms = graph_ms(torch, [lambda: pool_decode_attention_cuda(q, kp, vp, tables, off, sc,
                                                                     max_live)])
            pms = graph_ms(torch, [lambda: pool_decode_attention_plain(q, kp, vp, tables, off,
                                                                       sc)], iters=6)
            lms = graph_ms(torch, [library], iters=10)
            rec("pool_decode_attention", name, f"B={b} H={h} BS={bs} MB={mb} offsets 37..1500 "
                f"(poisoned pool, equal to kernel 3 on the gathered view)", y, ref, ms, pms, lms,
                2 * b * h * d * 2 + live * hkv * d * isz * 2 + b * 4 + live // bs * 4,
                4 * live * h * d, main=True)
            del kp, vp, kp_clean, vp_clean
            # kernel 4: a prompt (SQ = 100, offset 0) and a serving chunk (SQ =
            # 128 at offset 128), the cache poisoned past the causal limit;
            # at offset 0 over bf16 bit-equal to kernel 5 on the same rows
            for sq, off0, skv in ((100, 0, s), (128, 128, 256))[:2 if bf16 else 1]:
                hkv = hkv_mha
                ncopy = copies_for(2 * skv * hkv * d * isz)
                q = randn(1, sq, h, d)
                caches = [(cache(1, skv, hkv, d), cache(1, skv, hkv, d)) for _ in range(ncopy)]
                kc, vc = caches[0]
                dead = (torch.arange(skv, device="cuda") >= off0 + sq)[None, :]
                pk, pv = self._kv_poison(torch, kc, dead), self._kv_poison(torch, vc, dead)
                off_t = torch.tensor([off0], dtype=torch.int32, device="cuda")
                y = flash_prefill_blocked_cuda(q, pk, pv, off_t, sc, off0 + sq)
                ref = flash_prefill_blocked_plain(q, kc, vc, off0, sc)
                same5 = None
                if bf16 and off0 == 0:
                    k5, v5 = kc[:, :sq].contiguous(), vc[:, :sq].contiguous()
                    same5 = torch.equal(flash_prefill_blocked_cuda(q, k5, v5, 0, sc),
                                        flash_prefill_cuda(q, k5, v5, sc))
                torch.cuda.synchronize()
                if not torch.isfinite(y.float()).all() or same5 is False:
                    raise AssertionError(f"flash_prefill_blocked D={d} {name} SQ={sq}: a dead "
                                         f"slot was read, or kernel 4 at offset 0 differs from "
                                         f"kernel 5")
                del pk, pv
                n = off0 + sq
                allowed = (torch.arange(n, device="cuda")[None, :]
                           <= torch.arange(sq, device="cuda")[:, None] + off0)
                qt = q.transpose(1, 2)
                ms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_cuda(
                    q, c[0], c[1], off_t, sc, off0 + sq) for c in caches])
                pms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_plain(
                    q, c[0], c[1], off_t, sc) for c in caches], iters=6)
                gqa = {"enable_gqa": True} if h != hkv else {}
                lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                    qt, up(c[0], n), up(c[1], n), attn_mask=allowed, **gqa) for c in caches])
                pairs = sum(off0 + i + 1 for i in range(sq))
                rec("flash_prefill_blocked", name, f"B=1 SQ={sq} H={h} SKV={skv} offset={off0} "
                    f"(device offset, dead slots poisoned){'' if same5 is None else ', bit-equal to kernel 5 at offset 0'} [sync]",
                    y, ref, ms, pms, lms, 2 * sq * h * d * 2 + n * hkv * d * isz * 2,
                    4 * h * pairs * d, main=(sq == 100))
                del caches, kc, vc
        # kernel 5: causal, no cache, S = 2048 (the calibration and eval window)
        b, s5, hkv = 1, 2048, h if d != 256 else 2
        q, k, v = randn(b, s5, h, d), randn(b, s5, hkv, d), randn(b, s5, hkv, d)
        y, y2 = flash_prefill_cuda(q, k, v, sc), flash_prefill_cuda(q, k, v, sc)
        ref = flash_prefill_plain(q, k, v, sc)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            raise AssertionError(f"flash_prefill D={d}: two launches differ")
        gqa = {"enable_gqa": True} if h != hkv else {}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = graph_ms(torch, [lambda: flash_prefill_cuda(q, k, v, sc)], iters=6)
        pms = graph_ms(torch, [lambda: flash_prefill_plain(q, k, v, sc)], iters=2)
        lms = graph_ms(torch, [lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                      **gqa)], iters=6)
        rec("flash_prefill", "bf16", f"B={b} S={s5} H={h} Hkv={hkv} causal [sync], two launches "
            f"bit-equal", y, ref, ms, pms, lms, 2 * b * s5 * h * d * 2 + 2 * b * s5 * hkv * d * 2,
            2 * b * h * s5 * (s5 + 1) * d, main=True)
        del q, k, v
        torch.cuda.empty_cache()

    def _qmm_arch_rows(self, torch):
        """Kernel 1 at the fused q/k/v of LLaMA-7B (4096 x 12288, M = 1 and 8;
        its columns against the three unfused launches) and at GPT-NeoX-20B's
        linears with their biases (query_key_value 6144 x 18432, dense, the
        MLP), M = 1 and 8; tolerance as the kernels phase's rows."""
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import _launch, plan_for, qmm_cuda
        from gptq_for_llama_tpu_torch.ops.linear import PackedLinear, quant_matmul_plain
        bf = torch.bfloat16
        rng = np.random.RandomState(77)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(77)
        fused = {}
        for k, n, what, bias in ((4096, 12288, "fused qkv_proj (LLaMA-7B)", False),
                                 (6144, 18432, "query_key_value (NeoX-20B)", True),
                                 (6144, 6144, "attention.dense (NeoX-20B)", True),
                                 (6144, 24576, "dense_h_to_4h (NeoX-20B)", True),
                                 (24576, 6144, "dense_4h_to_h (NeoX-20B)", True)):
            if n == 12288:   # concat_outputs of three 4096 x 4096 linears, as fuse_attention
                parts = [self._linears(torch, rng, k, 4096, copies_for(k * n // 2))
                         for _ in range(3)]
                lins = [PackedLinear.concat_outputs([p[i] for p in parts])
                        for i in range(len(parts[0]))]
            else:
                lins = self._linears(torch, rng, k, n, copies_for(k * n // 2))
            if bias:
                b_ = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(bf)
                for lin in lins:
                    lin.bias = b_
            wdq = [lins[0].dequantize(bf) for _ in range(copies_for(k * n * 2))]
            for m in (1, 8):
                x = (torch.randn(m, k, generator=gen, device="cuda")).to(bf)
                y = qmm_cuda(x, lins[0])
                p = plan_for(x, lins[0])
                ref = quant_matmul_plain(x, lins[0], bf)
                err = (y.float() - ref.float()).abs().max().item()
                tol = 2e-2 * ref.float().abs().max().item()
                ms = graph_ms(torch, [lambda l=l: qmm_cuda(x, l) for l in lins])
                pms = graph_ms(torch, [lambda l=l: quant_matmul_plain(x, l, bf) for l in lins],
                               iters=10)
                lms = graph_ms(torch, [lambda w=w: torch.matmul(x, w) + (lins[0].bias if bias
                                                                         else 0) for w in wdq])
                extra = {"form": {"path": p.path, "rows": p.mt, "split": p.split}}
                if n == 12288:
                    unf = torch.cat([qmm_cuda(x, part[0]) for part in parts], dim=-1)
                    # the three launches under the fused launch's plan: the same
                    # K split, so the same sums in the same order
                    forced = torch.cat([_launch(x, part[0], p) for part in parts], dim=-1)
                    torch.cuda.synchronize()
                    diff = (y.float() - unf.float()).abs().max().item()
                    same, same_forced = torch.equal(y, unf), torch.equal(y, forced)
                    plans = [plan_for(x, part[0]) for part in parts]
                    extra["vs_unfused"] = {"bit_equal": same, "max_abs_diff": diff,
                                           "bit_equal_under_fused_plan": same_forced,
                                           "unfused_form": {"path": plans[0].path,
                                                            "split": plans[0].split}}
                    fused[m] = extra["vs_unfused"]
                    if diff > tol or not same_forced:
                        raise AssertionError(f"fused qkv M={m}: the fused columns differ from "
                                             f"the three unfused launches by {diff} (tol "
                                             f"{tol}), bit-equal under the fused plan: "
                                             f"{same_forced}")
                    log(f"[archs] fused qkv M={m}: columns vs three unfused launches "
                        f"{'bit-equal' if same else f'max abs diff {diff:.3e} (tol {tol:.3e})'};"
                        f" fused plan {p.path} split {p.split}, unfused {plans[0].path} split "
                        f"{plans[0].split}; under the fused plan bit-equal")
                self._record("qmm", f"{what} {k}x{n} M={m}", err, tol, ms, pms, lms,
                             m * k * 2 + self._lin_bytes(lins[0]) + m * n * 2 + (n * 2 if bias
                                                                                  else 0),
                             2 * m * k * n, path=p.path, extra=extra)
            del lins, wdq
        self.report["fused_qkv_columns"] = fused
        torch.cuda.empty_cache()

    def _arch_model(self, torch, name, layers=None, device="cuda", seed=0):
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.runtime.random_model import GAUSSIAN_WIRE
        spec = dict(ARCH_CONFIGS[name])
        if layers is not None:
            spec["num_layers"] = layers
        cfg = ModelConfig(**spec)
        return cfg, GAUSSIAN_WIRE[name](cfg, seed=seed, device=device, dtype=torch.bfloat16)

    def _hold_to_cpu(self, torch, label, name, cfg, gpu_params, cpu_params, prompt, steps,
                     **runner_kw):
        """Prefill and ``steps`` decode steps teacher-forced with the CPU's
        greedy tokens, card (bf16, kernels) against CPU (fp32, plain
        versions): logits within 2e-2 of their largest (bf16 activations and
        weights rounded at every op boundary of two full-width layers and
        the head, against fp32; measured 4.8e-3 on an H100, the margin keeps
        the token check live), greedy tokens equal where the CPU's top-2
        margin exceeds twice that. Returns (err, scale, agreed, compared)."""
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        gpu = ModelRunner(name, cfg, gpu_params, dtype=torch.bfloat16, device="cuda",
                          **runner_kw)
        cpu = ModelRunner(name, cfg, cpu_params, dtype=torch.float32, device="cpu")
        prompt = torch.as_tensor(prompt[None])
        lc, cc = cpu.prefill(prompt, cpu.init_cache())
        ref, toks = [lc[0].float()], []
        tok = lc[:, -1:].argmax(-1)
        for _ in range(steps):
            toks.append(tok)
            lc, cc = cpu.decode(tok, cc)
            ref.append(lc[0].float())
            tok = lc[:, -1:].argmax(-1)
        lg, cg = gpu.prefill(prompt.cuda(), gpu.init_cache())
        got = [lg[0].float().cpu()]
        for tok in toks:
            lg, cg = gpu.decode(tok.cuda(), cg)
            got.append(lg[0].float().cpu())
        torch.cuda.synchronize()
        ref_all, got_all = torch.cat(ref), torch.cat(got)
        if not torch.isfinite(got_all).all():
            raise AssertionError(f"{label}: non-finite logits on the card")
        rel_tol = 2e-2
        scale = ref_all.abs().max().item()
        err = (got_all - ref_all).abs().max().item()
        compared = agreed = 0
        for r, g in zip(ref, got):
            top2 = r.topk(2, dim=-1)
            sel = (top2.values[:, 0] - top2.values[:, 1]) > 2 * rel_tol * scale
            compared += int(sel.sum())
            agreed += int((g.argmax(-1) == top2.indices[:, 0])[sel].sum())
        log(f"[{label}] logits card vs CPU: max abs err {err:.4f}, max |ref| {scale:.3f}, rel "
            f"{err / scale:.4f} (tol {rel_tol}); greedy tokens {agreed}/{compared} agree where "
            f"the CPU's top-2 margin exceeds {2 * rel_tol * scale:.3f}")
        if err > rel_tol * scale or compared == 0 or agreed != compared:
            raise AssertionError(f"{label}: the card disagrees with the CPU")
        del gpu, cpu
        return err, scale, agreed, compared

    def _arch_two_layers(self, torch, name):
        """A 2-layer model of ``name`` at its published width on the card
        against the same weights on the CPU (fp32, plain versions)."""
        cfg, params = self._arch_model(torch, name, layers=2, seed=5)
        cpu_params = _tree_to_cpu(params, torch.float32)
        prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, size=29)
        t0 = time.perf_counter()
        err, scale, agreed, compared = self._hold_to_cpu(torch, f"archs {name} 2-layer", name,
                                                         cfg, params, cpu_params, prompt, 6)
        self.report.setdefault("archs", {}).setdefault(name, {})["two_layers"] = {
            "max_abs_err": err, "max_abs_ref": scale, "tokens_agreed": agreed,
            "tokens_compared": compared, "seconds": time.perf_counter() - t0}
        del params, cpu_params

    def _arch_full(self, torch, name, modes):
        """``name`` at its published width and depth, batch 1: ``generate``
        through the graphs twice (the same tokens; ms/token), the decode
        graph's device time, launches by kernel and head dim; then 8-slot
        serving in ``modes`` (paged span 8, dense chunk 128, dense fold),
        each run twice (the second with every graph captured): tok/s, ttft,
        the same tokens both runs."""
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine
        from gptq_for_llama_tpu_torch.runtime import generate
        from gptq_for_llama_tpu_torch.runtime.graphs import bucket_for
        t0 = time.perf_counter()
        cfg, params = self._arch_model(torch, name)
        torch.cuda.synchronize()
        wbytes = torch.cuda.memory_allocated()
        log(f"[archs] {name} ({cfg.num_layers} layers, hidden {cfg.hidden_size}, D "
            f"{cfg.head_dim}) INT4-g128 weights made in {time.perf_counter() - t0:.1f} s, "
            f"{wbytes / 2**30:.2f} GiB on the card")
        out = self.report.setdefault("archs", {}).setdefault(name, {})
        d = cfg.head_dim
        rng = np.random.RandomState(len(name))
        max_len = cfg.max_seq_len   # the published context: NeoX and OPT 2048, GPT-2 1024
        prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (37, 100)]
        new = 32
        runs = {}
        for impl in ("classic", "fold") if "fold" in modes else ("classic",):
            runner = ModelRunner(name, cfg, params, device="cuda", max_seq_len=max_len,
                                 cache_impl=impl)
            runner.warmup(prefill_buckets=tuple(len(p) for p in prompts))
            for rep in range(2):
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = [generate(runner, p, max_new_tokens=new, temperature=0.0) for p in prompts]
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
                if rep == 0:
                    first = got
            if any(not np.array_equal(a, b) for a, b in zip(first, got)):
                raise AssertionError(f"{name} {impl}: two generate runs differ")
            counts = kernels.launch_counts()
            self.check_path(f"arch:{name}:{'decode' if impl == 'classic' else 'fold'}", counts)
            distinct = len(set(np.concatenate([o[0, len(p):] for p, o in zip(prompts, got)])
                               .tolist()))
            if distinct < 8:
                raise AssertionError(f"{name}: the tokens do not depend on the prompt")
            cache = runner.init_cache()
            logits, cache = runner.prefill(torch.as_tensor(prompts[1][None], device="cuda"),
                                           cache)
            tok = logits[:, -1:].float().argmax(-1)
            runner.decode(tok, cache)
            offs = runner._store.offs
            key = ("decode", bucket_for(101, runner.decode_buckets))
            dev_ms = replay_ms(torch, runner.graphs, key, lambda: offs.fill_(101))
            by_d = {k: v for k, v in counts.items() if k.endswith(f":d{d}") and v}
            ms_tok = dt / (len(prompts) * new) * 1e3
            log(f"[archs] {name} generate(span=32) {impl}: {len(prompts)} prompts x {new} "
                f"tokens, {ms_tok:.3f} ms/token (prefills included, graphs replayed); decode "
                f"graph at offset 101 {dev_ms:.3f} ms device; {distinct} distinct tokens; "
                f"launches {_nonzero(counts)} | {self.card}")
            runs[impl] = {"ms_per_token": ms_tok, "decode_graph_ms": dev_ms,
                          "launches": counts, "launches_by_head_dim": by_d,
                          "distinct_tokens": distinct}
            if impl == "fold" and any(not np.array_equal(a, b)
                                      for a, b in zip(first, self._classic_tokens)):
                agree = np.mean([np.mean(a == b) for a, b in zip(first, self._classic_tokens)])
                log(f"[archs] {name} fold vs classic tokens: {agree:.3f} of positions equal "
                    f"(bf16 rounds the current k/v differently after a near tie)")
            self._classic_tokens = first
            del runner
            torch.cuda.empty_cache()
        out["decode"] = runs
        # serving: 8 slots, 12 requests
        srng = np.random.RandomState(9)
        sprompts = [srng.randint(0, cfg.vocab_size, size=n)
                    for n in (37, 60, 99, 150, 201, 256, 300, 41, 77, 120, 180, 230)]
        snew = 24
        kw_of = {"paged": dict(paged=True, block_size=16, decode_span=8),
                 "dense": dict(prefill_chunk=128),
                 "fold": dict(cache_impl="fold", decode_span=8)}
        serve = {}
        for mode in modes:
            eng = ServingEngine(name, cfg, params, batch_slots=8, max_seq_len=max_len,
                                device="cuda", **kw_of[mode])
            results = []
            for rep in range(2):
                kernels.reset_launch_counts()
                for uid, p in enumerate(sprompts):
                    eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=snew))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = eng.run()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
                results.append((res, dt, eng.stats()))
            (r1, dt1, st1), (r2, dt2, st2) = results
            if set(r1) != set(range(len(sprompts))) or any(
                    not np.array_equal(r1[u], r2[u]) or len(r1[u]) != snew for u in r1):
                raise AssertionError(f"{name} serve {mode}: incomplete, or the two runs differ")
            counts = kernels.launch_counts()
            self.check_path(f"arch:{name}:serve:{mode}" if mode != "fold"
                            else f"arch:{name}:fold", counts)
            tokens = len(sprompts) * snew
            log(f"[archs] {name} serve {mode} (8 slots, {len(sprompts)} requests x {snew}): "
                f"{tokens / dt2:.1f} tok/s, ttft p50/p95 {st2['ttft_p50_s']}/{st2['ttft_p95_s']} "
                f"s, latency p50 {st2['latency_p50_s']} s (first run, captures included, "
                f"{tokens / dt1:.1f} tok/s); KV {st2['kv_bytes'] / 2**30:.2f} GiB; launches "
                f"{_nonzero(counts)} | {self.card}")
            serve[mode] = {"tok_s": tokens / dt2, "tok_s_first_run": tokens / dt1,
                           "stats": st2, "launches": counts}
            del eng
            torch.cuda.empty_cache()
        out["serve"] = serve
        out["weight_bytes_on_card"] = wbytes
        del params
        torch.cuda.empty_cache()

    def _arch_quantize(self, torch, name):
        """quantize -> save -> reload -> perplexity through the port's CLI
        (``python -m gptq_for_llama_tpu_torch``, two processes, each writing
        its report with its launches by phase) on a 2-layer dense F16
        checkpoint of ``name`` at its published width in HF layout, written
        from a seed: the calibration forward on kernel 5 at the arch's head
        dim, the reloaded wire bytes equal to the saved file, a finite
        perplexity equal after the reload."""
        from gptq_for_llama_tpu_torch.engine.checkpoint import _HF_LAYOUT
        from gptq_for_llama_tpu_torch.engine.quantize import get_path
        from gptq_for_llama_tpu_torch.models import hf_loader
        from gptq_for_llama_tpu_torch.models.registry import get_arch
        layers = 2
        model, out = (os.path.join(self.tmp, f"{name}_model"),
                      os.path.join(self.tmp, f"{name}_packed"))
        t0 = time.perf_counter()
        nbytes = write_dense_arch(torch, name, model, layers, seed=13)
        log(f"[archs] dense F16 {name} at published width, {layers} layers: "
            f"{nbytes / 2**30:.2f} GiB written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

        def cli(args, tag):
            path = os.path.join(self.tmp, f"{name}_{tag}.json")
            proc = subprocess.run([sys.executable, "-m", "gptq_for_llama_tpu_torch", *args,
                                   "--report", path], cwd=os.path.dirname(
                                       os.path.abspath(__file__)), capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode:
                raise AssertionError(f"{name} CLI {tag} exited {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            with open(path) as f:
                return json.load(f)

        rep1 = cli([model, "synthetic", "--wbits", "4", "--groupsize", "128", "--nsamples", "32",
                    "--save", out, "--eval"], "quantize")
        rep2 = cli([model, "synthetic", "--load", out, "--eval", "--benchmark", "64", "--check"],
                   "reload")
        dt = time.perf_counter() - t0
        self.check_path(f"arch:{name}:quantize", rep1["launches"]["quantize"])
        ppl1, ppl2 = rep1["ppl"]["synthetic"], rep2["ppl"]["synthetic"]
        if not (math.isfinite(ppl1) and math.isfinite(ppl2)) or abs(ppl1 - ppl2) > 1e-4 * ppl2:
            raise AssertionError(f"{name} quantize: ppl {ppl1} after quantizing vs {ppl2} "
                                 f"reloaded")
        flat = hf_loader.read_flat_state(out)
        cfg, packed = hf_loader.load_params(out, device="cuda")
        prefix = _HF_LAYOUT[name][0]
        nbuf = 0
        for li, lp in enumerate(packed["layers"]):
            for lin in get_arch(name).LAYER_LINEARS:
                for k, v in get_path(lp, lin).to_wire().items():
                    ref = flat[f"{prefix}.{li}.{lin}.{k}"]
                    if v.dtype != ref.dtype or v.tobytes() != ref.tobytes():
                        raise AssertionError(f"{name} reload: layers.{li}.{lin}.{k} differs")
                    nbuf += 1
        split = {k: v / layers for k, v in rep1["quantize_split"].items()}
        log(f"[archs] {name} CLI quantize+save+eval and reload+eval+benchmark in {dt:.1f} s; "
            f"s/layer {json.dumps({k: round(v, 3) for k, v in split.items()})}; ppl "
            f"{ppl1:.4f} / {ppl2:.4f} reloaded; {nbuf} wire buffers byte-equal to the saved "
            f"file; decode benchmark {rep2['benchmark']['tokens_per_s']:.1f} tok/s; launches "
            f"quantize {_nonzero(rep1['launches']['quantize'])}, eval "
            f"{_nonzero(rep2['launches']['eval:synthetic'])} | {self.card}")
        self.report.setdefault("archs", {}).setdefault(name, {})["quantize"] = {
            "layers": layers, "s_per_layer": split, "ppl": [ppl1, ppl2], "buffers": nbuf,
            "benchmark": rep2["benchmark"], "launches": [rep1["launches"], rep2["launches"]]}
        del packed, flat

    def _fuse_qkv(self, torch):
        """LLaMA-7B (the ``full`` phase's model) with ``fuse_qkv=True``:
        kernel-1 launches per decode token (96 against 160), ms per token of
        both through ``decode_greedy_scan``'s graphs; the unfused model under
        the fused launch's plans bit-equal to the fused one (prompt logits and
        greedy tokens); and the 2-layer 7B-width model fused on the card
        against the unfused CPU path."""
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
        if self.model7b is None:
            cfg = ModelConfig(**LLAMA_7B)
            self.model7b = (cfg, gaussian_wire_llama(cfg, seed=0, device="cuda"))
        cfg, params = self.model7b
        prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, size=100)
        steps = 64
        res = {}
        for fuse in (False, True):
            runner = ModelRunner("llama", cfg, params, device="cuda", max_seq_len=512,
                                 fuse_qkv=fuse)
            for rep in range(2):
                logits, cache = runner.prefill(torch.as_tensor(prompt[None], device="cuda"),
                                               runner.init_cache())
                prompt_logits = logits[0].float()
                tok = logits[:, -1:].float().argmax(-1)
                kernels.reset_launch_counts()
                f0 = runner.forwards["decode"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks, cache = runner.decode_greedy_scan(tok, cache, steps)
                toks = toks.cpu().numpy()
                dt = time.perf_counter() - t0
            counts = kernels.launch_counts()
            fwd = runner.forwards["decode"] - f0
            if fuse:
                self.check_path("fuse_qkv:decode", counts)
            res[fuse] = {"ms_per_token": dt / steps * 1e3, "qmm_per_token": counts["qmm"] / fwd,
                         "tokens": toks, "logits": prompt_logits}
            del runner
        per = {k: v["qmm_per_token"] for k, v in res.items()}
        if per != {False: 5 * cfg.num_layers, True: 3 * cfg.num_layers}:
            raise AssertionError(f"fuse_qkv: kernel-1 launches per decode token {per}, want "
                                 f"{5 * cfg.num_layers} unfused and {3 * cfg.num_layers} fused")
        same = res[False]["tokens"][0] == res[True]["tokens"][0]
        first = int(np.argmin(same)) if not same.all() else steps
        # kernel 1's plan splits K in two for each 4096-wide q/k/v and not at
        # all at N = 12288, so the fused model rounds otherwise. The unfused
        # model under the fused launch's plans (``plan_for`` patched for the
        # q/k/v linears only: the same K split, so the same sums in the same
        # order) must give the fused model's prompt logits and greedy tokens
        # bit for bit
        from gptq_for_llama_tpu_torch.ops.cuda import matmul as qmm_mod
        qkv = {id(lp["self_attn"][n].qweight) for lp in params["layers"]
               for n in ("q_proj", "k_proj", "v_proj")}
        n_fused = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        natural = qmm_mod.plan_for

        def fused_plan(x2, lin):
            if id(lin.qweight) not in qkv:
                return natural(x2, lin)
            return qmm_mod.plan(x2.shape[0], lin.in_features, n_fused, lin.bits,
                                qmm_mod._sm_count(x2.device.index or 0),
                                groupsize=lin.groupsize)

        qmm_mod.plan_for = fused_plan
        try:
            r = ModelRunner("llama", cfg, params, device="cuda", max_seq_len=512)
            logits, cache = r.prefill(torch.as_tensor(prompt[None], device="cuda"),
                                      r.init_cache())
            forced_logits = logits[0].float()
            forced_toks = r.decode_greedy_scan(logits[:, -1:].float().argmax(-1), cache,
                                               steps)[0].cpu().numpy()
        finally:
            qmm_mod.plan_for = natural
        del r
        exact = (torch.equal(forced_logits, res[True]["logits"])
                 and np.array_equal(forced_toks, res[True]["tokens"]))
        scale = res[False]["logits"].abs().max().item()
        err = (res[True]["logits"] - res[False]["logits"]).abs().max().item()
        log(f"[archs] LLaMA-7B decode_greedy_scan, {steps} tokens after a 100-token prompt: "
            f"kernel-1 launches per token {per[False]:g} unfused / {per[True]:g} fused; "
            f"{res[False]['ms_per_token']:.3f} / {res[True]['ms_per_token']:.3f} ms/token; "
            f"under each its own plans the greedy tokens equal up to step {first} and the "
            f"prompt logits differ by {err:.4f} of max {scale:.3f}; the unfused model under the "
            f"fused plans: prompt logits and {steps} greedy tokens "
            f"{'bit-equal to' if exact else 'DIFFER from'} the fused model's | {self.card}")
        if not exact:
            raise AssertionError("fuse_qkv: under the fused launch's plans the unfused 7B "
                                 "model's logits or tokens differ from the fused model's")
        self.report["fuse_qkv"] = {
            "qmm_per_token": {"unfused": per[False], "fused": per[True]},
            "ms_per_token": {"unfused": res[False]["ms_per_token"],
                             "fused": res[True]["ms_per_token"]},
            "tokens_equal_until": first, "prompt_logits_max_abs_diff": err,
            "prompt_logits_max_abs": scale, "bit_equal_under_fused_plans": exact}
        # the 2-layer 7B-width model fused on the card against the unfused CPU path
        cfg2 = ModelConfig(**dict(LLAMA_7B, num_layers=2, max_seq_len=64))
        p2 = gaussian_wire_llama(cfg2, seed=7, device="cuda")
        self._hold_to_cpu(torch, "archs fuse_qkv 2-layer", "llama", cfg2, p2,
                          _tree_to_cpu(p2, torch.float32),
                          np.random.RandomState(7).randint(0, cfg2.vocab_size, size=37), 6,
                          fuse_qkv=True)
        del p2
        torch.cuda.empty_cache()

    # -- phase 12 --------------------------------------------------------------
    def phase_offload(self, torch):
        """LLaMA-7B (the ``full`` phase's model) with 24 of its 32 layers
        streamed from pinned host memory (``OffloadRunner``, pre_layer 8,
        cache 512): a 37-token prompt and 32 greedy tokens through
        ``generate``, the tokens and the prompt logits bit-equal to the
        resident runner's ``generate(span=1)``; ms/token of the decode loop
        beside the H2D bound (streamed bytes over a plain pinned copy's rate
        in this run), the copy time hidden under compute, and peak device
        memory beside the resident runner's. Then the CLI with ``--pre-layer
        1`` on the quantize phase's 2-layer checkpoint, its ppl equal to the
        resident CLI run's."""
        import gc
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
        from gptq_for_llama_tpu_torch.runtime.offload import OffloadRunner, map_tensors, tensors
        from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
        cfg = ModelConfig(**LLAMA_7B)
        params = (self.model7b or (None, gaussian_wire_llama(cfg, seed=0, device="cuda")))[1]
        self.model7b = None
        pre, new, max_len = 8, 32, 512
        prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, size=37)
        ids = torch.as_tensor(prompt[None], device="cuda")

        def decode_ms(runner, step, toks):
            """Host ms a token of ``new`` decode steps teacher-forced by
            ``toks`` after the prompt's prefill, synchronized at the end."""
            _, cache = runner.prefill(ids, runner.init_cache())
            feed = torch.as_tensor(toks[:, len(prompt):], device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for j in range(new):
                _, cache = step(feed[:, j:j + 1], cache)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / new * 1e3

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = ModelRunner("llama", cfg, params, max_seq_len=max_len, device="cuda")
        want = generate(res, prompt, max_new_tokens=new, temperature=0.0, span=1)
        want_logits = res.prefill(ids, res.init_cache())[0]
        resident_ms = decode_ms(res, res._step, want)
        peak_res = torch.cuda.max_memory_allocated()

        # the offloaded run starts from host parameters: the card keeps none
        # of the streamed layers
        host = map_tensors(params, lambda t: t.cpu())
        del res, params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        off = OffloadRunner("llama", cfg, host, pre, max_seq_len=max_len, device="cuda")
        t_build = time.perf_counter() - t0
        del host
        kernels.reset_launch_counts()
        got = off.generate(prompt, max_new_tokens=new)
        counts = kernels.launch_counts()
        self.check_path("offload", counts)
        self.check_norms("offload generate", counts, sum(off.forwards.values()), cfg.num_layers)
        got_logits = off.prefill(ids, off.init_cache())[0]
        if not np.array_equal(got, want) or not torch.equal(got_logits, want_logits):
            raise AssertionError("offload: tokens or prompt logits differ from the resident "
                                 "runner's")
        off_ms = decode_ms(off, off.decode, got)
        peak_off = torch.cuda.max_memory_allocated()

        # the copies alone: every streamed layer staged once (the runner's own
        # copies into its slots), and one plain pinned copy of a layer's bytes
        layers = off.layers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(off.host_layers)):
            layers._stage(i)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        src = torch.empty(layers.layer_bytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(layers.layer_bytes, dtype=torch.uint8, device="cuda")
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        bw = layers.layer_bytes / (float(np.median(times[1:])) * 1e-3)
        del src, dst
        bound_ms = off.streamed_bytes / bw * 1e3
        # the time copies and compute overlap: of the copies (at most
        # compute / copies) and of the compute
        overlap = resident_ms + copy_ms - off_ms
        hidden, covered = overlap / copy_ms, overlap / resident_ms
        saved = peak_res - peak_off
        log(f"[offload] LLaMA-7B, layers 0-{pre - 1} resident, {len(off.host_layers)} streamed "
            f"({off.streamed_bytes / 2**30:.3f} GiB a token, {layers.layer_bytes / 2**20:.1f} "
            f"MiB a layer, pinned in {t_build:.1f} s): {new} greedy tokens and the prompt "
            f"logits bit-equal to the resident runner's generate(span=1); launches "
            f"{_nonzero(counts)}")
        log(f"[offload] decode {off_ms:.3f} ms/token ({1e3 / off_ms:.2f} tok/s) against the "
            f"H2D bound {bound_ms:.3f} ms/token (a plain pinned copy of one layer: "
            f"{bw / 1e9:.2f} GB/s); the streamed layers' copies alone {copy_ms:.3f} ms, the "
            f"resident runner's eager step {resident_ms:.3f} ms/token: they overlap "
            f"{overlap:.3f} ms (step + copies - offloaded step), {hidden:.3f} of the copy time "
            f"hidden under compute, {covered:.3f} of the compute under the copies; "
            f"{bound_ms / off_ms:.3f} of the bound | {self.card}")
        log(f"[offload] peak device memory {peak_off / 2**30:.3f} GiB against the resident "
            f"runner's {peak_res / 2**30:.3f} GiB: {saved / layers.layer_bytes:.2f} layers' "
            f"bytes less | {self.card}")
        if saved < 20 * layers.layer_bytes:
            raise AssertionError(f"offload: peak memory only {saved} B below the resident "
                                 f"runner's; 20 streamed layers are {20 * layers.layer_bytes} B")
        self.report["offload"] = {
            "pre_layer": pre, "streamed_layers": len(off.host_layers),
            "streamed_bytes_per_token": off.streamed_bytes, "layer_bytes": layers.layer_bytes,
            "ms_per_token": off_ms, "bound_ms_per_token": bound_ms, "h2d_bytes_per_s": bw,
            "copies_alone_ms": copy_ms, "resident_eager_ms_per_token": resident_ms,
            "overlap_ms": overlap, "hidden_share": hidden, "compute_covered_share": covered,
            "peak_memory_bytes": peak_off,
            "resident_peak_memory_bytes": peak_res, "launches": counts}
        del off
        gc.collect()
        torch.cuda.empty_cache()
        self._offload_cli(torch)

    def _offload_cli(self, torch):
        """The CLI on the quantize phase's 2-layer checkpoint: ``--load --eval
        --benchmark 32 --check`` in this process, then with ``--pre-layer 1``
        through ``python -m gptq_for_llama_tpu_torch``; the ppl of both
        equal."""
        model, out = os.path.join(self.tmp, "model"), os.path.join(self.tmp, "packed")
        if not os.path.isdir(out):
            raise RuntimeError("offload: the CLI run needs the quantize phase's checkpoint "
                               "(--phases build,quantize,offload)")
        from gptq_for_llama_tpu_torch.cli.main import main as cli
        args = [model, "synthetic", "--load", out, "--eval", "--benchmark", "32", "--check"]
        reps = {"resident": json.loads(json.dumps(cli(args)))}   # in this process
        path = os.path.join(self.tmp, "offload_cli.json")
        proc = subprocess.run([sys.executable, "-m", "gptq_for_llama_tpu_torch", *args,
                               "--pre-layer", "1", "--report", path],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"offload CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(path) as f:
            reps["offload"] = json.load(f)
        res, off = reps["resident"], reps["offload"]
        self.check_path("offload:eval", off["launches"]["eval:synthetic"])
        self.check_path("offload:benchmark", off["launches"]["benchmark"])
        ppl = {t: (r["ppl"]["synthetic"], r["benchmark"]["ppl"]) for t, r in reps.items()}
        log(f"[offload] CLI --pre-layer 1 on the 2-layer checkpoint: ppl {ppl['offload'][0]:.6f}, "
            f"benchmark check ppl {ppl['offload'][1]:.6f}; resident {ppl['resident'][0]:.6f} / "
            f"{ppl['resident'][1]:.6f}; eval {off['phases']['eval:synthetic']:.2f} s against "
            f"{res['phases']['eval:synthetic']:.2f} s, benchmark "
            f"{off['benchmark']['tokens_per_s']:.1f} against "
            f"{res['benchmark']['tokens_per_s']:.1f} tok/s; peak memory by phase "
            f"{json.dumps(off['peak_memory'])} against {json.dumps(res['peak_memory'])} | "
            f"{self.card}")
        if ppl["offload"] != ppl["resident"] or not all(map(math.isfinite, ppl["offload"])):
            raise AssertionError(f"offload CLI: ppl {ppl['offload']} against the resident "
                                 f"run's {ppl['resident']}")
        self.report["offload"]["cli"] = {t: {"ppl": r["ppl"], "benchmark": r["benchmark"],
                                             "phases": r["phases"],
                                             "peak_memory": r["peak_memory"]}
                                         for t, r in reps.items()}

    # -- phase 13 --------------------------------------------------------------
    def phase_autotune(self, torch):
        """The measured race of kernels 1, 2 and 8 (``ops/cuda/autotune.py``)
        into a fresh cache file, on LLaMA-7B's own linears: kernel 1 at (K, N)
        = (4096, 4096) and (11008, 4096), M buckets 1, 8 and 1024; kernel 2 at
        (4096, 11008), M 1 and 8; kernel 8 at (4096, 4096), M 1024. Each
        winner against its plain version (2e-2 of the largest output); the 7B
        decode graph's device ms at offsets 164 and 2047 and one 8-slot
        serving decode step, tuned against heuristic, in turns; then
        ``ModelRunner.warmup`` in a fresh process on the same cache file,
        which must measure nothing."""
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops.cuda import autotune as at
        from gptq_for_llama_tpu_torch.runtime.random_model import gaussian_wire_llama
        cfg = ModelConfig(**LLAMA_7B)
        if self.model7b is None:
            self.model7b = (cfg, gaussian_wire_llama(cfg, seed=0, device="cuda"))
        params = self.model7b[1]
        path = os.path.join(self.tmp, "autotune.json")
        saved = {k: os.environ.get(k) for k in (at.MODE_ENV, at.PATH_ENV)}
        os.environ[at.MODE_ENV], os.environ[at.PATH_ENV] = "1", path
        try:
            at.configure()
            races = self._autotune_race(torch, at, params)
            steps = self._autotune_steps(torch, at, cfg, params)
            again = self._autotune_second_process(path)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            at.configure()
        with open(path) as f:
            keys = sorted(json.load(f)["entries"])
        log(f"[autotune] cache {len(keys)} entries, keys {keys} | {self.card}")
        if again != 0:
            raise AssertionError(f"autotune: a second process's warmup made {again} "
                                 "measurements on a cache that holds its shapes")
        log(f"[autotune] a fresh process's ModelRunner.warmup on the same cache file: "
            f"{again} measurements")
        self.report["autotune"] = {"races": races, "steps": steps, "keys": keys,
                                   "second_process_measurements": again}

    def _autotune_race(self, torch, at, params):
        from gptq_for_llama_tpu_torch.ops.cuda import matmul, matmul_t, mlp
        from gptq_for_llama_tpu_torch.ops.linear import quant_matmul_plain
        linears, pairs = at.collect(params)
        by_shape = {}
        for lin in linears:
            by_shape.setdefault((lin.in_features, lin.out_features), []).append(lin)
        plan = [("fwd", (4096, 4096), 1), ("fwd", (4096, 4096), 8), ("fwd", (4096, 4096), 1024),
                ("fwd", (11008, 4096), 1), ("fwd", (11008, 4096), 8),
                ("fwd", (11008, 4096), 1024), ("mlp", (4096, 11008), 1),
                ("mlp", (4096, 11008), 8), ("bwd", (4096, 4096), 1024)]
        rows = []
        for kind, (k, n), m in plan:
            timed = []

            def record(msg, timed=timed):
                log(f"[autotune]{msg}")
                timed.append(msg.strip())

            n0 = at.measurements
            t0 = time.perf_counter()
            if kind == "mlp":
                won = at.tune_mlp(pairs, m, log=record)
                units = len(pairs)
            else:
                won = at.tune_qmm(by_shape[(k, n)], m, kind, log=record)
                units = len(by_shape[(k, n)])
            race_s = time.perf_counter() - t0
            gen = torch.Generator(device="cuda").manual_seed(m)
            x = torch.randn((m, n if kind == "bwd" else k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            lin = pairs[0][0] if kind == "mlp" else by_shape[(k, n)][0]
            heur = at.candidates(kind, k, n, lin.bits, lin.groupsize, m, matmul._sm_count(0))[0]
            if kind == "fwd":
                taken = matmul.plan_for(x, lin)
                got, want = matmul.qmm_cuda(x, lin), quant_matmul_plain(x, lin)
            elif kind == "mlp":
                taken = mlp.plan_for(x, lin)
                got, want = mlp.fused_mlp_cuda(x, *pairs[0]), mlp.fused_mlp_plain(x, *pairs[0])
            else:
                taken = matmul_t.plan_for(x, lin)
                got, want = matmul_t.qmm_t_cuda(x, lin), matmul_t.quant_matmul_t_plain(x, lin)
            err = float((got.float() - want.float()).abs().max())
            tol = 2e-2 * float(want.float().abs().max())
            ok = taken == won and err <= tol and torch.isfinite(got.float()).all()
            log(f"[autotune] {kind} K={k} N={n} M={m}: {at.measurements - n0} candidates, each "
                f"over a chain of the first {at.CHAIN_BYTES >> 20} MiB of the model's {units} "
                f"of the shape, in {race_s:.1f} s; winner {won.path} mt={won.mt} "
                f"split={won.split} (the heuristic's {heur.path} mt={heur.mt} "
                f"split={heur.split}); "
                f"the wrapper's plan {'is' if taken == won else 'IS NOT'} the winner; max_abs_err "
                f"{err:.3e} against the plain version (tol {tol:.3e}) "
                f"{'ok' if ok else 'FAIL'} | {self.card}")
            if not ok:
                raise AssertionError(f"autotune {kind} K={k} N={n} M={m}: the winner's output "
                                     f"or plan is wrong ({err} > {tol} or {taken} != {won})")
            rows.append({"kind": kind, "k": k, "n": n, "m": m, "race_s": race_s,
                         "candidates": at.measurements - n0, "units": units,
                         "winner": list(won[:3]), "heuristic": list(heur[:3]),
                         "max_abs_err": err, "tol": tol,
                         "log": timed})
        return rows

    def _autotune_steps(self, torch, at, cfg, params):
        """The decode graph's device ms (offsets 164 and 2047) and an 8-slot
        dense serving decode step's, under the tuned plans and the heuristic
        ones: each runner and engine captures its graphs while its mode is
        the configured one, and the four are timed in turns (tuned,
        heuristic, heuristic, tuned)."""
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import (GenRequest, ModelRunner, ServingEngine,
                                                      generate)
        prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, size=37)
        owners = {}
        for mode in ("tuned", "heuristic"):
            os.environ[at.MODE_ENV] = "1" if mode == "tuned" else "0"
            n0 = at.measurements
            runner = ModelRunner("llama", cfg, params, device="cuda")
            runner.warmup(prefill_buckets=(len(prompt),))
            kernels.reset_launch_counts()
            toks = generate(runner, prompt, max_new_tokens=32, temperature=0.0)
            self.check_path(f"autotune:{mode}", kernels.launch_counts())
            eng = ServingEngine("llama", cfg, params, batch_slots=8, max_seq_len=512,
                                device="cuda")
            for uid in range(8):
                eng.submit(GenRequest(uid=uid, prompt=prompt[:20 + uid], max_new_tokens=8))
            eng.run()
            state = eng.state
            state["live"][:] = True
            with torch.inference_mode():
                bucket = eng._span_bucket(state, 1)
                eng._decode_span(state, 1, "greedy")   # captured under this mode's plans
            off0 = state["off"].clone()
            off0.copy_(torch.from_numpy(state["host_off"]).to(torch.int32))
            owners[mode] = (runner, eng, state, (1, "greedy", bucket), off0, toks)
            log(f"[autotune] {mode} runner and engine built and captured "
                f"({at.measurements - n0} measurements)")
        times = {m: {"164": [], "2047": [], "serve": []} for m in owners}
        for mode in ("tuned", "heuristic", "heuristic", "tuned"):
            runner, eng, state, key, off0, _ = owners[mode]
            offs = runner._store.offs
            for o in (164, 2047):
                times[mode][str(o)].append(replay_ms(
                    torch, runner.graphs, ("decode", 256 if o == 164 else 2048),
                    lambda o=o: offs.fill_(o)))
            times[mode]["serve"].append(replay_ms(torch, eng.graphs, key,
                                                  lambda s=state, o=off0: s["off"].copy_(o),
                                                  iters=4))
        out = {m: {k: float(np.mean(v)) for k, v in t.items()} for m, t in times.items()}
        same = np.array_equal(owners["tuned"][5], owners["heuristic"][5])
        log(f"[autotune] LLaMA-7B decode graph, device ms at offset 164 / 2047: tuned "
            f"{out['tuned']['164']:.4f} / {out['tuned']['2047']:.4f}, heuristic "
            f"{out['heuristic']['164']:.4f} / {out['heuristic']['2047']:.4f}; 8-slot dense "
            f"serving decode step: tuned {out['tuned']['serve']:.4f}, heuristic "
            f"{out['heuristic']['serve']:.4f} ms (each the mean of two turns, tuned, heuristic, "
            f"heuristic, tuned: {json.dumps(times)}); greedy tokens of the two runners "
            f"{'equal' if same else 'differ'} | {self.card}")
        del owners
        torch.cuda.empty_cache()
        return {"ms": out, "turns": times, "tokens_equal": bool(same)}

    def _autotune_second_process(self, path):
        """``ModelRunner.warmup`` of a 2-layer 7B-width LLaMA (the shapes of
        the races above, the decode rows of batch 1) in a fresh python
        process on the cache file: its count of measurements."""
        script = ("import json, sys\n"
                  "from gptq_for_llama_tpu_torch.models.config import ModelConfig\n"
                  "from gptq_for_llama_tpu_torch.ops.cuda import autotune as at\n"
                  "from gptq_for_llama_tpu_torch.runtime import ModelRunner\n"
                  "from gptq_for_llama_tpu_torch.runtime.random_model import "
                  "gaussian_wire_llama\n"
                  "cfg = ModelConfig(**json.loads(sys.argv[1]))\n"
                  "r = ModelRunner('llama', cfg, gaussian_wire_llama(cfg, seed=1), "
                  "device='cuda')\n"
                  "r.warmup(prefill_buckets=(37,))\n"
                  "print(json.dumps({'measurements': at.measurements}))\n")
        env = dict(os.environ, **{"GPTQ_TORCH_AUTOTUNE": "1", "GPTQ_TORCH_AUTOTUNE_CACHE": path})
        proc = subprocess.run([sys.executable, "-c", script,
                               json.dumps(dict(LLAMA_7B, num_layers=2))],
                              cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"autotune second process exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])["measurements"]

    # -- phase 14 --------------------------------------------------------------
    def phase_profile(self, torch):
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_llama

        cfg = ModelConfig(arch="llama", vocab_size=32000, hidden_size=4096,
                          intermediate_size=11008, num_layers=4, num_heads=32,
                          num_kv_heads=32, head_dim=128, max_seq_len=512)
        runner = ModelRunner("llama", cfg, random_wire_llama(cfg, seed=3), device="cuda")
        ids = torch.as_tensor(np.random.RandomState(3).randint(0, 32000, (1, 100)),
                              device="cuda")
        logits, cache = runner.prefill(ids, runner.init_cache())
        tok = logits[:, -1:].float().argmax(-1)
        for _ in range(2):
            logits, cache = runner._step(tok, cache)

        def step():
            runner._step(tok, cache)   # eager; the same slot rewritten: the offset stays

        self._profile_steps(torch, "profile", "eager decode steps of a 4-layer 7B-width model",
                            step, 4)

    def _profile_steps(self, torch, key, what, step, steps):
        """torch.profiler over ``steps`` calls of ``step``: host wall time, the
        device's busy share and device time per kernel name."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []   # kernels only: an aten op row repeats its kernels' time
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            dev = getattr(e, "self_device_time_total", None)
            if dev is None:
                dev = getattr(e, "self_cuda_time_total", 0)
            if dev > 0:
                rows.append((dev, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows) / 1e6
        # torch's elementwise add (CUDAFunctor_add; AddFunctor in older builds):
        # each residual add outside a norm is one
        adds = sum(c for _, c, k in rows if "Functor_add" in k or "AddFunctor" in k) / steps
        # device kernels a step (copies and fills apart), and those of them that
        # sum K-splits in a second launch (qmm_reduce_kernel)
        launched = sum(c for _, c, k in rows if not k.startswith(("Memcpy", "Memset"))) / steps
        reduces = sum(c for _, c, k in rows if "qmm_reduce_kernel" in k) / steps
        log(f"[{key}] {steps} {what}: wall {wall * 1e3:.3f} ms, device busy "
            f"{busy * 1e3:.3f} ms (busy share {busy / wall:.4f}); {adds:g} elementwise add "
            f"launches per step; {launched:g} device kernels per step, {reduces:g} of them "
            f"K-split reduce kernels | {self.card}")
        for dev, count, name in rows[:25]:
            log(f"[{key}]   {dev / steps:10.1f} us/step  {count // steps:4d} calls/step  "
                f"{name[:110]}")
        self.report[key] = {"wall_s": wall, "busy_s": busy, "steps": steps,
                            "elementwise_adds_per_step": adds,
                            "device_kernels_per_step": launched,
                            "reduce_kernels_per_step": reduces,
                            "kernels": [{"us_per_step": d / steps, "calls": c, "name": k}
                                        for d, c, k in rows]}

    def kernels_line(self) -> str:
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        rows = []
        for name, kernel in kernels.KERNELS.items():
            e = self.entries.get(name, {})
            by_path = {p: c.get(name, 0) for p, c in self.launches.items()}
            rows.append({"name": name, "route": "cuda", "source": kernel.source,
                         "replaces": kernel.replaces,
                         "launches": sum(by_path.values()), "launches_by_path": by_path,
                         "max_abs_err": e.get("max_abs_err"), "ms": e.get("ms"),
                         "plain_ms": e.get("plain_ms"), "bound_ms": e.get("bound_ms"),
                         "bound_by": e.get("bound_by"), "library_ms": e.get("library_ms"),
                         "shape": e.get("shape"), "serve": self.serve_entries.get(name)})
            if name in ("qmm", "fused_mlp", "rms_norm"):   # the form of every row
                rows[-1]["paths"] = {k[len(name) + 1:]: p for k, p in self.paths.items()
                                     if k.startswith(name + " ")}
            # the cache dtype read, and the head dim
            by_dtype = ("bf16", "f32", "fp8", "fp8_e5m2", "d64", "d80", "d96", "d128", "d256")
            forms = {"qmm": ("gemv", "frag", "tile"), "fused_mlp": ("gemv", "frag", "tile"),
                     "rms_norm": ("alone", "add"), "decode_attention": by_dtype,
                     "flash_prefill_blocked": by_dtype, "pool_decode_attention": by_dtype,
                     "fused_decode_attention": by_dtype, "flash_prefill": by_dtype[4:]}
            if name in forms:
                rows[-1]["launches_by_form"] = {
                    p: {f: c.get(f"{name}:{f}", 0) for f in forms[name]}
                    for p, c in self.launches.items()}
            if name == "rms_norm":
                rows[-1]["launch_floor_ms"] = self.report.get("launch_floor_ms")
            if name == "flash_prefill_blocked":
                rows[-1]["sq2048"] = self.sq2048
            if name in self.kv_entries:   # the same kernel over fp8-e4m3, fp8-e5m2, f32 caches
                rows[-1]["kv_dtypes"] = self.kv_entries[name]
            if name in self.dim_entries:   # at head dims 64, 80, 96, 256, by cache dtype
                rows[-1]["head_dims"] = self.dim_entries[name]
        return json.dumps({"kernels": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the detailed report here")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases, in their order")
    args = ap.parse_args()
    phases = [p for p in PHASES if p in args.phases.split(",")]
    if len(phases) != len(args.phases.split(",")):
        ap.error(f"--phases takes names among {','.join(PHASES)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # every phase but ``autotune`` runs kernels 1, 2 and 8 on their heuristic
    # plans, comparable with earlier runs and exact where a check is bit for
    # bit; ``autotune`` sets its own knobs and puts these back
    os.environ["GPTQ_TORCH_AUTOTUNE"] = "0"
    import gptq_for_llama_tpu_torch  # noqa: F401  (fails outside a checkout)

    smoke = Smoke()
    smoke.phase_card(torch)
    smoke.tmp = tempfile.mkdtemp(prefix="gptq_smoke_")
    try:
        for p in phases:
            t0 = time.perf_counter()
            log(f"== phase {p}")
            getattr(smoke, f"phase_{p}")(torch)
            log(f"== phase {p} done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(smoke.tmp, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(smoke.report, f, indent=1)
    if len(phases) < len(PHASES):
        log(f"ran phases {','.join(phases)} only: no result line")
        return 0
    print(smoke.kernels_line())
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
