#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gptq_for_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py [--json PATH]

Phases, in order, on one card:
  card     the card is there; prints nvidia-smi's name and power limit.
  build    builds every kernel of csrc/ with nvcc (timed) and prints the
           ptxas register / spill lines.
  kernels  each kernel against its plain PyTorch version on the card at the
           shapes LLaMA-7B prefill, decode, calibration and eval give it:
           error vs the stated tolerance (attention: per output row, relative
           to the row's norm), kernel / plain / library-call time (CUDA events
           around a CUDA-graph replay of many launches, weights cycled
           through copies larger than the 50 MB L2), and the bound.
  e2e      a random wire-format LLaMA at 7B width and 2 layers: prefill and
           8 greedy steps on the card (bf16, kernels) against the same
           weights on the CPU (fp32, plain versions).
  full     LLaMA-7B INT4-g128, 32 layers, batch 1: ``generate`` greedily for
           three prompts of ragged lengths; every kernel of the decode path
           must launch. Prints ms/token, tok/s, peak memory and the roofline
           share.
  quantize the quantize -> pack -> save -> reload -> perplexity path through
           the CLI, in-process: a dense F16 LLaMA checkpoint at 7B width and
           2 layers written from a seed, then ``--wbits 4 --groupsize 128
           --act-order --true-sequential --nsamples 128 --save OUT --eval``
           and ``--load OUT --eval --benchmark 128 --check``. Prints s/layer
           (forwards, Hessians, solver), eval tok/s, peak memory and launches
           per path; checks GPTQ against RTN, the card's Hessian against fp64,
           the solver card vs CPU, the reloaded wire bytes, and a window's NLL
           card vs the fp32 CPU plain path.
  profile  torch.profiler over eager decode steps of a 4-layer 7B-width
           model: device time per kernel and the device busy share.

Exits non-zero, with no result line, on any failure or when no CUDA device
is present. Otherwise the line before last is the kernels JSON and the last
line is {"ok": true, "device": {...}}. Needs no network; imports nothing of
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

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 2**20
PHASES = ("build", "kernels", "e2e", "full", "quantize", "profile")
# kernels each path must launch: the decode path (prefill at a cache offset,
# then decode steps), the calibration forward, the perplexity eval
PATHS = {"decode": {"qmm", "fused_mlp", "decode_attention", "flash_prefill_blocked"},
         "quantize": {"flash_prefill"},
         "eval": {"flash_prefill", "qmm", "fused_mlp"}}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the bf16 peak."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def row_rel_err(got, want) -> float:
    """Largest over output rows (all indices but the last) of
    |got - want| / |want|. A causal row i averages i + 1 values, so its size
    falls like 1/sqrt(i + 1); an error bound set from the largest value of
    the whole output would let late rows be wrong by as much as they are."""
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()


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
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"[ptxas {name}] {line.strip()}")
        self.report["build_s"] = dt

    # -- phase 3 ---------------------------------------------------------------
    def _record(self, kernel, shape, err, tol, ms, plain_ms, lib_ms, nbytes, flops, main=False,
                row_rel=None, ref_max=None):
        """One kernel row. The check is ``err <= tol`` or, where ``row_rel``
        (the per-row relative error) is given, ``row_rel <= tol``."""
        b_ms, b_by = bound(nbytes, flops)
        checked = err if row_rel is None else row_rel
        ok = checked <= tol
        row = {"shape": shape, "max_abs_err": err, "row_rel_err": row_rel, "max_abs_ref": ref_max,
               "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops, "ok": ok}
        self.report["kernels"].setdefault(kernel, []).append(row)
        what = (f"max_abs_err {err:.3e} (tol {tol:.3e})" if row_rel is None else
                f"max_abs_err {err:.3e}, max|plain| {ref_max:.3e}, worst row rel {row_rel:.3e} "
                f"(tol {tol:.3e})")
        log(f"[kernel {kernel}] {shape}: {what} "
            f"{'ok' if ok else 'FAIL'} | kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library {'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
            f"bound {b_ms * 1e3:.2f} us ({b_by}) | {self.card}")
        if not ok:
            raise AssertionError(f"{kernel} {shape}: kernel disagrees with its plain version "
                                 f"({checked} > {tol})")
        if main:
            self.entries[kernel] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                                    "shape": shape}

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

    def phase_kernels(self, torch):
        import torch.nn.functional as F
        from gptq_for_llama_tpu_torch.ops.cuda.attention import (
            decode_attention_cuda, decode_attention_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.flash import (
            flash_prefill_blocked_cuda, flash_prefill_blocked_plain)
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda
        from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp_cuda, fused_mlp_plain
        from gptq_for_llama_tpu_torch.ops.linear import quant_matmul_plain

        rng = np.random.RandomState(1234)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        bf = torch.bfloat16

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf)

        # kernel 1: tolerance 2e-2 * max|plain|: the plain version rounds the
        # dequantized weight to bf16 before its matmul, the kernel keeps it fp32
        for k, n, what in ((4096, 4096, "q_proj"), (11008, 4096, "down_proj")):
            lins = self._linears(torch, rng, k, n, copies_for(k * n // 2))
            lin = lins[0]
            wdq = [lin.dequantize(bf) for _ in range(copies_for(k * n * 2))]
            for m in (1, 100):
                x = randn(m, k)
                y = qmm_cuda(x, lin)
                ref = quant_matmul_plain(x, lin, bf)
                err = (y.float() - ref.float()).abs().max().item()
                tol = 2e-2 * ref.float().abs().max().item()
                ms = graph_ms(torch, [lambda l=l: qmm_cuda(x, l) for l in lins])
                pms = graph_ms(torch, [lambda l=l: quant_matmul_plain(x, l, bf) for l in lins],
                               iters=10)
                lms = graph_ms(torch, [lambda w=w: torch.matmul(x, w) for w in wdq])
                nbytes = m * k * 2 + self._lin_bytes(lin) + m * n * 2
                self._record("qmm", f"{what} {k}x{n} M={m}", err, tol, ms, pms, lms, nbytes,
                             2 * m * k * n, main=(what == "q_proj" and m == 1))
            del lins, wdq
        # kernel 2: same tolerance and reason, per branch before the epilogue
        k, n = 4096, 11008
        gates = self._linears(torch, rng, k, n, copies_for(k * n))
        ups = self._linears(torch, rng, k, n, len(gates))
        for m in (1, 100):
            x = randn(m, k)
            y = fused_mlp_cuda(x, gates[0], ups[0])
            ref = fused_mlp_plain(x, gates[0], ups[0])
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2e-2 * ref.float().abs().max().item()
            ms = graph_ms(torch, [lambda g=g, u=u: fused_mlp_cuda(x, g, u)
                                  for g, u in zip(gates, ups)])
            pms = graph_ms(torch, [lambda g=g, u=u: fused_mlp_plain(x, g, u)
                                   for g, u in zip(gates, ups)], iters=10)
            nbytes = m * k * 2 + 2 * self._lin_bytes(gates[0]) + m * n * 2
            self._record("fused_mlp", f"gate+up {k}x{n} M={m}", err, tol, ms, pms, None,
                         nbytes, 4 * m * k * n, main=(m == 1))
        del gates, ups
        # kernels 3-5: tolerance 1e-2 of each output row's norm: both sides
        # softmax in fp32, the output is rounded to bf16 (2^-9 relative);
        # kernel 5 also rounds p to bf16
        d, s = 128, 2048
        for b, h, hkv, offs in ((1, 32, 32, 0), (1, 32, 32, 127), (1, 32, 32, 2047),
                                (2, 32, 8, (100, 1500))):
            ncopy = copies_for(2 * b * s * hkv * d * 2)
            q = randn(b, 1, h, d)
            caches = [(randn(b, s, hkv, d), randn(b, s, hkv, d)) for _ in range(ncopy)]
            off_t = torch.tensor(offs if isinstance(offs, tuple) else [offs] * b,
                                 dtype=torch.int32, device="cuda")
            # a host int, as the runner passes it, except for per-row offsets
            off_arg = off_t if isinstance(offs, tuple) else offs
            kc, vc = caches[0]
            y = decode_attention_cuda(q, kc, vc, off_arg, d ** -0.5)
            ref = decode_attention_plain(q, kc, vc, off_t, d ** -0.5)
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            ms = graph_ms(torch, [lambda c=c: decode_attention_cuda(q, c[0], c[1], off_arg,
                                                                    d ** -0.5)
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
            self._record("decode_attention",
                         f"B={b} H={h} Hkv={hkv} S={s} offset={offs}", err, 1e-2, ms, pms, lms,
                         nbytes, 4 * live_slots * h * d,
                         main=(h == hkv and offs == 127), row_rel=rel, ref_max=ref_max)
            del caches
        b, sq, h, hkv = 1, 100, 32, 32
        for off in (0, 128):
            ncopy = copies_for(2 * b * s * hkv * d * 2)
            q = randn(b, sq, h, d)
            caches = [(randn(b, s, hkv, d), randn(b, s, hkv, d)) for _ in range(ncopy)]
            kc, vc = caches[0]
            y = flash_prefill_blocked_cuda(q, kc, vc, off, d ** -0.5)
            ref = flash_prefill_blocked_plain(q, kc, vc, off, d ** -0.5)
            err = (y.float() - ref.float()).abs().max().item()
            rel, ref_max = row_rel_err(y, ref), ref.float().abs().max().item()
            ms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_cuda(q, c[0], c[1], off,
                                                                         d ** -0.5)
                                  for c in caches])
            pms = graph_ms(torch, [lambda c=c: flash_prefill_blocked_plain(q, c[0], c[1], off,
                                                                           d ** -0.5)
                                   for c in caches], iters=10)
            allowed = (torch.arange(s, device="cuda")[None, :]
                       <= torch.arange(sq, device="cuda")[:, None] + off)
            qt = q.transpose(1, 2)
            lms = graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                qt, c[0].transpose(1, 2), c[1].transpose(1, 2), attn_mask=allowed)
                for c in caches])
            pairs = sum(off + i + 1 for i in range(sq))
            nbytes = 2 * b * sq * h * d * 2 + b * (off + sq) * hkv * d * 2 * 2
            self._record("flash_prefill_blocked", f"B={b} SQ={sq} H={h} Hkv={hkv} "
                         f"SKV={s} offset={off}", err, 1e-2, ms, pms, lms, nbytes,
                         4 * b * h * pairs * d, main=(off == 0), row_rel=rel, ref_max=ref_max)
            del caches
        self._kernel5(torch, F, randn)
        self._ppl_eval_linears(torch, rng, randn)
        torch.cuda.synchronize()

    def _kernel5(self, torch, F, randn):
        """Kernel 5 at the shapes of 7B quantization and eval: one window, the
        calibration forward (16 windows, the CLI's --chunk) and the eval batch
        (8 windows), then GQA and a ragged S. Tolerance 1e-2 of each output
        row's norm, as kernels 3-4."""
        from gptq_for_llama_tpu_torch.ops.cuda.flash_prefill import (flash_prefill_cuda,
                                                                     flash_prefill_plain)
        d = 128
        for b, s, h, hkv, what in ((1, 2048, 32, 32, "one window"),
                                   (16, 2048, 32, 32, "calibration chunk"),
                                   (8, 2048, 32, 32, "eval batch"), (1, 2048, 32, 8, "GQA"),
                                   (1, 1000, 32, 32, "ragged")):
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
            self._record("flash_prefill", f"{what} B={b} S={s} H={h} Hkv={hkv}", err, 1e-2,
                         ms, pms, lms, nbytes, 4 * b * h * pairs * d, main=(b == 8),
                         row_rel=rel, ref_max=ref_max)
            del ins
            torch.cuda.empty_cache()

    def _ppl_eval_linears(self, torch, rng, randn):
        """Kernels 1-2 at the perplexity-eval M (8 windows x 2048 tokens)."""
        from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda
        from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp_cuda, fused_mlp_plain
        from gptq_for_llama_tpu_torch.ops.linear import quant_matmul_plain
        bf, m = torch.bfloat16, 16384
        for k, n, what in ((4096, 4096, "q_proj"), (11008, 4096, "down_proj")):
            lin = self._linears(torch, rng, k, n, 1)[0]
            x = randn(m, k)
            y = qmm_cuda(x, lin)
            ref = quant_matmul_plain(x, lin, bf)
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2e-2 * ref.float().abs().max().item()
            wdq = lin.dequantize(bf)
            ms = graph_ms(torch, [lambda: qmm_cuda(x, lin)], iters=2)
            pms = graph_ms(torch, [lambda: quant_matmul_plain(x, lin, bf)], iters=2)
            lms = graph_ms(torch, [lambda: torch.matmul(x, wdq)], iters=2)
            nbytes = m * k * 2 + self._lin_bytes(lin) + m * n * 2
            self._record("qmm", f"{what} {k}x{n} M={m}", err, tol, ms, pms, lms, nbytes,
                         2 * m * k * n)
            del x, y, ref, wdq
        k, n = 4096, 11008
        gate, up = (self._linears(torch, rng, k, n, 1)[0] for _ in range(2))
        x = randn(m, k)
        y = fused_mlp_cuda(x, gate, up)
        ref = fused_mlp_plain(x, gate, up)
        err = (y.float() - ref.float()).abs().max().item()
        tol = 2e-2 * ref.float().abs().max().item()
        ms = graph_ms(torch, [lambda: fused_mlp_cuda(x, gate, up)], iters=2)
        pms = graph_ms(torch, [lambda: fused_mlp_plain(x, gate, up)], iters=2)
        nbytes = m * k * 2 + 2 * self._lin_bytes(gate) + m * n * 2
        self._record("fused_mlp", f"gate+up {k}x{n} M={m}", err, tol, ms, pms, None, nbytes,
                     4 * m * k * n)
        del x, y, ref
        torch.cuda.empty_cache()

    # -- phase 4 ---------------------------------------------------------------
    def phase_e2e(self, torch):
        from gptq_for_llama_tpu_torch.convert import params_from_jax
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.runtime import ModelRunner
        from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_tree

        cfg = ModelConfig(arch="llama", vocab_size=32000, hidden_size=4096,
                          intermediate_size=11008, num_layers=2, num_heads=32,
                          num_kv_heads=32, head_dim=128, max_seq_len=64)
        tree = random_wire_tree(cfg, seed=7)
        gpu = ModelRunner("llama", cfg, params_from_jax(tree, "cuda", torch.bfloat16),
                          dtype=torch.bfloat16, device="cuda")
        cpu = ModelRunner("llama", cfg, params_from_jax(tree, "cpu", torch.float32),
                          dtype=torch.float32, device="cpu")
        prompt = torch.as_tensor(np.random.RandomState(7).randint(0, cfg.vocab_size, (1, 37)))
        steps = 8
        t0 = time.perf_counter()
        lc, cc = cpu.prefill(prompt, cpu.init_cache())
        ref = [lc[0].float()]
        toks = []
        tok = lc[:, -1:].argmax(-1)
        for _ in range(steps):
            toks.append(tok)
            lc, cc = cpu.decode(tok, cc)
            ref.append(lc[0].float())
            tok = lc[:, -1:].argmax(-1)
        t_cpu = time.perf_counter() - t0
        lg, cg = gpu.prefill(prompt.cuda(), gpu.init_cache())
        got = [lg[0].float().cpu()]
        for tok in toks:   # teacher-forced with the plain path's tokens
            lg, cg = gpu.decode(tok.cuda(), cg)
            got.append(lg[0].float().cpu())
        torch.cuda.synchronize()
        ref_all, got_all = torch.cat(ref), torch.cat(got)
        if not torch.isfinite(got_all).all():
            raise AssertionError("e2e: non-finite logits on the card")
        # 2e-2 relative: bf16 activations and weights rounded at every op
        # boundary of two full-width layers and the lm_head, against fp32
        # (measured 4.8e-3 on an H100; the margin keeps the token check live)
        rel_tol = 2e-2
        scale = ref_all.abs().max().item()
        err = (got_all - ref_all).abs().max().item()
        log(f"[e2e] 2-layer 7B-width logits: max abs err {err:.4f}, max |ref| {scale:.3f}, "
            f"rel {err / scale:.4f} (tol {rel_tol}) | cpu plain fp32 {t_cpu:.1f} s")
        if err > rel_tol * scale:
            raise AssertionError(f"e2e: logits disagree (rel {err / scale} > {rel_tol})")
        compared = agreed = 0
        for r, g in zip(ref, got):   # every position of prefill and decode
            top2 = r.topk(2, dim=-1)
            margin = top2.values[:, 0] - top2.values[:, 1]
            sel = margin > 2 * rel_tol * scale
            compared += int(sel.sum())
            agreed += int((g.argmax(-1) == top2.indices[:, 0])[sel].sum())
        log(f"[e2e] greedy tokens: {agreed}/{compared} agree where the plain top-2 margin "
            f"exceeds {2 * rel_tol * scale:.3f}")
        if compared == 0 or agreed != compared:
            raise AssertionError("e2e: tokens disagree (or none cleared the margin)")
        self.report["e2e"] = {"max_abs_err": err, "max_abs_ref": scale, "rel_tol": rel_tol,
                              "tokens_compared": compared, "tokens_agreed": agreed}
        del gpu, cpu

    # -- phase 5 ---------------------------------------------------------------
    def phase_full(self, torch):
        from gptq_for_llama_tpu_torch.models.config import ModelConfig
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        from gptq_for_llama_tpu_torch.runtime import ModelRunner, generate
        from gptq_for_llama_tpu_torch.runtime.random_model import (model_weight_bytes,
                                                                   random_wire_llama)

        cfg = ModelConfig(arch="llama", vocab_size=32000, hidden_size=4096,
                          intermediate_size=11008, num_layers=32, num_heads=32,
                          num_kv_heads=32, head_dim=128, max_seq_len=2048)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = random_wire_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[full] 7B INT4-g128 random wire weights loaded in {time.perf_counter() - t0:.1f} s")
        runner = ModelRunner("llama", cfg, params, dtype=torch.bfloat16, device="cuda")
        runner.warmup(prefill_buckets=(16,))
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (37, 100, 201)]
        new = 64

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs = [generate(runner, p, max_new_tokens=new, temperature=0.0) for p in prompts]
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        counts = kernels.launch_counts()
        log(f"[full] generate: 3 requests x {new} new tokens in {t_gen:.2f} s; "
            f"launches {counts}")
        for p, o in zip(prompts, outs):
            if o.shape != (1, len(p) + new) or not ((o >= 0) & (o < cfg.vocab_size)).all():
                raise AssertionError(f"full: bad generate output {o.shape}")
        self.check_path("decode", counts)

        # decode speed: greedy loop after a prefill, host clock, synchronized
        cache = runner.init_cache()
        logits, cache = runner.prefill(torch.as_tensor(prompts[1][None], device="cuda"), cache)
        if not torch.isfinite(logits.float()).all() or logits.shape != (1, 100, cfg.vocab_size):
            raise AssertionError("full: prefill logits not finite / wrong shape")
        tok = logits[:, -1:].float().argmax(-1)
        runner.decode_greedy(tok, cache, 4)
        cache = runner.init_cache()
        _, cache = runner.prefill(torch.as_tensor(prompts[1][None], device="cuda"), cache)
        torch.cuda.synchronize()
        steps = 64
        t0 = time.perf_counter()
        toks, cache = runner.decode_greedy(tok, cache, steps)
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) / steps * 1e3

        # device time of one decode step: the step replayed as a CUDA graph
        # (offset fixed at the end of the greedy run, same slot rewritten)
        step_ids = toks[:, -1:].clone()
        dev_ms = graph_ms(torch, [lambda: runner.decode(step_ids, cache)], iters=8)
        peak = torch.cuda.max_memory_allocated()
        wbytes = model_weight_bytes(cfg)
        roof_tok_s = PEAK_BYTES_PER_S / wbytes
        tok_s = 1e3 / ms_tok
        log(f"[full] decode: {ms_tok:.3f} ms/token host loop ({tok_s:.1f} tok/s), device "
            f"{dev_ms:.3f} ms/token as a graph ({1e3 / dev_ms:.1f} tok/s); roofline "
            f"{roof_tok_s:.1f} tok/s ({wbytes} B/token at 3.35 TB/s): share "
            f"{tok_s / roof_tok_s:.4f} (graph {1e3 / dev_ms / roof_tok_s:.4f}); "
            f"peak memory {peak / 2**30:.2f} GiB | {self.card}")
        self.report["full"] = {"generate_s": t_gen, "launches": counts, "ms_per_token": ms_tok,
                               "tok_s": tok_s, "graph_ms_per_token": dev_ms,
                               "roofline_tok_s": roof_tok_s, "roofline_share": tok_s / roof_tok_s,
                               "peak_memory_bytes": peak, "weight_bytes": wbytes}

    def check_path(self, path, counts):
        """Record a path's launch counts; fail if a kernel of it never launched."""
        self.launches[path] = counts
        missing = sorted(k for k in PATHS[path] if counts.get(k, 0) == 0)
        if missing:
            raise AssertionError(f"{path} path: kernels never launched: {missing}")

    # -- phase 6 ---------------------------------------------------------------
    def phase_quantize(self, torch):
        tmp = tempfile.mkdtemp(prefix="gptq_smoke_")
        try:
            self._quantize_path(torch, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _quantize_path(self, torch, tmp):
        from gptq_for_llama_tpu_torch.cli.main import main as cli
        from gptq_for_llama_tpu_torch.ops import cuda as kernels

        layers = 2
        model, out = os.path.join(tmp, "model"), os.path.join(tmp, "packed")
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
            if rep["launches"]["eval:synthetic"].get("flash_prefill", 0) == 0:
                raise AssertionError("eval: the causal prefill kernel never launched")
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

    # -- phase 7 ---------------------------------------------------------------
    def phase_profile(self, torch):
        from torch.profiler import ProfilerActivity, profile
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
        steps = 4
        for _ in range(2):
            logits, cache = runner.decode(tok, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = runner.decode(tok, cache)
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
        log(f"[profile] {steps} eager decode steps of a 4-layer 7B-width model: wall "
            f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
            f"(busy share {busy / wall:.4f}) | {self.card}")
        for dev, count, key in rows[:25]:
            log(f"[profile]   {dev / steps:10.1f} us/step  {count // steps:4d} calls/step  "
                f"{key[:110]}")
        self.report["profile"] = {"wall_s": wall, "busy_s": busy, "steps": steps,
                                  "kernels": [{"us_per_step": d / steps, "calls": c, "name": k}
                                              for d, c, k in rows]}

    def kernels_line(self) -> str:
        from gptq_for_llama_tpu_torch.ops import cuda as kernels
        rows = []
        for name, (mod, _) in kernels.KERNELS.items():
            e = self.entries.get(name, {})
            by_path = {p: c.get(name, 0) for p, c in self.launches.items()}
            rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                         "replaces": mod.REPLACES,
                         "launches": sum(by_path.values()), "launches_by_path": by_path,
                         "max_abs_err": e.get("max_abs_err"), "ms": e.get("ms"),
                         "plain_ms": e.get("plain_ms"), "bound_ms": e.get("bound_ms"),
                         "bound_by": e.get("bound_by"), "library_ms": e.get("library_ms"),
                         "shape": e.get("shape")})
        return json.dumps({"kernels": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the detailed report here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import gptq_for_llama_tpu_torch  # noqa: F401  (fails outside a checkout)

    smoke = Smoke()
    smoke.phase_card(torch)
    for p in PHASES:
        t0 = time.perf_counter()
        log(f"== phase {p}")
        getattr(smoke, f"phase_{p}")(torch)
        log(f"== phase {p} done in {time.perf_counter() - t0:.1f} s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(smoke.report, f, indent=1)
    print(smoke.kernels_line())
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
