#!/usr/bin/env python3
"""Holds and times the two bodies of kernels 1, 2 and 8 of the PyTorch/CUDA
port above the decode rows, on one GPU: the mma.sync tiles (csrc/qmm_tc.cuh,
csrc/qmm_t.cu) and the Hopper body (csrc/qmm_wgmma.cuh: wgmma with the
weight dequantized into A fragments in registers, fed by TMA through an
mbarrier ring; kernel 2's gate and up on its two consumer warpgroups).

    python3 scripts/torch_qmm_bodies.py [--check-only | --quick] [--kinds fwd,mlp,bwd]
                                        [--json PATH]

First each body is forced on chip_smoke.py's ragged set (``hold_tc_cases``:
every device bits value, g128, g64, g32, g16 and G = 1, act-order, a bias,
ragged M, a ragged last column tile, N = 11008, with and without a split of
the reduction): held to the plain version (2e-2 * max|plain|; without a
split the product, on the same linear without its bias, in bf16 ulps beside
it), two launches bit-equal, and a CUDA-graph replay bit-equal to the eager
launch. Then (unless
``--check-only``) both bodies are timed as chip_smoke.py times kernels (CUDA
events around a CUDA graph cycling through weight copies larger than the
L2) at the widths LLaMA-7B gives them (kernel 1: 4096 x 4096, 11008 x 4096,
4096 x 11008 and the tensor-parallel q/k/v column shard 4096 x 2048 over M
= 17 .. 16384; kernel 2: gate/up 4096 x 11008 over M = 17 .. 16384 and its
tensor-parallel shards 4096 x 5504 and 4096 x 2816; kernel 8: the three LoRA
widths at M = 128 .. 2048), each body at its heuristic plan and at every row
tile and split of the reduction the autotuner would race, beside
torch.matmul on the dequantized weight (kernel 2: on the gate and up weights
side by side, N = 22016, the GEMM part alone) and the bound; kernel 2's rows
also time kernel 1 twice at the same shape. A line per shape gives the
fastest plan of each body; the plans' crossover (``matmul.WGMMA_MIN_M``)
and the split rules are read from them. ``--kinds`` keeps some kernels.
``--quick`` holds nothing and times the wgmma body alone at a few shapes and
fixed plans (``QUICK``), to compare two trees in one call. Last, the card's
name and power limit. Needs a CUDA device and nvcc; exits
non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# timed shapes: (kernel, K, N, Ms)
TIMED = (("fwd", 4096, 4096, (17, 64, 100, 128, 136, 256, 512, 1024, 2048, 16384)),
         ("fwd", 11008, 4096, (17, 128, 136, 512, 1024, 2048)),
         ("fwd", 4096, 11008, (128, 1024)),
         ("fwd", 4096, 2048, (128,)),
         ("mlp", 4096, 11008, (17, 100, 128, 136, 201, 256, 512, 1024, 2048, 16384)),
         ("mlp", 4096, 5504, (128,)),
         ("mlp", 4096, 2816, (128,)),
         ("bwd", 4096, 4096, (17, 128, 1024, 2048)),
         ("bwd", 11008, 4096, (128, 1024, 2048)),
         ("bwd", 4096, 11008, (128, 1024, 2048)))

# --quick: (kernel, K, N, M, row tile, split) of the wgmma body
QUICK = (("fwd", 4096, 4096, 128, 128, 4), ("fwd", 4096, 4096, 136, 144, 4),
         ("fwd", 4096, 2048, 128, 128, 8), ("fwd", 4096, 4096, 512, 256, 2),
         ("bwd", 4096, 4096, 128, 128, 4), ("fwd", 11008, 4096, 128, 128, 4),
         ("fwd", 4096, 4096, 1024, 256, 1), ("fwd", 4096, 4096, 16384, 256, 1),
         ("fwd", 11008, 4096, 1024, 256, 1), ("bwd", 4096, 4096, 1024, 256, 1),
         ("bwd", 11008, 4096, 1024, 256, 1), ("bwd", 4096, 11008, 2048, 256, 1))


def log(msg):
    print(msg, flush=True)


def launcher(kind):
    """The launch of kind "fwd" (kernel 1), "mlp" (kernel 2: ``lin`` a (gate,
    up) pair) or "bwd" (kernel 8) under a plan."""
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, matmul_t, mlp
    return {"fwd": matmul._launch, "bwd": matmul_t._launch,
            "mlp": lambda x, pair, p: mlp._launch(x, *pair, p)}[kind]


def candidates(kind, m, lin, sms):
    """Each body's heuristic plan, then its other row tiles (up to the one
    that holds M) at the splits 1, 2, 3, 4, 6, 8, 12 and 16 of the reduction
    that keep 4 stages a split (the autotuner races the powers of two; 3, 6
    and 12 check the heuristic's balanced split); kernel 2 from M = 1024 at
    splits 1 and 2 only."""
    from chip_smoke import body_plan
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, matmul_t
    k, n = lin.in_features, lin.out_features
    out = []
    for path in ("tile", "wgmma"):
        first = body_plan(kind, path, m, lin, sms)
        tiles = matmul.TC_ROW_TILES if path == "tile" else matmul.WG_ROW_TILES
        mts = [b for b in tiles if b < m] + [next((b for b in tiles if b >= m), tiles[-1])]
        units = -(-(k if kind != "bwd" else n) // 64)
        plans = [first]
        for bm in mts:
            for s in (1, 2, 3, 4, 6, 8, 12, 16):
                if s > max(1, units // 4) or (kind == "mlp" and m >= 1024 and s > 2):
                    continue
                if kind != "bwd":
                    p = matmul.plan_of(path, bm, s, k, lin.bits, 2 if kind == "mlp" else 1)
                else:
                    p = matmul_t.plan_of(bm, s, n, lin.bits, path)
                if p not in plans:
                    plans.append(p)
        out += plans
    return out


def timing(torch, report, card, kinds):
    import numpy as np
    from chip_smoke import bound, copies_for, graph_ms, wire_linear
    from gptq_for_llama_tpu_torch.ops.cuda import matmul
    rng = np.random.RandomState(11)
    sms = matmul._sm_count(0)
    bf = torch.bfloat16
    rows = []
    for kind, k, n, ms_of in TIMED:
        if kind not in kinds:
            continue
        w = 2 if kind == "mlp" else 1   # weights a launch reads
        lins = [wire_linear(torch, rng, k, n, 128, 4) for _ in range(copies_for(w * k * n // 2))]
        if kind == "mlp":   # (gate, up) pairs; the library multiplies [Wg | Wu]
            lins = [(g, wire_linear(torch, rng, k, n, 128, 4)) for g in lins]
            wcat = torch.cat([t.dequantize(bf) for t in lins[0]], dim=1)
            wdq = [wcat.clone() for _ in range(copies_for(k * 2 * n * 2))]
            del wcat
        else:
            wdq = [lins[0].dequantize(bf) for _ in range(copies_for(k * n * 2))]
        first = lins[0][0] if kind == "mlp" else lins[0]
        launch = launcher(kind)
        for m in ms_of:
            x = (torch.randn(m, k if kind != "bwd" else n, device="cuda") * 1.0).to(bf)
            iters = 60 if m <= 256 else 20 if m <= 2048 else 6
            lib = graph_ms(torch, [(lambda w=w: torch.matmul(x, w)) if kind != "bwd" else
                                   (lambda w=w: torch.matmul(x, w.T)) for w in wdq], iters=iters)
            nbytes = m * k * 2 + w * sum(t.numel() * t.element_size()
                                         for t in (first.qweight, first.scales, first.zeros)) \
                + m * n * 2
            b_ms, b_by = bound(nbytes, w * 2 * m * k * n)
            timed = []
            for p in candidates(kind, m, first, sms):
                t = graph_ms(torch, [lambda l=l, p=p: launch(x, l, p) for l in lins], iters=iters)
                timed.append((p, t))
            extra = {}
            if kind == "mlp":   # kernel 1 twice at its own plan, over the same weights
                from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda
                extra["kernel1_x2_ms"] = 2 * graph_ms(
                    torch, [lambda t=t: qmm_cuda(x, t) for pair in lins for t in pair],
                    iters=2 * iters)
            heur = {path: next(t for p, t in timed if p.path == path) for path in ("tile", "wgmma")}
            best = {path: min(((p, t) for p, t in timed if p.path == path), key=lambda e: e[1])
                    for path in ("tile", "wgmma")}
            log(f"[time] {kind} K={k} N={n} M={m}: heuristic tile {heur['tile'] * 1e3:.2f} us, "
                f"wgmma {heur['wgmma'] * 1e3:.2f} us; best tile {best['tile'][1] * 1e3:.2f} "
                f"(bm {best['tile'][0].mt} split {best['tile'][0].split}), best wgmma "
                f"{best['wgmma'][1] * 1e3:.2f} (bm {best['wgmma'][0].mt} split "
                f"{best['wgmma'][0].split}); torch.matmul {lib * 1e3:.2f} us"
                + (f", kernel 1 twice {extra['kernel1_x2_ms'] * 1e3:.2f} us" if extra else "")
                + f"; bound {b_ms * 1e3:.2f} us ({b_by}) | {card}")
            rows.append({"kind": kind, "k": k, "n": n, "m": m, "library_ms": lib,
                         "bound_ms": b_ms, "bound_by": b_by, **extra,
                         "plans": [{"path": p.path, "bm": p.mt, "split": p.split, "ms": t}
                                   for p, t in timed]})
            del x
        del lins, wdq
        torch.cuda.empty_cache()
    report["timing"] = rows


def quick(torch, report, card):
    import numpy as np
    from chip_smoke import copies_for, graph_ms, wire_linear
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, matmul_t
    rng = np.random.RandomState(11)
    rows = []
    for kind, k, n, m, bm, split in QUICK:
        lins = [wire_linear(torch, rng, k, n, 128, 4) for _ in range(copies_for(k * n // 2))]
        x = torch.randn(m, k if kind == "fwd" else n, device="cuda").to(torch.bfloat16)
        p = (matmul.plan_of("wgmma", bm, split, k, 4) if kind == "fwd"
             else matmul_t.plan_of(bm, split, n, 4, "wgmma"))
        launch = launcher(kind)
        t = graph_ms(torch, [lambda l=l: launch(x, l, p) for l in lins],
                     iters=60 if m <= 256 else 20 if m <= 2048 else 6)
        log(f"[quick] {kind} K={k} N={n} M={m} wgmma bm {bm} split {split}: {t * 1e3:.2f} us "
            f"| {card}")
        rows.append({"kind": kind, "k": k, "n": n, "m": m, "bm": bm, "split": split, "ms": t})
        del lins, x
    report["quick"] = rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true", help="hold the bodies, time nothing")
    ap.add_argument("--quick", action="store_true",
                    help="time the wgmma body alone at the QUICK shapes, hold nothing")
    ap.add_argument("--kinds", default="fwd,mlp,bwd",
                    help="kernels to hold and time: fwd (1), mlp (2), bwd (8)")
    ap.add_argument("--json", default=None, help="write every check and timing here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_qmm_bodies: no CUDA device", file=sys.stderr)
        return 2
    os.environ["GPTQ_TORCH_AUTOTUNE"] = "0"
    from gptq_for_llama_tpu_torch.ops.cuda import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    libs = ["qmm", "fused_mlp", "qmm_t"]
    build.start(libs)
    built = build.wait(libs)
    log(f"[build] {', '.join(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(built.items()):
        body = False   # the lines of a wgmma body's entry
        for line in text.splitlines():
            if "Compiling entry" in line:
                body = "wgmma" in line
            if (body and ("Compiling entry" in line or "registers" in line or "spill" in line)) \
                    or "arning" in line or "Performance Loss" in line:
                log(f"[ptxas {name}] {line.strip()}")
    report = {"card": card}
    try:
        if args.quick:
            quick(torch, report, card)
        else:
            from chip_smoke import hold_tc_cases
            kinds = tuple(args.kinds.split(","))
            report["checks"] = hold_tc_cases(torch, ("tile", "wgmma"), kinds)
            if not args.check_only:
                timing(torch, report, card, kinds)
    finally:
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=1)
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
