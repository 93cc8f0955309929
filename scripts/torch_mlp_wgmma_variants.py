#!/usr/bin/env python3
"""Times kernel 2's Hopper body (csrc/qmm_wgmma.cuh with NW = 2: the gate and
up weights on the two consumer warpgroups over one TMA ring of x) of the
PyTorch/CUDA port under design variants, on one GPU, beside kernel 1 run
twice over the same weights.

    python3 scripts/torch_mlp_wgmma_variants.py [--variants base,raster4,...] [--profile]

Each variant is the package's CUDA sources with one constant edited (the
launch order's row-tile groups), built with the package's nvcc flags into a
temporary directory (its ptxas report for the body's kernel 2 entries
printed) and timed in a process of its own, as chip_smoke.py times kernels:
CUDA events around a CUDA graph of launches cycling through weight copies
larger than the L2. Every variant holds one launch of each plan to the plain
version (1e-2 of each row's norm) and times kernel 2 at LLaMA-7B's gate/up
4096 x 11008 and its tensor-parallel shard 4096 x 5504 under fixed plans
(``PLANS``), and kernel 1 at the same widths under its own plan, launched
twice. Prints one line per variant and shape, then the card's name and
power limit. ``--profile`` instead times, with torch.profiler on the
package's own build, each device kernel that kernel 2's wgmma body (at the
plans of ``PROFILED``, the split ones with their sum of the partials) and
kernel 1 (launched for gate and up at its own plan) launch at those shapes.
Needs a CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> [(file, old, new)]: one design choice each
VARIANTS = {"base": []}
for _g in (1, 2, 4, 16):
    VARIANTS[f"raster{_g}"] = [("qmm_wgmma.cuh", "constexpr int kRasterRows = 8;",
                                f"constexpr int kRasterRows = {_g};")]
# (N, M, row tile, split) of kernel 2's wgmma body profiled by --profile
PROFILED = ((11008, 128, 128, 3), (11008, 128, 128, 1), (11008, 16384, 256, 1))
# (N, M, row tile, split) of kernel 2's wgmma body
PLANS = ((11008, 128, 128, 1), (11008, 128, 128, 2), (11008, 128, 128, 3),
         (5504, 128, 128, 1), (5504, 128, 128, 3), (11008, 512, 256, 1),
         (11008, 1024, 256, 1), (11008, 2048, 256, 1), (11008, 16384, 256, 1))


def build_variant(name: str, out: str) -> list:
    """Starts the nvcc processes of variant ``name`` into ``out``."""
    from gptq_for_llama_tpu_torch.ops.cuda import build
    src = os.path.join(out, "src")
    shutil.copytree(build.CSRC, src)
    for fn, old, new in VARIANTS[name]:
        path = os.path.join(src, fn)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {fn} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                              os.path.join(out, f"lib{lib}.so"), os.path.join(src, f"{lib}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for lib in ("qmm", "fused_mlp")]


def ptxas_lines(log: str) -> list:
    """The ptxas report lines (name, registers, spills) of the wgmma body's
    4-bit entries at row tiles 128 and 256 (kernel 1's in qmm, kernel 2's in
    fused_mlp)."""
    out, body = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            body = "qmm_wgmma_kernelILi4ELi128E" in line or "qmm_wgmma_kernelILi4ELi256E" in line
        if (body and ("Compiling entry" in line or "registers" in line or "spill" in line)) \
                or "arning" in line or "Performance Loss" in line:
            out.append(line.strip())
    return out


def sass_waits(lib: str) -> list:
    """Per wgmma entry of ``lib`` at 4 bits, the HGMMAs and the warpgroup
    waits after them in its SASS (cuobjdump): ``DEPBAR.LE gsb0, 0x0`` after
    every HGMMA means ptxas serialized the products."""
    from gptq_for_llama_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    out, name, counts = [], None, {}
    for line in text.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name and "qmm_wgmma_kernelILi4E" in name:
                out.append(f"{name[:64]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
            name, counts = line.split("Function :")[1].strip(), {}
        for key in ("HGMMA", "DEPBAR.LE gsb0, 0x0", "DEPBAR.LE gsb0, 0x1"):
            if key in line:
                counts[key] = counts.get(key, 0) + 1
    return out


def time_variant(name: str, out: str) -> None:
    import numpy as np
    import torch
    from chip_smoke import copies_for, graph_ms, row_rel_err, wire_linear
    from gptq_for_llama_tpu_torch.ops.cuda import build, matmul, mlp
    from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda

    for lib in ("qmm", "fused_mlp"):
        build._libs[lib] = ctypes.CDLL(os.path.join(out, f"lib{lib}.so"))
    rng = np.random.RandomState(0)
    k = 4096
    for n in sorted({p[0] for p in PLANS}, reverse=True):
        gates = [wire_linear(torch, rng, k, n, 128, 4) for _ in range(copies_for(k * n))]
        pairs = [(g, wire_linear(torch, rng, k, n, 128, 4)) for g in gates]
        for _, m, bm, split in (p for p in PLANS if p[0] == n):
            x = torch.randn(m, k, device="cuda").bfloat16()
            p = matmul.plan_of("wgmma", bm, split, k, 4, 2)
            rel = row_rel_err(mlp._launch(x, *pairs[0], p), mlp.fused_mlp_plain(x, *pairs[0]))
            if not rel <= 1e-2:
                raise AssertionError(f"{name} N={n} M={m} bm {bm} split {split}: worst row {rel}")
            iters = 60 if m <= 256 else 20 if m <= 2048 else 6
            t = graph_ms(torch, [lambda g=g, u=u: mlp._launch(x, g, u, p) for g, u in pairs],
                         iters=iters)
            k1 = 2 * graph_ms(torch, [lambda w=w: qmm_cuda(x, w) for pair in pairs for w in pair],
                              iters=2 * iters)
            print(f"[{name}] kernel 2 wgmma 4096x{n} M={m} bm {bm} split {split}: "
                  f"{t * 1e3:.2f} us; kernel 1 twice {k1 * 1e3:.2f} us", flush=True)
        del gates, pairs
        torch.cuda.empty_cache()


def profile() -> None:
    """Device time of each kernel a launch of ``PROFILED``'s plans (and of
    kernel 1, for gate and up) runs, from torch.profiler's key_averages."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from chip_smoke import wire_linear
    from gptq_for_llama_tpu_torch.ops.cuda import matmul, mlp
    from gptq_for_llama_tpu_torch.ops.cuda.matmul import qmm_cuda
    rng = np.random.RandomState(0)
    k, reps = 4096, 20
    for n, m, bm, split in PROFILED:
        g, u = (wire_linear(torch, rng, k, n, 128, 4) for _ in range(2))
        x = torch.randn(m, k, device="cuda").bfloat16()
        p = matmul.plan_of("wgmma", bm, split, k, 4, 2)
        for what, run in ((f"kernel 2 bm {bm} split {split}", lambda: mlp._launch(x, g, u, p)),
                          ("kernel 1 twice", lambda: (qmm_cuda(x, g), qmm_cuda(x, u)))):
            run()
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    run()
                torch.cuda.synchronize()
            rows = [(e.key, getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)),
                     e.count) for e in prof.key_averages()]
            rows = [r for r in rows if r[1] > 0]
            print(f"[profile] 4096x{n} M={m} {what}: "
                  + "; ".join(f"{key[:60]} {t / reps:.2f} us a call ({c // reps} a call)"
                              for key, t, c in sorted(rows, key=lambda r: -r[1])), flush=True)
        del g, u, x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--profile", action="store_true",
                    help="profile the device kernels of PROFILED's launches instead")
    ap.add_argument("--one", nargs=2, metavar=("NAME", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:   # a variant's own process
        os.environ["GPTQ_TORCH_AUTOTUNE"] = "0"
        time_variant(*args.one)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.profile:
        os.environ["GPTQ_TORCH_AUTOTUNE"] = "0"
        from gptq_for_llama_tpu_torch.ops.cuda import build
        build.start(["qmm", "fused_mlp"])
        build.wait(["qmm", "fused_mlp"])
        profile()
        names = []
    else:
        names = args.variants.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []   # every variant's builds at once
        for name in names:
            os.makedirs(os.path.join(tmp, name))
            procs += [(name, p) for p in build_variant(name, os.path.join(tmp, name))]
        for name, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
            for line in ptxas_lines(log) if name == names[0] else ():
                print(f"[ptxas {name}] {line}", flush=True)
        for lib in ("qmm", "fused_mlp") if names else ():
            for line in sass_waits(os.path.join(tmp, names[0], f"lib{lib}.so")):
                print(f"[sass {names[0]} {lib}] {line}", flush=True)
        for name in names:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name,
                            os.path.join(tmp, name)], check=True, timeout=600)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
