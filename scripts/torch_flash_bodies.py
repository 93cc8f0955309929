#!/usr/bin/env python3
"""Holds and times the two bodies of kernels 4 and 5 of the PyTorch/CUDA port
(csrc/flash_common.cuh: the 64-query mma.sync blocks and the warp-specialised
wgmma blocks) at head dims 64, 80, 96, 128 and 256, on one GPU.

    python3 scripts/torch_flash_bodies.py [--variants base,tile_fastest,one_group] [--dims 64,80,96,128,256]
                                          [--kv e4m3,e5m2,f32] [--no-bf16]

Each variant is the package's CUDA sources with one constant edited, built
with the package's nvcc flags (flash_prefill and flash_prefill_blocked, one
library per head dim) into a temporary directory and run in a process of its
own. ``base`` is the sources as they are (a wgmma ring of 3 K and 3 V
stages of 128 keys up to D = 128, 2 of 80 keys at 256); ``deep_ring`` makes
the ring as deep as shared memory allows (6 stages at D = 64, 5 at 80, 4 at
96, 3 at 128); ``keys64`` takes 64-key K and V tiles at D = 256 (an
m64n64k16 S product, 4 k16 steps of P V); ``no_turns`` lets
the two consumer warpgroups issue their products without taking turns;
``tile_fastest`` launches the wgmma grid with one head a group at every grid
size (the query tile fastest: the heaviest tile first within each head
only), ``one_group`` with every head in one group (the heads fastest, then
the query tile).

``--kv`` adds, at each head dim up to 128 (and at 256 the mma.sync body
alone), kernel 4 over caches stored in those dtypes: both bodies forced are
held to the plain version (1e-2 of each row) and bit-equal to the same body
over the cache decoded to bf16, at the chunk list below over a cache holding
the dtype's NaN past the causal limit; then both are timed over the same
chunks as bf16 (a line per shape and dtype, as bf16's). ``--no-bf16`` skips
the bf16 rows and kernel 5.

At each head dim, with the heads of the model that has it (64: GPT-2
medium's 16, 80: OPT-2.7B's 32, 96: GPT-NeoX-20B's 64, 128: LLaMA-7B's 32;
256: 16 query heads over 2 kv heads, the smoke's D = 256 layout),
every body forced is first held to the plain version (1e-2 of each output
row's norm) at causal S = 2048, GQA (Hkv = H / 4) at S = 300, ragged S =
1000 (TMA's rows past S read as zeros), and kernel 4 at SQ = 100, offset 128
over a cache holding NaN past the causal limit (the wgmma body zeroes those V
rows of its last tile); two launches are bit-equal
and kernel 4 at offset 0 is bit-equal to kernel 5. Then both bodies are timed
as chip_smoke.py times kernels (CUDA events around a CUDA graph cycling
through copies larger than the L2): kernel 5 at B = 1 over S = 64 .. 2048
and B = 8 at S = 128 (a serving admission) and 2048 (the eval batch) beside
SDPA (``is_causal``), and
kernel 4 at the chunks serving and the runner give it (SQ = 32 .. 512 at
offsets 0 .. 512 over a 2048-slot cache). A line per shape gives both times
(us) and which is faster; the plan's crossover (``SYNC_MAX_KEYS``) is read
from them. Last, the card's name and power limit. Needs a CUDA device and
nvcc; exits non-zero without them.
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

LIBS = ("flash_prefill", "flash_prefill_blocked")
# query heads and kv heads at each head dim
HEADS = {64: (16, 16), 80: (32, 32), 96: (64, 64), 128: (32, 32), 256: (16, 2)}
# name -> [(file, old, new)]: one design choice each
VARIANTS = {
    "base": [],
    "deep_ring": [("flash_common.cuh", "constexpr int kWStages = 3;",
                   "constexpr int kWStages = GPTQ_HEAD_DIM == 64 ? 6 : GPTQ_HEAD_DIM == 80 ? 5 "
                   ": GPTQ_HEAD_DIM == 96 ? 4 : 3;")],
    # 64-key K and V tiles at D = 256 (2 stages: 196,608 bytes of tiles)
    "keys64": [("flash_common.cuh", "constexpr int kWKeys256 = 80;",
                "constexpr int kWKeys256 = 64;")],
    # the two consumer warpgroups issue their products without taking turns
    "no_turns": [("flash_common.cuh", "named_barrier(kBarTurn + wg, 256);", ";"),
                 ("flash_common.cuh", "if (wg == 0 || t < n_kt - 1) named_barrier_arrive("
                  "kBarTurn + (wg ^ 1), 256);", ";"),
                 ("flash_common.cuh", "if (wg == 1) named_barrier_arrive(kBarTurn, 256);", ";")],
    # one head a group at every grid size (the query tile fastest)
    "tile_fastest": [("flash_common.cuh", "(many || d * nq >= sms)", "true")],
    # every head in one group: heads fastest, then the query tile
    "one_group": [("flash_common.cuh", "  int g = H;\n  for (int d = 1; d < H; ++d)",
                   "  int g = H;\n  for (int d = H; d < H; ++d)")],
}
K5_LENGTHS = (64, 128, 192, 256, 384, 512, 1024, 2048)
K4_CHUNKS = ((32, 0), (64, 0), (100, 0), (128, 0), (32, 96), (64, 64), (100, 28), (100, 29),
             (32, 128), (128, 128), (64, 448), (128, 512), (512, 0), (100, 1900))


def build_variant(name: str, out: str, dims) -> list:
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
    return [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, f"-DGPTQ_HEAD_DIM={d}", "-o",
                              os.path.join(out, f"lib{lib}-d{d}.so"),
                              os.path.join(src, f"{lib}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for lib in LIBS for d in dims]


KV = {"e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2", "f32": "float32"}


def time_variant(name: str, out: str, dims, kvs=(), bf16=True) -> None:
    import torch
    import torch.nn.functional as F
    from chip_smoke import copies_for, graph_ms, row_rel_err
    from gptq_for_llama_tpu_torch.ops.cuda import build, flash, flash_prefill as fp

    for lib in LIBS:
        for d in dims:
            build._libs[f"{lib}:d{d}"] = ctypes.CDLL(os.path.join(out, f"lib{lib}-d{d}.so"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def held(got, want, what):
        err = row_rel_err(got, want)
        if not (torch.isfinite(got.float()).all() and err <= 1e-2):
            raise AssertionError(f"{name} {what}: worst row {err} off the plain version")

    def equal(a, b, what):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError(f"{name} {what}: not bit-equal")

    for d in dims:
        (h, hk), sc = HEADS[d], d ** -0.5
        if kvs:
            time_kv(name, d, h, hk, kvs, randn, held, equal)
        if not bf16:
            continue
        # correctness, every body forced
        gqa_hkv = hk if hk != h else h // 4
        for b, s, hkv, what in ((1, 2048, hk, "S=2048"), (2, 300, gqa_hkv, "GQA S=300"),
                                (1, 1000, hk, "ragged S=1000")):
            q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
            want = fp.flash_prefill_plain(q, k, v, sc)
            for body in fp.PATH_IDS:
                y5, y5b = fp._launch(q, k, v, sc, body), fp._launch(q, k, v, sc, body)
                y4 = flash._launch(q, k, v, 0, sc, body)
                torch.cuda.synchronize()
                held(y5, want, f"D={d} kernel 5 {body} {what}")
                equal(y5, y5b, f"D={d} kernel 5 {body} {what}, two launches")
                equal(y4, y5, f"D={d} kernel 4 at offset 0 vs kernel 5, {body} {what}")
        sq, off, skv = 100, 128, 300
        q, k, v = randn(1, sq, h, d), randn(1, skv, hk, d), randn(1, skv, hk, d)
        want = flash.flash_prefill_blocked_plain(q, k, v, off, sc)
        k[:, off + sq:], v[:, off + sq:] = float("nan"), float("nan")
        for body in fp.PATH_IDS:
            held(flash._launch(q, k, v, off, sc, body), want,
                 f"D={d} kernel 4 SQ={sq} offset {off}, NaN past the limit, {body}")
        print(f"[{name}] D={d}: both bodies held to the plain version (1e-2 of each row), "
              f"bit-equal twice and kernel 4 = kernel 5 at offset 0", flush=True)

        # kernel 5
        for b, s in [(1, n) for n in K5_LENGTHS] + [(8, 128), (8, 2048)]:
            ins = [(randn(b, s, h, d), randn(b, s, hk, d), randn(b, s, hk, d))
                   for _ in range(copies_for(2 * b * s * (h + hk) * d * 2))]
            t = {body: graph_ms(torch, [lambda x=x, body=body: fp._launch(*x, sc, body)
                                        for x in ins], iters=20) for body in fp.PATH_IDS}
            gqa = {"enable_gqa": True} if hk != h else {}
            lib = graph_ms(torch, [lambda x=x: F.scaled_dot_product_attention(
                *(y.transpose(1, 2) for y in x), is_causal=True, **gqa) for x in ins], iters=20)
            print(f"[{name}] D={d} kernel 5 B={b} S={s} H={h}: sync {t['sync'] * 1e3:.2f}, "
                  f"wgmma {t['wgmma'] * 1e3:.2f}, SDPA {lib * 1e3:.2f} us; faster: "
                  f"{min(t, key=t.get)}; plan: {fp.plan(s, 0, d)}", flush=True)
            del ins
        # kernel 4 over a 2048-slot cache
        skv = 2048
        caches = [(randn(1, skv, hk, d), randn(1, skv, hk, d))
                  for _ in range(copies_for(2 * skv * hk * d * 2))]
        for sq, off in K4_CHUNKS:
            q = randn(1, sq, h, d)
            off_t = torch.tensor([off], dtype=torch.int32, device="cuda")
            t = {body: graph_ms(torch, [lambda c=c, body=body: flash._launch(
                q, c[0], c[1], off_t, sc, body) for c in caches], iters=40)
                for body in fp.PATH_IDS}
            print(f"[{name}] D={d} kernel 4 SQ={sq} offset={off} (offset + SQ = {off + sq}) "
                  f"H={h}: sync {t['sync'] * 1e3:.2f}, wgmma {t['wgmma'] * 1e3:.2f} us; faster: "
                  f"{min(t, key=t.get)}; plan: {fp.plan(sq, off, d)}", flush=True)
        del caches
        torch.cuda.empty_cache()


def time_kv(name, d, h, hk, kvs, randn, held, equal) -> None:
    """Kernel 4 over caches stored in ``kvs`` at head dim ``d``: each body
    the library takes there held and timed at every chunk of K4_CHUNKS."""
    import torch
    from chip_smoke import copies_for, graph_ms
    from gptq_for_llama_tpu_torch.ops import kv_dtype
    from gptq_for_llama_tpu_torch.ops.cuda import flash
    sc, skv, bf = d ** -0.5, 2048, torch.bfloat16
    bodies = ("sync", "wgmma") if d in flash.WGMMA_KV_HEAD_DIMS else ("sync",)
    for kv in kvs:
        dt = getattr(torch, KV[kv])
        nan = kv_dtype.encode(torch.tensor([float("nan")], device="cuda"), dt)
        caches = [tuple(kv_dtype.round_to(randn(1, skv, hk, d), dt) for _ in range(2))
                  for _ in range(copies_for(2 * skv * hk * d * dt.itemsize))]
        for sq, off in K4_CHUNKS:
            q = randn(1, sq, h, d)
            k, v = (c.clone() for c in caches[0])
            want = flash.flash_prefill_blocked_plain(q, k, v, off, sc)
            for c in (k, v):
                kv_dtype.stored(c)[:, off + sq:] = nan.to(kv_dtype.stored(c).dtype)
            dk, dv = kv_dtype.decode(k, bf), kv_dtype.decode(v, bf)
            for body in bodies:
                got = flash._launch(q, k, v, off, sc, body)
                held(got, want, f"D={d} kernel 4 {kv} SQ={sq} offset {off} {body}")
                equal(got, flash._launch(q, dk, dv, off, sc, body),
                      f"D={d} kernel 4 {kv} SQ={sq} offset {off} {body} against the cache "
                      f"decoded to bf16")
            off_t = torch.tensor([off], dtype=torch.int32, device="cuda")
            t = {body: graph_ms(torch, [lambda c=c, body=body: flash._launch(
                q, c[0], c[1], off_t, sc, body) for c in caches], iters=40) for body in bodies}
            print(f"[{name}] D={d} kernel 4 {kv} SQ={sq} offset={off} (offset + SQ = "
                  f"{off + sq}) H={h}: " + ", ".join(f"{b} {t[b] * 1e3:.2f}" for b in bodies) +
                  f" us; faster: {min(t, key=t.get)}; plan: {flash.plan_kv(sq, off, dt, d)}",
                  flush=True)
        print(f"[{name}] D={d} {kv}: every body held to the plain version (1e-2 of each row) "
              f"and bit-equal to itself over the cache decoded to bf16, NaN past the limit",
              flush=True)
        del caches
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--dims", default="64,80,96,128,256")
    ap.add_argument("--kv", default="", help="cache dtypes of kernel 4 to add: e4m3,e5m2,f32")
    ap.add_argument("--no-bf16", action="store_true", help="skip the bf16 rows and kernel 5")
    ap.add_argument("--one", nargs=2, metavar=("NAME", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    dims = [int(d) for d in args.dims.split(",")]
    kvs = [k for k in args.kv.split(",") if k]
    if args.one:   # a variant's own process
        time_variant(*args.one, dims, kvs, not args.no_bf16)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []   # every variant's builds at once
        for name in names:
            os.makedirs(os.path.join(tmp, name))
            procs += [(name, p) for p in build_variant(name, os.path.join(tmp, name), dims)]
        for name, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"variant {name}: nvcc failed\n{log[-6000:]}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas {name}] {line.strip()}", flush=True)
        for name in names:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name,
                            os.path.join(tmp, name), "--dims", args.dims, "--kv", args.kv,
                            *(["--no-bf16"] if args.no_bf16 else [])], check=True, timeout=600)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
