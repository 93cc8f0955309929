#!/usr/bin/env python3
"""Times the decode-width forms of kernels 1 and 2 of the PyTorch/CUDA port
(csrc/qmm_decode.cuh, csrc/qmm_gemv.cuh, csrc/qmm_frag.cuh) under design
variants, on one GPU.

    python3 scripts/torch_decode_gemm_variants.py [--variants base,frag_s4,...]

Each variant is the package's CUDA sources with one constant edited (ring
depth, warps per block) or one part of the kernel cut out (the attribution
variants ``*_loads``, ``*_no_sums``, ``*_empty``: timed, not held), built with the package's nvcc flags into a
temporary directory and timed in a process of its own, as chip_smoke.py
times kernels: CUDA events around a CUDA graph of 60 launches cycling
through weight copies larger than the L2. Every variant times kernel 1 at
4096 x 4096 and 11008 x 4096 (M = 1 and 8) and kernel 2 at 4096 x 11008
(M = 1 and 8) under each K split (cluster sizes 1 to 16) the GEMV and the
fragments take, and at M = 1 the decode form, after holding one launch of
each to the plain version (2e-2 * max|y|).
Prints one line per variant and shape, then the card's name and power limit.
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

# name -> ([(file, old, new)], {plan constant: value}): one design choice each
VARIANTS = {
    "base": ([], {}),
    "frag_s4": ([("qmm_frag.cuh", "constexpr int kStages = 3;", "constexpr int kStages = 4;")],
                {"FRAG_STAGES": 4}),
    "frag_s6": ([("qmm_frag.cuh", "constexpr int kStages = 3;", "constexpr int kStages = 6;")],
                {"FRAG_STAGES": 6}),
    "frag_16_warps": ([("qmm_frag.cuh", "constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
                       ("qmm_frag.cuh", "__launch_bounds__(kThreads, NT == 1 ? 3 : 2)",
                        "__launch_bounds__(kThreads, 1)")], {"FRAG_WARPS": 16}),
    "gemv_s4": ([("qmm_gemv.cuh", "kStages = NW == 1 ? 8 : 4", "kStages = NW == 1 ? 4 : 2")],
                {"GEMV_STAGES": {1: 4, 2: 2}}),
    "gemv_s16": ([("qmm_gemv.cuh", "kStages = NW == 1 ? 8 : 4", "kStages = NW == 1 ? 16 : 8")],
                 {"GEMV_STAGES": {1: 16, 2: 8}}),
}
# Attribution of a launch's time (timing only: their outputs are wrong, so
# they are not held). ``*_loads``: the copies of every ring stage and
# nothing else (no dequantization, product or sum); ``*_no_sums``: the
# copies, the dequantization and the products, with the warps' and the
# cluster's sums and the epilogue left out (the sums are kept alive by a
# store no launch takes); ``*_empty``: a launch of the same grid, cluster
# and shared memory that returns at once.
_FRAG_KEEP = """  cp_async_wait_all();
  {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        t += acc[j][nt][0] + acc[j][nt][1] + acc[j][nt][2] + acc[j][nt][3];
    if (t == 1.2345f) out[0] = __float2bfloat16_rn(t);
  }
  return;"""
_GEMV_KEEP = """  cp_async_wait_all();
  {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) t += acc[w][m][c];
    if (t == 1.2345f) out[0] = __float2bfloat16_rn(t);
  }
  return;"""
_SMEM = "  extern __shared__ __align__(16) unsigned char smem[];"
_WAIT = "  cp_async_wait_all();"
VARIANTS.update({
    "frag_loads": ([("qmm_frag.cuh", "for (int s = 0; s < kSteps; ++s) {",
                     "for (int s = 0; s < 0; ++s) {"),
                    ("qmm_frag.cuh", _WAIT, _WAIT + "\n  return;")], {}),
    "frag_no_sums": ([("qmm_frag.cuh", _WAIT, _FRAG_KEEP)], {}),
    "frag_empty": ([("qmm_frag.cuh", _SMEM, _SMEM + "\n  if (K > 0) return;")], {}),
    "gemv_loads": ([("qmm_gemv.cuh", "    word(wa + i, q, st);", ""),
                    ("qmm_gemv.cuh", _WAIT, _WAIT + "\n  return;")], {}),
    "gemv_no_sums": ([("qmm_gemv.cuh", _WAIT, _GEMV_KEEP)], {}),
    "gemv_empty": ([("qmm_gemv.cuh", _SMEM, _SMEM + "\n  if (K > 0) return;")], {}),
})
# the decode form's own attribution (timing only): its TMA ring alone (the
# consumers wait for each stage and release it), everything but the sum and
# the epilogue, an empty launch; and the tensor maps' L2 promotion
_DEC_KEEP = """  {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < kStrips; ++j)
#pragma unroll
      for (int c = 0; c < kChains; ++c) t += acc[j][c][0] + acc[j][c][1] + acc[j][c][2];
    if (t == 1.2345f) out[0] = __float2bfloat16_rn(t);
  }
  return;
  named_barrier(1, 32 * kWarps);"""
VARIANTS.update({
    "dec_loads": ([("qmm_decode.cuh", "  auto compute = [&](const Octet& q) {",
                    "  auto compute = [&](const Octet& q) {\n    return;")], {}),
    "dec_no_sums": ([("qmm_decode.cuh", "  named_barrier(1, 32 * kWarps);", _DEC_KEEP)], {}),
    "dec_empty": ([("qmm_decode.cuh", "  extern __shared__ unsigned char smem_raw[];",
                    "  extern __shared__ unsigned char smem_raw[];\n  if (K > 0) return;")], {}),
    "dec_promo_none": ([("qmm_wgmma.cuh", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                         "CU_TENSOR_MAP_L2_PROMOTION_NONE")], {}),
    "dec_promo_256": ([("qmm_wgmma.cuh", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                        "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")], {}),
})
# the decode form's consumer work, one part cut out at a time (timing only):
# the dequantization (the raw words into the products), the products (the
# fragments folded into the sums by cheap integer operations), the scale
# and zero reads (constants instead)
_DEQ = """          const uint32_t a[4] = {gptq_frag::dequant_pair<BITS>(q.qa[b][j], 2 * s, q.aa[j]),
                                 gptq_frag::dequant_pair<BITS>(q.qb[b][j], 2 * s, q.ab[j]),
                                 gptq_frag::dequant_pair<BITS>(q.qa[b][j], 2 * s + 1, q.aa[j]),
                                 gptq_frag::dequant_pair<BITS>(q.qb[b][j], 2 * s + 1, q.ab[j])};"""
_MMA = "          mma16816(acc[j][b % kChains], a, b0, b1);"
_AFF = ("      q.aa[j] = gptq_frag::affine<BITS>(sr[0], zr[0]);\n"
        "      q.ab[j] = gptq_frag::affine<BITS>(sr[8], zr[8]);")
VARIANTS.update({
    "dec_no_dequant_t": ([("qmm_decode.cuh", _DEQ, "          const uint32_t a[4] = "
                           "{q.qa[b][j] + s, q.qb[b][j] + s, q.qa[b][j] ^ s, q.qb[b][j] ^ s};")],
                         {}),
    "dec_no_mma_t": ([("qmm_decode.cuh", _MMA, "          acc[j][0][0] += "
                       "__uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3f800000u);")],
                     {}),
    "dec_no_scales_t": ([("qmm_decode.cuh", _AFF,
                          "      q.aa[j] = gptq_frag::affine<BITS>(__float2bfloat16(0.01f), "
                          "__float2bfloat16(8.0f));\n      q.ab[j] = q.aa[j];")], {}),
})
# two items of a stage (256 word rows a stage at 16 warps) unrolled together,
# so that the second's reads can go out beside the first's products
VARIANTS["dec_unroll2"] = ([("qmm_decode.cuh", "  for (int n = 0; n < n_items; ++n) {",
                             "#pragma unroll 2\n  for (int n = 0; n < n_items; ++n) {")],
                           {"DEC_STAGE_BYTES": 32768})
# the decode form's stage: the word bytes a stage aims at (the plan's rows
# follow from it)
VARIANTS.update({"dec_stage8k": ([], {"DEC_STAGE_BYTES": 8192}),
                 "dec_stage32k": ([], {"DEC_STAGE_BYTES": 32768})})
TIMING_ONLY = {name for name in VARIANTS
               if name.endswith(("_loads", "_no_sums", "_empty", "_t"))}


def build_variant(name: str, out: str) -> list:
    """Starts the two nvcc processes of variant ``name`` into ``out``."""
    from gptq_for_llama_tpu_torch.ops.cuda import build
    src = os.path.join(out, "src")
    shutil.copytree(build.CSRC, src)
    for fn, old, new in VARIANTS[name][0]:
        path = os.path.join(src, fn)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {fn} does not hold {old!r} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                              os.path.join(out, f"lib{lib}.so"), os.path.join(src, f"{lib}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for lib in ("qmm", "fused_mlp")]


def time_variant(name: str, out: str) -> None:
    import numpy as np
    import torch
    from chip_smoke import copies_for, graph_ms
    from gptq_for_llama_tpu_torch.ops.cuda import build, matmul, mlp
    from gptq_for_llama_tpu_torch.ops.cuda.mlp import fused_mlp_plain
    from gptq_for_llama_tpu_torch.ops.linear import PackedLinear, quant_matmul_plain
    from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_linear

    for key, value in VARIANTS[name][1].items():
        if isinstance(value, dict):
            getattr(matmul, key).update(value)
        else:
            setattr(matmul, key, value)
    matmul.decode_geometry.cache_clear()
    for lib in ("qmm", "fused_mlp"):
        build._libs[lib] = ctypes.CDLL(os.path.join(out, f"lib{lib}.so"))
    sms = matmul._sm_count(0)
    rng = np.random.RandomState(0)

    def linears(k, n, count):
        w = random_wire_linear(rng, k, n, 128, 4)
        return [PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"], bits=4,
                                       dtype=torch.bfloat16, device="cuda") for _ in range(count)]

    def held(got, want, what):
        if name in TIMING_ONLY:
            return
        err = (got.float() - want.float()).abs().max().item()
        if not err <= 2e-2 * want.float().abs().max().item():
            raise AssertionError(f"{name} {what}: {err} off the plain version")

    def plans(make, m, k, n, streams):
        seen = {}
        for cap in (1, 2, 4, 8, 16):
            p = make(m, k, n, 4, sms, streams, cap=cap)
            seen[p.split] = p
        return seen.values()

    for k, n in ((4096, 4096), (11008, 4096)):
        lins = linears(k, n, copies_for(k * n // 2))
        for m in (1, 8):
            x = torch.randn(m, k, device="cuda").bfloat16()
            want = quant_matmul_plain(x, lins[0])
            row = []
            for path, make in (("gemv", matmul._gemv_plan), ("frag", matmul._frag_plan)):
                for p in plans(make, m, k, n, 1):
                    held(matmul._launch(x, lins[0], p), want, f"qmm {path} M={m}")
                    t = graph_ms(torch, [lambda l=l, p=p: matmul._launch(x, l, p) for l in lins])
                    row.append(f"{path} split {p.split} {t * 1e3:.2f}")
            if m == 1:
                p = matmul.plan(1, k, n, 4, sms, path="decode")
                held(matmul._launch(x, lins[0], p), want, "qmm decode M=1")
                t = graph_ms(torch, [lambda l=l: matmul._launch(x, l, p) for l in lins])
                row.append(f"decode (rows {p.per_split}) {t * 1e3:.2f}")
            print(f"[{name}] kernel 1 {k}x{n} M={m} (us): " + ", ".join(row), flush=True)
        del lins
    k, n = 4096, 11008
    gates = linears(k, n, copies_for(k * n))
    pairs = list(zip(gates, linears(k, n, len(gates))))
    for m in (1, 8):
        x = torch.randn(m, k, device="cuda").bfloat16()
        want = fused_mlp_plain(x, *pairs[0])
        row = []
        for path, make in (("gemv", matmul._gemv_plan), ("frag", matmul._frag_plan)):
            for p in plans(make, m, k, n, 2):
                held(mlp._launch(x, *pairs[0], p), want, f"fused_mlp {path} M={m}")
                t = graph_ms(torch, [lambda g=g, u=u, p=p: mlp._launch(x, g, u, p)
                                     for g, u in pairs])
                row.append(f"{path} split {p.split} {t * 1e3:.2f}")
        if m == 1:
            p = matmul.plan(1, k, n, 4, sms, streams=2, path="decode")
            held(mlp._launch(x, *pairs[0], p), want, "fused_mlp decode M=1")
            t = graph_ms(torch, [lambda g=g, u=u: mlp._launch(x, g, u, p) for g, u in pairs])
            row.append(f"decode (rows {p.per_split}) {t * 1e3:.2f}")
        print(f"[{name}] kernel 2 {k}x{n} M={m} (us): " + ", ".join(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--one", nargs=2, metavar=("NAME", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:   # a variant's own process
        time_variant(*args.one)
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
            procs += [(name, p) for p in build_variant(name, os.path.join(tmp, name))]
        for name, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        for name in names:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name,
                            os.path.join(tmp, name)], check=True, timeout=600)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
