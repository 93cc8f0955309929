"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes); the attention
sources (``PER_HEAD_DIM``) become one library per head dim of ``HEAD_DIMS``,
built with ``-DGPTQ_HEAD_DIM=<D>``, so each translation unit instantiates
one head dim and the builds spread over the cores. The first call to
``library`` compiles every library that is not built yet, one nvcc process
per library, all started together, into ``gptq_for_llama_tpu_torch/_build/``
(listed in .gitignore). A library's file name carries a digest of all
sources and flags, so a changed source is rebuilt and a built one is reused.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("qmm", "fused_mlp", "decode_attention", "flash_prefill_blocked", "flash_prefill",
           "rms_norm", "pool_decode_attention", "qmm_t", "fused_decode_attention")
# the attention kernels' head dims (kernels 3, 4, 5, 7, 9), one library each
HEAD_DIMS = (64, 80, 96, 128, 256)
PER_HEAD_DIM = ("decode_attention", "flash_prefill_blocked", "flash_prefill",
                "pool_decode_attention", "fused_decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of gptq_for_llama_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):   # headers (.cuh) included
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _key(name: str, head_dim: int | None) -> str:
    """The library's name: ``name``, or ``name:d<D>`` for a per-head-dim one."""
    if name not in SOURCES:
        raise KeyError(f"no CUDA source {name!r}; have {SOURCES}")
    if name not in PER_HEAD_DIM:
        return name
    d = 128 if head_dim is None else int(head_dim)
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: no kernel at head dim {d}; built for {HEAD_DIMS} "
                         f"(ROADMAP B6)")
    return f"{name}:d{d}"


def targets() -> list[str]:
    """Every library: one per source, one per head dim of the attention ones."""
    return [f"{n}:d{d}" if n in PER_HEAD_DIM else n
            for n in SOURCES for d in (HEAD_DIMS if n in PER_HEAD_DIM else (None,))]


def lib_path(name: str, head_dim: int | None = None) -> str:
    key = _key(name, head_dim)
    return os.path.join(BUILD_DIR, f"lib{key.replace(':', '-')}-{_digest()}.so")


def build_all() -> dict[str, str]:
    """Compile every library not built yet, in parallel; raise on any failure.
    Returns {library: ptxas report} for the libraries this call built."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for key in targets():
        name, _, d = key.partition(":d")
        out = lib_path(name, int(d) if d else None)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        defs = [f"-DGPTQ_HEAD_DIM={d}"] if d else []
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    built, failed = {}, []
    for key, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {key} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        built[key] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def library(name: str, head_dim: int | None = None) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu (an attention source: at
    ``head_dim``, default 128), built at first use. A head dim with no
    library raises."""
    key = _key(name, head_dim)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = lib_path(name, head_dim)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            _libs[key] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        fn = lib.gptq_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()}) at launch")
