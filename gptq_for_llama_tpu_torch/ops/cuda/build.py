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
``start`` and ``wait`` split a build in two: a caller can start some
libraries at a lower priority, use the others at once, and wait for the
rest where it needs them (``library`` waits for a build in flight). No
build outlives the process that started it: ``start`` registers ``cancel``
with ``atexit`` (once), so an exit with builds in flight stops them.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import signal
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
# builds started and not yet waited for: key -> (nvcc process, temporary
# output, output, log file)
_inflight: dict[str, tuple] = {}
_cancel_at_exit = False   # ``cancel`` registered with atexit


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


def start(keys=None, nice: int = 0) -> None:
    """Start nvcc for every library of ``keys`` (default: all of
    ``targets()``) that is neither built nor building, and return at once.
    ``nice`` > 0 runs those processes at that lower priority. Builds still
    in flight when the process exits are cancelled."""
    global _cancel_at_exit
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not _cancel_at_exit:
        atexit.register(cancel)
        _cancel_at_exit = True
    for key in targets() if keys is None else keys:
        name, _, d = key.partition(":d")
        out = lib_path(name, int(d) if d else None)
        if key in _inflight or os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        defs = [f"-DGPTQ_HEAD_DIM={d}"] if d else []
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        # the report goes to a file: a pipe nobody reads would stall the build
        log = open(f"{tmp}.log", "w+")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True,   # cancel stops cicc and ptxas too
                                preexec_fn=(lambda: os.nice(nice)) if nice > 0 else None)
        _inflight[key] = (proc, tmp, out, log)


def wait(keys=None) -> dict[str, str]:
    """Wait for the builds of ``keys`` in flight (default: every one); raise
    on any failure. Returns {library: ptxas report} of those waited for."""
    built, failed = {}, []
    for key in list(_inflight) if keys is None else keys:
        if key not in _inflight:
            continue
        proc, tmp, out, log = _inflight[key]
        try:
            proc.wait()
        except BaseException:   # an interrupt stops every build in flight
            cancel()
            raise
        del _inflight[key]
        log.seek(0)
        text = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {key} (exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        built[key] = text
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def cancel() -> None:
    """Stop every build in flight and remove what it wrote."""
    while _inflight:
        proc, tmp, _, log = _inflight.popitem()[1]
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        log.close()
        for path in (tmp, log.name):
            if os.path.exists(path):
                os.remove(path)


def build_all() -> dict[str, str]:
    """Compile every library not built yet, in parallel, and wait for every
    build in flight; raise on any failure. Returns {library: ptxas report}
    for the libraries this call waited for."""
    start()
    return wait()


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
