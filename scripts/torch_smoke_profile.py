#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py`` goes: a stack-sampling profile.

    python3 scripts/torch_smoke_profile.py [--out PATH] [--build-times]
                                           [-- chip_smoke.py arguments]

Runs the smoke's ``main`` in this process while a thread reads the main
thread's stack every 50 ms and adds the time since its last look to:
each smoke function on the stack (inclusive), the innermost smoke line,
the innermost frame of the port's package, and the innermost frame of
all. While a CUDA graph is being captured the thread only counts the time
(``capturing_s``): under the default global capture mode any Python
allocation of the thread could collect garbage that frees a CUDA object
and so invalidate the capture. Time spent in a child process (the CLIs,
the tp phase's ranks) shows as the parent's wait.

``--build-times`` first compiles every library of ``ops/cuda/build.py``
itself, all nvcc processes started together, and records each one's CPU
seconds (its children's included) and the second it finished; the smoke's
build phase then finds them built.

Writes the counters, the smoke's seconds and the capture seconds as JSON to
``--out`` (default ``smoke_profile.json``) and prints the top entries to
stderr. Needs the card, as the smoke does.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_times() -> dict:
    """Compile every library (all nvcc processes at once); CPU seconds and
    finishing second of each."""
    from gptq_for_llama_tpu_torch.ops.cuda import build
    nvcc = build._nvcc()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs, t0 = {}, time.time()
    for key in build.targets():
        name, _, d = key.partition(":d")
        out = build.lib_path(name, int(d) if d else None)
        tmp = f"{out}.tmp{os.getpid()}"
        defs = [f"-DGPTQ_HEAD_DIM={d}"] if d else []
        cmd = [nvcc, *build.NVCC_FLAGS, *defs, "-o", tmp, os.path.join(build.CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        procs[proc.pid] = (key, tmp, out)
    libs = {}
    while procs:
        pid, status, usage = os.wait4(-1, 0)
        if pid not in procs:
            continue
        key, tmp, out = procs.pop(pid)
        if status == 0:
            os.replace(tmp, out)
        libs[key] = {"cpu_s": usage.ru_utime + usage.ru_stime, "done_s": time.time() - t0,
                     "status": status}
    wall = time.time() - t0
    for key, v in sorted(libs.items(), key=lambda kv: -kv[1]["cpu_s"]):
        print(f"[build] {key}: {v['cpu_s']:.1f} CPU-s, done at {v['done_s']:.1f} s, "
              f"status {v['status']}", file=sys.stderr)
    print(f"[build] wall {wall:.1f} s, {sum(v['cpu_s'] for v in libs.values()):.1f} CPU-s, "
          f"{os.cpu_count()} CPUs", file=sys.stderr)
    return {"wall_s": wall, "libraries": libs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="smoke_profile.json")
    ap.add_argument("--build-times", action="store_true")
    ap.add_argument("smoke_args", nargs="*", help="arguments of chip_smoke.py, after --")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    prof = {"build": build_times()} if args.build_times else {}
    counters = {k: collections.Counter() for k in ("inclusive", "line", "package", "leaf")}
    lock, capturing, capture_s = threading.Lock(), [0], [0.0]
    begin, end = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end

    def capture_begin(self, *a, **kw):
        with lock:   # no capture starts while the thread reads a stack
            capturing[0] += 1
        try:
            return begin(self, *a, **kw)
        except BaseException:
            capturing[0] -= 1
            raise

    def capture_end(self, *a, **kw):
        try:
            return end(self, *a, **kw)
        finally:
            capturing[0] -= 1

    torch.cuda.CUDAGraph.capture_begin = capture_begin
    torch.cuda.CUDAGraph.capture_end = capture_end
    main_id, stop = threading.get_ident(), threading.Event()

    def sample():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(0.05)
            now = time.perf_counter()
            w, last = now - last, now
            with lock:
                if capturing[0]:
                    capture_s[0] += w   # floats only: nothing for the collector
                    continue
                frame = sys._current_frames().get(main_id)
                stack = []
                while frame is not None:
                    stack.append((frame.f_code.co_filename, frame.f_code.co_name,
                                  frame.f_lineno))
                    frame = frame.f_back
            if not stack:
                continue
            stack.reverse()
            smoke = [f for f in stack if f[0].endswith("chip_smoke.py")]
            for name in {f[1] for f in smoke}:
                counters["inclusive"][name] += w
            if smoke:
                counters["line"][f"{smoke[-1][1]}:{smoke[-1][2]}"] += w
            counters["leaf"][f"{os.path.basename(stack[-1][0])}:{stack[-1][1]}"] += w
            for f in reversed(stack):
                if "gptq_for_llama_tpu_torch" in f[0]:
                    rel = f[0].split("gptq_for_llama_tpu_torch" + os.sep)[-1]
                    counters["package"][f"{rel}:{f[1]}"] += w
                    break

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    import chip_smoke
    sys.argv = ["chip_smoke.py", *args.smoke_args]
    t0 = time.perf_counter()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        thread.join()
        prof.update(smoke_s=time.perf_counter() - t0, capturing_s=capture_s[0],
                    **{k: dict(c.most_common(400)) for k, c in counters.items()})
        with open(args.out, "w") as f:
            json.dump(prof, f, indent=1)
        for k in ("inclusive", "line", "package"):
            print(f"== {k}", file=sys.stderr)
            for name, s in counters[k].most_common(25):
                print(f"{s:8.1f} {name}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
