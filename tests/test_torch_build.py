"""The kernel build's processes end with the process that started them.

``ops/cuda/build.start`` runs each nvcc in a process group of its own and returns
at once; a caller that exits without waiting (the smoke's build phase in a
child process, say) must not leave those compilers running. A child Python
process points the build at a fake compiler that records its pid and
sleeps, starts a build and exits; the fake must be gone right after.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap
import time

BUILD_PY = (pathlib.Path(__file__).resolve().parents[1] / "gptq_for_llama_tpu_torch" / "ops"
            / "cuda" / "build.py")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie has exited: only its parent's wait is missing
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_a_build_in_flight_ends_with_its_process(tmp_path):
    pidfile = tmp_path / "nvcc.pid"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\necho $$ > {pidfile}\nexec sleep 30\n")
    fake.chmod(0o755)
    code = textwrap.dedent(f"""
        import importlib.util, os, time
        spec = importlib.util.spec_from_file_location("build", {str(BUILD_PY)!r})
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        build._nvcc = lambda: {str(fake)!r}
        build.BUILD_DIR = {str(tmp_path / "_build")!r}
        build.start(["qmm"])
        t = time.monotonic()
        while not os.path.exists({str(pidfile)!r}) and time.monotonic() - t < 10:
            time.sleep(0.01)
        assert os.path.getsize({str(pidfile)!r}) > 0
    """)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=30)
    assert run.returncode == 0, run.stderr
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 2
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.02)
    alive = _alive(pid)
    if alive:
        os.kill(pid, 9)
    assert not alive, "the nvcc started by build.start outlived the process that started it"
    assert not list((tmp_path / "_build").glob("*.tmp*")), "cancel left a partial library"
