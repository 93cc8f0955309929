"""Phase timing and device tracing.

Counterpart of ``gptq_for_llama_tpu/utils/profiling.py``: wall-clock per named
phase, a ``torch.profiler`` trace of a block (Chrome trace JSON, readable in
Perfetto), and the card's memory counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase; ``summary`` gives a table."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        from .metrics import ascii_table
        rows = [[n, self.counts[n], round(self.totals[n], 3),
                 round(self.totals[n] / max(self.counts[n], 1), 4)]
                for n in sorted(self.totals, key=self.totals.get, reverse=True)]
        return ascii_table(["phase", "calls", "total_s", "mean_s"], rows)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block (CPU, and CUDA when a card is present);
    writes ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> dict:
    """Memory counters of every visible card (empty without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"allocated": torch.cuda.memory_allocated(i),
                          "max_allocated": torch.cuda.max_memory_allocated(i),
                          "reserved": torch.cuda.memory_reserved(i)}
            for i in range(torch.cuda.device_count())}
