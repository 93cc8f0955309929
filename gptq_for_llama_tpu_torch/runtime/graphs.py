"""CUDA graphs of the runner's and the serving engine's steps.

Counterpart of ``jax.jit``'s role in ``gptq_for_llama_tpu/runtime``: the TPU
package runs its decode step, token scans and serving spans as compiled
programs; the port captures the same step bodies as ``torch.cuda.CUDAGraph``s
and replays them. A body reads and writes only tensors that outlive it (the
caches, the offsets on the card, input and output buffers its owner made
once), so a replay does on the card what a call of the body did at capture.
On the CPU there is nothing to capture: ``Graphs.run`` calls the body, the
same code the card captures.

Capture: one warm call of the body on a side stream first (it builds and
loads every kernel the body launches and makes its first allocations, none
of which a capture allows), with the state it changes in place put back
afterwards (``restore``: tensors and generators), then the capture into the
owner's one memory pool. A capture that fails raises: nothing falls back to
eager on the card.

Launch accounting: the kernel wrappers count in Python (``ops/cuda``), so
their counts move while a body is captured and not when it is replayed. A
graph records the change of ``launch_counts()``, and of its owner's own
counters (the engine's ``forwards``), across its capture, takes it back (the
capture launched nothing) and adds it again on every replay.

Graphs are keyed by a bucket of the live length: the decode kernels and the
blocked prefill kernel plan from a host-side bound on the live slots, which a
capture freezes (``live_buckets``, ``bucket_for``); the offsets, slots and
token ids they run at are device buffers the owner loads before a replay.
The keys, by kind (``kind``): the runner's ("decode", bucket),
("greedy" | "forced", n, bucket), ("sample", ...) and ("prefill", S_pad,
bucket); the engine's decode spans (span, mode, bucket), ("prefill", blen),
("admit", blen), ("chunk", bucket) and ("chunk+decode", bucket).
"""

from __future__ import annotations

import time
from typing import Callable, Hashable, NamedTuple

import torch

from ..ops import cuda as kernels


def live_buckets(max_len: int, smallest: int = 128) -> tuple[int, ...]:
    """The live-length buckets of a cache of ``max_len`` slots: ``smallest``
    doubled while below ``max_len``, then ``max_len``."""
    out, b = [], smallest
    while b < max_len:
        out.append(b)
        b *= 2
    return (*out, max_len)


def bucket_for(live: int, buckets) -> int:
    """The smallest bucket that holds ``live`` slots (at a span's end, the
    largest offset + 1). A live length past the cache takes the last bucket,
    the cache length: no plan is made for more slots than the cache has."""
    for b in buckets:
        if live <= b:
            return b
    return buckets[-1]


def kind(key) -> str:
    """The kind of a graph key: its first word, "decode" for the engine's
    decode spans (keyed (span, mode, bucket))."""
    return key[0] if isinstance(key[0], str) else "decode"


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    out: object          # the body's return value at capture: tensors a replay rewrites
    launches: dict       # launch_counts() added by one replay
    counts: tuple        # one dict per owner counter, added by one replay
    seconds: float       # host seconds of its warm call and capture


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


class Graphs:
    """Graphs of one runner or engine, keyed by a hashable key, in one memory
    pool. ``counters``: the owner's dicts of ints that its bodies raise (they
    are accounted like the launch counts). ``eager``: never capture, call
    every body, on the card too (the tensor-parallel steps, whose
    collectives a graph cannot hold under gloo)."""

    def __init__(self, device, counters=(), eager: bool = False):
        self.device = torch.device(device)
        self.counters = tuple(counters)
        self.eager = eager
        self._graphs: dict[Hashable, _Captured] = {}
        self._pool = None
        self.capture_s = 0.0     # host seconds spent capturing, warm calls included
        self.replays: dict[Hashable, int] = {}   # replays of each key

    @property
    def on_card(self) -> bool:
        """Whether the bodies are captured and replayed: on the card, unless
        ``eager``."""
        return self.device.type == "cuda" and not self.eager

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self):
        return self._graphs.keys()

    def run(self, key: Hashable, body: Callable, restore=(), generators=()):
        """On the card: replay the graph of ``key``, captured from ``body``
        first if it is new; return what the body returned at capture, now
        rewritten by the replay (copy out what must outlive the next replay
        of any graph of this pool). On the CPU, or ``eager``: ``body()``."""
        if not self.on_card:
            return body()
        if key not in self._graphs:
            self.capture(key, body, restore, generators)
        return self.replay(key)

    def replay(self, key: Hashable):
        captured = self._graphs[key]
        captured.graph.replay()
        self._add(captured.launches, captured.counts)
        self.replays[key] = self.replays.get(key, 0) + 1
        return captured.out

    def by_kind(self) -> dict[str, dict]:
        """Per kind of key: graphs captured, their capture seconds (warm
        calls included) and replays."""
        out: dict[str, dict] = {}
        for key, captured in self._graphs.items():
            row = out.setdefault(kind(key), {"graphs": 0, "capture_s": 0.0, "replays": 0})
            row["graphs"] += 1
            row["capture_s"] += captured.seconds
            row["replays"] += self.replays.get(key, 0)
        return out

    def capture(self, key: Hashable, body: Callable, restore=(), generators=()) -> None:
        """Warm call, then capture. ``restore``: tensors the body changes in
        place (offsets, token buffers), put back after the warm call;
        ``generators``: the CUDA generators the body draws from, their states
        put back after the warm call and registered with the graph."""
        if key in self._graphs:
            raise KeyError(f"graph {key!r} is already captured")
        t0 = time.perf_counter()
        saved = [t.clone() for t in restore]
        states = [g.get_state() for g in generators]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body()
            for t, s in zip(restore, saved):
                t.copy_(s)
        current.wait_stream(side)
        for g, s in zip(generators, states):
            g.set_state(s)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = self._snapshot()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = body()
        finally:
            after = self._snapshot()
            launches = _diff(after[0], before[0])
            counts = tuple(_diff(a, b) for a, b in zip(after[1], before[1]))
            self._add({k: -n for k, n in launches.items()},
                      tuple({k: -n for k, n in c.items()} for c in counts))
        seconds = time.perf_counter() - t0
        self._graphs[key] = _Captured(graph, out, launches, counts, seconds)
        self.capture_s += seconds

    def pool_bytes(self) -> int | None:
        """Bytes the caching allocator holds for this pool's graphs (None on
        the CPU or before the first capture)."""
        if self._pool is None:
            return None
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def _snapshot(self):
        return kernels.launch_counts(), tuple(dict(c) for c in self.counters)

    def _add(self, launches: dict, counts: tuple) -> None:
        kernels.add_launch_counts(launches)
        for counter, delta in zip(self.counters, counts):
            for k, n in delta.items():
                counter[k] += n
