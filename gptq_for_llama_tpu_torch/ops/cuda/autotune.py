"""Measured plan race of kernels 1, 2 and 8, with a persistent cache.

Counterpart of ``gptq_for_llama_tpu/ops/pallas/autotune.py`` (itself the
reference's ``custom_autotune.py``), with the same kinds: "fwd" (kernel 1,
``matmul.py``), "mlp" (kernel 2, ``mlp.py``) and "bwd" (kernel 8,
``matmul_t.py``). The free choices of a plan are its form (``gemv``,
``frag`` or ``tile``), its row tile ``mt`` and its split (along K; along N
for kernel 8); the rest follows from them and the shape
(``matmul.plan_of``, ``matmul_t.plan_of``).

- ``candidates``: every plan the plan functions build for a shape, forced
  to each form and each power-of-two cluster split (the decode-width forms)
  or each row tile and split (the tiles), kept where it is valid for every M
  of its pow2 bucket and its shared memory fits an SM; the heuristic's own
  pick first.
- ``measure``: a chain of the model's own linears of one shape (256 MiB of
  weights, 30 of a 7B model's q/k/v/o, all read from HBM as in a decode
  step, where a lone 8 MB weight would sit in the 50 MB L2), captured as one
  CUDA graph and replayed; CUDA events time each replay. A candidate replaces the
  heuristic's pick only when its median is faster by more than the spread
  of its own replays.
- The cache: a JSON file with a version, keyed (kind, K, N, bits,
  groupsize, pow2 M bucket, card name), so another card never reuses these
  answers; written to a temporary file and then renamed over the old one.
- ``lookup`` answers the kernels' ``plan_for`` (an override first, then the
  cache; None on a miss, and the heuristic decides). A cached entry or an
  override that is not among the shape's candidates raises, naming where it
  came from.

The knobs, read by ``configure`` when a runner or an engine is built (not at
each plan): ``GPTQ_TORCH_AUTOTUNE`` ("1" or unset: measure on a miss and
look up; "ro": look up only; "0": the heuristic only), ``GPTQ_TORCH_AUTOTUNE_CACHE``
(the file; default ``gptq_for_llama_tpu_torch/_build/autotune.json``, beside
the built kernels) and ``GPTQ_TORCH_TUNE_OVERRIDE`` (pins, ``;``-separated
``kind:K<k>:N<n>[:M<bucket>]=path,mt,split``, e.g.
``fwd:K4096:N4096=frag,16,4``; each parsed when read, and checked against
the candidates of its shape when a plan needs it). Before the first
``configure`` every plan is the heuristic's. The race runs on the card only
(``ensure_*`` do nothing on the CPU) and never inside a capture: a capture
freezes the plans it records.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import threading
from functools import lru_cache
from typing import Optional

import torch

MODE_ENV = "GPTQ_TORCH_AUTOTUNE"
PATH_ENV = "GPTQ_TORCH_AUTOTUNE_CACHE"
OVERRIDE_ENV = "GPTQ_TORCH_TUNE_OVERRIDE"
VERSION = 1
KINDS = ("fwd", "mlp", "bwd")
REPS = 7            # timed replays of a candidate's chain (the median decides)
# the weight bytes one chain reads: five times the H100's 50 MB L2, so that
# every weight comes from HBM as in the model (the 32 q_proj of a 7B model)
CHAIN_BYTES = 256 * 2**20
TILE_MIN_SLABS = 4  # the least 64-deep slabs (slices) one tile split keeps
_OVERRIDE = re.compile(r"(fwd|mlp|bwd):K(\d+):N(\d+)(?::M(\d+))?=(gemv|frag|tile),(\d+),(\d+)")


@dataclasses.dataclass
class Settings:
    """What ``configure`` read: the mode, the cache file, the overrides
    ({(kind, K, N, bucket or None): (path, mt, split)}); then the file's
    entries (loaded at the first lookup) and the plans resolved so far."""
    mode: str = "0"
    path: str = ""
    overrides: dict = dataclasses.field(default_factory=dict)
    entries: Optional[dict] = None
    resolved: dict = dataclasses.field(default_factory=dict)


_LOCK = threading.Lock()
_settings = Settings()
measurements = 0    # candidates timed in this process (``measure`` calls)


def default_path() -> str:
    from . import build
    return os.path.join(build.BUILD_DIR, "autotune.json")


def configure() -> Settings:
    """Read the knobs from the environment and start a fresh view of the
    cache; raises on a mode or an override that does not parse."""
    global _settings
    env = os.environ
    mode = env.get(MODE_ENV, "1") or "1"
    if mode not in ("0", "1", "ro"):
        raise ValueError(f"{MODE_ENV}={mode!r}: takes 0, 1 or ro")
    settings = Settings(mode, env.get(PATH_ENV) or default_path(),
                        parse_overrides(env.get(OVERRIDE_ENV, "")))
    with _LOCK:
        _settings = settings
    return settings


def parse_overrides(text: str) -> dict:
    """``kind:K<k>:N<n>[:M<bucket>]=path,mt,split`` entries separated by
    ``;`` -> {(kind, K, N, bucket or None): (path, mt, split)}. An entry that
    does not parse, a bucket that is not a power of two, a form kernel 8 does
    not have or a second entry for one key raises."""
    out = {}
    for entry in filter(None, (e.strip() for e in text.split(";"))):
        hit = _OVERRIDE.fullmatch(entry)
        if hit is None:
            raise ValueError(f"{OVERRIDE_ENV}: {entry!r} is not "
                             "kind:K<k>:N<n>[:M<bucket>]=path,mt,split (kind fwd, mlp or bwd; "
                             "path gemv, frag or tile)")
        kind, k, n, mb, path, mt, split = hit.groups()
        if mb is not None and int(mb) != m_bucket(int(mb)):
            raise ValueError(f"{OVERRIDE_ENV}: {entry!r}: M{mb} is not a power of two")
        if kind == "bwd" and path != "tile":
            raise ValueError(f"{OVERRIDE_ENV}: {entry!r}: kernel 8 has the tiles only")
        key = (kind, int(k), int(n), None if mb is None else int(mb))
        if key in out:
            raise ValueError(f"{OVERRIDE_ENV}: two entries for {entry.split('=')[0]}")
        out[key] = (path, int(mt), int(split))
    return out


def reset_cache_for_tests() -> None:
    """Back to the state before any ``configure`` (the heuristic only)."""
    global _settings, measurements
    with _LOCK:
        _settings = Settings()
        measurements = 0


def m_bucket(m: int) -> int:
    """The smallest power of two >= m, the reference's nearest-power-of-two
    key (``custom_autotune.py:84-87``)."""
    return 1 << max(0, int(m) - 1).bit_length()


@lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index).replace(" ", "_")


def device_name(device) -> str:
    """The card's name with spaces replaced, the last field of a key."""
    return _card_name(torch.device(device).index or 0)


def key(kind: str, k: int, n: int, bits: int, gs: int, m: int, device: str) -> str:
    return f"{kind}:K{k}:N{n}:b{bits}:g{gs}:M{m_bucket(m)}:{device}"


def _load(s: Settings) -> dict:
    with _LOCK:
        if s.entries is None:
            entries = {}
            if os.path.exists(s.path):
                with open(s.path) as f:
                    data = json.load(f)
                if data.get("version") != VERSION:
                    raise ValueError(f"autotune cache {s.path}: version {data.get('version')}, "
                                     f"this package writes {VERSION}; move the file away")
                entries = dict(data["entries"])
            s.entries = entries
        return s.entries


def store(kind: str, k: int, n: int, bits: int, gs: int, m: int, plan, device: str) -> str:
    """Record ``plan``'s free choices under its key and write the file (to
    a temporary file, then renamed over the old one). Returns the key."""
    s = _settings
    entries = _load(s)
    name = key(kind, k, n, bits, gs, m, device)
    with _LOCK:
        entries[name] = {"path": plan.path, "mt": plan.mt, "split": plan.split}
        s.resolved.clear()
        os.makedirs(os.path.dirname(s.path) or ".", exist_ok=True)
        tmp = f"{s.path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": VERSION, "entries": entries}, f, indent=1, sort_keys=True)
        os.replace(tmp, s.path)
    return name


def lookup(kind: str, k: int, n: int, bits: int, gs: int, m: int, sms: int, device):
    """The plan of ``kind`` at (M, K) x (K, N) from an override or the cache,
    None on a miss (or before ``configure``, or in mode "0" without an
    override). A choice that is not a candidate of the shape raises."""
    s = _settings
    if s.mode == "0" and not s.overrides:
        return None
    mb = m_bucket(m)
    name = device_name(device)
    memo = (kind, k, n, bits, gs, mb, sms, name)
    if memo in s.resolved:
        return s.resolved[memo]
    choice = origin = None
    for ov in ((kind, k, n, mb), (kind, k, n, None)):
        if ov in s.overrides:
            choice = s.overrides[ov]
            origin = f"{OVERRIDE_ENV} entry {ov[0]}:K{k}:N{n}" + (
                "" if ov[3] is None else f":M{mb}")
            break
    if choice is None and s.mode != "0":
        entry = _load(s).get(key(kind, k, n, bits, gs, m, name))
        if entry is not None:
            choice = (entry["path"], entry["mt"], entry["split"])
            origin = f"autotune cache {s.path}, entry {key(kind, k, n, bits, gs, m, name)}"
    plan = None
    if choice is not None:
        cands = candidates(kind, k, n, bits, gs, mb, sms)
        plan = next((p for p in cands if (p.path, p.mt, p.split) == tuple(choice)), None)
        if plan is None:
            raise ValueError(f"{origin}: {choice} is not a plan of {kind} at K={k}, N={n}, "
                             f"{bits}-bit g{gs}, M bucket {mb}; its candidates: "
                             f"{[(p.path, p.mt, p.split) for p in cands]}")
    s.resolved[memo] = plan
    return plan


def _pow2_splits(limit: int) -> list[int]:
    return [1 << i for i in range(limit.bit_length()) if 1 << i <= limit]


def candidates(kind: str, k: int, n: int, bits: int, gs: int, m: int, sms: int) -> list:
    """Every plan of ``kind`` at (K, N) valid for every M of m's pow2 bucket,
    the heuristic's pick for the bucket's top first:

    - kernels 1 and 2: the GEMV at the row tile ``_gemv_plan`` takes and the
      fragment form (M <= 8 per n8 tile, ``frag_ok``) at its own, each at
      every power-of-two cluster split up to ``CLUSTER_MAX`` that leaves no
      split empty; the tiles (K and N multiples of 8) at every row tile up to
      the one that holds the bucket, each at the split the heuristic gives it
      and at every power-of-two split that keeps ``TILE_MIN_SLABS`` slabs;
    - kernel 8: its tiles, the same way along N's 64-wide slices.

    Shared memory of each fits an SM (1 KB of it reserved per block)."""
    from . import matmul as mm
    from . import matmul_t as mt_mod
    if kind not in KINDS:
        raise ValueError(f"autotune kinds are {KINDS}, got {kind!r}")
    mb = m_bucket(m)
    fits = mm.SMEM_PER_SM - 1024
    if kind == "bwd":
        first = mt_mod.plan(mb, k, n, bits, sms)
        slices = -(-n // mt_mod.SLICE_N)
        out = [first]
        for bm in _row_tiles(mb):
            splits = [first.split if bm == first.mt else 1]
            splits += _pow2_splits(max(1, slices // TILE_MIN_SLABS))
            out += [mt_mod.plan_of(bm, s, n, bits) for s in splits]
        return _valid(out, fits)
    streams = 2 if kind == "mlp" else 1
    first = mm.plan(mb, k, n, bits, sms, streams, groupsize=gs)
    out = [first]
    gemv = mm._gemv_plan(mb, k, n, bits, sms, streams)
    units = k // (32 // bits)
    out += [mm.plan_of("gemv", gemv.mt, s, k, bits, streams)
            for s in _pow2_splits(mm.CLUSTER_MAX) if _nonempty(units, s)]
    if mb <= mm.FRAG_MAX_M and mm.frag_ok(k, n, bits, gs):
        frag = mm._frag_plan(mb, k, n, bits, sms, streams)
        kbs = -(-k // mm.frag_rows_per_block(bits))
        out += [mm.plan_of("frag", frag.mt, s, k, bits, streams)
                for s in _pow2_splits(mm.CLUSTER_MAX) if _nonempty(kbs, s)]
    if k % 8 == 0 and n % 8 == 0:
        slabs = -(-k // mm.TC_TILE_K)
        tile = mm._tile_plan(mb, k, n, bits, sms, streams)
        for bm in _row_tiles(mb):
            splits = [tile.split if bm == tile.mt else 1]
            splits += _pow2_splits(max(1, slabs // TILE_MIN_SLABS))
            out += [mm.plan_of("tile", bm, s, k, bits, streams) for s in splits]
    return _valid(out, fits)


def _row_tiles(mb: int) -> list[int]:
    """The tiles' row tiles up to the first that holds a bucket of ``mb``
    rows (a larger one only pads)."""
    from .matmul import TC_ROW_TILES
    out = []
    for bm in TC_ROW_TILES:
        out.append(bm)
        if bm >= mb:
            break
    return out


def _nonempty(units: int, split: int) -> bool:
    """No split of a cluster split of ``units`` is empty."""
    return (split - 1) * -(-units // split) < units


def _valid(plans: list, fits: int) -> list:
    """``plans`` in order, each once, those whose shared memory fits."""
    out, seen = [], set()
    for p in plans:
        if p.smem <= fits and (p.path, p.mt, p.split) not in seen:
            seen.add((p.path, p.mt, p.split))
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def measure(run, reps: int = REPS) -> list[float]:
    """Seconds of each of ``reps`` replays of ``run`` (a chain of kernel
    launches) captured as one CUDA graph, one warm call and one warm replay
    first; CUDA events around each replay. Every time must be positive."""
    global measurements
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune: no race inside a CUDA graph capture")
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    del graph
    measurements += 1
    return [start.elapsed_time(end) / 1e3 for start, end in events]


def pick(timed: list) -> tuple:
    """The winner of [(plan, replay seconds), ...], the heuristic's pick
    first: the fastest median among the candidates faster than the
    heuristic's median by more than the spread (max - min) of their own
    replays, else the heuristic's. A timing that is not positive and finite
    raises: it would win the race and be written to the cache."""
    for plan, times in timed:
        if not times or not all(0 < t < float("inf") for t in times):
            raise RuntimeError(f"autotune: timing of {plan} is {times}, not positive and finite")
    base = statistics.median(timed[0][1])
    best, best_t = timed[0][0], base
    for plan, times in timed[1:]:
        med = statistics.median(times)
        if base - med > max(times) - min(times) and med < best_t:
            best, best_t = plan, med
    return best, best_t


def _race(kind, sig, units, m, log, launch, rows):
    """Time every candidate of ``kind`` at ``sig`` (K, N, bits, groupsize)
    over a chain of ``launch(x, unit, plan)`` for the first units whose
    weights reach ``CHAIN_BYTES`` (all of them where they do not), store and
    return the winner."""
    from .matmul import _sm_count
    k, n, bits, gs = sig
    chain_units, nbytes = [], 0
    for u in units:
        if nbytes >= CHAIN_BYTES:
            break
        chain_units.append(u)
        nbytes += sum(t.numel() * t.element_size() for lin in (u if isinstance(u, tuple) else (u,))
                      for t in (lin.qweight, lin.scales, lin.zeros))
    units = chain_units
    dev = rows.device
    sms = _sm_count(dev.index or 0)
    cands = candidates(kind, k, n, bits, gs, m, sms)
    timed = []
    for plan in cands:
        def chain(p=plan):   # the outputs are dropped as they come
            for u in units:
                launch(rows, u, p)

        times = measure(chain)
        timed.append((plan, times))
        if log:
            log(f"  autotune {kind} K={k} N={n} M={rows.shape[0]} {plan.path} mt={plan.mt} "
                f"split={plan.split}: {statistics.median(times) / len(units) * 1e6:.2f} us a "
                f"launch (median of {len(times)} replays of {len(units)})")
    best, best_t = pick(timed)
    name = store(kind, k, n, bits, gs, m, best, device_name(dev))
    if log:
        log(f"  autotune {name}: {best.path} mt={best.mt} split={best.split} "
            f"({best_t / len(units) * 1e6:.2f} us a launch; the heuristic's "
            f"{statistics.median(timed[0][1]) / len(units) * 1e6:.2f})")
    return best


def _rows(m: int, width: int, device) -> torch.Tensor:
    """The race's input: M's bucket of rows of seeded normal bf16 values."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((m_bucket(m), width), generator=gen, device=device).to(torch.bfloat16)


def tune_qmm(lins: list, m: int, kind: str = "fwd", log=None):
    """Race kernel 1 ("fwd") or kernel 8 ("bwd") at M's bucket over ``lins``,
    packed linears of one shape; store and return the winner (a cache hit
    returns the stored plan and measures nothing)."""
    from . import matmul as mm
    from . import matmul_t as mt_mod
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"tune_qmm takes kind fwd or bwd, got {kind!r}")
    lin = lins[0]
    sig = (lin.in_features, lin.out_features, lin.bits, lin.groupsize)
    if any((u.in_features, u.out_features, u.bits, u.groupsize) != sig for u in lins):
        raise ValueError("tune_qmm: the linears of one race share one shape")
    dev = lin.qweight.device
    hit = lookup(kind, *sig, m, mm._sm_count(dev.index or 0), dev)
    if hit is not None:
        return hit
    x = _rows(m, lin.in_features if kind == "fwd" else lin.out_features, dev)
    for u in lins:
        if kind == "fwd":
            mm.check_packed(u, x)
        else:
            mt_mod.check_operands(x, u)
    launch = mm._launch if kind == "fwd" else mt_mod._launch
    return _race(kind, sig, lins, m, log, launch, x)


def tune_mlp(pairs: list, m: int, log=None):
    """Race kernel 2 at M's bucket over ``pairs`` of (gate, up) of one shape;
    store and return the winner (a cache hit measures nothing)."""
    from . import matmul as mm
    from . import mlp
    gate = pairs[0][0]
    sig = (gate.in_features, gate.out_features, gate.bits, gate.groupsize)
    dev = gate.qweight.device
    hit = lookup("mlp", *sig, m, mm._sm_count(dev.index or 0), dev)
    if hit is not None:
        return hit
    x = _rows(m, gate.in_features, dev)
    for g, u in pairs:
        if not mlp.supports_fused(g, u) or (g.in_features, g.out_features, g.bits,
                                            g.groupsize) != sig:
            raise ValueError("tune_mlp: the pairs of one race are fusable and share one shape")
        mm.check_packed(g, x)
        mm.check_packed(u, x)
    return _race("mlp", sig, pairs, m, log, lambda xx, pair, p: mlp._launch(xx, *pair, p), x)


def _on(first) -> bool:
    """Measure now: mode "1", on the card."""
    return _settings.mode == "1" and first is not None and first.qweight.is_cuda


def _groups(items, lin_of) -> dict:
    out = {}
    for it in items:
        lin = lin_of(it)
        out.setdefault((lin.in_features, lin.out_features, lin.bits, lin.groupsize), []).append(it)
    return out


def ensure_linears(linears: list, m: int, kind: str = "fwd", log=None) -> None:
    """Race every shape among ``linears`` (kernel 1, or kernel 8 for "bwd")
    at M's bucket that the cache does not hold. Nothing on the CPU or in
    modes "0" and "ro"."""
    if not _on(linears[0] if linears else None):
        return
    for lins in _groups(linears, lambda lin: lin).values():
        tune_qmm(lins, m, kind, log)


def ensure_mlp_pairs(pairs: list, m: int, log=None) -> None:
    """Race every shape among (gate, up) ``pairs`` (kernel 2) at M's bucket
    that the cache does not hold. Nothing on the CPU or in modes "0" and
    "ro"."""
    if not _on(pairs[0][0] if pairs else None):
        return
    for group in _groups(pairs, lambda pair: pair[0]).values():
        tune_mlp(group, m, log)


def ensure(params, act: str, rows) -> None:
    """Race every tuning unit of ``params`` (``collect``) at the pow2 bucket
    of each of ``rows`` that the cache does not hold: what a runner's
    ``warmup`` and an engine do before they capture a graph."""
    linears, pairs = collect(params, act)
    for m in sorted({m_bucket(r) for r in rows}):
        ensure_linears(linears, m)
        ensure_mlp_pairs(pairs, m)


def collect(params, act: str = "silu") -> tuple[list, list]:
    """The tuning units of a parameter tree: (the packed linears kernel 1
    runs, the (gate, up) pairs kernel 2 runs: packed, fusable, under SiLU;
    ``ops/quant_matmul.fused_gate_up``)."""
    from ..linear import PackedLinear
    from .mlp import supports_fused
    pairs = []
    for lp in params.get("layers", ()):
        mlp = lp.get("mlp") if isinstance(lp, dict) else None
        g, u = (mlp.get("gate_proj"), mlp.get("up_proj")) if isinstance(mlp, dict) else (None,
                                                                                          None)
        if (act == "silu" and isinstance(g, PackedLinear) and isinstance(u, PackedLinear)
                and supports_fused(g, u)):
            pairs.append((g, u))
    paired = {id(x) for pair in pairs for x in pair}
    linears = []

    def walk(t):
        if isinstance(t, PackedLinear):
            if id(t) not in paired:
                linears.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(params)
    return linears, pairs
