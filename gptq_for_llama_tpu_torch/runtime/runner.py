"""Inference runner: prefill and decode over a static per-layer KV cache.

Counterpart of ``gptq_for_llama_tpu/runtime/runner.py``. The TPU package
jits its decode step and runs its token loops as ``lax.scan`` programs; the
port runs the same steps as CUDA graphs (``runtime/graphs.py``). ``decode``
replays the one-step graph of the live-length bucket; ``decode_greedy_scan``,
``decode_sample_scan`` and ``forced_decode_scan`` replay graphs of up to
``SCAN_PIECE`` steps each, back to back with no host read between them (the
argmax, the sampling and the teacher-forced token are inside the graph);
``generate(span=)`` decodes its spans through ``decode_sample_scan``;
``prefill`` replays the graph of ("prefill", S_pad, bucket): the prompt
right-padded to S_pad (``prefill_len``), at the device offset. On the CPU the
same step bodies run eagerly.

The bodies read the offset from a (B,) int32 tensor on the device (every row
aligned; a decode body advances it in place), so a graph holds no host value
but the plan bound of its bucket: the decode kernels' split and the blocked
prefill kernel's body. Layers are a Python loop; the cache is the runner's
own storage, written in place (see ``ModelRunner``).

Entry points run on the card unless the caller asks for the CPU: a
``ModelRunner`` without ``device=`` needs CUDA and raises without it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.registry import check_positions, embed_weight, get_arch
from ..ops import kv_dtype as kv
from ..ops.cuda import autotune as at
from .graphs import Graphs, bucket_for, live_buckets

# most decode steps one graph of a token scan holds (a power of two): a scan
# replays graphs of at most this many steps (``ModelRunner._pieces``)
SCAN_PIECE = 32
# the smallest prompt bucket of the prefill graphs: prompts are right-padded
# to a power of two from here (``prefill_len``)
PREFILL_MIN = 16


def prefill_len(s: int, room: int) -> int:
    """S_pad, the rows of the prefill graph a prompt of ``s`` tokens runs
    in: the smallest power of two from PREFILL_MIN that holds it and fits the
    ``room`` left in the cache (max_len - offset); ``s`` itself where none
    fits. The TPU package compiles one program per exact length; a capture
    costs more than the eager prefill it replaces, so the port pads to few
    lengths (ROADMAP, C)."""
    p = PREFILL_MIN
    while p < s:
        p *= 2
    return p if p <= room else s


@dataclasses.dataclass
class KVCache:
    """A handle on a runner's cache. ``k``/``v``: per layer (B, max_len, Hkv,
    D), written in place; ``offset``: the valid slots, on the host (every row
    aligned); ``offs``: the runner's (B,) int32 offsets on the device, which
    the decode graphs read and advance; ``epoch``: the runner's
    ``init_cache`` count when the handle was made (a handle of an earlier
    epoch is stale and raises when used)."""
    k: list
    v: list
    offset: int
    offs: Optional[torch.Tensor] = None
    epoch: int = 0


class ModelRunner:
    """Prefill and decode for one (model, batch, max_len) configuration.

    ``params`` must already live on ``device`` (see ``convert.params_from_jax``
    and ``runtime.random_model``).

    The cache is the runner's own, allocated at the first ``init_cache()``
    and kept: a captured graph writes into the tensors it was captured over.
    ``init_cache()`` hands out that storage, zeroed, with both offsets reset,
    and a handle from before the latest ``init_cache()`` raises when it is
    used, on both devices. So a runner holds ONE live sequence (batch) at a
    time: two sequences need two runners, and never alias. The TPU package's
    caches are functional values; the port's are not. Within one epoch a
    step may start again from an earlier handle (a smaller offset): it
    rewrites the cache from that offset on, as the TPU package would.

    ``cache_impl``: "classic" writes each step's k/v and then attends the
    cache (the decode kernel); "fold" decodes every one-token step through the
    fold kernel, over the stale cache with the current k/v folded in, and
    then writes the row (the TPU package's GPTQ_TPU_CACHE_IMPL=pallas).
    Prefills are the same in both.

    ``kv_dtype``: the cache's storage dtype (None: ``dtype``): bf16, f32,
    fp8-e4m3 or fp8-e5m2 (``ops/kv_dtype.py``), as the TPU package's
    ``kv_dtype``; compute stays in ``dtype`` and the kernels read the cache in
    its stored dtype. The graphs' keys do not name it: it is fixed per runner.

    ``decode_buckets`` (``graphs.live_buckets``): the decode kernels plan
    their split, and the blocked prefill kernel its body, from a host-side
    bound on the live slots, which a capture freezes, so every step runs
    under the plan of its live length's bucket and the graphs are keyed by
    it; ``warmup`` captures every bucket's one-step graph and the prefill
    graphs it is asked for. A prefill writes the pad rows' k/v past the
    prompt (S_pad - S slots past the new offset); they are masked until a
    later step overwrites them, as a decode step's are.
    ``forwards`` counts the forwards made, prefill and decode (a replay counts
    the forwards its graph holds); ``graphs.capture_s`` the capture time."""

    def __init__(self, arch_name: str, cfg, params, batch_size: int = 1,
                 max_seq_len: Optional[int] = None, dtype=torch.bfloat16, device=None,
                 cache_impl: str = "classic", kv_dtype=None, fuse_qkv: bool = False):
        self.cache_impl = check_cache_impl(cache_impl)
        self.kv_dtype = kv.check_kv_dtype(kv_dtype or dtype)
        self.device = resolve_device(device)
        at.configure()   # the tuner's knobs, read once per runner
        self.arch = get_arch(arch_name)
        self.arch_name = arch_name
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_seq_len or cfg.max_seq_len
        check_positions(self.arch, params, self.max_len)
        self.dtype = dtype
        emb_dev = embed_weight(params).device
        if emb_dev.type != self.device.type:
            raise ValueError(f"params live on {emb_dev}, the runner on {self.device}")
        if fuse_qkv and hasattr(self.arch, "fuse_attention"):
            # load-time q/k/v concat: one packed weight stream and one kernel
            # launch a layer in place of three (the caller's params unchanged)
            self.params = params = self.arch.fuse_attention(params)
        self.decode_buckets = live_buckets(self.max_len)
        self.forwards = {"prefill": 0, "decode": 0}
        self.graphs = Graphs(self.device, counters=(self.forwards,))
        self._store: Optional[KVCache] = None   # the cache storage
        self._epoch = 0
        self._dev_off: Optional[int] = None      # the offset the device tensor holds
        self._bufs: dict = {}                    # the graphs' static inputs
        self._gen = torch.Generator(device=self.device)   # decode_sample_scan's draws

    # -- cache and static buffers -----------------------------------------------

    @torch.inference_mode()
    def init_cache(self) -> KVCache:
        """The runner's cache storage, zeroed, at offset 0; every earlier
        handle is stale from now on."""
        if self._store is None:
            # normal tensors (not inference tensors): updated in place anywhere
            with torch.inference_mode(False):
                shape = (self.batch, self.max_len, self.cfg.num_kv_heads, self.cfg.head_dim)
                layers = range(len(self.params["layers"]))
                self._store = KVCache(
                    [torch.zeros(shape, dtype=self.kv_dtype, device=self.device) for _ in layers],
                    [torch.zeros(shape, dtype=self.kv_dtype, device=self.device) for _ in layers],
                    0, torch.zeros(self.batch, dtype=torch.int32, device=self.device))
        else:
            for t in (*self._store.k, *self._store.v):
                t.zero_()
        self._store.offs.zero_()
        self._dev_off = 0
        self._epoch += 1
        return dataclasses.replace(self._store, epoch=self._epoch)

    def _use(self, cache: KVCache, b: int, s: int) -> None:
        """Check a handle before a step of ``s`` tokens for ``b`` rows."""
        if self._store is None or cache.epoch != self._epoch or cache.k is not self._store.k:
            raise ValueError("stale KV cache: this handle was made before the runner's latest "
                             "init_cache() (or by another runner); a runner holds one live "
                             "sequence at a time")
        if b != self.batch or cache.offset + s > self.max_len:
            raise ValueError(f"step of {b} rows x {s} tokens at offset {cache.offset} does not "
                             f"fit batch {self.batch}, max_len {self.max_len}")

    def _buf(self, name: str, shape, dtype) -> torch.Tensor:
        """A static input of the graphs, made once per (name, shape, dtype)."""
        key = (name, tuple(shape), dtype)
        t = self._bufs.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = self._bufs[key] = torch.zeros(shape, dtype=dtype, device=self.device)
        return t

    def _at(self, cache: KVCache) -> None:
        """Set the device offsets to the handle's."""
        if self._dev_off != cache.offset:
            self._store.offs.fill_(cache.offset)
            self._dev_off = cache.offset

    # -- steps ------------------------------------------------------------------

    @torch.inference_mode()
    def _step(self, ids: torch.Tensor, cache: KVCache):
        """The eager step: ids (B, S) at the handle's offset, through the
        graphs' bodies run eagerly under the same plan: a prefill (S > 1)
        through ``_prefill_body``, one token through ``_one_step``."""
        if ids.shape[1] > 1:
            return self._prefill(ids, cache, _call)
        self._use(cache, *ids.shape)
        ids = ids.to(self.device)
        self._at(cache)
        logits = self._one_step(ids, bucket_for(cache.offset + 1, self.decode_buckets))
        self._dev_off = cache.offset + 1
        return logits, dataclasses.replace(cache, offset=cache.offset + 1)

    def _prefill(self, ids: torch.Tensor, cache: KVCache, run):
        """ids (B, S) right-padded to S_pad (``prefill_len``) into the static
        id buffer, then ``run`` (the graphs' ``run``, or a plain call) of the
        prefill body keyed ("prefill", S_pad, bucket of offset + S_pad).
        Returns the logits of the S real rows and the handle advanced by S."""
        b, s = ids.shape
        self._use(cache, b, s)
        s_pad = prefill_len(s, self.max_len - cache.offset)
        bound = bucket_for(cache.offset + s_pad, self.decode_buckets)
        buf = self._buf("prefill", (b, s_pad), torch.long)
        buf[:, :s].copy_(ids)
        buf[:, s:].zero_()
        self._at(cache)
        logits = run(("prefill", s_pad, bound), lambda: self._prefill_body(buf, bound),
                     restore=[self._store.offs, *self._bufs.values()])
        # the body leaves the device offsets; the next step's ``_at`` moves them
        return logits[:, :s].clone(), dataclasses.replace(cache, offset=cache.offset + s)

    def _prefill_body(self, ids: torch.Tensor, bound: int) -> torch.Tensor:
        """The prefill graphs' body: ids (B, S_pad) at the device offsets
        (every row aligned), the cache written through ``update_kv_cache``'s
        tensor-offset path and attended by the blocked prefill kernel at the
        device offset, planned for ``bound`` (>= offset + S_pad). Returns the
        logits (B, S_pad, V)."""
        arch, cfg, store = self.arch, self.cfg, self._store
        off = store.offs[:1]
        positions = store.offs[:, None].long() + torch.arange(ids.shape[1], device=self.device)
        rope = arch.step_rope(cfg, positions, self.dtype)
        x = arch.embed(self.params, cfg, ids, positions).to(self.dtype)
        x, delta = arch.stack(self.params, cfg, x, positions, None,
                              lambda li: (store.k[li], store.v[li], off, None, bound), rope=rope)
        logits = arch.head(self.params, cfg, x, delta)
        self.forwards["prefill"] += 1
        return logits

    def _one_step(self, ids: torch.Tensor, max_live: int) -> torch.Tensor:
        """One decode step at the device offsets, the unit of every graph
        body: ids (B, 1) on the device; the cache write takes the per-row
        path of ``update_kv_cache`` and attention the ("rows", offsets,
        max_live) form, planned for ``max_live`` slots. Advances the offsets
        in place; returns the logits (B, 1, V)."""
        arch, cfg, store = self.arch, self.cfg, self._store
        offs = store.offs
        positions = offs[:, None].long()
        rope = arch.step_rope(cfg, positions, self.dtype)
        x = arch.embed(self.params, cfg, ids, positions).to(self.dtype)
        fold = ("fold",) if self.cache_impl == "fold" else ()
        x, delta = arch.stack(
            self.params, cfg, x, positions, None,
            lambda li: (*fold, store.k[li], store.v[li], offs, None, max_live), rope=rope)
        logits = arch.head(self.params, cfg, x, delta)
        offs.add_(1)
        self.forwards["decode"] += 1
        return logits

    def _pieces(self, off: int, steps: int) -> list[tuple[int, int]]:
        """(steps, bucket) of the graphs a scan of ``steps`` decode steps from
        offset ``off`` replays: cut where the live length (offset + 1) enters
        the next bucket, so that every step runs under its own bucket's plan,
        as ``decode`` and ``_step`` do; SCAN_PIECE steps a piece while they
        fit, then the largest power of two that fits, so that a bucket has at
        most log2(SCAN_PIECE) + 1 piece lengths to capture, whatever the
        prompt lengths."""
        out = []
        while steps > 0:
            bucket = bucket_for(off + 1, self.decode_buckets)
            room = min(steps, bucket - off)
            n = min(SCAN_PIECE, 1 << (room.bit_length() - 1))
            out.append((n, bucket))
            off, steps = off + n, steps - n
        return out

    def _replay(self, key, body, cache: KVCache, steps: int, generators=()):
        """``body`` (``steps`` decode steps from the handle's offset) as the
        graph of ``key``: on the card captured once, then replayed; on the
        CPU called. Returns (what the body returns, the advanced handle)."""
        self._use(cache, self.batch, steps)
        self._at(cache)
        self._dev_off = None   # unknown until the body has run
        restore = [self._store.offs, *self._bufs.values()]
        out = self.graphs.run(key, body, restore=restore, generators=generators)
        self._dev_off = cache.offset + steps
        return out, dataclasses.replace(cache, offset=cache.offset + steps)

    @torch.inference_mode()
    def prefill(self, ids: torch.Tensor, cache: KVCache):
        """ids: (B, S) prompt tokens. Returns (logits (B, S, V), cache). On
        the card it replays the graph of ("prefill", S_pad, bucket)."""
        return self._prefill(ids, cache, self.graphs.run)

    @torch.inference_mode()
    def decode(self, ids: torch.Tensor, cache: KVCache):
        """ids: (B, 1). One decode step: (logits (B, 1, V), cache). On the card
        it replays the one-step graph of the live length's bucket."""
        if tuple(ids.shape) != (self.batch, 1):
            raise ValueError(f"decode takes one token per row, got {tuple(ids.shape)}")
        tok = self._buf("tok", (self.batch, 1), torch.long)
        tok.copy_(ids)
        bucket = bucket_for(cache.offset + 1, self.decode_buckets)
        logits, cache = self._replay(("decode", bucket),
                                     lambda: self._one_step(tok, bucket), cache, 1)
        return logits.clone(), cache

    @torch.inference_mode()
    def decode_greedy_scan(self, ids: torch.Tensor, cache: KVCache, steps: int):
        """``steps`` greedy iterations from the first tokens ids (B, 1), the
        argmax inside the graphs: no host read until the caller's. Returns
        (tokens (B, steps) on the device, cache)."""
        tok = self._buf("tok", (self.batch, 1), torch.long)
        tok.copy_(ids)
        out = [torch.zeros((self.batch, 0), dtype=torch.long, device=self.device)]
        for n, bucket in self._pieces(cache.offset, steps):
            toks, cache = self._replay(("greedy", n, bucket),
                                       lambda n=n, b=bucket: self._greedy_body(tok, n, b),
                                       cache, n)
            out.append(toks.clone())
        return torch.cat(out, dim=1), cache

    def _greedy_body(self, tok, n: int, bucket: int) -> torch.Tensor:
        cur, out = tok, []
        for _ in range(n):
            cur = self._one_step(cur, bucket)[:, -1].float().argmax(-1, keepdim=True)
            out.append(cur)
        tok.copy_(cur)   # the next piece's first token
        return torch.cat(out, dim=1)

    @torch.inference_mode()
    def decode_sample_scan(self, last_logits: torch.Tensor, cache: KVCache, steps: int,
                           generator: torch.Generator, temperature, top_p, top_k: int = 0,
                           eos_id: Optional[int] = None, min_left: int = 0):
        """``steps`` sample+decode iterations with the sampling inside the
        graphs (the span analogue of the serving engine's spans, for one
        request's generation).

        last_logits: (B, V) logits to sample the FIRST token from (the
        prefill's tail or the previous span's). temperature / top_p: floats
        or per-row host arrays; the sampling fast path follows from them
        (``sample_mode``), and the graphs are keyed like the TPU package's
        programs, ("sample", steps, top_k, eos?, mode), plus the bucket.
        min_left: EOS cannot be SAMPLED in the first ``min_left`` steps.
        generator: advanced as if every draw were taken from it (the graphs
        draw from the runner's own generator, given its state first and
        handing it back after). Returns (tokens (B, steps), last_logits (B,
        V), cache)."""
        b, vocab = last_logits.shape
        mode = sample_mode(temperature, top_p, top_k)
        last = self._buf("last", (b, vocab), last_logits.dtype)
        last.copy_(last_logits)
        temp = self._buf("temperature", (b,), torch.float32)
        temp.copy_(torch.as_tensor(temperature, dtype=torch.float32).reshape(-1).expand(b))
        top = self._buf("top_p", (b,), torch.float32)
        top.copy_(torch.as_tensor(top_p, dtype=torch.float32).reshape(-1).expand(b))
        left = self._buf("min_left", (), torch.long)
        left.fill_(min_left)
        eos = self._buf("eos", (), torch.long)
        eos.fill_(-1 if eos_id is None else eos_id)
        self._gen.set_state(generator.get_state())
        out = [torch.zeros((b, 0), dtype=torch.long, device=self.device)]
        for n, bucket in self._pieces(cache.offset, steps):
            key = ("sample", n, int(top_k), eos_id is not None, mode, bucket, last.dtype)

            def body(n=n, bucket=bucket):
                return self._sample_body(last, n, bucket, int(top_k), eos_id is not None, mode,
                                         temp, top, left, eos)

            toks, cache = self._replay(key, body, cache, n, generators=(self._gen,))
            out.append(toks.clone())
            left.sub_(n)
        generator.set_state(self._gen.get_state())
        return torch.cat(out, dim=1), last.clone(), cache

    def _sample_body(self, last, n, bucket, top_k, has_eos, mode, temp, top, left, eos):
        cur, out = last, []
        vocab = torch.arange(last.shape[-1], device=last.device)
        for i in range(n):
            lg = cur.float()
            if has_eos:
                lg = lg.masked_fill((vocab == eos) & (left > i), float("-inf"))
            tok = sample_logits(lg, self._gen, temp, top, top_k, mode=mode)
            out.append(tok)
            cur = self._one_step(tok[:, None], bucket)[:, -1]
        last.copy_(cur)   # the next piece's, and the caller's, last logits
        return torch.stack(out, dim=1)

    @torch.inference_mode()
    def forced_decode_scan(self, ids: torch.Tensor, cache: KVCache):
        """Teacher-forced decode: ids (B, S) fed one token per step, inside the
        graphs. Returns (last logits (B, 1, V), cache): the cache and logits
        of a prefill of ids."""
        b, s = ids.shape
        if s < 1:
            raise ValueError("forced_decode_scan takes at least one token per row")
        logits, start = None, 0
        for n, bucket in self._pieces(cache.offset, s):
            buf = self._buf("forced", (b, n), torch.long)
            buf.copy_(ids[:, start:start + n])
            logits, cache = self._replay(("forced", n, bucket),
                                         lambda buf=buf, n=n, b=bucket: self._forced_body(buf, n, b),
                                         cache, n)
            start += n
        return logits.clone(), cache

    def _forced_body(self, buf, n: int, bucket: int) -> torch.Tensor:
        for j in range(n):
            logits = self._one_step(buf[:, j:j + 1], bucket)
        return logits

    def warmup(self, prefill_buckets=(16,), autotune: bool = True) -> None:
        """Make the prefill graph of each given prompt length at offset 0 (a
        prefill on a scratch cache) and every live-length bucket's one-step
        decode graph, so that no capture falls inside a timed loop. Every
        cache handle is stale after it: call ``init_cache()``.

        ``autotune``: first race the plans of kernels 1 and 2 for every
        distinct packed shape (``ops/cuda/autotune.py``) at the batch's rows
        and at each prefill's padded rows, before any capture freezes a plan
        (the TPU package's ``warmup(autotune=True)``; its floor of 8 rows is
        a TPU tiling and is not kept). Nothing on the CPU, and nothing for a
        shape the cache holds."""
        if autotune:
            at.ensure(self.params, self.cfg.act,
                      [self.batch, *(self.batch * prefill_len(s, self.max_len)
                                     for s in prefill_buckets)])
        for s in prefill_buckets:
            ids = torch.zeros((self.batch, s), dtype=torch.long, device=self.device)
            self.prefill(ids, self.init_cache())
        cache = self.init_cache()
        ids = torch.zeros((self.batch, 1), dtype=torch.long, device=self.device)
        if not self.graphs.on_card:
            self.decode(ids, cache)
            return
        tok = self._buf("tok", (self.batch, 1), torch.long)
        tok.copy_(ids)
        with torch.inference_mode():
            for bucket in self.decode_buckets:
                if ("decode", bucket) not in self.graphs:
                    self.graphs.capture(("decode", bucket),
                                        lambda b=bucket: self._one_step(tok, b),
                                        restore=[self._store.offs, *self._bufs.values()])
        _sync(self.device)



def _call(key, body, restore=(), generators=()):
    """``Graphs.run``'s signature, calling the body: a step run eagerly."""
    return body()


def check_cache_impl(cache_impl: str) -> str:
    """The dense decode step's form: "classic" or "fold"."""
    if cache_impl not in ("classic", "fold"):
        raise ValueError(f"cache_impl must be 'classic' or 'fold', got {cache_impl!r}")
    return cache_impl


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_logits(logits: torch.Tensor, generator: torch.Generator, temperature=0.8,
                  top_p=0.95, top_k: int = 0, mode: Optional[str] = None) -> torch.Tensor:
    """Temperature + nucleus (top-p) + optional top-k sampling; (B, V) -> (B,).

    temperature/top_p are floats or per-row (B,) tensors; rows with
    temperature 0 take the argmax. All-greedy python floats skip the sort.

    mode is a host-side promise that skips the full-vocab sort, legal only
    when the host KNOWS the params satisfy it:
      "greedy"      every row it cares about has temperature == 0: argmax.
      "categorical" top_k == 0 and every top_p >= 1: no tail filtering, a
                    temperature-scaled categorical draw (rows with
                    temperature 0 still take the argmax).
      None          the general sort + top-k / top-p filter path."""
    if mode not in (None, "greedy", "categorical"):
        raise ValueError(f"mode must be None, 'greedy' or 'categorical', got {mode!r}")
    logits = logits.float()
    b = logits.shape[0]
    greedy = logits.argmax(-1)
    if mode == "greedy" or (not isinstance(temperature, torch.Tensor) and temperature == 0):
        return greedy
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device).reshape(-1).expand(b)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device).reshape(-1).expand(b)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if mode == "categorical":
        if top_k:
            raise ValueError("mode='categorical' requires top_k == 0")
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
        return torch.where(temperature == 0, greedy, sampled)
    sorted_logits = scaled.sort(dim=-1, descending=True).values
    if top_k and top_k > 0:
        kth = sorted_logits[:, top_k - 1:top_k]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        sorted_logits[:, top_k:] = float("-inf")
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
    cutoff_idx = (cum < top_p[:, None]).sum(-1, keepdim=True).clamp_max(scaled.shape[-1] - 1)
    cutoff = sorted_logits.gather(-1, cutoff_idx)
    filtered = scaled.masked_fill(scaled < cutoff, float("-inf"))
    sampled = torch.multinomial(torch.softmax(filtered, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temperature == 0, greedy, sampled)


def sample_mode(temperature, top_p, top_k: int = 0) -> Optional[str]:
    """``sample_logits``' fast path for host-side sampling params (floats or
    per-row arrays): "greedy" when every temperature is 0, "categorical"
    when top_k is 0 and every top_p >= 1, else None (the sort)."""
    t = torch.as_tensor(temperature).cpu().numpy()
    p = torch.as_tensor(top_p).cpu().numpy()
    return "greedy" if (t == 0).all() else \
        "categorical" if top_k == 0 and (p >= 1).all() else None


@torch.inference_mode()
def generate(runner: ModelRunner, prompt_ids, max_new_tokens: int, temperature: float = 0.8,
             top_p: float = 0.95, top_k: int = 0, min_new_tokens: int = 0,
             eos_token_id: Optional[int] = None, seed: int = 0, stream=None,
             span: int = 32) -> np.ndarray:
    """Autoregressive generation. prompt_ids: (B, S) or (S,) ints. Returns
    (B, S + new) token ids as numpy.

    With ``span`` > 1 a runner that has ``decode_sample_scan`` decodes in
    spans of up to ``span`` through it (sampling inside the graphs, one host
    read a span); EOS is handled on the host between spans, the span
    truncated where every row is done, so the result is token-identical to
    ``span=1``, the per-token loop (one ``decode`` graph a token; the host
    waits on the device per token only for EOS bookkeeping or a ``stream``
    callback). A runner without it (``runtime/offload.OffloadRunner``, whose
    layer streaming the host drives) takes the per-token loop whatever
    ``span`` says, as in the TPU package."""
    ids = np.atleast_2d(np.asarray(prompt_ids, dtype=np.int64))
    b, s = ids.shape
    if b != runner.batch or s + max_new_tokens > runner.max_len:
        raise ValueError(f"prompt {ids.shape} + {max_new_tokens} new tokens does not fit "
                         f"batch {runner.batch}, max_len {runner.max_len}")
    gen = torch.Generator(device=runner.device)
    gen.manual_seed(seed)
    logits, cache = runner.prefill(torch.as_tensor(ids, device=runner.device),
                                   runner.init_cache())
    last = logits[:, -1]
    mode = sample_mode(temperature, top_p, top_k)
    out = [ids]
    if span > 1 and hasattr(runner, "decode_sample_scan"):
        done = np.zeros(b, bool)
        produced = 0
        while produced < max_new_tokens and not done.all():
            n = min(span, max_new_tokens - produced)
            toks, last, cache = runner.decode_sample_scan(
                last, cache, n, gen, temperature, top_p, top_k, eos_id=eos_token_id,
                min_left=max(0, min_new_tokens - produced))
            toks = toks.cpu().numpy()
            keep = n
            for j in range(n):   # the per-token loop's bookkeeping, column by column
                if eos_token_id is not None and produced + j >= min_new_tokens:
                    done |= toks[:, j] == eos_token_id
                if stream is not None:
                    stream(toks[:, j])
                if done.all():
                    keep = j + 1
                    break
            out.append(toks[:, :keep])
            produced += keep
        return np.concatenate(out, axis=1)
    done = torch.zeros(b, dtype=torch.bool, device=runner.device)
    toks = []
    for step in range(max_new_tokens):
        if eos_token_id is not None and step < min_new_tokens:
            # EOS cannot be sampled before the minimum length
            last = last.clone()
            last[:, eos_token_id] = float("-inf")
        nxt = sample_logits(last, gen, temperature, top_p, top_k, mode=mode)
        toks.append(nxt)
        if stream is not None:
            stream(nxt.cpu().numpy())
        if eos_token_id is not None and step >= min_new_tokens:
            done |= nxt == eos_token_id
            if bool(done.all()):
                break
        if step + 1 < max_new_tokens:
            logits, cache = runner.decode(nxt[:, None], cache)
            last = logits[:, -1]
    if toks:
        out.append(torch.stack(toks, dim=1).cpu().numpy())
    return np.concatenate(out, axis=1)


# ---------------------------------------------------------------------------
# decode benchmark
# ---------------------------------------------------------------------------

@torch.inference_mode()
def benchmark_decode(runner: ModelRunner, input_ids, check: bool = False, log=print) -> dict:
    """Feed input_ids one token at a time through the decode step (on the
    card its graph: ``warmup`` makes every bucket's before the timed loop, as
    the TPU package compiles its step first); report the median per-token
    latency (host clock around a synchronized step),
    tokens/s, peak device memory (``torch.cuda.max_memory_allocated``; None
    on the CPU), the cache's storage dtype and bytes and, with ``check``, the
    next-token perplexity."""
    ids = np.atleast_2d(np.asarray(input_ids, dtype=np.int64))
    b, n = ids.shape
    runner.warmup(prefill_buckets=())
    cuda = runner.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(runner.device)
    cache = runner.init_cache()
    tok_all = torch.as_tensor(ids, device=runner.device)
    times, nll = [], 0.0
    for i in range(n):
        _sync(runner.device)
        t0 = time.perf_counter()
        logits, cache = runner.decode(tok_all[:, i:i + 1], cache)
        _sync(runner.device)
        times.append(time.perf_counter() - t0)
        if check and i + 1 < n:
            lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            nll -= float(lp[torch.arange(b), tok_all[:, i + 1]].mean())
        if (i + 1) % 256 == 0:
            log(f"  benchmark {i + 1}/{n} median {np.median(times) * 1e3:.2f} ms")
    med = float(np.median(times))
    result = {
        "device": torch.cuda.get_device_name(runner.device) if cuda else "cpu",
        "tokens": n,
        "median_latency_s": med,
        "tokens_per_s": b / med,
        "max_memory_bytes": torch.cuda.max_memory_allocated(runner.device) if cuda else None,
        "kv_dtype": str(runner.kv_dtype).replace("torch.", ""),
        "kv_bytes": kv.cache_bytes((*cache.k, *cache.v)),
    }
    if check and n > 1:
        result["ppl"] = float(np.exp(nll / (n - 1)))
    return result
