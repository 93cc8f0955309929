"""Continuous-batching serving engine.

Counterpart of ``gptq_for_llama_tpu/runtime/serve.py``. Decode throughput
comes from keeping the weight-bandwidth-bound decode step busy with many
sequences:

- a fixed pool of B cache slots over one static per-layer (B, max_len, Hkv, D)
  KV cache, or (paged) one shared per-layer block pool; every slot has its
  OWN offset;
- ONE decode step advances all live slots per iteration (``write_mask`` keeps
  retired and mid-prefill slots from clobbering their rows);
- arrivals are prefilled into free slots, right-padded to a length bucket
  (padded cache slots are masked until the real token at that position
  overwrites them before its first read), several same-bucket arrivals in one
  batched forward, or (``prefill_chunk``) one fixed-size chunk per iteration,
  fused with the decode step into one forward over a flat (1, B + C) token row;
- finished sequences (eos / max_new) free their slot at once and the scheduler
  backfills from the queue.

The TPU package compiles its steps; here every step is a CUDA graph
(``runtime/graphs.py``), replayed on the card, keyed as the TPU package's
programs are: a decode span (``decode_span`` decode+sample steps, ONE host
read at the end; a single decode step is a span of 1) by (span, sampling
mode, live-length bucket), a slot's bucketed prefill by ("prefill", blen), a
batched admission by ("admit", blen), a prompt chunk by ("chunk", bucket) and
the fused chunk+decode step by ("chunk+decode", bucket), one bucket holding
the chunk's end and every decode row's offset + 1. The CPU runs the same
bodies eagerly. Everything a graph reads or writes is allocated once per
engine (``state``: the caches, the block tables, the per-row offsets, the
span's tokens, live mask and sampling parameters, and the prefill inputs:
token ids, the slot, its chunk offset and last-token index, the admit mask
and the prompt lengths), and the host loads its own copies into it before
each replay (``_load``, ``_load_slot``): a graph holds no host value but its
key. The host copy of the offsets schedules, bounds the kernels' plans (the
graph's bucket) and checks that a chunk fits its slot before the replay
(``_check_fits``: on the card a write past the slot cannot be seen). After
a prefill the first token is sampled outside the graph. ``forwards`` counts
the forwards of each kind that ``run`` has made (a replay counts those its
graph holds).
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
from .runner import check_cache_impl, sample_logits, sample_mode


@dataclasses.dataclass
class GenRequest:
    uid: int
    prompt: np.ndarray            # (S,) ints
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[GenRequest] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = True
    # chunked-prefill progress (prefill_chunk mode)
    pending: Optional[np.ndarray] = None   # chunk-padded prompt still to feed
    ppos: int = 0                          # next chunk start
    plen: int = 0                          # true prompt length


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class ServingEngine:
    def __init__(self, arch_name: str, cfg, params, batch_slots: int = 8,
                 max_seq_len: Optional[int] = None, dtype=torch.bfloat16,
                 prefill_buckets=(32, 128, 512), paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: Optional[int] = None,
                 decode_span: int = 1, fused_chunk_decode: bool = True,
                 admit_batch_max: int = 128, mesh=None, shard_map_tp: bool = False,
                 fuse_qkv: bool = False, kv_dtype=None, device=None, seed: int = 0,
                 cache_impl: str = "classic"):
        if mesh is not None or shard_map_tp:
            raise NotImplementedError("tensor-parallel serving (A18) is not yet ported to "
                                      "gptq_for_llama_tpu_torch (see ROADMAP)")
        self.device = resolve_device(device)
        emb_dev = embed_weight(params).device
        if emb_dev.type != self.device.type:
            raise ValueError(f"params live on {emb_dev}, the engine on {self.device}")
        self.arch = get_arch(arch_name)
        if fuse_qkv and hasattr(self.arch, "fuse_attention"):
            # load-time q/k/v concat (the caller's params unchanged)
            params = self.arch.fuse_attention(params)
        self.arch_name = arch_name
        self.cfg = cfg
        self.params = params
        self.num_layers = len(params["layers"])
        self.dtype = dtype
        # the caches' and pools' storage dtype (ops/kv_dtype.py); compute stays
        # in ``dtype``
        self.kv_dtype = kv.check_kv_dtype(kv_dtype or dtype)
        self.b = batch_slots
        self.max_len = max_seq_len or cfg.max_seq_len
        check_positions(self.arch, params, self.max_len)
        self.buckets = tuple(b for b in prefill_buckets if b <= self.max_len)
        # implicit final bucket: a prompt longer than every configured bucket
        # but within the cache must still be servable
        if not self.buckets or self.buckets[-1] < self.max_len:
            self.buckets = self.buckets + (self.max_len,)
        # paged mode: slots share a block pool sized by actual tokens instead
        # of slots * max_len (runtime/paged.py); prompts always start at a
        # block boundary (offset 0), so prefill writes whole blocks
        self.paged = paged
        self.block_size = block_size
        # chunked prefill: at most ONE fixed-size prompt chunk per engine
        # iteration, so decode stalls are bounded by a chunk, not a prompt
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None and paged and prefill_chunk % block_size:
            raise ValueError("prefill_chunk must be a multiple of block_size in paged mode")
        # cache capacity must cover chunk-padded prompt writes
        cap = self.max_len if prefill_chunk is None else \
            -(-self.max_len // prefill_chunk) * prefill_chunk
        self.max_blocks = -(-cap // block_size)
        self.num_blocks = num_blocks or batch_slots * self.max_blocks
        self.logical_len = self.max_blocks * block_size
        if prefill_chunk is not None and not paged:
            self.max_len = cap  # dense cache rows must fit padded writes
        # decode span: `decode_span` decode+sample steps queued on the card per
        # host read. Sequences may overshoot eos/max_new by up to span-1 tokens
        # on the device; the host trims them (same results as span=1).
        self.decode_span = max(1, int(decode_span))
        # chunked prefill + decode in ONE forward: the pending slot's next
        # chunk and a decode token for every live slot share each weight read
        self.fused_chunk_decode = bool(fused_chunk_decode)
        # batched admission: same-bucket admissions share one prefill forward
        # up to this bucket size (beyond it the forward's B * bucket rows,
        # most of them padding or write-masked, outweigh the saved forwards)
        self.admit_batch_max = int(admit_batch_max)
        # "fold": every dense decode step (single steps and spans) attends the
        # stale cache with the current k/v folded in, then writes the live
        # rows (ModelRunner's cache_impl); prefills, the fused chunk+decode
        # step and paged mode keep their forms
        self.cache_impl = check_cache_impl(cache_impl)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: list[GenRequest] = []
        self.results: dict[int, np.ndarray] = {}
        # per-request wall-clock metrics: submit -> first token -> done
        self._meta: dict[int, dict] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.forwards = {"decode": 0, "prefill": 0, "admit": 0, "chunk": 0, "chunk+decode": 0}
        self.steps = 0      # engine iterations of the last run
        self.state = None   # caches, tables, offsets and span inputs, made by the first run
        # the decode spans' graphs, keyed by (span, mode, bucket), the bucket
        # holding every row's offset + 1 at the span's end
        self.decode_buckets = live_buckets(self._kv_len())
        self.graphs = Graphs(self.device, counters=(self.forwards,))
        # the measured race of kernels 1 and 2 at the decode step's rows, and
        # at the fused chunk+decode step's, before any capture freezes a plan
        # (the TPU package's engine does the same at serve.py:154-166; nothing
        # on the CPU or for a shape the cache holds)
        at.configure()
        at.ensure(self.params, cfg.act,
                  [self.b] + ([self.b + prefill_chunk]
                              if prefill_chunk is not None and self.fused_chunk_decode else []))

    # -- model steps -----------------------------------------------------------

    def _kv_len(self) -> int:
        return self.logical_len if self.paged else self.max_len

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _forward(self, ids, positions, past):
        """Embed, run every layer with its cache form ``past(li)``, and return
        the last layer's (x, delta), each (B, S, hidden): the hidden states are
        x + delta, added in the final norm's launch (``arch.head``); the
        caches are written in place."""
        arch, cfg = self.arch, self.cfg
        rope = arch.step_rope(cfg, positions, self.dtype)
        x = arch.embed(self.params, cfg, ids, positions).to(self.dtype)
        return arch.stack(self.params, cfg, x, positions, None, past, rope=rope)

    def _load(self, state) -> None:
        """The host's offsets, live mask, tokens and sampling parameters into
        the device buffers a decode forward reads (in place: a graph holds
        their addresses)."""
        for name, host in (("off", "host_off"), ("live_t", "live"), ("toks_t", "toks"),
                           ("temps_t", "temps"), ("tops_t", "tops")):
            dst = state[name]
            dst.copy_(torch.from_numpy(state[host]).reshape(dst.shape))

    def _decode_step(self, state, toks, live, max_live):
        """toks (B, 1); live (B,) bool. One token for every slot: returns the
        logits (B, V) and advances the live rows' device offsets in place.
        ``max_live``: the decode kernels' plan bound (every row's offset + 1)."""
        off, tables, k, v = state["off"], state["tables"], state["k"], state["v"]

        def past(li):
            # write-mask: the step decodes EVERY slot; non-live slots (retired,
            # or mid-chunked-prefill) must not clobber their cache rows
            if tables is None:
                fold = ("fold",) if self.cache_impl == "fold" else ()
                return (*fold, k[li], v[li], off, live, max_live)
            return ("paged", k[li], v[li], tables, off, live, max_live)

        x, delta = self._forward(toks, off[:, None].long(), past)
        off.add_(live.to(off.dtype))
        self.forwards["decode"] += 1
        return self.arch.head(self.params, self.cfg, x, delta)[:, -1]

    def _decode_span(self, state, span: int, mode) -> np.ndarray:
        """``span`` decode+sample steps, one host read at the end: (B, span)
        tokens. Dead slots repeat their token. On the card the graph of
        (span, mode, bucket) replays, the bucket holding every row's offset +
        1 at the span's end."""
        self._load(state)
        bucket = self._span_bucket(state, span)
        toks = self.graphs.run((span, mode, bucket),
                               lambda: self._decode_body(state, span, mode, bucket),
                               restore=[state["off"]], generators=(self._gen,))
        return toks.cpu().numpy()

    def _span_bucket(self, state, span: int) -> int:
        return bucket_for(int(state["host_off"].max()) + span, self.decode_buckets)

    def _decode_body(self, state, span: int, mode, max_live: int) -> torch.Tensor:
        """The decode span's body, over the loaded device buffers: returns the
        (B, span) tokens."""
        toks, live = state["toks_t"], state["live_t"]
        out = []
        for _ in range(span):
            logits = self._decode_step(state, toks, live, max_live)
            nxt = sample_logits(logits, self._gen, state["temps_t"], state["tops_t"], mode=mode)
            toks = torch.where(live, nxt, toks[:, 0])[:, None]
            out.append(toks)
        return torch.cat(out, dim=1)

    def _load_slot(self, state, i: int, ids: np.ndarray, off0: int, last_idx: int) -> None:
        """One slot's prompt (chunk) into the device buffers a prefill, chunk
        or chunk+decode forward reads: the ids into row 0 of ``ids_t``, then
        slot, chunk offset and last-token index in one copy."""
        state["ids_t"][0, :len(ids)].copy_(torch.from_numpy(np.asarray(ids, np.int64)))
        state["slot_meta"].copy_(torch.tensor([i, off0, last_idx], dtype=torch.int32))

    def _check_fits(self, i: int, off0: int, n: int) -> None:
        """Refuse, on the host and before any replay, a write of ``n`` tokens at
        ``off0`` that would run past slot ``i``'s cache row or its owned
        blocks: on the card the write's columns are device values and a
        paged write past the table would be clamped to its last block."""
        if self.paged:
            need = -(-(off0 + n) // self.block_size)
            have = len(self._paged_alloc.owned.get(i, ()))
            if need > have:
                raise ValueError(f"slot {i}: {n} tokens at {off0} need {need} blocks, the slot "
                                 f"owns {have}")
        elif off0 + n > self.max_len:
            raise ValueError(f"slot {i}: {n} tokens at {off0} run past the {self.max_len}-row "
                             f"cache")

    def _slot_meta(self, state):
        meta = state["slot_meta"]
        return meta[0:1], meta[1:2], meta[2:3]   # slot, chunk offset, last-token index

    def _prefill_slot(self, state, i: int, ids: np.ndarray, off0: int, last_idx: int, kind: str):
        """One slot's (right-padded) prompt or prompt chunk ``ids`` (blen,) at
        cache position ``off0``: writes the slot's cache and returns the
        logits (1, V) of token ``last_idx``. On the card the graph of
        ("prefill", blen) (a bucketed prompt at offset 0) or ("chunk",
        bucket of off0 + blen) replays."""
        blen = len(ids)
        self._check_fits(i, off0, blen)
        self._load_slot(state, i, ids, off0, last_idx)
        bound = bucket_for(off0 + blen, self.decode_buckets)
        key = ("prefill", blen) if kind == "prefill" else ("chunk", bound)
        logits = self.graphs.run(key, lambda: self._slot_body(state, blen, bound, kind))
        return logits.clone()

    def _slot_body(self, state, blen: int, bound: int, kind: str) -> torch.Tensor:
        """The prefill and chunk graphs' body: row 0 of ``ids_t`` (blen
        tokens) of the loaded slot at its loaded chunk offset, as the
        "grouped" cache forms without decode rows (kernel 4 at the device
        offset under ``bound``); returns the logits (1, V) of the loaded
        last-token index."""
        slot, off0, last = self._slot_meta(state)
        tables, k, v = state["tables"], state["k"], state["v"]
        positions = (off0.long() + torch.arange(blen, device=self.device))[None]

        def past(li):
            if tables is None:
                return ("grouped", k[li], v[li], None, None, slot, off0, 0, bound)
            return ("grouped_paged", k[li], v[li], tables, None, None, slot, off0, 0, bound)

        x, delta = self._forward(state["ids_t"][:1, :blen], positions, past)
        self.forwards[kind] += 1
        return self.arch.head(self.params, self.cfg, x.index_select(1, last),
                              None if delta is None else delta.index_select(1, last))[:, 0]

    def _chunk_decode_step(self, state, i: int, ids: np.ndarray, off0: int, last_idx: int):
        """One forward: the next prompt chunk of slot ``i`` + one decode token
        for all live slots, as ONE flat (1, B + C) token row, so every packed
        weight is read once for both groups. On the card the graph of
        ("chunk+decode", bucket) replays, the bucket holding off0 + C and
        every row's offset + 1. Returns (decode logits (B, V), chunk-last
        logits (1, V))."""
        c = len(ids)
        self._check_fits(i, off0, c)
        self._load(state)
        self._load_slot(state, i, ids, off0, last_idx)
        bound = bucket_for(max(off0 + c, int(state["host_off"].max()) + 1), self.decode_buckets)
        logits = self.graphs.run(("chunk+decode", bound),
                                 lambda: self._chunk_decode_body(state, c, bound),
                                 restore=[state["off"]])
        return logits[:self.b], logits[self.b:].clone()

    def _chunk_decode_body(self, state, c: int, bound: int) -> torch.Tensor:
        """The chunk+decode graphs' body over the loaded buffers: the
        "grouped" cache forms under the one bound, the decode rows' offsets
        advanced in place; returns the logits (B + 1, V) of the decode rows
        and the chunk's last token."""
        b_dec = self.b
        slot, off0, last = self._slot_meta(state)
        off, live, tables = state["off"], state["live_t"], state["tables"]
        k, v = state["k"], state["v"]
        ids_flat = torch.cat([state["toks_t"][:, 0], state["ids_t"][0, :c]])[None]
        positions = torch.cat([off.long(),
                               off0.long() + torch.arange(c, device=self.device)])[None]

        def past(li):
            if tables is None:
                return ("grouped", k[li], v[li], off, live, slot, off0, b_dec, bound)
            return ("grouped_paged", k[li], v[li], tables, off, live, slot, off0, b_dec, bound)

        x, delta = self._forward(ids_flat, positions, past)
        # the decode rows and the chunk's last row
        rows = torch.cat([torch.arange(b_dec, device=self.device), b_dec + last.long()])
        logits = self.arch.head(self.params, self.cfg, x.index_select(1, rows),
                                None if delta is None else delta.index_select(1, rows))[0]
        off.add_(live.to(off.dtype))
        self.forwards["chunk+decode"] += 1
        return logits

    def _pick_pending(self):
        """Next pending chunk: (i, slot, ids, off0, last_idx)."""
        for i, slot in enumerate(self.slots):
            if slot.pending is None:
                continue
            c = self.prefill_chunk
            ids = slot.pending[slot.ppos:slot.ppos + c]
            last_idx = max(0, min(slot.plen - 1 - slot.ppos, c - 1))
            return i, slot, ids, slot.ppos, last_idx
        return None

    def _sample_one(self, req, logits) -> int:
        return int(sample_logits(logits, self._gen, req.temperature, req.top_p,
                                 mode=sample_mode(req.temperature, req.top_p))[0])

    def _finish_chunk(self, state, i, slot, last):
        """Book-keeping after a chunk ran (activates the slot when done)."""
        slot.ppos += self.prefill_chunk
        if slot.ppos >= len(slot.pending):  # prompt complete: activate
            slot.pending = None
            self._finish_admit(state, i, slot, slot.req, slot.plen,
                               self._sample_one(slot.req, last))

    def _prefill_tick(self, state) -> bool:
        """Advance ONE pending slot by one chunk; True if a chunk ran."""
        picked = self._pick_pending()
        if picked is None:
            return False
        i, slot, ids, off0, last_idx = picked
        last = self._prefill_slot(state, i, ids, off0, last_idx, "chunk")
        self._finish_chunk(state, i, slot, last)
        return True

    # -- scheduler -------------------------------------------------------------

    def _blocks_needed(self, plen: int, max_new: int) -> int:
        """Blocks a paged request can touch: its (bucket- or chunk-padded)
        prompt writes, or prompt + new tokens + span slack. Span slack: a
        slot retiring mid-span keeps decoding on the card with the stale live
        mask for up to span-1 steps; those overshoot writes must land in
        blocks this slot OWNS (or the scratch block), never in filler-aliased
        blocks of another slot."""
        if self.prefill_chunk is not None:
            blen = -(-plen // self.prefill_chunk) * self.prefill_chunk
        else:
            blen = _bucket(plen, self.buckets)
        tokens = min(max(blen, plen + max_new + self.decode_span - 1), self.logical_len)
        return -(-tokens // self.block_size)

    def submit(self, req: GenRequest):
        """Queue a request; rejects up front what could never be served
        (instead of raising mid-run and losing in-flight sequences, or
        spinning forever on an impossible paged allocation)."""
        plen = len(np.asarray(req.prompt).reshape(-1))
        cap = self.logical_len if self.paged else self.max_len
        if plen + 1 > cap:
            raise ValueError(f"prompt length {plen} leaves no room to generate in a "
                             f"{cap}-row cache (max_seq_len={self.max_len})")
        if self.paged:
            need = self._blocks_needed(plen, req.max_new_tokens)
            if need > self.num_blocks:
                raise ValueError(f"request needs {need} KV blocks but the pool has "
                                 f"{self.num_blocks}; raise num_blocks or lower "
                                 f"max_new_tokens/decode_span")
        self._meta[req.uid] = {"submit": time.perf_counter()}
        self.queue.append(req)

    def _activate(self, slot, req, tok: int) -> bool:
        """Bookkeeping for the prefill-sampled FIRST token. Returns False
        when the request is already complete (eos on the first token, or
        max_new_tokens == 1): the slot retires without ever entering the
        decode batch, matching runner.generate semantics."""
        slot.generated = [tok]
        m = self._meta.get(req.uid)
        if m is not None and "first" not in m:
            m["first"] = time.perf_counter()
        ended = req.eos_token_id is not None and tok == req.eos_token_id
        if ended or req.max_new_tokens <= 1:
            self.results[req.uid] = np.asarray([tok], np.int32)
            self._meta[req.uid]["done"] = time.perf_counter()
            slot.done = True
            return False
        slot.done = False
        return True

    def kv_bytes(self) -> int:
        """Bytes of the engine's caches or pools (0 before its first run)."""
        return 0 if self.state is None else kv.cache_bytes((*self.state["k"],
                                                            *self.state["v"]))

    def stats(self) -> dict:
        """Aggregate per-request wall-clock metrics over completed requests:
        time-to-first-token and end-to-end latency (p50/p95, seconds), and the
        KV storage dtype and bytes."""
        done = [m for m in self._meta.values() if "done" in m]
        if not done:
            return {}
        ttft = np.asarray([m["first"] - m["submit"] for m in done if "first" in m])
        lat = np.asarray([m["done"] - m["submit"] for m in done])

        def pct(a, p):
            return round(float(np.percentile(a, p)), 4) if a.size else None

        return {"completed": len(done),
                "ttft_p50_s": pct(ttft, 50), "ttft_p95_s": pct(ttft, 95),
                "latency_p50_s": pct(lat, 50), "latency_p95_s": pct(lat, 95),
                "kv_dtype": str(self.kv_dtype).replace("torch.", ""),
                "kv_bytes": self.kv_bytes()}

    def _admit(self, state):
        """Fill free slots from the queue. Admissions that share a prefill
        bucket run as ONE batched forward (``_admit_batched``)."""
        picks = []
        for i, slot in enumerate(self.slots):
            if not slot.done or not self.queue:
                continue
            # paged: allocate only the blocks this request can actually touch
            if self.paged:
                peek = self.queue[0]
                need = self._blocks_needed(len(np.asarray(peek.prompt).reshape(-1)),
                                           peek.max_new_tokens)
                try:
                    self._paged_alloc.release(i)
                    self._paged_alloc.ensure_capacity(i, need * self.block_size,
                                                      self.block_size)
                except MemoryError:
                    continue  # pool full: request waits for a retirement
                owned = self._paged_alloc.owned[i]
                self._tables_np[i, :] = 0
                self._tables_np[i, :len(owned)] = owned
                state["tables"].copy_(torch.from_numpy(self._tables_np))
            req = self.queue.pop(0)
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            if self.prefill_chunk is not None:
                # chunked mode: stage the prompt; one chunk is fed per engine
                # iteration while other slots keep decoding
                c = self.prefill_chunk
                pending = np.zeros((-(-len(prompt) // c) * c,), np.int64)
                pending[:len(prompt)] = prompt
                slot.req = req
                slot.pending = pending
                slot.ppos = 0
                slot.plen = len(prompt)
                slot.generated = []
                slot.done = False
                continue
            picks.append((i, req, prompt))
        groups: dict[int, list] = {}
        for pick in picks:
            groups.setdefault(_bucket(len(pick[2]), self.buckets), []).append(pick)
        for blen in sorted(groups):
            group = groups[blen]
            if len(group) > 1 and blen <= self.admit_batch_max:
                self._admit_batched(state, blen, group)
            else:
                for pick in group:
                    self._admit_one(state, blen, *pick)

    def _finish_admit(self, state, i, slot, req, plen, tok):
        slot.req = req
        state["host_off"][i] = plen
        state["temps"][i] = req.temperature
        state["tops"][i] = req.top_p
        live = self._activate(slot, req, tok)
        if live:
            state["toks"][i] = tok
        state["live"][i] = live

    def _admit_one(self, state, blen, i, req, prompt):
        padded = np.zeros((blen,), np.int64)
        padded[:len(prompt)] = prompt
        last = self._prefill_slot(state, i, padded, 0, len(prompt) - 1, "prefill")
        self._finish_admit(state, i, self.slots[i], req, len(prompt),
                           self._sample_one(req, last))

    def _admit_batched(self, state, blen, group):
        """Prefill every (slot, req, prompt) in ``group`` in ONE forward: all
        prompts start at cache position 0 and attend only their own fresh
        tokens (causal); non-member rows' caches are write-masked (dense) or
        scratch-redirected (paged). On the card the graph of ("admit", blen)
        replays over the loaded ids, admit mask and prompt lengths."""
        ids = np.zeros((self.b, blen), np.int64)
        admit = np.zeros((self.b,), bool)
        lens = np.ones((self.b,), np.int64)
        temps = np.zeros((self.b,), np.float32)
        tops = np.ones((self.b,), np.float32)
        for i, req, prompt in group:
            self._check_fits(i, 0, blen)
            ids[i, :len(prompt)] = prompt
            admit[i] = True
            lens[i] = len(prompt)
            temps[i], tops[i] = req.temperature, req.top_p
        state["ids_t"][:, :blen].copy_(torch.from_numpy(ids))
        state["admit_t"].copy_(torch.from_numpy(admit))
        state["lens_t"].copy_(torch.from_numpy(lens))
        logits = self.graphs.run(("admit", blen), lambda: self._admit_body(state, blen))
        reqs = [r for _, r, _ in group]
        mode = sample_mode([r.temperature for r in reqs], [r.top_p for r in reqs])
        toks = sample_logits(logits, self._gen, self._dev(temps), self._dev(tops),
                             mode=mode).cpu().numpy()
        for i, req, prompt in group:
            self._finish_admit(state, i, self.slots[i], req, len(prompt), int(toks[i]))

    def _admit_body(self, state, blen: int) -> torch.Tensor:
        """The admission graphs' body: the "fresh" cache forms over the first
        blen columns of ``ids_t`` under ``admit_t``; returns the logits (B, V)
        of each row's last real token (``lens_t``)."""
        admit, tables, k, v = state["admit_t"], state["tables"], state["k"], state["v"]

        def past(li):
            if tables is None:
                return ("fresh", k[li], v[li], admit)
            return ("fresh_paged", k[li], v[li], tables, admit)

        positions = torch.arange(blen, device=self.device)[None, :]
        x, delta = self._forward(state["ids_t"][:, :blen], positions, past)
        self.forwards["admit"] += 1
        # head on the last REAL hidden state of each row only
        last = (torch.arange(self.b, device=self.device), state["lens_t"] - 1)
        return self.arch.head(self.params, self.cfg, x[last][:, None],
                              None if delta is None else delta[last][:, None])[:, 0]

    def _new_cache(self, shape) -> list:
        return [torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
                for _ in range(self.num_layers)]

    def _start(self) -> dict:
        """The engine's state for a run: the device tensors made once (the
        first run; a graph replays into the tensors it was captured over),
        then reset, with fresh host copies."""
        b = self.b
        if self.paged:
            from .paged import BlockAllocator
            # +1 physical block: index 0 is a reserved scratch block (the
            # table filler value), so unowned-entry writes never alias a
            # slot's cache; the user-visible pool stays num_blocks usable
            pool_blocks = self.num_blocks + 1
            self._paged_alloc = BlockAllocator(pool_blocks, reserved=1)
            self._tables_np = np.zeros((b, self.max_blocks), np.int32)
            shape = (pool_blocks, self.block_size, self.cfg.num_kv_heads, self.cfg.head_dim)
        else:
            shape = (b, self.max_len, self.cfg.num_kv_heads, self.cfg.head_dim)
        if self.state is None:
            # normal tensors (not inference tensors): updated in place anywhere
            with torch.inference_mode(False):
                self.state = {
                    "k": self._new_cache(shape),
                    "v": self._new_cache(shape),
                    "tables": self._dev(self._tables_np) if self.paged else None,
                    "off": torch.zeros((b,), dtype=torch.int32, device=self.device),
                    "live_t": torch.zeros((b,), dtype=torch.bool, device=self.device),
                    "toks_t": torch.zeros((b, 1), dtype=torch.long, device=self.device),
                    "temps_t": torch.zeros((b,), dtype=torch.float32, device=self.device),
                    "tops_t": torch.ones((b,), dtype=torch.float32, device=self.device),
                    # the prefill, admission and chunk graphs' inputs
                    "ids_t": torch.zeros((b, max(self.buckets[-1], self.prefill_chunk or 1)),
                                         dtype=torch.long, device=self.device),
                    "slot_meta": torch.zeros((3,), dtype=torch.int32, device=self.device),
                    "admit_t": torch.zeros((b,), dtype=torch.bool, device=self.device),
                    "lens_t": torch.ones((b,), dtype=torch.long, device=self.device),
                }
        state = self.state
        if self.paged:
            state["tables"].zero_()
        state.update(host_off=np.zeros((b,), np.int64), temps=np.zeros((b,), np.float32),
                     tops=np.ones((b,), np.float32), toks=np.zeros((b,), np.int64),
                     live=np.zeros((b,), bool))
        return state

    @torch.inference_mode()
    def run(self, log=None) -> dict[int, np.ndarray]:
        """Drain the queue; returns {uid: generated token array}. The final
        caches stay in ``self.state`` until the next run."""
        state = self._start()
        steps = produced = 0
        t0 = time.perf_counter()

        while self.queue or any(not s.done for s in self.slots):
            self._admit(state)
            fused_chunk = None
            if self.prefill_chunk is not None:
                if self.fused_chunk_decode and state["live"].any():
                    fused_chunk = self._pick_pending()
                else:
                    self._prefill_tick(state)  # one chunk per iteration
                    if not state["live"].any():
                        continue  # nothing decoding yet; keep prefilling
            # a multi-step span only when the host has nothing to schedule and
            # capacity cannot be hit mid-span: spans trade <= span-1 tokens of
            # admission latency for throughput (a slot retiring mid-span is
            # only backfilled at the next host iteration)
            span = self.decode_span
            if span > 1 and (any(s.pending is not None for s in self.slots)
                             or not state["live"].any()
                             or state["host_off"][state["live"]].max() + span
                             >= self._kv_len()):
                span = 1
            # the sampling fast path from the params of the slots whose tokens
            # are kept (the live ones): all-greedy batches skip the sort
            live = state["live"]
            mode = sample_mode(state["temps"][live], state["tops"][live])
            fused_done = None
            if fused_chunk is not None:
                i, slot, ids, off0, last_idx = fused_chunk
                logits, clast = self._chunk_decode_step(state, i, ids, off0, last_idx)
                # activation must wait until after the token loop below: the
                # fused step decoded with the PRE-activation live mask, so
                # this slot's decode logits are meaningless
                fused_done = (i, slot, clast)
                toks_np = sample_logits(logits, self._gen, state["temps_t"], state["tops_t"],
                                        mode=mode).cpu().numpy().reshape(-1, 1)
            else:
                toks_np = self._decode_span(state, span, mode)   # (B, span)
            for j in range(toks_np.shape[1]):
                for i, slot in enumerate(self.slots):
                    if slot.done or not state["live"][i]:
                        continue
                    req = slot.req
                    t = int(toks_np[i, j])
                    state["host_off"][i] += 1
                    slot.generated.append(t)
                    produced += 1
                    ended = req.eos_token_id is not None and t == req.eos_token_id
                    full = state["host_off"][i] + 1 >= self.max_len
                    if ended or full or len(slot.generated) >= req.max_new_tokens:
                        self.results[req.uid] = np.asarray(slot.generated, np.int32)
                        self._meta[req.uid]["done"] = time.perf_counter()
                        slot.done = True
                        state["live"][i] = False
                        # paged blocks are NOT released here: a retired slot
                        # still takes part in the batched decode step and
                        # re-writes its frozen position, so its blocks stay
                        # owned until the slot is re-admitted (released in
                        # _admit). Tokens it produced later in the span (it
                        # kept decoding on the card) are dropped by the
                        # live[] check.
                    else:
                        state["toks"][i] = t
            if fused_done is not None:
                self._finish_chunk(state, *fused_done)
            steps += 1
            if log and steps % 32 == 0:
                dt = time.perf_counter() - t0
                log(f"  serve: {steps} steps, {produced} tokens, {produced / dt:.1f} tok/s")
        self.steps = steps
        return self.results
