"""Inference runner: prefill and decode over a static per-layer KV cache.

Counterpart of ``gptq_for_llama_tpu/runtime/runner.py``. PyTorch runs
eagerly, so the TPU package's jit, lax.scan and pytree machinery have no
counterpart: layers and tokens are Python loops, the cache is a list of
per-layer tensors written in place, and the cache offset is a host int (all
rows aligned), so no step waits on the device to learn it. The greedy loop
keeps each token on the device (no ``.item()`` per step).

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
from ..models.registry import get_arch


@dataclasses.dataclass
class KVCache:
    k: list            # per layer (B, max_len, Hkv, D), written in place
    v: list
    offset: int        # number of valid slots (every row aligned)

    @classmethod
    def zeros(cls, cfg, num_layers: int, batch: int, max_len: int, dtype, device):
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return cls([torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
                   0)


class ModelRunner:
    """Prefill and decode for one (model, batch, max_len) configuration.

    ``params`` must already live on ``device`` (see ``convert.params_from_jax``
    and ``runtime.random_model``). The cache passed to ``prefill``/``decode``
    is updated in place: start every sequence from ``init_cache()``.

    ``cache_impl``: "classic" writes each step's k/v and then attends the
    cache (the decode kernel); "fold" decodes every one-token step through the
    fold kernel, over the stale cache with the current k/v folded in, and
    then writes the row (the TPU package's GPTQ_TPU_CACHE_IMPL=pallas).
    Prefills are the same in both."""

    def __init__(self, arch_name: str, cfg, params, batch_size: int = 1,
                 max_seq_len: Optional[int] = None, dtype=torch.bfloat16, device=None,
                 cache_impl: str = "classic"):
        self.cache_impl = check_cache_impl(cache_impl)
        self.device = resolve_device(device)
        self.arch = get_arch(arch_name)
        self.arch_name = arch_name
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_seq_len or cfg.max_seq_len
        self.dtype = dtype
        emb_dev = params["embed_tokens"].device
        if emb_dev.type != self.device.type:
            raise ValueError(f"params live on {emb_dev}, the runner on {self.device}")

    def init_cache(self) -> KVCache:
        return KVCache.zeros(self.cfg, len(self.params["layers"]), self.batch,
                             self.max_len, self.dtype, self.device)

    @torch.inference_mode()
    def _step(self, ids: torch.Tensor, cache: KVCache):
        arch, cfg = self.arch, self.cfg
        b, s = ids.shape
        off = cache.offset
        if b != self.batch or off + s > self.max_len:
            raise ValueError(f"step of {tuple(ids.shape)} at offset {off} does not fit "
                             f"batch {self.batch}, max_len {self.max_len}")
        ids = ids.to(self.device)
        positions = torch.arange(off, off + s, device=self.device)[None, :]
        rope = arch.step_rope(cfg, positions, self.dtype)
        x = arch.embed(self.params, cfg, ids).to(self.dtype)
        fold = ("fold",) if self.cache_impl == "fold" else ()
        x, delta = arch.stack(self.params, cfg, x, positions, None,
                              lambda li: (*fold, cache.k[li], cache.v[li], off), rope=rope)
        logits = arch.head(self.params, cfg, x, delta)
        return logits, KVCache(cache.k, cache.v, off + s)

    def prefill(self, ids: torch.Tensor, cache: KVCache):
        """ids: (B, S) prompt tokens. Returns (logits (B, S, V), cache)."""
        return self._step(ids, cache)

    def decode(self, ids: torch.Tensor, cache: KVCache):
        """ids: (B, 1). One decode step: (logits (B, 1, V), cache)."""
        if ids.shape[1] != 1:
            raise ValueError(f"decode takes one token per row, got {tuple(ids.shape)}")
        return self._step(ids, cache)

    @torch.inference_mode()
    def decode_greedy(self, ids: torch.Tensor, cache: KVCache, steps: int):
        """``steps`` greedy iterations from first token ids (B, 1); every token
        stays on the device. Returns (tokens (B, steps), cache)."""
        tok, toks = ids.to(self.device), []
        for _ in range(steps):
            logits, cache = self.decode(tok, cache)
            tok = logits[:, -1].float().argmax(-1, keepdim=True)
            toks.append(tok)
        return torch.cat(toks, dim=1), cache

    @torch.inference_mode()
    def forced_decode(self, ids: torch.Tensor, cache: KVCache):
        """Teacher-forced decode, one token of ids (B, S) per step. Returns
        (last logits (B, 1, V), cache): the same cache and logits as prefill."""
        logits = None
        for i in range(ids.shape[1]):
            logits, cache = self.decode(ids[:, i:i + 1], cache)
        return logits, cache

    def warmup(self, prefill_buckets=(16,)) -> None:
        """Build the kernels and allocate once, on a scratch cache."""
        for s in prefill_buckets:
            ids = torch.zeros((self.batch, s), dtype=torch.long, device=self.device)
            self.prefill(ids, self.init_cache())
        ids = torch.zeros((self.batch, 1), dtype=torch.long, device=self.device)
        self.decode(ids, self.init_cache())
        _sync(self.device)


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


@torch.inference_mode()
def generate(runner: ModelRunner, prompt_ids, max_new_tokens: int, temperature: float = 0.8,
             top_p: float = 0.95, top_k: int = 0, min_new_tokens: int = 0,
             eos_token_id: Optional[int] = None, seed: int = 0, stream=None) -> np.ndarray:
    """Autoregressive generation. prompt_ids: (B, S) or (S,) ints. Returns
    (B, S + new) token ids as numpy. The host waits on the device per token
    only for EOS bookkeeping or a ``stream`` callback."""
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
    done = torch.zeros(b, dtype=torch.bool, device=runner.device)
    toks = []
    for step in range(max_new_tokens):
        if eos_token_id is not None and step < min_new_tokens:
            # EOS cannot be sampled before the minimum length
            last = last.clone()
            last[:, eos_token_id] = float("-inf")
        nxt = sample_logits(last, gen, temperature, top_p, top_k)
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
    new = torch.stack(toks, dim=1).cpu().numpy() if toks else np.zeros((b, 0), np.int64)
    return np.concatenate([ids, new], axis=1)


# ---------------------------------------------------------------------------
# decode benchmark
# ---------------------------------------------------------------------------

@torch.inference_mode()
def benchmark_decode(runner: ModelRunner, input_ids, check: bool = False, log=print) -> dict:
    """Feed input_ids one token at a time through the decode step; report
    the median per-token latency (host clock around a synchronized step),
    tokens/s, peak device memory (``torch.cuda.max_memory_allocated``; None
    on the CPU) and, with ``check``, the next-token perplexity."""
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
    }
    if check and n > 1:
        result["ppl"] = float(np.exp(nll / (n - 1)))
    return result
