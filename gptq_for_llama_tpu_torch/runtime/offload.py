"""Offloaded inference: run a model larger than the card's memory.

Counterpart of ``gptq_for_llama_tpu/runtime/offload.py`` (the reference's
``llama_inference_offload.py``, ``--pre_layer``): the first ``pre_layer``
decoder layers, the embedding, the final norm and the head live on the
device; the other layers live in pinned host memory and stream to the card
one layer ahead of their use, so that the copy of layer i + 1 runs while
layer i computes (the TPU package's asynchronous ``device_put``).

On the card the streamed layers share two device slots: raw byte buffers,
each the size of the largest streamed layer, allocated once; every streamed
layer is a tree of views at its own shapes into its slot. A side stream copies layer i + 1 into the
other slot; the compute stream waits on that copy's event before layer i + 1;
and the side stream waits, before it writes layer i + 2 over layer i's slot,
on an event the compute stream recorded after layer i's last kernel. With
fixed slots no tensor changes stream and the allocator is not touched per
layer. On the CPU nothing is pinned and the copies are plain copies: the
tests run the same code.

The layers stream through the arch's own ``stack`` (``StreamedLayers`` is
the ``"layers"`` of a parameter view), and the steps are ``ModelRunner``'s
bodies run eagerly: LLaMA's pending residual add still folds into the next
norm, decode plans its attention for its live-length bucket, and a prefill
is right-padded and planned as the resident runner's is. So the greedy
tokens and the logits are the resident runner's, bit for bit, on the card
as on the CPU. There are no CUDA graphs: ``generate`` takes the per-token
loop for this runner, as in the TPU package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..engine.evaluate import perplexity
from ..models.registry import get_arch
from ..ops.linear import PackedLinear
from ..ops.lora import map_leaves
from .runner import ModelRunner, _call
from .runner import generate as runner_generate

# the device tensors of a packed linear, in the order they are copied
_PACKED_FIELDS = ("qweight", "scales", "zeros", "perm", "bias")


def map_tensors(tree, fn):
    """``tree`` with every tensor t replaced by fn(t), in tree order: plain
    tensors and a packed linear's device tensors (its host buffers and
    metadata kept); a tensor met twice maps once."""
    memo = {}

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in memo:
            memo[id(t)] = fn(t)
        return memo[id(t)]

    def leaf(x):
        if isinstance(x, PackedLinear):
            return dataclasses.replace(x, **{f: one(getattr(x, f)) for f in _PACKED_FIELDS})
        return one(x)

    return map_leaves(leaf, tree)


def tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree`` in ``map_tensors``' order."""
    out = []
    map_tensors(tree, out.append)
    return out


class StreamedLayers:
    """The ``"layers"`` of an offloaded model as ``stack`` reads them: the
    resident layers, then each streamed layer in its slot, staged one layer
    ahead. Each iteration is one pass over the model. ``staged_bytes``
    counts the bytes copied to the device.

    The two slots are raw device byte buffers, each the size of the largest
    streamed layer, and every streamed layer is a tree of views at its own
    shapes and dtypes into the slot it is staged in (layer i into slot
    i % 2): layers of different shapes (an ``--observe`` model's upgraded
    group sizes and bits, a layer without an act-order permutation) stream
    through the same two buffers, as the TPU package stages each layer at
    its own shapes."""

    def __init__(self, resident: list, host: list, device: torch.device):
        self.resident, self.host, self.device = resident, host, device
        self.staged_bytes = 0
        self._src = [tensors(h) for h in host]
        self.bytes_of = [sum(_nbytes(t) for t in src) for src in self._src]
        # the largest streamed layer's bytes
        self.layer_bytes = max(self.bytes_of, default=0)
        slot_bytes = max((_carved(src) for src in self._src), default=0)
        with torch.inference_mode(False):   # written in place under inference mode
            self.slots = [torch.empty(slot_bytes, dtype=torch.uint8, device=device)
                          for _ in range(min(2, len(host)))]
        # each streamed layer as the model reads it: its own metadata (the
        # permutation digests, the wire buffers) over views into its slot
        self.views = [_carve(h, self.slots[i % 2]) for i, h in enumerate(host)]
        self._dst = [tensors(v) for v in self.views]
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
            self._copied = [torch.cuda.Event() for _ in self.slots]
            self._freed = [torch.cuda.Event() for _ in self.slots]

    def __len__(self) -> int:
        return len(self.resident) + len(self.host)

    def __iter__(self):
        n = len(self.host)
        if n:
            if self.device.type == "cuda":
                # nothing enqueued before this pass (the last pass's layers)
                # still reads a slot when its first two copies start
                self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._stage(0)   # under the resident layers
        yield from self.resident
        for i in range(n):
            if i + 1 < n:
                self._stage(i + 1)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).wait_event(self._copied[i % 2])
            yield self.views[i]
            if self.device.type == "cuda":
                # every kernel of layer i is enqueued: its slot is free after them
                self._freed[i % 2].record(torch.cuda.current_stream(self.device))

    def _stage(self, i: int) -> None:
        """Copy streamed layer i into its views in slot i % 2: on the side
        stream, after the compute stream is done with layer i - 2 there."""
        slot = i % 2
        if self.device.type != "cuda":
            for dst, src in zip(self._dst[i], self._src[i]):
                dst.copy_(src)
        else:
            with torch.cuda.stream(self._stream):
                if i >= 2:
                    self._after(slot)
                for dst, src in zip(self._dst[i], self._src[i]):
                    dst.copy_(src, non_blocking=True)
                self._copied[slot].record(self._stream)
        self.staged_bytes += self.bytes_of[i]

    def _after(self, slot: int) -> None:
        """The side stream waits until the compute stream is done with the
        layer in ``slot``."""
        self._stream.wait_event(self._freed[slot])


# each view in a slot starts on a multiple of this many bytes (every dtype's
# alignment, and the kernels' vector loads)
_ALIGN = 256


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _carved(src: list) -> int:
    """The slot bytes ``_carve`` takes for these tensors."""
    return sum(-(-_nbytes(t) // _ALIGN) * _ALIGN for t in src)


def _carve(tree, slot: torch.Tensor):
    """``tree`` with each tensor replaced by a view of its shape and dtype
    into the byte buffer ``slot``, laid out in tree order, each view on an
    ``_ALIGN`` boundary."""
    at = 0

    def view(t):
        nonlocal at
        n = _nbytes(t)
        out = slot[at:at + n].view(t.dtype).view(t.shape)
        at += -(-n // _ALIGN) * _ALIGN
        return out

    return map_tensors(tree, view)


class OffloadRunner:
    """Layer-streaming forward, prefill, decode and generation for a model
    larger than the device's memory; the surface of ``ModelRunner`` that
    ``generate`` and ``benchmark_decode`` use, plus ``forward`` and
    ``perplexity``.

    ``params`` may live on the CPU or on the card: layers ``[:pre_layer]``
    and every other part go to ``device``, layers ``[pre_layer:]`` to pinned
    host memory (on the card; a pinning that fails raises). ``pre_layer``
    must lie in [0, num_layers]. The KV cache is the runner's own device
    storage, stored in ``kv_dtype`` (``ops/kv_dtype.py``), with
    ``ModelRunner``'s handle and epoch rules; ``cache_impl`` is classic."""

    def __init__(self, arch_name: str, cfg, params, pre_layer: int, dtype=torch.bfloat16,
                 batch_size: int = 1, max_seq_len: Optional[int] = None, kv_dtype=None,
                 device=None):
        self.device = resolve_device(device)
        layers = params["layers"]
        if not 0 <= pre_layer <= len(layers):
            raise ValueError(f"pre_layer {pre_layer} outside [0, {len(layers)}]")
        self.arch, self.arch_name, self.cfg = get_arch(arch_name), arch_name, cfg
        cuda = self.device.type == "cuda"

        def host(t):
            if not cuda:
                return t.to("cpu")
            pinned = (t.pin_memory() if t.device.type == "cpu" else
                      torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t))
            if not pinned.is_pinned():
                raise RuntimeError("offload: pinning a streamed layer's tensor failed")
            return pinned

        self.resident = [map_tensors(lp, lambda t: t.to(self.device)) for lp in layers[:pre_layer]]
        self.host_layers = [map_tensors(lp, host) for lp in layers[pre_layer:]]
        self.statics = map_tensors({k: v for k, v in params.items() if k != "layers"},
                                   lambda t: t.to(self.device))
        self.layers = StreamedLayers(self.resident, self.host_layers, self.device)
        # the bytes one forward streams to the device
        self.streamed_bytes = sum(self.layers.bytes_of)
        # the resident runner's step bodies, run eagerly over the streamed view
        self._steps = ModelRunner(arch_name, cfg, {**self.statics, "layers": self.layers},
                                  batch_size=batch_size, max_seq_len=max_seq_len, dtype=dtype,
                                  device=self.device, kv_dtype=kv_dtype)
        self.batch, self.max_len = self._steps.batch, self._steps.max_len
        self.kv_dtype, self.forwards = self._steps.kv_dtype, self._steps.forwards
        self.params = self._steps.params

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """(B, S) -> (B, S, V) logits: the arch's cache-less causal forward,
        streaming the offloaded layers."""
        ids = torch.as_tensor(input_ids).to(device=self.device, dtype=torch.long)
        return self.arch.forward(self.params, self.cfg, ids)

    def init_cache(self):
        """The runner's cache, zeroed, at offset 0 (``ModelRunner.init_cache``)."""
        return self._steps.init_cache()

    @torch.inference_mode()
    def prefill(self, ids, cache):
        """(B, S) prompt: (logits (B, S, V), cache), the resident runner's
        prefill body (right-padded to S_pad) run eagerly."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return self._steps._prefill(ids, cache, _call)

    @torch.inference_mode()
    def decode(self, ids, cache):
        """(B, 1): one decode step, (logits (B, 1, V), cache), planned for its
        live-length bucket as the resident runner's."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        if tuple(ids.shape) != (self.batch, 1):
            raise ValueError(f"decode takes one token per row, got {tuple(ids.shape)}")
        return self._steps._step(ids, cache)

    def generate(self, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
                 top_p: float = 0.95, top_k: int = 0, min_new_tokens: int = 0,
                 eos_token_id: Optional[int] = None, seed: int = 0, stream=None) -> np.ndarray:
        """``runtime.runner.generate`` over this runner: the per-token loop,
        its sampling, EOS and minimum-length rules, and the resident runner's
        greedy tokens."""
        return runner_generate(self, prompt_ids, max_new_tokens, temperature=temperature,
                               top_p=top_p, top_k=top_k, min_new_tokens=min_new_tokens,
                               eos_token_id=eos_token_id, seed=seed, stream=stream)

    def warmup(self, prefill_buckets=(), autotune: bool = True) -> None:
        """Nothing to capture or tune: ``benchmark_decode`` calls it, and the
        steps run eagerly (the TPU package's offload warmup does nothing
        either)."""
        return None

    def perplexity(self, test_ids, seqlen: int) -> float:
        """``engine.evaluate.perplexity`` over the streamed model: the same
        windows, batches and head chunks as the resident eval."""
        return perplexity(self.arch_name, self.cfg, self.params, test_ids, seqlen=seqlen)
