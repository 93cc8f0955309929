"""Perplexity evaluation — the reference's integration test.

Counterpart of ``gptq_for_llama_tpu/engine/evaluate.py``: the test stream is
cut into seqlen windows, each window's shifted cross-entropy comes from one
cache-less causal forward (attention through the causal prefill kernel on
the card), and ppl = exp(sum nll / (nsamples * seqlen)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.common import causal_mask
from ..models.registry import embed_weight, get_arch


@torch.inference_mode()
def window_nll(arch, cfg, params, ids: torch.Tensor, head_chunk: int = 512) -> torch.Tensor:
    """Per-window summed shifted cross-entropy of (B, seqlen) windows, scaled
    as the reference (mean over seqlen - 1 tokens, times seqlen). The head is
    applied ``head_chunk`` positions at a time, so the fp32 (B, S, V) logits
    never materialize; per-row log-softmax does not depend on the chunking."""
    b, s = ids.shape
    positions = torch.arange(s, device=ids.device)[None, :]
    x = arch.embed(params, cfg, ids, positions)
    x, delta = arch.stack(params, cfg, x, positions, causal_mask(s, s, device=ids.device))
    # the final norm once over every row (the last layer's add in its launch)
    xs, labels = arch.head_input(params, cfg, x, delta)[:, :-1], ids[:, 1:]
    acc = torch.zeros(b, dtype=torch.float32, device=ids.device)
    for c0 in range(0, s - 1, min(head_chunk, s - 1)):
        logits = arch.logits(params, cfg, xs[:, c0:c0 + head_chunk]).float()
        gold = logits.gather(-1, labels[:, c0:c0 + head_chunk, None])[..., 0]
        acc += (torch.logsumexp(logits, dim=-1) - gold).sum(-1)
    return acc / (s - 1) * s


def default_batch(seqlen: int, device: torch.device) -> int:
    """Eval window batch: 8 on the card (the causal prefill kernel takes
    every seqlen and never materializes the (B, H, S, S) logits); on the CPU
    the plain softmax does, so the batch scales down with seqlen."""
    if device.type == "cuda":
        return 8
    return max(1, min(8, (512 * 512 * 8) // (seqlen * seqlen)))


def perplexity(arch_name: str, cfg, params, test_ids, seqlen: int | None = None,
               verbose: bool = False, log=print, batch: int | None = None) -> float:
    """Perplexity over a flat token stream (T,), on the device of ``params``:
    floor(T / seqlen) windows, ``batch`` at a time (the last batch is padded
    and its padded rows dropped, as the TPU package keeps one shape)."""
    arch = get_arch(arch_name)
    seqlen = seqlen or cfg.max_seq_len
    device = embed_weight(params).device
    if batch is None:
        batch = default_batch(seqlen, device)
    test_ids = np.asarray(test_ids).reshape(-1)
    nsamples = len(test_ids) // seqlen
    if nsamples == 0:
        raise ValueError(f"test stream of {len(test_ids)} tokens < seqlen {seqlen}")
    windows = test_ids[: nsamples * seqlen].reshape(nsamples, seqlen)
    total, done = 0.0, 0
    for i in range(0, nsamples, batch):
        chunk = windows[i:i + batch]
        n = len(chunk)
        if n < batch and nsamples >= batch:
            chunk = np.pad(chunk, ((0, batch - n), (0, 0)))
        vals = window_nll(arch, cfg, params, torch.as_tensor(chunk, dtype=torch.long,
                                                             device=device))
        total += float(vals[:n].sum())
        done += n
        if verbose and (i // batch) % 4 == 3:
            log(f"  ppl eval {done}/{nsamples}: {float(np.exp(total / (done * seqlen))):.4f}")
    return float(np.exp(total / (nsamples * seqlen)))
