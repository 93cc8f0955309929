"""Calibration / evaluation token streams with the reference's sampling.

Counterpart of ``gptq_for_llama_tpu/data/datautils.py`` (numpy and Python
``random`` only, so the same seed picks the same windows in both packages):
the reference's corpus construction and seeded window selection
(``random.seed(seed)`` then ``random.randint(0, total - seqlen - 1)`` per
sample), and the offline ``synthetic`` corpus, which goes through the same
windowing code. The real corpora (wikitext2, ptb, c4 and their ``-new``
variants) import ``datasets`` and ``transformers`` lazily and need their files
in the HuggingFace cache. Windows are numpy int32 (nsamples, seqlen).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def set_seed(seed: int) -> None:
    """Seed python + numpy RNGs (reference: datautils.py:5-7)."""
    random.seed(seed)
    np.random.seed(seed)


def _get_tokenizer(model: str):
    from transformers import AutoTokenizer
    try:
        return AutoTokenizer.from_pretrained(model, use_fast=False)
    except Exception:
        return AutoTokenizer.from_pretrained(model, use_fast=True)


def _sample_windows(ids: np.ndarray, nsamples: int, seed: int, seqlen: int) -> np.ndarray:
    """nsamples random seqlen windows from a 1-D token stream, reference seeding.

    Matches datautils.py:23-32: random.seed(seed); randint(0, len - seqlen - 1).
    Returns (nsamples, seqlen) int32.
    """
    total = ids.shape[0]
    if total < seqlen + 1:
        raise ValueError(f"Corpus has {total} tokens < seqlen+1 ({seqlen + 1})")
    random.seed(seed)
    out = np.empty((nsamples, seqlen), dtype=np.int32)
    for s in range(nsamples):
        i = random.randint(0, total - seqlen - 1)
        out[s] = ids[i:i + seqlen]
    return out


def _encode(tokenizer, text: str) -> np.ndarray:
    return np.asarray(tokenizer(text)["input_ids"], dtype=np.int32)


def get_wikitext2(nsamples, seed, seqlen, model):
    """wikitext-2-raw-v1; train joined with \\n\\n (reference: datautils.py:10-33)."""
    from datasets import load_dataset
    traindata = load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
    testdata = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
    tokenizer = _get_tokenizer(model)
    trainids = _encode(tokenizer, "\n\n".join(traindata["text"]))
    testids = _encode(tokenizer, "\n\n".join(testdata["text"]))
    return _sample_windows(trainids, nsamples, seed, seqlen), testids


def get_ptb(nsamples, seed, seqlen, model):
    """ptb_text_only; eval on the VALIDATION split (reference: datautils.py:36-59)."""
    from datasets import load_dataset
    traindata = load_dataset("ptb_text_only", "penn_treebank", split="train")
    valdata = load_dataset("ptb_text_only", "penn_treebank", split="validation")
    tokenizer = _get_tokenizer(model)
    trainids = _encode(tokenizer, "\n\n".join(traindata["sentence"]))
    testids = _encode(tokenizer, "\n\n".join(valdata["sentence"]))
    return _sample_windows(trainids, nsamples, seed, seqlen), testids


def get_ptb_new(nsamples, seed, seqlen, model):
    """--new-eval variant: " ".join and the TEST split (reference: datautils.py:113-136)."""
    from datasets import load_dataset
    traindata = load_dataset("ptb_text_only", "penn_treebank", split="train")
    testdata = load_dataset("ptb_text_only", "penn_treebank", split="test")
    tokenizer = _get_tokenizer(model)
    trainids = _encode(tokenizer, " ".join(traindata["sentence"]))
    testids = _encode(tokenizer, " ".join(testdata["sentence"]))
    return _sample_windows(trainids, nsamples, seed, seqlen), testids


def _c4_doc_windows(data, tokenizer, n: int, seed: int, seqlen: int) -> np.ndarray:
    """n windows, each from a random doc long enough (reference: datautils.py:73-100)."""
    random.seed(seed)
    out = np.empty((n, seqlen), dtype=np.int32)
    for s in range(n):
        while True:
            i = random.randint(0, len(data) - 1)
            ids = _encode(tokenizer, data[i]["text"])
            # the reference uses >= for train (datautils.py:80) and its val loop
            # (:96) — a doc of exactly seqlen tokens then draws randint(0, -1),
            # which python rejects; >= seqlen + 1 never changes sampling for real
            # c4 docs but keeps the synthetic path well-defined.
            if ids.shape[0] >= seqlen + 1:
                break
        j = random.randint(0, ids.shape[0] - seqlen - 1)
        out[s] = ids[j:j + seqlen]
    return out


def get_c4(nsamples, seed, seqlen, model):
    """allenai/c4 first shard; val = 256 seed-0 windows (reference: datautils.py:62-110)."""
    from datasets import load_dataset
    traindata = load_dataset(
        "allenai/c4", data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
        split="train")
    valdata = load_dataset(
        "allenai/c4", data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
        split="validation")
    tokenizer = _get_tokenizer(model)
    train = _c4_doc_windows(traindata, tokenizer, nsamples, seed, seqlen)
    val = _c4_doc_windows(valdata, tokenizer, 256, 0, seqlen).reshape(-1)
    return train, val


def get_c4_new(nsamples, seed, seqlen, model):
    """--new-eval variant: val = first 1100 docs joined, 256*seqlen tokens
    (reference: datautils.py:139-176)."""
    from datasets import load_dataset
    traindata = load_dataset(
        "allenai/c4", data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
        split="train")
    valdata = load_dataset(
        "allenai/c4", data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
        split="validation")
    tokenizer = _get_tokenizer(model)
    train = _c4_doc_windows(traindata, tokenizer, nsamples, seed, seqlen)
    val = _encode(tokenizer, " ".join(valdata[:1100]["text"]))[: 256 * seqlen]
    return train, val


def get_synthetic(nsamples, seed, seqlen, model: Optional[str] = None,
                  vocab_size: int = 256, total_tokens: int = 200_000):
    """Deterministic offline corpus for CI/bench (no network, no tokenizer).

    A fixed-seed Zipf-ish token stream (frequent low ids) run through the same
    windowing code as the real datasets. ``model`` may be a ModelConfig-like with
    vocab_size or an int.
    """
    if hasattr(model, "vocab_size"):
        vocab_size = model.vocab_size
    elif isinstance(model, int):
        vocab_size = model
    rng = np.random.RandomState(1234)  # corpus identity is fixed; `seed` picks windows
    z = rng.zipf(1.5, size=total_tokens)
    ids = ((z - 1) % vocab_size).astype(np.int32)
    test = ids[-(total_tokens // 4):]
    train = ids[: -(total_tokens // 4)]
    return _sample_windows(train, nsamples, seed, seqlen), test


def get_loaders(name: str, nsamples: int = 128, seed: int = 0, seqlen: int = 2048,
                model: str = ""):
    """Dispatch by dataset name (reference: datautils.py:179-189).

    Returns (train_windows (nsamples, seqlen) int32, test_ids (T,) int32).
    """
    if "synthetic" in name:
        return get_synthetic(nsamples, seed, seqlen, model)
    if "wikitext2" in name:
        return get_wikitext2(nsamples, seed, seqlen, model)
    if "ptb" in name:
        if "new" in name:
            return get_ptb_new(nsamples, seed, seqlen, model)
        return get_ptb(nsamples, seed, seqlen, model)
    if "c4" in name:
        if "new" in name:
            return get_c4_new(nsamples, seed, seqlen, model)
        return get_c4(nsamples, seed, seqlen, model)
    raise ValueError(f"Unknown dataset {name!r}")
