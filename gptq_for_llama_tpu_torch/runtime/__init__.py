"""Inference runtime: runner, sampling, generation, decode benchmark, serving engine."""

from .runner import KVCache, ModelRunner, benchmark_decode, generate, sample_logits
from .serve import GenRequest, ServingEngine

__all__ = ["GenRequest", "KVCache", "ModelRunner", "ServingEngine", "benchmark_decode",
           "generate", "sample_logits"]
