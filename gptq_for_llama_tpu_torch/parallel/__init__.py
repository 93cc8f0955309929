"""Tensor and data parallelism over ``torch.distributed``: one process per
rank, TP shardings of packed weights and KV caches, the TP runner's and
engine's collectives."""

from .sharding import Mesh, make_mesh, shard_cache, shard_packed_linear
from .tp_ops import tp_quant_matmul

__all__ = ["Mesh", "make_mesh", "shard_cache", "shard_packed_linear", "tp_quant_matmul"]
