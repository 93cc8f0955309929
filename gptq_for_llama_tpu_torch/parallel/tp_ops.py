"""Tensor-parallel quantized matmuls: kernel 1 on each rank's local shard.

Counterpart of ``gptq_for_llama_tpu/parallel/tp_ops.py`` (its
``shard_map``-wrapped Pallas matmuls):

- column-parallel: x replicated, the weight split on out-features; one local
  kernel-1 launch; the output stays split on N (this rank's columns);
- row-parallel: x split on in-features (this rank takes its slice of the
  replicated x), the weight split on K in whole groups; a local launch with
  no bias, then an all-reduce over the tp group, then the bias added once.

``lin`` is this rank's shard from ``parallel/sharding.shard_packed_linear``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.linear import PackedLinear
from ..ops.quant_matmul import quant_matmul
from .sharding import Mesh


def tp_quant_matmul(x: torch.Tensor, lin: PackedLinear, mesh: Mesh, mode: str) -> torch.Tensor:
    """y = x @ dequant(W) with kernel 1 on this rank's shard ``lin``.

    mode 'col': x (..., K) replicated -> this rank's columns (..., N / tp).
    mode 'row': x (..., K) replicated -> y (..., N) replicated (all-reduce).
    """
    if mode == "col":
        return quant_matmul(x, lin, dtype=x.dtype)
    if mode != "row":
        raise ValueError(mode)
    groups = lin.scales.shape[0]
    if groups * mesh.tp != -(-lin.in_features * mesh.tp // lin.groupsize):
        # shard_packed_linear replicated the groups: they do not split over tp
        raise ValueError(
            f"row-parallel shard_map needs groups ({groups}) "
            f"divisible by tp ({mesh.tp})")
    if lin.perm is not None:
        # act-order rows need a device-row index map (parallel/tp_model's
        # prepare_tp_params does this for the whole-step runner)
        raise NotImplementedError(
            "tp_quant_matmul row mode does not support act-order or "
            "K-padded weights — use the shard_map TP runner "
            "(parallel/tp_model) instead")
    k = lin.in_features
    xl = x[..., mesh.tp_rank * k:(mesh.tp_rank + 1) * k]
    y = quant_matmul(xl, dataclasses.replace(lin, bias=None), dtype=x.dtype)
    y = mesh.all_reduce(y)
    return y if lin.bias is None else y + lin.bias
