"""Tensor-parallel placement of packed quantized weights and KV caches.

Counterpart of ``gptq_for_llama_tpu/parallel/sharding.py``. The TPU package
places its weights with NamedShardings over a (dp, tp) device mesh; the port
runs one process per rank, and each rank holds only its own slice. The
scheme (Megatron-style, per decoder layer) is the TPU package's:

  column-parallel (split out-features N): q/k/v/gate/up (llama), q/k/v/fc1
    (opt), query_key_value/dense_h_to_4h (neox), c_attn/c_fc (gpt2)
  row-parallel (split in-features K): o_proj/down_proj, out_proj/fc2,
    dense/dense_4h_to_h, c_proj; each followed by an all-reduce over tp
  lm_head: column-parallel over the vocabulary; embeddings and norms
    replicated.

PackedLinear tensors (``ops/linear.py``): qweight (K*bits/32, N) col -> its
N, row -> its packed rows; scales/zeros (G, N) likewise (row: replicated
when G % tp != 0); perm (K,) replicated; bias col -> split, row ->
replicated. Divisibility: col needs N % tp == 0; row needs K % (tp * 32) ==
0 (whole packed words, 3-bit packs included, on each shard).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.linear import PackedLinear
from .distributed import local_rank

# per-arch: linear tree-path suffix -> 'col' | 'row'
TP_RULES = {
    "llama": {
        "self_attn.q_proj": "col", "self_attn.k_proj": "col",
        "self_attn.v_proj": "col", "self_attn.o_proj": "row",
        "mlp.gate_proj": "col", "mlp.up_proj": "col", "mlp.down_proj": "row",
    },
    "opt": {
        "self_attn.q_proj": "col", "self_attn.k_proj": "col",
        "self_attn.v_proj": "col", "self_attn.out_proj": "row",
        "fc1": "col", "fc2": "row",
    },
    "neox": {
        # the fused qkv is (heads, 3 * head_dim) on N: splitting N splits
        # whole heads as long as num_heads % tp == 0
        "attention.query_key_value": "col", "attention.dense": "row",
        "mlp.dense_h_to_4h": "col", "mlp.dense_4h_to_h": "row",
    },
    "gpt2": {
        # the fused c_attn is [all Q | all K | all V]; tp_model regroups its
        # columns per shard before the split (``_relayout_qkv_blocks``)
        "attn.c_attn": "col", "attn.c_proj": "row",
        "mlp.c_fc": "col", "mlp.c_proj": "row",
    },
}


def tp_rules(arch_name: str) -> dict:
    """TP_RULES lookup with an actionable error for unsupported arches."""
    try:
        return TP_RULES[arch_name]
    except KeyError:
        raise ValueError(
            f"tensor parallelism is not supported for {arch_name!r}; "
            "run single-chip") from None


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, tp) mesh of ranks: its coordinates, its
    device, and one process group for its tp row and one for its dp column.
    ``member`` is False for a rank past dp * tp (the TPU package's
    ``make_mesh`` leaves such devices out). ``collectives`` counts the
    all-reduces and all-gathers issued, by axis."""

    tp: int
    dp: int
    rank: int
    tp_rank: int
    dp_rank: int
    device: torch.device
    tp_group: object = None
    dp_group: object = None
    member: bool = True
    collectives: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def _axis(self, axis: str):
        return (self.tp, self.tp_group) if axis == "tp" else (self.dp, self.dp_group)

    def _count(self, what: str) -> None:
        self.collectives[what] = self.collectives.get(what, 0) + 1

    def all_reduce(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """The sum of ``t`` over the ranks of this rank's ``axis`` group (the
        TPU package's ``psum``); ``t`` may be reduced in place."""
        n, group = self._axis(axis)
        if n == 1:
            return t
        self._count(f"all_reduce:{axis}")
        t = t.contiguous()
        dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1, axis: str = "tp") -> torch.Tensor:
        """The ranks' ``t`` of this rank's ``axis`` group concatenated along
        ``dim`` in rank order (``jax.lax.all_gather(..., tiled=True)``)."""
        n, group = self._axis(axis)
        if n == 1:
            return t
        self._count(f"all_gather:{axis}")
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)


def device_for_rank(rank: int, device) -> torch.device:
    """``device`` as given, or the card of this rank's index on its host
    (``distributed.local_rank`` in the process group); a rank whose card is
    missing raises."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device is available for {device}")
        return device
    local = local_rank(rank, dist.get_world_size() if dist.is_initialized() else 1)
    cards = torch.cuda.device_count()
    if local >= cards:
        raise RuntimeError(f"rank {rank} needs card {local}; this machine has {cards} "
                           "(pass device='cpu' to run the ranks on the CPU)")
    return torch.device("cuda", local)


def make_mesh(tp: Optional[int] = None, dp: int = 1, device=None) -> Mesh:
    """This rank's place in a (dp, tp) mesh over the ranks of the process
    group (``torch.distributed`` initialized; a lone process makes a 1 x 1
    mesh). tp defaults to the ranks / dp. Ranks are ordered tp-major, as the
    TPU package orders devices host-major: rank r sits at (r // tp, r % tp),
    so a tp group is consecutive ranks. A group of more ranks than dp * tp
    leaves the rest out (``member`` False); fewer raise. Every rank must call
    it, in the same order (the groups are made collectively). ``device``: the
    rank's device (None: its card, ``cuda:<local rank>``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp = tp or world // dp
    if dp * tp > world:
        raise ValueError(f"a mesh of dp={dp} x tp={tp} needs {dp * tp} ranks; the process group "
                         f"has {world}")
    tp_group = dp_group = None
    if dist.is_initialized() and world > 1:
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if rank // tp == i:
                tp_group = g
        for j in range(tp):
            g = dist.new_group([i * tp + j for i in range(dp)])
            if rank % tp == j and rank < dp * tp:
                dp_group = g
    member = rank < dp * tp
    return Mesh(tp=tp, dp=dp, rank=rank, tp_rank=rank % tp if member else 0,
                dp_rank=rank // tp if member else 0, device=device_for_rank(rank, device),
                tp_group=tp_group, dp_group=dp_group, member=member)


def _check_div(name: str, dim: int, parts: int):
    if dim % parts != 0:
        raise ValueError(
            f"{name}: dimension {dim} not divisible by tp={parts}; "
            f"pad the model dims or lower tp")


def _part(t: Optional[torch.Tensor], dim: int, parts: int, index: int, device):
    """Slice ``index`` of ``parts`` of t along ``dim``, contiguous on device."""
    if t is None:
        return None
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).to(device).contiguous()


def _on(t: Optional[torch.Tensor], device):
    return None if t is None else t.to(device)


def shard_packed_linear(lin: PackedLinear, mesh: Mesh, mode: str) -> PackedLinear:
    """This rank's slice of one PackedLinear with column or row TP sharding,
    on the mesh's device, its dims the slice's (out_features for col,
    in_features for row). A shard is not a save path: the host wire buffers
    are dropped."""
    tp, r, dev = mesh.tp, mesh.tp_rank, mesh.device
    if mode == "col":
        _check_div("qweight.N", lin.qweight.shape[1], tp)
        _check_div("scales.N", lin.scales.shape[1], tp)
        return dataclasses.replace(
            lin, qweight=_part(lin.qweight, 1, tp, r, dev),
            scales=_part(lin.scales, 1, tp, r, dev), zeros=_part(lin.zeros, 1, tp, r, dev),
            perm=_on(lin.perm, dev), bias=_part(lin.bias, 0, tp, r, dev),
            out_features=lin.out_features // tp, qzeros=None, g_idx=None, scales_wire=None)
    if mode == "row":
        # keep 32-value packs (and 3-bit 3-word packs) whole on each shard
        _check_div("qweight.K", lin.in_features, tp * 32)
        # the group dim G may be < tp (small models, groupsize -1): replicate it
        split = lin.scales.shape[0] % tp == 0
        group = (lambda t: _part(t, 0, tp, r, dev)) if split else (lambda t: _on(t, dev))
        return dataclasses.replace(
            lin, qweight=_part(lin.qweight, 0, tp, r, dev), scales=group(lin.scales),
            zeros=group(lin.zeros), perm=_on(lin.perm, dev), bias=_on(lin.bias, dev),
            in_features=lin.in_features // tp, qzeros=None, g_idx=None, scales_wire=None)
    raise ValueError(mode)


def shard_cache(cache, mesh: Mesh):
    """This rank's part of a KV cache or block pool split over kv heads: a
    tensor (..., Hkv, D), a list of them, or a runner's ``KVCache`` (its k
    and v lists). Where Hkv % tp != 0 the cache is replicated, as in the TPU
    package."""
    if isinstance(cache, (list, tuple)):
        return type(cache)(shard_cache(c, mesh) for c in cache)
    if isinstance(cache, torch.Tensor):
        if cache.shape[-2] % mesh.tp:
            return cache.to(mesh.device)
        return _part(cache, cache.ndim - 2, mesh.tp, mesh.tp_rank, mesh.device)
    return dataclasses.replace(cache, k=shard_cache(cache.k, mesh), v=shard_cache(cache.v, mesh))
