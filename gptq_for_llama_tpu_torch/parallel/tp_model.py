"""Whole-model tensor parallelism: the kernels on each rank's local shards.

Counterpart of ``gptq_for_llama_tpu/parallel/tp_model.py``. The TPU package
runs the whole model step inside one ``shard_map`` region; the port runs the
same step in every rank's process, over that rank's shards:

- every rank executes the step on its LOCAL parameters with a LOCAL
  ModelConfig (num_heads / tp, num_kv_heads / tp), so the CUDA kernels run
  unmodified at the shard's widths;
- the row-parallel projections of each layer (o_proj/down_proj and their
  opt/neox/gpt2 counterparts) all-reduce over the tp group
  (``models/common.row_parallel_apply``);
- the KV cache is split over kv heads, the lm_head over the vocabulary (its
  logits all-gathered); the batch is split over the dp axis.

Act-order / K-padded row-parallel weights: the device row order of a packed
row-parallel weight is group-sorted, and K-padded to the TPU package's
device length (``k_padded``), which no longer matches the activation layout
once split. ``prepare_tp_params`` rewrites such a linear's ``perm`` into a
device-row index map of length k_padded; each rank all-gathers the (small)
activation and takes its own rows (pad rows read a clamped index; their
codes and zero-points are 0 and their scales 1, so they add exactly 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sharding import Mesh, _on, _part, tp_rules
from ..ops.linear import PackedLinear

__all__ = ["local_config", "prepare_tp_params", "shard_params", "localize_layer_aux",
           "localize_step_params", "k_padded"]


def local_config(cfg, tp: int):
    """The per-shard view of the model: heads and ffn width divided by tp."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp)


# ---------------------------------------------------------------------------
# host-side preparation
# ---------------------------------------------------------------------------

def k_padded(lin: PackedLinear) -> int:
    """The contraction length the TPU package stores this linear at: K padded
    with zero-code groups (scale 1, zero 0) to a multiple of 8 groups where
    its tiled layout applies and that adds at most 1/8 of K
    (``gptq_for_llama_tpu/ops/linear.py`` ``from_wire``); K elsewhere. The
    port keeps K at load and pads a row-parallel linear here, so that its
    groups split over tp as the TPU package's do (LLaMA-7B's down_proj: 86
    groups of 128, 88 padded, 22 a shard at tp = 4)."""
    k, gs, bits = lin.in_features, lin.groupsize, lin.bits
    if gs <= 0 or k % gs or bits not in (2, 4, 8) or gs % (32 // bits):
        return k
    cand = -(-k // (8 * gs)) * (8 * gs)
    return cand if (k // gs) % 8 and (cand - k) * 8 <= k else k


def _pad_k(lin: PackedLinear, kp: int) -> PackedLinear:
    """lin with kp - k zero-code rows (whole packed words and groups) after
    its sorted rows, their groups scale 1, zero 0."""
    k = lin.in_features
    if kp == k:
        return lin
    rows = (kp - k) * lin.bits // 32
    gp = (kp - k) // lin.groupsize
    n = lin.out_features
    qw = torch.cat([lin.qweight, lin.qweight.new_zeros((rows, n))])
    scales = torch.cat([lin.scales, lin.scales.new_ones((gp, n))])
    zeros = torch.cat([lin.zeros, lin.zeros.new_zeros((gp, n))])
    return dataclasses.replace(lin, qweight=qw, scales=scales, zeros=zeros)


def _prepare_row_linear(lin: PackedLinear, tp: int,
                        act_map: np.ndarray | None = None) -> PackedLinear:
    """Make a row-parallel PackedLinear shardable on its device-row axis.

    act_map: optional (in_features,) map from original activation index to
    its position in the GATHERED activation when the upstream col-parallel
    producer was shard-padded (_pad_col_shards): the all-gathered x then has
    zero pad entries at each shard's tail."""
    k, kp = lin.in_features, k_padded(lin)
    g = lin.scales.shape[0] + (kp - k) // lin.groupsize
    rows = kp * lin.bits // 32
    if (rows % tp) or (g % tp):
        raise ValueError(
            f"row-parallel: packed rows {rows} and groups {g} "
            f"must divide tp={tp}")
    if lin.perm is None and kp == k and act_map is None:
        return lin  # natural order, no padding: direct row sharding
    base = lin.perm.cpu().numpy() if lin.perm is not None else np.arange(k)
    if act_map is not None:
        base = act_map[base]
    pad_idx = base[-1] if k else 0
    rowmap = np.concatenate([base, np.full(kp - k, pad_idx)]).astype(np.int64)  # pad: clamped
    return dataclasses.replace(_pad_k(lin, kp),
                               perm=torch.as_tensor(rowmap, device=lin.qweight.device))


# per-arch MLP col producers -> row consumer: the one col->row pair whose col
# output is consumed ONLY through the row linear's gather, so its N can be
# shard-padded to the lane width (the attention q/k/v cols must NOT be
# padded: their widths are reshaped to local heads * head_dim)
_MLP_PAIRS = {
    "llama": (("mlp.gate_proj", "mlp.up_proj"), "mlp.down_proj"),
    "opt": (("fc1",), "fc2"),
    "neox": (("mlp.dense_h_to_4h",), "mlp.dense_4h_to_h"),
    "gpt2": (("mlp.c_fc",), "mlp.c_proj"),
}

# fused attention projections in [all Q | all K | all V] BLOCK column layout
# (not per-head interleaved like neox): contiguous col-sharding would split
# q/k/v across shards, so prepare_tp_params regroups their columns into
# per-shard [Q_i|K_i|V_i] groups first (see _relayout_qkv_blocks)
_QKV_BLOCK_FUSED = {"gpt2": "attn.c_attn"}

# the TPU package's lane width: a shard's N is padded to a multiple of it.
# Kept so that the prepared trees are the TPU package's, byte for byte (the
# port's kernels take any N that is a multiple of 8).
_LANE = 128


def _pad_cols(a: torch.Tensor, tp: int, n_local: int, pad: int) -> torch.Tensor:
    """(rows, tp * n_local) -> (rows, tp * (n_local + pad)): each shard's
    columns followed by ``pad`` zero columns."""
    lead = a.shape[:-1]
    a3 = a.reshape(*lead, tp, n_local)
    a3 = torch.cat([a3, a3.new_zeros((*lead, tp, pad))], dim=-1)
    return a3.reshape(*lead, tp * (n_local + pad))


def _pad_col_shards(lin: PackedLinear, tp: int, pad: int) -> PackedLinear:
    """Zero-pad each TP shard of a col-parallel packed linear's N axis.

    The global N axis is viewed as tp chunks of n_local; each chunk grows by
    ``pad`` zero columns (scales = 0 AND zeros = 0, so the dequantized weight
    is exactly 0 and the column adds exactly nothing), keeping every shard's
    local N a multiple of the lane width. Shard-local params are not a save
    path: the wire buffers are dropped."""
    n = lin.out_features
    n_local = n // tp
    return dataclasses.replace(
        lin, qweight=_pad_cols(lin.qweight, tp, n_local, pad),
        scales=_pad_cols(lin.scales, tp, n_local, pad),
        zeros=_pad_cols(lin.zeros, tp, n_local, pad),
        bias=None if lin.bias is None else _pad_cols(lin.bias, tp, n_local, pad),
        out_features=tp * (n_local + pad),
        qzeros=None, g_idx=None, scales_wire=None)


def _relayout_qkv_blocks(lin, tp: int):
    """[all Q | all K | all V] fused projection -> per-shard [Q_i|K_i|V_i]
    column groups, so contiguous col-sharding hands shard i its own whole
    q/k/v head blocks and the LOCAL forward's split-by-thirds stays right
    (gpt2's c_attn). A pure output-column permutation, applied once at load.
    Shard-local layout is not a save path: the wire buffers are dropped."""
    n = lin.out_features if isinstance(lin, PackedLinear) else lin["kernel"].shape[1]
    if n % (3 * tp):
        raise ValueError(f"fused qkv out_features {n} must divide 3*tp={3 * tp}")
    h = n // 3
    hl = h // tp
    perm = np.concatenate([np.arange(s * h + i * hl, s * h + (i + 1) * hl)
                           for i in range(tp) for s in range(3)])
    if isinstance(lin, PackedLinear):
        idx = torch.as_tensor(perm, device=lin.qweight.device)
        return dataclasses.replace(
            lin, qweight=lin.qweight[:, idx], scales=lin.scales[:, idx],
            zeros=lin.zeros[:, idx],
            bias=None if lin.bias is None else lin.bias[idx],
            qzeros=None, g_idx=None, scales_wire=None)
    idx = torch.as_tensor(perm, device=lin["kernel"].device)
    out = {"kernel": lin["kernel"][:, idx]}
    if lin.get("bias") is not None:
        out["bias"] = lin["bias"][idx]
    return out


def _copy_tree(tree):
    """The dicts and lists of ``tree`` new, its leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _walk_linears(arch_name: str, layer_tree: dict, fn, skip=()) -> dict:
    """Apply fn(lin, mode) to every TP-ruled linear of one layer tree (copy)."""
    from ..engine.quantize import get_path, set_path  # cycle-free late import

    new = _copy_tree(layer_tree)
    for name, mode in tp_rules(arch_name).items():
        if name in skip:
            continue
        try:
            lin = get_path(new, name)
        except (KeyError, TypeError):
            continue
        set_path(new, name, fn(lin, mode))
    return new


def prepare_tp_params(arch_name: str, params: dict, tp: int) -> dict:
    """Host-side transform before each rank takes its shards (``shard_params``).

    Returns a new params tree whose row-parallel packed linears carry a
    device-row index map (see the module docstring), K-padded as the TPU
    package stores them, and whose MLP col-parallel packed linears are
    shard-padded to the 128 lane width when n / tp is not a multiple of it
    (7B at tp = 4: intermediate 11008 -> 2752 a shard, padded to 2816; the
    padded gather's layout is composed into the downstream row linear's
    index map). Fused q/k/v projections (``fuse_qkv``) are refused: TP_RULES
    shard q/k/v separately; GPT-2's ``c_attn`` is regrouped per shard."""
    from ..engine.quantize import get_path, set_path

    def prep(lin, mode):
        if isinstance(lin, PackedLinear) and mode == "row":
            return _prepare_row_linear(lin, tp)
        return lin

    cols, row_name = _MLP_PAIRS.get(arch_name, ((), None))
    out = {k: v for k, v in params.items()}
    new_layers = []
    for lp in params["layers"]:
        if "self_attn" in lp and "qkv_proj" in lp.get("self_attn", {}):
            raise ValueError("shard_map TP requires unfused q/k/v projections")
        # MLP shard-padding first (its row consumer then needs an act_map,
        # so the generic row prep must skip that one name)
        act_map = None
        new = _copy_tree(lp)
        qkv_name = _QKV_BLOCK_FUSED.get(arch_name)
        if qkv_name is not None:
            try:
                qkv_lin = get_path(new, qkv_name)
            except (KeyError, TypeError):
                qkv_lin = None
            if qkv_lin is not None:
                set_path(new, qkv_name, _relayout_qkv_blocks(qkv_lin, tp))
        try:
            col_lins = [get_path(new, c) for c in cols]
            row_lin = get_path(new, row_name) if row_name else None
        except (KeyError, TypeError):
            col_lins, row_lin = [], None
        if (col_lins and isinstance(row_lin, PackedLinear)
                and all(isinstance(c, PackedLinear) for c in col_lins)):
            n = col_lins[0].out_features
            if n % tp:
                raise ValueError(
                    f"col-parallel: out_features {n} must divide tp={tp}")
            n_local = n // tp
            pad = (-n_local) % _LANE
            if pad:
                for cname, c in zip(cols, col_lins):
                    set_path(new, cname, _pad_col_shards(c, tp, pad))
                j = np.arange(n)
                act_map = ((j // n_local) * (n_local + pad) + (j % n_local)).astype(np.int64)
            set_path(new, row_name,
                     _prepare_row_linear(row_lin, tp, act_map=act_map))
            new_layers.append(_walk_linears(arch_name, new, prep, skip=(row_name,)))
        else:
            new_layers.append(_walk_linears(arch_name, new, prep))
    out["layers"] = new_layers
    return out


# ---------------------------------------------------------------------------
# each rank's shards
# ---------------------------------------------------------------------------

def _slice_linear(lin, mode: str, mesh: Mesh):
    """This rank's tensors of one prepared linear, as the TPU package's
    ``step_specs`` split them: col -> N (bias too; perm replicated), row ->
    packed rows, groups and the row map (bias replicated). The dims stay the
    global ones until ``localize_layer_aux``."""
    def part(t, dim):
        return _part(t, dim, mesh.tp, mesh.tp_rank, mesh.device)

    if isinstance(lin, PackedLinear):
        if mode == "col":
            return dataclasses.replace(
                lin, qweight=part(lin.qweight, 1), scales=part(lin.scales, 1),
                zeros=part(lin.zeros, 1), perm=_on(lin.perm, mesh.device),
                bias=part(lin.bias, 0))
        return dataclasses.replace(
            lin, qweight=part(lin.qweight, 0), scales=part(lin.scales, 0),
            zeros=part(lin.zeros, 0), perm=part(lin.perm, 0), bias=_on(lin.bias, mesh.device))
    out = {"kernel": part(lin["kernel"], 1 if mode == "col" else 0)}
    if lin.get("bias") is not None:
        out["bias"] = part(lin["bias"], 0) if mode == "col" else _on(lin["bias"], mesh.device)
    return out


def localize_layer_aux(arch_name: str, tree: dict, tp: int) -> dict:
    """PackedLinear leaves holding LOCAL shards but global dims: rewrite col
    out_features and row in_features to the per-shard values (the tensor
    shapes are authoritative)."""
    def fix(lin, mode):
        if not isinstance(lin, PackedLinear):
            return lin
        if mode == "col":
            return dataclasses.replace(lin, out_features=lin.out_features // tp)
        # row: the local contraction is the local device rows (the row map
        # and padding are row_parallel_apply's)
        return dataclasses.replace(lin, in_features=lin.qweight.shape[-2] * 32 // lin.bits)

    return _walk_linears(arch_name, tree, fix)


def localize_step_params(arch_name: str, params: dict, tp: int) -> dict:
    """``localize_layer_aux`` over every layer, and a PACKED lm_head /
    embed_out's out_features to the local vocabulary."""
    out = dict(params)
    out["layers"] = [localize_layer_aux(arch_name, lp, tp) for lp in params["layers"]]
    for key in ("lm_head", "embed_out"):
        lin = out.get(key)
        if isinstance(lin, PackedLinear):
            out[key] = dataclasses.replace(lin, out_features=lin.out_features // tp)
    return out


def shard_params(arch_name: str, params: dict, mesh: Mesh) -> dict:
    """This rank's slice of a ``prepare_tp_params`` tree, on the mesh's
    device, with local dims: what the TP runner and engine compute with.
    Norms and embeddings are replicated, lm_head / embed_out split over the
    vocabulary, the layers' linears as TP_RULES says."""
    def leaf(t):
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        if isinstance(t, list):
            return [leaf(v) for v in t]
        return t.to(mesh.device) if isinstance(t, torch.Tensor) else t

    out = {}
    for key, val in params.items():
        if key == "layers":
            continue
        if key in ("lm_head", "embed_out"):
            n = val.out_features if isinstance(val, PackedLinear) else val["kernel"].shape[1]
            if n % mesh.tp:
                raise ValueError(f"{key}: vocabulary {n} not divisible by tp={mesh.tp}")
            out[key] = _slice_linear(val, "col", mesh)
        else:
            out[key] = leaf(val)
    layers = []
    for lp in params["layers"]:
        sliced = _walk_linears(arch_name, lp, lambda lin, mode: _slice_linear(lin, mode, mesh))
        layers.append(leaf(sliced))
    out["layers"] = layers
    return localize_step_params(arch_name, out, mesh.tp)
