"""The port's tensor-parallel weight preparation held against the TPU
package's, in one process: ``tp_rules`` and its error, ``local_config``,
``prepare_tp_params`` trees byte for byte (every arch, act-order row maps,
the K-padded row-parallel case, GPT-2's q/k/v regrouping, MLP shards whose
width is not a multiple of 128 and get padded), and each rank's shards
against the TPU package's tree sliced as its ``step_specs`` slice it.

The TPU package stores packed weights in its tiled row layout; its
``from_tpu_layout`` turns them back into the wire row order the port keeps,
so the comparison is of the same bytes."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.parallel import tp_model as jtp
from gptq_for_llama_tpu.parallel.sharding import TP_RULES as JAX_TP_RULES
from gptq_for_llama_tpu.parallel.sharding import tp_rules as jax_tp_rules
from gptq_for_llama_tpu.quant import packing as jpacking
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.parallel import tp_model
from gptq_for_llama_tpu_torch.parallel.sharding import TP_RULES, Mesh, tp_rules

from torch_tp import CFGS, GQA, K_PADDED, jax_config, jax_tree, wire_tree

# (cfg, tp, tree kwargs): every arch at tp 4 (MLP shards of 64 columns,
# padded to 128), act-order, GQA at tp 2, the K-padded down_proj at tp 4
CASES = {
    "llama": (CFGS["llama"], 4, {}),
    "opt": (CFGS["opt"], 4, {}),
    "neox": (CFGS["neox"], 4, {}),
    "gpt2": (CFGS["gpt2"], 4, {}),
    "act_order": (CFGS["llama"], 4, dict(act_order=True)),
    "gqa": (GQA, 2, {}),
    "k_padded": (K_PADDED, 4, {}),
    "k_padded_act_order": (K_PADDED, 2, dict(act_order=True)),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bytes(got, want, what):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), what


def _jax_rows(jlin, qweight=None):
    """A TPU-package packed weight's rows in the wire row order."""
    qw = np.asarray(jlin.qweight if qweight is None else qweight)
    if jlin.layout == "tpu":
        qw = jpacking.from_tpu_layout(qw, jlin.bits, jlin.groupsize)
    return qw


def _hold(got, want, path=""):
    """Every leaf of the port's tree against the TPU package's, byte for byte."""
    if isinstance(want, JaxPackedLinear):
        assert isinstance(got, PackedLinear), path
        assert (got.bits, got.groupsize) == (want.bits, want.groupsize), path
        assert (got.in_features, got.out_features) == (want.in_features, want.out_features), path
        _same_bytes(got.qweight, _jax_rows(want).astype(np.int32), path + ".qweight")
        for f in ("scales", "zeros", "bias"):
            if getattr(want, f) is None:
                assert getattr(got, f) is None, path + f
            else:
                _same_bytes(getattr(got, f), getattr(want, f), f"{path}.{f}")
        if want.perm is None:
            assert got.perm is None, path
        else:
            np.testing.assert_array_equal(_np(got.perm), np.asarray(want.perm), err_msg=path)
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _hold(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f"{path}[{i}]")
        return
    _same_bytes(got, want, path)


def _prepared(name):
    cfg, tp, kw = CASES[name]
    tree = wire_tree(cfg, seed=len(name), **kw)
    jp = jtp.prepare_tp_params(cfg["arch"], jax_tree(tree), tp)
    return cfg, tp, params_from_jax(tree, "cpu", torch.float32), jp


def test_tp_rules_and_local_config_match_jax():
    assert TP_RULES == JAX_TP_RULES
    for arch in JAX_TP_RULES:
        assert tp_rules(arch) == jax_tp_rules(arch)
    with pytest.raises(ValueError) as got:
        tp_rules("bloom")
    with pytest.raises(ValueError) as want:
        jax_tp_rules("bloom")
    assert str(got.value) == str(want.value)
    for cfg in (CFGS["llama"], GQA):
        for tp in (1, 2, 3, 4):
            try:
                want = dataclasses.asdict(jtp.local_config(jax_config(cfg), tp))
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    tp_model.local_config(ModelConfig(**cfg), tp)
                continue
            got = dataclasses.asdict(tp_model.local_config(ModelConfig(**cfg), tp))
            assert got == {k: v for k, v in want.items() if k in got}


@pytest.mark.parametrize("name", list(CASES))
def test_prepare_tp_params_match_jax_byte_for_byte(name):
    """The prepared trees: row maps (act-order, the padded gather of the MLP
    shards), K padding of row-parallel weights, zero-padded MLP shards,
    GPT-2's regrouped c_attn; every other leaf untouched."""
    cfg, tp, params, jp = _prepared(name)
    got = tp_model.prepare_tp_params(cfg["arch"], params, tp)
    _hold(got, jax.tree_util.tree_map(lambda x: x, jp, is_leaf=lambda x: isinstance(
        x, JaxPackedLinear)))
    down = "mlp.c_proj" if cfg["arch"] == "gpt2" else {
        "llama": "mlp.down_proj", "opt": "fc2", "neox": "mlp.dense_4h_to_h"}[cfg["arch"]]
    lin = got["layers"][0]
    for part in down.split("."):
        lin = lin[part]
    # 64 or 120 columns a shard are padded, so a row map; GQA's 128 are not
    assert (lin.perm is None) == (name == "gqa")
    if name.startswith("k_padded"):
        assert lin.qweight.shape[0] * 32 // lin.bits == 512 > lin.in_features == 480


def _jax_slice(x, spec, tp, rank):
    x = np.asarray(x)
    for dim, axis in enumerate(spec):
        if axis == "tp":
            size = x.shape[dim] // tp
            x = np.take(x, np.arange(rank * size, (rank + 1) * size), axis=dim)
    return x


def _jax_local(tree, spec, tp, rank):
    """A TPU-package tree with its leaves as the rank's shard holds them."""
    if isinstance(tree, JaxPackedLinear):
        return dataclasses.replace(tree, **{
            f: _jax_slice(getattr(tree, f), getattr(spec, f), tp, rank)
            for f in ("qweight", "scales", "zeros", "perm", "bias")
            if getattr(tree, f) is not None})
    if isinstance(tree, dict):
        return {k: _jax_local(v, spec[k], tp, rank) for k, v in tree.items()}
    return _jax_slice(tree, spec, tp, rank)


def _hold_shard(got, want, spec, tp, rank, path):
    """This rank's shard of one linear against the TPU package's leaf
    sliced by its PartitionSpec (and localized: col out_features / tp, row
    in_features = its device rows)."""
    if isinstance(want, JaxPackedLinear):
        rows = _jax_slice(want.qweight, spec.qweight, tp, rank)
        _same_bytes(got.qweight, _jax_rows(want, rows).astype(np.int32), path + ".qweight")
        for f in ("scales", "zeros", "bias", "perm"):
            w = getattr(want, f)
            if w is None:
                assert getattr(got, f) is None, path + f
                continue
            sl = _jax_slice(w, getattr(spec, f), tp, rank)
            if f == "perm":
                np.testing.assert_array_equal(_np(got.perm), sl, err_msg=path)
            else:
                _same_bytes(getattr(got, f), sl, f"{path}.{f}")
        return
    if isinstance(want, dict):
        for k in want:
            _hold_shard(got[k], want[k], spec[k], tp, rank, f"{path}.{k}")
        return
    _same_bytes(got, _jax_slice(want, spec, tp, rank), path)


@pytest.mark.parametrize("name", ["llama", "gpt2", "act_order", "k_padded"])
def test_each_ranks_shards_match_jax_step_specs(name):
    """Each rank's ``shard_params`` against the TPU package's prepared tree
    sliced by ``step_specs`` (its shard_map in_specs), localized as
    ``localize_step_params`` does."""
    cfg, tp, params, jp = _prepared(name)
    sp = {"statics": {k: v for k, v in jp.items() if k != "layers"}, "stacked": None,
          "layers": jp["layers"]}
    specs = jtp.step_specs(cfg["arch"], sp)
    prepared = tp_model.prepare_tp_params(cfg["arch"], params, tp)
    for rank in range(tp):
        mesh = Mesh(tp=tp, dp=1, rank=rank, tp_rank=rank, dp_rank=0,
                    device=torch.device("cpu"))
        got = tp_model.shard_params(cfg["arch"], prepared, mesh)
        for key, spec in specs["statics"].items():
            _hold_shard(got[key], sp["statics"][key], spec, tp, rank, key)
        for li, (lp, spec) in enumerate(zip(sp["layers"], specs["layers"])):
            _hold_shard(got["layers"][li], lp, spec, tp, rank, f"layers[{li}]")
            # the local dims: the TPU package's localize_layer_aux over its
            # leaves as a shard holds them
            jl = jtp.localize_layer_aux(cfg["arch"], _jax_local(lp, spec, tp, rank), tp)
            for dotted in TP_RULES[cfg["arch"]]:
                g, w = got["layers"][li], jl
                for part in dotted.split("."):
                    g, w = g[part], w[part]
                assert (g.in_features, g.out_features) == (w.in_features, w.out_features)


@pytest.mark.parametrize("hkv", [4, 3])
def test_shard_cache_matches_jax_per_rank(hkv):
    """A runner's KV cache split over kv heads at tp 2: each rank's part
    equals the TPU package's ``shard_cache`` shard on that rank's device;
    3 kv heads do not split, and both packages replicate."""
    from gptq_for_llama_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from gptq_for_llama_tpu.parallel.sharding import shard_cache as jax_shard_cache
    from gptq_for_llama_tpu.runtime.runner import KVCache as JaxKVCache
    from gptq_for_llama_tpu_torch.parallel.sharding import shard_cache
    from gptq_for_llama_tpu_torch.runtime.runner import KVCache
    rng = np.random.RandomState(hkv)
    k, v = (rng.standard_normal((2, 2, 8, hkv, 4)).astype(np.float32) for _ in range(2))
    mesh = jax_make_mesh(tp=2, dp=1)
    jc = jax_shard_cache(JaxKVCache(jax.numpy.asarray(k), jax.numpy.asarray(v),
                                    jax.numpy.zeros((), jax.numpy.int32)), mesh)
    for rank, dev in enumerate(mesh.devices[0]):
        local = shard_cache(KVCache([torch.as_tensor(a) for a in k],
                                    [torch.as_tensor(a) for a in v], 0),
                            Mesh(tp=2, dp=1, rank=rank, tp_rank=rank, dp_rank=0,
                                 device=torch.device("cpu")))
        for got, arr in ((local.k, jc.k), (local.v, jc.v)):
            want = next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(np.stack([t.numpy() for t in got]), want)
