"""The port's tensor-parallel runner held against the TPU package's
shard_map runner (tests/test_tp_model.py's cases and tolerances: fp32,
greedy tokens exact, logits atol 3e-4 / rtol 1e-3).

The port runs one process per rank: one group of 4 gloo ranks on the CPU,
spawned once for the module (a ``file://`` rendezvous in a temporary
directory), runs every case, each on a mesh of its own (ranks outside a
mesh skip its case); the TPU package runs the same weights on the
conftest's virtual CPU devices meanwhile. Cases: every arch at tp 4,
act-order row-parallel weights (with the greedy decode scan), GQA at tp 2,
the K-padded row-parallel down_proj, dp x tp = 2 x 2, and the TPU package's
unrolled-layers runner (the port has one form, a layer loop)."""

import threading

import numpy as np
import pytest

from gptq_for_llama_tpu_torch.parallel import distributed

import torch_tp_workers
from torch_tp import CFGS, GQA, K_PADDED, jax_run_steps, jax_runner, wire_tree

IDS2 = (np.arange(2 * 16) % 128).reshape(2, 16)
IDS1 = (np.arange(16) % 128)[None]
# name -> (cfg, tree kwargs, tp, dp, ids, decode-scan steps)
CASES = {
    "llama": (CFGS["llama"], {}, 4, 1, IDS2, 0),
    "opt": (CFGS["opt"], {}, 4, 1, IDS2, 0),
    "neox": (CFGS["neox"], {}, 4, 1, IDS2, 0),
    "gpt2": (CFGS["gpt2"], {}, 4, 1, IDS2, 0),
    "act_order": (CFGS["llama"], dict(act_order=True), 4, 1, IDS1, 5),
    "gqa": (GQA, {}, 2, 1, IDS1, 0),
    "k_padded": (K_PADDED, {}, 4, 1, IDS1, 0),
    "dp2_tp2": (CFGS["llama"], {}, 2, 2, IDS2, 5),
}


def _tree(name):
    cfg, kw = CASES[name][:2]
    return wire_tree(cfg, seed=len(name), **kw)


@pytest.fixture(scope="module")
def port():
    """Every case through the port's TP runner in one spawned group of 4
    ranks: {rank: {case: outputs}}."""
    cases = {name: {"cfg": cfg, "tree": _tree(name), "tp": tp, "dp": dp, "ids": ids,
                    "scan": scan}
             for name, (cfg, _, tp, dp, ids, scan) in CASES.items()}
    out = {}
    worker = threading.Thread(target=lambda: out.update(enumerate(distributed.spawn(
        torch_tp_workers.runner_cases, 4, args=(cases,), backend="gloo", threads=1))))
    worker.start()
    yield lambda: (worker.join(), out)[1]
    worker.join()


_JAX = {}


def _jax(name, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _JAX:
        cfg, _, tp, dp, ids, scan = CASES[name]
        _JAX[key] = jax_run_steps(jax_runner(cfg, _tree(name), tp, dp, ids.shape[0], **kw), ids,
                                  scan=scan)
    return _JAX[key]


def _hold(got, want):
    np.testing.assert_array_equal(got["toks"], want["toks"])
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=3e-4, rtol=1e-3)
    if "scan" in want:
        np.testing.assert_array_equal(got["scan"], want["scan"])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_runner_matches_jax_shard_map(port, name):
    want = _jax(name)   # the TPU package's run overlaps the ranks'
    ranks = port()
    _hold(ranks[0][name], want)
    cfg, _, tp, dp, _, _ = CASES[name]
    for r in range(tp * dp):   # every rank of the mesh returns the same outputs
        np.testing.assert_array_equal(ranks[r][name]["toks"], ranks[0][name]["toks"])
    # two all-reduces a layer a forward over tp (o_proj, down_proj), one
    # vocab all-gather a forward, and the down_proj's activation all-gather
    # where its shards are padded or act-order
    got = ranks[0][name]
    forwards = sum(got["forwards"].values())
    assert got["collectives"]["all_reduce:tp"] == 2 * cfg["num_layers"] * forwards
    assert got["collectives"]["all_gather:tp"] >= forwards


def test_tp_runner_matches_jax_unrolled_layers(port):
    """The TPU package's unrolled-layers TP runner (its real-pod form)
    gives what the port's one form gives."""
    _hold(port()[0]["llama"], _jax("llama", unroll_layers=True))
