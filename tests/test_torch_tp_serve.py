"""The port's tensor-parallel serving engine held against the TPU package's
shard_map engine (tests/test_tp_model.py:165-200: 3 greedy requests, 2
slots, tp 4, fp32 on the CPU): dense, multi-step spans, paged, chunked
prefill and the fold form against its dense engine (as that test holds its
span, paged, unrolled and chunked engines to one run), an fp8-e4m3 cache
(dense and paged) against its engine over fp8, and its unrolled-layers
engine against the port's dense one. Tokens must be equal.

One spawned group of 4 gloo ranks runs every port mode (each rank its
shards, caches and pools split over kv heads, the same block tables)."""

import threading

import numpy as np
import jax.numpy as jnp
import pytest

from gptq_for_llama_tpu_torch.parallel import distributed

import torch_tp_workers
from torch_tp import CFGS, jax_engine, wire_tree

PROMPTS = [np.array([1, 2, 3]), np.array([9, 8, 7, 6, 5]), np.array([4])]
TP = 4
# port mode -> (the port engine's kwargs, the TPU package engine's kwargs)
MODES = {
    "dense": ({}, {}),
    "span": (dict(decode_span=4), {}),
    "paged": (dict(paged=True, block_size=8), {}),
    "chunked": (dict(prefill_chunk=8), {}),
    "fold": (dict(cache_impl="fold"), {}),
    "fp8": (dict(kv_dtype="float8_e4m3fn"), dict(kv_dtype=jnp.float8_e4m3fn)),
    "paged_fp8": (dict(paged=True, block_size=8, kv_dtype="float8_e4m3fn"),
                  dict(kv_dtype=jnp.float8_e4m3fn)),
}


@pytest.fixture(scope="module")
def case():
    cfg = CFGS["llama"]
    return {"cfg": cfg, "tree": wire_tree(cfg, seed=11), "prompts": PROMPTS}


@pytest.fixture(scope="module")
def port(case):
    """Every mode through the port's TP engine in one group of 4 ranks."""
    out = {}
    modes = {name: kw for name, (kw, _) in MODES.items()}
    worker = threading.Thread(target=lambda: out.update(enumerate(distributed.spawn(
        torch_tp_workers.engine_cases, TP, args=(case, modes, TP), backend="gloo",
        threads=1))))
    worker.start()
    yield lambda: (worker.join(), out)[1]
    worker.join()


_JAX = {}


def _jax(case, **kw):
    key = tuple(sorted((k, str(v)) for k, v in kw.items()))
    if key not in _JAX:
        _JAX[key] = jax_engine(case["cfg"], case["tree"], PROMPTS, TP, **kw)
    return _JAX[key]


def _hold(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=f"request {uid}")


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_engine_matches_jax_shard_map(port, case, mode):
    want = _jax(case, **MODES[mode][1])
    ranks = port()
    _hold(ranks[0][mode]["tokens"], want)
    for r in range(1, TP):   # every rank samples the same tokens
        _hold(ranks[r][mode]["tokens"], ranks[0][mode]["tokens"])
    assert ranks[0][mode]["forwards"]["decode"] > 0


def test_tp_engine_matches_jax_unrolled_layers(port, case):
    _hold(port()[0]["dense"]["tokens"], _jax(case, unroll_layers=True))
