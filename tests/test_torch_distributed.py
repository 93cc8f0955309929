"""The port's multi-process scaffolding (parallel/distributed.py) and its
data-parallel calibration, the counterpart of tests/test_multihost.py:
``initialize`` gated by the environment as in the TPU package, a real
two-process group (meshes, collectives, ``put_global``), and quantization
with calibration split over dp = 2 against dp = 1 and against the TPU
package's ``quantize_model(mesh=make_mesh(tp=1, dp=2))``."""

import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.engine import QuantizeSpec as JSpec
from gptq_for_llama_tpu.engine import get_path as jget_path
from gptq_for_llama_tpu.engine import quantize_model as jquantize_model
from gptq_for_llama_tpu.parallel.sharding import make_mesh as jax_make_mesh
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.engine import QuantizeSpec, get_path, quantize_model
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.parallel import distributed
from gptq_for_llama_tpu_torch.parallel.sharding import Mesh

import torch_tp_workers
from test_torch_quant import assert_solver_close
from torch_tp import jax_config, jax_tree

CFG = dict(arch="llama", vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64)
SPEC = dict(wbits=4, groupsize=16, chunk=4, act_order=True, true_sequential=True)


def test_initialize_is_env_gated(monkeypatch):
    for k in ("GPTQ_TPU_COORDINATOR", "GPTQ_TPU_DISTRIBUTED", "GPTQ_TPU_NUM_PROCESSES",
              "GPTQ_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False   # no env, no args: a no-op
    assert distributed.process_count() == 1
    monkeypatch.setenv("GPTQ_TPU_DISTRIBUTED", "0")
    assert distributed.initialize() is False


@pytest.mark.parametrize("local_rank_set", [False, True])
def test_initialize_places_one_rank_a_card_across_hosts(monkeypatch, local_rank_set):
    """The launch recipe on 2 hosts of 2 cards: process 3 (host 1, card 1)
    joins a group of 4 over NCCL, its card from LOCAL_WORLD_SIZE whether or
    not LOCAL_RANK is set; a host with fewer cards than its ranks, or a
    group of 4 with no LOCAL_WORLD_SIZE (taken to be one host's), raises."""
    from gptq_for_llama_tpu_torch.parallel.sharding import device_for_rank
    joined = {}

    def init_process_group(backend, init_method, **kw):
        joined.update(backend=backend, init=init_method, **kw)

    monkeypatch.setattr(distributed.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda: 3)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for k, v in (("GPTQ_TPU_COORDINATOR", "host0:8476"), ("GPTQ_TPU_NUM_PROCESSES", "4"),
                 ("GPTQ_TPU_PROCESS_ID", "3"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_rank_set:
        monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.initialize() is True
    assert joined == {"backend": "nccl", "init": "tcp://host0:8476", "world_size": 4,
                      "rank": 3}
    assert distributed.local_rank(3, 4) == 1
    assert device_for_rank(3, None) == torch.device("cuda", 1)
    assert distributed.initialize(device_type="cpu") is True and joined["backend"] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks on this host need a card each"):
        distributed.initialize()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(RuntimeError, match="4 ranks on this host need a card each"):
        distributed.initialize()


def test_put_global_single_process_takes_each_ranks_slice():
    """Every rank holds the full host copy and takes its own slice (the
    TPU package's put_global over P("dp", None) on a dp 2 x tp 4 mesh)."""
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    for rank in range(8):
        mesh = Mesh(tp=4, dp=2, rank=rank, tp_rank=rank % 4, dp_rank=rank // 4,
                    device=torch.device("cpu"))
        got = distributed.put_global(x, mesh, ("dp", None)).numpy()
        np.testing.assert_array_equal(got, x[(rank // 4) * 4:(rank // 4 + 1) * 4])
        np.testing.assert_array_equal(distributed.put_global(x, mesh, (None, None)).numpy(), x)
        np.testing.assert_array_equal(distributed.put_global(x.T, mesh, (None, "tp")).numpy(),
                                      x.T[:, (rank % 4) * 2:(rank % 4 + 1) * 2])


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    h, inter, v = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]

    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32)}

    def norm():
        return (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    return {"embed_tokens": rng.standard_normal((v, h)).astype(np.float32),
            "layers": [{"input_layernorm": norm(), "post_attention_layernorm": norm(),
                        "self_attn": {n: lin(h, h) for n in ("q_proj", "k_proj", "v_proj",
                                                             "o_proj")},
                        "mlp": {"gate_proj": lin(h, inter), "up_proj": lin(h, inter),
                                "down_proj": lin(inter, h)}} for _ in range(CFG["num_layers"])],
            "norm": norm(), "lm_head": lin(h, v)}


WINDOWS = np.random.RandomState(1).randint(0, CFG["vocab_size"], size=(8, 32))


@pytest.fixture(scope="module")
def ranks():
    """One group of two ranks: the group probe, then dp = 2 calibration."""
    out = {}

    def run():
        ranks = distributed.spawn(torch_tp_workers.probe_and_calibrate, 2,
                                  args=(_tree(), CFG, WINDOWS, SPEC), threads=1)
        for key in ("probe", "matmuls", "dp2"):
            out[key] = [r[key] for r in ranks]

    worker = threading.Thread(target=run)
    worker.start()
    yield lambda: (worker.join(), out)[1]
    worker.join()


def test_two_process_group(ranks):
    """Two REAL processes: tp-major coordinates on (1, 2) and (2, 1) meshes,
    bf16 and fp64 all-reduces, an all-gather in rank order, each rank's
    put_global slice."""
    probe = ranks()["probe"]
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    for rank, p in enumerate(probe):
        assert p["rank"] == rank and p["count"] == 2
        assert p["tp2"] == (rank, 0) and p["dp2"] == (0, rank)
        np.testing.assert_array_equal(p["sum_bf16"], np.full(3, 2.0))
        np.testing.assert_array_equal(p["sum_dp"], np.full(2, 3.0))
        np.testing.assert_array_equal(p["gather"], [[0.0, 0.0, 1.0, 1.0]])
        np.testing.assert_array_equal(p["slice"], x[rank * 4:(rank + 1) * 4])


def test_tp_quant_matmul_col_and_row(ranks):
    """``tp_quant_matmul`` on two ranks (tests/test_tp_ops.py's cases): each
    rank's column shard is its slice of the unsharded product, the row-parallel
    product (all-reduced, the bias added once) the whole of it; act-order
    rows and groups that do not split over tp raise, as in the TPU package."""
    from gptq_for_llama_tpu_torch.ops.linear import quant_matmul_plain
    per_rank = ranks()["matmuls"]
    x = torch.as_tensor(per_rank[0]["x"])
    for rank, got in enumerate(per_rank):
        y, full = got["col"]
        want = quant_matmul_plain(x, full, torch.float32).numpy()
        np.testing.assert_allclose(y, want[:, rank * 256:(rank + 1) * 256], rtol=1e-5, atol=1e-5)
        y, full = got["row"]
        np.testing.assert_allclose(y, quant_matmul_plain(x, full, torch.float32).numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert got["refused"] == ["NotImplementedError", "ValueError"]


def _port_dp1():
    cfg = ModelConfig(**CFG)
    params = params_from_jax(_tree(), "cpu", torch.float32)
    params, recs, _ = quantize_model("llama", cfg, params, WINDOWS, QuantizeSpec(**SPEC),
                                     verbose=False)
    return {key: {"kernel": get_path(params["layers"][int(key.split(".")[1])],
                                     key.split(".", 2)[2])["kernel"].numpy(),
                  "scale": rec.scale, "zero": rec.zero, "g_idx": rec.g_idx, "error": rec.error}
            for key, rec in recs.items()}


def _jax_dp2():
    jparams = jax_tree(_tree())
    jparams, jrecs, _ = jquantize_model("llama", jax_config(CFG), jparams, WINDOWS, JSpec(**SPEC),
                                        verbose=False, mesh=jax_make_mesh(tp=1, dp=2))
    return {key: {"kernel": np.asarray(jget_path(jparams["layers"][int(key.split(".")[1])],
                                                 key.split(".", 2)[2])["kernel"]),
                  "scale": np.asarray(rec.scale), "zero": np.asarray(rec.zero),
                  "g_idx": np.asarray(rec.g_idx), "error": rec.error}
            for key, rec in jrecs.items()}


def _solver(r):
    return (r["kernel"].T, r["scale"], r["zero"], r["g_idx"], r["error"])


def test_dp2_calibration_matches_dp1_and_jax(ranks):
    """Calibration split over two ranks (each runs half of every chunk, the
    fp64 Gram sums all-reduced before the solver): both ranks end with the
    same tree, bit for bit; it matches the port's dp = 1 run and the TPU
    package's dp = 2 run within the solver tolerance of tests/test_torch_quant.py."""
    want_dp1, want_jax = _port_dp1(), _jax_dp2()
    r0, r1 = ranks()["dp2"]
    assert set(r0) == set(want_dp1) == set(want_jax)
    for key in r0:
        for f in ("kernel", "scale", "zero", "g_idx"):
            np.testing.assert_array_equal(r0[key][f], r1[key][f])
        assert r0[key]["error"] == r1[key]["error"]
        assert_solver_close(_solver(r0[key]), _solver(want_dp1[key]))
        assert_solver_close(_solver(r0[key]), _solver(want_jax[key]))
