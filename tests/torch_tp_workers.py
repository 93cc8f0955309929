"""What the port's tensor-parallel tests run in each rank's process.

Imported by name in the processes that ``parallel.distributed.spawn``
starts, so it imports no JAX: the test modules build the weights (numpy
wire trees, the hand-over format of ``convert.params_from_jax``) and the
TPU package's reference outputs in the test process, and hand each rank the
trees and the cases to run. Every function returns plain numpy results.
"""

from __future__ import annotations

import numpy as np
import torch

from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.parallel.sharding import make_mesh
from gptq_for_llama_tpu_torch.quant import packing
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine


def wire_linear(rng, k: int, n: int, bits: int = 4, gs: int = 32, act_order: bool = False,
                bias=None) -> dict:
    """Wire buffers of one packed (k -> n) linear: codes of a rounded
    N(0, 0.02) around zero-points near the middle, every group its own
    scales; act_order shuffles g_idx (an act-order checkpoint)."""
    g, maxq, mid = k // gs, 2 ** bits - 1, 2 ** (bits - 1)
    codes = np.clip(np.rint(mid + rng.standard_normal((k, n)) * maxq / 6), 0, maxq)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if act_order:
        g_idx = g_idx[rng.permutation(k)]
    zeros = rng.randint(mid - 1, mid + 2, size=(g, n)).astype(np.uint32)
    out = {"qweight": packing.pack_rows(codes.astype(np.uint32), bits),
           "qzeros": packing.pack_cols(zeros - 1, bits),
           "scales": ((0.9 + 0.2 * rng.rand(g, n)) * 0.12 / maxq).astype(np.float16),
           "g_idx": g_idx, "bits": bits}
    if bias is not None:
        out["bias"] = np.asarray(bias, np.float32)
    return out


def port_model(case: dict):
    """(cfg, fp32 params on the CPU) of a case's wire tree."""
    return ModelConfig(**case["cfg"]), params_from_jax(case["tree"], "cpu", torch.float32)


def run_steps(runner, ids: np.ndarray, nsteps: int = 3, scan: int = 0) -> dict:
    """tests/test_tp_model.py's ``_run_steps``: prefill, then ``nsteps``
    greedy decode steps; with ``scan``, also ``decode_greedy_scan`` of that
    many steps from the prefill."""
    ids = torch.as_tensor(ids, dtype=torch.long)
    cache = runner.init_cache()
    logits, cache = runner.prefill(ids, cache)
    out = {"prefill": logits[:, -1].float().numpy()}
    tok = logits[:, -1].float().argmax(-1, keepdim=True)
    toks = []
    for _ in range(nsteps):
        toks.append(tok[:, 0].numpy())
        logits, cache = runner.decode(tok, cache)
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
    toks.append(tok[:, 0].numpy())
    out.update(logits=logits.float().numpy(), toks=np.stack(toks, 1))
    if scan:
        cache = runner.init_cache()
        logits, cache = runner.prefill(ids, cache)
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        out["scan"] = runner.decode_greedy_scan(tok, cache, scan)[0].numpy()
    return out


def runner_cases(cases: dict) -> dict:
    """Each case through the TP runner on a (dp, tp) mesh of this group's
    ranks (every rank makes every mesh; ranks outside one skip its case)."""
    out = {}
    for name, case in cases.items():
        mesh = make_mesh(tp=case["tp"], dp=case.get("dp", 1), device="cpu")
        if not mesh.member:
            continue
        cfg, params = port_model(case)
        r = ModelRunner(cfg.arch, cfg, params, batch_size=case["ids"].shape[0],
                        max_seq_len=32, dtype=torch.float32, mesh=mesh)
        out[name] = run_steps(r, case["ids"], scan=case.get("scan", 0))
        out[name]["collectives"] = dict(mesh.collectives)
        out[name]["forwards"] = dict(r.forwards)
    return out


def engine_cases(case: dict, modes: dict, tp: int) -> dict:
    """One model through the TP serving engine in each mode of ``modes``
    ({name: engine kwargs, with "kv_dtype" a dtype name}); greedy tokens of
    each request."""
    mesh = make_mesh(tp=tp, dp=1, device="cpu")
    cfg, params = port_model(case)
    out = {}
    for name, kw in modes.items():
        kw = dict(kw)
        if "kv_dtype" in kw:
            kw["kv_dtype"] = getattr(torch, kw["kv_dtype"])
        eng = ServingEngine(cfg.arch, cfg, params, batch_slots=2, max_seq_len=32,
                            dtype=torch.float32, prefill_buckets=(8,), device="cpu", mesh=mesh,
                            **kw)
        for uid, p in enumerate(case["prompts"]):
            eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=5, temperature=0.0))
        res = eng.run()
        out[name] = {"tokens": {uid: np.asarray(t) for uid, t in res.items()},
                     "forwards": dict(eng.forwards)}
    return out


def group_probe() -> dict:
    """One rank of a two-rank group: its coordinates on the meshes it makes,
    collectives over each axis, and its put_global slice."""
    import torch.distributed as dist
    from gptq_for_llama_tpu_torch.parallel import distributed
    rank = dist.get_rank()
    tp2, dp2 = make_mesh(tp=2, device="cpu"), make_mesh(tp=1, dp=2, device="cpu")
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    return {"rank": rank, "count": distributed.process_count(),
            "tp2": (tp2.tp_rank, tp2.dp_rank), "dp2": (dp2.tp_rank, dp2.dp_rank),
            "sum_bf16": tp2.all_reduce(torch.full((3,), rank + 0.5, dtype=torch.bfloat16))
            .float().numpy(),
            "sum_dp": dp2.all_reduce(torch.full((2,), rank + 1.0, dtype=torch.float64),
                                     axis="dp").numpy(),
            "gather": tp2.all_gather(torch.full((1, 2), float(rank)), dim=-1).numpy(),
            "slice": distributed.put_global(x, dp2, ("dp", None)).numpy()}


def tp_matmuls() -> dict:
    """``tp_quant_matmul`` over a two-rank tp group (tests/test_tp_ops.py's
    shapes): a column shard's output, a row-parallel product all-reduced
    (bias added once), and its refusals of act-order rows and of groups that
    do not split over tp."""
    from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
    from gptq_for_llama_tpu_torch.parallel import shard_packed_linear, tp_quant_matmul
    mesh = make_mesh(tp=2, device="cpu")
    rng = np.random.RandomState(0)

    def lin(k, n, gs, act_order=False):
        w = wire_linear(rng, k, n, gs=gs, act_order=act_order,
                        bias=rng.standard_normal(n).astype(np.float32))
        return PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"], 4,
                                      bias=w["bias"], dtype=torch.float32, device="cpu")

    x = torch.as_tensor(rng.standard_normal((4, 256)).astype(np.float32))
    out = {"x": x.numpy()}
    for mode, (k, n) in (("col", (256, 512)), ("row", (256, 512))):
        full = lin(k, n, 32)
        out[mode] = (tp_quant_matmul(x, shard_packed_linear(full, mesh, mode), mesh,
                                     mode).numpy(), full)
    refused = []
    for kw in (dict(act_order=True), dict(gs=256)):
        try:
            tp_quant_matmul(x, shard_packed_linear(lin(256, 64, kw.pop("gs", 32), **kw), mesh,
                                                   "row"), mesh, "row")
        except (NotImplementedError, ValueError) as e:
            refused.append(type(e).__name__)
    out["refused"] = refused
    return out


def calibrate(tree: dict, cfg: dict, windows: np.ndarray, spec: dict, dp: int) -> dict:
    """quantize_model with calibration split over a dp mesh: the fake-quantized
    kernels and the records, as numpy."""
    from gptq_for_llama_tpu_torch.engine import QuantizeSpec, get_path, quantize_model
    mesh = make_mesh(tp=1, dp=dp, device="cpu")
    cfg = ModelConfig(**cfg)
    params = params_from_jax(tree, "cpu", torch.float32)
    params, recs, _ = quantize_model(cfg.arch, cfg, params, windows, QuantizeSpec(**spec),
                                     verbose=False, mesh=mesh)
    return {key: {"kernel": get_path(params["layers"][int(key.split(".")[1])],
                                     key.split(".", 2)[2])["kernel"].numpy(),
                  "scale": rec.scale, "zero": rec.zero, "g_idx": rec.g_idx, "error": rec.error}
            for key, rec in recs.items()}


def probe_and_calibrate(tree: dict, cfg: dict, windows: np.ndarray, spec: dict) -> dict:
    """``group_probe``, ``tp_matmuls``, then ``calibrate`` at dp 2: what
    tests/test_torch_distributed.py runs in one two-rank group."""
    return {"probe": group_probe(), "matmuls": tp_matmuls(),
            "dp2": calibrate(tree, cfg, windows, spec, 2)}
