"""The port's continuous-batching engine held against the TPU package's.

The same numpy weights (a tiny dense LLaMA, fp32) and the same prompts go
through ``gptq_for_llama_tpu.runtime.serve.ServingEngine`` and its counterpart
in the port on the CPU, in every serving mode; greedy tokens must be EQUAL.
The scheduler's regressions are then ported as cases against the port's own
single-sequence ``generate`` (itself held against the TPU package's in
tests/test_torch_model.py).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine
from gptq_for_llama_tpu_torch.cli import serve as serve_cli
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine, generate
from gptq_for_llama_tpu_torch.runtime.serve import _bucket

import hf_tiny

CFG = dict(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64)


def _np_llama(cfg, seed=0):
    """A dense LLaMA as a numpy tree in the hand-over format of both packages."""
    rng = np.random.RandomState(seed)
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]
    h, kvh = cfg["num_heads"] * cfg["head_dim"], cfg["num_kv_heads"] * cfg["head_dim"]

    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32)}

    def norm():
        return (1 + 0.1 * rng.standard_normal(hid)).astype(np.float32)

    layers = [{"input_layernorm": norm(), "post_attention_layernorm": norm(),
               "self_attn": {"q_proj": lin(hid, h), "k_proj": lin(hid, kvh),
                             "v_proj": lin(hid, kvh), "o_proj": lin(h, hid)},
               "mlp": {"gate_proj": lin(hid, inter), "up_proj": lin(hid, inter),
                       "down_proj": lin(inter, hid)}} for _ in range(cfg["num_layers"])]
    return {"embed_tokens": rng.standard_normal((cfg["vocab_size"], hid)).astype(np.float32),
            "layers": layers, "norm": norm(), "lm_head": lin(hid, cfg["vocab_size"])}


def _setup(**kw):
    cfg = dict(CFG, **kw)
    tree = _np_llama(cfg)
    return ModelConfig(**cfg), params_from_jax(tree, "cpu", torch.float32), \
        JaxModelConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, tree)


def _run(cfg, params, prompts, max_new, slots=2, max_seq_len=32, buckets=(8,), eos=None, **kw):
    eng = ServingEngine("llama", cfg, params, batch_slots=slots, max_seq_len=max_seq_len,
                        dtype=torch.float32, prefill_buckets=buckets, device="cpu", **kw)
    max_new = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    for uid, p in enumerate(prompts):
        eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=max_new[uid], eos_token_id=eos))
    return eng.run(), eng


def _run_jax(jcfg, jparams, prompts, max_new, slots=2, max_seq_len=32, buckets=(8,), **kw):
    eng = JaxServingEngine("llama", jcfg, jparams, batch_slots=slots, max_seq_len=max_seq_len,
                           dtype=jnp.float32, prefill_buckets=buckets, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(JaxGenRequest(uid=uid, prompt=p.astype(np.int32), max_new_tokens=max_new,
                                 temperature=0.0))
    return eng.run()


def _reference(cfg, params, prompts, max_new, max_seq_len=32):
    runner = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=max_seq_len,
                         dtype=torch.float32, device="cpu")
    return [generate(runner, p, max_new_tokens=max_new, temperature=0.0)[0, len(p):]
            for p in prompts]


MIXED = [np.array([1, 2, 3]), np.array([5, 6]), np.arange(3, 20), np.array([4]),
         np.arange(1, 12), np.array([2, 2, 2])]   # 6 requests > slots: slots are backfilled

MODES = {
    "dense": dict(),
    "paged": dict(paged=True, block_size=8, num_blocks=10),   # < slots * blocks: real reuse
    "chunked": dict(prefill_chunk=8, fused_chunk_decode=False),
    "chunked+fused": dict(prefill_chunk=8),
    "chunked+fused+paged": dict(prefill_chunk=8, paged=True, block_size=8),
    "span4": dict(decode_span=4),
    "span4+paged": dict(decode_span=4, paged=True, block_size=8),
    "batched-admission": dict(slots=4),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_engine_matches_jax_engine(mode):
    """Every serving mode: the port's greedy tokens EQUAL the TPU package's
    engine on the same weights and prompts (fp32 on the CPU, the port through
    its plain versions), and the forwards the mode exists for were made."""
    cfg, params, jcfg, jparams = _setup()
    kw = dict(MODES[mode], buckets=(8, 32))
    want = _run_jax(jcfg, jparams, MIXED, 5, **kw)
    got, eng = _run(cfg, params, MIXED, 5, **kw)
    assert set(got) == set(want) == set(range(len(MIXED)))
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]), err_msg=f"request {uid}")
    f = eng.forwards
    assert f["decode"] > 0 and eng.stats()["completed"] == len(MIXED)
    if "chunked" in mode:
        assert f["prefill"] == f["admit"] == 0 and f["chunk"] + f["chunk+decode"] == 9
        assert (f["chunk+decode"] > 0) == ("fused" in mode)
    else:
        assert f["chunk"] == f["chunk+decode"] == 0 and f["prefill"] + f["admit"] > 0
    if mode == "batched-admission":
        assert f["admit"] >= 1   # the first wave's four short prompts share bucket 8


def test_batched_admission_matches_per_slot():
    """A backfill wave of same-bucket admissions runs through ONE batched
    forward and gives the same greedy results as per-slot admission
    (admit_batch_max=0), dense and paged."""
    cfg, params, _, _ = _setup()
    prompts = [np.array([1, 2, 3]), np.array([5, 6]), np.array([9, 8, 7, 6, 5]), np.array([4])]
    for kw in (dict(), dict(paged=True, block_size=8)):
        got_b, eng_b = _run(cfg, params, prompts, 5, slots=4, **kw)
        got_s, eng_s = _run(cfg, params, prompts, 5, slots=4, admit_batch_max=0, **kw)
        assert (eng_b.forwards["admit"], eng_b.forwards["prefill"]) == (1, 0)
        assert (eng_s.forwards["admit"], eng_s.forwards["prefill"]) == (0, 4)
        for uid in range(len(prompts)):
            np.testing.assert_array_equal(got_b[uid], got_s[uid])


def test_serving_eos_frees_slot():
    cfg, params, _, _ = _setup()
    p = np.array([1, 2, 3])
    ref = _reference(cfg, params, [p], 8)[0]
    eos = int(ref[2])  # stop at this token's FIRST occurrence in ref
    expect_len = int(np.argmax(ref == eos)) + 1
    got, _ = _run(cfg, params, [p], 8, eos=eos)
    assert len(got[0]) == expect_len and got[0][-1] == eos
    np.testing.assert_array_equal(got[0], ref[:expect_len])


def test_prompt_longer_than_buckets_still_serves():
    """A prompt beyond every configured prefill bucket but within the cache
    uses the implicit full-length bucket instead of raising."""
    cfg, params, _, _ = _setup()
    p = np.arange(1, 13)  # 12 > bucket 8
    got, eng = _run(cfg, params, [p], 4)
    assert eng.buckets == (8, 32) and _bucket(12, eng.buckets) == 32
    np.testing.assert_array_equal(got[0], _reference(cfg, params, [p], 4)[0])
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        _bucket(33, eng.buckets)


def test_first_token_retirement_and_submit_validation():
    """max_new_tokens=1 returns exactly ONE token (generate parity); eos as
    the first sampled token retires at once; over-length prompts and
    impossible paged requests are rejected at submit()."""
    cfg, params, _, _ = _setup()
    p = np.array([1, 2, 3])
    got, eng = _run(cfg, params, [p], 1, max_seq_len=16)
    np.testing.assert_array_equal(got[0], _reference(cfg, params, [p], 1, max_seq_len=16)[0])
    assert len(got[0]) == 1

    first = int(got[0][0])
    r2, _ = _run(cfg, params, [p], 8, max_seq_len=16, eos=first)
    assert list(r2[0]) == [first]

    with pytest.raises(ValueError, match="no room"):
        eng.submit(GenRequest(uid=9, prompt=np.arange(16), max_new_tokens=4))
    eng3 = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=32, dtype=torch.float32,
                         prefill_buckets=(8,), paged=True, block_size=8, num_blocks=2,
                         device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        eng3.submit(GenRequest(uid=9, prompt=p, max_new_tokens=24))


def test_paged_span_midspan_retirement_no_corruption():
    """In paged mode with decode_span > block_size, a slot retiring mid-span
    keeps decoding on the device with the stale live mask: its offset
    overshoots. Span slack in the allocation and the reserved scratch block
    keep those writes out of the other slot's blocks."""
    cfg, params, _, _ = _setup(vocab_size=256)   # wide enough that corruption flips tokens
    prompts, max_new = [np.array([1, 2, 3]), np.array([9, 8])], [18, 3]
    base, _ = _run(cfg, params, prompts, max_new)
    got, _ = _run(cfg, params, prompts, max_new, decode_span=8, paged=True, block_size=4)
    for uid in base:
        np.testing.assert_array_equal(got[uid], base[uid], err_msg=f"request {uid}")
    ref = _reference(cfg, params, prompts[:1], 18)
    np.testing.assert_array_equal(base[0], ref[0])


def test_chunked_prefill_concurrent_decode_write_mask():
    """A batched decode step must not clobber rows of a slot that is
    mid-chunked-prefill (its stale offset points into prompt rows that
    earlier chunks already wrote): staggered lifetimes force a multi-chunk
    prefill to coexist with live decoding, fused and unfused."""
    cfg, params, _, _ = _setup()
    prompts = [np.arange(1, 6), np.array([5, 6]), np.arange(3, 20)]   # 17 tokens: 3 chunks
    max_new = [12, 2, 4]
    base, _ = _run(cfg, params, prompts, max_new, buckets=(32,))
    for kw in (dict(prefill_chunk=8, fused_chunk_decode=False), dict(prefill_chunk=8),
               dict(prefill_chunk=8, paged=True, block_size=8)):
        got, _ = _run(cfg, params, prompts, max_new, buckets=(32,), **kw)
        for uid in base:
            np.testing.assert_array_equal(got[uid], base[uid], err_msg=f"{kw}, request {uid}")


def test_per_slot_prefills_pass_host_offsets(monkeypatch):
    """Every per-slot prefill and every chunk (fused or not, dense or paged)
    reaches the blocked prefill dispatcher with its offset as a 1-element
    int32 tensor and a host-int bound no smaller than offset + C: the form
    its kernel reads on the card, which a graph replays at any offset. Dense:
    the slot's row of the whole cache through ``rows``; paged: the blocks of
    the bound, gathered."""
    cfg, params, _, _ = _setup()
    seen = []
    orig = common.flash_prefill_blocked

    def spy(q, k, v, q_offset, scale, bound=None, rows=None):
        seen.append((q.shape[1], k.shape[1], q_offset, bound, rows))
        return orig(q, k, v, q_offset, scale, bound, rows)

    monkeypatch.setattr(common, "flash_prefill_blocked", spy)
    prompts = [np.arange(1, 6), np.arange(3, 20)]
    for kw in (dict(admit_batch_max=0), dict(prefill_chunk=8), dict(prefill_chunk=8, paged=True,
                                                                    block_size=8)):
        seen.clear()
        _, eng = _run(cfg, params, prompts, 3, buckets=(8, 32), **kw)
        per_layer = eng.forwards["prefill"] + eng.forwards["chunk"] + eng.forwards["chunk+decode"]
        assert len(seen) == per_layer * cfg.num_layers and per_layer > 0
        for sq, skv, off, bound, rows in seen:
            assert isinstance(off, torch.Tensor) and off.dtype == torch.int32 and off.numel() == 1
            assert type(bound) is int and bound >= int(off) + sq
            if kw.get("paged"):   # a paged chunk gathers the blocks of its bound only
                assert rows is None and sq == 8 and skv == -(-bound // 8) * 8
            else:                 # a dense one attends its slot's row of the whole cache
                assert rows.dtype == torch.int32 and rows.numel() == 1 and skv == eng.max_len


def test_engine_refuses_unported_options_and_devices():
    cfg, params, _, _ = _setup()
    # tensor-parallel serving is ported (tests/test_torch_tp_serve.py): fused
    # q/k/v under it, and a tp that does not divide the heads, raise as in the
    # TPU package
    from gptq_for_llama_tpu_torch.parallel.sharding import Mesh
    for tp, kw, msg in ((2, dict(fuse_qkv=True), "fuse_qkv is incompatible"),
                        (3, dict(), "must divide num_heads")):
        mesh = Mesh(tp=tp, dp=1, rank=0, tp_rank=0, dp_rank=0, device=torch.device("cpu"))
        with pytest.raises(ValueError, match=msg):
            ServingEngine("llama", cfg, params, dtype=torch.float32, device="cpu", mesh=mesh,
                          **kw)
    # fuse_qkv is ported (A4; tests/test_torch_fuse_qkv.py): dense q/k/v, as
    # here, stay unfused, as in the TPU package
    eng = ServingEngine("llama", cfg, params, dtype=torch.float32, device="cpu", fuse_qkv=True)
    assert all("q_proj" in lp["self_attn"] for lp in eng.params["layers"])
    # a KV storage dtype is ported: the caches are made in it; another dtype raises
    eng = ServingEngine("llama", cfg, params, dtype=torch.float32, device="cpu",
                        kv_dtype=torch.float8_e4m3fn)
    assert eng.kv_dtype == torch.float8_e4m3fn and eng.kv_bytes() == 0
    with pytest.raises(TypeError, match="KV cache"):
        ServingEngine("llama", cfg, params, dtype=torch.float32, device="cpu",
                      kv_dtype=torch.float16)
    with pytest.raises(ValueError, match="multiple of block_size"):
        ServingEngine("llama", cfg, params, paged=True, block_size=8, prefill_chunk=12,
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine("llama", cfg, params)


def test_sampled_serving_runs_and_keeps_greedy_rows():
    """Mixed sampling params in one batch: greedy rows equal the all-greedy
    run; sampled rows are valid tokens; the same seed repeats the run."""
    cfg, params, _, _ = _setup()
    prompts = [np.array([1, 2, 3]), np.array([5, 6]), np.array([7, 7, 7])]

    def run(seed):
        eng = ServingEngine("llama", cfg, params, batch_slots=3, max_seq_len=32,
                            dtype=torch.float32, prefill_buckets=(8,), device="cpu", seed=seed)
        eng.submit(GenRequest(uid=0, prompt=prompts[0], max_new_tokens=6))
        eng.submit(GenRequest(uid=1, prompt=prompts[1], max_new_tokens=6, temperature=0.9))
        eng.submit(GenRequest(uid=2, prompt=prompts[2], max_new_tokens=6, temperature=0.7,
                              top_p=0.8))
        return eng.run()

    a, b = run(3), run(3)
    np.testing.assert_array_equal(a[0], _reference(cfg, params, prompts[:1], 6)[0])
    for uid in (1, 2):
        assert len(a[uid]) == 6 and ((a[uid] >= 0) & (a[uid] < cfg.vocab_size)).all()
        np.testing.assert_array_equal(a[uid], b[uid])


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed_dir(tmp_path_factory):
    from gptq_for_llama_tpu_torch.cli.main import main
    root = tmp_path_factory.mktemp("serve_cli")
    model, _ = hf_tiny.tiny_llama_dir(root / "model")
    packed = str(root / "packed")
    main([model, "synthetic", "--wbits", "4", "--groupsize", "16", "--nsamples", "4", "--chunk",
          "4", "--seqlen", "32", "--save", packed, "--device", "cpu"])
    return model, packed


@pytest.mark.parametrize("flags", [[], ["--paged", "--block-size", "8", "--prefill-chunk", "8"]])
def test_serve_cli_demo(packed_dir, capsys, flags):
    """``serve MODEL --load PACKED --demo N --device cpu``: one JSON line per
    request, then the stats line with the TPU package's keys."""
    model, packed = packed_dir
    rep = serve_cli.main([model, "--load", packed, "--demo", "4", "--max-new-tokens", "5",
                          "--slots", "2", "--span", "4", "--quiet", "--device", "cpu", *flags])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[:-1] == rep["requests"] and lines[-1] == rep["stats"]
    assert [r["uid"] for r in lines[:-1]] == [0, 1, 2, 3]
    assert all(r["prompt_tokens"] == 16 and r["new_tokens"] == len(r["tokens"]) == 5
               for r in lines[:-1])
    stats = lines[-1]
    assert stats["requests"] == 4 and stats["tokens"] == 20 and stats["completed"] == 4
    assert {"tok_s", "ttft_p50_s", "latency_p95_s", "slots", "span", "paged", "prefill_chunk",
            "tp", "max_seq_len"} <= set(stats)
    assert stats["paged"] == ("--paged" in flags)


def test_serve_cli_needs_the_card_and_refuses_unported_flags(packed_dir):
    model, packed = packed_dir
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.main([model, "--load", packed, "--demo", "1", "--quiet"])
    # --tp and --distributed are ported: --tp 2 wants a card a rank, and
    # --distributed a group in the environment; each raises without them
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need a card each"):
            serve_cli.main([model, "--demo", "1", "--tp", "2"])
    with pytest.raises(ValueError, match="environment variable"):
        serve_cli.main([model, "--demo", "1", "--device", "cpu", "--distributed"])
    with pytest.raises(SystemExit):   # --fuse-attn is ported; with --tp a parser error
        serve_cli.main([model, "--demo", "1", "--device", "cpu", "--fuse-attn", "--tp", "2"])
    with pytest.raises(SystemExit):
        serve_cli.main([model, "--device", "cpu"])   # neither --prompts nor --demo
