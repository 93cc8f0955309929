"""The port's compiled steps (``runtime/graphs.py``) held against the TPU
package's jitted steps and token scans, and the rules of the graphs.

On the CPU the graph bodies run eagerly, so what is held here is the body
the card captures: the runner's ``decode_greedy_scan`` and
``forced_decode_scan`` against the TPU package's, ``generate(span=)``
against ``span=1`` and the TPU package's ``generate``, and the engine's
decode spans (dense, paged, fold) against its single steps and the TPU
package's engine. Both packages run fp32 on the CPU; tokens must be EQUAL,
logits within atol 2e-4, rtol 1e-3 (tests/test_torch_model.py's tolerance).
Then the port's own rules: the live-length buckets, the graph keys, stale
cache handles, and the launch accounting of a capture (on a fake card).
"""

import contextlib
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine
from gptq_for_llama_tpu_torch.ops import cuda as kernels
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine, generate
from gptq_for_llama_tpu_torch.runtime import graphs
from gptq_for_llama_tpu_torch.runtime.runner import SCAN_PIECE

from test_torch_fold import _count_jax_folds
from test_torch_fold import _models as _fold_models
from test_torch_model import _models
from test_torch_serve import _setup


def _runner(max_len, seed=20):
    _, _, cfg, params = _models(seed=seed, max_seq_len=max_len)
    return ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=max_len,
                       dtype=torch.float32, device="cpu")


def _runners(kv_heads=4, max_len=64, seed=20):
    jcfg, jparams, cfg, params = _models(seed=seed + kv_heads, num_kv_heads=kv_heads,
                                         max_seq_len=max_len)
    jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=max_len,
                        dtype=jnp.float32)
    r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=max_len,
                    dtype=torch.float32, device="cpu")
    return jr, r


@pytest.mark.parametrize("kv_heads,steps,max_len", [(4, 9, 64), (2, 40, 64), (4, 130, 300)])
def test_decode_greedy_scan_matches_jax(kv_heads, steps, max_len):
    """The port's scan (pieces of up to SCAN_PIECE steps, cut at the bucket
    of 128 in the 300-slot cache) gives the TPU package's decode_greedy_scan
    tokens from the same prefill, and the same cache offset."""
    jr, r = _runners(kv_heads, max_len)
    prompt = np.random.RandomState(kv_heads).randint(0, 96, size=(1, 9)).astype(np.int32)
    jl, jcache = jr.prefill(jnp.asarray(prompt), jr.init_cache())
    want, jcache = jr.decode_greedy_scan(jnp.argmax(jl[:, -1:], -1).astype(jnp.int32), jcache,
                                         steps)
    lg, cache = r.prefill(torch.as_tensor(prompt), r.init_cache())
    got, cache = r.decode_greedy_scan(lg[:, -1:].argmax(-1), cache, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache.offset == 9 + steps == int(jcache.offset)
    assert r.forwards == {"prefill": 1, "decode": steps}


@pytest.mark.parametrize("kv_heads,length", [(4, 7), (2, 40)])
def test_forced_decode_scan_matches_jax(kv_heads, length):
    """Teacher-forced logits of the last step against the TPU package's
    forced_decode_scan (fp32), and the same as a prefill of the ids."""
    jr, r = _runners(kv_heads)
    ids = np.random.RandomState(length).randint(0, 96, size=(1, length)).astype(np.int32)
    want, _ = jr.forced_decode_scan(jnp.asarray(ids), jr.init_cache())
    got, cache = r.forced_decode_scan(torch.as_tensor(ids), r.init_cache())
    assert got.shape == (1, 1, 96) and cache.offset == length
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    pre, _ = r.prefill(torch.as_tensor(ids), r.init_cache())
    np.testing.assert_allclose(got.numpy()[:, -1], pre.numpy()[:, -1], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("span", [4, 13, 32])
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_span_generate_matches_span1_and_jax(temp, span):
    """generate(span=k) is token-identical to the per-token loop (the same
    draws from the same generator, sampling inside the span), and greedy
    equals the TPU package's generate (tests/test_runtime.py:298)."""
    jr, r = _runners(seed=30)
    prompt = np.array([1, 2, 3])
    want = generate(r, prompt, max_new_tokens=13, temperature=temp, top_p=0.9, seed=3, span=1)
    got = generate(r, prompt, max_new_tokens=13, temperature=temp, top_p=0.9, seed=3, span=span)
    np.testing.assert_array_equal(got, want)
    if temp == 0.0:
        np.testing.assert_array_equal(got, np.asarray(jax_generate(
            jr, prompt.astype(np.int32), max_new_tokens=13, temperature=temp, top_p=0.9,
            seed=3, span=span)))


@pytest.mark.parametrize("span", [1, 4, 32])
def test_span_generate_eos_truncation_matches_jax(span):
    """EOS truncation mid-span and min_new_tokens across span boundaries
    (tests/test_runtime.py:315): the same output as span=1 and as the TPU
    package's generate at the same span."""
    jr, r = _runners(seed=31)
    p = np.array([1, 2, 3])
    eos = int(generate(r, p, max_new_tokens=1, temperature=0.0)[0, -1])
    out = generate(r, p, max_new_tokens=12, temperature=0.0, min_new_tokens=3,
                   eos_token_id=eos, span=span)
    assert eos not in out[0, 3:6].tolist()
    np.testing.assert_array_equal(out, generate(r, p, max_new_tokens=12, temperature=0.0,
                                                min_new_tokens=3, eos_token_id=eos, span=1))
    np.testing.assert_array_equal(out, np.asarray(jax_generate(
        jr, p.astype(np.int32), max_new_tokens=12, temperature=0.0, min_new_tokens=3,
        eos_token_id=eos, span=span)))
    cut = generate(r, p, max_new_tokens=12, temperature=0.0, eos_token_id=eos, span=span)
    assert cut.shape == (1, 4) and cut[0, -1] == eos


def test_decode_sample_scan_keeps_the_generator_stream():
    """Two spans of 5 draw what one span of 10 draws, and hand the generator
    back advanced as far: the caller's generator is the stream."""
    r = _runner(64, seed=32)
    prompt = torch.as_tensor([[4, 5, 6]])
    toks = {}
    for spans in ((10,), (5, 5)):
        gen = torch.Generator().manual_seed(9)
        lg, cache = r.prefill(prompt, r.init_cache())
        last, parts = lg[:, -1], []
        for n in spans:
            t, last, cache = r.decode_sample_scan(last, cache, n, gen, 1.0, 0.8)
            parts.append(t)
        toks[spans] = (torch.cat(parts, 1), torch.rand(3, generator=gen))
    assert torch.equal(toks[(10,)][0], toks[(5, 5)][0])
    assert torch.equal(toks[(10,)][1], toks[(5, 5)][1])


def _engine_jax(jcfg, jparams, prompts, max_new, **kw):
    eng = JaxServingEngine("llama", jcfg, jparams, batch_slots=2, max_seq_len=32,
                           dtype=jnp.float32, prefill_buckets=(8,), **kw)
    for uid, p in enumerate(prompts):
        eng.submit(JaxGenRequest(uid=uid, prompt=p.astype(np.int32), max_new_tokens=max_new,
                                 temperature=0.0))
    return eng.run()


def _engine(cfg, params, prompts, max_new, **kw):
    eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=32,
                        dtype=torch.float32, prefill_buckets=(8,), device="cpu", **kw)
    for uid, p in enumerate(prompts):
        eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=max_new))
    return eng.run(), eng


@pytest.mark.parametrize("mode", ["dense", "paged", "fold"])
def test_engine_span_matches_single_step_and_jax(mode, monkeypatch):
    """The engine's decode span of 4 (the body its graphs hold) gives the
    single-step engine's greedy tokens and the TPU package's engine's at
    span 4 (tests/test_serve.py:143): six requests on two slots, so spans
    end with retired rows still decoding, which the host trims."""
    kw = {"dense": {}, "paged": dict(paged=True, block_size=8),
          "fold": dict(cache_impl="fold")}[mode]
    if mode == "fold":
        jcfg, jparams, cfg, params = _fold_models()
        calls = _count_jax_folds(monkeypatch)
    else:
        cfg, params, jcfg, jparams = _setup()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in (3, 5, 1, 7, 2, 4)]
    jkw = {k: v for k, v in kw.items() if k != "cache_impl"}
    want = _engine_jax(jcfg, jparams, prompts, 7, decode_span=4, **jkw)
    if mode == "fold":
        assert calls, "the TPU package did not take its fold kernel"
    single, _ = _engine(cfg, params, prompts, 7, **kw)
    spanned, eng = _engine(cfg, params, prompts, 7, decode_span=4, **kw)
    assert set(spanned) == set(single) == set(want) == set(range(len(prompts)))
    for uid in want:
        np.testing.assert_array_equal(spanned[uid], single[uid], err_msg=f"request {uid}")
        np.testing.assert_array_equal(spanned[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
    assert eng.forwards["decode"] > 0


def test_engine_state_is_allocated_once():
    """A second run replays into the tensors of the first (a graph holds
    their addresses): caches, tables, offsets and the span's inputs."""
    cfg, params, _, _ = _setup()
    eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=32,
                        dtype=torch.float32, prefill_buckets=(8,), device="cpu", paged=True,
                        block_size=8, decode_span=4)
    ptrs = []
    for _ in range(2):
        for uid, n in enumerate((3, 9, 4)):
            eng.submit(GenRequest(uid=uid, prompt=np.arange(1, n + 1), max_new_tokens=5))
        results = eng.run()
        assert sorted(results) == [0, 1, 2] and all(len(t) == 5 for t in results.values())
        ptrs.append({k: (v.data_ptr() if isinstance(v, torch.Tensor) else
                         [t.data_ptr() for t in v] if isinstance(v, list) else None)
                     for k, v in eng.state.items()})
    assert ptrs[0] == ptrs[1]


# -- the port's own rules -------------------------------------------------------

def test_live_buckets_and_bucket_rule():
    assert graphs.live_buckets(2048) == (128, 256, 512, 1024, 2048)
    assert graphs.live_buckets(300) == (128, 256, 300)
    assert graphs.live_buckets(64) == (64,) and graphs.live_buckets(128) == (128,)
    buckets = graphs.live_buckets(2048)
    assert [graphs.bucket_for(n, buckets) for n in (1, 128, 129, 1000, 2048, 5000)] == \
        [128, 128, 256, 1024, 2048, 2048]


@pytest.mark.parametrize("max_len", [64, 300, 2048])
def test_scan_pieces_keep_every_step_in_its_own_bucket(max_len):
    """Every piece of a scan holds a power of two of at most SCAN_PIECE steps;
    its bucket is at least the live length (offset + 1) of its last step,
    never above the cache, and equal to each of its steps' own bucket (the
    one-step graph's). So a bucket has at most six piece lengths to capture."""
    r = _runner(max_len, seed=33)
    rng = np.random.RandomState(max_len)
    for _ in range(200):
        off = int(rng.randint(0, r.max_len))
        steps = int(rng.randint(0, r.max_len - off + 1))
        pieces = r._pieces(off, steps)
        assert sum(n for n, _ in pieces) == steps
        for n, bucket in pieces:
            assert 1 <= n <= SCAN_PIECE and n & (n - 1) == 0
            assert off + n <= bucket <= r.max_len
            assert all(graphs.bucket_for(o + 1, r.decode_buckets) == bucket
                       for o in range(off, off + n))
            off += n


def test_engine_span_bucket_covers_the_span_end():
    cfg, params, _, _ = _setup()
    for paged in (False, True):
        eng = ServingEngine("llama", cfg, params, batch_slots=4, max_seq_len=300,
                            dtype=torch.float32, device="cpu", paged=paged, block_size=8)
        kv = eng._kv_len()
        rng = np.random.RandomState(7)
        for _ in range(200):
            span = int(rng.randint(1, 9))
            host_off = rng.randint(0, kv - span + 1, size=4)
            bucket = eng._span_bucket({"host_off": host_off}, span)
            assert host_off.max() + span <= bucket <= kv and bucket in eng.decode_buckets


def _recording(owner):
    """Record the keys ``owner``'s graphs are asked for (the bodies still run)."""
    keys = []

    def run(key, body, restore=(), generators=()):
        keys.append(key)
        return body()

    owner.graphs.run = run
    return keys


def test_graph_keys():
    r = _runner(300, seed=34)
    keys = _recording(r)
    lg, cache = r.prefill(torch.as_tensor([[1, 2, 3]]), r.init_cache())
    _, cache = r.decode(torch.as_tensor([[4]]), cache)
    toks, cache = r.decode_greedy_scan(torch.as_tensor([[5]]), cache, 40)
    _, last, cache = r.decode_sample_scan(lg[:, -1], cache, 3, torch.Generator(), 0.7, 0.9,
                                          top_k=5, eos_id=2, min_left=1)
    _, cache = r.forced_decode_scan(torch.arange(90)[None] % 96, cache)
    assert keys == [("prefill", 16, 128), ("decode", 128), ("greedy", 32, 128),
                    ("greedy", 8, 128),
                    ("sample", 2, 5, True, None, 128, torch.float32),
                    ("sample", 1, 5, True, None, 128, torch.float32),
                    ("forced", 32, 128), ("forced", 32, 128), ("forced", 16, 128),
                    ("forced", 1, 128), ("forced", 8, 256), ("forced", 1, 256)]
    assert cache.offset == 137
    cfg, params, _, _ = _setup()
    eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=300,
                        dtype=torch.float32, prefill_buckets=(8,), device="cpu", decode_span=4)
    keys = _recording(eng)
    for uid, n in enumerate((3, 5)):
        eng.submit(GenRequest(uid=uid, prompt=np.arange(1, n + 1), max_new_tokens=6))
    eng.submit(GenRequest(uid=2, prompt=np.arange(1, 4), max_new_tokens=3, temperature=0.5))
    eng.run()
    spans = [k for k in keys if graphs.kind(k) == "decode"]
    assert keys[0] == ("admit", 8) and ("prefill", 8) in keys   # two arrivals, then one
    assert set(keys) - set(spans) == {("admit", 8), ("prefill", 8)}
    assert spans[0] == (4, "greedy", 128) and {k[1] for k in spans} == {"greedy", "categorical"}
    assert all(span in (1, 4) and bucket == 128 for span, _, bucket in spans)


def test_a_stale_cache_handle_raises():
    """A runner's cache is its own storage: a handle from before the latest
    init_cache() (or from another runner) raises on every entry point, and a
    new handle reuses the same tensors."""
    r = _runner(64, seed=35)
    ids = torch.as_tensor([[1, 2, 3]])
    _, old = r.prefill(ids, r.init_cache())
    _, new = r.prefill(ids, r.init_cache())
    assert new.k is old.k and new.k[0].data_ptr() == old.k[0].data_ptr()
    for call in (lambda: r.decode(ids[:, :1], old), lambda: r.prefill(ids, old),
                 lambda: r.decode_greedy_scan(ids[:, :1], old, 2),
                 lambda: r.forced_decode_scan(ids, old),
                 lambda: r.decode_sample_scan(torch.zeros(1, 96), old, 2, torch.Generator(),
                                              0.0, 1.0)):
        with pytest.raises(ValueError, match="stale"):
            call()
    other = _runner(64, seed=35)
    with pytest.raises(ValueError, match="stale"):
        other.decode(ids[:, :1], new)
    logits, new = r.decode(ids[:, :1], new)   # the live handle still works
    assert new.offset == 4 and torch.isfinite(logits).all()
    # an earlier handle of the same epoch starts again from its offset
    again, _ = r.decode(ids[:, :1], dataclasses.replace(new, offset=3))
    assert torch.equal(again, logits)


class _FakeGraph:
    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's graph API, faked on the CPU: a capture records nothing
    and a replay runs nothing, so only the accounting moves."""
    for name, value in (("CUDAGraph", _FakeGraph), ("Stream", lambda *a, **k: _FakeStream()),
                        ("current_stream", lambda *a, **k: _FakeStream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("graph", lambda g, pool=None: contextlib.nullcontext()),
                        ("graph_pool_handle", lambda: (0, 1))):
        monkeypatch.setattr(torch.cuda, name, value, raising=False)
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


def test_launch_accounting_of_a_capture(fake_card):
    """The warm call's launches count (it launched them), the capture's are
    taken back (it launched nothing), and every replay adds what the capture
    recorded: kernels, kernels by form and the owner's counters. The warm
    call's in-place changes and draws are undone before the capture."""
    forwards = {"decode": 0}
    g = graphs.Graphs("cpu", counters=(forwards,))
    offs = torch.zeros(2, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    seen = []   # what the warm call and the capture find

    def body():
        kernels.KERNELS["qmm"].wrapper.launches += 5
        kernels.KERNELS["rms_norm"].wrapper.launches += 3
        kernels.KERNELS["rms_norm"].wrapper.forms["add"] += 2
        kernels.KERNELS["rms_norm"].wrapper.forms["alone"] += 1
        forwards["decode"] += 1
        seen.append((offs.tolist(), torch.rand(1, generator=gen)))
        offs.add_(1)

    g.capture("k", body, restore=[offs], generators=(gen,))
    counts = kernels.launch_counts()
    assert (counts["qmm"], counts["rms_norm"], counts["rms_norm:add"],
            counts["rms_norm:alone"], forwards["decode"]) == (5, 3, 2, 1, 1)
    assert seen[0][0] == seen[1][0] == [0, 0] and torch.equal(seen[0][1], seen[1][1])
    assert "k" in g and len(g) == 1 and g._graphs["k"].graph.generators == [gen]
    for _ in range(3):
        g.replay("k")
    counts = kernels.launch_counts()
    assert (counts["qmm"], counts["rms_norm"], counts["rms_norm:add"],
            counts["rms_norm:alone"], forwards["decode"]) == (20, 12, 8, 4, 4)
    assert counts["decode_attention"] == 0 and g._graphs["k"].graph.replays == 3
    with pytest.raises(KeyError):
        g.capture("k", body)


def test_a_failed_capture_raises_and_takes_back_its_counts(fake_card):
    forwards = {"decode": 0}
    g = graphs.Graphs("cpu", counters=(forwards,))
    calls = []

    def body():
        calls.append(1)
        kernels.KERNELS["qmm"].wrapper.launches += 2
        forwards["decode"] += 1
        if len(calls) == 2:   # the capture, not the warm call
            raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        g.capture("k", body)
    assert "k" not in g and kernels.launch_counts()["qmm"] == 2 and forwards["decode"] == 1
