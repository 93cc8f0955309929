"""The port's compiled prefill, admission and chunk steps held against the
TPU package's jitted programs, and kernel 4's device offset.

On the CPU the graph bodies run eagerly, so what is held here is the body
the card captures:
- kernel 4's plain version with the offset as a 1-element int32 tensor, a
  host bound and per-row cache rows, against the TPU kernel in interpret
  mode at a traced offset (1e-2 of each row's norm) and bit-equal to the
  host-int call;
- the runner's padded prefill (the prompt right-padded to S_pad, at the
  device offset) against the TPU package's prefill at the exact length:
  logits of the real rows and the cache below the offset within
  tests/test_torch_graphs.py's tolerance (atol 2e-4, rtol 1e-3, fp32), greedy
  tokens EQUAL on both sides of a bucket edge and after a second prefill at
  a non-zero offset;
- every engine mode over a 300-slot cache (three live-length buckets, so
  chunks run under several bounds) giving the TPU package's greedy tokens;
- on a fake card (``fake_card``): the graph keys, the bound on their number,
  replays equal to forwards per kind once every graph is captured, and the
  host's refusal of a chunk that would run past its slot.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.ops.pallas import flash as jflash
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu_torch.ops.cuda.flash import flash_prefill_blocked_plain
from gptq_for_llama_tpu_torch.runtime import GenRequest, ServingEngine, generate
from gptq_for_llama_tpu_torch.runtime import graphs
from gptq_for_llama_tpu_torch.runtime.runner import prefill_len

from test_torch_fold import _count_jax_folds
from test_torch_fold import _models as _fold_models
from test_torch_graphs import _recording, _runners, fake_card  # noqa: F401  (a fixture)
from test_torch_serve import _run_jax, _setup

ATOL, RTOL = 2e-4, 1e-3


def _row_rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)).max())


# -- kernel 4 -------------------------------------------------------------------

@pytest.mark.parametrize("off,hkv", [(0, 4), (64, 2), (128, 1)])
def test_kernel4_device_offset_matches_pallas_at_a_traced_offset(off, hkv):
    """Two query rows over a three-row cache (``rows`` = 2, 0): the plain
    version with a device offset and its bound against the TPU kernel (its
    offset traced under jit, interpret mode) on the rows' own caches; and
    bit-equal to the host-int call on those caches."""
    b, sq, bkv, skv, h, d = 2, 128, 3, 384, 4, 128
    rng = np.random.RandomState(off + hkv)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((bkv, skv, hkv, d)).astype(np.float32) for _ in range(2))
    rows = np.array([2, 0], np.int32)
    run = jax.jit(lambda q, k, v, o: jflash.flash_prefill_blocked(q, k, v, o, d ** -0.5,
                                                                  interpret=True))
    want = np.asarray(run(jnp.asarray(q), jnp.asarray(k[rows]), jnp.asarray(v[rows]),
                          jnp.int32(off)))
    tq, tk, tv = torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v)
    off_t = torch.tensor([off], dtype=torch.int32)
    got = flash_prefill_blocked_plain(tq, tk, tv, off_t, d ** -0.5, bound=off + sq + 5,
                                      rows=torch.as_tensor(rows))
    assert _row_rel(got.numpy(), want) <= 1e-2
    host = flash_prefill_blocked_plain(tq, tk[rows], tv[rows], off, d ** -0.5)
    assert torch.equal(got, host)


# -- the cache protocol with a device slot and offset ------------------------------

DEVICE_FORMS = ("dense-prefill", "paged-prefill", "grouped", "grouped_paged", "grouped-alone",
                "grouped_paged-alone")


@pytest.mark.parametrize("form", DEVICE_FORMS)
def test_cache_protocol_device_forms_match_jax(form):
    """The forms the graphs capture, with the slot and the chunk offset as
    1-element int32 tensors and a host bound above offset + C, against the
    TPU package's forms with the same values traced (fp32): the runner's
    dense prefill, one slot's paged chunk, the token-fused step (dense and
    paged) and one slot's prompt alone through the fused forms without decode
    rows (held against the TPU engine's one-slot prefill: the slot's cache
    sliced, dense, or its table row, paged). Outputs within 1e-5, caches and
    pools equal."""
    from test_torch_paged import _pool, _tables
    from gptq_for_llama_tpu.models import common as jcommon
    from gptq_for_llama_tpu_torch.models import common
    rng = np.random.RandomState(len(form) + 7)
    b, mb, nb, bs, h, hkv, d, c = 3, 4, 16, 8, 4, 2, 16, 8
    s_len, bound = mb * bs, 31
    kp, vp = _pool(rng, nb, bs, hkv, d)
    kp[0] = vp[0] = 0.0   # the scratch block
    ck = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    tables = _tables(rng, b, mb, nb)
    offs = np.array([5, 17, 30], np.int32)
    live = np.array([True, False, True])
    slot, off0 = 1, 16
    slot_t = torch.tensor([slot], dtype=torch.int32)
    off_t = torch.tensor([off0], dtype=torch.int32)

    def qkv(rows, n):
        return [rng.standard_normal((rows, n, m, d)).astype(np.float32) for m in (h, hkv, hkv)]

    J, T = jnp.asarray, lambda a: torch.as_tensor(np.array(a))
    joff = J(np.array([off0], np.int32))
    rows = slice(None)   # the caches compared
    if form == "dense-prefill":
        q, k, v = qkv(b, c)
        jpast = (J(ck), J(cv), jnp.int32(off0))
        tpast = (T(ck), T(cv), off_t, None, bound)
        jmask = jcommon.decode_mask(c, s_len, jnp.int32(off0))
    elif form == "paged-prefill":
        q, k, v = qkv(1, c)
        jpast = ("paged", J(kp), J(vp), J(tables[1:2]), joff)
        tpast = ("paged", T(kp), T(vp), T(tables[1:2]), off_t, None, bound)
        jmask = jcommon.decode_mask(c, s_len, joff)
    elif form in ("grouped", "grouped_paged"):
        q, k, v = qkv(1, b + c)
        head = (J(ck), J(cv)) if form == "grouped" else (J(kp), J(vp), J(tables))
        jpast = (form, *head, J(offs), J(live), jnp.int32(slot), jnp.int32(off0), b)
        head = (T(ck), T(cv)) if form == "grouped" else (T(kp), T(vp), T(tables))
        tpast = (form, *head, T(offs), T(live), slot_t, off_t, b, bound)
        jmask = None
    elif form == "grouped-alone":
        q, k, v = qkv(1, c)
        jpast = (J(ck[slot:slot + 1]), J(cv[slot:slot + 1]), joff)
        tpast = ("grouped", T(ck), T(cv), None, None, slot_t, off_t, 0, bound)
        jmask = jcommon.decode_mask(c, s_len, joff)
        rows = slice(slot, slot + 1)
    else:
        q, k, v = qkv(1, c)
        jpast = ("paged", J(kp), J(vp), J(tables[slot:slot + 1]), joff)
        tpast = ("grouped_paged", T(kp), T(vp), T(tables), None, None, slot_t, off_t, 0, bound)
        jmask = jcommon.decode_mask(c, s_len, joff)
    jout, jpresent = jcommon.attention_block(jpast, J(q), J(k), J(v), jmask)
    tout, tpresent = common.attention_block(tpast, T(q), T(k), T(v), None)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    for g, w in zip(tpresent, jpresent):
        np.testing.assert_array_equal(g.numpy()[rows], np.asarray(w))


# -- the runner's prefill graphs --------------------------------------------------

def test_prefill_len_rule():
    """The smallest power of two from 16 that holds the prompt and fits the
    room left; the prompt's own length where none fits."""
    assert [prefill_len(s, 2048) for s in (1, 16, 17, 37, 100, 201, 2000)] == \
        [16, 16, 32, 64, 128, 256, 2048]
    assert prefill_len(20, 24) == 20 and prefill_len(20, 32) == 32 and prefill_len(5, 8) == 5


def _jax_cache_layer(jcache, li):
    return np.asarray(jcache.k[li]), np.asarray(jcache.v[li])


@pytest.mark.parametrize("first,second", [(9, 0), (16, 0), (17, 0), (9, 7), (17, 20)])
def test_padded_prefill_matches_jax(first, second):
    """Prompts of 9, 16 and 17 tokens (S_pad 16, 16, 32), then optionally a
    second prefill at offset ``first``: the logits of the real rows and every
    layer's cache below the offset against the TPU package's runner, the
    offsets advanced by S, not S_pad."""
    jr, r = _runners(kv_heads=2, max_len=64, seed=40 + first)
    rng = np.random.RandomState(first * 31 + second)
    parts = [rng.randint(0, 96, size=(1, n)).astype(np.int32) for n in (first, second) if n]
    jcache, cache = jr.init_cache(), r.init_cache()
    for ids in parts:
        want, jcache = jr.prefill(jnp.asarray(ids), jcache)
        got, cache = r.prefill(torch.as_tensor(ids), cache)
        assert got.shape == (1, ids.shape[1], 96)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    n = cache.offset
    assert n == first + second == int(jcache.offset)
    for li in range(len(cache.k)):
        jk, jv = _jax_cache_layer(jcache, li)
        np.testing.assert_allclose(cache.k[li][:, :n].numpy(), jk[:, :n], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(cache.v[li][:, :n].numpy(), jv[:, :n], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("length", [16, 17, 32, 33])
def test_generate_across_a_bucket_edge_matches_jax(length):
    """Greedy generate from prompts on both sides of the 16 and 32 buckets:
    the TPU package's tokens (its prefill compiled at the exact length)."""
    jr, r = _runners(max_len=64, seed=50 + length)
    prompt = np.random.RandomState(length).randint(0, 96, size=length).astype(np.int32)
    want = np.asarray(jax_generate(jr, prompt, max_new_tokens=8, temperature=0.0))
    np.testing.assert_array_equal(generate(r, prompt, max_new_tokens=8, temperature=0.0), want)


def test_second_prefill_then_greedy_matches_jax():
    """A prefill, a second prefill at its offset, then a greedy scan: the TPU
    package's tokens; the second prefill near the end of the cache pads to
    nothing (S_pad = S) where no bucket fits."""
    jr, r = _runners(max_len=64, seed=60)
    rng = np.random.RandomState(6)
    a, b2 = (rng.randint(0, 96, size=(1, n)).astype(np.int32) for n in (50, 12))
    jl, jcache = jr.prefill(jnp.asarray(a), jr.init_cache())
    jl, jcache = jr.prefill(jnp.asarray(b2), jcache)
    want, _ = jr.decode_greedy_scan(jnp.argmax(jl[:, -1:], -1).astype(jnp.int32), jcache, 2)
    keys = _recording(r)
    lg, cache = r.prefill(torch.as_tensor(a), r.init_cache())
    lg, cache = r.prefill(torch.as_tensor(b2), cache)   # 14 slots left: 16 does not fit
    got, cache = r.decode_greedy_scan(lg[:, -1:].argmax(-1), cache, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert keys[:2] == [("prefill", 64, 64), ("prefill", 12, 64)] and cache.offset == 64


def test_eager_step_is_the_prefill_body():
    """``_step`` with a prompt runs the prefill graph's body under the same
    key's plan: bit-equal logits and caches to ``prefill``."""
    _, r = _runners(max_len=64, seed=61)
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 96, size=(1, 21)))
    a, ca = r.prefill(ids, r.init_cache())
    ka = [t.clone() for t in ca.k]
    b, cb = r._step(ids, r.init_cache())
    assert torch.equal(a, b) and ca.offset == cb.offset == 21
    assert all(torch.equal(x, y) for x, y in zip(ka, cb.k))


# -- the engine's steps -------------------------------------------------------------

ENGINE_MODES = {
    "dense": dict(admit_batch_max=0),
    "batched-admission": dict(),
    "paged": dict(paged=True, block_size=8),
    "chunked": dict(prefill_chunk=64, fused_chunk_decode=False),
    "chunked+fused": dict(prefill_chunk=64),
    "chunked+fused+paged": dict(prefill_chunk=64, paged=True, block_size=8),
    "fold": dict(cache_impl="fold"),
}
PROMPT_LENS = (5, 140, 33, 200, 9, 70)


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_steps_match_jax_engine_across_buckets(mode, monkeypatch):
    """Six requests of 5-200 tokens on three slots of a 300-slot cache (live
    buckets 128, 256, 300; prefill buckets 32, 128, 300; fold: 304): every mode's
    greedy tokens EQUAL the TPU package's engine, and the steps run as the
    keys the mode exists for."""
    if mode == "fold":   # the shapes the TPU package's fold kernel takes (304 % 8 == 0)
        max_len = 304
        jcfg, jparams, cfg, params = _fold_models(max_seq_len=max_len)
        calls = _count_jax_folds(monkeypatch)
    else:
        max_len = 300
        cfg, params, jcfg, jparams = _setup(max_seq_len=max_len)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    # the TPU engine has no admit_batch_max: its admissions give the same tokens
    jkw = {k: v for k, v in ENGINE_MODES[mode].items() if k not in ("cache_impl",
                                                                    "admit_batch_max")}
    want = _run_jax(jcfg, jparams, prompts, 6, slots=3, max_seq_len=max_len, buckets=(32, 128),
                    **jkw)
    if mode == "fold":
        assert calls, "the TPU package did not take its fold kernel"
    eng = ServingEngine("llama", cfg, params, batch_slots=3, max_seq_len=max_len,
                        dtype=torch.float32, prefill_buckets=(32, 128), device="cpu",
                        **ENGINE_MODES[mode])
    keys = _recording(eng)
    for uid, p in enumerate(prompts):
        eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=6))
    got = eng.run()
    assert set(got) == set(want) == set(range(len(prompts)))
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]), err_msg=f"request {uid}")
    kinds = {graphs.kind(k) for k in keys} - {"decode"}
    if "chunked" in mode:
        assert {k for k in keys if k[0] == "chunk" or k[0] == "chunk+decode"} and \
            {k[1] for k in keys if isinstance(k[0], str) and "chunk" in k[0]} >= {128, 256}
        assert kinds == ({"chunk", "chunk+decode"} if "fused" in mode else {"chunk"})
    else:
        assert kinds <= {"prefill", "admit"} and "prefill" in kinds
        assert {k[1] for k in keys if k[0] == "prefill"} <= {32, 128, max_len}
    per_kind = {}
    for k in keys:
        per_kind[graphs.kind(k)] = per_kind.get(graphs.kind(k), 0) + 1
    assert all(per_kind.get(kind, 0) == n for kind, n in eng.forwards.items()
               if kind != "decode")


# -- on a fake card -------------------------------------------------------------------

@pytest.fixture
def on_card(fake_card, monkeypatch):  # noqa: F811  (the fixture of test_torch_graphs)
    """Graphs of CPU owners capture and replay as on the card, through the
    fake graph API: a replay runs nothing, so only keys and counts mean
    anything."""
    monkeypatch.setattr(graphs.Graphs, "on_card", property(lambda self: True))


def _served(eng, lens, new=4, seed=9):
    rng = np.random.RandomState(seed)
    for uid, n in enumerate(lens):
        eng.submit(GenRequest(uid=uid, prompt=rng.randint(1, 64, size=n), max_new_tokens=new))
    eng.run()


@pytest.mark.parametrize("chunk", [None, 128])
def test_engine_graph_keys_are_bounded(on_card, chunk):
    """At max_len 2048 with the prefill buckets (32, 128, 512): at most 4
    prefill, 2 admission, 5 chunk and 5 chunk+decode keys, whatever the
    prompts; on a second run with every graph captured, each kind's replays
    equal its forwards."""
    cfg, params, _, _ = _setup(max_seq_len=2048)
    kw = dict(prefill_chunk=chunk) if chunk else {}
    eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=2048,
                        dtype=torch.float32, prefill_buckets=(32, 128, 512), device="cpu", **kw)
    lens = (5, 6, 40, 41, 200, 300, 700, 1900, 3, 1500)
    _served(eng, lens)
    keys = set(eng.graphs.keys())
    new = {k for k in keys if graphs.kind(k) != "decode"}
    assert len(new) <= 16
    if chunk:
        assert new <= {(kind, b) for kind in ("chunk", "chunk+decode")
                       for b in eng.decode_buckets}
        assert {b for kind, b in new if kind == "chunk+decode"} >= {128, 2048}
    else:
        assert new <= {("prefill", b) for b in (32, 128, 512, 2048)} | {("admit", 32),
                                                                        ("admit", 128)}
        assert ("prefill", 2048) in new and ("admit", 32) in new
    before = dict(eng.graphs.replays), dict(eng.forwards)
    _served(eng, lens, seed=10)
    assert set(eng.graphs.keys()) == keys   # nothing new to capture
    replays = {}
    for k, n in eng.graphs.replays.items():
        kind = graphs.kind(k)
        replays[kind] = replays.get(kind, 0) + n - before[0].get(k, 0)
    for kind in ("prefill", "admit", "chunk", "chunk+decode"):
        assert replays.get(kind, 0) == eng.forwards[kind] - before[1][kind]


def test_runner_prefill_keys_on_a_fake_card(on_card):
    """warmup captures the prefill graphs it is given; prompts of 37, 100 and
    201 tokens replay ("prefill", 64 | 128 | 256, bucket) and capture nothing
    once warmed; a second prefill at an offset takes its own bucket."""
    _, r = _runners(max_len=300, seed=62)
    r.warmup(prefill_buckets=(37, 100, 201))
    keys = set(r.graphs.keys())
    assert {("prefill", 64, 128), ("prefill", 128, 128), ("prefill", 256, 256)} <= keys
    for n in (37, 100, 201):
        r.prefill(torch.zeros((1, n), dtype=torch.long), r.init_cache())
    assert set(r.graphs.keys()) == keys
    assert r.graphs.replays[("prefill", 128, 128)] == 2   # warmup's call, then this one
    _, cache = r.prefill(torch.zeros((1, 100), dtype=torch.long), r.init_cache())
    r.prefill(torch.zeros((1, 30), dtype=torch.long), cache)
    assert ("prefill", 32, 256) in r.graphs.keys()


@pytest.mark.parametrize("paged", [False, True])
def test_a_chunk_past_its_slot_is_refused_on_the_host(on_card, paged):
    """A chunk whose write would run past the slot's cache row (dense) or its
    owned blocks (paged, where a device offset's block columns would be
    clamped) raises before anything is loaded or replayed."""
    cfg, params, _, _ = _setup(max_seq_len=64)
    eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=64,
                        dtype=torch.float32, prefill_chunk=16, paged=paged, block_size=8,
                        device="cpu")
    _served(eng, (20,), new=2)
    state = eng.state
    if paged:   # slot 0 owns the blocks of its chunk-padded prompt and span: 4 of 8
        owned = len(eng._paged_alloc.owned[0])
        off0 = owned * 8 - 8
    else:
        off0 = eng.max_len - 8
    captured, meta = set(eng.graphs.keys()), state["slot_meta"].clone()
    with pytest.raises(ValueError, match="slot 0"):
        eng._prefill_slot(state, 0, np.arange(16), off0, 15, "chunk")
    with pytest.raises(ValueError, match="slot 0"):
        eng._chunk_decode_step(state, 0, np.arange(16), off0, 15)
    assert set(eng.graphs.keys()) == captured and torch.equal(state["slot_meta"], meta)
    eng._prefill_slot(state, 0, np.arange(8), off0, 7, "chunk")   # one that fits runs
