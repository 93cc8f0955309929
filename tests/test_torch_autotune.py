"""The port's measured plan race of kernels 1, 2 and 8 (``ops/cuda/autotune.py``)
on the CPU: the counterpart of the CPU half of tests/test_autotune.py. The
race itself needs the card, so its timer is faked here (and the card's name
and SM count, and the wrappers' checks that operands are CUDA tensors); the
candidates, the choice of a winner, the cache, the knobs and the kernels'
``plan_for`` lookups are pinned."""

import json

import numpy as np
import pytest
import torch

from gptq_for_llama_tpu_torch.ops.cuda import autotune as at
from gptq_for_llama_tpu_torch.ops.cuda import matmul, matmul_t, mlp
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.quant import packing

SMS = 132
CARD = "NVIDIA_H100_80GB_HBM3"
# (kind, K, N, M): LLaMA-7B's decode, serving and prefill rows
CASES = [("fwd", 4096, 4096, 1), ("fwd", 4096, 4096, 8), ("fwd", 4096, 4096, 1024),
         ("fwd", 11008, 4096, 1), ("fwd", 11008, 4096, 16), ("fwd", 11008, 4096, 136),
         ("mlp", 4096, 11008, 1), ("mlp", 4096, 11008, 8), ("mlp", 4096, 11008, 512),
         ("bwd", 4096, 4096, 1024), ("bwd", 11008, 4096, 100), ("fwd", 4096, 4096, 3)]


def _lin(k=512, n=256, bits=4, gs=128, seed=0):
    rng = np.random.RandomState(seed)
    g = k // gs
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    return PackedLinear.from_wire(packing.pack_rows(codes, bits),
                                  packing.pack_cols(zeros - 1, bits),
                                  (rng.rand(g, n) * 0.02 + 0.005).astype(np.float16),
                                  (np.arange(k) // gs).astype(np.int32), bits=bits,
                                  dtype=torch.bfloat16, device="cpu")


def _heuristic(kind, k, n, m, bits=4, gs=128):
    if kind == "bwd":
        return matmul_t.plan(m, k, n, bits, SMS, groupsize=gs)
    return matmul.plan(m, k, n, bits, SMS, 2 if kind == "mlp" else 1, groupsize=gs)


@pytest.fixture
def tune(tmp_path, monkeypatch):
    """A fresh cache file, the knobs unset, the card faked: its name and SM
    count, and the wrappers' operand checks (CPU tensors here)."""
    path = str(tmp_path / "autotune.json")
    for name in (at.MODE_ENV, at.OVERRIDE_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(at.PATH_ENV, path)
    monkeypatch.setattr(at, "device_name", lambda device: CARD)
    for mod in (matmul, mlp, matmul_t):
        monkeypatch.setattr(mod, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(matmul, "check_packed", lambda lin, x: None)
    monkeypatch.setattr(matmul_t, "check_operands", lambda g, lin: None)
    at.reset_cache_for_tests()
    at.configure()
    yield path
    at.reset_cache_for_tests()


def _fake_measure(monkeypatch, fastest: int, spread: float = 0.0):
    """Candidate number ``fastest`` (in race order) takes 1 ms a replay, the
    others 2 ms; each replay's time spread by ``spread``."""
    calls = []

    def measure(run, reps=at.REPS):
        calls.append(run)
        t = 1e-3 if len(calls) - 1 == fastest else 2e-3
        return [t + spread * (i - reps // 2) / reps for i in range(reps)]

    monkeypatch.setattr(at, "measure", measure)
    return calls


@pytest.mark.parametrize("kind,k,n,m", CASES)
def test_candidates_are_valid_for_every_m_of_their_bucket(kind, k, n, m):
    """The heuristic's pick at the bucket's top comes first; every
    candidate is the plan its free choices build, covers K (N for kernel 8)
    with no empty split, fits an SM's shared memory, and is valid for every M
    of the pow2 bucket: the batch-1 decode form is raced at the M = 1 bucket
    only, the fragment form holds at most 8 rows per n8 tile and needs
    ``frag_ok``, cluster splits are powers of two up to the kernels' limit;
    kernels 1, 2 and 8 race both tensor-core bodies (the mma.sync tiles and
    the wgmma body, which takes any M)."""
    mb = at.m_bucket(m)
    cands = at.candidates(kind, k, n, 4, 128, m, SMS)
    assert cands[0] == _heuristic(kind, k, n, mb)
    assert len({(p.path, p.mt, p.split) for p in cands}) == len(cands)
    if kind in ("fwd", "mlp"):
        assert {p.path for p in cands} >= ({"gemv", "frag", "tile", "wgmma"} if mb <= 16 else
                                           {"gemv", "tile", "wgmma"})
        assert ("decode" in {p.path for p in cands}) == (mb == 1)
    else:
        assert {p.path for p in cands} == {"tile", "wgmma"}
    for p in cands:
        assert p.smem <= matmul.SMEM_PER_SM - 1024
        if p.path == "decode":   # no free choice, no K split: stages of word rows
            streams = 2 if kind == "mlp" else 1
            assert p == matmul._decode_plan(1, k, n, 4, SMS, streams, 128, None)
            assert (p.split, mb) == (1, 1) and p.per_split in (64, 128, 256)
            assert p.mt in matmul.DEC_STRIPS[streams]
            continue
        if kind == "bwd":
            assert p == matmul_t.plan_of(p.mt, p.split, n, 4, p.path)
            units = -(-n // matmul_t.SLICE_N)
        else:
            assert p == matmul.plan_of(p.path, p.mt, p.split, k, 4, 2 if kind == "mlp" else 1)
            units = {"gemv": k // 8, "frag": -(-k // matmul.frag_rows_per_block(4)),
                     "tile": -(-k // matmul.TC_TILE_K), "wgmma": -(-k // matmul.WG_DEPTH)}[p.path]
        assert p.split * p.per_split >= units > (p.split - 1) * p.per_split
        if p.path in ("gemv", "frag"):
            assert p.split & (p.split - 1) == 0 and p.split <= matmul.CLUSTER_LIMIT
        if p.path in ("tile", "wgmma"):
            assert p.mt in (matmul.TC_ROW_TILES if p.path == "tile" else matmul.WG_ROW_TILES)
            assert p.per_split >= at.TILE_MIN_SLABS or p == cands[0] or p.split == 1
        for rows in range(mb // 2 + 1, mb + 1):
            if p.path == "frag":
                assert rows <= p.mt and matmul.frag_ok(k, n, 4, 128)
            if p.path == "gemv":
                assert p.mt in (1, 2, 4, 8)


def test_store_lookup_persist_and_cold_reload(tune):
    """An entry answers every M of its pow2 bucket and no other; a new
    process (``reset`` + ``configure``) reads it back from the file, which
    holds the version and the free choices under a key naming the card."""
    p = at.candidates("fwd", 4096, 4096, 4, 128, 8, SMS)[3]
    key = at.store("fwd", 4096, 4096, 4, 128, 8, p, CARD)
    assert key == f"fwd:K4096:N4096:b4:g128:M8:{CARD}"
    for m in (5, 6, 8):
        assert at.lookup("fwd", 4096, 4096, 4, 128, m, SMS, "cuda") == p
    assert at.lookup("fwd", 4096, 4096, 4, 128, 4, SMS, "cuda") is None
    assert at.lookup("fwd", 4096, 4096, 4, 128, 16, SMS, "cuda") is None
    assert at.lookup("mlp", 4096, 4096, 4, 128, 8, SMS, "cuda") is None
    at.reset_cache_for_tests()
    at.configure()
    assert at.lookup("fwd", 4096, 4096, 4, 128, 7, SMS, "cuda") == p
    with open(tune) as f:
        data = json.load(f)
    assert data == {"version": at.VERSION,
                    "entries": {key: {"path": p.path, "mt": p.mt, "split": p.split}}}


def test_the_key_names_the_card(tune, monkeypatch):
    """Another card's name misses this card's entries."""
    p = at.candidates("fwd", 4096, 4096, 4, 128, 1, SMS)[1]
    at.store("fwd", 4096, 4096, 4, 128, 1, p, CARD)
    assert at.lookup("fwd", 4096, 4096, 4, 128, 1, SMS, "cuda") == p
    monkeypatch.setattr(at, "device_name", lambda device: "NVIDIA_H100_PCIe")
    at.configure()
    assert at.lookup("fwd", 4096, 4096, 4, 128, 1, SMS, "cuda") is None


@pytest.mark.parametrize("kind", ["fwd", "mlp", "bwd"])
def test_the_race_stores_the_fake_fastest(tune, monkeypatch, kind):
    """Every candidate is timed once over the chain of all the linears (or
    pairs) of the shape; the fastest, faster than the heuristic's pick by
    more than its spread, is stored and returned; a second race of the same
    shape is a cache hit and measures nothing."""
    lins = [_lin(seed=s) for s in range(3)]
    m = 64 if kind == "bwd" else 8
    k, n = lins[0].in_features, lins[0].out_features
    cands = at.candidates(kind, k, n, 4, 128, m, SMS)
    calls = _fake_measure(monkeypatch, fastest=len(cands) - 1, spread=1e-4)
    if kind == "mlp":
        pairs = [(lins[0], lins[1]), (lins[2], lins[0])]
        got = at.tune_mlp(pairs, m)
        again = at.tune_mlp(pairs, m)
    else:
        got = at.tune_qmm(lins, m, kind)
        again = at.tune_qmm(lins, m, kind)
    assert got == again == cands[-1] and len(calls) == len(cands)
    assert at.lookup(kind, k, n, 4, 128, m, SMS, "cuda") == cands[-1]
    other = {"fwd": "bwd", "bwd": "fwd", "mlp": "fwd"}[kind]
    assert at.lookup(other, k, n, 4, 128, m, SMS, "cuda") is None


def test_a_candidate_wins_only_by_more_than_its_spread():
    """No near-tie rule: the heuristic's pick (first) stays unless another
    median is faster by more than that candidate's own spread; then the
    fastest such median wins."""
    a, b, c = "heuristic", "b", "c"
    assert at.pick([(a, [1.0, 1.0]), (b, [0.9, 1.05])])[0] == a
    assert at.pick([(a, [1.0, 1.0]), (b, [0.9, 0.95]), (c, [0.8, 0.9])])[0] == c
    # c's median is the fastest, but its spread is larger than its lead
    assert at.pick([(a, [1.0, 1.2, 1.1]), (b, [0.5, 0.6, 0.55]), (c, [0.4, 1.1, 0.45])])[0] == b


@pytest.mark.parametrize("times", [[0.0, 1e-3], [-1e-3, 1e-3], [float("nan")], [float("inf")],
                                   []])
def test_a_timing_that_is_not_positive_raises(tune, monkeypatch, times):
    """A zero, negative, NaN or infinite replay time (or none) raises rather
    than wins, and nothing is stored."""
    with pytest.raises(RuntimeError, match="positive"):
        at.pick([("heuristic", [1e-3]), ("other", times)])
    monkeypatch.setattr(at, "measure", lambda run, reps=at.REPS: times)
    with pytest.raises(RuntimeError, match="positive"):
        at.tune_qmm([_lin()], 1)
    assert at.lookup("fwd", 512, 256, 4, 128, 1, SMS, "cuda") is None


@pytest.mark.parametrize("kind", ["fwd", "mlp", "bwd"])
def test_plan_for_returns_the_stored_plan(tune, kind):
    """The kernels' ``plan_for`` answers with the tuned plan on a hit and
    with the heuristic on a miss (another bucket)."""
    lin = _lin(n=1024)
    k, n = lin.in_features, lin.out_features
    cands = at.candidates(kind, k, n, 4, 128, 4, SMS)
    at.store(kind, k, n, 4, 128, 4, cands[-1], CARD)

    def plan_for(m):
        if kind == "bwd":
            return matmul_t.plan_for(torch.zeros(m, n, dtype=torch.bfloat16), lin)
        x = torch.zeros(m, k, dtype=torch.bfloat16)
        return (mlp.plan_for(x, lin) if kind == "mlp" else matmul.plan_for(x, lin))

    assert plan_for(3) == plan_for(4) == cands[-1] != _heuristic(kind, k, n, 4)
    assert plan_for(5) == _heuristic(kind, k, n, 5)


def test_mode_0_and_ro(tune, monkeypatch):
    """GPTQ_TORCH_AUTOTUNE=0: the cache is not read (the heuristic only);
    "ro": it is read; neither measures on ``ensure_*``; a mode that is
    neither raises. The knobs are read by ``configure`` only."""
    p = at.candidates("fwd", 512, 256, 4, 128, 1, SMS)[-1]
    at.store("fwd", 512, 256, 4, 128, 1, p, CARD)
    calls = _fake_measure(monkeypatch, fastest=0)
    monkeypatch.setenv(at.MODE_ENV, "0")
    assert at.lookup("fwd", 512, 256, 4, 128, 1, SMS, "cuda") == p   # not read again yet
    at.configure()
    assert at.lookup("fwd", 512, 256, 4, 128, 1, SMS, "cuda") is None
    assert matmul.plan_for(torch.zeros(1, 512, dtype=torch.bfloat16), _lin()) == \
        _heuristic("fwd", 512, 256, 1)
    monkeypatch.setenv(at.MODE_ENV, "ro")
    at.configure()
    assert at.lookup("fwd", 512, 256, 4, 128, 1, SMS, "cuda") == p
    at.ensure_linears([_lin(k=1024)], 1)
    assert calls == []
    monkeypatch.setenv(at.MODE_ENV, "on")
    with pytest.raises(ValueError, match=at.MODE_ENV):
        at.configure()


@pytest.mark.parametrize("text", [
    "fwd:K4096:N4096=frag,16", "fwd:K4096=tile,64,1", "mlp:K4096:N11008=warp,8,1",
    "dx:K4096:N4096=tile,64,1", "fwd:K4096:N4096:M3=frag,8,1", "bwd:K4096:N4096=frag,8,1",
    "mlp:K4096:N11008:M100=wgmma,128,1", "bwd:K4096:N4096=wgma,128,1",
    "fwd:K4096:N4096=tile,64,1;fwd:K4096:N4096=tile,64,2", "fwd:K4096:N4096=tile,64,1,2",
    "fwd:k4096:n4096=tile,64,1"])
def test_a_malformed_override_raises(tune, monkeypatch, text):
    monkeypatch.setenv(at.OVERRIDE_ENV, text)
    with pytest.raises(ValueError, match=at.OVERRIDE_ENV):
        at.configure()


def test_overrides_pin_and_are_checked_against_the_candidates(tune, monkeypatch):
    """A valid override pins its shape (every bucket, or the one it names),
    in mode "0" too and over a cached entry; one that is not a candidate of
    the shape at the bucket looked up raises, naming the entry."""
    at.store("fwd", 4096, 4096, 4, 128, 1, at.candidates("fwd", 4096, 4096, 4, 128, 1, SMS)[1],
             CARD)
    monkeypatch.setenv(at.MODE_ENV, "0")
    monkeypatch.setenv(at.OVERRIDE_ENV,
                       "fwd:K4096:N4096=frag,16,4; mlp:K4096:N11008:M1=gemv,1,8")
    at.configure()
    got = at.lookup("fwd", 4096, 4096, 4, 128, 16, SMS, "cuda")
    assert (got.path, got.mt, got.split) == ("frag", 16, 4)
    got = at.lookup("mlp", 4096, 11008, 4, 128, 1, SMS, "cuda")
    assert (got.path, got.mt, got.split) == ("gemv", 1, 8)
    assert at.lookup("mlp", 4096, 11008, 4, 128, 2, SMS, "cuda") is None
    with pytest.raises(ValueError, match="fwd:K4096:N4096"):
        at.lookup("fwd", 4096, 4096, 4, 128, 1, SMS, "cuda")   # frag mt 16 is not M = 1's
    with pytest.raises(ValueError, match="fwd:K4096:N4096"):
        at.lookup("fwd", 4096, 4096, 4, 128, 1024, SMS, "cuda")


def test_a_cached_entry_that_is_not_a_candidate_raises(tune):
    """The error names the cache file and the key; a file of another
    version raises too."""
    key = f"fwd:K4096:N4096:b4:g128:M1024:{CARD}"
    with open(tune, "w") as f:
        json.dump({"version": at.VERSION, "entries": {key: {"path": "frag", "mt": 8,
                                                            "split": 2}}}, f)
    at.configure()
    with pytest.raises(ValueError, match=key) as err:
        at.lookup("fwd", 4096, 4096, 4, 128, 1000, SMS, "cuda")
    assert tune in str(err.value)
    with open(tune, "w") as f:
        json.dump({"version": at.VERSION + 1, "entries": {}}, f)
    at.configure()
    with pytest.raises(ValueError, match="version"):
        at.lookup("fwd", 4096, 4096, 4, 128, 1, SMS, "cuda")


def test_ensure_is_a_no_op_on_the_cpu(tune, monkeypatch):
    """On the CPU nothing is measured: ``ensure_*`` and the runner's
    ``warmup`` (autotune on) of a packed LLaMA; the tuning units are the
    kernel-1 linears and the fusable gate/up pairs."""
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    from gptq_for_llama_tpu_torch.runtime import ModelRunner
    from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_llama
    calls = _fake_measure(monkeypatch, fastest=0)
    cfg = ModelConfig(arch="llama", vocab_size=96, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32, max_seq_len=64)
    params = random_wire_llama(cfg, groupsize=32, device="cpu", dtype=torch.bfloat16)
    linears, pairs = at.collect(params, cfg.act)
    assert len(pairs) == 2 and len(linears) == 2 * 5
    assert not {id(x) for p in pairs for x in p} & {id(x) for x in linears}
    at.ensure_linears(linears, 1)
    at.ensure_mlp_pairs(pairs, 1)
    ModelRunner("llama", cfg, params, device="cpu").warmup(prefill_buckets=(16,))
    assert calls == [] and at.measurements == 0


def test_an_override_naming_the_wgmma_body_is_parsed_and_checked(tune, monkeypatch):
    """``path`` may name the wgmma body for kernels 1, 2 and 8: a row tile
    and split among the shape's candidates pins it (kernel 2's plan then
    has its 64-column tiles' shared memory, kernel 1's layout); one that is
    not (a row tile the body does not have) raises, naming the entry."""
    monkeypatch.setenv(at.OVERRIDE_ENV, "fwd:K4096:N4096:M1024=wgmma,256,1;"
                                        "bwd:K4096:N4096=wgmma,128,4;fwd:K4096:N4096:M128=wgmma,96,4;"
                                        "mlp:K4096:N11008:M1024=wgmma,256,2;"
                                        "mlp:K4096:N11008:M128=wgmma,96,1")
    at.configure()
    got = at.lookup("fwd", 4096, 4096, 4, 128, 1000, SMS, "cuda")
    assert (got.path, got.mt, got.split) == ("wgmma", 256, 1)
    assert got == matmul.plan_of("wgmma", 256, 1, 4096, 4)
    got = at.lookup("bwd", 4096, 4096, 4, 128, 128, SMS, "cuda")
    assert got == matmul_t.plan_of(128, 4, 4096, 4, "wgmma")
    got = at.lookup("mlp", 4096, 11008, 4, 128, 1000, SMS, "cuda")
    assert got == matmul.plan_of("wgmma", 256, 2, 4096, 4, 2)
    assert got.smem == matmul.wgmma_smem_bytes(4, 256)
    with pytest.raises(ValueError, match="fwd:K4096:N4096:M128"):
        at.lookup("fwd", 4096, 4096, 4, 128, 128, SMS, "cuda")
    with pytest.raises(ValueError, match="mlp:K4096:N11008:M128"):
        at.lookup("mlp", 4096, 11008, 4, 128, 128, SMS, "cuda")


def test_a_version_1_cache_raises(tune):
    """A cache of an earlier version (1, before the wgmma body; 2, before
    kernel 2's; 3, before the batch-1 decode form: their races never saw
    it) raises with its message instead of pinning an old plan."""
    assert at.VERSION == 4
    key = f"fwd:K4096:N4096:b4:g128:M1024:{CARD}"
    for old in (1, 2, 3):
        with open(tune, "w") as f:
            json.dump({"version": old, "entries": {key: {"path": "tile", "mt": 128,
                                                         "split": 1}}}, f)
        at.configure()
        with pytest.raises(ValueError, match=f"version {old}, this package writes 4"):
            at.lookup("fwd", 4096, 4096, 4, 128, 1024, SMS, "cuda")


@pytest.mark.parametrize("kind,k,n,m", [c for c in CASES if c[3] > 16]
                         + [("fwd", 4096, 2048, 128), ("bwd", 4096, 11008, 2048),
                            ("mlp", 4096, 11008, 128), ("mlp", 4096, 5504, 100)])
def test_wgmma_candidates_are_valid_for_every_m_of_their_bucket(kind, k, n, m):
    """The wgmma body's candidates: its row tiles (64, 128, 144, 256) up to
    the first that holds the bucket, each at its heuristic split and at
    every power-of-two split that keeps TILE_MIN_SLABS stages; any M of the
    bucket runs on each (wgmma's N is the row tile, rows past M read as
    zeros); its shapes must suit the body (g40 races the tiles only)."""
    mb = at.m_bucket(m)
    cands = [p for p in at.candidates(kind, k, n, 4, 128, m, SMS) if p.path == "wgmma"]
    tiles = []
    for bm in matmul.WG_ROW_TILES:
        tiles.append(bm)
        if bm >= mb:
            break
    assert {p.mt for p in cands} == set(tiles)
    units = -(-(k if kind != "bwd" else n) // 64)
    for p in cands:
        assert p.smem == matmul.wgmma_smem_bytes(4, p.mt)
        assert p.split * p.per_split >= units > (p.split - 1) * p.per_split
    assert not [p for p in at.candidates(kind, k, n, 4, 40, m, SMS) if p.path == "wgmma"]
