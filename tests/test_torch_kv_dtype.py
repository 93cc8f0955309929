"""KV caches stored in fp8 (e4m3, e5m2) and f32: the port's encoder, decoder,
kernel plain versions, runner, engine and CLIs held against the TPU package.

Inputs come from numpy with a seed and pass between the packages as bytes.
The encoder must give JAX's ``astype`` bytes; the decoder the TPU kernels'
``_load_f32`` / ``_load_bf16`` bits; the plain versions of kernels 3, 4, 7 and
9 the Pallas kernels' outputs in interpret mode (fp32: 2e-5, the same fp32
softmax summed in another order; kernel 4 feeds bf16 to its products: 3e-2 of
the largest output, as tests/test_torch_kernels.py), with cache bytes equal
after a write; the runner's and the engine's greedy tokens JAX's, their
logits within 1e-4 of JAX's (fp32 on both sides, the same fp8 values; the
XLA path of the TPU package sums in another order).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.ops.pallas import attention as jattn
from gptq_for_llama_tpu.ops.pallas import flash as jflash
from gptq_for_llama_tpu.runtime import ModelRunner as JaxModelRunner
from gptq_for_llama_tpu.runtime import generate as jax_generate
from gptq_for_llama_tpu.runtime.serve import GenRequest as JaxGenRequest
from gptq_for_llama_tpu.runtime.serve import ServingEngine as JaxServingEngine
from gptq_for_llama_tpu_torch.cli import serve as serve_cli
from gptq_for_llama_tpu_torch.cli.main import main as cli_main
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.ops import kv_dtype as kv
from gptq_for_llama_tpu_torch.ops.cuda.attention import (decode_attention,
                                                         fused_decode_attention,
                                                         pool_decode_attention)
from gptq_for_llama_tpu_torch.ops.cuda.flash import flash_prefill_blocked
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine, generate

from test_torch_serve import _np_llama

DTYPES = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "fp8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
          "f32": (torch.float32, jnp.float32)}
# the points where rounding and overflow change: e4m3's largest finite (448),
# the tie at 464 that rounds to 448, its overflow to NaN, e5m2's overflow
EDGES = [0.0, -0.0, 2.0 ** -10, 2.0 ** -9, 3 * 2.0 ** -10, 2.0 ** -17, 2.0 ** -16, 447.0, 448.0,
         463.9, 464.0, 465.0, 500.0, 57344.0, 61440.0, 1e6, 1e-3, 0.3, 1.0625]


def _pair(a: np.ndarray, name: str):
    """float32 values stored in cache dtype ``name``: (torch tensor, jax array),
    the same bytes (JAX's astype)."""
    tdt, jdt = DTYPES[name]
    j = jnp.asarray(a).astype(jdt)
    if tdt == torch.float32:
        return torch.from_numpy(np.asarray(j).copy()), j
    return torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(tdt), j


def _bytes(t) -> np.ndarray:
    """The bytes of a torch tensor or a jax array."""
    if isinstance(t, torch.Tensor):
        return kv.stored(t).contiguous().view(torch.uint8).numpy().reshape(-1) \
            if t.dtype in kv.FP8 else t.contiguous().numpy().view(np.uint8).reshape(-1)
    return np.asarray(t).view(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# the encoder and the decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("src", ["bfloat16", "float32"])
def test_encoder_bytes_equal_jax_astype(name, src):
    """Every edge, with its sign, and 20000 seeded values over 2^-24 .. 2^17
    (from bf16: all 65536 bit patterns as well): byte-equal to ``jnp.astype``
    from the same bf16 or f32 input, infinities included; a NaN input gives a
    NaN code (its sign and payload are not held to JAX's)."""
    rng = np.random.RandomState(0)
    vals = np.concatenate([np.asarray(EDGES), -np.asarray(EDGES),
                           rng.standard_normal(20000) * np.exp2(rng.uniform(-24, 17, 20000)),
                           [np.inf, -np.inf, np.nan]]).astype(np.float32)
    jx = jnp.asarray(vals).astype(getattr(jnp, src))
    if src == "bfloat16":
        every = jnp.asarray(np.arange(65536, dtype=np.uint32).astype(np.uint16)).view(jnp.bfloat16)
        jx = jnp.concatenate([jx, every])
    # the same input bits on both sides (a NaN's payload and sign included)
    tx = torch.from_numpy(np.asarray(jx).view(np.int16 if src == "bfloat16" else np.int32).copy())
    tx = tx.view(getattr(torch, src))
    tdt, jdt = DTYPES[name]
    want = np.asarray(jx.astype(jdt)).view(np.uint8)
    got = kv.encode(tx, tdt)
    nan = np.isnan(np.asarray(jx.astype(jnp.float32)))
    if tdt in kv.FP8:
        got = got.numpy()
        np.testing.assert_array_equal(got[~nan], want[~nan])
        assert np.isnan(kv.decode(torch.from_numpy(got[nan]).view(torch.float8_e5m2)).numpy()).all() \
            if name == "fp8_e5m2" else np.isin(got[nan], [0x7F, 0xFF]).all()
    else:
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want.reshape(-1))
    if name == "fp8":   # the overflow JAX writes as NaN, where torch saturates
        assert kv.encode(torch.tensor([500.0, -500.0, 464.0]), tdt).tolist() == [0x7F, 0xFF, 0x7E]
        assert torch.tensor(500.0).to(tdt).view(torch.uint8).item() != 0x7F


def test_decoder_equals_tpu_loads_on_every_code():
    """All 256 e4m3 codes: ``decode`` equals ``_load_f32`` and, into bf16,
    ``_load_bf16`` bit for bit; each equals ``astype`` but at 0x7F and 0xFF
    (+-480, not NaN). e5m2 and f32 decode as ``astype`` (e5m2's NaN codes
    to a NaN, whatever its payload); an f32 value read into bf16 rounds to
    nearest even."""
    codes = np.arange(256, dtype=np.uint8)
    t = torch.from_numpy(codes.copy()).view(torch.float8_e4m3fn)
    j = jnp.asarray(codes).view(jnp.float8_e4m3fn)
    got32 = kv.decode(t).numpy()
    np.testing.assert_array_equal(got32.view(np.uint32),
                                  np.asarray(jattn._load_f32(j)).view(np.uint32))
    np.testing.assert_array_equal(kv.decode(t, torch.bfloat16).view(torch.int16).numpy(),
                                  np.asarray(jflash._load_bf16(j)).view(np.int16))
    astype = np.asarray(j.astype(jnp.float32))
    nan = np.isin(codes, [0x7F, 0xFF])
    np.testing.assert_array_equal(got32[~nan].view(np.uint32), astype[~nan].view(np.uint32))
    assert np.isnan(astype[nan]).all() and got32[nan].tolist() == [480.0, -480.0]
    e5 = torch.from_numpy(codes.copy()).view(torch.float8_e5m2)
    np.testing.assert_array_equal(   # floats: NaN where NaN, signed zeros and infs equal
        kv.decode(e5).numpy(),
        np.asarray(jnp.asarray(codes).view(jnp.float8_e5m2).astype(jnp.float32)), strict=True)
    f = np.random.RandomState(1).standard_normal(4096).astype(np.float32)
    np.testing.assert_array_equal(
        kv.decode(torch.from_numpy(f), torch.bfloat16).view(torch.int16).numpy(),
        np.asarray(jflash._load_bf16(jnp.asarray(f))).view(np.int16))


def test_e4m3_bf16_pair_form_equals_load_bf16_on_every_code():
    """A numpy model of kernel 4's e4m3 -> bf16 bit form (csrc/kv_dtype.cuh
    ``e4m3x2_bf16``, which both its bodies convert through): two codes byte
    permuted to bits 8-15 and 24-31 of a word, (t & 0x80008000) | ((t >> 4) &
    0x07F007F0) as a bf16 pair, each lane times 2^120 in one bf16 multiply
    (exact, subnormals kept). Every code in either lane, beside every other
    code, gives ``_load_bf16``'s bf16 bit for bit (0x7F / 0xFF: +-480, 0x80:
    -0)."""
    lo, hi = (a.reshape(-1).astype(np.uint32) for a in np.meshgrid(np.arange(256),
                                                                    np.arange(256)))
    t = (hi << 24) | (lo << 8)   # __byte_perm(u, 0, 0x1404): code 0 low, code 1 high
    b = (t & 0x80008000) | ((t >> 4) & 0x07F007F0)

    def lane(bits):   # a bf16 lane times 2^120 in float32 (numpy keeps subnormals)
        v = ((bits.astype(np.uint32) << 16).view(np.float32) * np.float32(2.0 ** 120))
        assert (v.view(np.uint32) & 0xFFFF == 0).all()   # exact: a bf16, no rounding
        return (v.view(np.uint32) >> 16).astype(np.uint16)

    want = np.asarray(jflash._load_bf16(jnp.arange(256, dtype=jnp.uint8).view(
        jnp.float8_e4m3fn))).view(np.uint16)
    np.testing.assert_array_equal(lane(b & 0xFFFF), want[lo])
    np.testing.assert_array_equal(lane(b >> 16), want[hi])
    assert want[0x7F] == 0x43F0 and want[0xFF] == 0xC3F0 and want[0x80] == 0x8000


# ---------------------------------------------------------------------------
# kernels 3, 7, 9 and 4: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _cache_values(rng, shape, name):
    """Seeded cache values; an e4m3 cache also holds its two NaN codes'
    values (+-480, what the kernels read them as) at a few slots."""
    a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    if name == "fp8":
        a.reshape(-1)[rng.choice(a.size, 8, replace=False)] = [480.0, -480.0] * 4
    return a


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,offs", [(3, 8, 8, (0, 17, 31)), (2, 8, 2, (9, 30))])
def test_decode_attention_plain_matches_pallas(name, b, h, hkv, offs):
    """Kernel 3, dense and GQA, at tests/test_torch_kernels.py's shapes."""
    s, d = 32, 128
    rng = np.random.RandomState(b + hkv)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    (tk, jk), (tv, jv) = (_pair(_cache_values(rng, (b, s, hkv, d), name), name)
                          for _ in range(2))
    off = np.asarray(offs, np.int32)
    got = decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(off), d ** -0.5)
    want = jattn.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(off), d ** -0.5,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(DTYPES))
def test_pool_decode_attention_plain_matches_pallas(name):
    """Kernel 7: GQA, permuted physical blocks, varied live lengths."""
    rng = np.random.RandomState(0)
    b, h, hkv, d, bs, mb, nb = 3, 8, 4, 128, 16, 8, 32
    (tk, jk), (tv, jv) = (_pair(_cache_values(rng, (nb, bs, hkv, d), name), name)
                          for _ in range(2))
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    offs = np.array([5, 37, 127], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    got = pool_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
                                torch.from_numpy(offs), d ** -0.5)
    want = jattn.pool_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                                       jnp.asarray(offs), d ** -0.5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(DTYPES))
def test_fused_decode_attention_plain_matches_pallas_with_masked_write(name):
    """Kernel 9 with its row write under a mixed mask: the current k/v are
    rounded to the cache dtype as the TPU wrapper does, the output within
    2e-5, the caches byte-equal after the write (one k value overflows e4m3:
    its code is NaN in both)."""
    rng = np.random.RandomState(5)
    b, s, h, hkv, d = 3, 64, 8, 8, 128
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, 1, hkv, d)).astype(np.float32) for _ in range(2))
    kn[1, 0, 0, 0] = 600.0     # row 1 is written: e4m3 stores NaN there
    (tk, jk), (tv, jv) = (_pair(_cache_values(rng, (b, s, hkv, d), name), name)
                          for _ in range(2))
    offs = np.array([3, 40, 63], np.int32)
    mask = np.array([True, True, False])
    got, gk, gv = fused_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
                                         torch.from_numpy(vn), torch.from_numpy(offs),
                                         d ** -0.5, write_mask=torch.from_numpy(mask))
    want, wk, wv = jattn.fused_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(kn),
                                                jnp.asarray(vn), jnp.asarray(offs), d ** -0.5,
                                                write_mask=jnp.asarray(mask), interpret=True)
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(_bytes(gk), _bytes(wk))
    np.testing.assert_array_equal(_bytes(gv), _bytes(wv))
    ok = np.isfinite(np.asarray(want)).reshape(b, -1).all(1)
    if name == "fp8":   # row 1 folded a NaN (JAX) or 480 (the port's read) code: not compared
        assert not ok[1] and np.asarray(gk.view(torch.uint8))[1, 40, 0, 0] == 0x7F
        ok[1] = False
    np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("off", [0, 128])
def test_flash_prefill_blocked_plain_matches_pallas(name, off):
    """Kernel 4 at offset 0 and 128: bf16 q against a cache in each dtype
    (3e-2 of the largest output: the TPU kernel rounds p to bf16). Its plain
    version reads the cache through ``_load_bf16``: an f32 cache gives the
    same bits as that cache rounded to bf16 first."""
    b, sq, skv, h, hkv, d = 1, 128, 256, 4, 2, 128
    rng = np.random.RandomState(off + len(name))
    q = jnp.asarray(rng.standard_normal((b, sq, h, d)).astype(np.float32)).astype(jnp.bfloat16)
    tq = torch.from_numpy(np.asarray(q.astype(jnp.float32))).bfloat16()
    (tk, jk), (tv, jv) = (_pair(_cache_values(rng, (b, skv, hkv, d), name), name)
                          for _ in range(2))
    got = flash_prefill_blocked(tq, tk, tv, off, d ** -0.5)
    want = np.asarray(jflash.flash_prefill_blocked(q, jk, jv, jnp.int32(off), d ** -0.5,
                                                   interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2 * np.abs(want).max(), rtol=0)
    rounded = flash_prefill_blocked(tq, kv.decode(tk, torch.bfloat16),
                                    kv.decode(tv, torch.bfloat16), off, d ** -0.5)
    assert torch.equal(got.view(torch.int16), rounded.view(torch.int16))
    if name == "f32":   # the rounding is real: the f32 cache is not bf16-exact
        assert not torch.equal(kv.decode(tk, torch.bfloat16).float(), tk)


# ---------------------------------------------------------------------------
# the runner and the engine against the TPU package's
# ---------------------------------------------------------------------------

# head_dim 128 and 8 query heads: the TPU package's fold kernel takes the shape
CFG = dict(arch="llama", vocab_size=64, hidden_size=64, intermediate_size=96, num_layers=2,
           num_heads=8, num_kv_heads=8, head_dim=128, max_seq_len=32)


def _models(**kw):
    cfg = dict(CFG, **kw)
    tree = _np_llama(cfg)
    return (JaxModelConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, tree), ModelConfig(**cfg),
            params_from_jax(tree, "cpu", torch.float32))


@pytest.mark.parametrize("name", list(DTYPES))
def test_runner_matches_jax_runner(name):
    """ModelRunner(kv_dtype=...) on a GQA model: its cache has the dtype; the
    prefill and two decode steps' logits within 1e-4 of the TPU package's
    runner with the same kv_dtype; the cache bytes below the offset equal;
    10 greedy tokens equal."""
    tdt, jdt = DTYPES[name]
    jcfg, jparams, cfg, params = _models(num_kv_heads=2)
    prompt = np.random.RandomState(3).randint(1, cfg.vocab_size, size=(1, 7)).astype(np.int32)
    jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=32, dtype=jnp.float32,
                        kv_dtype=jdt)
    r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32, dtype=torch.float32,
                    device="cpu", kv_dtype=tdt)
    jl, jc = jr.prefill(jnp.asarray(prompt), jr.init_cache())
    tl, tc = r.prefill(torch.from_numpy(prompt.astype(np.int64)), r.init_cache())
    assert all(t.dtype == tdt for t in (*tc.k, *tc.v))
    for _ in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int64)[:, None]
        jl, jc = jr.decode(jnp.asarray(tok.astype(np.int32)), jc)
        tl, tc = r.decode(torch.from_numpy(tok), tc)
    n = tc.offset
    for t, j in zip((*tc.k, *tc.v), (*jc.k, *jc.v)):
        if tdt in kv.FP8:   # the same k/v rounded to fp8 by the same rule: the same bytes
            np.testing.assert_array_equal(_bytes(t[:, :n].contiguous()),
                                          np.asarray(j[:, :n]).view(np.uint8).reshape(-1))
        else:               # f32 k/v computed by two frameworks: within fp32 rounding
            np.testing.assert_allclose(t[:, :n].numpy(), np.asarray(j[:, :n]), atol=1e-5,
                                       rtol=1e-5)
    want = jax_generate(jr, prompt[0], max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(generate(r, prompt[0], max_new_tokens=10, temperature=0.0),
                                  np.asarray(want))


def _count_jax_folds(monkeypatch):
    calls = []
    real = jattn.fused_decode_attention
    monkeypatch.setattr(jattn, "fused_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("GPTQ_TPU_CACHE_IMPL", "pallas")
    return calls


def test_fold_differs_from_classic_as_jax_does(monkeypatch):
    """Over an fp8 cache the fold runner's decode logits equal the TPU
    package's fold path (GPTQ_TPU_CACHE_IMPL=pallas, its kernel 9 in
    interpret mode) within 1e-4 and the classic runner's equal its classic
    path; the port's fold and classic differ where JAX's do (the current
    token folded in after the prefix, not read back from the cache), and the
    greedy tokens of all four agree."""
    jcfg, jparams, cfg, params = _models()
    prompt = np.random.RandomState(4).randint(1, cfg.vocab_size, size=6).astype(np.int32)
    outs = {}
    for impl in ("classic", "fold"):
        if impl == "fold":
            calls = _count_jax_folds(monkeypatch)
        jr = JaxModelRunner("llama", jcfg, jparams, batch_size=1, max_seq_len=32,
                            dtype=jnp.float32, kv_dtype=jnp.float8_e4m3fn)
        r = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32, dtype=torch.float32,
                        device="cpu", kv_dtype=torch.float8_e4m3fn, cache_impl=impl)
        jl, jc = jr.prefill(jnp.asarray(prompt[None]), jr.init_cache())
        tl, tc = r.prefill(torch.from_numpy(prompt[None].astype(np.int64)), r.init_cache())
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, _ = jr.decode(jnp.asarray(tok.astype(np.int32)), jc)
        tl, _ = r.decode(torch.from_numpy(tok.astype(np.int64)), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        outs[impl] = (tl.numpy(), np.asarray(jl),
                      generate(r, prompt, max_new_tokens=8, temperature=0.0),
                      np.asarray(jax_generate(jr, prompt, max_new_tokens=8, temperature=0.0)))
    assert calls, "the TPU package did not take its fold kernel"
    (tc_, jc_, tgc, jgc), (tf, jf, tgf, jgf) = outs["classic"], outs["fold"]
    assert not np.array_equal(tc_, tf) and not np.array_equal(jc_, jf)
    np.testing.assert_allclose(tf - tc_, jf - jc_, atol=2e-4)
    for toks in (tgf, jgc, jgf):
        np.testing.assert_array_equal(toks, tgc)


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, block_size=8), dict(cache_impl="fold"),
                                dict(prefill_chunk=8)], ids=["dense", "paged", "fold", "chunked"])
def test_fp8_engine_matches_jax_engine_and_runner(monkeypatch, kw):
    """ServingEngine(kv_dtype=fp8) in each mode: four requests on two slots,
    greedy tokens equal to the TPU package's engine with the same kv_dtype
    (its fold path under GPTQ_TPU_CACHE_IMPL=pallas) and to the port's fp8
    runner wherever the engine's prefill attends the cache, as the runner's
    does; the engine's pools are fp8 and half the bytes of bf16's. Requests 2
    and 3 are admitted together (one bucket, two free slots) except when
    chunked: a batched admission attends its fresh k/v at compute precision,
    as the TPU package's ("fresh", ...) form does, so they are held to the
    TPU package's engine only."""
    jcfg, jparams, cfg, params = _models()
    fold = kw.get("cache_impl") == "fold"
    jkw = {k: v for k, v in kw.items() if k != "cache_impl"}
    if fold:
        calls = _count_jax_folds(monkeypatch)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32) for n in (3, 9, 5, 2)]
    jeng = JaxServingEngine("llama", jcfg, jparams, batch_slots=2, max_seq_len=32,
                            dtype=jnp.float32, prefill_buckets=(8, 16),
                            kv_dtype=jnp.float8_e4m3fn, **jkw)
    eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=32, dtype=torch.float32,
                        prefill_buckets=(8, 16), device="cpu", kv_dtype=torch.float8_e4m3fn,
                        **kw)
    for uid, p in enumerate(prompts):
        jeng.submit(JaxGenRequest(uid=uid, prompt=p, max_new_tokens=6, temperature=0.0))
        eng.submit(GenRequest(uid=uid, prompt=p, max_new_tokens=6))
    want, got = jeng.run(), eng.run()
    if fold:
        assert calls, "the TPU package did not take its fold kernel"
    assert all(t.dtype == torch.float8_e4m3fn for t in (*eng.state["k"], *eng.state["v"]))
    assert eng.kv_bytes() * 2 == sum(t.numel() * 2 for t in (*eng.state["k"], *eng.state["v"]))
    assert eng.stats()["kv_dtype"] == "float8_e4m3fn"
    runner = ModelRunner("llama", cfg, params, batch_size=1, max_seq_len=32,
                         dtype=torch.float32, device="cpu", kv_dtype=torch.float8_e4m3fn)
    batched = eng.forwards["admit"] > 0
    assert batched == ("prefill_chunk" not in kw)
    for uid, p in enumerate(prompts):
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]), err_msg=f"request {uid}")
        if uid < 2 or not batched:
            np.testing.assert_array_equal(got[uid],
                                          generate(runner, p, 6, temperature=0.0)[0, len(p):],
                                          err_msg=f"request {uid} vs the runner")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    import hf_tiny
    d, _ = hf_tiny.tiny_llama_dir(tmp_path_factory.mktemp("kv_cli") / "model")
    return d


@pytest.mark.parametrize("name", ["fp8", "fp8_e5m2", "f32"])
def test_clis_take_kv_dtype_on_the_cpu(model_dir, capsys, name):
    """``--kv-dtype`` on ``--benchmark N --check`` and on ``serve --demo
    --paged``: the runner's cache and the engine's pool are stored in it (the
    reports say which, with the bytes), the ppl is finite, every request
    finishes."""
    rep = cli_main([model_dir, "synthetic", "--seqlen", "32", "--benchmark", "24", "--check",
                    "--device", "cpu", "--kv-dtype", name])
    bench = rep["benchmark"]
    tdt = DTYPES[name][0]
    assert bench["kv_dtype"] == str(tdt).replace("torch.", "") and np.isfinite(bench["ppl"])
    with open(f"{model_dir}/config.json") as f:
        c = json.load(f)
    hkv = c.get("num_key_value_heads", c["num_attention_heads"])
    elems = 2 * c["num_hidden_layers"] * 32 * hkv * c["hidden_size"] // c["num_attention_heads"]
    assert bench["kv_bytes"] == elems * torch.empty((), dtype=tdt).element_size()
    capsys.readouterr()
    out = serve_cli.main([model_dir, "--demo", "2", "--max-new-tokens", "3", "--slots", "2",
                          "--paged", "--block-size", "8", "--quiet", "--device", "cpu",
                          "--kv-dtype", name])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats == out["stats"] and stats["completed"] == 2 and stats["tokens"] == 6
    assert stats["kv_dtype"] == bench["kv_dtype"] and stats["kv_bytes"] > 0
