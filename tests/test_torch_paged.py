"""The port's paged KV cache held against the TPU package's.

The same numpy pools, tables and new k/v go through
``gptq_for_llama_tpu.runtime.paged`` / ``models.common`` and their counterparts
in the port: the allocator hands out the same blocks, every write leaves the
same pool (exactly: both move values without arithmetic), and the cache
protocol's paged and grouped forms attend the same physical layout.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.models import common as jcommon
from gptq_for_llama_tpu.runtime import paged as jpaged
from gptq_for_llama_tpu_torch.models import common
from gptq_for_llama_tpu_torch.runtime import paged


def _t(a):
    return torch.as_tensor(np.array(a))


def test_allocator_matches_jax():
    """The same calls give the same blocks, free lists and errors, with and
    without reserved scratch blocks."""
    for reserved in (0, 1, 2):
        a, j = paged.BlockAllocator(9, reserved), jpaged.BlockAllocator(9, reserved)
        for op in (("alloc", 0, 3), ("alloc", 1, 2), ("ensure", 1, 25, 8), ("release", 0),
                   ("alloc", 2, 2), ("ensure", 2, 8, 8), ("release", 5), ("alloc", 3, 1)):
            if op[0] == "alloc":
                assert a.alloc(*op[1:]) == j.alloc(*op[1:])
            elif op[0] == "ensure":
                assert a.ensure_capacity(*op[1:]) == j.ensure_capacity(*op[1:])
            else:
                a.release(op[1])
                j.release(op[1])
            assert a.free == j.free and a.owned == j.owned
            assert not set(a.free) & set(range(reserved))
        with pytest.raises(MemoryError):
            a.alloc(7, 9)
        with pytest.raises(MemoryError):
            j.alloc(7, 9)


def _pool(rng, nb=12, bs=8, h=2, d=4):
    return (rng.standard_normal((nb, bs, h, d)).astype(np.float32),
            rng.standard_normal((nb, bs, h, d)).astype(np.float32))


def _tables(rng, b, mb, nb, reserved=1):
    """Disjoint random physical blocks per row, none of them the scratch block."""
    return (rng.permutation(np.arange(reserved, nb))[:b * mb].reshape(b, mb)).astype(np.int32)


# case -> (new tokens per row, write mask, one host-int offset for every row)
UPDATE_CASES = {"decode": (1, False, False), "decode-masked": (1, True, False),
                "decode-host-offset": (1, False, True), "prefill": (16, False, False),
                "prefill-ragged": (11, False, False), "prefill-masked": (16, True, False),
                "prefill-host-offset": (16, False, True)}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
@pytest.mark.parametrize("gather", [True, False])
def test_paged_update_layer_matches_jax(case, gather):
    """Same pool, tables, offsets and mask in both packages: the pools and
    the gathered views are EQUAL (writes move values, no arithmetic)."""
    rng = np.random.RandomState(len(case))
    b, mb, nb, bs, h, d = 3, 3, 12, 8, 2, 4
    kp, vp = _pool(rng, nb, bs, h, d)
    tables = _tables(rng, b, mb, nb)
    s, masked, host = UPDATE_CASES[case]
    k_new = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, h, d)).astype(np.float32)
    mask = np.array([True, False, True]) if masked else None
    if host:
        off = 13 if s == 1 else 8
        joff, toff = jnp.int32(off), off
    else:
        off = np.array([5, 23, 8] if s == 1 else [0, 8, 0], np.int32)
        joff, toff = jnp.asarray(off), _t(off)

    want = jpaged.paged_update_layer(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
                                     jnp.asarray(v_new), jnp.asarray(tables), joff,
                                     write_mask=None if mask is None else jnp.asarray(mask),
                                     gather=gather)
    kp_t, vp_t = _t(kp), _t(vp)
    got = paged.paged_update_layer(kp_t, vp_t, _t(k_new), _t(v_new), _t(tables), toff,
                                   write_mask=None if mask is None else _t(mask), gather=gather)
    assert got[0] is kp_t and got[1] is vp_t   # written in place, and returned
    # the scratch block takes every masked prefill row: which row lands last
    # there is not defined, and nothing reads it
    keep = slice(1, None) if (mask is not None and s > 1) else slice(None)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])
    if s == 1 and mask is not None:   # the masked row kept its contents
        np.testing.assert_array_equal(kp_t.numpy()[tables[1, 23 // bs], 23 % bs],
                                      kp[tables[1, 23 // bs], 23 % bs])
    if gather:
        for g, w in zip(got[2:], want[2:]):
            assert g.shape == (b, mb * bs, h, d)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        assert got[2] is None and got[3] is None and want[2] is None


def test_paged_write_gather_and_kv_match_jax():
    rng = np.random.RandomState(2)
    layers, b, mb, nb, bs, h, d = 2, 3, 3, 12, 8, 2, 4
    kp = rng.standard_normal((layers, nb, bs, h, d)).astype(np.float32)
    vp = rng.standard_normal((layers, nb, bs, h, d)).astype(np.float32)
    tables = _tables(rng, b, mb, nb, reserved=0)
    offs = np.array([0, 9, 23], np.int32)
    k_new = rng.standard_normal((layers, b, 1, h, d)).astype(np.float32)
    v_new = rng.standard_normal((layers, b, 1, h, d)).astype(np.float32)
    jk, jv = jpaged.paged_write(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
                                jnp.asarray(v_new), jnp.asarray(tables), jnp.asarray(offs))
    tk, tv = paged.paged_write(_t(kp), _t(vp), _t(k_new), _t(v_new), _t(tables), _t(offs))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        paged.paged_gather(tk[1], _t(tables[2])).numpy(),
        np.asarray(jpaged.paged_gather(jk[1], jnp.asarray(tables[2]))))
    np.testing.assert_array_equal(paged.gather_prefix(tk[0], _t(tables[1]), 11).numpy()[0],
                                  np.asarray(jpaged.paged_gather(jk[0], jnp.asarray(tables[1])))[:16])

    kv = paged.PagedKV(layers, nb, bs, h, d, slots=b, max_len=20, dtype=torch.float32,
                       device="cpu")
    jkv = jpaged.PagedKV(layers, nb, bs, h, d, slots=b, max_len=20, dtype=jnp.float32)
    assert kv.k.shape == tuple(jkv.k.shape) and kv.max_blocks == jkv.max_blocks == 3
    assert kv.tables.shape == jkv.tables.shape and kv.tables_device().dtype == torch.int32
    assert kv.alloc.ensure_capacity(0, 20, bs) == jkv.alloc.ensure_capacity(0, 20, bs)


def test_paged_decode_attention_matches_jax():
    rng = np.random.RandomState(3)
    b, mb, nb, bs, h, hkv, d = 3, 3, 12, 8, 4, 2, 16
    kp, vp = _pool(rng, nb, bs, hkv, d)
    tables = _tables(rng, b, mb, nb)
    offs = np.array([0, 9, 23], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    want = jpaged.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(tables), jnp.asarray(offs), d ** -0.5)
    got = paged.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(offs), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["paged-decode", "paged-prefill", "fresh", "fresh_paged",
                                  "grouped", "grouped_paged"])
def test_cache_protocol_matches_jax(form):
    """attention_block with each serving form of the cache protocol: the same
    attention output and the same caches / pools as the TPU package (fp32;
    host-int slots and offsets here, the device forms the graphs capture in
    tests/test_torch_prefill_graphs.py)."""
    rng = np.random.RandomState(len(form))
    b, mb, nb, bs, h, hkv, d, c = 3, 4, 16, 8, 4, 2, 16, 8
    s_len = mb * bs
    kp, vp = _pool(rng, nb, bs, hkv, d)
    kp[0] = vp[0] = 0.0   # the scratch block
    ck = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    tables = _tables(rng, b, mb, nb)
    offs = np.array([5, 17, 30], np.int32)
    live = np.array([True, False, True])

    def qkv(rows, s):
        return [rng.standard_normal((rows, s, n, d)).astype(np.float32) for n in (h, hkv, hkv)]

    J, T = jnp.asarray, _t
    if form == "paged-decode":
        q, k, v = qkv(b, 1)
        jpast = ("paged", J(kp), J(vp), J(tables), J(offs), J(live))
        tpast = ("paged", T(kp), T(vp), T(tables), T(offs), T(live), 31)
        jmask = jcommon.decode_mask(1, s_len, J(offs))
    elif form == "paged-prefill":
        q, k, v = qkv(1, c)
        jpast = ("paged", J(kp), J(vp), J(tables[1:2]), J(np.array([16], np.int32)))
        tpast = ("paged", T(kp), T(vp), T(tables[1:2]), 16)
        jmask = jcommon.decode_mask(c, s_len, J(np.array([16], np.int32)))
    elif form == "fresh":
        q, k, v = qkv(b, c)
        jpast, tpast = ("fresh", J(ck), J(cv), J(live)), ("fresh", T(ck), T(cv), T(live))
        jmask = jcommon.causal_mask(c, c)
    elif form == "fresh_paged":
        q, k, v = qkv(b, c)
        jpast = ("fresh_paged", J(kp), J(vp), J(tables), J(live))
        tpast = ("fresh_paged", T(kp), T(vp), T(tables), T(live))
        jmask = jcommon.causal_mask(c, c)
    else:
        q, k, v = qkv(1, b + c)
        slot, off0 = 1, 16   # the chunk's slot is not live
        head = (J(ck), J(cv)) if form == "grouped" else (J(kp), J(vp), J(tables))
        jpast = (form, *head, J(offs), J(live), jnp.int32(slot), jnp.int32(off0), b)
        head = (T(ck), T(cv)) if form == "grouped" else (T(kp), T(vp), T(tables))
        tpast = (form, *head, T(offs), T(live), slot, off0, b, 31)
        jmask = None

    jout, jpresent = jcommon.attention_block(jpast, J(q), J(k), J(v), jmask)
    tout, tpresent = common.attention_block(tpast, T(q), T(k), T(v), None)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    keep = slice(1, None) if form == "fresh_paged" else slice(None)   # scratch: see above
    for g, w in zip(tpresent, jpresent):
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])


def test_layer_paged_matches_dense():
    """llama.layer with the paged protocol == the dense cache: a block-aligned
    prefill of each slot, then decode steps at per-row offsets."""
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_layers=1, num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64)
    gen = torch.Generator()
    gen.manual_seed(0)
    lp = llama.init_params(cfg, gen, dtype=torch.float32, device="cpu")["layers"][0]
    rng = np.random.RandomState(1)
    b, bs, mb = 2, 8, 3
    kv = paged.PagedKV(1, 8, bs, cfg.num_kv_heads, cfg.head_dim, slots=b, max_len=mb * bs,
                       dtype=torch.float32, device="cpu")
    for slot in range(b):
        blocks = kv.alloc.ensure_capacity(slot, mb * bs, bs)
        kv.tables[slot, :len(blocks)] = blocks
    tables, kp, vp = kv.tables_device(), kv.k[0], kv.v[0]
    dk = torch.zeros((b, mb * bs, cfg.num_kv_heads, cfg.head_dim))
    dv = torch.zeros_like(dk)

    x0 = _t(rng.standard_normal((b, 8, 32)).astype(np.float32))
    pos = torch.arange(8)[None, :]
    yd, _, _ = llama.layer(cfg, lp, x0, pos, None, (dk, dv, 0))
    # one slot at a time, as the engine prefills; several rows at once raise
    yp = torch.cat([llama.layer(cfg, lp, x0[i:i + 1], pos, None,
                                ("paged", kp, vp, tables[i:i + 1], 0))[0] for i in range(b)])
    np.testing.assert_allclose(yp.numpy(), yd.numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="one slot"):
        llama.layer(cfg, lp, x0, pos, None, ("paged", kp, vp, tables, 0))
    for t in range(8, 11):
        x1 = _t(rng.standard_normal((b, 1, 32)).astype(np.float32))
        pos = torch.full((b, 1), t)
        off = torch.full((b,), t, dtype=torch.int32)
        yd, _, _ = llama.layer(cfg, lp, x1, pos, None, (dk, dv, off))
        yp, _, _ = llama.layer(cfg, lp, x1, pos, None, ("paged", kp, vp, tables, off))
        np.testing.assert_allclose(yp.numpy(), yd.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"t={t}")


def test_pool_and_random_model_default_to_the_card():
    """``PagedKV`` and ``llama.init_params`` follow the port's rule: without
    ``device=`` they go to the card; without a card that raises
    ``resolve_device``'s error rather than running on the CPU."""
    from gptq_for_llama_tpu_torch.models import llama
    from gptq_for_llama_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_layers=1, num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=16)
    make = (lambda: paged.PagedKV(1, 4, 8, 4, 8, slots=1, max_len=16).k,
            lambda: llama.init_params(cfg, torch.Generator().manual_seed(0))["norm"])
    for fn in make:
        if torch.cuda.is_available():
            assert fn().is_cuda
        else:
            with pytest.raises(RuntimeError, match="no CUDA device is available"):
                fn()
