"""The port's quantizer, GPTQ solver and packing held against the TPU package.

Same numpy inputs through both packages (and through tests/oracle.py for the
solver), fp32 on the CPU. Tolerances: quantizer params exact, and within
1 ulp on the MSE search, where a near-tie in a row's error curve may pick
another shrink step; Hessians 1e-6 relative; the solver's scales 1e-5
relative, zeros exact, codes equal on >= 99.9 % of entries and within 1
elsewhere, error 1e-4 relative (the two factor the inverse Hessian by
different LAPACK routes); RTN exact; packing byte-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.quant import gptq as jgptq
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu.quant import quantizer as jq
from gptq_for_llama_tpu_torch.quant import gptq, packing, quantizer
import oracle


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

def _cfgs():
    out = []
    for bits in (2, 3, 4, 8):
        for sym in (False, True):
            for mse in (False, True):
                out.append(dict(bits=bits, sym=sym, mse=mse))
    out += [dict(bits=4, trits=True), dict(bits=4, trits=True, mse=True),
            dict(bits=4, wire_safe=True), dict(bits=2, wire_safe=True, mse=True),
            dict(bits=4, perchannel=False), dict(bits=3, perchannel=False, mse=True)]
    return out


def _weight(seed, rows=24, cols=40):
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((rows, cols)).astype(np.float32)
    w[1] = np.abs(w[1])          # all-positive row: zero 0 unless wire_safe
    w[2] = 0.0                   # zero-range guard
    w[3] = -np.abs(w[3])
    return w


def _same_params(got, want, mse, trits=False):
    (gs, gz), (ws, wz) = got, want
    gs, gz, ws, wz = (_np(a).reshape(-1) for a in (gs, gz, ws, wz))
    if not mse:
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gz, wz)
        return
    # MSE: XLA computes |q-x|^2.4 with its own pow and sums in its own order,
    # so a row whose error curve has a near-tie may keep another shrink step;
    # rows on the same step agree to 1 ulp
    same_step = np.abs(gs - ws) <= 1e-6 * np.abs(ws)
    assert same_step.mean() >= 0.9, same_step
    np.testing.assert_array_max_ulp(gs[same_step], ws[same_step], maxulp=1)
    if trits:   # zero is the shrunk xmin itself
        np.testing.assert_array_max_ulp(gz[same_step], wz[same_step], maxulp=1)
    else:
        np.testing.assert_array_equal(gz[same_step], wz[same_step])
    np.testing.assert_allclose(gs, ws, rtol=0.1)


@pytest.mark.parametrize("kw", _cfgs(), ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_find_params_weight_matches_jax(kw):
    w = _weight(kw["bits"] + 7 * kw.get("sym", 0))
    got = quantizer.find_params_weight(_t(w), quantizer.QuantConfig(**kw))
    want = jq.find_params_weight(jnp.asarray(w), jq.QuantConfig(**kw))
    _same_params(got, want, kw.get("mse", False), kw.get("trits", False))
    if not kw.get("mse", False):
        cfg = quantizer.QuantConfig(**kw)
        q = quantizer.fake_quantize(_t(w), *got, cfg)
        jwant = jq.fake_quantize(jnp.asarray(w), *want, jq.QuantConfig(**kw))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("perchannel,mse", [(True, False), (False, False), (True, True)])
def test_find_params_activation_matches_jax(perchannel, mse):
    x = np.random.RandomState(3).standard_normal((2, 7, 16)).astype(np.float32)
    kw = dict(bits=8, perchannel=perchannel, sym=True, mse=mse)
    got = quantizer.find_params_activation(_t(x), quantizer.QuantConfig(**kw))
    want = jq.find_params_activation(jnp.asarray(x), jq.QuantConfig(**kw))
    assert tuple(got[0].shape) == tuple(want[0].shape)
    _same_params(got, want, mse)


# ---------------------------------------------------------------------------
# Hessians
# ---------------------------------------------------------------------------

def test_hessians_match_jax():
    x = np.random.RandomState(4).standard_normal((4, 33, 48)).astype(np.float32)
    want = np.asarray(jgptq.batch_hessian(jnp.asarray(x)))
    got = gptq.batch_hessian(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    h, n = torch.zeros(48, 48), 0
    jh, jn = jnp.zeros((48, 48), jnp.float32), 0
    for j in range(4):
        h, n = gptq.update_hessian(h, n, _t(x[j]))
        jh, jn = jgptq.update_hessian(jh, jn, jnp.asarray(x[j]))
    assert n == int(jn) == 4
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jh)).max())


def test_fp32_matmul_scope_restores_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with gptq.fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------------------------
# GPTQ solver
# ---------------------------------------------------------------------------

def _problem(rows, cols, seed, dead=()):
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((rows, cols)).astype(np.float32)
    x = rng.standard_normal((4, 96, cols)).astype(np.float32)
    x *= np.linspace(0.2, 2.0, cols, dtype=np.float32)   # spread diag(H): act-order ties
    x[..., list(dead)] = 0.0
    h = np.asarray(jgptq.batch_hessian(jnp.asarray(x)))
    return w, h


def _codes(q, scale, zero, g_idx):
    return np.rint(q / scale[:, g_idx] + zero[:, g_idx]).astype(np.int64)


def assert_solver_close(got, want, trits=False):
    """scale 1e-5 relative, zero exact, codes equal on >= 99.9 % (rest +-1),
    error 1e-4 relative."""
    gq, gs, gz, gg, ge = (_np(a) for a in got)
    wq, ws, wz, wg, we = (_np(a) for a in want)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
    if trits:   # ternary: zero is a weight value, and there is no integer grid
        np.testing.assert_allclose(gz, wz, rtol=1e-5, atol=0)
        same = np.abs(gq - wq) <= 1e-5 * np.abs(wq).max()
    else:
        np.testing.assert_array_equal(gz, wz)
        gc, wc = _codes(gq, gs, gz, gg), _codes(wq, ws, wz, wg)
        assert np.abs(gc - wc).max() <= 1
        same = gc == wc
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(float(ge), float(we), rtol=1e-4)


SOLVER_CASES = [
    # (rows, cols, bits, groupsize, blocksize, actorder, sym, dead, trits)
    (32, 256, 4, -1, 128, False, False, (), False),
    (32, 256, 4, 32, 128, False, False, (), False),
    (32, 256, 4, 32, 128, True, False, (), False),
    (32, 512, 4, 256, 128, False, False, (), False),     # gs > blocksize: unrolled loop
    (32, 512, 3, 256, 128, True, True, (), False),
    (24, 256, 2, 32, 64, False, True, (5, 77, 200), False),
    (32, 200, 4, 32, 128, False, False, (), False),      # cols % 128 != 0
    (32, 200, 4, -1, 128, True, False, (3,), False),
    (16, 128, 4, 32, 64, False, False, (), True),        # trits
]


@pytest.mark.parametrize("rows,cols,bits,gs,bs,actorder,sym,dead,trits", SOLVER_CASES)
def test_gptq_quantize_matches_jax(rows, cols, bits, gs, bs, actorder, sym, dead, trits):
    w, h = _problem(rows, cols, seed=cols + bits + gs, dead=dead)
    kw = dict(bits=bits, sym=sym, trits=trits)
    got = gptq.gptq_quantize(_t(w), _t(h), quantizer.QuantConfig(**kw), blocksize=bs,
                             groupsize=gs, actorder=actorder)
    want = jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(h), jq.QuantConfig(**kw),
                               blocksize=bs, groupsize=gs, actorder=actorder)
    assert got.g_idx.dtype == torch.int32
    assert_solver_close(got, want, trits=trits)
    if dead:
        assert np.all(got.qweight.numpy()[:, list(dead)] == 0)


# The oracle inverts H with np.linalg.inv, not by Cholesky: at 2 bits the
# large rounding errors feed back and amplify that difference (the TPU
# package's own solver differs from the oracle by 9 % in a group scale of the
# 2-bit case), so the oracle holds the 3- and 4-bit cases.
@pytest.mark.parametrize("rows,cols,bits,gs,bs,actorder,sym,dead,trits",
                         [c for c in SOLVER_CASES if not c[8] and c[2] >= 3])
def test_gptq_quantize_matches_oracle(rows, cols, bits, gs, bs, actorder, sym, dead, trits):
    w, h = _problem(rows, cols, seed=cols + bits + gs, dead=dead)
    got = gptq.gptq_quantize(_t(w), _t(h), quantizer.QuantConfig(bits=bits, sym=sym),
                             blocksize=bs, groupsize=gs, actorder=actorder)
    want = oracle.gptq_reference(w, h, bits=bits, sym=sym, blocksize=bs, groupsize=gs,
                                 actorder=actorder)
    assert_solver_close(got, want)


@pytest.mark.parametrize("gs,sym", [(-1, False), (16, False), (32, True)])
def test_rtn_quantize_matches_jax(gs, sym):
    w = _weight(9, rows=16, cols=64)
    got = gptq.rtn_quantize(_t(w), quantizer.QuantConfig(bits=4, sym=sym), groupsize=gs)
    want = jgptq.rtn_quantize(jnp.asarray(w), jq.QuantConfig(bits=4, sym=sym), groupsize=gs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# packing of solver output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,gs,actorder", [(4, 32, False), (4, 32, True), (2, 64, False),
                                              (3, 32, True), (8, -1, False)])
def test_pack_quantized_byte_equal(bits, gs, actorder):
    w, h = _problem(64, 128, seed=bits, dead=(7,))
    cfg = jq.QuantConfig(bits=bits, wire_safe=True)
    res = jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(h), cfg, groupsize=gs,
                              actorder=actorder)
    q, s, z, g = (np.asarray(a) for a in res[:4])
    got_codes = packing.quantize_weight_to_codes(q, s, z, g).numpy()
    np.testing.assert_array_equal(got_codes, jpack.quantize_weight_to_codes(q, s, z, g))
    want = jpack.pack_quantized(q, s, z, g, bits)
    for w in (q, _t(q)):   # numpy, or a tensor where the model keeps it
        got = packing.pack_quantized(w, s, z, g, bits)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key
    if bits != 3:   # the torch row gather is the JAX package's, byte for byte
        perm = np.random.RandomState(bits).permutation(q.shape[1]).astype(np.int32)
        np.testing.assert_array_equal(
            packing.gather_rows_packed_torch(_t(want["qweight"]), _t(perm), bits).numpy(),
            jpack.gather_rows_packed(want["qweight"], perm, bits))
    dq = packing.dequantize(want["qweight"], want["qzeros"], want["scales"], g, bits).numpy()
    jdq = np.asarray(jpack.dequantize(jnp.asarray(want["qweight"]), jnp.asarray(want["qzeros"]),
                                      jnp.asarray(want["scales"]), jnp.asarray(g), bits))
    np.testing.assert_array_equal(dq, jdq)
