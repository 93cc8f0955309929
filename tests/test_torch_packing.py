"""Port packing and wire format held against the TPU package, byte for byte.

The same numpy inputs go through gptq_for_llama_tpu.quant.packing /
ops.linear and their counterparts in gptq_for_llama_tpu_torch. Packing and
to_wire round trips must be byte-identical; dequantize runs the same fp32
arithmetic in both packages, so it must match exactly too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.quant import packing as tpack


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_unpack_byte_equal(bits):
    rng = np.random.RandomState(bits)
    k, n = 96, 40
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    packed = tpack.pack_rows(codes, bits)
    np.testing.assert_array_equal(packed, jpack.pack_rows(codes, bits))
    assert packed.dtype == np.int32
    np.testing.assert_array_equal(tpack.unpack_rows(packed, bits),
                                  jpack.unpack_rows(packed, bits))
    np.testing.assert_array_equal(tpack.unpack_rows(packed, bits), codes)
    # zeros-1 wrap at zero 0 (uint32 0xffffffff): only its own slot changes
    zc = rng.randint(0, 2 ** bits, size=(3, 96)).astype(np.uint32)
    zc[1, 5] = np.uint32(0xFFFFFFFF)
    np.testing.assert_array_equal(tpack.pack_cols(zc, bits), jpack.pack_cols(zc, bits))
    pc = jpack.pack_cols(zc, bits)
    np.testing.assert_array_equal(tpack.unpack_cols(pc, bits, n=96),
                                  jpack.unpack_cols(pc, bits, n=96))
    if bits != 3:   # the device layout never holds 3-bit words
        perm = rng.permutation(k).astype(np.int32)
        got = tpack.gather_rows_packed_torch(torch.as_tensor(packed), torch.as_tensor(perm),
                                             bits)
        np.testing.assert_array_equal(got.numpy(), jpack.gather_rows_packed(packed, perm, bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_torch_unpack_matches_numpy(bits):
    rng = np.random.RandomState(10 + bits)
    packed = rng.randint(-2**31, 2**31, size=(12, 24), dtype=np.int32)
    got = tpack.unpack_rows_torch(torch.as_tensor(packed), bits).numpy()
    np.testing.assert_array_equal(got, jpack.unpack_rows(packed, bits))


def _wire(k, n, bits, gs, seed, actorder=False, bias=False):
    """Random wire buffers; act-order scrambles the rows and g_idx together
    (tests/test_pallas.py:_random_packed)."""
    rng = np.random.RandomState(seed)
    g = -(-k // gs)
    codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
    g_idx = (np.arange(k) // gs).astype(np.int32)
    if actorder:
        p = rng.permutation(k)
        codes, g_idx = codes[p], g_idx[p]
    zeros = rng.randint(1, 2 ** bits, size=(g, n)).astype(np.uint32)
    w = {"qweight": jpack.pack_rows(codes, bits),
         "qzeros": jpack.pack_cols(zeros - 1, bits),
         "scales": (rng.rand(g, n) * 0.02 + 0.005).astype(np.float16),
         "g_idx": g_idx}
    if bias:
        w["bias"] = rng.standard_normal(n).astype(np.float16)
    return w


CASES = {
    "int4": dict(k=128, n=64, bits=4, gs=32),
    "int4_actorder": dict(k=128, n=64, bits=4, gs=32, actorder=True),
    "int3": dict(k=128, n=64, bits=3, gs=32),
    "int3_actorder": dict(k=128, n=64, bits=3, gs=32, actorder=True),
    "int2_bias": dict(k=128, n=64, bits=2, gs=64, bias=True),
    "int8": dict(k=64, n=32, bits=8, gs=16),
    "ragged_last_group": dict(k=104, n=32, bits=4, gs=32),
    "ragged_actorder": dict(k=104, n=32, bits=4, gs=32, actorder=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wire_roundtrip_and_dequantize(case):
    c = dict(CASES[case])
    bits = c.pop("bits")
    w = _wire(bits=bits, seed=len(case), **c)
    lin = PackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"],
                                 bits=bits, bias=w.get("bias"), dtype=torch.float32,
                                 device="cpu")
    jlin = JaxPackedLinear.from_wire(w["qweight"], w["qzeros"], w["scales"], w["g_idx"],
                                     bits=bits, bias=w.get("bias"), dtype=jnp.float32)
    assert (lin.perm is not None) == c.get("actorder", False)
    assert lin.bits == (4 if bits == 3 else bits) and lin.wire_bits == jlin.wire_bits
    back, jback = lin.to_wire(), jlin.to_wire()
    assert sorted(back) == sorted(jback)
    for key, arr in back.items():
        assert arr.dtype == jback[key].dtype, key
        assert arr.tobytes() == np.asarray(jback[key]).tobytes(), key
        if key in w:
            assert arr.tobytes() == np.asarray(w[key], arr.dtype).tobytes(), key
    np.testing.assert_array_equal(lin.dequantize(torch.float32).numpy(),
                                  np.asarray(jlin.dequantize(jnp.float32)))
