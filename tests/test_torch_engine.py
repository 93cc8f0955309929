"""The port's quantization engine, perplexity eval and data loaders held
against the TPU package.

A tiny LLaMA from tests/hf_tiny.py (2 layers, hidden 32), loaded fp32 by the
TPU package and handed to the port as numpy (``convert.params_from_jax``),
so both quantize the same dense weights on the same calibration windows
(nsamples 8, seqlen 32, groupsize 16). Records and fake-quantized kernels
are held at the solver tolerance of tests/test_torch_quant.py; perplexity at
1e-4 relative (fp32 on both sides).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gptq_for_llama_tpu.data import datautils as jdata
from gptq_for_llama_tpu.engine import QuantizeSpec as JSpec
from gptq_for_llama_tpu.engine import pack_model as jpack_model
from gptq_for_llama_tpu.engine import perplexity as jperplexity
from gptq_for_llama_tpu.engine import quantize_model as jquantize_model
from gptq_for_llama_tpu.models import hf_loader as jloader
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu_torch.convert import params_from_jax, records_from_jax
from gptq_for_llama_tpu_torch.data import datautils
from gptq_for_llama_tpu_torch.engine import (QuantizeSpec, get_path, pack_model, perplexity,
                                             quantize_model)
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.models.registry import get_arch

import hf_tiny
from test_torch_quant import assert_solver_close

SEQLEN = 32


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d, _ = hf_tiny.tiny_llama_dir(tmp_path_factory.mktemp("tiny"))
    jcfg, _ = jloader.load_params(d, dtype=jnp.float32, seqlen=SEQLEN)
    train, test = jdata.get_loaders("synthetic", nsamples=8, seed=0, seqlen=SEQLEN, model=jcfg)
    return d, jcfg, train, test[: SEQLEN * 48]


def _wire_tree(p):
    """The TPU package's params as numpy (packed linears as wire dicts)."""
    if isinstance(p, JaxPackedLinear):
        d = dict(p.to_wire())
        d["bits"] = p.wire_bits or p.bits
        return d
    if isinstance(p, dict):
        return {k: _wire_tree(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_wire_tree(v) for v in p]
    return np.asarray(p, np.float32)


def _both(tiny):
    """Fresh fp32 params of the tiny model in both packages (the same weights)."""
    d, jcfg, _, _ = tiny
    _, jparams = jloader.load_params(d, dtype=jnp.float32, seqlen=SEQLEN)
    cfg = ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})
    params = params_from_jax(_wire_tree(jparams), "cpu", torch.float32)
    return cfg, params, jcfg, jparams


SPECS = {
    "trueseq-actorder": dict(wbits=4, groupsize=16, chunk=4, true_sequential=True,
                             act_order=True),
    "nearest": dict(wbits=4, groupsize=16, chunk=4, nearest=True),
    "observe": dict(wbits=2, groupsize=16, chunk=4, observe=True),
    "lm-head": dict(wbits=4, groupsize=16, chunk=4, quantize_lm_head=True),
    "resume": dict(wbits=4, groupsize=16, chunk=4),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_quantize_model_matches_jax(tiny, tmp_path, name):
    _, _, train, _ = tiny
    kw = SPECS[name]
    cfg, params, jcfg, jparams = _both(tiny)
    jparams, jrecs, _ = jquantize_model("llama", jcfg, jparams, train, JSpec(**kw),
                                        verbose=False)
    if name == "resume":   # a run stopped after layer 0, then resumed
        rdir = str(tmp_path / "resume")
        quantize_model("llama", cfg, params, train, QuantizeSpec(**kw), verbose=False,
                       resume_dir=rdir)
        os.remove(os.path.join(rdir, "layer_0001.npz"))
        cfg, params, _, _ = _both(tiny)
        params, recs, _ = quantize_model("llama", cfg, params, train, QuantizeSpec(**kw),
                                         verbose=False, resume_dir=rdir)
    else:
        params, recs, obs = quantize_model("llama", cfg, params, train, QuantizeSpec(**kw),
                                           verbose=True, log=lambda *a: None)
        if name == "observe":
            assert any(r.wbits > 2 for r in recs.values())
    assert set(recs) == set(jrecs)
    if name == "lm-head":
        assert "lm_head" in recs
    arch = get_arch("llama")
    for key, jrec in jrecs.items():
        rec = recs[key]
        assert (rec.wbits, rec.groupsize, rec.sym) == (jrec.wbits, jrec.groupsize, jrec.sym)
        if key == "lm_head":
            kernel, jkernel = params["lm_head"]["kernel"], jparams["lm_head"]["kernel"]
        else:
            li, lname = int(key.split(".")[1]), key.split(".", 2)[2]
            assert lname in arch.LAYER_LINEARS
            kernel = get_path(params["layers"][li], lname)["kernel"]
            jkernel = get_path(jparams["layers"][li], lname)["kernel"]
        q, jq = kernel.T.numpy(), np.asarray(jkernel).T
        if name == "nearest":   # RTN is exact
            np.testing.assert_array_equal(q, jq)
            np.testing.assert_array_equal(rec.scale, jrec.scale)
            continue
        assert_solver_close((q, rec.scale, rec.zero, rec.g_idx, rec.error),
                            (jq, jrec.scale, jrec.zero, jrec.g_idx, jrec.error))


def test_perplexity_matches_jax_dense_and_packed(tiny):
    _, _, train, test = tiny
    cfg, params, jcfg, jparams = _both(tiny)
    got = perplexity("llama", cfg, params, test, seqlen=SEQLEN)
    want = jperplexity("llama", jcfg, jparams, test, seqlen=SEQLEN)
    np.testing.assert_allclose(got, want, rtol=1e-4)

    # the TPU package quantizes and packs; the port evaluates the same bytes
    spec = dict(wbits=4, groupsize=16, chunk=4, act_order=True)
    jparams, jrecs, _ = jquantize_model("llama", jcfg, jparams, train, JSpec(**spec),
                                        verbose=False)
    jparams = jpack_model("llama", jcfg, jparams, jrecs, dtype=jnp.float32)
    packed = params_from_jax(_wire_tree(jparams), "cpu", torch.float32)
    got = perplexity("llama", cfg, packed, test, seqlen=SEQLEN)
    want = jperplexity("llama", jcfg, jparams, test, seqlen=SEQLEN)
    np.testing.assert_allclose(got, want, rtol=1e-4)

    # the port packs the same records from its own copy of the fake-quantized
    # kernels: the same model, so the same perplexity
    _, fq, _, _ = _both(tiny)
    for li, lp in enumerate(fq["layers"]):
        for name in get_arch("llama").LAYER_LINEARS:
            jk = get_path(jparams["layers"][li], name)
            get_path(lp, name)["kernel"] = torch.as_tensor(
                np.asarray(_dequant_kernel(jk), np.float32))
    packed2 = pack_model("llama", cfg, fq, records_from_jax(jrecs), dtype=torch.float32)
    np.testing.assert_allclose(perplexity("llama", cfg, packed2, test, seqlen=SEQLEN), want,
                               rtol=1e-4)


def _dequant_kernel(jlin):
    """(in, out) fp32 kernel of a TPU-package PackedLinear in original row order."""
    from gptq_for_llama_tpu.utils.metrics import dequant_weight_np
    w = jlin.to_wire()
    return dequant_weight_np(w["qweight"], w["qzeros"], w["scales"], w["g_idx"],
                             jlin.wire_bits or jlin.bits).T


def test_perplexity_padded_last_batch_and_default_batch():
    """The last partial batch is padded and its rows dropped: batch 3 over 7
    windows gives the batch-1 perplexity; the card's eval batch is 8."""
    from gptq_for_llama_tpu_torch.engine.evaluate import default_batch
    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_layers=1, num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=16)
    params = get_arch("llama").init_params(cfg, torch.Generator().manual_seed(0),
                                           dtype=torch.float32)
    ids = np.random.RandomState(0).randint(0, 64, size=7 * 16 + 5)
    a = perplexity("llama", cfg, params, ids, seqlen=16, batch=1)
    b = perplexity("llama", cfg, params, ids, seqlen=16, batch=3)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert default_batch(2048, torch.device("cuda")) == 8
    assert default_batch(2048, torch.device("cpu")) == 1
    assert default_batch(256, torch.device("cpu")) == 8


@pytest.mark.parametrize("nsamples,seed,seqlen", [(8, 0, 32), (5, 3, 100)])
def test_synthetic_loader_matches_jax(nsamples, seed, seqlen):
    train, test = datautils.get_loaders("synthetic", nsamples=nsamples, seed=seed,
                                        seqlen=seqlen, model=96)
    jtrain, jtest = jdata.get_loaders("synthetic", nsamples=nsamples, seed=seed,
                                      seqlen=seqlen, model=96)
    np.testing.assert_array_equal(train, jtrain)
    np.testing.assert_array_equal(test, jtest)
    ids = np.arange(1000, dtype=np.int32)
    np.testing.assert_array_equal(datautils._sample_windows(ids, 4, 7, 50),
                                  jdata._sample_windows(ids, 4, 7, 50))


def test_mesh_raises_until_parallel_slice(tiny):
    _, _, train, _ = tiny
    cfg, params, _, _ = _both(tiny)
    with pytest.raises(NotImplementedError, match="A18"):
        quantize_model("llama", cfg, params, train, QuantizeSpec(), mesh=object())
