"""Packed checkpoints cross between the port and the TPU package.

A tiny LLaMA (tests/hf_tiny.py) quantized by the TPU package: its saved
directory loads in the port, and the port's re-save loads in the TPU
package, with byte-identical wire buffers (qweight, qzeros, scales, g_idx)
and equal float tensors. The port's safetensors reader/writer is held
against the ``safetensors`` package; quantize_config.json and the quant-table
export are file-equal to the TPU package's for the same records.
"""

import filecmp
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from safetensors.numpy import load_file as st_load, save_file as st_save

from gptq_for_llama_tpu.data import get_loaders
from gptq_for_llama_tpu.engine import QuantizeSpec as JSpec
from gptq_for_llama_tpu.engine import export_quant_table as jexport
from gptq_for_llama_tpu.engine import pack_model as jpack_model
from gptq_for_llama_tpu.engine import quantize_model as jquantize_model
from gptq_for_llama_tpu.engine import save_packed as jsave_packed
from gptq_for_llama_tpu.models import hf_loader as jloader
from gptq_for_llama_tpu_torch.convert import record_to_numpy, records_from_jax
from gptq_for_llama_tpu_torch.engine import QuantizeSpec, export_quant_table, save_packed
from gptq_for_llama_tpu_torch.engine import safetensors_io
from gptq_for_llama_tpu_torch.models import hf_loader
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear

import hf_tiny

SPEC = dict(wbits=4, groupsize=16, chunk=4, act_order=True, true_sequential=True)


@pytest.fixture(scope="module")
def jax_packed(tmp_path_factory):
    """(model dir, TPU-package packed dir, its records)."""
    root = tmp_path_factory.mktemp("ckpt")
    d, _ = hf_tiny.tiny_llama_dir(root / "model")
    cfg, params = jloader.load_params(d, dtype=jnp.bfloat16, seqlen=32)
    train, _ = get_loaders("synthetic", nsamples=8, seed=0, seqlen=32, model=cfg)
    params, recs, _ = jquantize_model("llama", cfg, params, train, JSpec(**SPEC), verbose=False)
    params = jpack_model("llama", cfg, params, recs)
    out = str(root / "jax_packed")
    jsave_packed(out, "llama", cfg, params, recs, JSpec(**SPEC))
    return d, out, recs


def _same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if x.dtype.kind in "iu" or x.dtype == np.float16:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        else:
            np.testing.assert_array_equal(x.astype(np.float32), y.astype(np.float32), err_msg=k)


def test_jax_checkpoint_loads_in_port_and_back(jax_packed, tmp_path):
    _, jdir, _ = jax_packed
    cfg, params = hf_loader.load_params(jdir, device="cpu")
    q = params["layers"][0]["self_attn"]["q_proj"]
    assert isinstance(q, PackedLinear) and q.bits == 4 and q.perm is not None
    assert params["embed_tokens"].dtype == torch.bfloat16
    jflat = hf_loader.read_flat_state(jdir)
    for li in range(cfg.num_layers):
        for name in ("self_attn.q_proj", "mlp.down_proj"):
            lin = params["layers"][li]
            for part in name.split("."):
                lin = lin[part]
            for k, v in lin.to_wire().items():
                ref = jflat[f"model.layers.{li}.{name}.{k}"]
                assert v.dtype == ref.dtype and v.tobytes() == ref.tobytes(), (li, name, k)

    pdir = str(tmp_path / "port_packed")
    save_packed(pdir, "llama", cfg, params)
    _same_state(st_load_any(pdir), st_load_any(jdir))
    jcfg, jparams = jloader.load_params(pdir, dtype=jnp.bfloat16)
    assert (jcfg.hidden_size, jcfg.num_layers) == (cfg.hidden_size, cfg.num_layers)
    jq = jparams["layers"][0]["self_attn"]["q_proj"]
    for k, v in jq.to_wire().items():
        assert v.tobytes() == q.to_wire()[k].tobytes(), k


def st_load_any(d):
    """Flat state of a checkpoint dir through the port's reader."""
    return safetensors_io.load_file(os.path.join(d, "model.safetensors"))


def test_safetensors_io_matches_the_package(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {"a.f32": rng.standard_normal((3, 5)).astype(np.float32),
               "b.f16": rng.standard_normal((7,)).astype(np.float16),
               "c.i32": rng.randint(-2**31, 2**31, size=(4, 2), dtype=np.int32),
               "d.i64": np.arange(3, dtype=np.int64), "e.empty": np.zeros((0, 4), np.float32)}
    ours = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(tensors, ours)
    back = st_load(ours)
    theirs = str(tmp_path / "theirs.safetensors")
    st_save(tensors, theirs, metadata={"format": "pt"})
    mine = safetensors_io.load_file(theirs)
    for k, v in tensors.items():
        for got in (back[k], mine[k]):
            assert got.dtype == v.dtype and got.shape == v.shape and got.tobytes() == v.tobytes()
    # bf16: written from a torch tensor, read back widened to fp32 (exact)
    t = torch.randn(6, 3).bfloat16()
    path = str(tmp_path / "bf16.safetensors")
    safetensors_io.save_file({"w": t}, path)
    np.testing.assert_array_equal(safetensors_io.load_file(path)["w"], t.float().numpy())
    import safetensors.torch
    assert torch.equal(safetensors.torch.load_file(path)["w"], t)


def test_hf_checkpoint_reads_like_jax(jax_packed):
    """The fp32 HF checkpoint written by transformers: the port's reader and
    loader see the same tensors as the TPU package's."""
    d, _, _ = jax_packed
    ref = st_load(os.path.join(d, "model.safetensors"))
    _same_state(hf_loader.read_flat_state(d), ref)
    cfg, params = hf_loader.load_params(d, device="cpu", dtype=torch.float32)
    _, jparams = jloader.load_params(d, dtype=jnp.float32)
    np.testing.assert_array_equal(params["layers"][1]["mlp"]["up_proj"]["kernel"].numpy(),
                                  np.asarray(jparams["layers"][1]["mlp"]["up_proj"]["kernel"]))
    np.testing.assert_array_equal(params["lm_head"]["kernel"].numpy(),
                                  np.asarray(jparams["lm_head"]["kernel"]))


def test_quant_config_and_table_equal_jax(jax_packed, tmp_path):
    """Same records through both packages' savers: file-equal metadata."""
    _, jdir, jrecs = jax_packed
    recs = records_from_jax(jrecs)
    for k, r in recs.items():
        back = record_to_numpy(r)
        assert back["scale"].tobytes() == np.asarray(jrecs[k].scale).tobytes()
        assert back["wbits"] == jrecs[k].wbits
    cfg, params = hf_loader.load_params(jdir, device="cpu", seqlen=32)   # as it was saved
    pdir = str(tmp_path / "port")
    save_packed(pdir, "llama", cfg, params, recs, QuantizeSpec(**SPEC))
    for f in ("quantize_config.json", "config.json"):
        assert filecmp.cmp(os.path.join(pdir, f), os.path.join(jdir, f), shallow=False), f
    # a mixed-width record set gets per_layer overrides in both
    mixed = dict(jrecs)
    key = "layers.1.mlp.down_proj"
    mixed[key] = mixed[key]._replace(wbits=8)
    jsave_cfg = str(tmp_path / "jmixed")
    _, jparams = jloader.load_params(jdir, dtype=jnp.bfloat16)
    jsave_packed(jsave_cfg, "llama", cfg, jparams, mixed, JSpec(**SPEC))
    save_packed(str(tmp_path / "mixed"), "llama", cfg, params, records_from_jax(mixed),
                QuantizeSpec(**SPEC))
    assert filecmp.cmp(os.path.join(jsave_cfg, "quantize_config.json"),
                       str(tmp_path / "mixed" / "quantize_config.json"), shallow=False)

    export_quant_table(recs, str(tmp_path / "qt"))
    jexport(jrecs, str(tmp_path / "jqt"))
    cmp = filecmp.dircmp(str(tmp_path / "qt"), str(tmp_path / "jqt"))
    names = []
    for root, _, files in os.walk(tmp_path / "jqt"):
        names += [os.path.relpath(os.path.join(root, f), tmp_path / "jqt") for f in files]
    assert len(names) > 3 * len(recs)
    for n in names:
        assert filecmp.cmp(str(tmp_path / "qt" / n), str(tmp_path / "jqt" / n), shallow=False), n
    assert not cmp.left_only and not cmp.right_only
