"""LoRA finetuning over frozen packed weights: the port held against the TPU
package.

``attach_lora`` / ``split_lora`` / ``join_lora`` are ported from
tests/test_lora.py. Then the same tiny packed LLaMA, OPT, GPT-NeoX or GPT-2
with the same adapters (drawn by the TPU package, ``b`` set nonzero from
numpy, handed over with ``convert.params_from_jax``) gives the same loss and
the same gradient of every adapter through the whole model, fp32 on the CPU
(the port through its autograd Functions over the plain versions, the TPU
package through jax.grad of its XLA path); and 25 Adam steps lower the loss.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from gptq_for_llama_tpu.engine import attach_lora as jax_attach_lora
from gptq_for_llama_tpu.engine import join_lora as jax_join_lora
from gptq_for_llama_tpu.engine import split_lora as jax_split_lora
from gptq_for_llama_tpu.engine.quantize import set_path as jax_set_path
from gptq_for_llama_tpu.models import registry as jregistry
from gptq_for_llama_tpu.models.config import ModelConfig as JaxModelConfig
from gptq_for_llama_tpu.ops.linear import PackedLinear as JaxPackedLinear
from gptq_for_llama_tpu.ops.lora import LoraLinear as JaxLoraLinear
from gptq_for_llama_tpu.quant import packing as jpack
from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.engine import LoraLinear, attach_lora, join_lora, split_lora
from gptq_for_llama_tpu_torch.engine.quantize import get_path
from gptq_for_llama_tpu_torch.models import llama, registry
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.ops.linear import PackedLinear
from gptq_for_llama_tpu_torch.runtime.random_model import random_wire_llama

import torch_archs
from test_torch_model import _jax_packed_llama

CFG = dict(arch="llama", vocab_size=96, hidden_size=128, intermediate_size=256,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=64)
# one tiny config per other family: its own tree (tests/torch_archs.py) at
# LLaMA's widths above, so the packed linears have whole groups of 32
ARCH_CFGS = {a: dict(torch_archs.CONFIGS[a], hidden_size=128, intermediate_size=256,
                     num_heads=4, num_kv_heads=4, head_dim=32) for a in ("opt", "neox", "gpt2")}


def _to_wire_tree(p):
    """The TPU package's hand-over format: wire dicts + bits, adapters as
    {"base", "a", "b", "alpha"}, numpy arrays."""
    if isinstance(p, JaxLoraLinear):
        return {"base": _to_wire_tree(p.base), "a": np.asarray(p.a, np.float32),
                "b": np.asarray(p.b, np.float32), "alpha": p.alpha}
    if isinstance(p, JaxPackedLinear):
        d = dict(p.to_wire())
        d["bits"] = p.wire_bits or p.bits
        return d
    if isinstance(p, dict):
        return {k: _to_wire_tree(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_to_wire_tree(v) for v in p]
    return np.asarray(p, np.float32)


def _port_tiny(seed=0):
    cfg = ModelConfig(**CFG)
    return cfg, random_wire_llama(cfg, seed=seed, groupsize=32, device="cpu",
                                  dtype=torch.float32)


def test_attach_preserves_forward_and_caller_tree():
    cfg, params = _port_tiny()
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16)))
    base_logits = llama.forward(params, cfg, ids)
    gen = torch.Generator()
    gen.manual_seed(0)
    adapted = attach_lora("llama", params, rank=4, generator=gen)
    # the caller's tree is untouched; the adapter wraps every layer linear
    assert isinstance(params["layers"][0]["self_attn"]["q_proj"], PackedLinear)
    for lp, orig in zip(adapted["layers"], params["layers"]):
        for name in llama.LAYER_LINEARS:
            lin = get_path(lp, name)
            assert isinstance(lin, LoraLinear) and lin.b.abs().max() == 0
            assert lin.base is get_path(orig, name)
    lin = adapted["layers"][0]["self_attn"]["q_proj"]
    assert lin.a.shape == (cfg.hidden_size, 4) and lin.b.shape == (4, cfg.num_heads * 32)
    assert lin.a.dtype == torch.float32 and 0.005 < float(lin.a.std()) < 0.02
    # b == 0: the initial delta is exactly zero
    torch.testing.assert_close(llama.forward(adapted, cfg, ids), base_logits, atol=1e-5,
                               rtol=1e-5)
    # targets restrict the wrapped linears; an already adapted one is kept
    again = attach_lora("llama", adapted, rank=2, generator=gen, targets=("mlp.down_proj",
                                                                         "self_attn.nope"))
    assert again["layers"][0]["mlp"]["down_proj"] is adapted["layers"][0]["mlp"]["down_proj"]
    some = attach_lora("llama", params, rank=2, generator=gen, targets=("mlp.down_proj",))
    assert isinstance(some["layers"][1]["mlp"]["gate_proj"], PackedLinear)
    assert isinstance(some["layers"][1]["mlp"]["down_proj"], LoraLinear)


def test_split_join_roundtrip():
    cfg, params = _port_tiny()
    gen = torch.Generator()
    gen.manual_seed(1)
    adapted = attach_lora("llama", params, rank=2, generator=gen)
    adapters, skeleton = split_lora(adapted)
    assert len(adapters) == len(llama.LAYER_LINEARS) * cfg.num_layers
    # the skeleton holds no trainable tensor
    for lp in skeleton["layers"]:
        for name in llama.LAYER_LINEARS:
            lin = get_path(lp, name)
            assert isinstance(lin, LoraLinear) and lin.a is None and lin.b is None
    back = join_lora(skeleton, adapters)
    for lp, lq in zip(adapted["layers"], back["layers"]):
        for name in llama.LAYER_LINEARS:
            a, b = get_path(lp, name), get_path(lq, name)
            assert a.a is b.a and a.b is b.b and a.base is b.base and a.alpha == b.alpha
    assert back["embed_tokens"] is adapted["embed_tokens"]


def _adapter_grads(tree, arch="llama"):
    """{(layer, name): (grad a, grad b)} of a tree (of either package) whose
    LoraLinears hold gradients."""
    return {(i, n): (np.asarray(get_path(lp, n).a), np.asarray(get_path(lp, n).b))
            for i, lp in enumerate(tree["layers"]) for n in registry.get_arch(arch).LAYER_LINEARS
            if isinstance(get_path(lp, n), (LoraLinear, JaxLoraLinear))}


def _jax_packed_arch(arch, seed, gs=32, bits=4):
    """JAX params of ``ARCH_CFGS[arch]``: the family's tree with every layer
    linear packed from random wire buffers (4-bit, groups of 32) and a bias
    that fp16 holds exactly (the wire format stores biases in fp16)."""
    tree = torch_archs.np_tree(ARCH_CFGS[arch], seed)
    rng = np.random.RandomState(seed + 1)
    for lp in tree["layers"]:
        for name in jregistry.get_arch(arch).LAYER_LINEARS:
            k, n = get_path(lp, name)["kernel"].shape
            codes = rng.randint(0, 2 ** bits, size=(k, n)).astype(np.uint32)
            zeros = rng.randint(1, 2 ** bits, size=(k // gs, n)).astype(np.uint32)
            bias = (0.1 * rng.standard_normal(n)).astype(np.float16)
            jax_set_path(lp, name, JaxPackedLinear.from_wire(
                jpack.pack_rows(codes, bits), jpack.pack_cols(zeros - 1, bits),
                (rng.rand(k // gs, n) * 0.04 + 0.01).astype(np.float16),
                (np.arange(k) // gs).astype(np.int32), bits=bits,
                bias=bias.astype(np.float32), dtype=jnp.float32))

    def to_jnp(x):
        if isinstance(x, dict):
            return {key: to_jnp(v) for key, v in x.items()}
        if isinstance(x, list):
            return [to_jnp(v) for v in x]
        return jnp.asarray(x) if isinstance(x, np.ndarray) else x
    return to_jnp(tree)


@pytest.mark.parametrize("arch,targets,actorder", [
    pytest.param("llama", None, True, id="None-True"),               # every linear, act-order
    pytest.param("llama", ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                           "self_attn.o_proj", "mlp.down_proj"), False,
                 id="targets1-False"),                                # gate/up fused and frozen
    *[pytest.param(a, None, False, id=a) for a in ("opt", "neox", "gpt2")]])
def test_lora_loss_and_grads_match_jax(arch, targets, actorder):
    """The loss and the gradient of every adapter's a and b through the whole
    tiny packed model equal jax.grad's at 1e-4 of each tensor's largest value
    (fp32; both run the same algorithm). Without adapters on gate/up the port
    takes the fused gate/up and its recomputing backward. OPT, GPT-NeoX and
    GPT-2: adapters on every layer linear of the family (biased, LayerNorm,
    learned positions or partial rotary, parallel residual)."""
    spec = CFG if arch == "llama" else ARCH_CFGS[arch]
    jcfg = JaxModelConfig(**spec)
    cfg = ModelConfig(**spec)
    jparams = (_jax_packed_llama(jcfg, seed=3, actorder=actorder) if arch == "llama"
               else _jax_packed_arch(arch, seed=3))
    adapted = jax_attach_lora(arch, jparams, rank=4, key=jax.random.PRNGKey(0),
                              targets=targets)
    rng = np.random.RandomState(4)
    linears = registry.get_arch(arch).LAYER_LINEARS
    for lp in adapted["layers"]:   # b nonzero, so the gradient of a is live
        for name in linears:
            lin = get_path(lp, name)
            if isinstance(lin, JaxLoraLinear):
                jax_set_path(lp, name, dataclasses.replace(
                    lin, b=jnp.asarray(rng.standard_normal(lin.b.shape) * 0.05, jnp.float32)))
    ids = rng.randint(0, cfg.vocab_size, (2, 12))
    labels = rng.randint(0, cfg.vocab_size, (2, 12))

    jarch = jregistry.get_arch(arch)
    jadapters, jskeleton = jax_split_lora(adapted)

    def jloss_fn(ads):
        logits = jarch.forward(jax_join_lora(jskeleton, ads), jcfg,
                               jnp.asarray(ids)).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], axis=-1))

    jloss, jgrads = jax.value_and_grad(jloss_fn)(jadapters)
    want = _adapter_grads(jax_join_lora(jskeleton, jgrads), arch)

    params = params_from_jax(_to_wire_tree(adapted), "cpu", torch.float32)
    adapters, skeleton = split_lora(params)
    for ab in adapters:
        ab["a"].requires_grad_()
        ab["b"].requires_grad_()
    logits = registry.get_arch(arch).forward(join_lora(skeleton, adapters), cfg,
                                             torch.as_tensor(ids))
    loss = F.cross_entropy(logits.flatten(0, 1).float(), torch.as_tensor(labels).flatten())
    loss.backward()
    got = _adapter_grads(join_lora(skeleton, [{"a": ab["a"].grad, "b": ab["b"].grad}
                                              for ab in adapters]), arch)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    n_targets = len(targets or linears)
    assert set(got) == set(want) and len(got) == n_targets * cfg.num_layers
    for key, (ga, gb) in got.items():
        wa, wb = want[key]
        for g, w, what in ((ga, wa, "a"), (gb, wb, "b")):
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 1e-4, f"{key} {what}: {err}"


def test_lora_training_reduces_loss():
    """25 Adam steps on a fixed batch: the loss drops by more than 0.02, every
    b moved, and the packed buffers are byte-identical afterwards (the
    adapters are the only tensors that require grad)."""
    cfg, params = _port_tiny(seed=2)
    gen = torch.Generator()
    gen.manual_seed(2)
    adapted = attach_lora("llama", params, rank=4, generator=gen)
    adapters, skeleton = split_lora(adapted)
    leaves = [t.requires_grad_() for ab in adapters for t in (ab["a"], ab["b"])]
    frozen = [(lin.qweight.clone(), lin.scales.clone(), lin.zeros.clone())
              for lp in params["layers"] for lin in (get_path(lp, n) for n in llama.LAYER_LINEARS)]
    rng = np.random.RandomState(3)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 16)))
    labels = torch.full((2, 16), 7)
    opt = torch.optim.Adam(leaves, lr=0.05)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        logits = llama.forward(join_lora(skeleton, adapters), cfg, ids)
        loss = F.cross_entropy(logits.flatten(0, 1).float(), labels.flatten())
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.02, losses
    assert all(float(ab["b"].detach().abs().max()) > 0 for ab in adapters)
    after = [(lin.qweight, lin.scales, lin.zeros)
             for lp in params["layers"] for lin in (get_path(lp, n) for n in llama.LAYER_LINEARS)]
    for before, now in zip(frozen, after):
        assert all(torch.equal(x, y) for x, y in zip(before, now))
