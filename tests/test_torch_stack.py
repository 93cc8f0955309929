"""The LLaMA stack with every residual add folded into a norm, on the CPU.

Each layer's o_proj output is added in the post-attention norm's call
(``add_rms_norm``) and its down_proj output is carried to the next layer's
input norm, or to the final norm (``llama.stack``). Held BIT-EQUAL (tolerance
0, fp32 and bf16 weights carried across by ``params_from_jax``) to the
composition the layer had before, which added each output to the residual
stream first and then normalized it: in ``llama.forward``, the runner's
prefill and decode (classic and fold), every serving engine mode and the eval
loop. The plain versions are the same torch add and norm in both, so any
difference is a wrong operand or a lost add. Greedy tokens against the TPU
package stay with ``test_torch_model.py`` and ``test_torch_serve.py``.
"""

import numpy as np
import pytest
import torch

from gptq_for_llama_tpu_torch.convert import params_from_jax
from gptq_for_llama_tpu_torch.engine.evaluate import window_nll
from gptq_for_llama_tpu_torch.models import common, llama
from gptq_for_llama_tpu_torch.models.config import ModelConfig
from gptq_for_llama_tpu_torch.ops.linear import linear_apply
from gptq_for_llama_tpu_torch.ops.quant_matmul import fused_gate_up
from gptq_for_llama_tpu_torch.runtime import GenRequest, ModelRunner, ServingEngine

CFG = dict(arch="llama", vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=3,
           num_heads=4, num_kv_heads=2, head_dim=8, max_seq_len=64)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _model(dtype, seed=0):
    """A dense LLaMA drawn with numpy, through the hand-over converter."""
    rng = np.random.RandomState(seed)
    hid, inter, v = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]
    h, kvh = CFG["num_heads"] * CFG["head_dim"], CFG["num_kv_heads"] * CFG["head_dim"]

    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32)}

    def norm():
        return (1 + 0.1 * rng.standard_normal(hid)).astype(np.float32)

    tree = {"embed_tokens": rng.standard_normal((v, hid)).astype(np.float32),
            "layers": [{"input_layernorm": norm(), "post_attention_layernorm": norm(),
                        "self_attn": {"q_proj": lin(hid, h), "k_proj": lin(hid, kvh),
                                      "v_proj": lin(hid, kvh), "o_proj": lin(h, hid)},
                        "mlp": {"gate_proj": lin(hid, inter), "up_proj": lin(hid, inter),
                                "down_proj": lin(inter, hid)}}
                       for _ in range(CFG["num_layers"])],
            "norm": norm(), "lm_head": lin(hid, v)}
    return ModelConfig(**CFG), params_from_jax(tree, "cpu", DTYPES[dtype])


def _layer_before(cfg, lp, x, positions, mask, past_kv=None, rope=None):
    """The layer as it composed before: each output added to the residual
    stream, then the sum normalized."""
    h_attn_in = common.rms_norm(x, lp["input_layernorm"], cfg.norm_eps)
    att = lp["self_attn"]
    q = linear_apply(att["q_proj"], h_attn_in)
    k = linear_apply(att["k_proj"], h_attn_in)
    v = linear_apply(att["v_proj"], h_attn_in)
    b, s, _ = x.shape
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    cos, sin = rope if rope is not None else common.rope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, dtype=x.dtype)
    q, k = common.apply_rope(q, k, cos, sin)
    attn_out, present = common.attention_block(past_kv, q, k, v, mask)
    attn_out = attn_out.reshape(b, s, -1)
    x = x + linear_apply(att["o_proj"], attn_out)
    h_mlp_in = common.rms_norm(x, lp["post_attention_layernorm"], cfg.norm_eps)
    mlp = lp["mlp"]
    h_down_in = fused_gate_up(mlp["gate_proj"], mlp["up_proj"], h_mlp_in, cfg.act)
    y = x + linear_apply(mlp["down_proj"], h_down_in)
    taps = {"self_attn.q_proj": h_attn_in, "self_attn.k_proj": h_attn_in,
            "self_attn.v_proj": h_attn_in, "self_attn.o_proj": attn_out,
            "mlp.gate_proj": h_mlp_in, "mlp.up_proj": h_mlp_in, "mlp.down_proj": h_down_in}
    return y, taps, present


def _stack_before(params, cfg, x, positions, mask, past=None, rope=None):
    """``llama.stack`` as a loop over the layer before: the hidden state with
    nothing pending (x + 0 is x in every dtype)."""
    for li, lp in enumerate(params["layers"]):
        x, _, _ = _layer_before(cfg, lp, x, positions, mask,
                                None if past is None else past(li), rope)
    return x, torch.zeros_like(x)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_with_its_defaults_is_the_layer_before(dtype):
    """``layer`` without a pending add and without deferring (the quantize
    engine's call) returns the same y, taps and cache as before, bit for bit;
    with ``defer`` its (x, down) add up to that y, and with ``delta`` it takes
    x + delta as its input."""
    cfg, params = _model(dtype)
    lp = params["layers"][1]
    rng = np.random.RandomState(1)
    x = torch.as_tensor(rng.standard_normal((2, 5, cfg.hidden_size)), dtype=DTYPES[dtype])
    d = torch.as_tensor(rng.standard_normal((2, 5, cfg.hidden_size)), dtype=DTYPES[dtype])
    pos = torch.arange(5)[None]
    mask = common.causal_mask(5, 5)
    want = _layer_before(cfg, lp, x, pos, mask)
    assert _equal(llama.layer(cfg, lp, x, pos, mask), want)
    (xr, down), taps, _ = llama.layer(cfg, lp, x, pos, mask, defer=True)
    assert torch.equal(xr + down, want[0]) and _equal(taps, want[1])
    assert _equal(llama.layer(cfg, lp, x, pos, mask, delta=d)[:2],
                  _layer_before(cfg, lp, x + d, pos, mask)[:2])
    caches = [torch.zeros(2, 16, cfg.num_kv_heads, cfg.head_dim, dtype=DTYPES[dtype])
              for _ in range(4)]
    got = llama.layer(cfg, lp, x, pos, None, (caches[0], caches[1], 3))
    want = _layer_before(cfg, lp, x, pos, None, (caches[2], caches[3], 3))
    assert _equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_is_bit_equal_to_the_layer_by_layer_composition(dtype):
    cfg, params = _model(dtype)
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 9)))
    pos = torch.arange(9)[None]
    x, _ = _stack_before(params, cfg, llama.embed(params, cfg, ids), pos,
                         common.causal_mask(9, 9))
    assert torch.equal(llama.forward(params, cfg, ids), llama.head(params, cfg, x))


def _runner_steps(cfg, params, dtype, cache_impl):
    r = ModelRunner("llama", cfg, params, batch_size=2, max_seq_len=32, dtype=DTYPES[dtype],
                    device="cpu", cache_impl=cache_impl)
    ids = torch.as_tensor(np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 11)))
    logits, cache = r.prefill(ids[:, :6], r.init_cache())
    out = [logits]
    for i in range(6, 11):
        logits, cache = r.decode(ids[:, i:i + 1], cache)
        out.append(logits)
    return out, cache.k, cache.v


@pytest.mark.parametrize("cache_impl", ["classic", "fold"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_runner_prefill_and_decode_are_bit_equal(dtype, cache_impl, monkeypatch):
    """Prefill and five decode steps: every step's logits and the caches the
    layers wrote."""
    cfg, params = _model(dtype)
    got = _runner_steps(cfg, params, dtype, cache_impl)
    monkeypatch.setattr(llama, "stack", _stack_before)
    assert _equal(got, _runner_steps(cfg, params, dtype, cache_impl))


SERVE_MODES = {
    "dense": dict(),
    "dense fold span 4": dict(cache_impl="fold", decode_span=4),
    "paged": dict(paged=True, block_size=8),
    "chunked+fused": dict(prefill_chunk=8),
    "chunked+fused+paged": dict(prefill_chunk=8, paged=True, block_size=8),
    "batched admission": dict(slots=4),
}


_HEAD = llama.head


def _serve(cfg, params, dtype, kw, monkeypatch):
    """Every request's tokens and every logits row the engine's head made."""
    kw = dict(kw)
    heads = []

    def recording(*args):
        out = _HEAD(*args)
        heads.append(out)
        return out

    monkeypatch.setattr(llama, "head", recording)
    eng = ServingEngine("llama", cfg, params, batch_slots=kw.pop("slots", 2), max_seq_len=40,
                        dtype=DTYPES[dtype], prefill_buckets=(8, 32), device="cpu", **kw)
    rng = np.random.RandomState(4)
    for uid, n in enumerate((3, 2, 17, 1, 11, 3)):
        eng.submit(GenRequest(uid=uid, prompt=rng.randint(1, cfg.vocab_size, size=n),
                              max_new_tokens=5))
    results = eng.run()
    return [results[u] for u in sorted(results)], heads, dict(eng.forwards)


@pytest.mark.parametrize("mode", list(SERVE_MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_serving_engine_steps_are_bit_equal(dtype, mode, monkeypatch):
    """Every head call of a whole serving run (decode steps, per-slot
    prefills or chunks, batched admissions, token-fused chunk+decode steps)
    and every token."""
    cfg, params = _model(dtype)
    toks, heads, forwards = _serve(cfg, params, dtype, SERVE_MODES[mode], monkeypatch)
    monkeypatch.setattr(llama, "stack", _stack_before)
    want_toks, want_heads, want_forwards = _serve(cfg, params, dtype, SERVE_MODES[mode],
                                                  monkeypatch)
    assert forwards == want_forwards and len(heads) == sum(forwards.values())
    assert all(np.array_equal(a, b) for a, b in zip(toks, want_toks))
    assert _equal(heads, want_heads)


def _window_nll_before(cfg, params, ids, head_chunk):
    """The eval loop before: the final norm applied per head chunk."""
    b, s = ids.shape
    pos = torch.arange(s)[None]
    x, _ = _stack_before(params, cfg, llama.embed(params, cfg, ids), pos,
                         common.causal_mask(s, s))
    xs, labels = x[:, :-1], ids[:, 1:]
    acc = torch.zeros(b, dtype=torch.float32)
    for c0 in range(0, s - 1, min(head_chunk, s - 1)):
        logits = llama.head(params, cfg, xs[:, c0:c0 + head_chunk]).float()
        gold = logits.gather(-1, labels[:, c0:c0 + head_chunk, None])[..., 0]
        acc += (torch.logsumexp(logits, dim=-1) - gold).sum(-1)
    return acc / (s - 1) * s


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_eval_window_nll_is_bit_equal(dtype):
    """The eval loop normalizes every row once, the last layer's add in the
    final norm's call, where it normalized each head chunk before."""
    cfg, params = _model(dtype)
    ids = torch.as_tensor(np.random.RandomState(5).randint(0, cfg.vocab_size, (3, 16)))
    with torch.inference_mode():
        assert torch.equal(window_nll(llama, cfg, params, ids, head_chunk=4),
                           _window_nll_before(cfg, params, ids, head_chunk=4))


def test_norm_calls_per_forward_on_every_path(monkeypatch):
    """What the card's launch checks count, counted here at the dispatch: a
    forward through the stack makes one norm alone (layer 0's input norm) and
    2L with the residual add folded in (each post-attention norm, each later
    input norm, the final norm), and no other residual add; the quantize
    engine's layer-by-layer call makes one of each."""
    cfg, params = _model("fp32")
    layers = cfg.num_layers
    calls = {"alone": 0, "add": 0}

    def counting(form, fn):
        def call(*args):
            calls[form] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(llama, "rms_norm", counting("alone", llama.rms_norm))
    monkeypatch.setattr(llama, "add_rms_norm", counting("add", llama.add_rms_norm))

    def per_forward(run):   # run() makes the calls and returns its forwards
        calls.update(alone=0, add=0)
        n = run()
        assert calls == {"alone": n, "add": 2 * layers * n}

    ids = torch.as_tensor(np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 8)))
    per_forward(lambda: (llama.forward(params, cfg, ids), 1)[1])
    r = ModelRunner("llama", cfg, params, batch_size=2, max_seq_len=32, dtype=torch.float32,
                    device="cpu")
    per_forward(lambda: (r.prefill(ids, r.init_cache()), 1)[1])
    cache = r.prefill(ids, r.init_cache())[1]
    per_forward(lambda: (r.decode(ids[:, :1], cache), 1)[1])

    def serve(**kw):
        eng = ServingEngine("llama", cfg, params, batch_slots=2, max_seq_len=40,
                            dtype=torch.float32, prefill_buckets=(8,), device="cpu", **kw)
        for uid, n in enumerate((3, 12, 5)):
            eng.submit(GenRequest(uid=uid, prompt=np.arange(1, n + 1), max_new_tokens=4))
        eng.run()
        return sum(eng.forwards.values())

    per_forward(lambda: serve(paged=True, block_size=8))
    per_forward(lambda: serve(prefill_chunk=4))
    with torch.inference_mode():
        per_forward(lambda: (window_nll(llama, cfg, params, ids, head_chunk=3), 1)[1])
    calls.update(alone=0, add=0)
    llama.layer(cfg, params["layers"][0], llama.embed(params, cfg, ids), torch.arange(8)[None],
                common.causal_mask(8, 8))
    assert calls == {"alone": 1, "add": 1}
