"""Sequential layer-by-layer GPTQ quantization engine.

Counterpart of ``gptq_for_llama_tpu/engine/quantize.py``. The reference's
forward hooks become the ``taps`` dict each arch's ``layer`` returns; its
Catcher input capture becomes running ``embed``. All nsamples hidden states
stay on the device as one (nsamples, seqlen, hidden) tensor; layers are
quantized strictly in order; forwards run in ``chunk``-sample microbatches.
The calibration forward is the cache-less causal forward: its attention goes
through the causal prefill kernel on the card, its dense linears through
``torch.matmul`` (the TPU package leaves them to XLA). Gram sums accumulate
in fp64 and the solver runs in full fp32 (``quant.gptq``).

Linears fed by the same activation (q/k/v, gate/up) share one Gram-matrix
accumulation; the TPU package accumulates each separately, to the same sums.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.common import causal_mask
from ..models.registry import get_arch
from ..ops.linear import PackedLinear
from ..quant.gptq import batch_hessian, gptq_quantize, gram
from ..quant.quantizer import QuantConfig, fake_quantize, find_params_weight
from ..utils.metrics import ascii_table, gen_conditions, snr_error


@dataclasses.dataclass(frozen=True)
class QuantizeSpec:
    """All quantization knobs (the reference's argparse flags)."""

    wbits: int = 4
    groupsize: int = -1
    sym: bool = False
    trits: bool = False
    mse: bool = False
    percdamp: float = 0.01
    blocksize: int = 128
    act_order: bool = False
    true_sequential: bool = False
    nearest: bool = False           # RTN baseline instead of GPTQ (--nearest)
    observe: bool = False           # keep worst layers for auto-upgrade (--observe)
    chunk: int = 16                 # calibration samples per forward microbatch
    quantize_lm_head: bool = False  # GPTQ the output head too (beyond the reference)

    def qconfig(self, wbits: Optional[int] = None) -> QuantConfig:
        # wire_safe: the packed checkpoint must represent the fake-quant grid
        # exactly (the zeros-1 wire offset wraps at zero 0)
        return QuantConfig(bits=wbits or self.wbits, perchannel=True, sym=self.sym,
                           mse=self.mse, trits=self.trits, wire_safe=True)


class QuantRecord(NamedTuple):
    """Per-linear quantization artifact (host numpy): the reference's
    quantizers-dict tuple (quantizer, scale, zero, g_idx, wbits, groupsize)."""

    scale: np.ndarray      # (out, G)
    zero: np.ndarray       # (out, G)
    g_idx: np.ndarray      # (in,)
    wbits: int
    groupsize: int
    error: float
    sym: bool = False


class ObserverEntry(NamedTuple):
    layer_idx: int
    name: str
    error: float
    hessian: Optional[torch.Tensor]   # kept (in host memory) only when observing


class Observer:
    """Top-k worst layers by quantization error."""

    def __init__(self, topk: int = 32):
        self.items: list[ObserverEntry] = []
        self.topk = topk

    def submit(self, entry: ObserverEntry):
        if len(self.items) < self.topk:
            self.items.append(entry)
            return
        min_idx = min(range(len(self.items)), key=lambda i: self.items[i].error)
        if self.items[min_idx].error < entry.error:
            self.items[min_idx] = entry

    def ranked(self) -> list[ObserverEntry]:
        return sorted(self.items, key=lambda e: e.error, reverse=True)

    def table(self) -> str:
        return ascii_table(["name", "error"],
                           [[f"{e.name}.{e.layer_idx}", float(e.error)] for e in self.ranked()])


def get_path(tree, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def set_path(tree, dotted: str, value):
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def layer_linears(arch, lp) -> list[str]:
    """Linear names present in this layer's params."""
    return [n for n in arch.LAYER_LINEARS if isinstance(get_path(lp, n), (dict, PackedLinear))]


def _record(scale, zero, g_idx, wbits, groupsize, error, sym) -> QuantRecord:
    host = lambda t: t.detach().cpu().numpy()
    return QuantRecord(host(scale), host(zero), host(g_idx), wbits, groupsize, float(error),
                       sym=sym)


def _quantize_one(w_t, h, spec: QuantizeSpec, wbits: int, groupsize: int):
    """GPTQ (or RTN) one weight w_t (out, in) fp32. Returns (q, record)."""
    cfg = spec.qconfig(wbits)
    if spec.nearest:
        # RTN: per-row params over the whole weight; recorded as one whole-row
        # group (-1), which is what the wire buffers then hold
        scale, zero = find_params_weight(w_t, cfg)
        q = fake_quantize(w_t, scale, zero, cfg)
        g = torch.zeros(w_t.shape[1], dtype=torch.int32)
        return q, _record(scale, zero, g, wbits, -1, ((q - w_t) ** 2).sum(), spec.sym)
    res = gptq_quantize(w_t, h, cfg, blocksize=spec.blocksize, percdamp=spec.percdamp,
                        groupsize=groupsize, actorder=spec.act_order)
    return res.qweight, _record(res.scale, res.zero, res.g_idx, wbits, groupsize, res.error,
                                spec.sym)


def _group_hessian_sums(arch, cfg, lp, x, positions, mask, group, chunk, keep_taps, clock):
    """Run the layer over x in chunks; per linear of ``group`` the Gram sum of
    its input, and (``keep_taps``) the last chunk's fp32 inputs."""
    sums, owner, last_taps = {}, {}, None
    for i in range(0, x.shape[0], chunk):
        t0 = time.perf_counter()
        _, taps, _ = arch.layer(cfg, lp, x[i:i + chunk], positions, mask)
        clock("forward", t0)
        t0 = time.perf_counter()
        if not owner:   # linears reading one activation share its sum
            for n in group:
                owner[n] = next(m for m in group if taps[m] is taps[n])
        for n in set(owner.values()):
            g = gram(taps[n])
            sums[n] = g if n not in sums else sums[n] + g
        if keep_taps:
            last_taps = {n: taps[n].float().reshape(-1, taps[n].shape[-1]) for n in group}
        del taps
        clock("hessian", t0)
    return {n: sums[owner[n]] for n in group}, last_taps


@torch.inference_mode()
def quantize_model(arch_name: str, cfg, params, train_windows, spec: QuantizeSpec,
                   verbose: bool = True, log=print, resume_dir: str = None, mesh=None,
                   timings: Optional[dict] = None):
    """Quantize every decoder layer of ``params`` (dense kernels (in, out) on
    one device) in order, replacing each kernel by its fake-quantized weight.

    train_windows: (nsamples, seqlen) int calibration windows. Returns
    (params, {dotted_name: QuantRecord}, Observer). resume_dir: after each
    layer its fake-quantized kernels and records are written there, and a
    re-run with the same directory skips the completed layers. timings: if a
    dict is given, the seconds spent in forwards, Hessians and the solver are
    added to its "forward", "hessian" and "solver" keys (each phase ends in a
    device synchronize, so the split is exact on the card)."""
    if mesh is not None:
        raise NotImplementedError("data-parallel calibration (--dp) is not yet ported "
                                  "(ROADMAP A18)")
    if resume_dir is not None and spec.observe:
        raise ValueError(
            "--observe with --resume-dir is unsupported: resumed layers carry no retained "
            "Hessian, so the auto-upgrade pass would silently exclude them from its ranking")
    arch = get_arch(arch_name)
    t_start = time.time()
    dev = params["embed_tokens"].device
    windows = torch.as_tensor(np.asarray(train_windows), dtype=torch.long, device=dev)
    ns, seqlen = windows.shape
    chunk = min(spec.chunk, ns)
    assert ns % chunk == 0, f"nsamples {ns} must divide by chunk {chunk}"
    positions = torch.arange(seqlen, device=dev)[None, :]
    mask = causal_mask(seqlen, seqlen, device=dev)
    dtype = params["embed_tokens"].dtype
    split = timings if timings is not None else {}

    def clock(key, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        split[key] = split.get(key, 0.0) + time.perf_counter() - t0

    def propagate(lp, x):
        t0 = time.perf_counter()
        x = torch.cat([arch.layer(cfg, lp, x[i:i + chunk], positions, mask)[0]
                       for i in range(0, ns, chunk)])
        clock("forward", t0)
        return x

    x = torch.cat([arch.embed(params, cfg, windows[i:i + chunk]) for i in range(0, ns, chunk)])
    quantizers: dict[str, QuantRecord] = {}
    observer = Observer()
    if verbose:
        log(ascii_table(["layer", "name", "weight_error", "time"], []).split("\n")[1])

    for li, lp in enumerate(params["layers"]):
        names_present = layer_linears(arch, lp)
        if resume_dir is not None and _load_layer_ckpt(resume_dir, li, lp, quantizers, spec):
            if verbose:
                log(f"| layer {li:3d} | resumed from checkpoint |")
            x = propagate(lp, x)
            continue
        groups = [[n for n in g if n in names_present]
                  for g in arch.sequential_groups(spec.true_sequential)]
        for group in [g for g in groups if g]:
            sums, last_taps = _group_hessian_sums(arch, cfg, lp, x, positions, mask, group,
                                                  chunk, spec.observe, clock)
            for name in group:
                t0 = time.perf_counter()
                kernel = get_path(lp, name)["kernel"]
                w_t = kernel.T.float()
                h = (sums[name] * (2.0 / ns)).float()   # H = 2/nsamples * sum x x^T
                q, rec = _quantize_one(w_t, h, spec, spec.wbits, spec.groupsize)
                get_path(lp, name)["kernel"] = q.T.to(dtype).contiguous()
                quantizers[f"layers.{li}.{name}"] = rec
                observer.submit(ObserverEntry(li, name, rec.error,
                                              h.cpu() if spec.observe else None))
                clock("solver", t0)
                if verbose:
                    snr_txt = ""
                    if spec.observe:
                        fp_snr, q_snr = snr_probe(q.T, kernel.float(), last_taps[name])
                        snr_txt = f" fp_inp_SNR {fp_snr:10.4f} | q_inp_SNR {q_snr:10.4f} |"
                    log(f"| layer {li:3d} | {name:28s} | error {rec.error:12.4f} "
                        f"|{snr_txt} {time.perf_counter() - t0:6.2f}s |")
        if resume_dir is not None:
            _save_layer_ckpt(resume_dir, li, lp, names_present, quantizers)
        x = propagate(lp, x)   # quantized activations feed the next layer

    if spec.quantize_lm_head:
        _quantize_lm_head(arch, cfg, params, x, spec, ns, chunk, quantizers, verbose, log)
    if spec.observe:
        _auto_upgrade(params, quantizers, observer, spec, verbose, log)
    if verbose:
        log(f"quantization done in {time.time() - t_start:.1f}s")
    return params, quantizers, observer


def _quantize_lm_head(arch, cfg, params, x, spec, ns, chunk, quantizers, verbose, log):
    """GPTQ the output head on the final-norm activations (opt-in; the
    reference never quantizes lm_head). A tied head is skipped."""
    lin = params.get("lm_head")
    if not isinstance(lin, dict) or "kernel" not in lin:
        return
    if getattr(cfg, "tie_word_embeddings", False):
        if verbose:
            log("| lm_head: tied to embeddings — not quantized |")
        return
    t0 = time.time()
    kdim = lin["kernel"].shape[0]
    h = torch.zeros((kdim, kdim), dtype=torch.float32, device=x.device)
    for i in range(0, ns, chunk):
        # each chunk's (2/chunk)-normalized Hessian weighted by chunk/ns
        h = h + batch_hessian(arch.head_input(params, cfg, x[i:i + chunk])) * (chunk / ns)
    q, rec = _quantize_one(lin["kernel"].T.float(), h, spec, spec.wbits, spec.groupsize)
    lin["kernel"] = q.T.to(lin["kernel"].dtype).contiguous()
    quantizers["lm_head"] = rec
    if verbose:
        log(f"| head      | {'lm_head':28s} | error {rec.error:12.4f} "
            f"| {time.time() - t0:6.2f}s |")


def _auto_upgrade(params, quantizers, observer: Observer, spec: QuantizeSpec, verbose: bool,
                  log):
    """Re-quantize the worst layers at higher precision until the error
    halves (the reference's --observe pass), from the current fake-quantized
    weight with the retained Hessian, walking ``gen_conditions``."""
    if verbose:
        log(observer.table())
    for entry in observer.ranked():
        if entry.hessian is None:
            continue
        dotted = f"layers.{entry.layer_idx}.{entry.name}"
        lp = params["layers"][entry.layer_idx]
        target = entry.error / 2.0
        for wbits, gs in gen_conditions(spec.wbits, spec.groupsize):
            kernel = get_path(lp, entry.name)["kernel"]
            q, rec = _quantize_one(kernel.T.float(), entry.hessian.to(kernel.device), spec,
                                   wbits, gs)
            if verbose:
                log(f"| observe {dotted}: wbits={wbits} groupsize={gs} "
                    f"error={rec.error:.4f} (target {target:.4f}) |")
            if rec.error < target:
                get_path(lp, entry.name)["kernel"] = q.T.to(kernel.dtype).contiguous()
                quantizers[dotted] = rec
                break


# ---------------------------------------------------------------------------
# mid-quantization checkpointing
# ---------------------------------------------------------------------------

def _ckpt_path(resume_dir: str, li: int) -> str:
    return os.path.join(resume_dir, f"layer_{li:04d}.npz")


def _save_layer_ckpt(resume_dir: str, li: int, lp, names, quantizers):
    """The layer's fake-quantized kernels (fp32, exact for bf16) and records."""
    os.makedirs(resume_dir, exist_ok=True)
    payload = {}
    for name in names:
        rec = quantizers[f"layers.{li}.{name}"]
        payload[f"{name}/kernel"] = get_path(lp, name)["kernel"].float().cpu().numpy()
        payload[f"{name}/scale"] = rec.scale
        payload[f"{name}/zero"] = rec.zero
        payload[f"{name}/g_idx"] = rec.g_idx
        payload[f"{name}/meta"] = np.asarray(
            [rec.wbits, rec.groupsize, rec.error, float(rec.sym)], np.float64)
    tmp = _ckpt_path(resume_dir, li) + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, _ckpt_path(resume_dir, li))


def _load_layer_ckpt(resume_dir: str, li: int, lp, quantizers, spec=None) -> bool:
    path = _ckpt_path(resume_dir, li)
    if not os.path.exists(path):
        return False
    data = np.load(path)
    for name in sorted({k.split("/")[0] for k in data.files}):
        kernel = get_path(lp, name)["kernel"]
        get_path(lp, name)["kernel"] = torch.as_tensor(data[f"{name}/kernel"]).to(
            device=kernel.device, dtype=kernel.dtype)
        meta = data[f"{name}/meta"]
        rec = QuantRecord(data[f"{name}/scale"], data[f"{name}/zero"], data[f"{name}/g_idx"],
                          int(meta[0]), int(meta[1]), float(meta[2]),
                          sym=bool(meta[3]) if len(meta) > 3 else False)
        if spec is not None and (rec.wbits != spec.wbits
                                 or (not spec.nearest and rec.groupsize != spec.groupsize)
                                 or rec.sym != spec.sym):
            raise ValueError(
                f"resume checkpoint layer {li} ({name}) was quantized with wbits={rec.wbits} "
                f"groupsize={rec.groupsize} sym={rec.sym}, which differs from the current "
                f"spec — point --resume-dir at a matching run or remove it")
        quantizers[f"layers.{li}.{name}"] = rec
    return True


def snr_probe(kernel_q, kernel_fp, x):
    """(fp_inp_SNR, q_inp_SNR) of one linear on a probe activation x (T, in):
    the input quantized to int8 per tensor, symmetric, as the reference."""
    from ..quant.quantizer import find_params_activation
    cfg8 = QuantConfig(bits=8, perchannel=False, sym=True, mse=False)
    scale, zero = find_params_activation(x, cfg8)
    q_in = fake_quantize(x, scale, zero, cfg8)
    kq, kf = kernel_q.float(), kernel_fp.float()
    out_ref = x @ kf
    return float(snr_error(x @ kq, out_ref)), float(snr_error(q_in @ kq, out_ref))
