"""Serving front door: the continuous-batching engine as a CLI.

Counterpart of ``gptq_for_llama_tpu/cli/serve.py``, with the same flag surface
(``--span`` defaults to 1, not 8: see the flag) and one addition,
``--device``: the CLI runs on the card unless it is given
``--device cpu`` (the plain PyTorch versions), and without a card and without
that flag it raises. It stands up ``runtime.serve.ServingEngine`` (slots,
decode spans, optional paged KV pool, chunked prefill) over a packed
checkpoint, feeds it a batch of prompts, and reports aggregate throughput.
``--tp N`` serves through the tensor-parallel engine in N processes, one
rank each (started here, or joined with ``--distributed``; rank 0 prints).

Usage:
  # real prompts (one per line; tokenizer read from MODEL_DIR)
  python -m gptq_for_llama_tpu_torch serve MODEL_DIR --load PACKED_DIR \\
      --prompts prompts.txt --slots 16 --span 8 --paged

  # synthetic smoke/benchmark (no tokenizer needed)
  python -m gptq_for_llama_tpu_torch serve MODEL_DIR --demo 16 --max-new-tokens 32

Output: one JSON line per finished request ({"uid", "prompt_tokens",
"new_tokens", "text"|"tokens"}) then one final stats line ({"requests",
"tokens", "tok_s", ...knobs}).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gptq_for_llama_tpu_torch serve")
    p.add_argument("model", type=str, help="HF checkpoint directory (tokenizer + config)")
    p.add_argument("--load", type=str, default="",
                   help="packed checkpoint directory (default: MODEL_DIR)")
    # workload
    p.add_argument("--prompts", type=str, default=None, help="text file, one prompt per line")
    p.add_argument("--demo", type=int, default=0,
                   help="serve N synthetic prompts instead of --prompts")
    p.add_argument("--demo-prompt-len", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    # engine knobs (see runtime/serve.py)
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent decode slots (continuous batching)")
    # 1, where the TPU CLI has 8: a decode step replayed from a CUDA graph
    # leaves the host 3-10 % of the step, so a span saves little, while a slot
    # that retires mid-span decodes on and is backfilled only at the span's
    # end (ROADMAP.md, queue A)
    p.add_argument("--span", type=int, default=1,
                   help="decode steps per host read (one CUDA graph on the card)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool instead of dense per-slot cache")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=None,
                   help="paged pool size (default: slots * max_len / block)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="chunked prefill: one fixed-size prompt chunk per engine tick rides "
                        "along with decode")
    p.add_argument("--buckets", type=str, default="32,128,512",
                   help="prefill length buckets (comma-separated)")
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--tp", type=int, default=None, help="tensor-parallel degree")
    p.add_argument("--distributed", action="store_true", help="multi-host initialization")
    p.add_argument("--quiet", action="store_true", help="suppress progress lines on stderr")
    p.add_argument("--kv-dtype", type=str, default=None, dest="kv_dtype",
                   choices=["bf16", "f32", "fp8", "fp8_e5m2"],
                   help="KV storage dtype (fp8: half the KV pool's bytes, 2x tokens per pool)")
    p.add_argument("--fuse-attn", action="store_true", dest="fuse_attn",
                   help="fuse q/k/v into one packed projection at load")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the plain PyTorch versions on the CPU; default: the card")
    return p


def _rank_main(argv):
    """One rank of a spawned group: the serving CLI, printing on rank 0."""
    import torch.distributed as dist
    if dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")
    return _serve(build_parser().parse_args(argv))


def main(argv=None) -> dict:
    """Run the serving CLI; returns what it printed: "requests" (the
    per-request records) and "stats" (the final line)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.fuse_attn and args.tp and args.tp > 1:
        parser.error("--fuse-attn is incompatible with --tp: shard_map TP "
                     "shards q/k/v separately (TP_RULES)")
    if not args.prompts and not args.demo:
        parser.error("need --prompts FILE or --demo N")
    _buckets(parser, args)
    if args.prompts:  # validate BEFORE any checkpoint load
        _prompt_lines(parser, args)
    if args.distributed:
        from ..parallel.distributed import initialize
        initialize(device_type="cpu" if args.device == "cpu" else "cuda", auto=True)
    elif args.tp and args.tp > 1:
        # one process per rank: a card each over NCCL, or the CPU over gloo
        from ..parallel import distributed
        backend = distributed.backend_for("cpu" if args.device == "cpu" else "cuda", args.tp)
        return distributed.spawn(_rank_main, args.tp,
                                 args=(list(argv if argv is not None else sys.argv[1:]),),
                                 backend=backend)[0]
    return _serve(args, parser)


def _buckets(parser, args) -> tuple:
    try:
        buckets = tuple(sorted(int(b) for b in args.buckets.split(",") if b.strip()))
    except ValueError:
        parser.error(f"--buckets must be comma-separated ints, got {args.buckets!r}")
    if not buckets:
        parser.error("--buckets is empty")
    return buckets


def _prompt_lines(parser, args) -> list:
    with open(args.prompts) as f:
        prompt_lines = [line.rstrip("\n") for line in f if line.strip()]
    if not prompt_lines:
        parser.error(f"--prompts {args.prompts}: no non-empty lines")
    return prompt_lines


def _serve(args, parser=None) -> dict:
    """The serving CLI's work in this process (one rank of a group under
    --tp: the tensor-parallel engine over the group's ranks, rank 0
    printing; or alone)."""
    parser = parser or build_parser()
    buckets = _buckets(parser, args)
    prompt_lines = _prompt_lines(parser, args) if args.prompts else None
    import torch.distributed as dist
    from .. import resolve_device
    from ..models import hf_loader
    from ..ops.kv_dtype import kv_dtype
    from ..runtime.serve import GenRequest, ServingEngine

    device = resolve_device(args.device)
    mesh = None
    if args.tp and args.tp > 1:
        from ..parallel.sharding import make_mesh
        mesh = make_mesh(tp=args.tp, dp=1, device="cpu" if device.type == "cpu" else None)
        device = mesh.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if not mesh.member:
            return {}
    t0 = time.time()
    model_dir = args.load or args.model
    cfg, params = hf_loader.load_params(model_dir, seqlen=args.max_seq_len, dtype=torch.bfloat16,
                                        device=device)
    log = (lambda *a: None) if args.quiet else \
        (lambda *a: print(*a, file=sys.stderr, flush=True))
    log(f"loaded {cfg.arch} from {model_dir} on {device} ({time.time() - t0:.1f}s)")

    # workload
    tokenizer = None
    eos = None
    if args.prompts:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model)
        eos = tokenizer.eos_token_id
        prompts = [np.asarray(tokenizer(line)["input_ids"], np.int32) for line in prompt_lines]
    else:
        rng = np.random.RandomState(args.seed)
        prompts = [rng.randint(1, cfg.vocab_size, size=(args.demo_prompt_len,)).astype(np.int32)
                   for _ in range(args.demo)]

    max_len = args.max_seq_len or min(
        cfg.max_seq_len, max(len(p) for p in prompts) + args.max_new_tokens + 1)
    engine = ServingEngine(
        cfg.arch, cfg, params, batch_slots=args.slots, max_seq_len=max_len, paged=args.paged,
        block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, decode_span=args.span, prefill_buckets=buckets,
        device=device, seed=args.seed, kv_dtype=kv_dtype(args.kv_dtype),
        fuse_qkv=args.fuse_attn, mesh=mesh)
    for uid, prompt in enumerate(prompts):
        engine.submit(GenRequest(uid=uid, prompt=prompt, max_new_tokens=args.max_new_tokens,
                                 temperature=args.temperature, top_p=args.top_p,
                                 eos_token_id=eos))

    t1 = time.time()
    results = engine.run(log=log)
    dt = time.time() - t1

    total, records = 0, []
    for uid in sorted(results):
        toks = results[uid]
        total += len(toks)
        rec = {"uid": uid, "prompt_tokens": int(len(prompts[uid])), "new_tokens": int(len(toks))}
        if tokenizer is not None:
            rec["text"] = tokenizer.decode(toks)
        else:
            rec["tokens"] = [int(t) for t in toks]
        print(json.dumps(rec), flush=True)
        records.append(rec)
    stats = {"requests": len(results), "tokens": total,
             "tok_s": round(total / max(dt, 1e-9), 2), **engine.stats(),
             "slots": args.slots, "span": args.span, "paged": args.paged,
             "prefill_chunk": args.prefill_chunk, "tp": args.tp, "max_seq_len": max_len}
    print(json.dumps(stats), flush=True)
    return {"requests": records, "stats": stats}


if __name__ == "__main__":
    main()
