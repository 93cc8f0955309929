"""Multi-process execution: joining a process group, and starting one.

Counterpart of ``gptq_for_llama_tpu/parallel/distributed.py``. The TPU
package runs one JAX process per host over one global computation; the port
runs one process per rank (one card each, or the CPU), joined in a
``torch.distributed`` process group:

  1. ``initialize()`` joins the group that the environment names, gated by
     the same variables as the TPU package: GPTQ_TPU_COORDINATOR
     (``host:port``), GPTQ_TPU_NUM_PROCESSES, GPTQ_TPU_PROCESS_ID, or, with
     none of them, GPTQ_TPU_DISTRIBUTED=1 and a launcher's own variables
     (``torchrun``'s MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).
  2. ``parallel/sharding.make_mesh`` orders the ranks tp-major, so that a tp
     group is consecutive ranks (one host) and dp spans hosts.
  3. ``put_global()``: every rank holds the full host copy and takes its own
     slice.

``spawn`` starts the ranks of one group on this machine (the CLIs without a
launcher, the tests, ``chip_smoke.py``). The backend is chosen, never
switched after a failure: NCCL where each rank has a card of its own, gloo on
the CPU (``backend_for``); ranks that share one card are spawned over gloo by
their caller.

One rank a card: a host of C cards runs C ranks, rank j of host k being
process k * C + j, with LOCAL_WORLD_SIZE = C (``local_rank``). Launch recipe
(N hosts of C cards): on host k start C processes, j = 0 .. C - 1, each with
  GPTQ_TPU_COORDINATOR=host0:8476 GPTQ_TPU_NUM_PROCESSES=<N*C> \\
  GPTQ_TPU_PROCESS_ID=<k*C+j> LOCAL_RANK=<j> LOCAL_WORLD_SIZE=<C> \\
  python -m gptq_for_llama_tpu_torch ... --distributed
or ``torchrun --nnodes N --nproc-per-node C -m gptq_for_llama_tpu_torch ...
--distributed``, which sets its own variables (RANK, LOCAL_RANK, ...).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def local_world(world: int) -> int:
    """The ranks on this host: LOCAL_WORLD_SIZE, else all ``world`` of the
    group (a group launched without it is taken to be one host's)."""
    return _int_env("LOCAL_WORLD_SIZE") or world


def local_rank(rank: int, world: int) -> int:
    """This rank's index on its host, the card it runs on: LOCAL_RANK, else
    ``rank`` modulo the ranks on this host (ranks host-major, as the launch
    recipe numbers them)."""
    local = _int_env("LOCAL_RANK")
    return rank % local_world(world) if local is None else local


def backend_for(device_type: str, ranks: int) -> str:
    """The collective backend of ``ranks`` ranks on this host: "nccl" when
    each has a card of its own (NCCL refuses two ranks on one device), "gloo"
    on the CPU. Ranks that want a card each on a machine with fewer cards
    raise."""
    if device_type == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    if cards < ranks:
        raise RuntimeError(f"{ranks} ranks on this host need a card each; this machine has "
                           f"{cards} (LOCAL_WORLD_SIZE names the ranks a host runs)")
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device_type: str = "cuda",
               backend: Optional[str] = None, auto: bool = False) -> bool:
    """Env-gated ``torch.distributed.init_process_group``; call it before any
    mesh is made. Explicit arguments win; otherwise GPTQ_TPU_COORDINATOR /
    GPTQ_TPU_NUM_PROCESSES / GPTQ_TPU_PROCESS_ID are read. With no
    coordinator and GPTQ_TPU_DISTRIBUTED=1 the launcher's environment
    (``env://``) names the group; ``auto`` stands for GPTQ_TPU_DISTRIBUTED=1
    (the CLIs' ``--distributed``, which the TPU package sets in the
    environment). Returns True iff a group was joined.
    ``device_type``: where the ranks run ("cuda": a card for each rank on
    this host, ``local_world``; "cpu")."""
    coordinator_address = coordinator_address or os.environ.get("GPTQ_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = _int_env("GPTQ_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = _int_env("GPTQ_TPU_PROCESS_ID")
    if coordinator_address is None:
        if not auto and os.environ.get("GPTQ_TPU_DISTRIBUTED") != "1":
            return False
        init, world, rank = "env://", None, None
    else:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    backend = backend or backend_for(device_type,
                                     local_world(world or _int_env("WORLD_SIZE") or 1))
    kw = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init, **kw)
    _log_backend(backend)
    return True


def _log_backend(backend: str) -> None:
    if dist.get_rank() == 0:
        print(f"torch.distributed: {dist.get_world_size()} ranks over {backend}",
              file=sys.stderr, flush=True)


def process_count() -> int:
    """The ranks of the group this process joined (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def put_global(x, mesh, spec):
    """This rank's slice of ``x``, a full host copy every rank holds, on the
    mesh's device. ``spec``: per dimension None (replicated), "tp" or "dp"
    (split evenly over that axis of the mesh), as a PartitionSpec names
    them."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        parts, index = (mesh.tp, mesh.tp_rank) if axis == "tp" else (mesh.dp, mesh.dp_rank)
        if t.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over "
                             f"{axis}={parts}")
        t = t.narrow(dim, index * (t.shape[dim] // parts), t.shape[dim] // parts)
    return t.to(mesh.device).contiguous()


def _worker(rank: int, fn, world: int, init_file: str, backend: str, out_dir: str,
            threads: Optional[int], args) -> None:
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    _log_backend(backend)
    try:
        out = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # the other ranks then fail in their next collective; this is the cause
        traceback.print_exc()
        print(f"rank {rank} of {world} failed (above)", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), backend: str = "gloo",
          threads: Optional[int] = None) -> list:
    """``fn(*args)`` in ``world`` new processes, ranks 0..world-1 of one
    process group over ``backend`` (a ``file://`` rendezvous in a new
    temporary directory, so that concurrent groups never share a port). ``fn`` must be importable by name in a new interpreter. Returns
    what each rank's ``fn`` returned, by rank; a rank that raises fails the
    whole call. ``threads``: torch's CPU threads per rank."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="gptq_ranks_") as d:
        mp.spawn(_worker, args=(fn, world, os.path.join(d, "rendezvous"), backend, d, threads,
                                tuple(args)), nprocs=world, join=True)
        out = []
        for rank in range(world):
            with open(os.path.join(d, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
