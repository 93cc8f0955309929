"""Hand-over of model parameters in the TPU package's wire format.

``params_from_jax`` takes a parameter tree as the TPU package hands it over,
as numpy: a packed linear as its ``PackedLinear.to_wire()`` dict plus
``"bits"`` (the checkpoint width), a dense linear as ``{"kernel", "bias"}``,
norms and embeddings as arrays, nested in dicts and lists as in
``models/llama.py``. Every packed linear is rebuilt through this package's
own ``PackedLinear.from_wire``, so both packages compute from the same wire
bytes; dense kernels (in, out) become tensors, so both packages quantize the
same weights. ``records_from_jax`` / ``record_to_numpy`` carry per-linear
quantization records across as plain numpy fields. The port never imports
the TPU package.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.quantize import QuantRecord
from .ops.linear import PackedLinear, dense


def params_from_jax(tree, device, dtype=torch.bfloat16):
    """numpy wire tree -> this package's parameters on ``device``."""
    if isinstance(tree, dict):
        if "qweight" in tree:
            return PackedLinear.from_wire(tree["qweight"], tree["qzeros"], tree["scales"],
                                          tree["g_idx"], bits=int(tree["bits"]),
                                          bias=tree.get("bias"), dtype=dtype, device=device)
        if "kernel" in tree:
            bias = tree.get("bias")
            return dense(_tensor(tree["kernel"], device, dtype),
                         None if bias is None else _tensor(bias, device, dtype))
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def records_from_jax(records: dict) -> dict:
    """{name: record} with the TPU package's QuantRecord fields (a NamedTuple
    or a dict of numpy arrays and scalars) -> this package's QuantRecords."""
    out = {}
    for name, rec in records.items():
        d = rec._asdict() if hasattr(rec, "_asdict") else dict(rec)
        out[name] = QuantRecord(np.asarray(d["scale"]), np.asarray(d["zero"]),
                                np.asarray(d["g_idx"]), int(d["wbits"]), int(d["groupsize"]),
                                float(d["error"]), sym=bool(d.get("sym", False)))
    return out


def record_to_numpy(rec: QuantRecord) -> dict:
    """A QuantRecord as {field: numpy array or scalar}."""
    return dict(rec._asdict())
