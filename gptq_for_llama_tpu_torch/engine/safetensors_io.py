"""Reader and writer of the safetensors file format, with numpy alone.

The TPU package calls the ``safetensors`` package; the port must not need it.
A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__": {...}}``
(padded with spaces to a multiple of 8 bytes) and the raw little-endian
tensor bytes, offsets counted from the end of the header.

``load_file`` returns numpy arrays; BF16 tensors, which numpy cannot hold,
come back widened to float32 (exact). ``save_file`` takes numpy arrays or
CPU torch tensors; a torch bfloat16 tensor is written as BF16.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_NP_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


def _header(f) -> tuple[dict, int]:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def load_file(path: str) -> dict[str, np.ndarray]:
    """{name: numpy array} of every tensor in a safetensors file."""
    with open(path, "rb") as f:
        header, start = _header(f)
        buf = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = memoryview(buf)[begin:end]   # no copy: each tensor is copied once, below
        shape = tuple(info["shape"])
        dt = info["dtype"]
        if dt == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif dt in _NP_DTYPES:
            out[name] = np.frombuffer(raw, dtype=np.dtype(_NP_DTYPES[dt]).newbyteorder("<")
                                      ).astype(_NP_DTYPES[dt], copy=True).reshape(shape)
        else:
            raise NotImplementedError(f"{path}: tensor {name!r} has dtype {dt}, not supported")
    return out


def _encode(value) -> tuple[str, list[int], bytes]:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", list(t.shape), t.view(torch.int16).numpy().astype("<i2").tobytes()
        value = t.numpy()
    a = np.ascontiguousarray(value)
    if a.dtype not in _DTYPE_NAMES:
        raise NotImplementedError(f"cannot write dtype {a.dtype} to safetensors")
    return _DTYPE_NAMES[a.dtype], list(a.shape), a.astype(a.dtype.newbyteorder("<")).tobytes()


def save_file(tensors: dict, path: str) -> None:
    """Write {name: array or tensor} to ``path`` in name order."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        dt, shape, raw = _encode(tensors[name])
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
