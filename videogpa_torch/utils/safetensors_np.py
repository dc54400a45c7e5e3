"""The safetensors file format in numpy alone.

A file is a little-endian u64 header length N, N bytes of JSON mapping each
tensor name to its dtype, shape and [begin, end) byte offsets (and an
optional ``__metadata__`` string map), then the raw little-endian bytes.
``load_file`` also reads BF16 tensors (numpy has no bfloat16), widened to
float32 exactly: each value's 16 bits are the top half of its float32.
Files written here are byte for byte those of ``safetensors.numpy.save_file``:
tensors ordered by dtype rank (largest first, the library's order), then by
name; compact JSON in that order; the header padded with spaces to a
multiple of 8 bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np

# the library's dtype order, largest rank first
_DTYPES = [
    ("U64", np.uint64), ("I64", np.int64), ("F64", np.float64), ("F32", np.float32),
    ("U32", np.uint32), ("I32", np.int32), ("F16", np.float16), ("U16", np.uint16),
    ("I16", np.int16), ("I8", np.int8), ("U8", np.uint8), ("BOOL", np.bool_),
]
_NAME = {np.dtype(t): n for n, t in _DTYPES}
_TYPE = {n: np.dtype(t).newbyteorder("<") for n, t in _DTYPES}
_RANK = {n: i for i, (n, _) in enumerate(_DTYPES)}


def save_file(tensors: Dict[str, np.ndarray], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    arrays = {}
    for name, a in tensors.items():
        a = np.asarray(a)
        if a.dtype.newbyteorder("=") not in _NAME:
            raise TypeError(f"safetensors: unsupported dtype {a.dtype} for {name!r}")
        arrays[name] = a
    order = sorted(arrays, key=lambda n: (_RANK[_NAME[arrays[n].dtype.newbyteorder("=")]], n))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = metadata
    blobs, offset = [], 0
    for name in order:
        a = arrays[name]
        kind = _NAME[a.dtype.newbyteorder("=")]
        blob = np.ascontiguousarray(a, dtype=_TYPE[kind]).tobytes()
        header[name] = {"dtype": kind, "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] == "BF16":
            out[name] = bf16_bits_to_f32(
                np.frombuffer(data[begin:end], dtype="<u2")).reshape(info["shape"])
            continue
        dtype = _TYPE[info["dtype"]]
        out[name] = np.frombuffer(data[begin:end], dtype=dtype).astype(
            dtype.newbyteorder("="), copy=True).reshape(info["shape"])
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (uint16) -> the float32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)
