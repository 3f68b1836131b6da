"""Minimal GGUF v3 writer.

Counterpart of mistralrs_tpu/gguf/writer.py: the same bytes for the same
metadata and tensors, per the public GGUF spec, with metadata values limited
to ints, floats, bools, strings and string/float/int arrays. Each tensor's
bytes go to the file as they come, so a model is never held twice in
memory.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from mistralrs_tpu_torch.gguf.reader import GGML_BLOCK_INFO, GGMLType


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v: Any) -> bytes:
    if isinstance(v, bool):
        return struct.pack("<I", 7) + struct.pack("<?", v)
    if isinstance(v, int):
        if v < 0:
            return struct.pack("<I", 5) + struct.pack("<i", v)
        return struct.pack("<I", 4) + struct.pack("<I", v)
    if isinstance(v, float):
        return struct.pack("<I", 6) + struct.pack("<f", v)
    if isinstance(v, str):
        return struct.pack("<I", 8) + _pack_string(v)
    if isinstance(v, np.ndarray):
        if v.dtype == np.float32:
            return struct.pack("<II", 9, 6) + struct.pack("<Q", v.size) + v.tobytes()
        if v.dtype in (np.int32, np.int64):
            v32 = v.astype(np.int32)
            return struct.pack("<II", 9, 5) + struct.pack("<Q", v32.size) + v32.tobytes()
        raise TypeError(f"unsupported array dtype {v.dtype}")
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, str) for x in v):
            return (struct.pack("<II", 9, 8) + struct.pack("<Q", len(v))
                    + b"".join(_pack_string(x) for x in v))
        if all(isinstance(x, float) for x in v):
            return _pack_value(np.asarray(v, np.float32))
        if all(isinstance(x, int) for x in v):
            return _pack_value(np.asarray(v, np.int32))
        raise TypeError("mixed-type metadata arrays unsupported")
    raise TypeError(f"unsupported metadata value {type(v)}")


def write_gguf(path: str, metadata: dict[str, Any],
               tensors: dict[str, tuple[GGMLType, tuple[int, ...], np.ndarray]],
               alignment: int = 32) -> None:
    """tensors: name -> (ggml_type, shape in numpy order, raw uint8 or typed
    array holding the type's blocks)."""
    header = b"GGUF" + struct.pack("<IQQ", 3, len(tensors), len(metadata))
    kv = b"".join(_pack_string(k) + _pack_value(v) for k, v in metadata.items())
    infos = []
    raws = []
    offset = 0
    for name, (gtype, shape, arr) in tensors.items():
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        be, bb = GGML_BLOCK_INFO[GGMLType(int(gtype))]
        expect = int(np.prod(shape)) // be * bb
        if raw.size != expect:
            raise ValueError(f"{name}: {raw.size} bytes, expected {expect} for {shape} "
                             f"{GGMLType(int(gtype)).name}")
        ne = list(reversed(shape))  # ggml fastest-first
        infos.append(_pack_string(name) + struct.pack("<I", len(ne))
                     + struct.pack(f"<{len(ne)}Q", *ne) + struct.pack("<IQ", int(gtype), offset))
        pad = (-raw.size) % alignment
        raws.append((raw, pad))
        offset += raw.size + pad
    body = header + kv + b"".join(infos)
    body += b"\0" * ((-len(body)) % alignment)
    with open(path, "wb") as f:
        f.write(body)
        for raw, pad in raws:
            f.write(memoryview(raw))
            f.write(b"\0" * pad)
