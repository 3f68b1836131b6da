"""GGUF binary reader (mmap, zero-copy raw tensor views).

Counterpart of mistralrs_tpu/gguf/reader.py, numpy-only: one or more GGUF
v2/v3 shards presented as one model, their metadata, and each tensor's raw
bytes as a view into the file's mmap, so a loader packs a tensor at a time
without reading the whole file into memory.

Tensor shape convention: GGUF stores ggml `ne` dims fastest-first; the
shapes here are numpy-style (reversed), so a llama attention weight appears
as (out_features, in_features) with in_features contiguous.
"""

from __future__ import annotations

import dataclasses
import enum
import mmap
import struct
from typing import Any, BinaryIO

import numpy as np


class GGMLType(enum.IntEnum):
    """GGUF tensor types (values as in the GGUF spec)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_elems, block_bytes) per type
GGML_BLOCK_INFO: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q8_1: (32, 36),
    GGMLType.Q2_K: (256, 84),
    GGMLType.Q3_K: (256, 110),
    GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176),
    GGMLType.Q6_K: (256, 210),
    GGMLType.Q8_K: (256, 292),
}

# scalar value types: GGUF type id -> (struct format, size)
_VALUE_READERS = {
    0: ("<B", 1),
    1: ("<b", 1),
    2: ("<H", 2),
    3: ("<h", 2),
    4: ("<I", 4),
    5: ("<i", 4),
    6: ("<f", 4),
    7: ("<?", 1),
    10: ("<Q", 8),
    11: ("<q", 8),
    12: ("<d", 8),
}
_ARRAY_DTYPES = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16, 4: np.uint32, 5: np.int32,
                 6: np.float32, 7: np.bool_, 10: np.uint64, 11: np.int64, 12: np.float64}


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (slowest-first)
    ggml_type: GGMLType
    offset: int  # relative to the data section's start
    file_index: int = 0

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def byte_size(self) -> int:
        be, bb = GGML_BLOCK_INFO[self.ggml_type]
        if self.num_elements % be:
            raise ValueError(f"{self.name}: {self.shape} is not a whole number of "
                             f"{self.ggml_type.name} blocks of {be}")
        return self.num_elements // be * bb


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def read(self, fmt: str, size: int):
        return struct.unpack(fmt, self.f.read(size))[0]

    def read_string(self) -> str:
        n = self.read("<Q", 8)
        return self.f.read(n).decode("utf-8", errors="replace")

    def read_value(self, vtype: int) -> Any:
        if vtype in _VALUE_READERS:
            return self.read(*_VALUE_READERS[vtype])
        if vtype == 8:
            return self.read_string()
        if vtype == 9:  # array
            elem_type = self.read("<I", 4)
            n = self.read("<Q", 8)
            if elem_type in _VALUE_READERS:
                size = _VALUE_READERS[elem_type][1]
                return np.frombuffer(self.f.read(size * n), dtype=_ARRAY_DTYPES[elem_type])
            return [self.read_value(elem_type) for _ in range(n)]
        raise ValueError(f"unknown gguf value type {vtype}")


class GGUFFile:
    """One or more GGUF shards presented as a single model."""

    def __init__(self, paths: str | list[str]):
        if isinstance(paths, str):
            paths = [paths]
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._mmaps: list[mmap.mmap] = []
        self._data_starts: list[int] = []
        for idx, path in enumerate(paths):
            self._read_file(str(path), idx)

    def _read_file(self, path: str, file_index: int) -> None:
        with open(path, "rb") as f:
            r = _Reader(f)
            magic = f.read(4)
            if magic != b"GGUF":
                raise ValueError(f"{path}: not a GGUF file (magic={magic!r})")
            version = r.read("<I", 4)
            if version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF version {version}")
            n_tensors = r.read("<Q", 8)
            n_kv = r.read("<Q", 8)
            for _ in range(n_kv):
                key = r.read_string()
                vtype = r.read("<I", 4)
                self.metadata[key] = r.read_value(vtype)
            infos = []
            for _ in range(n_tensors):
                name = r.read_string()
                n_dims = r.read("<I", 4)
                ne = [r.read("<Q", 8) for _ in range(n_dims)]
                ggml_type = GGMLType(r.read("<I", 4))
                offset = r.read("<Q", 8)
                infos.append(TensorInfo(name, tuple(reversed(ne)), ggml_type, offset, file_index))
            alignment = int(self.metadata.get("general.alignment", 32))
            pos = f.tell()
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._mmaps.append(mm)
        self._data_starts.append((pos + alignment - 1) // alignment * alignment)
        for ti in infos:
            self.tensors[ti.name] = ti

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "unknown")

    def raw_tensor(self, name: str) -> tuple[TensorInfo, np.ndarray]:
        """(info, raw uint8 view): zero-copy into the mmap."""
        ti = self.tensors[name]
        start = self._data_starts[ti.file_index] + ti.offset
        buf = np.frombuffer(self._mmaps[ti.file_index], dtype=np.uint8, count=ti.byte_size,
                            offset=start)
        return ti, buf

    def tensor_f32(self, name: str) -> np.ndarray:
        """Any tensor dequantized to float32 (quant/kquants.dequantize)."""
        from mistralrs_tpu_torch.quant import kquants

        ti, raw = self.raw_tensor(name)
        return kquants.dequantize(raw, ti.ggml_type, ti.shape)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors
