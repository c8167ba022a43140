"""The safetensors file format in numpy alone (no ``safetensors`` package).

A file is an 8-byte little-endian header length n, n bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an
optional ``"__metadata__": {str: str}``, then the raw little-endian buffer;
offsets count from the buffer's start. ``SafetensorsFile`` memory-maps a file
and reads one tensor at a time; ``load_file`` reads them all; ``save_file``
writes one. The dtypes are those ``safetensors.numpy`` reads: numpy's own,
and ``BF16`` where numpy knows a ``bfloat16`` dtype (``ml_dtypes``
registers one when it is imported); a tensor of another dtype (the ``F8_*``
types) is listed but refused on read, as there. The header is checked as the ``safetensors`` library checks it:
a bounded length, each tensor's byte count equal to its shape's, the
tensors tiling the buffer without holes or overlaps.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Mapping, Optional

import numpy as np

#: dtypes numpy reads and writes, by their safetensors name
NUMPY_DTYPES: Dict[str, np.dtype] = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "U64": np.dtype("<u8"), "I32": np.dtype("<i4"),
    "U32": np.dtype("<u4"), "I16": np.dtype("<i2"), "U16": np.dtype("<u2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
    "C64": np.dtype("<c8"),
}
#: every dtype a header may name → its size in bytes
DTYPE_BYTES: Dict[str, int] = {
    **{name: dt.itemsize for name, dt in NUMPY_DTYPES.items()},
    "BF16": 2, "F8_E4M3": 1, "F8_E5M2": 1,
}
_NAMES = {dt: name for name, dt in NUMPY_DTYPES.items()}
MAX_HEADER_BYTES = 100_000_000


def _read_header(path: str):
    """(header length n, tensors {name: meta}, metadata or None) of a file,
    checked against its size."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes is too large")
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file's {size}")
        header = json.loads(f.read(n).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None)
    end = 0
    for name, meta in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"]):
        dtype, shape, (begin, stop) = meta["dtype"], meta["shape"], meta["data_offsets"]
        if dtype not in DTYPE_BYTES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {dtype!r}")
        if begin != end or stop < begin:
            raise ValueError(f"{path}: tensor {name!r} at {begin}-{stop} leaves a hole or "
                             f"overlaps (previous end {end})")
        if stop - begin != int(np.prod(shape, dtype=np.int64)) * DTYPE_BYTES[dtype]:
            raise ValueError(f"{path}: tensor {name!r} of {dtype} {shape} spans "
                             f"{stop - begin} bytes")
        end = stop
    if 8 + n + end != size:
        raise ValueError(f"{path}: the tensors cover {end} bytes of a {size - 8 - n}-byte buffer")
    return n, header, metadata


def _numpy_dtype(name: str) -> Optional[np.dtype]:
    if name == "BF16":
        try:
            return np.dtype("bfloat16")  # known to numpy once ml_dtypes is imported
        except TypeError:
            return None
    return NUMPY_DTYPES.get(name)


class SafetensorsFile:
    """One safetensors file, memory-mapped; ``get_tensor`` copies one tensor
    out of the map."""

    def __init__(self, path: str):
        self.path = path
        n, self._tensors, self._metadata = _read_header(path)
        self._base = 8 + n
        self._map = np.memmap(path, dtype=np.uint8, mode="r") if self._tensors else None

    def keys(self) -> List[str]:
        return sorted(self._tensors)

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._metadata

    def get_tensor(self, name: str) -> np.ndarray:
        meta = self._tensors[name]
        dtype = _numpy_dtype(meta["dtype"])
        if dtype is None:
            raise TypeError(f"{self.path}: tensor {name!r} is {meta['dtype']}, which numpy "
                            f"cannot hold")
        begin, stop = meta["data_offsets"]
        raw = self._map[self._base + begin:self._base + stop]
        return np.array(raw.view(dtype).reshape(meta["shape"]), dtype=dtype.newbyteorder("="))

    def close(self) -> None:
        self._map = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a file, as ``safetensors.numpy.load_file``."""
    with SafetensorsFile(path) as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def save_file(tensors: Mapping[str, np.ndarray], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays of the dtypes above) to ``path``; the
    header is padded with spaces to a multiple of 8 bytes."""
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        le = arr.dtype.newbyteorder("<") if arr.dtype.byteorder != "|" else arr.dtype
        if le not in _NAMES:
            raise TypeError(f"tensor {name!r}: dtype {arr.dtype} has no safetensors name "
                            f"numpy can write")
        arr = arr.astype(le, order="C", copy=False)  # keeps 0-d arrays 0-d
        header[name] = {"dtype": _NAMES[le], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.reshape(-1).view(np.uint8).data if arr.size else b"")
