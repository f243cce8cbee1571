"""The safetensors file format, read and written with the standard library
and torch (no ``safetensors`` or ``ml_dtypes`` package).

Layout: an 8-byte little-endian header length N, N bytes of JSON mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(plus an optional ``"__metadata__"`` entry of strings), then the raw
little-endian tensor bytes, offsets relative to the end of the header.

:class:`SafetensorsFile` reads lazily: the header at open, each tensor's
bytes only when asked for, so a loader can hold one tensor of a
multi-gigabyte shard at a time. bf16 comes straight from the bytes as
``torch.bfloat16`` (numpy has no bf16). :func:`save_file` pads the header
with spaces to a multiple of 8 bytes, as the reference writer does, so
every tensor starts 8-byte aligned.
"""
from __future__ import annotations

import json
import struct
import sys
from typing import Dict, List

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16,
    "I64": torch.int64, "I32": torch.int32}
_NAMES = {v: k for k, v in DTYPES.items()}
METADATA = "__metadata__"

if sys.byteorder != "little":          # the format stores little-endian
    raise ImportError("the safetensors reader needs a little-endian host")


class SafetensorsFile:
    """One ``.safetensors`` file opened for lazy reads::

        with SafetensorsFile(path) as f:
            for name in f.keys():
                t = f.get_tensor(name)      # a CPU tensor of its own
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            head = self._f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path!r}: not a safetensors file "
                                 "(shorter than its 8-byte header length)")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(self._f.read(n))
        except BaseException:
            self._f.close()
            raise
        header.pop(METADATA, None)
        self._entries: Dict[str, dict] = header
        self._base = 8 + n

    def keys(self) -> List[str]:
        return list(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        """Tensor ``name`` as a CPU tensor owning a copy of its bytes."""
        entry = self._entries[name]
        if entry["dtype"] not in DTYPES:
            raise ValueError(f"{self.path!r}: tensor {name!r} has dtype "
                             f"{entry['dtype']!r} (supported: "
                             f"{sorted(DTYPES)})")
        dtype = DTYPES[entry["dtype"]]
        shape = tuple(int(s) for s in entry["shape"])
        begin, end = (int(x) for x in entry["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{self.path!r}: tensor {name!r} spans "
                             f"{end - begin} bytes, its shape {shape} of "
                             f"{entry['dtype']} needs "
                             f"{numel * dtype.itemsize}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        # a fresh buffer: the file offset need not be aligned for dtype
        buf = bytearray(end - begin)
        self._f.seek(self._base + begin)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path!r}: tensor {name!r} runs past the "
                             "end of the file")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, as CPU tensors."""
    with SafetensorsFile(path) as f:
        return {name: f.get_tensor(name) for name in f.keys()}


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, any strides) to ``path`` in name
    order."""
    header: Dict[str, object] = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not "
                             f"storable (supported: {sorted(DTYPES)})")
        t = t.detach().to("cpu").contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)
