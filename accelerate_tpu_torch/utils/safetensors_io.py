"""The safetensors file format, read and written without the ``safetensors``
package (the card's machine does not have it).

A file is an 8-byte little-endian header length ``n``, then ``n`` bytes of
JSON, then the tensors' raw bytes. The header maps each tensor's name to its
``dtype``, ``shape`` and ``data_offsets`` (``[begin, end)`` into the bytes
after the header), and may hold a ``__metadata__`` map of strings. The header
is padded with spaces to a multiple of 8 bytes, so every tensor starts
aligned. Little-endian only, as the format is.

This module adds nothing to the format: the JAX package writes the same
files with ``safetensors.numpy.save_file`` and reads them with ``load_file``,
and each package reads the other's.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# The format's dtype names for the dtypes the packages write.
DTYPES = {
    "F32": torch.float32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I64": torch.int64,
    "I32": torch.int32,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {dtype: name for name, dtype in DTYPES.items()}
_NUMPY = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
          np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool}


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor of ``value``: a tensor, or a numpy array of a listed
    dtype (numpy's bfloat16 is the ``ml_dtypes`` extension type, taken by
    its bits)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    if arr.dtype not in _NUMPY:
        raise TypeError(f"dtype {arr.dtype} has no safetensors name here; supported: "
                        f"{sorted(DTYPES)}")
    return torch.from_numpy(np.ascontiguousarray(arr))


def _raw(t: torch.Tensor):
    """The tensor's bytes in memory order, as a numpy uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def save_file(tensors: dict, filename, metadata: dict | None = None) -> None:
    """Write ``tensors`` (name -> tensor or numpy array) to ``filename``:
    the header in the order given, the data of wider dtypes first (as the
    ``safetensors`` package lays it out), so that every tensor starts at a
    multiple of its element size. ``metadata`` values must be strings."""
    header, offset, payload = {}, 0, []
    if metadata is not None:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise ValueError("safetensors metadata must map strings to strings")
        header["__metadata__"] = dict(metadata)
    converted = {name: _as_tensor(value) for name, value in tensors.items()}
    for name, t in converted.items():
        if t.dtype not in NAMES:
            raise TypeError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name here; "
                            f"supported: {sorted(DTYPES)}")
        header[name] = None
    for name, t in sorted(converted.items(), key=lambda kv: -kv[1].element_size()):
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        payload.append(t)
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(filename, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in payload:
            if t.numel():
                f.write(_raw(t))


def read_header(filename) -> dict:
    """The file's JSON header (``__metadata__`` included)."""
    with open(filename, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def load_file(filename) -> dict:
    """Every tensor of ``filename`` as a CPU tensor, by name, in the
    header's order. The tensors share one buffer read from the file."""
    with open(filename, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{filename}: shorter than its size")
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in DTYPES:
            raise TypeError(f"tensor {name!r}: safetensors dtype {entry['dtype']} is not "
                            f"supported here; supported: {sorted(DTYPES)}")
        dtype, shape = DTYPES[entry["dtype"]], tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        if end > len(data) or end < begin:
            raise ValueError(f"tensor {name!r}: data_offsets {entry['data_offsets']} outside "
                             f"the file's {len(data)} data bytes")
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"tensor {name!r}: {end - begin} bytes for shape {shape} of "
                             f"{entry['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=begin)
        if begin % itemsize:  # a writer that did not align the data
            flat = flat.clone()
        out[name] = flat.view(dtype).reshape(shape)
    return out


# The numpy dtype a memory map reads each format dtype as (bf16 as its bits).
_MEMMAP = {"F32": np.float32, "BF16": np.uint16, "F16": np.float16, "I64": np.int64,
           "I32": np.int32, "U8": np.uint8, "BOOL": np.bool_}


def load_file_lazy(filename) -> dict:
    """Every tensor of ``filename`` as a CPU tensor over its own copy-on-write
    memory map of the file: nothing is read until a tensor is used, and a
    slice (one layer of a stacked weight) reads only its own pages. For
    checkpoints larger than the host's memory."""
    header = read_header(filename)
    with open(filename, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    base = 8 + n
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _MEMMAP:
            raise TypeError(f"tensor {name!r}: safetensors dtype {entry['dtype']} is not "
                            f"supported here; supported: {sorted(_MEMMAP)}")
        dtype, shape = DTYPES[entry["dtype"]], tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np.dtype(_MEMMAP[entry["dtype"]]).itemsize:
            raise ValueError(f"tensor {name!r}: {end - begin} bytes for shape {shape} of "
                             f"{entry['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        arr = np.memmap(filename, dtype=_MEMMAP[entry["dtype"]], mode="c", offset=base + begin,
                        shape=shape or (1,))
        out[name] = torch.from_numpy(arr).view(dtype).reshape(shape)
    return out
