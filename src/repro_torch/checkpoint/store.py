"""Tree (de)serialization: msgpack + zstd (zlib fallback), atomic writes.

The file format of the JAX package's ``checkpoint/store.py``, so that a
checkpoint written by either package restores in the other: a header
(``SWCK\\x01\\x00`` and a big-endian crc32 of the compressed payload), then a
zstd frame where ``zstandard`` is importable or a zlib stream otherwise,
holding one msgpack map. Arrays are ``{"__arr__": True, "dtype", "shape",
"data"}`` with raw little-endian bytes (bf16 as its uint16 bits), tuples are
``{"__tuple__": [...]}``.

The port differs from the reference where the machines it runs on differ:
msgpack goes through its own small codec (``msgpack_lite``), bf16 is decoded
from its uint16 bits straight into a torch bf16 tensor (no ``ml_dtypes``),
and a zlib payload is compressed as a stream, array by array, so that a
state of many gigabytes is never joined into one buffer. ``level=0`` stores
the payload uncompressed inside zlib framing (also where ``zstandard`` is
importable): the choice for large f32 states, which barely compress (about
7% at zlib level 3, at some 15 MB/s on one CPU core).
Restored trees hold CPU tensors; the caller moves them to its device.
"""
from __future__ import annotations

import os
import struct
import tempfile
import zlib
from typing import Any, List

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite

try:
    import zstandard as zstd
except ImportError:  # optional dep: fall back to stdlib zlib
    zstd = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# checksummed-container header: magic + u32 crc32(compressed payload)
_MAGIC = b"SWCK\x01\x00"
_HEADER = struct.Struct(">6sI")

_ARR = "__arr__"
_TUPLE = "__tuple__"


class CheckpointCorrupt(RuntimeError):
    """The file's checksum/framing does not match its contents (torn write,
    truncation, bit rot). The caller should fall back to an older step."""


def _array_bytes(node):
    """(dtype name, shape, contiguous little-endian buffer) of a tensor or
    numpy array, without copying a CPU buffer."""
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu().contiguous()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(node)
        dtype = str(a.dtype)
        if dtype == "bfloat16":
            a = a.view(np.uint16)
    return dtype, list(a.shape), memoryview(a.reshape(-1)).cast("B")


def _encode(node):
    if isinstance(node, dict):
        return {str(k): _encode(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_encode(v) for v in node]
    if isinstance(node, tuple):
        return {_TUPLE: [_encode(v) for v in node]}
    if isinstance(node, torch.Tensor) or hasattr(node, "dtype"):
        dtype, shape, data = _array_bytes(node)
        return {_ARR: True, "dtype": dtype, "shape": shape, "data": data}
    if isinstance(node, (int, float, str, bool)) or node is None:
        return node
    raise TypeError(f"cannot serialize {type(node)}")


def _decode(node):
    if isinstance(node, dict):
        if node.get(_ARR):
            dtype, shape = node["dtype"], node["shape"]
            if dtype == "bfloat16":
                a = np.frombuffer(node["data"], np.int16).reshape(shape).copy()
                return torch.from_numpy(a).view(torch.bfloat16)
            a = np.frombuffer(node["data"], np.dtype(dtype)).reshape(shape)
            return torch.from_numpy(a.copy())
        if _TUPLE in node:
            return tuple(_decode(v) for v in node[_TUPLE])
        return {k: _decode(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v) for v in node]
    return node


def _compressed_parts(tree: Any, level: int) -> List[bytes]:
    parts = msgpack_lite.pack_parts(_encode(tree))
    if zstd is not None and level > 0:
        return [zstd.ZstdCompressor(level=level).compress(b"".join(parts))]
    comp = zlib.compressobj(level)
    out = [comp.compress(p) for p in parts]
    out.append(comp.flush())
    return out


def _header(parts: List[bytes]) -> bytes:
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return _HEADER.pack(_MAGIC, crc & 0xFFFFFFFF)


def serialize_pytree(tree: Any, *, level: int = 3) -> bytes:
    """Full checksummed file image (header + compressed msgpack payload)."""
    parts = _compressed_parts(tree, level)
    return _header(parts) + b"".join(parts)


def deserialize_pytree(data: bytes, *, source: str = "<bytes>") -> Any:
    """Inverse of :func:`serialize_pytree`; also reads legacy headerless
    files. Raises :class:`CheckpointCorrupt` on checksum/framing mismatch."""
    if data[:len(_MAGIC)] == _MAGIC:
        if len(data) < _HEADER.size:
            raise CheckpointCorrupt(f"{source}: truncated header")
        _, crc = _HEADER.unpack_from(data)
        comp = memoryview(data)[_HEADER.size:]
        if zlib.crc32(comp) & 0xFFFFFFFF != crc:
            raise CheckpointCorrupt(
                f"{source}: checksum mismatch (torn or corrupt write)")
    else:
        comp = memoryview(data)  # legacy headerless file: no checksum to verify
    try:
        if bytes(comp[:4]) == _ZSTD_MAGIC:
            if zstd is None:
                raise RuntimeError(
                    f"{source} is zstd-compressed but zstandard is not "
                    f"installed")
            payload = zstd.ZstdDecompressor().decompress(comp)
        else:
            payload = zlib.decompress(comp)
        return _decode(msgpack_lite.unpackb(payload))
    except (zlib.error, msgpack_lite.MsgpackError, ValueError, KeyError,
            TypeError) as e:
        # a checksummed file that passed crc cannot land here unless the
        # writer was buggy; legacy files land here when truncated
        raise CheckpointCorrupt(f"{source}: undecodable payload: {e}") from e
    except Exception as e:  # zstd raises its own error type
        if zstd is not None and isinstance(e, zstd.ZstdError):
            raise CheckpointCorrupt(
                f"{source}: undecodable payload: {e}") from e
        raise


def save_pytree(tree: Any, path: str, *, level: int = 3) -> None:
    parts = _compressed_parts(tree, level)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_header(parts))
            for p in parts:
                f.write(p)
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        data = f.read()
    return deserialize_pytree(data, source=path)
