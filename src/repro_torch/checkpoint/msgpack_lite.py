"""The msgpack subset the checkpoint store uses, in plain Python.

Maps, arrays, str, bin, int, float, bool and nil, encoded exactly as
``msgpack.packb(obj, use_bin_type=True)`` encodes them (smallest integer
and length forms, str8 for short strings, floats as float64) and decoded as
``msgpack.unpackb(data, raw=False)`` decodes them. The port keeps this
codec because the machines it runs on need not have the ``msgpack``
package; checkpoints stay byte-compatible with the JAX package's.
"""
from __future__ import annotations

import struct
from typing import Any, List


class MsgpackError(ValueError):
    """Malformed or truncated msgpack data."""


def _int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0xFF < x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < -0x80:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _length(out: List[bytes], n: int, fix: int, fix_max: int,
            codes: tuple) -> None:
    """A container/str/bin header: fix form below ``fix_max`` (when the type
    has one), then the 8-, 16- and 32-bit forms given by ``codes``."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"length {n} exceeds msgpack's 32 bits")


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _length(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = memoryview(obj).cast("B")
        _length(out, b.nbytes, None, -1, (0xC4, 0xC5, 0xC6))
        out.append(b)
    elif isinstance(obj, dict):
        _length(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _length(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def pack_parts(obj: Any) -> List[bytes]:
    """The encoding as a list of byte strings (array payloads are not copied)."""
    out: List[bytes] = []
    _pack(out, obj)
    return out


def packb(obj: Any) -> bytes:
    return b"".join(pack_parts(obj))


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                 0xCA: ">f", 0xCB: ">d"}
        if b in sized:
            return self.unpack(sized[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B",
                   0xC5: ">H", 0xC6: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I"}
        if b not in lengths:
            raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.unpack(lengths[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(n)
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if b in (0xDC, 0xDD):
            return self._array(n)
        return self._map(n)

    def _str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"invalid utf-8 in msgpack str: {e}") from e

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data) -> Any:
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise MsgpackError("extra bytes after the msgpack object")
    return obj
