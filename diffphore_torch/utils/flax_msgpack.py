"""A msgpack decoder and encoder for the subset that flax's
``serialization.to_bytes`` writes: maps, arrays, str/bin, nil/bool, ints and
floats, and the ext types flax uses for numpy values (code 1 = ndarray,
3 = numpy scalar, each the msgpack of ``(shape, dtype name, raw C-order
bytes)``).

The port reads and writes checkpoints with this and needs no msgpack
package; what :func:`dumps` writes, flax's ``msgpack_restore`` reads.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code: int, payload: bytes) -> Any:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, dtype, buf = loads(payload)
    arr = np.frombuffer(bytes(buf), dtype=np.dtype(dtype)).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    sized = {  # marker -> (length format, kind)
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    }
    if b in sized:
        fmt, kind = sized[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return bytes(r.take(n)).decode("utf-8")
        if kind == "array":
            return [_decode(r) for _ in range(n)]
        if kind == "map":
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(fixext[b])))
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        return r.unpack(scalars[b])
    raise ValueError(f"msgpack: unsupported marker 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def loads(data: bytes) -> Any:
    """Decode one msgpack object; raises on trailing bytes."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return obj


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


def flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    """Yield (path tuple, leaf) over a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _head(n: int, fix: int, fix_max: int, m16: int, m32: int) -> bytes:
    """Length header of a str (no 8-bit form used), array or map."""
    if n <= fix_max:
        return bytes([fix | n])
    if n < 1 << 16:
        return bytes([m16]) + struct.pack(">H", n)
    return bytes([m32]) + struct.pack(">I", n)


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        out += b"\xd3" + struct.pack(">q", int(obj))
    elif isinstance(obj, (float, np.floating)):
        out += b"\xcb" + struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _head(len(raw), 0xA0, 31, 0xDA, 0xDB) + raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out += b"\xc6" + struct.pack(">I", len(obj)) + bytes(obj)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        payload = dumps([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        out += b"\xc9" + struct.pack(">Ib", len(payload), _EXT_NDARRAY) + payload
    elif isinstance(obj, dict):
        out += _head(len(obj), 0x80, 15, 0xDE, 0xDF)
        for k, v in obj.items():
            _encode(str(k), out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        out += _head(len(obj), 0x90, 15, 0xDC, 0xDD)
        for v in obj:
            _encode(v, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    """Encode a tree of dicts (str keys), lists, numpy arrays and scalars."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def dump(obj: Any, path: str) -> None:
    """Write-to-temp and rename, so that the visible file is always whole."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(dumps(obj))
    os.replace(tmp, path)
