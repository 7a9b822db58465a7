"""The subset of MessagePack that the checkpoint format uses: maps, arrays,
str, bin and unsigned ints. :func:`pack` gives
the bytes ``msgpack.packb(obj, use_bin_type=True)`` gives for such an
object, as a list of pieces (a large ``bin`` payload is passed through as
its own piece, never copied); :func:`unpack` reads them back, ``bin`` as
``memoryview`` slices of the buffer it was given. The port does not depend
on the ``msgpack`` package; this module lets its checkpoints carry the JAX
package's format without it."""

from __future__ import annotations

import struct

__all__ = ["pack", "unpack"]


def _head(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """A length or value header: the fix form under ``fix_max``, else the
    smallest of ``codes`` ((marker, struct format, limit), ...)."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for marker, fmt, limit in codes:
        if n < limit:
            return bytes((marker,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} out of range")


_UINT = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
         (0xCF, ">Q", 1 << 64))
_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def pack(obj, out: list | None = None) -> list:
    """``obj`` as MessagePack, a list of ``bytes``/buffer pieces to write
    one after another (or join)."""
    out = [] if out is None else out
    if isinstance(obj, bool):
        raise TypeError("msgpack: booleans are not part of the checkpoint format")
    if isinstance(obj, int):
        if obj < 0:
            raise ValueError("msgpack: negative ints are not part of the checkpoint format")
        out.append(bytes((obj,)) if obj < 0x80 else _head(obj, None, 0, _UINT))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += [_head(len(b), 0xA0, 32, _STR), b]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out += [_head(n, None, 0, _BIN), obj]
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, _ARRAY))
        for x in obj:
            pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            pack(k, out)
            pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")
    return out


# the sized forms: type byte -> (length or value format, kind)
_SIZED = {0xCC: (">B", "uint"), 0xCD: (">H", "uint"), 0xCE: (">I", "uint"),
          0xCF: (">Q", "uint"), 0xD9: (">B", "str"), 0xDA: (">H", "str"),
          0xDB: (">I", "str"), 0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
          0xC6: (">I", "bin"), 0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpack(buf) -> object:
    """The object MessagePack ``buf`` holds (the subset :func:`pack`
    writes); ``bin`` values are ``memoryview`` slices of ``buf``."""
    mv = memoryview(buf)
    obj, end = _read(mv, 0)
    if end != len(mv):
        raise ValueError(f"msgpack: {len(mv) - end} trailing bytes")
    return obj


def _read(mv: memoryview, i: int):
    c = mv[i]
    i += 1
    if c < 0x80:
        return c, i
    if 0xA0 <= c <= 0xBF:
        n, kind = c & 0x1F, "str"
    elif 0x90 <= c <= 0x9F:
        n, kind = c & 0x0F, "array"
    elif 0x80 <= c <= 0x8F:
        n, kind = c & 0x0F, "map"
    elif c in _SIZED:
        fmt, kind = _SIZED[c]
        (n,) = struct.unpack_from(fmt, mv, i)
        i += struct.calcsize(fmt)
        if kind == "uint":
            return n, i
    else:
        raise ValueError(f"msgpack: type byte 0x{c:02x} is not part of the checkpoint format")
    if kind in ("str", "bin"):
        if i + n > len(mv):
            raise ValueError("msgpack: truncated payload")
        piece = mv[i:i + n]
        return (str(piece, "utf-8") if kind == "str" else piece), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, i = _read(mv, i)
            out.append(x)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _read(mv, i)
        out[k], i = _read(mv, i)
    return out, i
