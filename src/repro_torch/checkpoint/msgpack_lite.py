"""The subset of MessagePack that a checkpoint's `meta.msgpack` uses: maps,
str, int, float, bool, nil, arrays and bin.

`packb` writes the bytes that `msgpack.packb` (msgpack 1.x defaults:
use_bin_type=True, floats as 64-bit) writes for the same object, and
`unpackb` reads them back as `msgpack.unpackb` does (str keys and values
decoded, arrays as lists, bin as bytes), so the JAX package's checkpoints
and the port's read each other without the msgpack package.
"""
from __future__ import annotations

import struct

_INT_FORMATS = (  # (lo, hi, tag, struct format), in msgpack's order of choice
    (0x80, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
    (0x100, 0xFFFF, 0xCD, ">H"), (-0x8000, -0x81, 0xD1, ">h"),
    (0x10000, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -0x8001, 0xD2, ">i"),
    (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
    (-0x8000000000000000, -0x80000001, 0xD3, ">q"))


def _sized(out, n, fix_tag, fix_max, tags):
    """Header of a str / bin / array / map of length n: the fix form when
    `fix_tag` is set and n <= fix_max, else the 8-, 16- or 32-bit form
    (`tags`, None where the type has no such form)."""
    if fix_tag is not None and n <= fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt, hi in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF,
                                                        0xFFFFFFFF)):
        if tag is not None and n <= hi:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if -32 <= obj < 128:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
            return
        for lo, hi, tag, fmt in _INT_FORMATS:
            if lo <= obj <= hi:
                out.append(tag)
                out += struct.pack(fmt, obj)
                return
        raise OverflowError(f"int {obj} does not fit in 64 bits")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _sized(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack an object of type {type(obj)}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        tag = self.num(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.obj() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.take(tag & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        for _lo, _hi, t, fmt in _INT_FORMATS:
            if tag == t:
                return self.num(fmt)
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B",
                   0xC5: ">H", 0xC6: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I"}
        if tag == 0xCB:
            return self.num(">d")
        if tag == 0xCA:
            return self.num(">f")
        if tag not in lengths:
            raise ValueError(f"msgpack type 0x{tag:02x} is outside the "
                             "subset a checkpoint uses")
        n = self.num(lengths[tag])
        if tag in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if tag in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if tag in (0xDC, 0xDD):
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack map key {k!r} is not str or bytes")
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack object")
    return out
