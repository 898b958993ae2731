"""The MessagePack subset a checkpoint's ``meta.msgpack`` holds.

The reference writes its metadata with the ``msgpack`` package
(``msgpack.packb`` with its defaults).  The port keeps a codec of its own,
so that a checkpoint needs no package beyond numpy: maps with ``str`` keys,
arrays (lists and tuples), ``str``, ``int`` up to 64 bits, ``bool``,
``None`` and ``float`` (as float64).  Every value is written in the
smallest format that holds it, as ``msgpack.packb`` writes it, so the
bytes are the same.
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out) -> None:
    """The header of a str/array/map of ``n`` entries."""
    if n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"length {n} is too large for MessagePack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k)}")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack(">b", v)
    elif 0 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif 0 <= v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x80 <= v:
        out += struct.pack(">Bb", 0xD0, v)
    elif -0x8000 <= v:
        out += struct.pack(">Bh", 0xD1, v)
    elif -0x80000000 <= v:
        out += struct.pack(">Bi", 0xD2, v)
    elif -0x8000000000000000 <= v:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} does not fit in 64 bits")


# code -> (struct format, kind) for the fixed-width scalars
_SCALARS = {0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
            0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
            0xD2: (">i", "int"), 0xD3: (">q", "int"), 0xCA: (">f", "float"),
            0xCB: (">d", "float")}
_LENGTHS = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpackb(data: bytes):
    """The object ``data`` encodes (arrays as lists, str keys)."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the "
                         f"MessagePack object")
    return obj


def _take(buf, pos: int, n: int):
    if pos + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[pos:pos + n], pos + n


def _unpack(buf, pos: int):
    raw, pos = _take(buf, pos, 1)
    code = raw[0]
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        return _str(buf, pos, code & 0x1F)
    if 0x90 <= code <= 0x9F:
        return _array(buf, pos, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _map(buf, pos, code & 0x0F)
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        fmt, _ = _SCALARS[code]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if code in _LENGTHS:
        fmt, kind = _LENGTHS[code]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, raw)[0]
        return {"str": _str, "array": _array, "map": _map}[kind](buf, pos, n)
    raise ValueError(f"MessagePack type 0x{code:02x} is not in the subset "
                     f"a checkpoint uses")


def _str(buf, pos: int, n: int):
    raw, pos = _take(buf, pos, n)
    return bytes(raw).decode("utf-8"), pos


def _array(buf, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        if not isinstance(k, str):
            raise ValueError(f"map key {k!r} is not a str")
        out[k], pos = _unpack(buf, pos)
    return out, pos
