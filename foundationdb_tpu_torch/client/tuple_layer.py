"""Tuple layer: order-preserving tuple <-> key encoding
(bindings/python/fdb/tuple.py semantics; the cross-binding data vocabulary).

pack(t) produces byte keys whose lexicographic order equals the natural
order of the tuples — the property every FDB layer builds on.  Supported
types (the reference core set): None, bytes, unicode str, int (arbitrary
size), and nested tuples.  `Subspace` scopes keys under a packed prefix
(bindings/python/fdb/subspace_impl.py).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

_NULL = 0x00
_BYTES = 0x01
_STRING = 0x02
_NESTED = 0x05
_INT_ZERO = 0x14  # codes 0x0c..0x1c: ints by byte length, negatives below
_ESCAPE = 0xFF


def _encode_bytes(code: int, b: bytes) -> bytes:
    # 0x00 bytes are escaped as 00 FF so the terminator stays unambiguous
    return bytes([code]) + b.replace(b"\x00", b"\x00\xff") + b"\x00"


def _pack_one(v) -> bytes:
    if v is None:
        return bytes([_NULL])
    if isinstance(v, bool):  # order bools as ints like the reference
        v = int(v)
    if isinstance(v, bytes):
        return _encode_bytes(_BYTES, v)
    if isinstance(v, str):
        return _encode_bytes(_STRING, v.encode("utf-8"))
    if isinstance(v, int):
        if v == 0:
            return bytes([_INT_ZERO])
        if v > 0:
            b = v.to_bytes((v.bit_length() + 7) // 8, "big")
            if len(b) > 8:
                raise ValueError("int too large for tuple encoding (> 8 bytes)")
            return bytes([_INT_ZERO + len(b)]) + b
        n = -v
        size = (n.bit_length() + 7) // 8
        if size > 8:
            raise ValueError("int too small for tuple encoding (> 8 bytes)")
        # offset encoding: maximal value minus |v|, so order is preserved
        b = ((1 << (8 * size)) - 1 - n).to_bytes(size, "big")
        return bytes([_INT_ZERO - size]) + b
    if isinstance(v, tuple):
        out = bytes([_NESTED])
        for item in v:
            if item is None:
                out += b"\x00\xff"  # nested null escape
            else:
                out += _pack_one(item)
        return out + b"\x00"
    raise TypeError(f"tuple layer cannot encode {type(v).__name__}")


def pack(t: tuple) -> bytes:
    return b"".join(_pack_one(v) for v in t)


def _find_terminator(data: bytes, pos: int) -> int:
    while True:
        i = data.index(b"\x00", pos)
        if i + 1 < len(data) and data[i + 1] == _ESCAPE:
            pos = i + 2
            continue
        return i


def _unpack_one(data: bytes, pos: int):
    code = data[pos]
    if code == _NULL:
        return None, pos + 1
    if code in (_BYTES, _STRING):
        end = _find_terminator(data, pos + 1)
        raw = data[pos + 1 : end].replace(b"\x00\xff", b"\x00")
        return (raw if code == _BYTES else raw.decode("utf-8")), end + 1
    if code == _NESTED:
        items = []
        pos += 1
        while data[pos] != 0x00 or (pos + 1 < len(data) and data[pos + 1] == _ESCAPE):
            if data[pos] == 0x00:  # escaped nested null
                items.append(None)
                pos += 2
            else:
                v, pos = _unpack_one(data, pos)
                items.append(v)
        return tuple(items), pos + 1
    if 0x0C <= code <= 0x1C:
        size = code - _INT_ZERO
        if size == 0:
            return 0, pos + 1
        if size > 0:
            raw = data[pos + 1 : pos + 1 + size]
            return int.from_bytes(raw, "big"), pos + 1 + size
        size = -size
        raw = data[pos + 1 : pos + 1 + size]
        return -((1 << (8 * size)) - 1 - int.from_bytes(raw, "big")), pos + 1 + size
    raise ValueError(f"unknown tuple type code 0x{code:02x}")


def unpack(key: bytes) -> tuple:
    out = []
    pos = 0
    while pos < len(key):
        v, pos = _unpack_one(key, pos)
        out.append(v)
    return tuple(out)


def range_of(t: tuple) -> tuple[bytes, bytes]:
    """Key range spanning all tuples extending t (fdb.tuple.range)."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"


class Subspace:
    """Keys scoped under a packed tuple prefix (the Subspace layer)."""

    def __init__(self, prefix_tuple: tuple = (), raw_prefix: bytes = b"") -> None:
        self._prefix = raw_prefix + pack(prefix_tuple)

    @property
    def key(self) -> bytes:
        return self._prefix

    def pack(self, t: tuple = ()) -> bytes:
        return self._prefix + pack(t)

    def unpack(self, key: bytes) -> tuple:
        if not key.startswith(self._prefix):
            raise ValueError("key is not within this Subspace")
        return unpack(key[len(self._prefix):])

    def range(self, t: tuple = ()) -> tuple[bytes, bytes]:
        p = self.pack(t)
        return p + b"\x00", p + b"\xff"

    def subspace(self, t: tuple) -> "Subspace":
        return Subspace((), self.pack(t))

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))
