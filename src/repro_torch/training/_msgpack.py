"""The subset of MessagePack that checkpoints use, encoded byte for byte as
``msgpack.packb(obj, use_bin_type=True)`` encodes it and decoded as
``msgpack.unpackb(data, raw=False)`` decodes it: maps with str keys, str,
int, bytes (bin) and lists.  The GPU machine has no ``msgpack`` package, so
the port carries this codec; ``repro.training.checkpoint`` writes and reads
the same bytes with the package."""

from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int], what: str) -> None:
    """A length header: the fix form below ``fix_max`` (where the type has
    one), else the 8-, 16- or 32-bit form (``codes``, None where absent)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"{what} of {n} entries is too long for msgpack")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"the checkpoint codec does not encode {obj!r}")
    if isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj >= 0:
            for code, fmt, bits in ((0xcc, ">BB", 8), (0xcd, ">BH", 16),
                                    (0xce, ">BI", 32), (0xcf, ">BQ", 64)):
                if obj < 1 << bits:
                    out += struct.pack(fmt, code, obj)
                    return
            raise ValueError(f"{obj} does not fit msgpack's uint64")
        else:
            for code, fmt, bits in ((0xd0, ">Bb", 8), (0xd1, ">Bh", 16),
                                    (0xd2, ">Bi", 32), (0xd3, ">Bq", 64)):
                if obj >= -(1 << (bits - 1)):
                    out += struct.pack(fmt, code, obj)
                    return
            raise ValueError(f"{obj} does not fit msgpack's int64")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), "a str")
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, (0xc4, 0xc5, 0xc6), "a bin")
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd), "an array")
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xde, 0xdf), "a map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the checkpoint codec does not encode "
                        f"{type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        code = self.unpack(">B")
        if code < 0x80:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code < 0x90:
            return self.map(code & 0x0f)
        if 0x90 <= code < 0xa0:
            return self.array(code & 0x0f)
        if 0xa0 <= code < 0xc0:
            return str(self.take(code & 0x1f), "utf-8")
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                 0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                 0xdc: ">H", 0xdd: ">I",                  # array
                 0xde: ">H", 0xdf: ">I"}                  # map
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if code in ints:
            return self.unpack(ints[code])
        if code not in sized:
            raise ValueError(f"msgpack type 0x{code:02x} is not in the "
                             "checkpoint codec")
        n = self.unpack(sized[code])
        if code <= 0xc6:
            return bytes(self.take(n))
        if code <= 0xdb:
            return str(self.take(n), "utf-8")
        if code <= 0xdd:
            return self.array(n)
        return self.map(n)

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj
