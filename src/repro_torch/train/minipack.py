"""A minimal MessagePack codec for checkpoint manifests.

The reference writes ``manifest.msgpack`` with ``msgpack.packb`` (default
options) and reads it with ``msgpack.unpackb``. The port must read and
write the same bytes without that package, so this module carries the
part of the format a manifest uses: map, array (lists and tuples), str,
int, float (always float64), bool and nil, each in its shortest form as
``msgpack.packb`` chooses it.
"""
from __future__ import annotations

import struct


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < lim:
                return bytes([tag]) + struct.pack(fmt, x)
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if x >= -lim:
                return bytes([tag]) + struct.pack(fmt, x)
    raise OverflowError(f"int {x} does not fit in 64 bits")


def _head(n: int, fix: int, fix_max: int, tags: tuple) -> bytes:
    if n < fix_max:
        return bytes([fix | n])
    for tag, fmt, lim in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < lim:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large")


def packb(obj) -> bytes:
    out = bytearray()

    def put(o):
        if o is None:
            out.append(0xC0)
        elif o is True or o is False:
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            out.extend(_int(o))
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            out.extend(_head(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
            out.extend(b)
        elif isinstance(o, (list, tuple)):
            out.extend(_head(len(o), 0x90, 16, (None, 0xDC, 0xDD)))
            for v in o:
                put(v)
        elif isinstance(o, dict):
            out.extend(_head(len(o), 0x80, 16, (None, 0xDE, 0xDF)))
            for k, v in o.items():
                put(k)
                put(v)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")

    put(obj)
    return bytes(out)


def unpackb(data: bytes):
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated msgpack data")
        b = data[pos : pos + n]
        pos += n
        return b

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def get():
        t = take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return {get(): get() for _ in range(t & 0x0F)}
        if 0x90 <= t <= 0x9F:
            return [get() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return take(t & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        nums = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
        if t in nums:
            return num(nums[t])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in lens:
            return take(num(lens[t])).decode("utf-8")
        if t in (0xDC, 0xDD):
            return [get() for _ in range(num(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return {get(): get() for _ in range(num(">H" if t == 0xDE else ">I"))}
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    obj = get()
    if pos != len(data):
        raise ValueError("extra data after the msgpack object")
    return obj
