"""REMIX index (de)serialization (paper §3.4).

One contiguous little-endian payload — anchors | cursors | selectors —
whose byte length equals ``Remix.storage_bytes()`` exactly (asserted on
write): the paper's space accounting is validated against real files. The
payload is a straight concatenation of C-ordered arrays, so loading is a
single read + three ``np.frombuffer`` views (mmap-friendly: no per-element
parsing, no byte swapping on little-endian hosts). Files are
byte-identical to the JAX package's; :func:`load_remix` builds the port's
torch :class:`~repro_torch.core.remix.Remix` on a ``device`` (the card
unless the caller asks for the CPU).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from repro_torch.core.remix import Remix, remix_from_arrays
from repro_torch.device import u32_np
from repro_torch.io.checksum import crc32c
from repro_torch.io.faults import NULL_IO, CorruptionError

MAGIC = b"RMIXIDX1"
VERSION = 1
_HEADER = struct.Struct("<8sHHHHIIIQ")  # magic ver kw r d | g n_slots n_entries | payload_len


def dump_remix(remix: Remix, path: str, io=None) -> int:
    """Serialize ``remix`` atomically to ``path``; returns bytes written."""
    anchors = np.ascontiguousarray(u32_np(remix.anchors))
    cursors = np.ascontiguousarray(remix.cursors.cpu().numpy())
    selectors = np.ascontiguousarray(remix.selectors.cpu().numpy())
    g, kw = anchors.shape
    r = cursors.shape[1]
    payload = (
        anchors.astype("<u4").tobytes()
        + cursors.astype("<i4").tobytes()
        + selectors.tobytes()
    )
    expect = int(remix.storage_bytes())
    if len(payload) != expect:
        raise AssertionError(
            f"serialized REMIX is {len(payload)} B but storage_bytes() "
            f"claims {expect} B — §3.4 accounting drifted from the format"
        )
    header = _HEADER.pack(
        MAGIC, VERSION, kw, r, remix.d, g, selectors.shape[0],
        int(remix.n_entries), len(payload),
    )
    io = io or NULL_IO
    blob = io.mutate_write(
        path, header + payload + struct.pack("<I", crc32c(payload))
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        io.check_fsync(path)
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return _HEADER.size + len(payload) + 4


def load_remix(path: str, io=None, device="cuda") -> Remix:
    """Load a serialized REMIX back into a Remix on ``device``.

    Transient faults are retried per the :class:`IOContext`; a bad magic,
    a truncated file or a payload CRC mismatch raises a typed
    :class:`CorruptionError` with ``section="remix"`` — the scrubber's
    cue to rebuild the file from the tables' CKBs (§3.4 redundancy).
    """
    io = io or NULL_IO

    def attempt():
        with open(path, "rb") as f:
            io.check_read(path)
            raw = io.mutate_read(path, 0, f.read())
        try:
            hdr = _HEADER.unpack_from(raw, 0)
        except struct.error:
            raise CorruptionError(path, "remix", detail="truncated header")
        magic, ver, kw, r, d, g, n_slots, n_entries, plen = hdr
        if magic != MAGIC or ver != VERSION:
            raise CorruptionError(
                path, "remix", detail="not a REMIX index file"
            )
        payload = raw[_HEADER.size:_HEADER.size + plen]
        tail = raw[_HEADER.size + plen:_HEADER.size + plen + 4]
        if len(payload) != plen or len(tail) != 4:
            raise CorruptionError(path, "remix", detail="truncated payload")
        (crc,) = struct.unpack("<I", tail)
        return hdr, payload, crc

    hdr, payload, crc = io.run("remix", attempt)
    magic, ver, kw, r, d, g, n_slots, n_entries, plen = hdr
    if crc32c(payload) != crc:
        raise CorruptionError(path, "remix")
    na, nc = g * kw * 4, g * r * 4
    if plen != na + nc + n_slots:
        raise CorruptionError(
            path, "remix",
            detail=f"payload length {plen} != storage_bytes {na + nc + n_slots}",
        )
    anchors = np.frombuffer(payload, "<u4", count=g * kw).astype(
        np.uint32
    ).reshape(g, kw)
    cursors = np.frombuffer(payload, "<i4", count=g * r, offset=na).astype(
        np.int32
    ).reshape(g, r)
    selectors = np.frombuffer(
        payload, np.uint8, count=n_slots, offset=na + nc
    ).copy()
    return remix_from_arrays(anchors, cursors, selectors, n_entries, d,
                             device=device)


def check_remix(path: str, io=None) -> int:
    """Integrity-check a REMIX file at rest without touching the device.

    Scrub primitive: verifies magic/version, payload CRC, and the §3.4
    accounting invariant (payload length == anchors + cursors + selectors
    == ``storage_bytes()``). Raises :class:`CorruptionError` on any
    mismatch; returns the number of bytes read.
    """
    io = io or NULL_IO

    def attempt() -> bytes:
        with open(path, "rb") as f:
            io.check_read(path)
            return io.mutate_read(path, 0, f.read())

    raw = io.run("remix_scrub", attempt)
    try:
        hdr = _HEADER.unpack_from(raw, 0)
    except struct.error:
        raise CorruptionError(path, "remix", detail="truncated header")
    magic, ver, kw, r, d, g, n_slots, n_entries, plen = hdr
    if magic != MAGIC or ver != VERSION:
        raise CorruptionError(path, "remix", detail="not a REMIX index file")
    payload = raw[_HEADER.size:_HEADER.size + plen]
    tail = raw[_HEADER.size + plen:_HEADER.size + plen + 4]
    if len(payload) != plen or len(tail) != 4:
        raise CorruptionError(path, "remix", detail="truncated payload")
    if crc32c(payload) != struct.unpack("<I", tail)[0]:
        raise CorruptionError(path, "remix")
    if plen != g * kw * 4 + g * r * 4 + n_slots:
        raise CorruptionError(
            path, "remix",
            detail=f"payload length {plen} != storage_bytes "
                   f"{g * kw * 4 + g * r * 4 + n_slots}",
        )
    return len(raw)
