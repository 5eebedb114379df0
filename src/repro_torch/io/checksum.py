"""CRC32C (Castagnoli) — the checksum used by per-block table integrity.

Two implementations, byte-for-byte identical (asserted in
``tests/test_io.py``), no dependency on a native crc32c wheel (the
container has none):

- :func:`crc32c_py` — pure-Python slicing-by-8 over precomputed tables;
  the fallback and the reference for small inputs/tails (~8 bytes per
  loop iteration).
- a **vectorized numpy slicing-by-16** path for large buffers (every
  64 KB cache-granule verification): the per-chunk table contribution
  ``F(chunk)`` is GF(2)-linear, so all chunks are reduced with 16
  whole-array gathers, and the sequential dependency on the running CRC
  — ``crc' = F(chunk) ^ G(crc)`` with ``G`` the linear "advance 16 zero
  bytes" map — is folded in ``log2(n/16)`` vectorized rounds using
  memoized byte-tables of ``G^(2^l)``. No Python-level per-chunk loop
  remains; ~60x faster than the scalar loop on 64 KB granules.

Matches the RFC 3720 reference (crc32c(b"123456789") == 0xE3069283).
"""
from __future__ import annotations

import threading

import numpy as np

_POLY = np.uint32(0x82F63B78)
_W = 16  # vector-path chunk width (slicing-by-16)
_VECTOR_MIN = 1024  # below this the scalar loop wins (setup costs)


def _make_tables(rows: int) -> np.ndarray:
    t = np.zeros((rows, 256), np.uint32)
    row = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        row = np.where(row & 1, (row >> 1) ^ _POLY, row >> 1).astype(np.uint32)
    t[0] = row
    for k in range(1, rows):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    return t


_T = _make_tables(_W)  # row k: CRC contribution of a byte k zero-bytes early
# plain lists: CPython list indexing is ~5x cheaper than numpy scalar
# indexing, and the scalar loop below does 8 lookups per input word
_T0, _T1, _T2, _T3, _T4, _T5, _T6, _T7 = (_T[i].tolist() for i in range(8))


def crc32c_py(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """Pure-Python slicing-by-8 CRC32C (reference / fallback path)."""
    crc = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    mv = memoryview(data).cast("B")
    crc = _tail(mv, 0, len(mv), crc)
    return crc ^ 0xFFFFFFFF


def _tail(mv: memoryview, lo: int, hi: int, crc: int) -> int:
    """Scalar slicing-by-8 over ``mv[lo:hi]`` on the *internal* state."""
    n8 = lo + ((hi - lo) & ~7)
    if n8 > lo:
        for w in np.frombuffer(mv[lo:n8], "<u8").tolist():
            w ^= crc
            crc = (
                _T7[w & 0xFF]
                ^ _T6[(w >> 8) & 0xFF]
                ^ _T5[(w >> 16) & 0xFF]
                ^ _T4[(w >> 24) & 0xFF]
                ^ _T3[(w >> 32) & 0xFF]
                ^ _T2[(w >> 40) & 0xFF]
                ^ _T1[(w >> 48) & 0xFF]
                ^ _T0[(w >> 56) & 0xFF]
            )
    for i in range(n8, hi):
        crc = _T0[(crc ^ mv[i]) & 0xFF] ^ (crc >> 8)
    return crc


# ---- vectorized slicing-by-16 ----
# G advances the 32-bit CRC state across one 16-byte chunk of zeros: the
# state XORs into the chunk's first 4 bytes, which use tables 15..12.
_GPOW: list[tuple[np.ndarray, ...]] = [
    (_T[15], _T[14], _T[13], _T[12])
]
_GPOW_LOCK = threading.Lock()  # guards extension (readers verify blocks
# concurrently with the flush writer under the Version architecture)


def _apply_map(tabs, x):
    """Apply a byte-decomposed 32→32 GF(2)-linear map to uint32 ``x``
    (scalar or array): T[a ^ b] == T[a] ^ T[b], so four gathers supply
    the full map."""
    g0, g1, g2, g3 = tabs
    return (
        g0[x & 0xFF]
        ^ g1[(x >> 8) & 0xFF]
        ^ g2[(x >> 16) & 0xFF]
        ^ g3[(x >> 24) & 0xFF]
    )


def _gpow(level: int):
    """Byte-tables of ``G^(2^level)`` (memoized; each level is the
    previous one composed with itself — linearity again). Extension is
    locked: entries are immutable and only ever appended, so lock-free
    reads of already-built levels stay safe."""
    if len(_GPOW) <= level:
        with _GPOW_LOCK:
            while len(_GPOW) <= level:
                prev = _GPOW[-1]
                _GPOW.append(tuple(_apply_map(prev, t) for t in prev))
    return _GPOW[level]


def _crc_chunks16(mv: memoryview, crc: int) -> int:
    """Advance the internal CRC state over ``mv`` (len % 16 == 0, > 0).

    ``state_m = G^m(state_0) ^ XOR_i G^(m-1-i)(F(chunk_i))``: the F
    terms come from 16 vectorized table gathers over the whole buffer,
    the XOR-fold is a binary tree — at each level the left half of every
    pair advances past the right half's chunks via ``G^(2^l)`` — and the
    initial state is advanced by ``G^m`` using the same memoized tables.
    """
    b = np.frombuffer(mv, np.uint8).reshape(-1, _W)
    f = _T[15][b[:, 0]]
    for j in range(1, _W):
        f = f ^ _T[15 - j][b[:, j]]
    m = len(f)
    # fold the per-chunk contributions (front-pad with zero segments:
    # G is linear, so they contribute nothing)
    cap = 1 << (m - 1).bit_length()
    if cap != m:
        f = np.concatenate([np.zeros(cap - m, np.uint32), f])
    level = 0
    while len(f) > 1:
        f = _apply_map(_gpow(level), f[0::2]) ^ f[1::2]
        level += 1
    # advance the incoming state past all m chunks
    state = np.uint32(crc)
    bit = 0
    while (1 << bit) <= m:
        if m & (1 << bit):
            state = _apply_map(_gpow(bit), state)
        bit += 1
    return int(state ^ f[0])


def crc32c(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """CRC32C of ``data``; pass a previous value in ``crc`` to continue.

    Dispatches large buffers to the vectorized numpy slicing-by-16 path
    and finishes ragged tails (and serves small inputs) with the scalar
    loop — results are identical to :func:`crc32c_py` for every input
    and continuation split.
    """
    mv = memoryview(data).cast("B")
    n = len(mv)
    state = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    n16 = n & ~(_W - 1)
    if n16 >= _VECTOR_MIN:
        state = _crc_chunks16(mv[:n16], state)
        state = _tail(mv, n16, n, state)
    else:
        state = _tail(mv, 0, n, state)
    return state ^ 0xFFFFFFFF
