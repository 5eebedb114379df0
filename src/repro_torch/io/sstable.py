"""On-disk SSTable files: columnar sections + per-block CRC32C + CKB.

The byte-level layout is specified in ``docs/FORMAT.md``; files written
here are byte-identical to the JAX package's. Files are immutable:
writers emit ``<path>.tmp`` and atomically rename, readers only ever see
complete files. Section reads are lazy and individually checksummed — a
reader that fetches only the CKB never touches (or validates) value bytes,
which is what makes incremental REMIX rebuilds cheap (Snippet 1).

Two read modes (``SSTableReader(mode=...)``):

- ``"copy"`` (default): each checksum granule is read into a heap
  ``bytes`` object, verified, and cached;
- ``"mmap"``: the file is mapped once; a granule is CRC-verified on first
  touch and after that served as a zero-copy ``memoryview`` slice of the
  mapping — the block cache then holds views, not copies, and a contiguous
  multi-block :meth:`SSTableReader.read_range` costs no join.
"""
from __future__ import annotations

import mmap
import os
import struct

import numpy as np

from repro_torch.io.checksum import crc32c
from repro_torch.io.ckb import decode_ckb, encode_ckb
from repro_torch.io.faults import NULL_IO, CorruptionError
from repro_torch.obs import tracing as _tracing

MAGIC = b"RMIXSST1"
FOOTER_MAGIC = b"RMIXFTR1"
VERSION = 2
FLAG_CKB = 1
FLAG_EXP = 2  # file carries a per-row TTL expiry section

DEFAULT_BLOCK = 1 << 16  # 64 KB checksum granule

# magic, ver, kw, vw, flags, n, blk, n_rtombs
_HEADER = struct.Struct("<8sHHHHQII8x")
# 7 section offsets, ckb_len, nblk, blk
_FOOTER_FIXED = struct.Struct("<8QII")
_FOOTER_TAIL = struct.Struct("<II8s")  # footer_crc, footer_len, magic

SECTIONS = ("keys", "vals", "seq", "tomb", "exp", "rtombs", "ckb")

_RTOMB = struct.Struct("<3Q")  # lo, hi (exclusive), seq


def write_sstable(
    path: str,
    keys: np.ndarray,
    vals: np.ndarray,
    seq: np.ndarray,
    tomb: np.ndarray,
    exp: np.ndarray | None = None,
    rtombs=None,
    with_ckb: bool = True,
    block_bytes: int = DEFAULT_BLOCK,
    io=None,
) -> int:
    """Write one table file atomically; returns bytes written.

    ``keys``: (N, KW) uint32 sorted ascending (word 0 most significant);
    ``vals``: (N, VW) uint32; ``seq``: (N,) uint32; ``tomb``: (N,) bool;
    ``exp``: optional (N,) uint32 absolute TTL expiries (all-zero or None
    omits the section and clears FLAG_EXP); ``rtombs``: optional iterable
    of ``(lo, hi, seq)`` range tombstones born from the same flush as this
    table's rows (the manifest's excised spans stay authoritative — the
    section is a colocated, crash-independent record of the deletes).
    """
    keys = np.ascontiguousarray(np.asarray(keys, np.uint32))
    vals = np.ascontiguousarray(np.asarray(vals, np.uint32))
    seq = np.ascontiguousarray(np.asarray(seq, np.uint32))
    tomb = np.ascontiguousarray(np.asarray(tomb, bool))
    n, kw = keys.shape
    vw = vals.shape[1]
    sections = [
        keys.astype("<u4").tobytes(),
        vals.astype("<u4").tobytes(),
        seq.astype("<u4").tobytes(),
        tomb.astype(np.uint8).tobytes(),
    ]
    flags = 0
    if exp is not None and np.any(np.asarray(exp)):
        exp = np.ascontiguousarray(np.asarray(exp, np.uint32))
        sections.append(exp.astype("<u4").tobytes())
        flags |= FLAG_EXP
    else:
        sections.append(b"")
    rt = [(int(lo), int(hi), int(s)) for lo, hi, s in (rtombs or ())]
    sections.append(b"".join(_RTOMB.pack(*r) for r in rt))
    if with_ckb:
        sections.append(encode_ckb(keys))
        flags |= FLAG_CKB
    else:
        sections.append(b"")
    offs = []
    pos = _HEADER.size
    for s in sections:
        offs.append(pos)
        pos += len(s)
    data = b"".join(sections)
    crcs = [
        crc32c(data[i : i + block_bytes])
        for i in range(0, max(1, len(data)), block_bytes)
    ]
    footer = _FOOTER_FIXED.pack(
        *offs, len(sections[6]), len(crcs), block_bytes
    ) + np.asarray(crcs, "<u4").tobytes()
    footer += _FOOTER_TAIL.pack(
        crc32c(footer), len(footer) + _FOOTER_TAIL.size, FOOTER_MAGIC
    )
    header = _HEADER.pack(
        MAGIC, VERSION, kw, vw, flags, n, block_bytes, len(rt)
    )
    io = io or NULL_IO
    payload = io.mutate_write(path, header + data + footer)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        io.check_fsync(path)
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return _HEADER.size + len(data) + len(footer)


class SSTableReader:
    """Lazy, checksum-verifying reader for one table file.

    All data-region access goes through :meth:`read_block`, one checksum
    granule (default 64 KB) at a time: a granule is read from disk, CRC-
    verified, and (when a :class:`repro_torch.io.blockcache.BlockCache` is
    attached) cached, so repeated queries touching the same blocks pay no
    further I/O or verification. Tracks per-section logical ``bytes_read``
    plus physical ``disk_bytes_read`` (cache hits don't count) so
    benchmarks can prove which parts of the file a code path touched.
    """

    def __init__(self, path: str, cache=None, mode: str = "copy", io=None):
        if mode not in ("copy", "mmap"):
            raise ValueError(f"mode must be 'copy' or 'mmap', got {mode!r}")
        self.path = path
        self.mode = mode
        self._cache = cache
        self._io = io or NULL_IO
        self._mm: mmap.mmap | None = None
        self._verified: set[int] | None = set() if mode == "mmap" else None
        self.bytes_read: dict[str, int] = {s: 0 for s in SECTIONS}
        self.disk_bytes_read = 0
        # cache-key namespace: path alone is not a safe identity (Storage
        # ids restart at 1+max(surviving files), so a name can be reused
        # after the highest-id tables are deleted) — bind the inode and
        # mtime captured at open so a reused name can't hit stale blocks
        st = os.stat(path)
        self._cache_key = (path, st.st_ino, st.st_mtime_ns)
        self._io.run("open", self._open_meta)
        if mode == "mmap":
            with open(path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)

    def _open_meta(self) -> None:
        """Read + verify header and footer (retried on transient faults)."""
        path, io = self.path, self._io
        with open(path, "rb") as f:
            io.check_read(path)
            hdr = io.mutate_read(path, 0, f.read(_HEADER.size))
            try:
                (magic, ver, self.kw, self.vw, self.flags, self.n,
                 self.block_bytes, self.n_rtombs) = _HEADER.unpack(hdr)
            except struct.error:
                raise CorruptionError(path, "header", detail="truncated")
            if magic != MAGIC or ver != VERSION:
                raise CorruptionError(
                    path, "header",
                    detail=f"not an SSTable (v{VERSION}) file",
                )
            try:
                f.seek(-_FOOTER_TAIL.size, os.SEEK_END)
                end = f.tell()
                fcrc, flen, fmagic = _FOOTER_TAIL.unpack(
                    io.mutate_read(path, end, f.read(_FOOTER_TAIL.size))
                )
            except (OSError, struct.error):
                raise CorruptionError(path, "footer", detail="truncated")
            if fmagic != FOOTER_MAGIC:
                raise CorruptionError(path, "footer", detail="bad magic")
            f.seek(end + _FOOTER_TAIL.size - flen)
            body = io.mutate_read(
                path, end + _FOOTER_TAIL.size - flen,
                f.read(flen - _FOOTER_TAIL.size),
            )
            if crc32c(body) != fcrc:
                raise CorruptionError(path, "footer")
            try:
                fixed = _FOOTER_FIXED.unpack_from(body, 0)
                self._offs = dict(zip(SECTIONS, fixed[:7]))
                self._ckb_len = fixed[7]
                n_blocks, bb = fixed[8], fixed[9]
                self._crcs = np.frombuffer(
                    body, "<u4", count=n_blocks, offset=_FOOTER_FIXED.size
                )
            except (struct.error, ValueError):
                raise CorruptionError(path, "footer", detail="truncated")
            self._data_start = _HEADER.size
            self._data_end = self._offs["ckb"] + self._ckb_len
            self.block_bytes = bb

    @property
    def has_ckb(self) -> bool:
        return bool(self.flags & FLAG_CKB)

    @property
    def has_exp(self) -> bool:
        """Whether the file carries per-row TTL expiries (any nonzero)."""
        return bool(self.flags & FLAG_EXP)

    @property
    def n_blocks(self) -> int:
        """Number of checksum granules covering the data region."""
        return len(self._crcs)

    def data_bytes(self) -> int:
        """Size of the data region (all sections, without header/footer)."""
        return self._data_end - self._data_start

    def attach_cache(self, cache) -> None:
        """Share a :class:`BlockCache`; subsequent block reads go via it."""
        self._cache = cache

    def attach_io(self, io) -> None:
        """Route reads through an :class:`repro_torch.io.faults.IOContext`
        (fault injection + bounded transient-error retry)."""
        self._io = io or NULL_IO

    def block_section(self, idx: int) -> str:
        """Logical section containing granule ``idx``'s first byte —
        the ``section`` coordinate of a :class:`CorruptionError`."""
        off = self._data_start + idx * self.block_bytes
        best = SECTIONS[0]
        for name in SECTIONS:
            if self._offs[name] <= off:
                best = name
        return best

    def _section_range(self, name: str) -> tuple[int, int]:
        lens = dict(
            keys=self.n * self.kw * 4,
            vals=self.n * self.vw * 4,
            seq=self.n * 4,
            tomb=self.n,
            exp=self.n * 4 if self.has_exp else 0,
            rtombs=self.n_rtombs * _RTOMB.size,
            ckb=self._ckb_len,
        )
        off = self._offs[name]
        return off, off + lens[name]

    def section_block0(self, name: str) -> int:
        """Granule index of the first block overlapping section ``name``."""
        lo, _ = self._section_range(name)
        return (lo - self._data_start) // self.block_bytes

    def _load_block(self, idx: int, f) -> bytes:
        """Read granule ``idx`` from ``f`` and verify its CRC32C.

        Transient faults are retried (bounded by the attached
        :class:`IOContext`); a CRC mismatch raises a typed
        :class:`CorruptionError` pinned to this file/section/granule —
        corruption is never retried and never cached.
        """
        tr = _tracing.current()
        t0 = _tracing.now() if tr is not None else 0.0
        c0 = _tracing.cpu_now() if tr is not None else 0.0
        bb = self.block_bytes
        lo = self._data_start + idx * bb
        hi = min(lo + bb, self._data_end)
        io = self._io

        def attempt() -> bytes:
            io.check_read(self.path)
            f.seek(lo)
            return io.mutate_read(self.path, lo, f.read(hi - lo))

        chunk = io.run("block", attempt)
        if crc32c(chunk) != int(self._crcs[idx]):
            raise CorruptionError(self.path, self.block_section(idx), idx)
        self.disk_bytes_read += hi - lo
        if tr is not None:
            tr.leaf("disk_read", t0, c0=c0, bytes=hi - lo, block=idx)
        return chunk

    def _mmap_block(self, idx: int) -> memoryview:
        """Granule ``idx`` as a zero-copy view of the mapping.

        The CRC is checked (and ``disk_bytes_read`` charged — the page
        faults happen here) only on the reader's *first* touch of the
        granule; afterwards the same pages are re-served without another
        pass, even if the block cache evicted the view in between.
        """
        bb = self.block_bytes
        lo = self._data_start + idx * bb
        hi = min(lo + bb, self._data_end)
        view = memoryview(self._mm)[lo:hi]
        if idx not in self._verified:
            tr = _tracing.current()
            t0 = _tracing.now() if tr is not None else 0.0
            c0 = _tracing.cpu_now() if tr is not None else 0.0
            io = self._io
            io.run("mmap", lambda: io.check_read(self.path))
            # verify against the (possibly fault-mutated) bytes: the CRC
            # pass must see what the injected disk would have served
            probe = (
                io.mutate_read(self.path, lo, bytes(view))
                if io.has_read_mutations(self.path) else view
            )
            if crc32c(probe) != int(self._crcs[idx]):
                raise CorruptionError(self.path, self.block_section(idx), idx)
            self._verified.add(idx)
            self.disk_bytes_read += hi - lo
            if tr is not None:
                tr.leaf("disk_read", t0, c0=c0, bytes=hi - lo, block=idx,
                        mmap=True)
        return view

    def _block_loader(self, idx: int):
        """Miss-path loader for granule ``idx`` in the current mode."""
        if self.mode == "mmap":
            return lambda: self._mmap_block(idx)

        def load() -> bytes:
            with open(self.path, "rb") as f:
                return self._load_block(idx, f)

        return load

    def read_block(self, idx: int) -> bytes:
        """One verified checksum granule of the data region (cached)."""
        if not 0 <= idx < len(self._crcs):
            raise IndexError(f"block {idx} out of range [0, {len(self._crcs)})")
        if self._cache is None:
            return self._block_loader(idx)()
        # open-coded get_or_load: the hit path (by far the common case on
        # batched reads) must not pay a loader-closure allocation
        data = self._cache.get((self._cache_key, idx))
        if data is None:
            data = self._block_loader(idx)()
            self._cache.put((self._cache_key, idx), data)
        return data

    def section_rows_resident(self, name: str, lo: int, hi: int) -> bool:
        """Whether rows [lo, hi) of ``name`` can be served without any
        disk read or checksum pass: every covering granule is in the
        block cache (or, in mmap mode, already verified — re-slicing the
        mapping is free). Pure probe: no counters move."""
        if self._cache is None and self.mode != "mmap":
            return False
        for bi in self.section_row_blocks(name, lo, hi):
            if self.mode == "mmap" and bi in self._verified:
                continue
            if self._cache is not None and self._cache.contains(
                (self._cache_key, bi)
            ):
                continue
            return False
        return True

    def prefetch_block(self, idx: int) -> None:
        """Pull granule ``idx`` into the shared cache ahead of demand.

        The pipelining primitive behind cold-scan value-block prefetch:
        a no-op without a cache (nothing would retain the block) or when
        the block is already resident. Loads issued here are tagged by
        the cache so ``stats()['cache']`` can report hit/waste counts.
        """
        if self._cache is None or not 0 <= idx < len(self._crcs):
            return
        self._cache.prefetch((self._cache_key, idx), self._block_loader(idx))

    def read_range(self, lo: int, hi: int) -> bytes:
        """Bytes [lo, hi) of the file (data region), block-granular+verified.

        Opens the file at most once per call: a whole-section read costs
        one open + one sequential read per uncached granule, not one
        open/close cycle per 64 KB.
        """
        if hi <= lo:
            return b""
        bb = self.block_bytes
        b0 = (lo - self._data_start) // bb
        b1 = (hi - self._data_start - 1) // bb
        if self.mode == "mmap":
            # verify (and cache) covering granules, then hand out one
            # contiguous zero-copy view — no per-block join even when the
            # range straddles granule boundaries
            for bi in range(b0, b1 + 1):
                if self._cache is None:
                    self._mmap_block(bi)
                elif self._cache.get((self._cache_key, bi)) is None:
                    self._cache.put((self._cache_key, bi),
                                    self._mmap_block(bi))
            return memoryview(self._mm)[lo:hi]
        parts = []
        f = None
        try:
            for bi in range(b0, b1 + 1):
                chunk = (
                    self._cache.get((self._cache_key, bi))
                    if self._cache is not None
                    else None
                )
                if chunk is None:
                    if f is None:
                        f = open(self.path, "rb")
                    chunk = self._load_block(bi, f)
                    if self._cache is not None:
                        self._cache.put((self._cache_key, bi), chunk)
                parts.append(chunk)
        finally:
            if f is not None:
                f.close()
        buf = parts[0] if len(parts) == 1 else b"".join(parts)
        base = self._data_start + b0 * bb
        return buf[lo - base : hi - base]

    def read_section_bytes(self, name: str, lo: int, hi: int) -> bytes:
        """Bytes [lo, hi) *relative to section ``name``* (partial read)."""
        slo, shi = self._section_range(name)
        lo, hi = slo + lo, min(slo + hi, shi)
        buf = self.read_range(lo, hi)
        self.bytes_read[name] += max(0, hi - lo)
        return buf

    def _read_checked(self, name: str) -> bytes:
        """Read one section, verifying the CRC blocks that cover it."""
        lo, hi = self._section_range(name)
        buf = self.read_range(lo, hi)
        self.bytes_read[name] += hi - lo
        return buf

    def read_keys(self) -> np.ndarray:
        """(N, KW) uint32 from the keys section."""
        raw = self._read_checked("keys")
        return np.frombuffer(raw, "<u4").astype(np.uint32).reshape(
            self.n, self.kw
        )

    def read_vals(self) -> np.ndarray:
        raw = self._read_checked("vals")
        return np.frombuffer(raw, "<u4").astype(np.uint32).reshape(
            self.n, self.vw
        )

    def read_seq(self) -> np.ndarray:
        return np.frombuffer(self._read_checked("seq"), "<u4").astype(
            np.uint32
        )

    def read_tomb(self) -> np.ndarray:
        return np.frombuffer(self._read_checked("tomb"), np.uint8).astype(bool)

    def read_exp(self) -> np.ndarray:
        """(N,) uint32 absolute TTL expiries (zeros when FLAG_EXP clear)."""
        if not self.has_exp:
            return np.zeros(self.n, np.uint32)
        return np.frombuffer(self._read_checked("exp"), "<u4").astype(
            np.uint32
        )

    def read_rtombs(self) -> list[tuple[int, int, int]]:
        """Range tombstones ``(lo, hi, seq)`` recorded with this table."""
        raw = self._read_checked("rtombs")
        return [
            _RTOMB.unpack_from(raw, i * _RTOMB.size)
            for i in range(self.n_rtombs)
        ]

    def read_ckb_keys(self) -> np.ndarray | None:
        """Decode the CKB trailer to (N, KW) uint32, or None if absent."""
        if not self.has_ckb:
            return None
        return decode_ckb(self._read_checked("ckb"))

    def row_bytes(self, name: str) -> int:
        """Fixed row width (bytes) of a columnar section."""
        return dict(
            keys=self.kw * 4, vals=self.vw * 4, seq=4, tomb=1, exp=4
        )[name]

    def section_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of a columnar section, via block-granular reads.

        Only the checksum granules overlapping the requested rows are
        fetched (and, with a cache attached, retained) — the partial-load
        primitive behind cold-start queries. Returns the typed array:
        ``keys`` (M, KW) uint32, ``vals`` (M, VW) uint32, ``seq`` (M,)
        uint32, ``tomb`` (M,) bool.
        """
        lo, hi = max(0, lo), min(hi, self.n)
        rb = self.row_bytes(name)
        raw = self.read_section_bytes(name, lo * rb, hi * rb)
        return self._typed_rows(
            name, np.frombuffer(raw, np.uint8).reshape(-1, rb)
        )

    def _typed_rows(self, name: str, out: np.ndarray) -> np.ndarray:
        """(M, row_bytes) uint8 → the section's typed row array.

        Dtype reinterpretation only — no copy (the result may be a
        read-only view of a cached block buffer; row readers never
        mutate in place).
        """
        if name == "keys":
            return out.view("<u4").reshape(-1, self.kw)
        if name == "vals":
            return out.view("<u4").reshape(-1, self.vw)
        if name in ("seq", "exp"):
            return out.view("<u4").ravel()
        return out.ravel().astype(bool)

    def section_row_blocks(self, name: str, lo: int, hi: int) -> range:
        """Granule indices covering rows [lo, hi) of section ``name``.

        The prefetch planning primitive: a cold-scan pipeline maps the
        next group's row ranges to block ids here and issues
        :meth:`prefetch_block` for each, without reading anything yet.
        """
        lo, hi = max(0, lo), min(hi, self.n)
        if hi <= lo:
            return range(0)
        rb = self.row_bytes(name)
        slo, _ = self._section_range(name)
        bb = self.block_bytes
        b0 = (slo + lo * rb - self._data_start) // bb
        b1 = (slo + hi * rb - 1 - self._data_start) // bb
        return range(b0, b1 + 1)

    def section_rows_scattered(self, name: str, rows) -> np.ndarray:
        """Arbitrary rows of a columnar section, one block fetch per
        touched granule.

        The batched-read primitive: ``rows`` (M,) int — any order,
        duplicates allowed — are mapped to checksum granules, the set of
        distinct granules is fetched exactly once each (through the
        cache), and the rows are scattered out of the block buffers with
        a vectorized gather. Returns the typed array in ``rows`` order,
        like :meth:`section_rows`.
        """
        rows = np.asarray(rows, np.int64)
        rb = self.row_bytes(name)
        if rows.size == 0:
            return self._typed_rows(name, np.zeros((0, rb), np.uint8))
        if rows.min() < 0 or rows.max() >= self.n:
            raise IndexError(f"rows out of range [0, {self.n})")
        slo, _ = self._section_range(name)
        bb = self.block_bytes
        starts = slo + rows * rb - self._data_start  # data-region offsets
        b0 = starts // bb
        b1 = (starts + rb - 1) // bb
        bufs = {
            int(bi): np.frombuffer(self.read_block(int(bi)), np.uint8)
            for bi in np.unique(np.concatenate([b0, b1]))
        }
        out = np.empty((len(rows), rb), np.uint8)
        within = b0 == b1
        for bi in np.unique(b0[within]):
            m = within & (b0 == bi)
            off = starts[m] - int(bi) * bb
            out[m] = bufs[int(bi)][off[:, None] + np.arange(rb)]
        for i in np.flatnonzero(~within):  # granule-straddling rows
            head = bufs[int(b0[i])][int(starts[i] - b0[i] * bb):]
            out[i, : len(head)] = head
            out[i, len(head):] = bufs[int(b1[i])][: rb - len(head)]
        self.bytes_read[name] += len(rows) * rb
        return self._typed_rows(name, out)

    def verify(self) -> None:
        """Validate every block checksum (full-file scrub)."""
        for name in SECTIONS:
            self._read_checked(name)

    def check_blocks(self, on_block=None) -> list[int]:
        """CRC-verify every checksum granule straight off the disk.

        The scrub primitive: bypasses the block cache entirely (a scrub
        must re-read the at-rest bytes, and must not evict the serving
        working set), charges no read counters, and *collects* failures
        instead of raising — returns the list of granule indices whose
        CRC did not match. ``on_block(nbytes)`` is invoked after each
        granule so the caller can rate-limit by byte budget.
        """
        bad: list[int] = []
        io = self._io
        bb = self.block_bytes
        with open(self.path, "rb") as f:
            for idx in range(len(self._crcs)):
                lo = self._data_start + idx * bb
                hi = min(lo + bb, self._data_end)

                def attempt() -> bytes:
                    io.check_read(self.path)
                    f.seek(lo)
                    return io.mutate_read(self.path, lo, f.read(hi - lo))

                chunk = io.run("scrub", attempt)
                if crc32c(chunk) != int(self._crcs[idx]):
                    bad.append(idx)
                if on_block is not None:
                    on_block(hi - lo)
        return bad
