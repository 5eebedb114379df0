"""Compressed Keys Block: prefix-compressed sorted key stream (Snippet 1).

The JAX package's format, byte for byte; the port encodes the whole
entry stream with array operations instead of a loop over keys.

A CKB re-encodes every key of a table (no values) in sorted order. Keys are
fixed-width ``KW`` uint32-word vectors; each key is serialized big-endian
(word 0 first) so that byte-wise shared prefixes coincide with the
lexicographic word order used everywhere else. Per key the stream stores::

    u8 shared | u8 non_shared | suffix bytes

with ``shared`` forced to 0 at every restart point (default: every 16th
key), followed by a restart-offset array so future work can binary-search
within a block. Decoding is a single sequential pass.

Layout::

    magic 'CKB1' u32 | n u32 | key_bytes u16 | restart_interval u16 |
    entry stream | restarts (u32 each) | n_restarts u32
"""
from __future__ import annotations

import struct
import threading

import numpy as np

from repro_torch.obs import tracing as _tracing

MAGIC = 0x31424B43  # 'CKB1' little-endian
_HDR = struct.Struct("<IIHH")


def _key_bytes_be(keys: np.ndarray) -> np.ndarray:
    """(N, KW) uint32 -> (N, KW*4) uint8, big-endian within each word."""
    keys = np.ascontiguousarray(np.asarray(keys, np.uint32))
    n, kw = keys.shape
    return keys.astype(">u4").view(np.uint8).reshape(n, kw * 4)


def encode_ckb(keys: np.ndarray, restart_interval: int = 16) -> bytes:
    """Encode sorted (N, KW) uint32 keys into a CKB byte string."""
    keys = np.asarray(keys, np.uint32)
    if keys.ndim != 2:
        raise ValueError("CKB keys must be (N, KW) uint32")
    n, kw = keys.shape
    kb = kw * 4
    if kb > 255:
        raise ValueError("CKB supports keys up to 255 bytes")
    raw = _key_bytes_be(keys)
    shared = np.zeros(n, np.int64)
    if n > 1:
        eq = raw[1:] == raw[:-1]
        shared[1:] = np.cumprod(eq, axis=1).sum(axis=1)
    if restart_interval > 0:
        shared[::restart_interval] = 0
    # every entry at once: the row-major order of a masked (N, 2 + kb)
    # array is the entry stream, each row its header then its suffix
    ent = np.empty((n, 2 + kb), np.uint8)
    ent[:, 0] = shared
    ent[:, 1] = kb - shared
    ent[:, 2:] = raw
    keep = np.ones((n, 2 + kb), bool)
    keep[:, 2:] = np.arange(kb)[None, :] >= shared[:, None]
    offs = _HDR.size + np.cumsum(2 + kb - shared) - (2 + kb - shared)
    restarts = offs[::restart_interval] if restart_interval > 0 else offs[:0]
    return b"".join([
        _HDR.pack(MAGIC, n, kb, restart_interval),
        ent[keep].tobytes(),
        restarts.astype("<u4").tobytes(),
        struct.pack("<I", len(restarts)),
    ])


# _PREFIX_MASK[s]: the high s bytes of a u64 key (the prefix an entry
# shares with the key before it)
_PREFIX_MASK = np.array(
    [((1 << 64) - 1) ^ ((1 << (64 - 8 * s)) - 1) for s in range(9)], np.uint64
)


class CKBReader:
    """Restart-point random access into an encoded CKB — no full decode.

    Reads go through a ``fetch(lo, hi) -> bytes`` callback over *CKB-
    relative* byte offsets, so the backing store can be an in-memory
    buffer or a block-granular (cached, checksum-verified) view of the
    CKB section of a table file. Restart points (``shared`` forced to 0
    every ``interval`` keys at encode time) make any key decodable by
    walking at most ``interval - 1`` predecessors:

      - :meth:`key_at` decodes one key by row index;
      - :meth:`seek` lower-bounds a query key within a row range by
        binary-searching the restart keys covering the range, then
        walking one restart interval — the point-lookup primitive that
        replaces full-section decodes on the cold read path;
      - :meth:`narrow_batch` is the batched variant of the restart
        search: restart keys are materialized chunk-wise into a uint64
        array (vectorized extraction — restart entries are
        self-contained, so no sequential walk) and a whole query batch
        is narrowed to one restart interval each with a single
        ``np.searchsorted``.
    """

    RESTART_CHUNK = 512  # restart keys materialized per span fetch

    def __init__(self, length: int, fetch, memo_entries: int | None = None):
        self.length = int(length)
        self._fetch = fetch
        magic, n, kb, interval = _HDR.unpack_from(fetch(0, _HDR.size), 0)
        if magic != MAGIC:
            raise ValueError("bad CKB magic")
        if kb % 4:
            raise ValueError("CKB key size must be a whole number of words")
        if interval <= 0:
            raise ValueError("CKB has no restart points (interval 0)")
        self.n = n
        self.kb = kb
        self.interval = interval
        (self.n_restarts,) = struct.unpack(
            "<I", bytes(fetch(self.length - 4, self.length))
        )
        self._entries_end = self.length - 4 - 4 * self.n_restarts
        self._restarts: np.ndarray | None = None
        # chunk-wise materialized restart keys (only for 8-byte keys):
        # value + validity, filled by _ensure_restart_chunks
        self._rk64: np.ndarray | None = None
        self._rk_valid: np.ndarray | None = None
        # interval-decode memo (8-byte keys): keys of fully decoded
        # restart intervals, so repeated batched seeks over a warm
        # working set pay the entry-stream decode once per interval.
        # Bounded LRU: ``memo_entries`` caps decoded *key* entries held
        # (None = unbounded, e.g. small in-memory CKBs); table handles
        # derive the budget from the block-cache byte budget, so the memo
        # can no longer outgrow the cache it shadows. Held as arrays (the
        # reference keeps an OrderedDict): interval j's keys sit in row
        # ``_iv_slot[j]`` of ``_iv_keys`` (-1: not held), each row stamped
        # with its last use; evicting the smallest stamps is the
        # OrderedDict's pop from the front, and a batch's thousands of
        # intervals cost array ops instead of a Python loop each
        self._iv_keys = np.empty((0, self.interval), np.uint64)
        self._iv_owner = np.empty(0, np.int64)  # interval of each row, -1: free
        self._iv_stamp = np.empty(0, np.int64)
        self._iv_slot: np.ndarray | None = None
        self._iv_rows = 0
        self._iv_clock = 0
        self.memo_entries_budget = (
            None if memo_entries is None else max(int(memo_entries), 1)
        )
        self.memo_evictions = 0
        # guards both memos (restart chunks + decoded intervals): the op
        # layer's async worker pool reads one table from several threads
        self._memo_lock = threading.Lock()

    @classmethod
    def from_bytes(cls, buf: bytes | memoryview,
                   memo_entries: int | None = None) -> "CKBReader":
        mv = memoryview(buf)
        return cls(len(mv), lambda lo, hi: bytes(mv[lo:hi]),
                   memo_entries=memo_entries)

    def memo_stats(self) -> dict:
        """Size/eviction accounting of the interval-decode memo (feeds
        the ``ckb_memo_{entries,bytes,evictions}`` registry gauges)."""
        with self._memo_lock:
            rows = self._iv_rows
            rk = 0 if self._rk64 is None else self._rk64.nbytes
            return dict(
                entries=rows * self.interval,
                bytes=rows * self.interval * 8 + rk,
                evictions=self.memo_evictions,
                budget_entries=self.memo_entries_budget,
            )

    def _restart_offsets(self) -> np.ndarray:
        if self._restarts is None:
            raw = self._fetch(self._entries_end, self.length - 4)
            self._restarts = np.frombuffer(raw, "<u4")
        return self._restarts

    def _entry_span(self, j0: int, j1: int) -> bytes:
        """Raw entry bytes from restart j0 up to restart j1 (exclusive)."""
        offs = self._restart_offsets()
        lo = int(offs[j0])
        hi = int(offs[j1]) if j1 < self.n_restarts else self._entries_end
        return self._fetch(lo, hi)

    def _walk(self, row0: int, raw: bytes, stop_row: int):
        """Decode rows [row0, stop_row) from ``raw`` (row0 on a restart).

        Yields (row, key_bytes); ``key_bytes`` is reused between yields.
        """
        prev = bytearray(self.kb)
        off = 0
        for row in range(row0, min(stop_row, self.n)):
            s, ns = raw[off], raw[off + 1]
            off += 2
            prev[s : s + ns] = raw[off : off + ns]
            off += ns
            yield row, prev

    def key_at(self, row: int) -> np.ndarray:
        """Key at ``row`` as (KW,) uint32 — decodes one restart interval."""
        if not 0 <= row < self.n:
            raise IndexError(f"row {row} out of range [0, {self.n})")
        j = row // self.interval
        raw = self._entry_span(j, j + 1)
        for r, kb in self._walk(j * self.interval, raw, row + 1):
            if r == row:
                return (
                    np.frombuffer(bytes(kb), ">u4").astype(np.uint32)
                )
        raise AssertionError("restart walk ended before target row")

    def _restart_key(self, j: int) -> bytes:
        """Key at restart ``j`` (self-contained: shared == 0 there)."""
        offs = self._restart_offsets()
        lo = int(offs[j])
        raw = self._fetch(lo, lo + 2 + self.kb)
        return bytes(raw[2 : 2 + raw[1]])

    def _ensure_restart_chunks(self, chunks) -> None:
        """Materialize restart keys for the given chunk ids as uint64.

        A chunk's restart entries live contiguously in the entry stream;
        one span fetch (block-granular, cached) plus a vectorized numpy
        gather extracts every restart key of the chunk — no per-key
        Python walk, because restart entries are self-contained
        (``shared == 0``). Requires ``kb == 8``.
        """
        with self._memo_lock:
            if self._rk64 is None:
                self._rk64 = np.zeros(self.n_restarts, np.uint64)
                self._rk_valid = np.zeros(self.n_restarts, bool)
            offs = self._restart_offsets()
            c = self.RESTART_CHUNK
            for ci in chunks:
                a, b = ci * c, min((ci + 1) * c, self.n_restarts)
                if a >= b or self._rk_valid[a]:
                    continue
                lo = int(offs[a])
                hi = int(offs[b - 1]) + 2 + self.kb
                raw = np.frombuffer(
                    self._fetch(lo, hi), np.uint8, count=hi - lo
                )
                rel = (offs[a:b].astype(np.int64) - lo)[:, None]
                kb8 = raw[rel + 2 + np.arange(self.kb)]  # (m, 8) big-endian
                self._rk64[a:b] = kb8.copy().view(">u8").ravel()
                self._rk_valid[a:b] = True

    def narrow_batch(
        self, qs: np.ndarray, los: np.ndarray, his: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Narrow each query's row range to one restart interval.

        ``qs`` (Q,) uint64 queries, ``los``/``his`` their per-query row
        ranges (non-empty, within the run). Returns ``(nlo, nhi)`` such
        that the lower bound of ``qs[i]`` within ``[los[i], his[i])``
        provably lies in ``[nlo[i], nhi[i]]`` — with ``nhi[i]`` itself
        the answer when every key of the narrowed interval is smaller
        than the query. One vectorized rightmost-restart-``<=`` search
        replaces Q binary searches; only the restart chunks the batch
        touches are materialized (and they are memoized across batches).
        """
        ii = self.interval
        ja = los // ii
        jb = np.minimum((his - 1) // ii, self.n_restarts - 1)
        c = self.RESTART_CHUNK
        if int((jb // c - ja // c).max(initial=0)) > 1:
            chunks = range(int(ja.min()) // c, int(jb.max()) // c + 1)
        else:
            chunks = np.unique(np.concatenate([ja // c, jb // c]))
        self._ensure_restart_chunks(chunks)
        # global rightmost decoded restart with key <= q, clipped per
        # query to [ja, jb]: clipping is exact because every restart of
        # [ja, jb] is decoded and restart keys ascend with j
        js = np.flatnonzero(self._rk_valid)
        idx = np.searchsorted(self._rk64[js], qs, side="right") - 1
        cand = js[np.maximum(idx, 0)]
        j = np.clip(cand, ja, jb)
        return np.maximum(los, j * ii), np.minimum(his, (j + 1) * ii)

    def decode_intervals(self, js: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized decode of whole restart intervals from the entry
        stream (requires ``kb == 8``).

        ``js`` are unique restart indices. Returns ``(keys (U, interval)
        uint64, counts (U,))`` — interval ``j``'s rows are
        ``[j*interval, j*interval + counts)`` and positions past
        ``counts`` are undefined. The prefix-compression recurrence is
        sequential *within* an interval but independent *across* them,
        so the loop runs over the ≤ ``interval`` in-interval positions
        while every gather/scatter is vectorized over all U intervals at
        once — the decoder that lets batched seeks resolve keys straight
        from the compressed stream, with no fixed-width keys-section
        reads.
        """
        if self.kb != 8:
            raise ValueError("decode_intervals requires 8-byte keys")
        js = np.asarray(js, np.int64)
        ii = self.interval
        with self._memo_lock:
            all_counts = np.minimum(self.n - js * ii, ii).astype(np.int64)
            if self._iv_slot is None:
                self._iv_slot = np.full(self.n_restarts, -1, np.int64)
            todo = js[self._iv_slot[js] < 0]
            if len(todo):
                tr = _tracing.current()
                t0 = _tracing.now() if tr is not None else 0.0
                c0 = _tracing.cpu_now() if tr is not None else 0.0
                keys, _ = self._decode_intervals_uncached(todo)
                if tr is not None:
                    tr.leaf("ckb_decode", t0, c0=c0,
                            intervals=len(todo), rows=int(len(todo)) * ii)
                self._iv_store(todo, keys)
            slot = self._iv_slot[js]
            out = self._iv_keys[slot]  # a copy: safe to evict below
            # last use in ``js`` order, as the reference's move_to_end
            self._iv_stamp[slot] = self._iv_clock + np.arange(len(js))
            self._iv_clock += len(js)
            budget = self.memo_entries_budget
            if budget is not None:
                excess = self._iv_rows - max(1, budget // ii)
                if excess > 0:
                    held = np.flatnonzero(self._iv_owner >= 0)
                    old = held[np.argsort(self._iv_stamp[held])[:excess]]
                    self._iv_slot[self._iv_owner[old]] = -1
                    self._iv_owner[old] = -1
                    self._iv_rows -= excess
                    self.memo_evictions += excess
            return out, all_counts

    def _iv_store(self, js: np.ndarray, keys: np.ndarray) -> None:
        """Hold intervals ``js``' decoded keys in free memo rows (the row
        arrays double when full)."""
        free = np.flatnonzero(self._iv_owner < 0)
        if len(free) < len(js):
            cap = len(self._iv_owner)
            grow = max(cap, len(js) - len(free))
            self._iv_keys = np.concatenate(
                [self._iv_keys, np.empty((grow, self.interval), np.uint64)])
            self._iv_owner = np.concatenate([self._iv_owner, np.full(grow, -1, np.int64)])
            self._iv_stamp = np.concatenate([self._iv_stamp, np.zeros(grow, np.int64)])
            free = np.concatenate([free, cap + np.arange(grow)])
        rows = free[: len(js)]
        self._iv_keys[rows] = keys
        self._iv_owner[rows] = js
        self._iv_slot[js] = rows
        self._iv_rows += len(js)

    def _decode_intervals_uncached(self, js: np.ndarray
                                   ) -> tuple[np.ndarray, np.ndarray]:
        offs = self._restart_offsets()
        u = len(js)
        ii = self.interval
        counts = np.minimum(self.n - js * ii, ii).astype(np.int64)
        # one span fetch per touched restart *chunk* — the same spans
        # narrow_batch already pulled through the block cache, so this
        # adds joins, not granule reads — then a shared flat byte buffer
        c = self.RESTART_CHUNK
        cj = js // c
        base = np.zeros(u, np.int64)
        chunks: list[np.ndarray] = []
        pos = 0
        for ci in np.unique(cj):
            a = int(ci) * c
            b = min(a + c, self.n_restarts)
            lo = int(offs[a])
            hi = int(offs[b]) if b < self.n_restarts else self._entries_end
            raw = np.frombuffer(
                self._fetch(lo, hi), np.uint8, count=hi - lo
            )
            chunks.append(raw)
            m = cj == ci
            base[m] = pos + (offs[js[m]].astype(np.int64) - lo)
            pos += len(raw)
        pad = 24 - pos % 8  # whole big-endian words, two past the end
        raw = np.concatenate(chunks + [np.zeros(pad, np.uint8)])
        # entry: u8 shared | u8 ns | suffix; kb == 8, so ns == 8 - shared
        # and a key is one big-endian u64. The walk that finds each
        # entry's offset (from the previous entry's shared length) is
        # sequential within an interval, vectorized across intervals
        ptr = np.empty((ii, u), np.int64)
        shared = np.empty((ii, u), np.int64)
        p = base
        for k in range(ii):  # past a count the walk reads clipped junk
            ptr[k] = p
            shared[k] = raw.take(p, mode="clip")
            p = p + 10 - shared[k]
        ptr, shared = ptr.T, shared.T
        # entries past the count write nothing: shared = 8 keeps the key
        shared = np.where(np.arange(ii)[None, :] < counts[:, None],
                          np.minimum(shared, 8), 8)
        last = len(raw) - 16  # past every entry's first byte
        # each entry's suffix, low-aligned: the 8 bytes from its start as
        # a big-endian u64 (from the two aligned words it straddles),
        # shifted right past the next entry's bytes
        words = raw.view(">u8")
        o = np.minimum(ptr + 2, last)
        r = ((o & 7) * 8).astype(np.uint64)
        q = o >> 3
        word = (words[q].astype(np.uint64) << r) | (
            (words[q + 1].astype(np.uint64) >> np.uint64(1)) >> (np.uint64(63) - r))
        suf = np.where(shared < 8, word >> (8 * np.minimum(shared, 7)).astype(np.uint64),
                       np.uint64(0))
        keep = _PREFIX_MASK[shared.T]  # the shared prefix's high bytes
        suf = np.ascontiguousarray(suf.T)
        out = np.empty((ii, u), np.uint64)
        key = np.zeros(u, np.uint64)
        for k in range(ii):
            key = (key & keep[k]) | suf[k]
            out[k] = key
        return np.ascontiguousarray(out.T), counts

    def seek_batch(
        self, qs: np.ndarray, nlo: np.ndarray, nhi: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Resolve a batch of narrowed seeks entirely from the entry
        stream: the vectorized counterpart of :meth:`seek` over ranges
        produced by :meth:`narrow_batch` (each within one restart
        interval).

        Returns ``(rows, keyat, known)``: ``rows[i]`` is the lower bound
        of ``qs[i]`` within ``[nlo[i], nhi[i]]`` (``nhi`` itself when
        every key in range is smaller); ``known[i]`` marks rows whose
        key was decoded (always, except ``rows[i] == nhi[i]``), with the
        key in ``keyat[i]`` — callers verify point hits without touching
        the fixed-width keys section.
        """
        ii = self.interval
        j = np.asarray(nlo, np.int64) // ii
        uj, inv = np.unique(j, return_inverse=True)
        keys, counts = self.decode_intervals(uj)
        krows = keys[inv]  # (Q, interval)
        cnt = counts[inv]
        valid = np.arange(ii)[None, :] < cnt[:, None]
        lt = (krows < np.asarray(qs, np.uint64)[:, None]) & valid
        rows = j * ii + lt.sum(axis=1)
        rows = np.clip(rows, nlo, nhi)
        idx = rows - j * ii
        known = idx < cnt
        keyat = krows[np.arange(len(rows)), np.minimum(idx, ii - 1)]
        keyat = np.where(known, keyat, np.uint64(0))
        return rows, keyat, known

    def seek(self, key: np.ndarray, lo: int = 0, hi: int | None = None) -> int:
        """Lower bound of ``key`` within rows [lo, hi): first row whose key
        is >= ``key``, or ``hi`` when every key in range is smaller.

        Bounded seeks ([lo, hi) from a REMIX group's cursor offsets span at
        most D rows) touch only the restart intervals covering the range,
        keeping block reads O(1) per run instead of O(log n) scattered
        probes across the whole compressed block.
        """
        hi = self.n if hi is None else min(hi, self.n)
        lo = max(0, lo)
        if hi <= lo:
            return hi
        qb = bytes(
            np.asarray(key, np.uint32).astype(">u4").view(np.uint8)
        )
        # rightmost restart in range whose key <= query: start decoding there
        ja = lo // self.interval
        jb = min((hi - 1) // self.interval, self.n_restarts - 1)
        a, b = ja, jb
        while a < b:  # invariant: answer restart in [a, b]
            mid = (a + b + 1) >> 1
            if self._restart_key(mid) <= qb:
                a = mid
            else:
                b = mid - 1
        # the answer is in interval a, or is the head row of interval a+1
        # (whose restart key is known > query): walk at most two intervals
        jend = min(a + 1, jb)
        raw = self._entry_span(a, jend + 1)
        stop = min(hi, (jend + 1) * self.interval)
        for row, kb in self._walk(a * self.interval, raw, stop):
            if row < lo:
                continue
            if bytes(kb) >= qb:
                return row
        return hi


def decode_ckb(buf: bytes | memoryview) -> np.ndarray:
    """Decode a CKB back into (N, KW) uint32 keys (sorted order)."""
    mv = memoryview(buf)
    magic, n, kb, _interval = _HDR.unpack_from(mv, 0)
    if magic != MAGIC:
        raise ValueError("bad CKB magic")
    if kb % 4:
        raise ValueError("CKB key size must be a whole number of words")
    out = np.zeros((n, kb), np.uint8)
    prev = np.zeros(kb, np.uint8)
    off = _HDR.size
    for i in range(n):
        s, ns = mv[off], mv[off + 1]
        off += 2
        prev[s : s + ns] = np.frombuffer(mv[off : off + ns], np.uint8)
        off += ns
        out[i] = prev
    return out.view(">u4").astype(np.uint32).reshape(n, kb // 4)
