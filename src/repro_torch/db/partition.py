"""Key-range partitions: table files + one REMIX per partition (paper §4).

Tables are host numpy arrays (the "files") or lazy handles onto on-disk
SSTables, whose sections are read — and checksum-verified — on first
access; on the host a table returns exactly the JAX package's arrays.
The partition builds its REMIX + stacked RunSet on the host and keeps them
as torch tensors on its device when first queried (:meth:`Partition.index`,
the plain engine's input) or when a device view uploads it
(:meth:`Partition.device_index`, with or without the value sections). A
persisted REMIX (:meth:`Partition.persist_index`) is adopted back with
:meth:`Partition.preload_index`; the store loads it into host memory, where
the cold read path (``cold_get*``, ``cold_scan*``, the cursor state) walks
it with numpy and block-granular table reads, and the first device build
moves it to the partition's device.

Partitions are *logically immutable* once published in a
:class:`repro_torch.db.version.Version`: compaction derives a successor via
:meth:`Partition.clone_with_tables` (sharing unchanged table handles and
the built REMIX as the incremental-rebuild base) while the old partition
stays servable by pinned readers. The query caches are benign fills
shared across versions: they never change results, only where they are
answered from.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.core.remix import Remix, build_remix
from repro_torch.core.runs import (  # noqa: F401 (Run, as in the reference)
    RowWindow,
    Run,
    RunSet,
    make_run,
    merge_ranges_np,
    ranges_to_rows,
    stack_runs,
)
from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER
from repro_torch.db import clock
from repro_torch.device import as_words, resolve, u32_np

KEY_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _pad_index(remix: Remix, runset: RunSet, d: int) -> tuple[Remix, RunSet]:
    """Pad (G, R, Nmax) to power-of-two buckets on the index's device; query
    semantics unchanged (pad groups are all-placeholder with +inf anchors,
    pad runs are empty)."""
    g2 = _pow2(remix.g, 4)
    r2 = _pow2(remix.r, 1)
    n2 = _pow2(runset.nmax, 64)
    if (g2, r2, n2) == (remix.g, remix.r, runset.nmax):
        return remix, runset
    dev = remix.anchors.device
    i32 = dict(dtype=torch.int32, device=dev)
    anchors = torch.full((g2, runset.kw), CK.INF_WORD, **i32)
    anchors[: remix.g] = remix.anchors
    cursors = torch.zeros((g2, r2), **i32)
    cursors[: remix.g, : remix.r] = remix.cursors
    selectors = torch.full((g2 * d,), PLACEHOLDER, dtype=torch.uint8, device=dev)
    selectors[: remix.n_slots] = remix.selectors
    keys = torch.full((r2, n2, runset.kw), CK.INF_WORD, **i32)
    keys[: runset.r, : runset.nmax] = runset.keys
    vals = torch.zeros((r2, n2, runset.vw), **i32)
    vals[: runset.r, : runset.nmax] = runset.vals
    seq = torch.zeros((r2, n2), **i32)
    seq[: runset.r, : runset.nmax] = runset.seq
    tomb = torch.zeros((r2, n2), dtype=torch.bool, device=dev)
    tomb[: runset.r, : runset.nmax] = runset.tomb
    lens = torch.zeros((r2,), **i32)
    lens[: runset.r] = runset.lens
    return (
        Remix(anchors=anchors, cursors=cursors, selectors=selectors,
              n_entries=remix.n_entries, d=d),
        RunSet(keys=keys, vals=vals, seq=seq, tomb=tomb, lens=lens),
    )


def _to_device(remix: Remix, device: torch.device) -> Remix:
    """``remix`` with its arrays on ``device`` (a REMIX recovered into host
    memory moves to the card on the partition's first device build)."""
    if remix.anchors.device == device:
        return remix
    return dataclasses.replace(
        remix, anchors=remix.anchors.to(device),
        cursors=remix.cursors.to(device), selectors=remix.selectors.to(device),
    )


class Table:
    """One immutable sorted table file.

    Either fully in-memory (``keys``/``vals``/``seq``/``tomb`` arrays) or a
    lazily-loadable handle onto an on-disk SSTable (``path``): column
    sections are fetched — and checksum-verified — on first access.
    ``key_words()`` serves REMIX (re)builds from the table's Compressed
    Keys Block when one exists, so a rebuild never reads value bytes.
    """

    def __init__(
        self,
        keys: np.ndarray | None = None,  # (N,) uint64 ascending, unique
        vals: np.ndarray | None = None,  # (N, VW) uint32
        seq: np.ndarray | None = None,  # (N,) uint32
        tomb: np.ndarray | None = None,  # (N,) bool
        path: str | None = None,
        cache_mode: str = "copy",
        ckb_decode: bool = True,
        exp: np.ndarray | None = None,  # (N,) uint32 TTL expiry (0 = none)
    ):
        if keys is None and path is None:
            raise ValueError("Table needs in-memory arrays or a file path")
        self._keys, self._vals = keys, vals
        self._seq, self._tomb = seq, tomb
        self._exp = exp
        self._ttl_any: bool | None = None
        self.path = path
        self.cache_mode = cache_mode
        # batched seeks decode the prefix-compressed CKB entry stream
        # (vectorized) instead of reading fixed-width key rows
        self.ckb_decode = ckb_decode
        self._reader = None
        self._cache = None
        self._ioctx = None
        self._ckb = None
        self._n: int | None = None if keys is None else len(keys)

    @classmethod
    def from_file(cls, path: str, cache_mode: str = "copy",
                  ckb_decode: bool = True) -> "Table":
        return cls(path=path, cache_mode=cache_mode, ckb_decode=ckb_decode)

    def __repr__(self) -> str:
        # must not force-load a lazy handle: report only what is resident
        if self.resident:
            return f"Table(n={len(self._keys)}, resident=True)"
        n = "?" if self._reader is None else self._reader.n
        return f"Table(path={self.path!r}, n={n}, resident=False)"

    @property
    def resident(self) -> bool:
        """Whether the column arrays are fully loaded in memory."""
        return self._keys is not None

    def attach_cache(self, cache) -> None:
        """Route this handle's block reads through a shared BlockCache."""
        self._cache = cache
        if self._reader is not None:
            self._reader.attach_cache(cache)

    def attach_io(self, ioctx) -> None:
        """Route this handle's reads through an ``IOContext`` (fault
        injection + bounded transient-error retry)."""
        self._ioctx = ioctx
        if self._reader is not None:
            self._reader.attach_io(ioctx)

    def _rd(self):
        if self._reader is None:
            from repro_torch.io.sstable import SSTableReader

            self._reader = SSTableReader(
                self.path, cache=self._cache, mode=self.cache_mode,
                io=self._ioctx,
            )
        return self._reader

    # ---- block-granular access (cold read path) ----
    def read_block(self, section: str, idx: int) -> bytes:
        """``idx``-th checksum granule overlapping ``section`` (cached)."""
        rd = self._rd()
        return rd.read_block(rd.section_block0(section) + idx)

    def rows(self, section: str, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of one columnar section via partial block reads."""
        return self._rd().section_rows(section, lo, hi)

    def rows_resident(self, section: str, lo: int, hi: int) -> bool:
        """Side-effect-free probe: rows [lo, hi) servable without I/O."""
        return self._rd().section_rows_resident(section, lo, hi)

    def ckb(self):
        """Restart-point CKB reader over cached block reads (or None).

        The reader's interval-decode memo is bounded by an entry budget
        tied to the block-cache byte budget (1/64th of it in decoded
        8-byte key entries per reader), so a long-lived handle over a
        huge table can no longer hold more decoded keys than the cache
        it shadows holds raw bytes. Cacheless handles keep a small
        fixed budget.
        """
        if self._ckb is None:
            rd = self._rd()
            if not rd.has_ckb:
                return None
            from repro_torch.io.ckb import CKBReader

            cap = getattr(self._cache, "capacity_bytes", None)
            budget = (cap // 64) if cap else (1 << 20)
            self._ckb = CKBReader(
                rd._ckb_len,
                lambda lo, hi: rd.read_section_bytes("ckb", lo, hi),
                memo_entries=budget,
            )
        return self._ckb

    def key_at(self, row: int) -> np.ndarray:
        """(KW,) uint32 key words at ``row`` without loading the section."""
        ckb = self.ckb()
        if ckb is not None:
            return ckb.key_at(row)
        return self.rows("keys", row, row + 1)[0]

    def seek_row(self, key_words: np.ndarray, lo: int, hi: int) -> int:
        """Lower bound of ``key_words`` within rows [lo, hi).

        Prefers the CKB restart-point binary search; tables without a CKB
        fall back to probing key rows (still block-granular).
        """
        ckb = self.ckb()
        if ckb is not None:
            return ckb.seek(key_words, lo, hi)
        q = CK.unpack_u64(np.asarray(key_words, np.uint32)[None, :])[0]
        while lo < hi:
            mid = (lo + hi) // 2
            kmid = CK.unpack_u64(self.rows("keys", mid, mid + 1))[0]
            if kmid < q:
                lo = mid + 1
            else:
                hi = mid
        return lo

    # ---- batched access (cold batch query path) ----
    def rows_scattered(self, section: str, rows) -> np.ndarray:
        """Arbitrary rows of one section; each touched granule fetched
        once (see ``SSTableReader.section_rows_scattered``)."""
        return self._rd().section_rows_scattered(section, rows)

    def keys_u64_rows(self, rows) -> np.ndarray:
        """(M,) uint64 keys at the given rows, via scattered block reads."""
        return CK.unpack_u64(self.rows_scattered("keys", rows))

    def prefetch_rows(self, section: str, lo: int, hi: int) -> None:
        """Issue cache loads for the granules covering rows [lo, hi)."""
        self.prefetch_blocks(self.row_block_ids(section, lo, hi))

    def row_block_ids(self, section: str, lo: int, hi: int):
        """Granule ids covering rows [lo, hi) of one section (no I/O).
        Ids are file-absolute, so adjacent sections sharing a boundary
        granule report the same id — callers dedupe across sections."""
        return self._rd().section_row_blocks(section, lo, hi)

    def prefetch_blocks(self, ids) -> None:
        """Issue cache loads for an explicit granule id set."""
        rd = self._rd()
        for bi in ids:
            rd.prefetch_block(bi)

    def seek_rows_batch(self, qs: np.ndarray, los, his,
                        return_keys: bool = False):
        """Lower bounds of ``qs`` (Q,) u64 within per-query row ranges.

        The batched counterpart of :meth:`seek_row`, same results, no
        per-query binary search: the CKB's restart keys narrow every
        query to one restart interval in a single vectorized pass
        (:meth:`repro_torch.io.ckb.CKBReader.narrow_batch`), then the narrowed
        intervals are resolved — by default straight from the
        prefix-compressed entry stream (the vectorized
        :meth:`repro_torch.io.ckb.CKBReader.seek_batch` decoder: zero
        keys-section bytes), or, with ``ckb_decode`` off / no usable
        CKB, by fetching the narrowed fixed-width key rows with ranges
        merged across the whole batch and one ``np.searchsorted``.
        Clipping the candidate row into each query's narrowed range is
        exact because keys ascend with row number.

        With ``return_keys`` the result is ``(rows, keyat, known)``:
        where ``known[i]``, ``keyat[i]`` is the key at ``rows[i]`` —
        point lookups verify hits with zero extra key fetches on the
        decoder path (the fallback path reports nothing as known).

        The entry-stream decoder only runs when the caller wants the
        keys (``return_keys``): there the decode replaces *two* keys-
        section reads (seek + hit verification). Seek-only callers
        (the scan paths, which must read the keys section anyway to
        emit rows) keep the cheaper narrow + scattered-fetch resolve.
        """
        qs = np.asarray(qs, np.uint64)
        los = np.maximum(np.asarray(los, np.int64), 0)
        his = np.minimum(np.asarray(his, np.int64), self.n)
        out = his.copy()
        keyat = np.zeros(len(qs), np.uint64)
        known = np.zeros(len(qs), bool)
        act = his > los
        if not act.any():
            return (out, keyat, known) if return_keys else out
        ckb = self.ckb()
        if (ckb is not None and ckb.kb == 8 and self.ckb_decode
                and return_keys):
            nlo, nhi = ckb.narrow_batch(qs[act], los[act], his[act])
            rows, ka, kn = ckb.seek_batch(qs[act], nlo, nhi)
            out[act] = rows
            keyat[act] = ka
            known[act] = kn
            return (out, keyat, known) if return_keys else out
        nlo, nhi = los.copy(), his.copy()
        if ckb is not None and ckb.kb == 8:
            nlo[act], nhi[act] = ckb.narrow_batch(qs[act], los[act], his[act])
        mlo, mhi = merge_ranges_np(nlo[act], nhi[act])
        rows_cat = ranges_to_rows(mlo, mhi)
        keys_cat = self.keys_u64_rows(rows_cat)  # one scattered fetch
        idx = np.searchsorted(keys_cat, qs, side="left")
        hit = idx < len(rows_cat)
        cand = np.where(
            hit, rows_cat[np.minimum(idx, len(rows_cat) - 1)],
            np.iinfo(np.int64).max,
        )
        out = np.where(act, np.clip(cand, nlo, nhi), his)
        return (out, keyat, known) if return_keys else out

    @property
    def keys(self) -> np.ndarray:
        if self._keys is None:
            self._keys = CK.unpack_u64(self._rd().read_keys())
        return self._keys

    @property
    def vals(self) -> np.ndarray:
        if self._vals is None:
            self._vals = self._rd().read_vals()
        return self._vals

    @property
    def seq(self) -> np.ndarray:
        if self._seq is None:
            self._seq = self._rd().read_seq()
        return self._seq

    @property
    def tomb(self) -> np.ndarray:
        if self._tomb is None:
            self._tomb = self._rd().read_tomb()
        return self._tomb

    @property
    def exp(self) -> np.ndarray:
        """(N,) uint32 absolute TTL expiries; zeros when none were set."""
        if self._exp is None:
            if self.path is not None:
                self._exp = self._rd().read_exp()
            else:
                self._exp = np.zeros(self.n, np.uint32)
        return self._exp

    def ttl_present(self) -> bool:
        """Whether any row of this table carries a TTL (cheap: lazy
        handles answer from the file header flag, no section read)."""
        if self._ttl_any is None:
            if self._exp is not None:
                self._ttl_any = bool(np.any(self._exp))
            elif self.path is not None:
                self._ttl_any = bool(self._rd().has_exp)
            else:
                self._ttl_any = False
        return self._ttl_any

    # ---- liveness (tombstone OR expired TTL) ----
    def dead(self, now: float | None = None) -> np.ndarray:
        """(N,) bool: rows hidden from reads — tombstones plus rows whose
        TTL expired as of ``now`` (defaults to ``clock.now()``)."""
        if not self.ttl_present():
            return self.tomb
        if now is None:
            now = clock.now()
        e = self.exp
        return self.tomb | ((e != 0) & (e <= np.uint32(int(now))))

    def dead_rows(self, lo: int, hi: int,
                  now: float | None = None) -> np.ndarray:
        """Rows [lo, hi) of the combined liveness column (cold path):
        tomb | expired, fetching the exp section only when the table
        carries TTLs at all."""
        tomb = self.rows("tomb", lo, hi)
        if not self.ttl_present():
            return tomb
        if now is None:
            now = clock.now()
        e = self.rows("exp", lo, hi)
        return tomb | ((e != 0) & (e <= np.uint32(int(now))))

    def dead_rows_scattered(self, rows,
                            now: float | None = None) -> np.ndarray:
        """Scattered-row counterpart of :meth:`dead_rows`."""
        tomb = self.rows_scattered("tomb", rows)
        if not self.ttl_present():
            return tomb
        if now is None:
            now = clock.now()
        e = self.rows_scattered("exp", rows)
        return tomb | ((e != 0) & (e <= np.uint32(int(now))))

    def min_future_exp(self, now: float) -> int | None:
        """Smallest TTL expiry still in the future, or None: the instant
        a device index built at ``now`` goes stale."""
        if not self.ttl_present():
            return None
        e = self.exp
        fut = e[(e != 0) & (e > np.uint32(int(now)))]
        return int(fut.min()) if fut.size else None

    @property
    def n(self) -> int:
        if self._n is None:  # header-only read; no section is loaded
            self._n = self._rd().n
        return self._n

    @property
    def vw(self) -> int:
        if self._vals is not None:
            return self._vals.shape[1]
        return self._rd().vw

    def key_words(self) -> np.ndarray:
        """(N, KW) uint32 key words for index builds; prefers the CKB."""
        if self._keys is not None:
            return CK.pack_u64(self._keys)
        rd = self._rd()
        if rd.has_ckb:
            return rd.read_ckb_keys()
        return rd.read_keys()

    def bytes(self, key_bytes: int = 8) -> int:
        return self.n * (key_bytes + self.vw * 4 + 5)


@dataclasses.dataclass
class ExcisedSpan:
    """One committed range tombstone: every row with key in [lo, hi) of a
    *covered* table is dead, unconditionally.

    Coverage is by table identity: a span attaches at flush covering
    exactly the tables that existed then (all of whose seqs precede the
    delete's), so no seq comparison is ever needed on the read path —
    newer writes land in tables born later, which the span does not
    cover."""

    lo: int
    hi: int  # exclusive
    seq: int
    tables: tuple

    def __post_init__(self):
        self._ids = frozenset(id(t) for t in self.tables)

    def covers_table(self, t: Table) -> bool:
        return id(t) in self._ids

    def retain(self, tables: list[Table]) -> "ExcisedSpan":
        """The span restricted to the handles surviving in ``tables``."""
        kept = tuple(t for t in tables if id(t) in self._ids)
        return ExcisedSpan(self.lo, self.hi, self.seq, kept)


def _empty_table() -> Table:
    return Table(
        keys=np.zeros(0, np.uint64),
        vals=np.zeros((0, 2), np.uint32),
        seq=np.zeros(0, np.uint32),
        tomb=np.zeros(0, bool),
    )


def excise_rows(t: Table, spans: list[ExcisedSpan]) -> tuple[Table, int]:
    """Copy of ``t`` with rows covered by ``spans`` removed; returns the
    copy (or ``t`` itself when nothing is covered) and the row count
    dropped. Dropping (not tombstoning) is exact: any older version of a
    covered key lives in a table some covering span also covers."""
    cov = None
    for sp in spans:
        if sp.covers_table(t):
            m = (t.keys >= np.uint64(sp.lo)) & (t.keys < np.uint64(sp.hi))
            cov = m if cov is None else (cov | m)
    if cov is None or not cov.any():
        return t, 0
    keep = ~cov
    return (
        Table(keys=t.keys[keep], vals=t.vals[keep], seq=t.seq[keep],
              tomb=t.tomb[keep], exp=t.exp[keep]),
        int(cov.sum()),
    )


def merge_tables(
    tables: list[Table],
    drop_tombs: bool = False,
    excised: list[ExcisedSpan] | None = None,
    now: float | None = None,
    stats: dict | None = None,
) -> Table:
    """Sort-merge tables, newest version per key wins (tiered major merge).

    ``excised`` spans drop covered input rows before the merge (outputs
    are then *not* covered — the caller's clone drops the merged handles
    from every span's coverage set). Rows whose TTL expired as of ``now``
    are GC'd: converted to tombstones (they must keep hiding older
    versions that may survive in unmerged tables) and, with
    ``drop_tombs``, removed outright. ``stats`` (optional dict) receives
    ``rows_excised`` / ``rows_expired`` counts.
    """
    n_exc = 0
    if excised:
        masked = []
        for t in tables:
            t2, dropped = excise_rows(t, excised)
            n_exc += dropped
            masked.append(t2)
        tables = masked
    keys = np.concatenate([t.keys for t in tables])
    vals = np.concatenate([t.vals for t in tables])
    seq = np.concatenate([t.seq for t in tables])
    tomb = np.concatenate([t.tomb for t in tables])
    exp = np.concatenate([t.exp for t in tables])
    neg = np.uint64(0xFFFFFFFFFFFFFFFF) - seq.astype(np.uint64)
    order = np.lexsort([neg, keys])
    keys, vals, seq = keys[order], vals[order], seq[order]
    tomb, exp = tomb[order], exp[order]
    keep = np.ones(len(keys), bool)
    keep[1:] = keys[1:] != keys[:-1]
    keys, vals, seq = keys[keep], vals[keep], seq[keep]
    tomb, exp = tomb[keep], exp[keep]
    if now is None:
        now = clock.now()
    expired = (exp != 0) & (exp <= np.uint32(int(now))) & ~tomb
    n_ttl = int(expired.sum())
    if n_ttl:
        tomb = tomb | expired
        vals = vals.copy()
        vals[expired] = 0
        exp = exp.copy()
        exp[expired] = 0
    if drop_tombs:
        live = ~tomb
        keys, vals, seq = keys[live], vals[live], seq[live]
        tomb, exp = tomb[live], exp[live]
    if stats is not None:
        stats["rows_excised"] = stats.get("rows_excised", 0) + n_exc
        stats["rows_expired"] = stats.get("rows_expired", 0) + n_ttl
    return Table(keys=keys, vals=vals, seq=seq, tomb=tomb, exp=exp)


def chunk_table(t: Table, cap: int) -> list[Table]:
    """Split a merged table into files of at most ``cap`` entries."""
    if t.n == 0:
        return []
    return [
        Table(
            keys=t.keys[i : i + cap],
            vals=t.vals[i : i + cap],
            seq=t.seq[i : i + cap],
            tomb=t.tomb[i : i + cap],
            exp=t.exp[i : i + cap],
        )
        for i in range(0, t.n, cap)
    ]

class Partition:
    def __init__(self, lo: int, tables: list[Table] | None = None, d: int = 32,
                 device="cuda"):
        self.lo = int(lo)  # inclusive lower bound of the key range
        self.tables: list[Table] = tables or []
        self.d = d
        self.device = resolve(device)
        self._remix: Remix | None = None
        self._runset: RunSet | None = None
        self.remix_bytes = 0  # last REMIX build size (for WA accounting)
        # committed range tombstones covering (subsets of) self.tables
        self.excised: list[ExcisedSpan] = []
        # earliest future TTL expiry baked into the built index: past this
        # instant the runset's tomb marks are stale and index() rebuilds
        # them (REMIX structure is unaffected by liveness)
        self._ttl_next: float | None = None
        # last built (unpadded) REMIX + the tables it covered: a rebuild
        # that only appended tables extends it incrementally (§4.2)
        self._built_remix: Remix | None = None
        self._built_tables: list[Table] = []
        self.remix_name: str | None = None  # manifest name when persisted
        self.last_build_kind = "none"  # none | scratch | incremental | reuse
        # cold read path: host-side view of the (preloaded) REMIX + counters
        self._host: dict | None = None
        self.cold_gets = 0
        self.cold_scans = 0
        # workload statistics for the promotion decision: logical row
        # bytes served by cold reads (counted on cache hits too, unlike
        # the physical ``cold_disk_bytes``)
        self.cold_served_rows = 0

    def __repr__(self) -> str:
        # introspection must not force-load lazy table handles
        return (
            f"Partition(lo={self.lo}, tables={len(self.tables)}, "
            f"resident={sum(t.resident for t in self.tables)}, "
            f"built={self.last_build_kind})"
        )

    def clone_with_tables(self, tables: list[Table],
                          carry_built: bool = False) -> "Partition":
        """Copy-on-write successor over a new table list.

        The compaction primitive of the Version architecture: the clone
        shares unchanged :class:`Table` handles (and with ``carry_built``
        the last built REMIX, so a minor compaction that only appended
        tables rebuilds incrementally) while this partition — possibly
        still pinned by older Versions — keeps serving its exact old
        view. Cold-read workload counters carry over so promotion
        decisions survive the version edge.
        """
        p2 = Partition(lo=self.lo, tables=list(tables), d=self.d,
                       device=self.device)
        if carry_built:
            p2._built_remix = self._built_remix
            p2._built_tables = list(self._built_tables)
        # spans follow the surviving covered handles; a span whose whole
        # coverage set was compacted away (its rows dropped in the merge)
        # is garbage-collected here
        p2.excised = [
            s2 for s in self.excised if (s2 := s.retain(tables)).tables
        ]
        p2.cold_gets = self.cold_gets
        p2.cold_scans = self.cold_scans
        p2.cold_served_rows = self.cold_served_rows
        return p2

    def attach_excised(self, lo: int, hi: int, seq: int) -> None:
        """Attach a freshly flushed range tombstone covering every table
        this partition holds *right now* (their rows all predate it)."""
        if self.tables and lo < hi:
            self.excised.append(
                ExcisedSpan(int(lo), int(hi), int(seq), tuple(self.tables))
            )

    def full_spans(self) -> list[tuple[int, int]]:
        """Merged sorted [lo, hi) spans covering *all* current tables —
        the spans a cursor can skip structurally (nothing in the
        partition can be live inside them)."""
        spans = sorted(
            (s.lo, s.hi)
            for s in self.excised
            if all(s.covers_table(t) for t in self.tables)
        )
        out: list[tuple[int, int]] = []
        for lo, hi in spans:
            if out and lo <= out[-1][1]:
                out[-1] = (out[-1][0], max(hi, out[-1][1]))
            else:
                out.append((lo, hi))
        return out

    def _span_dead(self, r: int, keys: np.ndarray) -> np.ndarray:
        """(M,) bool: which of run ``r``'s emitted keys an excised span
        hides (partial-coverage fallback — full coverage is skipped
        structurally upstream)."""
        out = np.zeros(len(keys), bool)
        t = self.tables[r]
        for sp in self.excised:
            if sp.covers_table(t):
                out |= (keys >= np.uint64(sp.lo)) & (keys < np.uint64(sp.hi))
        return out

    def _covered(self, r: int, key: int) -> bool:
        t = self.tables[r]
        return any(
            sp.covers_table(t) and sp.lo <= key < sp.hi
            for sp in self.excised
        )

    def preload_index(self, remix: Remix):
        """Adopt a deserialized REMIX for the current table list (recovery
        path): the next build reuses it instead of rebuilding."""
        self._built_remix = remix
        self._built_tables = list(self.tables)
        self.remix_bytes = int(remix.storage_bytes())

    # ---------------- cold read path (block-granular, no table loads) ----
    def cold_ready(self) -> bool:
        """True when queries can be served straight off the on-disk REMIX
        + block cache, without materializing the device RunSet (the state
        right after ``RemixDB.open``: REMIX deserialized, tables lazy)."""
        return (
            self._remix is None
            and self._built_remix is not None
            and bool(self.tables)
            and len(self._built_tables) == len(self.tables)
            and all(a is b for a, b in zip(self._built_tables, self.tables))
            and all(t.path is not None and not t.resident for t in self.tables)
        )

    def cold_disk_bytes(self) -> int:
        """Physical bytes cold reads have pulled from this partition."""
        return sum(
            t._reader.disk_bytes_read
            for t in self.tables
            if t._reader is not None
        )

    def _row_bytes(self) -> int:
        """Logical bytes per served row (matches ``Table.bytes()``)."""
        vw = self.tables[0].vw if self.tables else 2
        return 8 + 4 * vw + 5

    def promotion_inputs(self, fraction: float = 0.5) -> dict:
        """Observed-workload inputs of the promotion decision.

        Two counters, both compared against the same ``fraction`` of the
        partition's data bytes:

        - ``disk_bytes`` — physical bytes cold reads pulled (cache hits
          excluded): the original pay-as-you-go signal.
        - ``served_bytes`` — logical row bytes cold queries *touched*,
          hits included. Once the block cache absorbs a hot partition's
          working set the disk counter stalls, so a byte-fraction rule
          alone would never promote it no matter how much traffic it
          serves; the served counter keeps observing the workload.
        """
        total = sum(t._rd().data_bytes() for t in self.tables)  # header-only
        disk = self.cold_disk_bytes()
        served = self.cold_served_rows * self._row_bytes()
        threshold = int(fraction * max(1, total))
        return dict(
            lo=self.lo,
            data_bytes=int(total),
            disk_bytes=int(disk),
            served_bytes=int(served),
            cold_gets=int(self.cold_gets),
            cold_scans=int(self.cold_scans),
            threshold_bytes=threshold,
            promote=bool(disk >= threshold or served >= threshold),
        )

    def should_promote(self, fraction: float = 0.5) -> bool:
        """Build the device RunSet once the observed cold workload — the
        physical bytes it pulled *or* the logical bytes it served out of
        the cache — reaches ``fraction`` of the data region (see
        :meth:`promotion_inputs` for the two counters)."""
        return self.promotion_inputs(fraction)["promote"]

    def _host_index(self) -> dict:
        """Host numpy view of the built REMIX (anchors as u64 for search)."""
        rm = self._built_remix
        if self._host is None or self._host["remix"] is not rm:
            self._host = dict(
                remix=rm,
                anch64=CK.unpack_u64(u32_np(rm.anchors)),
                cursors=rm.cursors.cpu().numpy(),
                selectors=rm.selectors.cpu().numpy(),
                d=rm.d,
                n_slots=rm.n_slots,
            )
        return self._host

    def _group_rows(self, hx: dict, g: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-run row ranges [cur, nxt) covered by group ``g``."""
        cur = hx["cursors"][g].astype(np.int64)
        if g + 1 < hx["cursors"].shape[0]:
            nxt = hx["cursors"][g + 1].astype(np.int64)
        else:
            nxt = np.array([t.n for t in self.tables], np.int64)
        return cur, nxt

    def _group_bounds_batch(self, hx: dict, keys: np.ndarray):
        """Vectorized anchors search + cursor gather for a key batch.

        Returns (g (Q,), cur (Q, R), nxt (Q, R)) — the batched analogue
        of one scalar searchsorted + :meth:`_group_rows` per key.
        """
        g = np.maximum(
            np.searchsorted(hx["anch64"], keys, side="right") - 1, 0
        )
        cursors = hx["cursors"]
        gcount = cursors.shape[0]
        ns = np.array([t.n for t in self.tables], np.int64)
        cur = cursors[g].astype(np.int64)
        nxt = np.where(
            (g + 1 < gcount)[:, None],
            cursors[np.minimum(g + 1, gcount - 1)].astype(np.int64),
            ns[None, :],
        )
        return g, cur, nxt

    def _gather_emit(self, er, erow, windows, vw: int):
        """Emit live (key, value) rows for one walked window.

        ``er``/``erow`` are the emitted runs/absolute rows in view order;
        ``windows[r]`` answers run ``r``'s rows (``RowWindow.gather``).
        Shared by the scalar and batched scan paths so both stay
        bit-identical by construction: gather per run, scatter back into
        view order, drop dead rows (tombstones, expired TTLs, and keys an
        excised span hides).
        """
        kk = np.empty(len(er), np.uint64)
        vv = np.empty((len(er), vw), np.uint32)
        dead = np.zeros(len(er), bool)
        for r in np.unique(er):
            m = er == r
            kk[m], vv[m], dead[m] = windows[r].gather(erow[m])
            if self.excised:
                dead[m] |= self._span_dead(r, kk[m])
        live = ~dead
        return kk[live], vv[live]

    def _seek_slot(self, hx: dict, g: int, cur, nextrow) -> int:
        """View position implied by the per-run seek results of group
        ``g`` (with the device-parity placeholder hop)."""
        d, sels, n_slots = hx["d"], hx["selectors"], hx["n_slots"]
        pos = g * d + int(np.sum(nextrow - cur))
        # device-seek parity (_ingroup_vector): landing on a trailing
        # placeholder means every real entry of the group is < start, so
        # the true lower bound is the next group's head — the window must
        # not waste budget on the placeholder tail.
        if pos < min(n_slots, (g + 1) * d) and int(sels[pos]) == PLACEHOLDER:
            pos = (g + 1) * d
        return min(pos, n_slots)

    def _walk_from(self, hx: dict, pos: int, nextrow, width: int):
        """Vectorized selector walk of ``width`` view slots from ``pos``.

        Replaces the slot-by-slot Python loop: the whole window's
        selectors are classified at once and each run's occurrences get
        consecutive rows via one cumulative count per run. Requires
        ``nextrow`` to hold each run's next absolute row at ``pos`` —
        which is exactly what a seek produces and what this walk leaves
        behind, so windows chain without re-seeking (the cursor's
        comparison-free ``next``, §3.3). Mutates ``nextrow`` to the
        post-window pointers. Returns ``(pos, stop, valid, win,
        rows_abs, newest)``: window slot bounds, the per-slot
        non-placeholder mask, raw selector values, absolute rows
        assigned per slot, and the newest-version emission mask.
        """
        sels, n_slots = hx["selectors"], hx["n_slots"]
        stop = min(n_slots, pos + width)
        win = sels[pos:stop].astype(np.int64)
        valid = win != PLACEHOLDER
        rows_abs = np.zeros(len(win), np.int64)
        for r in range(len(self.tables)):
            m = valid & ((win & 0x7F) == r)
            c = int(np.count_nonzero(m))
            if c:
                rows_abs[m] = int(nextrow[r]) + np.arange(c)
                nextrow[r] += c
        newest = valid & ((win & NEWEST_BIT) != 0)
        return pos, stop, valid, win, rows_abs, newest

    def _walk_window(self, hx: dict, g: int, cur, nextrow, width: int):
        """Seek-position + selector walk in one step (scan entry point)."""
        pos = self._seek_slot(hx, g, cur, nextrow)
        return self._walk_from(hx, pos, nextrow, width)

    def cold_get(self, key: int) -> tuple[bool, np.ndarray | None]:
        """Point lookup from the on-disk REMIX without loading any table.

        Anchors binary search on the host, then one *bounded* CKB
        restart-point seek per run — the group's cursor offsets restrict
        each seek to at most D rows, so each run contributes O(1) block
        reads — and finally at most one tomb byte and one value row are
        fetched from the run the selector names (§3.2 adapted to
        block-granular I/O). Returns (found, value row)."""
        hx = self._host_index()
        self.cold_gets += 1
        self.cold_served_rows += 1
        d, sels = hx["d"], hx["selectors"]
        g = max(
            int(np.searchsorted(hx["anch64"], np.uint64(key), side="right"))
            - 1,
            0,
        )
        cur, nxt = self._group_rows(hx, g)
        qw = CK.pack_u64(np.array([key], np.uint64))[0]
        rows = [
            t.seek_row(qw, int(cur[r]), int(nxt[r]))
            for r, t in enumerate(self.tables)
        ]
        s = int(sum(rows[r] - int(cur[r]) for r in range(len(rows))))
        pos = g * d + s
        if s >= d or pos >= hx["n_slots"]:
            return False, None
        sel = int(sels[pos])
        if sel == PLACEHOLDER or not (sel & NEWEST_BIT):
            return False, None
        run = sel & 0x7F
        row = rows[run]
        t = self.tables[run]
        if not np.array_equal(t.key_at(row), qw):
            return False, None
        if self._covered(run, int(key)):
            return False, None
        if bool(t.dead_rows(row, row + 1)[0]):
            return False, None
        return True, t.rows("vals", row, row + 1)[0]

    def cold_get_batch(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized point lookups off the on-disk REMIX.

        The batched counterpart of :meth:`cold_get`, bit-identical per
        key, with the per-key Python work replaced by whole-batch array
        ops: one vectorized anchors binary search, one grouped
        :meth:`Table.seek_rows_batch` per run (restart-narrowed,
        range-merged), a vectorized selector resolve, and finally
        key-check/tombstone/value fetches grouped per run with all
        (file, block) granules deduplicated — each granule a batch
        touches is read exactly once. Returns (found (Q,), vals (Q, VW)).
        """
        keys = np.asarray(keys, np.uint64)
        q = len(keys)
        vw = self.tables[0].vw if self.tables else 2
        found = np.zeros(q, bool)
        vals = np.zeros((q, vw), np.uint32)
        if q == 0 or not self.tables:
            return found, vals
        hx = self._host_index()
        self.cold_gets += q
        self.cold_served_rows += q
        d, sels, n_slots = hx["d"], hx["selectors"], hx["n_slots"]
        nrun = len(self.tables)
        g, cur, nxt = self._group_bounds_batch(hx, keys)
        rows = np.empty((q, nrun), np.int64)
        keyat = np.empty((q, nrun), np.uint64)
        known = np.empty((q, nrun), bool)
        for r, t in enumerate(self.tables):
            rows[:, r], keyat[:, r], known[:, r] = t.seek_rows_batch(
                keys, cur[:, r], nxt[:, r], return_keys=True
            )
        s = (rows - cur).sum(axis=1)
        pos = g * d + s
        ok = (s < d) & (pos < n_slots)
        sel = np.where(
            ok, sels[np.minimum(pos, n_slots - 1)].astype(np.int64),
            PLACEHOLDER,
        )
        ok &= (sel != PLACEHOLDER) & ((sel & NEWEST_BIT) != 0)
        run = np.where(ok, sel & 0x7F, 0)
        row = rows[np.arange(q), np.minimum(run, nrun - 1)]
        for r in np.unique(run[ok]):
            t = self.tables[r]
            m = ok & (run == r)
            rr = row[m]
            # hit verification: keys the CKB decoder already resolved
            # cost nothing; only unresolved rows (decoder off / no CKB)
            # fall back to a fixed-width keys-section fetch
            kn = known[m, r]
            match = np.empty(len(rr), bool)
            match[kn] = keyat[m, r][kn] == keys[m][kn]
            if (~kn).any():
                match[~kn] = t.keys_u64_rows(rr[~kn]) == keys[m][~kn]
            qi = np.flatnonzero(m)[match]
            rv = rr[match]
            if not len(qi):
                continue
            live = ~t.dead_rows_scattered(rv)
            if self.excised:
                live &= ~self._span_dead(r, keys[qi])
            found[qi] = live
            if live.any():
                vals[qi[live]] = t.rows_scattered("vals", rv[live])
        return found, vals

    def cold_scan(self, start: int, width: int, prefetch_depth: int = 0):
        """Range scan over a ``width``-slot view window without whole-table
        loads: seek as in :meth:`cold_get`, walk the selector stream
        (comparison-free next, §3.3) to find the touched per-run row
        ranges, then materialize only the emitted row spans per run. The
        window covers exactly ``width`` view slots from the seek
        position — placeholders, old versions and tombstones consume
        budget — matching the device path's ``gather_view`` window
        bit-for-bit, so promotion never changes scan results.

        With ``prefetch_depth > 0`` the materialization is pipelined per
        selector group (paper Fig 10): while group *i*'s rows are being
        fetched and emitted, the value/tomb blocks of groups
        ``i+1 .. i+depth`` — already known exactly from the decoded
        selector stream — are issued into the block cache, so a demand
        read behind the emitter always finds its granule resident. The
        prefetched block set equals the eager path's demand set (the
        stream names precisely which rows each group touches), so
        pipelining never reads a block the eager path would not.

        Returns (keys (M,) u64, vals (M, VW), more) — live entries in
        ascending order, M ≤ width, and whether view slots remain beyond
        the window (so an all-invalid window is distinguishable from an
        exhausted partition)."""
        state = self.cold_cursor_seek(start)
        return self.cold_cursor_window(
            state, width, prefetch_depth=prefetch_depth
        )

    def _emit_window(
        self, pos, stop, win, rows_abs, newest, depth, vw, d
    ) -> tuple[np.ndarray, np.ndarray]:
        """Materialize and emit one walked window, group-pipelined.

        The window's emitted slots are split into selector-group chunks
        (one chunk — the whole window — when ``depth == 0``, i.e. the
        eager path). Per chunk and run, the emitted row span is fetched
        as one coalesced range; with ``depth > 0`` the *next* chunks'
        value/tomb granules are issued to the cache first.
        """
        runsel = win & 0x7F
        slots = np.arange(pos, stop)
        if depth > 0 and not self._window_resident(runsel, rows_abs, newest):
            bounds = (
                [pos]
                + list(range((pos // d + 1) * d, stop, d))
                + [stop]
            )
        else:
            # eager path — or a fully-warm window, where the group-ahead
            # pipeline would issue no prefetch (every granule resident)
            # and only pay per-group fetch overhead: one span per run
            bounds = [pos, stop]
        nrun = len(self.tables)
        chunk_ranges: list[list[tuple[int, int]]] = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            inb = (slots >= a) & (slots < b) & newest
            rng = []
            for r in range(nrun):
                rr = rows_abs[inb & (runsel == r)]
                rng.append((int(rr[0]), int(rr[-1]) + 1) if len(rr) else (0, 0))
            chunk_ranges.append(rng)
        ks_out: list[np.ndarray] = []
        vs_out: list[np.ndarray] = []
        issued: set[tuple[int, int]] = set()  # (run, granule) already sent
        for ci, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            for cj in range(ci + 1, min(ci + 1 + depth, len(chunk_ranges))):
                for r in range(nrun):
                    lo2, hi2 = chunk_ranges[cj][r]
                    if hi2 <= lo2:
                        continue
                    # one deduped issue set per (chunk, run): the vals
                    # and tomb sections share boundary granules, and
                    # successive lookahead windows revisit chunks — each
                    # granule is issued to the cache at most once per
                    # window emission
                    t = self.tables[r]
                    ids = set(t.row_block_ids("vals", lo2, hi2))
                    ids.update(t.row_block_ids("tomb", lo2, hi2))
                    fresh = [bi for bi in sorted(ids)
                             if (r, bi) not in issued]
                    issued.update((r, bi) for bi in fresh)
                    t.prefetch_blocks(fresh)
            inb = (slots >= a) & (slots < b) & newest
            if not inb.any():
                continue
            er, erow = runsel[inb], rows_abs[inb]
            # each run's emitted rows lie inside one contiguous span
            # (occurrence counting assigns window rows in view order),
            # so per section one span fetch + an index gather suffices —
            # no range merging or searchsorted row resolution needed
            kk = np.empty(len(er), np.uint64)
            vv2 = np.empty((len(er), vw), np.uint32)
            dead = np.zeros(len(er), bool)
            for r in np.unique(er):
                m = er == r
                lo2, hi2 = chunk_ranges[ci][r]
                idx = erow[m] - lo2  # old-version rows interleave: gather
                t = self.tables[r]
                kk[m] = CK.unpack_u64(t.rows("keys", lo2, hi2))[idx]
                vv2[m] = t.rows("vals", lo2, hi2)[idx]
                dead[m] = t.dead_rows(lo2, hi2)[idx]
                if self.excised:
                    dead[m] |= self._span_dead(r, kk[m])
            live = ~dead
            ks_out.append(kk[live])
            vs_out.append(vv2[live])
        if not ks_out:
            return np.zeros(0, np.uint64), np.zeros((0, vw), np.uint32)
        return np.concatenate(ks_out), np.concatenate(vs_out)

    # ---- cursor continuation (streaming scans without re-seeking) ----
    def _cursor_state(self, start: int) -> dict:
        """Bare continuation state (no skip table): the view position of
        ``start``'s lower bound plus the per-run next-row pointers."""
        hx = self._host_index()
        g = max(
            int(np.searchsorted(hx["anch64"], np.uint64(start), side="right"))
            - 1,
            0,
        )
        cur, nxt = self._group_rows(hx, g)
        qw = CK.pack_u64(np.array([start], np.uint64))[0]
        nextrow = np.array(
            [
                t.seek_row(qw, int(cur[r]), int(nxt[r]))
                for r, t in enumerate(self.tables)
            ],
            np.int64,
        )
        return dict(pos=self._seek_slot(hx, g, cur, nextrow), nextrow=nextrow)

    def cold_cursor_seek(self, start: int) -> dict:
        """Continuation state for a streaming cold scan: the view position
        of ``start``'s lower bound plus the per-run next-row pointers.

        One anchors binary search + one bounded CKB seek per run — paid
        exactly once per cursor; every subsequent window is a pure
        selector-stream decode (:meth:`cold_cursor_window`).

        Excised spans covering *all* tables additionally contribute a
        ``skips`` table of view-position intervals: everything inside
        them is dead by construction, so the window walk jumps over them
        structurally — no selector decode, no key/value block reads —
        resuming with the span-end seek's next-row pointers."""
        state = self._cursor_state(start)
        spans = self.full_spans() if self.excised else ()
        if spans:
            skips = []
            for lo, hi in spans:
                a = self._cursor_state(lo)
                b = self._cursor_state(hi)
                if b["pos"] > a["pos"]:
                    skips.append((int(a["pos"]), int(b["pos"]),
                                  b["nextrow"]))
            if skips:
                state["skips"] = sorted(skips)
        return state

    def cold_cursor_window(self, state: dict, width: int,
                           prefetch_depth: int = 0):
        """Walk the next ``width`` view slots from ``state`` (no seek).

        The comparison-free ``next × width`` of the paper's cursor
        (§3.3): decode the persisted selector stream from the saved
        position, fetch only the emitted row spans, advance the state.
        Returns (keys, vals, more) exactly like :meth:`cold_scan`; a
        fresh ``cold_cursor_seek(start)`` followed by chained windows
        yields bit-identical rows to repeated ``cold_scan`` calls."""
        hx = self._host_index()
        self.cold_scans += 1
        vw = self.tables[0].vw if self.tables else 2
        pos0 = int(state["pos"])
        # structural skip: jump excised view intervals, clamp the walk so
        # a window never enters one (its blocks are never touched)
        for slo, shi, nrow in state.get("skips", ()):
            if slo <= pos0 < shi:
                pos0 = shi
                state["pos"] = shi
                state["nextrow"] = nrow.copy()
            elif pos0 < slo:
                width = min(width, slo - pos0)
                break
        if pos0 >= hx["n_slots"]:
            return np.zeros(0, np.uint64), np.zeros((0, vw), np.uint32), False
        pos, stop, valid, win, rows_abs, newest = self._walk_from(
            hx, pos0, state["nextrow"], width
        )
        state["pos"] = stop
        more = stop < hx["n_slots"]
        if not bool(newest.any()):
            return np.zeros(0, np.uint64), np.zeros((0, vw), np.uint32), more
        kk, vv = self._emit_window(
            pos, stop, win, rows_abs, newest, prefetch_depth, vw, hx["d"]
        )
        self.cold_served_rows += len(kk)
        return kk, vv, more

    def _window_resident(self, runsel, rows_abs, newest) -> bool:
        """Whether every granule a window's emission touches is already
        cached/verified (no I/O left to overlap — pipelining it would be
        pure per-group overhead). Side-effect-free."""
        for r in range(len(self.tables)):
            rr = rows_abs[newest & (runsel == r)]
            if not len(rr):
                continue
            lo, hi = int(rr[0]), int(rr[-1]) + 1
            t = self.tables[r]
            if not all(
                t.rows_resident(sec, lo, hi)
                for sec in ("keys", "vals", "tomb")
            ):
                return False
        return True

    def _dead_fetcher(self, r: int):
        """Section fetcher for run ``r`` whose "tomb" answers are the
        combined liveness column (tomb | expired TTL) — lets RowWindow
        stay liveness-agnostic. Free when the table carries no TTLs."""
        t = self.tables[r]
        if not t.ttl_present():
            return t.rows_scattered
        now = clock.now()

        def fetch(section, rows):
            if section == "tomb":
                return t.dead_rows_scattered(rows, now)
            return t.rows_scattered(section, rows)

        return fetch

    def cold_scan_batch(self, starts, width) -> list[tuple]:
        """Batched :meth:`cold_scan`: one vectorized anchors search and
        one grouped per-run seek for the whole batch, then per-query
        selector walks whose touched row spans are **coalesced per run**
        (``merge_ranges``) before fetching — interleaved scan windows
        share granules, and each touched (file, block) granule is read
        at most once for the batch. ``width`` may be a scalar or a (Q,)
        array — heterogeneous scan groups merge their row windows into
        the same coalesced fetch set. Returns a list of per-query
        ``(keys, vals, more)`` triples, bit-identical to cold_scan.

        (No prefetch pipeline here: the batch path already fetches every
        window's blocks in one coalesced pass up front, which strictly
        dominates group-ahead prefetching.)"""
        starts = np.asarray(starts, np.uint64)
        q = len(starts)
        widths = np.zeros(q, np.int64) + np.asarray(width, np.int64)
        vw = self.tables[0].vw if self.tables else 2
        empty = (np.zeros(0, np.uint64), np.zeros((0, vw), np.uint32), False)
        if q == 0 or not self.tables:
            return [empty] * q
        hx = self._host_index()
        self.cold_scans += q
        n_slots = hx["n_slots"]
        nrun = len(self.tables)
        g, cur, nxt = self._group_bounds_batch(hx, starts)
        nextrow = np.empty((q, nrun), np.int64)
        for r, t in enumerate(self.tables):
            nextrow[:, r] = t.seek_rows_batch(starts, cur[:, r], nxt[:, r])
        walks = []
        ranges_by_run: list[list[tuple[int, int]]] = [[] for _ in range(nrun)]
        for i in range(q):
            pos, stop, valid, win, rows_abs, newest = self._walk_window(
                hx, int(g[i]), cur[i], nextrow[i], int(widths[i])
            )
            er = (win & 0x7F)[newest]
            erow = rows_abs[newest]
            for r in np.unique(er):
                rr = erow[er == r]
                ranges_by_run[r].append((int(rr[0]), int(rr[-1]) + 1))
            walks.append((er, erow, stop < n_slots))
        windows = [
            RowWindow.from_scattered(ranges_by_run[r], self._dead_fetcher(r))
            for r in range(nrun)
        ]
        out = []
        for er, erow, more in walks:
            if er.size == 0:
                out.append((empty[0], empty[1], more))
                continue
            kk, vv = self._gather_emit(er, erow, windows, vw)
            self.cold_served_rows += len(kk)
            out.append((kk, vv, more))
        return out

    @property
    def n_entries(self) -> int:
        return sum(t.n for t in self.tables)

    def data_bytes(self) -> int:
        return sum(t.bytes() for t in self.tables)

    def persist_index(self, storage) -> None:
        """Build (if needed) and serialize this partition's REMIX; the
        padded on-device copy is derived, only the unpadded index persists."""
        self.index()
        self.remix_name = storage.write_remix(self._built_remix)

    def _build(self, runs, tabs: list[Table], d: int) -> tuple[Remix, RunSet]:
        """Unpadded (remix, runset), incrementally where only tables were
        appended since the last build."""
        remix = self._try_incremental(tabs, d)
        if remix is not None:
            remix = _to_device(remix, self.device)
            runset = stack_runs(runs)
        else:
            remix, runset = build_remix(runs, d=d)
            self.last_build_kind = "scratch"
        self._built_remix = remix
        self._built_tables = list(tabs) if self.tables else []
        self.remix_bytes = int(remix.storage_bytes())
        return remix, runset

    def index(self) -> tuple[Remix, RunSet]:
        """Build (or reuse) the partition's REMIX + stacked runs, with
        liveness (tombstones, TTL expiry at build time, excised spans)
        baked into the runset's tombstones.

        Shapes are bucket-padded to powers of two, as in the reference.
        """
        # TTL staleness: tomb marks were baked at build time; once the
        # clock passes the earliest future expiry, rebuild the runset
        # (the REMIX itself is liveness-independent and gets reused)
        if (
            self._remix is not None
            and self._ttl_next is not None
            and clock.now() >= self._ttl_next
        ):
            self._remix = None
            self._runset = None
        if self._remix is None:
            tabs = self.tables or [_empty_table()]
            d = max(self.d, len(tabs))  # paper requires D >= R
            now = clock.now()
            runs = [
                make_run(t.keys, t.vals, seq=t.seq,
                         tomb=self._build_dead(t, now), sort=False,
                         device=self.device)
                for t in tabs
            ]
            nexts = [t.min_future_exp(now) for t in tabs]
            self._ttl_next = min(
                (x for x in nexts if x is not None), default=None
            )
            remix, runset = self._build(runs, tabs, d)
            self._remix, self._runset = _pad_index(remix, runset, d)
        return self._remix, self._runset

    def release_device(self) -> None:
        """Free this partition's device memory: drop the padded index
        that :meth:`index` built and move the last built REMIX to the
        host, where the next build finds it again (as after recovery)."""
        self._remix = None
        self._runset = None
        self._host = None
        if self._built_remix is not None:
            self._built_remix = _to_device(self._built_remix, torch.device("cpu"))

    def _build_dead(self, t: Table, now: float) -> np.ndarray:
        """Liveness column baked into the runset for table ``t``:
        tombstones, TTL-expired rows, and rows an excised span covers."""
        return t.dead(now) | self._span_cover(t)

    def _span_cover(self, t: Table) -> np.ndarray:
        """(N,) bool: rows of ``t`` hidden by an excised span covering it
        — structural deadness (a covered row can never revive), safe to
        bake into any uploaded view regardless of the query clock."""
        dead = np.zeros(t.n, bool)
        for sp in self.excised:
            if sp.covers_table(t):
                m = (t.keys >= np.uint64(sp.lo)) & (t.keys < np.uint64(sp.hi))
                if m.any():
                    dead = dead | m
        return dead

    # ---------------- device-resident view (kernels/device_view.py) ----
    def device_view_bytes(self, with_vals: bool = True) -> int:
        """Estimated padded device-buffer bytes of :meth:`device_index`
        (no build needed) — the upload/tier decision input of the
        :class:`~repro_torch.kernels.device_view.DeviceViewManager`."""
        tabs = self.tables
        r2 = _pow2(max(1, len(tabs)), 1)
        n2 = _pow2(max((t.n for t in tabs), default=1), 64)
        d = max(self.d, len(tabs))
        kw = 2
        vw = (tabs[0].vw if tabs else 2) if with_vals else 1
        g2 = _pow2(max(1, -(-self.n_entries // d)), 4)
        per_row = 4 * kw + 4 * vw + 4 + 1 + 4  # keys+vals+seq+tomb+exp
        return int(g2 * (4 * kw + 4 * r2 + d) + r2 * n2 * per_row + r2 * 4)

    def device_index(self, with_vals: bool = True):
        """Padded ``(remix, runset, exp)`` for the device-resident view.

        Unlike :meth:`index`, liveness is *not* baked at build time: the
        runset tombstones carry only real tombstones plus excised-span
        coverage (structural), and the per-row TTL expiry words ride
        along as a padded (R, Nmax) int32-word tensor so the device
        evaluates ``tomb | (exp != 0 & exp <= now)`` at query time.

        With ``with_vals=False`` (the index-only residency tier) the
        value sections stay host-side and are never read: the runset
        carries 1-word dummy values and callers gather real value
        granules through the BlockCache from the returned (run, row)
        coordinates.
        """
        tabs = self.tables or [_empty_table()]
        d = max(self.d, len(tabs))  # paper requires D >= R
        runs, exps = [], []
        for t in tabs:
            dead = np.asarray(t.tomb, bool) | self._span_cover(t)
            vals = t.vals if with_vals else np.zeros((t.n, 1), np.uint32)
            runs.append(
                make_run(t.keys, vals, seq=t.seq, tomb=dead, sort=False,
                         device=self.device)
            )
            exps.append(
                np.asarray(t.exp, np.uint32)
                if t.ttl_present()
                else np.zeros(t.n, np.uint32)
            )
        remix, runset = self._build(runs, tabs, d)
        remix_p, runset_p = _pad_index(remix, runset, d)
        exp_p = torch.zeros((runset_p.r, runset_p.nmax), dtype=torch.int32,
                            device=self.device)
        for i, e in enumerate(exps):
            if len(e):
                exp_p[i, : len(e)] = as_words(e, self.device)
        return remix_p, runset_p, exp_p

    def _try_incremental(self, tabs: list[Table], d: int) -> Remix | None:
        """Reuse/extend the last built REMIX when this rebuild only appended
        tables (minor compaction) — zero key comparisons among old runs.

        Returns None when the table set changed in any other way (major,
        split, first build) or the group size moved; those rebuild from
        scratch.
        """
        prev, base = self._built_remix, self._built_tables
        if prev is None or not base or prev.r != len(base) or prev.d != d:
            return None
        if len(tabs) < len(base) or any(
            a is not b for a, b in zip(base, tabs)
        ):
            return None
        if len(tabs) == len(base):  # nothing changed: reuse as-is
            self.last_build_kind = "reuse"
            return prev
        from repro_torch.io.rebuild import incremental_build_remix

        new = tabs[len(base):]
        remix = incremental_build_remix(
            prev,
            [t.key_words() for t in base],
            [t.key_words() for t in new],
            [np.asarray(t.seq) for t in new],
            d=d,
        )
        self.last_build_kind = "incremental"
        return remix

    def estimate_remix_bytes(self, extra_entries: int = 0) -> int:
        """Size estimate of a REMIX over current + new entries (§4.2 Abort)."""
        n = self.n_entries + extra_entries
        r = len(self.tables) + 1
        groups = max(1, n // self.d)
        return int(groups * (8 + 4 * r) + n)
