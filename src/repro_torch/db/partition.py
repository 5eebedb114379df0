"""Key-range partitions: table files + one REMIX per partition (paper §4).

Tables are host numpy arrays (the "files") or lazy handles onto on-disk
SSTables, whose sections are read — and checksum-verified — on first
access; on the host a table returns exactly the JAX package's arrays.
The partition builds its REMIX + stacked RunSet on the host and keeps them
as torch tensors on its device when first queried (:meth:`Partition.index`,
the plain engine's input) or when a device view uploads it
(:meth:`Partition.device_index`, with or without the value sections). A
persisted REMIX (:meth:`Partition.persist_index`) is adopted back with
:meth:`Partition.preload_index`. The cold read path and the compaction
helpers (``excise_rows``, ``merge_tables``, ``chunk_table``,
``clone_with_tables``) come with the port's store slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.core.remix import Remix, build_remix
from repro_torch.core.runs import (
    RunSet,
    make_run,
    merge_ranges_np,
    ranges_to_rows,
    stack_runs,
)
from repro_torch.core.view import PLACEHOLDER
from repro_torch.db import clock
from repro_torch.device import as_words, resolve


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

    def __repr__(self) -> str:
        # introspection must not force-load lazy table handles
        return (
            f"Partition(lo={self.lo}, tables={len(self.tables)}, "
            f"resident={sum(t.resident for t in self.tables)}, "
            f"built={self.last_build_kind})"
        )

    def attach_excised(self, lo: int, hi: int, seq: int) -> None:
        """Attach a freshly flushed range tombstone covering every table
        this partition holds *right now* (their rows all predate it)."""
        if self.tables and lo < hi:
            self.excised.append(
                ExcisedSpan(int(lo), int(hi), int(seq), tuple(self.tables))
            )

    @property
    def n_entries(self) -> int:
        return sum(t.n for t in self.tables)

    def preload_index(self, remix: Remix):
        """Adopt a deserialized REMIX for the current table list (recovery
        path): the next build reuses it instead of rebuilding."""
        self._built_remix = remix
        self._built_tables = list(self.tables)
        self.remix_bytes = int(remix.storage_bytes())

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
