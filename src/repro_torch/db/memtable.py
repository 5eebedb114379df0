"""MemTable: in-memory write buffer with per-key 8-bit update counters.

The paper (§4.2, following TRIAD) counts updates per key so that compaction
can retain frequently-updated keys in the MemTable/WAL instead of repeatedly
rewriting them into table files. Counters saturate at 255 and are halved when
a key is carried over by a compaction.

Keys are 64-bit ints; values are fixed-width uint32 word vectors. Entries
carry an optional absolute TTL expiry (``exp`` unix seconds, 0 = none).

Range tombstones (DeleteRange) live beside the point entries as a list of
``(lo, hi, seq)`` triples: live entries covered at delete time are eagerly
converted to point tombstones (entries are *replaced*, never mutated, so
snapshot views keep the pre-delete Entry objects), and the triple
itself hides every table row in [lo, hi) until the next flush turns it
into a manifest-level excised span.

Persistent layered overlay: entries are stored as a stack of immutable
layers plus one small mutable top layer. :meth:`snapshot_view` freezes
the top (an O(1) pointer push — no dict copy, however large the
MemTable) and returns a :class:`LayeredMap` over the frozen stack, so
``db.snapshot()`` is O(1) and high-pin-rate serving (replica catch-up,
per-batch snapshots) never pays an O(memtable) copy. Writes go to a
fresh top layer and can never reach a frozen view; layer count is
bounded by merging frozen layers (amortized) once it exceeds
``MAX_LAYERS``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Entry:
    seq: int
    tomb: bool
    val: np.ndarray  # (VW,) uint32
    count: int  # 8-bit update counter
    exp: int = 0  # absolute TTL expiry, unix seconds (0 = no TTL)


def entry_dead(e: Entry, now: float) -> bool:
    """True when the entry is a tombstone or its TTL has expired."""
    return e.tomb or (e.exp != 0 and e.exp <= now)


class LayeredMap:
    """Read-only dict-like view over a stack of entry dicts.

    ``layers`` is ordered newest → oldest; a key's entry is the one in
    the newest layer holding it. The view is what snapshots hold as
    their overlay: frozen views are immutable (their layers are never
    written again), the live view (``MemTable.data``) reads through to
    the mutable top layer. ``len``/``bool`` report the number of
    *distinct* keys, captured at construction.
    """

    __slots__ = ("layers", "_n")

    def __init__(self, layers, n: int):
        self.layers = tuple(layers)
        self._n = int(n)

    def get(self, key, default=None):
        for d in self.layers:
            e = d.get(key)
            if e is not None:
                return e
        return default

    def __getitem__(self, key):
        e = self.get(key)
        if e is None:
            raise KeyError(key)
        return e

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        if len(self.layers) == 1:
            yield from self.layers[0]
            return
        seen: set[int] = set()
        for d in self.layers:
            for k in d:
                if k not in seen:
                    seen.add(k)
                    yield k

    def keys(self):
        return iter(self)

    def values(self):
        for _, e in self.items():
            yield e

    def items(self):
        if len(self.layers) == 1:
            yield from self.layers[0].items()
            return
        seen: set[int] = set()
        for d in self.layers:
            for k, e in d.items():
                if k not in seen:
                    seen.add(k)
                    yield k, e


class MemTable:
    # frozen-layer budget: a snapshot_view() that would leave more than
    # this many frozen layers first merges them into one (new dict —
    # existing views keep their own layer tuples untouched)
    MAX_LAYERS = 4

    def __init__(self, vw: int = 2):
        self.vw = vw
        self._top: dict[int, Entry] = {}  # mutable newest layer
        self._frozen: tuple[dict, ...] = ()  # immutable, newest → oldest
        self._n = 0  # distinct keys across all layers
        self.ranges: list[tuple[int, int, int]] = []  # (lo, hi, seq)

    def __len__(self) -> int:
        return self._n

    @property
    def data(self) -> LayeredMap:
        """Live dict-like view over all layers (reads see every write;
        snapshot consumers use :meth:`snapshot_view` instead)."""
        return LayeredMap((self._top,) + self._frozen, self._n)

    def snapshot_view(self) -> LayeredMap:
        """O(1) frozen view of the current contents.

        Freezes the mutable top layer (pointer push, no copy) so later
        writes land in a fresh top and can never reach the returned
        view. Callers must hold the store's ``_state_lock`` (the same
        lock writers insert under).
        """
        if self._top:
            frozen = (self._top,) + self._frozen
            self._top = {}
            if len(frozen) > self.MAX_LAYERS:
                merged: dict[int, Entry] = {}
                for d in reversed(frozen):
                    merged.update(d)
                frozen = (merged,)
            self._frozen = frozen
        return LayeredMap(self._frozen or ({},), self._n)

    def _lookup(self, key: int) -> Entry | None:
        e = self._top.get(key)
        if e is not None:
            return e
        for d in self._frozen:
            e = d.get(key)
            if e is not None:
                return e
        return None

    def put(self, key: int, val: np.ndarray, seq: int, tomb: bool = False,
            exp: int = 0):
        prev = self._lookup(key)
        if prev is None:
            self._n += 1
            count = 1
        else:
            count = min(255, prev.count + 1)
        self._top[key] = Entry(seq=seq, tomb=tomb, val=val, count=count,
                               exp=int(exp))

    def put_batch(self, keys, vals, seq0: int, tomb=None, exp=None) -> int:
        """Vectorized put; returns the next unused sequence number."""
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32).reshape(len(keys), self.vw)
        tomb = np.zeros(len(keys), bool) if tomb is None else np.asarray(tomb)
        exp = (
            np.zeros(len(keys), np.uint32) if exp is None
            else np.asarray(exp, np.uint32)
        )
        seq = seq0
        for k, v, t, e in zip(keys.tolist(), vals, tomb.tolist(),
                              exp.tolist()):
            self.put(k, v, seq, t, e)
            seq += 1
        return seq

    def delete_range(self, lo: int, hi: int, seq: int):
        """Record a range tombstone [lo, hi) at sequence ``seq``.

        Covered live entries with an older seq are eagerly replaced by
        point tombstones: after this, a covered key never resurfaces from
        the overlay, and table rows are hidden by the (lo, hi, seq) triple
        until the flush attaches it to the partitions as an excised span.
        """
        for k, e in list(self.data.items()):
            if lo <= k < hi and e.seq < seq and not e.tomb:
                self._top[k] = Entry(
                    seq=seq, tomb=True,
                    val=np.zeros(self.vw, np.uint32), count=e.count,
                )
        self.ranges.append((int(lo), int(hi), int(seq)))

    def purge_range(self, lo: int, hi: int) -> int:
        """Drop every entry with key in [lo, hi) and clip buffered range
        tombstones to the outside of it (shard absorb/merge: the span's
        authoritative state now comes from the absorbed shard). Collapses
        the layer stack; existing snapshot views are unaffected (they
        hold their own layer tuples). Returns the number dropped."""
        kept = {
            k: e for k, e in self.data.items() if not (lo <= k < hi)
        }
        dropped = self._n - len(kept)
        self._top = kept
        self._frozen = ()
        self._n = len(kept)
        ranges: list[tuple[int, int, int]] = []
        for rlo, rhi, s in self.ranges:
            if rlo < lo and rlo < min(rhi, lo):
                ranges.append((rlo, min(rhi, lo), s))
            if rhi > hi and max(rlo, hi) < rhi:
                ranges.append((max(rlo, hi), rhi, s))
        self.ranges = ranges
        return dropped

    def covers(self, key: int) -> bool:
        """True when any buffered range tombstone covers ``key``."""
        return any(lo <= key < hi for lo, hi, _ in self.ranges)

    def carry_over(self, key: int, entry: Entry):
        """Re-insert a compaction-excluded hot key (counter halving, §4.2)."""
        cur = self._lookup(key)
        if cur is None:
            self._n += 1
            self._top[key] = Entry(
                seq=entry.seq, tomb=entry.tomb, val=entry.val,
                count=max(1, entry.count // 2), exp=entry.exp,
            )
        else:
            # newer update already buffered: fold the halved old count in
            # (entries are replaced, not mutated — frozen views may share
            # the current object)
            self._top[key] = Entry(
                seq=cur.seq, tomb=cur.tomb, val=cur.val,
                count=min(255, cur.count + max(1, entry.count // 2)),
                exp=cur.exp,
            )

    def get(self, key: int) -> Entry | None:
        return self._lookup(key)

    def sorted_items(self):
        return sorted(self.data.items())

    def range_items(self, lo: int, hi: int):
        return [(k, e) for k, e in self.sorted_items() if lo <= k < hi]

    def approx_bytes(self, key_bytes: int = 8) -> int:
        return self._n * (key_bytes + 4 * self.vw + 8)

    def to_arrays(self):
        items = self.sorted_items()
        keys = np.array([k for k, _ in items], np.uint64)
        vals = (
            np.stack([e.val for _, e in items])
            if items
            else np.zeros((0, self.vw), np.uint32)
        )
        seq = np.array([e.seq for _, e in items], np.uint32)
        tomb = np.array([e.tomb for _, e in items], bool)
        counts = np.array([e.count for _, e in items], np.int32)
        exp = np.array([e.exp for _, e in items], np.uint32)
        return keys, vals, seq, tomb, counts, exp
