"""Immutable, refcounted store Versions (LevelDB-style version set, §4.2–4.3).

A :class:`Version` is a frozen snapshot of the store below the MemTable:
the partition list (each partition owning its immutable tables + REMIX)
plus the sequence horizon that was current when the version was created.
``flush()``/compaction never mutate a published Version — they build new
:class:`~repro_torch.db.partition.Partition` objects off to the side (table
writes, incremental REMIX rebuild, manifest commit = the version edge)
and publish them through :meth:`VersionSet.publish`, a pointer swap.

In-flight readers *pin* the Version they started on; a retired Version —
and the tables/REMIXes only it references — is released when its last
pin drops, never mid-read. The release callback lets the store fold the
retired tables' I/O accounting and garbage-collect files that were kept
on disk solely for that Version.

:class:`Snapshot` is the read-side handle: a pinned Version plus a frozen
MemTable overlay, giving every query issued through it the exact store
contents at creation time regardless of concurrent flushes. Snapshots
are context managers; the store's own ``get``/``scan`` calls use
ephemeral (unpinned) snapshots of the live state.
"""
from __future__ import annotations

import os
import threading


class Version:
    """One immutable store version: partitions + sequence horizon."""

    __slots__ = ("vid", "partitions", "seq_horizon", "refs")

    def __init__(self, vid: int, partitions, seq_horizon: int):
        self.vid = vid
        self.partitions = tuple(partitions)
        self.seq_horizon = int(seq_horizon)
        self.refs = 0  # managed by VersionSet under its lock

    def __repr__(self) -> str:
        return (
            f"Version(vid={self.vid}, partitions={len(self.partitions)}, "
            f"seq_horizon={self.seq_horizon}, refs={self.refs})"
        )

    def file_names(self) -> set[str]:
        """Manifest-relative table/REMIX file names this version pins."""
        live: set[str] = set()
        for p in self.partitions:
            for t in p.tables:
                if t.path is not None:
                    live.add(os.path.basename(t.path))
            if p.remix_name:
                live.add(p.remix_name)
        return live

    def tables(self):
        for p in self.partitions:
            yield from p.tables


class VersionSet:
    """The registry of live Versions + the ``current`` pointer.

    ``publish`` installs a new current Version (the pointer swap at the
    end of a flush); the previous current keeps serving any reader that
    pinned it and is released — triggering ``on_release(version,
    remaining_live)`` — only when its last pin drops. All refcount state
    is guarded by one lock so readers can pin from any thread while a
    flush publishes.
    """

    def __init__(self, on_release=None, registry=None):
        # reentrant: a cyclic-GC-collected Snapshot's finalizer may call
        # unpin() on the very thread that is inside publish()/pin_current
        # holding this lock — a plain Lock would self-deadlock. Reentrant
        # unpins are safe: they run at points where the registry is
        # consistent, and the ``v is not self.current`` guard keeps the
        # in-flight publish's versions alive.
        self._lock = threading.RLock()
        self._live: dict[int, Version] = {}
        self._next_vid = 1
        self.current: Version | None = None
        self.on_release = on_release
        if registry is None:
            from repro_torch.obs import metrics as _metrics

            registry = _metrics.MetricsRegistry()
        self._c_publishes = registry.counter("versions_published")
        self._c_releases = registry.counter("versions_released")
        registry.gauge("versions_live", fn=lambda: len(self._live))
        registry.gauge("versions_pinned", fn=lambda: self.stats()["pinned"])

    def publish(self, partitions, seq_horizon: int) -> Version:
        """Install a new current Version; the old one is unpinned (and
        released immediately when no reader holds it)."""
        with self._lock:
            v = Version(self._next_vid, partitions, seq_horizon)
            self._next_vid += 1
            v.refs = 1  # the ``current`` pointer's own pin
            self._live[v.vid] = v
            old, self.current = self.current, v
        self._c_publishes.inc()
        if old is not None:
            self.unpin(old)
        return v

    def pin_current(self) -> Version:
        with self._lock:
            v = self.current
            v.refs += 1
            return v

    def unpin(self, v: Version) -> None:
        fire = False
        with self._lock:
            v.refs -= 1
            if v.refs == 0 and v is not self.current:
                del self._live[v.vid]
                remaining = list(self._live.values())
                fire = True
        if fire:
            self._c_releases.inc()
            if self.on_release is not None:
                self.on_release(v, remaining)

    def live_versions(self) -> list[Version]:
        with self._lock:
            return list(self._live.values())

    def stats(self) -> dict:
        with self._lock:
            return dict(
                current=self.current.vid if self.current else 0,
                live=len(self._live),
                pinned=max(0, (self.current.refs - 1) if self.current else 0)
                + sum(
                    v.refs
                    for v in self._live.values()
                    if v is not self.current
                ),
            )


class Snapshot:
    """A consistent read view: pinned Version + frozen MemTable overlay.

    Every read issued through a Snapshot — ``get``/``get_batch``/
    ``scan``/``scan_batch``/``cursor`` — observes exactly the store
    contents at creation time: concurrent flushes publish new Versions
    without touching this one, and the overlay is a point-in-time copy
    of the MemTable (writes after the snapshot go to the live dict).

    Obtained from :meth:`repro_torch.db.store.RemixDB.snapshot` (pinned; use as
    a context manager or call :meth:`close`). The store's direct read
    methods use ephemeral unpinned snapshots of the live state, so both
    paths run the same query code.
    """

    def __init__(self, store, version: Version, overlay: dict,
                 seq: int, pinned: bool = False, shared: bool = False,
                 ranges: tuple = ()):
        self.store = store
        self.version = version
        self.overlay = overlay  # key -> MemTable Entry (frozen iff copied)
        # overlay range tombstones (lo, hi, seq): DeleteRanges buffered in
        # the (frozen) MemTable at creation — they hide every table row in
        # [lo, hi) until a flush converts them to partition excised spans
        self.ranges = tuple(ranges)
        # sequence horizon at creation: every write with seq < this is
        # visible (version.seq_horizon covers the table state; overlay
        # entries extend visibility up to this snapshot's horizon)
        self.seq = int(seq)
        self.pinned = pinned
        # shared=True: overlay IS the store's live MemTable dict (the
        # ephemeral per-call view) — iterating it must coordinate with
        # writers via store._state_lock; a public snapshot()'s private
        # copy needs no such care
        self.shared = shared
        self.closed = False

    @property
    def partitions(self):
        return self.version.partitions

    def covers(self, key: int) -> bool:
        """Whether an overlay range tombstone hides table rows at ``key``
        (overlay *entries* for the key take precedence — check them
        first; any entry newer than the range was written after it)."""
        return any(lo <= key < hi for lo, hi, _ in self.ranges)

    # ---- reads (delegating to the store's shared query engine) ----
    def get(self, key: int):
        return self.store._get_at(self, key)

    def get_batch(self, keys):
        return self.store._get_batch_at(self, keys)

    def scan(self, start_key: int, n: int):
        return self.store._scan_at(self, start_key, n)

    def scan_batch(self, starts, n: int):
        return self.store._scan_batch_at(self, starts, n)

    def cursor(self, start: int = 0, width: int = 64):
        """A :class:`repro_torch.db.cursor.RemixCursor` positioned at the lower
        bound of ``start`` over this snapshot's merged view."""
        from repro_torch.db.cursor import RemixCursor

        cur = RemixCursor(self, width=width)
        cur.seek(start)
        return cur

    # ---- lifecycle ----
    def close(self) -> None:
        """Drop the pin; idempotent. After the last snapshot of a retired
        Version closes, its exclusively-owned tables/files are released."""
        if self.pinned and not self.closed:
            self.closed = True
            self.store.versions.unpin(self.version)

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __repr__(self) -> str:
        return (
            f"Snapshot(version={self.version.vid}, seq={self.seq}, "
            f"overlay={len(self.overlay)}, pinned={self.pinned}, "
            f"closed={self.closed})"
        )
