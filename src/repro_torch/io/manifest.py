"""Versioned table/partition registry with atomic rename commits (§4.3).

``Manifest`` owns the commit protocol (see the package docstring diagram):
every commit writes ``MANIFEST-<v>.tmp``, fsyncs, renames it into place,
then repoints ``CURRENT`` the same way. A crash at any step leaves either
the previous or the new version fully readable. ``Storage`` layers file
allocation on top: monotonically numbered immutable table / REMIX files
plus orphan collection for files a crashed flush wrote but never
committed.

The manifest state is a plain JSON dict; ``repro_torch.io`` imposes no schema
beyond ``{"version": int}`` so the db layer owns its own contents
(partitions, sequence number, WAL mapping table).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

from repro_torch.io.faults import NULL_IO, CorruptionError

CURRENT = "CURRENT"
QUARANTINE_DIR = "quarantine"
_MANIFEST_RE = re.compile(r"^MANIFEST-(\d{6})$")
_FILE_RE = re.compile(r"^(t|x)-(\d{6})\.(sst|rmx)$")


def live_files(state: dict) -> set[str]:
    """Table/REMIX file names a manifest state references.

    The db layer uses this for orphan collection at recovery; with the
    Version architecture the *runtime* live set is the union of this
    over every pinned version of the store — a commit is
    the version edge, but files are reclaimed only when the last Version
    referencing them unpins.
    """
    live: set[str] = set()
    for pe in state.get("partitions", []):
        live.update(pe.get("tables", []))
        if pe.get("remix"):
            live.add(pe["remix"])
    return live


def _atomic_write(path: str, data: bytes, io=None) -> None:
    io = io or NULL_IO
    data = io.mutate_write(path, data)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        io.check_fsync(path)
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Manifest:
    """The versioned registry: MANIFEST-<v> files + the CURRENT pointer."""

    def __init__(self, root: str, io=None):
        self.root = root
        self.io = io or NULL_IO
        os.makedirs(root, exist_ok=True)

    def _current_name(self) -> str | None:
        cur = os.path.join(self.root, CURRENT)
        if not os.path.exists(cur):
            return None
        with open(cur, "rb") as f:
            raw = f.read()
        try:
            name = raw.decode("ascii").strip()
        except UnicodeDecodeError:
            raise CorruptionError(
                cur, "manifest",
                detail=f"undecodable CURRENT pointer: {raw[:32]!r}",
            )
        return name or None

    def current_version(self) -> int:
        name = self._current_name()
        if name is None:
            return 0
        m = _MANIFEST_RE.match(name)
        if not m:
            raise CorruptionError(
                os.path.join(self.root, CURRENT), "manifest",
                detail=f"corrupt CURRENT pointer: {name!r}",
            )
        return int(m.group(1))

    def load(self) -> dict | None:
        """State of the committed version, or None for a fresh directory."""
        name = self._current_name()
        if name is None:
            return None
        path = os.path.join(self.root, name)
        if not _MANIFEST_RE.match(name) or not os.path.exists(path):
            raise CorruptionError(
                os.path.join(self.root, CURRENT), "manifest",
                detail=f"CURRENT points at {name!r} which does not exist — "
                       f"corrupt manifest directory {self.root}",
            )

        def attempt() -> dict:
            with open(path, "rb") as f:
                self.io.check_read(path)
                raw = self.io.mutate_read(path, 0, f.read())
            try:
                return json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                raise CorruptionError(
                    path, "manifest", detail="undecodable manifest JSON"
                )

        return self.io.run("manifest", attempt)

    def verify(self) -> dict | None:
        """Scrub check: CURRENT and the manifest it points at agree and
        decode. Returns the state (None for fresh); raises
        :class:`CorruptionError` on disagreement."""
        state = self.load()
        if state is not None:
            v = state.get("version")
            if v != self.current_version():
                raise CorruptionError(
                    os.path.join(self.root, CURRENT), "manifest",
                    detail=f"CURRENT version {self.current_version()} != "
                           f"manifest body version {v}",
                )
        return state

    def commit(self, state: dict) -> int:
        """Durably publish ``state`` as the next version; returns it."""
        version = self.current_version() + 1
        state = dict(state, version=version)
        name = f"MANIFEST-{version:06d}"
        _atomic_write(
            os.path.join(self.root, name),
            json.dumps(state, separators=(",", ":")).encode(),
            io=self.io,
        )
        _atomic_write(
            os.path.join(self.root, CURRENT), name.encode() + b"\n",
            io=self.io,
        )
        # previous manifest versions are superseded; keep only the latest
        for f in os.listdir(self.root):
            m = _MANIFEST_RE.match(f)
            if m and int(m.group(1)) < version:
                os.remove(os.path.join(self.root, f))
        return version


class Storage:
    """File allocation + commit glue for one RemixDB data directory.

    Layout::

        <root>/CURRENT, MANIFEST-xxxxxx      (Manifest)
        <root>/tables/t-xxxxxx.sst           (immutable table files)
        <root>/remix/x-xxxxxx.rmx            (immutable REMIX files)
        <root>/wal.log                       (block-structured WAL)
        <root>/quarantine/                   (GC'd orphans, age-purged)
    """

    def __init__(self, root: str, with_ckb: bool = True, io=None):
        self.root = root
        self.with_ckb = with_ckb
        self.io = io or NULL_IO
        self.manifest = Manifest(root, io=self.io)
        self.tables_dir = os.path.join(root, "tables")
        self.remix_dir = os.path.join(root, "remix")
        self.quarantine_dir = os.path.join(root, QUARANTINE_DIR)
        os.makedirs(self.tables_dir, exist_ok=True)
        os.makedirs(self.remix_dir, exist_ok=True)
        self.bytes_written = 0
        self._next_id = 1 + max(
            (
                int(m.group(2))
                for d in (self.tables_dir, self.remix_dir)
                for f in os.listdir(d)
                if (m := _FILE_RE.match(f))
            ),
            default=0,
        )
        # a shard merge's live copy allocates names in this directory
        # while the store's own flush does
        self._id_lock = threading.Lock()

    def _alloc_id(self) -> int:
        with self._id_lock:
            n = self._next_id
            self._next_id += 1
            return n

    def wal_path(self) -> str:
        return os.path.join(self.root, "wal.log")

    def table_path(self, name: str) -> str:
        return os.path.join(self.tables_dir, name)

    def remix_path(self, name: str) -> str:
        return os.path.join(self.remix_dir, name)

    def alloc_table_name(self) -> str:
        return f"t-{self._alloc_id():06d}.sst"

    def alloc_remix_name(self) -> str:
        return f"x-{self._alloc_id():06d}.rmx"

    def write_table(self, keys, vals, seq, tomb, exp=None, rtombs=None) -> str:
        """Write one table file; returns its manifest-relative name."""
        from repro_torch.io.sstable import write_sstable

        name = self.alloc_table_name()
        self.bytes_written += write_sstable(
            self.table_path(name), keys, vals, seq, tomb,
            exp=exp, rtombs=rtombs, with_ckb=self.with_ckb, io=self.io,
        )
        return name

    def write_remix(self, remix) -> str:
        """Serialize one REMIX; returns its manifest-relative name."""
        from repro_torch.io.remix_io import dump_remix

        name = self.alloc_remix_name()
        self.bytes_written += dump_remix(
            remix, self.remix_path(name), io=self.io
        )
        return name

    def commit(self, state: dict) -> int:
        return self.manifest.commit(state)

    def load_state(self) -> dict | None:
        return self.manifest.load()

    def gc_orphans(self, live: set[str]) -> list[str]:
        """Quarantine table/REMIX files not referenced by the committed
        state (left behind by a flush that crashed before its commit).

        Files are *moved* into ``<root>/quarantine/`` instead of unlinked
        so a mis-scoped GC (or an operator investigating corruption) can
        still recover the bytes; :meth:`purge_quarantine` expires them by
        age. ``.tmp`` leftovers carry no committed data and are deleted
        outright.
        """
        removed = []
        for d in (self.tables_dir, self.remix_dir):
            for f in os.listdir(d):
                p = os.path.join(d, f)
                if f.endswith(".tmp"):
                    os.remove(p)
                    removed.append(f)
                elif _FILE_RE.match(f) and f not in live:
                    os.makedirs(self.quarantine_dir, exist_ok=True)
                    os.replace(p, os.path.join(self.quarantine_dir, f))
                    removed.append(f)
        return removed

    def quarantine_file(self, name: str) -> str | None:
        """Move a live table/REMIX file into the quarantine directory
        (scrub found it unrecoverable); returns its new path."""
        for d in (self.tables_dir, self.remix_dir):
            p = os.path.join(d, name)
            if os.path.exists(p):
                os.makedirs(self.quarantine_dir, exist_ok=True)
                dst = os.path.join(self.quarantine_dir, name)
                os.replace(p, dst)
                return dst
        return None

    def purge_quarantine(self, max_age_s: float) -> list[str]:
        """Delete quarantined files older than ``max_age_s`` (mtime-based);
        returns the purged names. ``max_age_s <= 0`` purges everything."""
        purged = []
        if not os.path.isdir(self.quarantine_dir):
            return purged
        cutoff = time.time() - max(0.0, max_age_s)
        for f in sorted(os.listdir(self.quarantine_dir)):
            p = os.path.join(self.quarantine_dir, f)
            try:
                if os.path.getmtime(p) <= cutoff:
                    os.remove(p)
                    purged.append(f)
            except OSError:
                continue
        return purged
