"""Snapshot shipping: materialize a pinned Version as a new store dir.

A RemixDB shard is fully described by its manifest: immutable table /
REMIX files plus a WAL horizon. Shipping therefore never rewrites data —
it pins a :class:`repro_torch.db.version.Snapshot`, hard-copies the referenced
files (with transient-fault retry through :class:`repro_torch.io.faults.
IOContext`), writes the snapshot's MemTable overlay into a fresh WAL at
the destination, and commits a manifest. ``RemixDB.open`` on the result
recovers to a bit-identical read view.

``lo``/``hi`` restrict the ship to a key span: only partitions
intersecting ``[lo, hi)`` are copied and overlay/range records are
clipped. This is the transport half of a live shard split — the span
must start at a partition boundary of the source (or below its data);
the cluster layer aligns split points before calling in here.
"""
from __future__ import annotations

import os

from repro_torch.db.sharded import partition_spans
from repro_torch.io.faults import NULL_IO
from repro_torch.io.manifest import Storage

KEY_SPACE = 1 << 64


def clip_records(records, lo: int, hi: int):
    """Clip WAL records ``(key, seq, flags, exp, val)`` to ``[lo, hi)``.

    Point records outside the span are dropped; DeleteRange records are
    intersected with the span (and dropped when the intersection is
    empty). Returns a new list.
    """
    from repro_torch.db.wal import FLAG_RANGE, pack_range_hi, unpack_range_hi

    lo, hi = int(lo), int(hi)
    out = []
    for rec in records:
        k, s, fl, exp, v = rec
        k = int(k)
        if int(fl) & FLAG_RANGE:
            rhi = unpack_range_hi(v)
            l2, h2 = max(k, lo), min(rhi, hi)
            if l2 >= h2:
                continue
            if l2 != k or h2 != rhi:
                rec = (l2, s, fl, exp, pack_range_hi(h2, len(v)))
            out.append(rec)
        elif lo <= k < hi:
            out.append(rec)
    return out


def subset_state(state: dict, lo: int, hi: int) -> dict:
    """Restrict a manifest state to partitions intersecting ``[lo, hi)``.

    Partition lower bounds are clamped to ``lo`` (a store opened fresh
    labels its first partition lo=0 regardless of the span it serves);
    partitions at or above ``hi`` are dropped. Unavailable spans are
    intersected. The WAL block map is dropped — the subset is adopted
    into a store with its own WAL.
    """
    lo, hi = int(lo), int(hi)
    parts = sorted(state.get("partitions", []), key=lambda pe: int(pe["lo"]))
    spans = partition_spans([pe["lo"] for pe in parts])
    keep = []
    for pe, (plo, phi) in zip(parts, spans):
        if phi <= lo or plo >= hi:
            continue
        pe = dict(pe)
        pe["lo"] = max(int(pe["lo"]), lo)
        keep.append(pe)
    unavail = []
    for sp in state.get("unavailable", []):
        l2 = max(int(sp["lo"]), lo)
        h2 = min(int(sp["hi"]), hi)
        if l2 < h2:
            unavail.append(dict(sp, lo=l2, hi=h2))
    sub = dict(state, partitions=keep, unavailable=unavail)
    sub.pop("wal", None)
    return sub


def copy_file(src: str, dst: str, io=None, site: str = "ship") -> int:
    """Copy one immutable file with transient-fault retry; returns bytes.

    The read goes through the fault plan (``check_read``/``mutate_read``)
    so tests can inject transient EIO on the shipping path; ``io.run``
    retries within its budget. The write lands via tmp-file + rename so a
    crashed ship never leaves a half-written table at the destination.
    """
    io = NULL_IO if io is None else io

    def attempt() -> bytes:
        io.check_read(src)
        with open(src, "rb") as f:
            return io.mutate_read(src, 0, f.read())

    data = io.run(site, attempt)
    tmp = dst + ".ship-tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dst)
    return len(data)


def fetch_files(state: dict, src_storage: Storage, dst_storage: Storage,
                io=None, rename: dict | None = None) -> tuple[int, int]:
    """Copy the table/REMIX files a manifest state references.

    Two modes:

    - ``rename is None`` — preserve names and skip files the destination
      already has. This is the replica catch-up path: a manifest diff
      degenerates to "fetch whatever is new".
    - ``rename`` given (a dict, mutated in place) — every source name is
      assigned a fresh name from the destination's id space (shard merge:
      two stores' ``t-%06d`` sequences collide). Names already mapped are
      skipped, so a two-phase copy (bulk while live, delta under the
      gate) ships each immutable file exactly once.

    Returns ``(files_copied, bytes_copied)``.
    """
    from repro_torch.io.manifest import live_files

    nfiles = nbytes = 0
    for name in sorted(live_files(state)):
        is_table = name.endswith(".sst")
        src = (src_storage.table_path(name) if is_table
               else src_storage.remix_path(name))
        if rename is not None:
            if name in rename:
                continue
            new = (dst_storage.alloc_table_name() if is_table
                   else dst_storage.alloc_remix_name())
            rename[name] = new
            dst = (dst_storage.table_path(new) if is_table
                   else dst_storage.remix_path(new))
        else:
            dst = (dst_storage.table_path(name) if is_table
                   else dst_storage.remix_path(name))
            if os.path.exists(dst):
                continue
        nbytes += copy_file(src, dst, io=io)
        nfiles += 1
    return nfiles, nbytes


def ship_snapshot(db, dst_dir: str, lo: int = 0, hi: int | None = None,
                  io=None, registry=None, events=None) -> dict:
    """Ship a consistent snapshot of ``db``'s ``[lo, hi)`` span to
    ``dst_dir`` and commit a manifest there; returns a report dict.

    The snapshot is pinned for the duration, so concurrent flushes and
    compactions cannot reclaim the files being copied. The destination
    receives the source's table/REMIX files verbatim (no rewrite), a
    fresh WAL holding the clipped overlay + range tombstones at their
    original sequence numbers, and a manifest subset; opening it yields
    reads bit-identical to the snapshot.
    """
    from repro_torch.db.store import partition_entry
    from repro_torch.db.wal import WAL

    if db.storage is None:
        raise RuntimeError("snapshot shipping requires a persistent store")
    lo = int(lo)
    hi = KEY_SPACE if hi is None else int(hi)
    io = db.io if io is None else io
    registry = db.registry if registry is None else registry
    events = db.events if events is None else events
    c_bytes = registry.counter("snapshot_ship_bytes")
    c_files = registry.counter("snapshot_ship_files")

    os.makedirs(dst_dir, exist_ok=True)
    dst = Storage(dst_dir, with_ckb=db.cfg.ckb)
    if dst.manifest.current_version():
        raise ValueError(f"destination already holds a store: {dst_dir}")

    nfiles = nbytes = nrecs = 0
    with db.snapshot() as snap:
        parts = sorted(snap.version.partitions, key=lambda p: p.lo)
        spans = partition_spans([p.lo for p in parts])
        shipped = []
        for p, (plo, phi) in zip(parts, spans):
            if phi <= lo or plo >= hi:
                continue
            entry = partition_entry(p)
            entry["lo"] = max(int(entry["lo"]), lo)
            for nm in entry["tables"]:
                nbytes += copy_file(db.storage.table_path(nm),
                                    dst.table_path(nm), io=io)
                nfiles += 1
            if entry.get("remix"):
                nbytes += copy_file(db.storage.remix_path(entry["remix"]),
                                    dst.remix_path(entry["remix"]), io=io)
                nfiles += 1
            shipped.append(entry)
        if not shipped:
            # an empty shard is still a shard: commit a rowless partition
            # so recovery publishes a Version spanning [lo, hi)
            shipped = [dict(lo=lo, tables=[], remix=None, excised=[])]

        wal = WAL(dst.wal_path(), vw=db.cfg.vw)
        for k, e in sorted(snap.overlay.items()):
            if lo <= int(k) < hi:
                wal.append(int(k), int(e.seq), bool(e.tomb), e.val,
                           exp=int(e.exp))
                nrecs += 1
        for rlo, rhi, rseq in snap.ranges:
            l2, h2 = max(int(rlo), lo), min(int(rhi), hi)
            if l2 < h2:
                wal.append_range(l2, h2, int(rseq))
                nrecs += 1
        wal.sync()
        unavail = []
        for sp in getattr(snap.store, "_unavailable", []):
            l2 = max(int(sp["lo"]), lo)
            h2 = min(int(sp["hi"]), hi)
            if l2 < h2:
                unavail.append(dict(sp, lo=l2, hi=h2))
        state = dict(seq=int(snap.seq), vw=int(db.cfg.vw), d=int(db.cfg.d),
                     partitions=shipped, unavailable=unavail,
                     wal=wal.save_state())
        version = dst.commit(state)
        seq = int(snap.seq)

    c_bytes.inc(nbytes)
    c_files.inc(nfiles)
    events.emit("snapshot_ship", dst=os.path.basename(dst_dir.rstrip("/")),
                lo=str(lo), hi=str(hi), files=nfiles, bytes=nbytes,
                records=nrecs)
    return dict(dst=dst_dir, lo=lo, hi=hi, files=nfiles, bytes=nbytes,
                records=nrecs, partitions=len(shipped), seq=seq,
                version=version)
