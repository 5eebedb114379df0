"""RemixDB: the public key-value store API (paper §4).

Write path: put/delete → WAL append + MemTable (update counters). When the
MemTable exceeds its budget, ``flush()`` freezes it, routes the new data to
partitions, plans + executes compactions (abort/minor/major/split), carries
hot keys back (TRIAD-style), and garbage-collects the WAL's virtual log.

Read path: MemTable overlay first, then the owning partition's REMIX
(batched torch seek/get/scan on the store's device — no bloom filters, §4).
Recovered partitions answer from the on-disk REMIX through the block cache
(the host-only cold path) until their workload promotes them; promoted
partitions answer from device views on the card (``device_path``).

Versioned core: the store below the MemTable is a chain of immutable,
refcounted :class:`~repro_torch.db.version.Version` objects. A flush builds new
partitions *off to the side* (copy-on-write — see
``compaction.execute``), commits the manifest (the version edge), and
publishes the new Version with a pointer swap; readers holding a
:meth:`snapshot` pin their Version until dropped, so a compaction never
invalidates an in-flight read and retired tables/files are reclaimed
only when their last Version unpins. All scans run through
:class:`~repro_torch.db.cursor.RemixCursor`, the paper's §3.2 cursor over the
merged (overlay + cold + promoted) view — ``scan``/``scan_batch`` are
thin wrappers, and streaming consumers can hold one cursor instead of
re-seeking per chunk.

Operation layer (API v2): the typed entry point is
:meth:`RemixDB.submit` — build a :class:`repro_torch.db.ops.Batch` of
Get/MultiGet/Scan/Put/Delete ops (with per-op deadlines and priorities)
and get a future back; the :class:`repro_torch.db.executor.Executor` plans the
batch (stage split, shard routing, one pinned snapshot per shard) and
compiles it onto this store's physical primitives (``_get_at`` /
``_get_batch_at`` / ``_scan_group_at`` / ``_apply_writes``). Every
legacy method below (``get``/``get_batch``/``scan``/``scan_batch``/
``put``/``put_batch``/``delete``) is a thin wrapper that builds a
one-kind batch and blocks on the future, so both surfaces share one
code path and stay bit-for-bit identical.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.core import keys as CK
from repro_torch.core import query as Q
from repro_torch.db import clock
from repro_torch.db.compaction import (
    CompactionConfig,
    Plan,
    apply_abort_budget,
    execute,
    plan_partition,
)
from repro_torch.db.cursor import RemixCursor
from repro_torch.db.memtable import MemTable, entry_dead
from repro_torch.db.ops import Batch, Op, OpInterrupted
from repro_torch.db.partition import ExcisedSpan, Partition, Table
from repro_torch.db.sharded import partition_spans, route_host, route_one
from repro_torch.db.version import Snapshot, VersionSet
from repro_torch.db.wal import FLAG_RANGE, FLAG_TOMB, WAL, unpack_range_hi
from repro_torch.device import as_words, resolve, u32_np
from repro_torch.io.faults import (CorruptionError, IOContext,
                             UnavailableSpanError)
from repro_torch.obs.events import EventLog, NULL_EVENTS
from repro_torch.obs.metrics import MetricsRegistry, merge_snapshots


@dataclasses.dataclass
class RemixDBConfig:
    vw: int = 2  # value words (uint32)
    d: int = 32  # REMIX group size
    memtable_entries: int = 1 << 18
    hot_threshold: int = 8  # update count above which a key stays buffered
    compaction: CompactionConfig = dataclasses.field(
        default_factory=CompactionConfig
    )
    wal_dir: str | None = None
    use_kernels: bool = False  # route queries through the CUDA kernel path
    # in-group search mode of the plain path: "auto" picks binary probes
    # on the CPU and the vectorized all-slot compare on CUDA; results do
    # not depend on it
    ingroup: str = "auto"
    # torch device of every partition's index and of the device views;
    # the card by default, and asking for CUDA where there is none raises
    device: str = "cuda"
    # persistence root: when set, flushes write SSTables + REMIX files there
    # and commit a manifest; RemixDB.open(dir) recovers the store from it
    data_dir: str | None = None
    ckb: bool = True  # append Compressed Keys Blocks to new table files
    # block cache budget for cold reads (shared across all partitions of
    # the store; pass a BlockCache via ``block_cache`` to share it across
    # stores, e.g. from serve.KVServeEngine)
    cache_bytes: int = 64 << 20
    block_cache: object | None = dataclasses.field(default=None, repr=False)
    # serve recovered partitions via block-granular cold reads until
    # promotion, instead of loading whole tables on first query
    cold_reads: bool = True
    # promote a partition to the device RunSet once the observed cold
    # workload — physical bytes pulled OR logical row bytes served (cache
    # hits included) — reaches this fraction of its data region; the
    # decision inputs are exposed in stats()["cache"]["promotion"]
    promote_fraction: float = 0.5
    # ---- device-resident query execution (docs/ARCHITECTURE.md) ----
    # promoted-partition read routing: "auto" answers promoted reads
    # from persistent device views when the store's device is CUDA;
    # "on" forces the device path everywhere (on the CPU the kernels'
    # plain versions run — the CI parity configuration); "off" keeps the
    # legacy path (Partition.index() + the query module)
    device_path: str = "auto"
    # HBM byte budget for resident device views (LRU-evicted under
    # upload pressure; views whose partition left every live Version
    # are dropped at release). A partition that fits neither residency
    # tier falls back to the legacy path (device_fallback_total)
    device_budget_bytes: int = 256 << 20
    # batch-slice width of the host/device overlapped value pipeline
    # (index-only tier: the device resolves row windows for slice i+1
    # while the host gathers value granules for slice i)
    device_slice: int = 64
    # cold-scan pipelining (paper Fig 10): while one selector group's
    # rows are emitted, issue the next `prefetch_depth` groups'
    # value/tomb blocks into the cache; 0 = eager (fetch on demand).
    # Never reads a block the eager path would not (the selector stream
    # names exactly which rows each group touches).
    prefetch_depth: int = 1
    # block-read mode for lazy table handles: "copy" reads each verified
    # granule into heap bytes; "mmap" maps the file once and serves
    # zero-copy memoryview slices after a single checksum pass
    cache_mode: str = "copy"
    # WAL durability: "block" (default) group-commits — fsync whenever a
    # full 4 KB block is written; "always" fsyncs every put; "none" only
    # fsyncs on explicit sync()/close()
    sync_policy: str = "block"
    # per-round compaction log entries retained (ring of the last N
    # rounds); aggregate counters live in stats()["compaction"], so
    # long-running stores don't grow memory with flush count
    compaction_log_rounds: int = 64
    # run compaction + manifest commit on a background thread: flush()
    # returns right after the MemTable freeze and the round publishes
    # off-thread under the writer lock (wait_for_compaction() joins it).
    # Readers are unaffected either way (Version pointer swap).
    background_compaction: bool = False
    # resolve batched cold seeks from the prefix-compressed CKB entry
    # stream (vectorized decoder) instead of fixed-width keys-section
    # reads; False falls back to the keys-section path
    ckb_decode: bool = True
    # op-layer admission control: bytes of submitted-but-unfinished
    # batches before submit() blocks (backpressure)
    max_inflight_bytes: int = 256 << 20
    # worker threads serving async submit(); sync submissions (and the
    # legacy wrappers) execute inline and never touch them
    submit_workers: int = 2
    # ---- observability (docs/OBSERVABILITY.md) ----
    # master toggle: False hands every layer no-op instruments and a
    # null event log, removing even the counter lock acquires (the
    # registry-backed stats()/wa fields then read as zero)
    metrics: bool = True
    # fraction of op batches traced without an explicit Batch(trace=True)
    # (deterministic 1-in-round(1/rate) sampling; 0 disables)
    trace_sample_rate: float = 0.0
    # ring capacity of the structured lifecycle event log
    event_log_capacity: int = 256
    # optional JSONL sink mirroring every event append-only to disk
    event_log_path: str | None = None
    # share a MetricsRegistry across components (e.g. per-shard labelled
    # registries from a serving tier); None creates a private one
    registry: object | None = dataclasses.field(default=None, repr=False)
    # ---- durability / fault injection (docs/ARCHITECTURE.md) ----
    # deterministic fault-injection plan (repro_torch.io.FaultPlan) threaded
    # under every reader/writer of this store's files; None = no faults
    fault_plan: object | None = dataclasses.field(default=None, repr=False)
    # bounded retry budget for transient read/fsync faults (TransientIO-
    # Error): per site, with exponential backoff between attempts
    io_retries: int = 2
    io_retry_backoff_s: float = 0.0
    # background integrity scrub cadence (seconds); 0 disables the
    # thread — db.scrub(full=True) stays available synchronously
    scrub_interval_s: float = 0.0
    # byte-budget rate limit for background scrub passes (bytes/sec of
    # at-rest reads); 0 = unthrottled. Full/sync scrubs ignore it.
    scrub_bytes_per_sec: int = 0
    # age after which quarantined files (GC'd orphans + unrecoverable
    # tables) are purged for good; checked at each scrub pass and close
    quarantine_purge_age_s: float = 7 * 24 * 3600.0



def _pow2pad(n: int) -> int:
    """Next power-of-two bucket of a query batch (the reference's padding,
    kept so that the legacy path sees the same shapes)."""
    b = 8
    while b < n:
        b <<= 1
    return b


def partition_entry(p: Partition, rename=None) -> dict:
    """The manifest entry for one partition (table/REMIX file basenames
    + excised spans). ``rename`` maps basenames when the files were
    shipped under fresh names (shard merge into a dir with collisions).
    """
    nm = (lambda n: n) if rename is None else (lambda n: rename.get(n, n))
    return dict(
        lo=p.lo,
        tables=[nm(os.path.basename(t.path)) for t in p.tables],
        remix=None if p.remix_name is None else nm(p.remix_name),
        excised=[
            dict(
                lo=s.lo, hi=s.hi, seq=s.seq,
                tables=[
                    nm(os.path.basename(t.path))
                    for t in s.tables
                    if t.path is not None
                ],
            )
            for s in p.excised
        ],
    )


def partition_entry_renamed(pe: dict, rename=None) -> dict:
    """A manifest partition entry with file basenames mapped through
    ``rename`` (no-op when None/empty)."""
    if not rename:
        return pe
    out = dict(pe)
    out["tables"] = [rename.get(n, n) for n in pe["tables"]]
    if pe.get("remix"):
        out["remix"] = rename.get(pe["remix"], pe["remix"])
    out["excised"] = [
        {**se, "tables": [rename.get(n, n) for n in se.get("tables", [])]}
        for se in pe.get("excised", [])
    ]
    return out


class RemixDB:
    def __init__(self, config: RemixDBConfig | None = None):
        self.cfg = config or RemixDBConfig()
        self.device = resolve(self.cfg.device)
        # resolve the in-group search mode once; query paths only ever see
        # a valid "binary"/"vector" (a stray "auto" would raise in seek)
        mode = self.cfg.ingroup
        if mode == "auto":
            mode = "binary" if self.device.type == "cpu" else "vector"
        if mode not in ("binary", "vector"):
            raise ValueError(
                f"ingroup must be 'auto', 'binary' or 'vector', got {mode!r}"
            )
        self._ingroup = mode
        if self.cfg.cache_mode not in ("copy", "mmap"):
            raise ValueError(
                f"cache_mode must be 'copy' or 'mmap', "
                f"got {self.cfg.cache_mode!r}"
            )
        if self.cfg.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0")
        if self.cfg.device_path not in ("auto", "on", "off"):
            raise ValueError(
                f"device_path must be 'auto', 'on' or 'off', "
                f"got {self.cfg.device_path!r}"
            )
        if self.cfg.device_slice < 1:
            raise ValueError("device_slice must be >= 1")
        # observability: one registry + one lifecycle event log shared by
        # every layer this store owns (cache, WAL, versions, executor);
        # metrics=False hands out no-op instruments and a null event log
        self.registry = (
            self.cfg.registry
            if self.cfg.registry is not None
            else MetricsRegistry(enabled=self.cfg.metrics)
        )
        self.events = (
            EventLog(self.cfg.event_log_capacity,
                     jsonl_path=self.cfg.event_log_path)
            if self.cfg.metrics
            else NULL_EVENTS
        )
        # device-resident query views for promoted partitions: persistent
        # device buffers + the batched execution driver. "auto" engages
        # on CUDA; "on" forces the path (the kernels' plain versions on
        # the CPU — how CI parity-tests it)
        self.device_views = None
        if self.cfg.device_path == "on" or (
            self.cfg.device_path == "auto" and self.device.type == "cuda"
        ):
            from repro_torch.kernels.device_view import DeviceViewManager

            self.device_views = DeviceViewManager(
                self.cfg.device_budget_bytes,
                slice_width=self.cfg.device_slice,
                registry=self.registry,
                events=self.events,
                device=self.device,
            )
        self.mem = MemTable(vw=self.cfg.vw)
        # durability plumbing: one IOContext (fault plan + bounded retry)
        # threaded under every file this store reads or writes
        self._c_io_retry = self.registry.counter("io_retry")
        self._c_io_giveup = self.registry.counter("io_giveup")
        self._c_corruption = self.registry.counter("corruption_detected")
        self._c_scrub_passes = self.registry.counter("scrub_passes")
        self._c_scrub_bytes = self.registry.counter("scrub_bytes_read")
        self._c_repair_remix = self.registry.counter("repair_remix_rebuilt")
        self._c_quarantined = self.registry.counter(
            "repair_table_quarantined"
        )
        self._c_quarantine_purged = self.registry.counter(
            "quarantine_purged"
        )
        self.io = IOContext(
            plan=self.cfg.fault_plan,
            retries=self.cfg.io_retries,
            backoff_s=self.cfg.io_retry_backoff_s,
            on_retry=self._c_io_retry.inc,
            on_giveup=self._c_io_giveup.inc,
        )
        # key spans whose backing table was quarantined as unrecoverable:
        # reads over them raise UnavailableSpanError (graceful
        # degradation) instead of silently missing rows; persisted in the
        # manifest so degradation survives restarts
        self._unavailable: list[dict] = []
        self._last_scrub: dict | None = None
        self.storage = None
        self.block_cache = None
        state = None
        if self.cfg.data_dir is not None:
            from repro_torch.io.blockcache import BlockCache
            from repro_torch.io.manifest import Storage

            self.storage = Storage(self.cfg.data_dir, with_ckb=self.cfg.ckb,
                                   io=self.io)
            # explicit None check: an empty BlockCache is falsy (len == 0)
            self.block_cache = (
                self.cfg.block_cache
                if self.cfg.block_cache is not None
                else BlockCache(self.cfg.cache_bytes,
                                registry=self.registry)
            )
            state = self.storage.load_state()
            wal_path = self.storage.wal_path()
        else:
            wal_dir = self.cfg.wal_dir or tempfile.mkdtemp(prefix="remixdb-")
            os.makedirs(wal_dir, exist_ok=True)
            wal_path = os.path.join(wal_dir, "wal.log")
        self.wal = WAL(wal_path, vw=self.cfg.vw,
                       sync_policy=self.cfg.sync_policy,
                       registry=self.registry, ioctx=self.io)
        self.seq = 1
        # registry-backed accounting; the legacy attribute names
        # (user_bytes, table_bytes_written, compaction_totals, ...) are
        # read-only property views over these counters so stats() and
        # write_amplification() stay bit-compatible
        reg = self.registry
        # physical-read bytes of table handles retired with their last
        # Version, so disk_bytes_read() is monotonic across table
        # replacement
        self._c_retired_bytes = reg.counter("db_retired_disk_bytes")
        # write-amplification accounting (fig 16)
        self._c_user_bytes = reg.counter("db_user_bytes")
        self._c_table_bytes = reg.counter("db_table_bytes_written")
        self._c_comp_rounds = reg.counter("db_compaction_rounds")
        self._c_comp_bytes = reg.counter("db_compaction_bytes_written")
        # tentpole op counters (asserted in tests/test_obs.py)
        self._c_delete_range = reg.counter("delete_range")
        self._c_cas_conflict = reg.counter("cas_conflict")
        self._c_ttl_dropped = reg.counter("ttl_expired_dropped")
        self._c_rtomb_drop = reg.counter("range_tombstone_drop")
        self._comp_kinds: set[str] = set()  # plan kinds seen so far
        self._h_flush = reg.histogram("db_flush_seconds")
        reg.gauge("db_memtable_entries", fn=lambda: len(self.mem))
        reg.gauge("db_partitions", fn=lambda: len(self.partitions))
        reg.gauge(
            "db_tables",
            fn=lambda: sum(len(p.tables) for p in self.partitions),
        )
        reg.gauge("db_disk_bytes_read", fn=self.disk_bytes_read)
        reg.multi_gauge(
            "db_partition_cold_gets",
            fn=lambda: [
                (dict(lo=str(p.lo)), p.cold_gets) for p in self.partitions
            ],
        )
        reg.multi_gauge(
            "db_partition_cold_scans",
            fn=lambda: [
                (dict(lo=str(p.lo)), p.cold_scans) for p in self.partitions
            ],
        )
        reg.gauge("ckb_memo_entries", fn=lambda: self._ckb_memo("entries"))
        reg.gauge("ckb_memo_bytes", fn=lambda: self._ckb_memo("bytes"))
        reg.gauge(
            "ckb_memo_evictions", fn=lambda: self._ckb_memo("evictions")
        )
        # last-N compaction rounds (ring); lifetime aggregates live in
        # the registry counters above (see the compaction_totals view)
        self.compaction_log: collections.deque = collections.deque(
            maxlen=max(1, self.cfg.compaction_log_rounds)
        )
        # one writer at a time; readers never take this lock — they pin
        # a Version and proceed. Reentrant because a publish inside
        # flush() releases the old Version, whose hook may reach
        # _gc_files on the same thread.
        self._flush_lock = threading.RLock()
        # serializes the write path end-to-end (seq allocation + WAL
        # append + MemTable apply) against other writers and against the
        # compaction round's WAL GC / checkpoint — with async submit()
        # several executor workers may write concurrently
        self._write_lock = threading.Lock()
        # serializes flush scheduling (freeze + background hand-off)
        self._flush_gate = threading.Lock()
        # guards the (_bg_thread, _bg_error) handoff: wait_for_compaction
        # is public and may race a writer-triggered flush() installing
        # the next round's thread
        self._bg_lock = threading.Lock()
        self._bg_thread: threading.Thread | None = None
        self._bg_error: BaseException | None = None
        # op-layer executor, created on first submit()/wrapper call
        self._ops_engine = None
        self._engine_lock = threading.Lock()
        self._in_flush = False  # file GC defers to flush-end while set
        # names of files being copied into this directory that no Version
        # references yet (a shard merge's or a replica catch-up's fetch);
        # file GC treats them as live. The lock spans a whole collection,
        # so a name reserved after it returns is seen by every later one.
        self._incoming: set[str] = set()
        self._incoming_lock = threading.Lock()
        # guards the (current Version, overlay source, seq) triple that
        # snapshots capture, against the flush's freeze/publish edges
        self._state_lock = threading.Lock()
        # while a flush is compacting, readers overlay the *frozen*
        # MemTable (the data mid-compaction) instead of the drained live
        # one — a snapshot taken mid-flush must still see pre-flush state
        self._flush_overlay: dict | None = None
        # the frozen MemTable's range tombstones, visible to readers for
        # the same window: they become partition excised spans at publish
        self._flush_ranges: list | None = None
        self.versions = VersionSet(on_release=self._on_version_release,
                                   registry=self.registry)
        self.versions.publish(
            [Partition(lo=0, d=self.cfg.d, device=self.device)], seq_horizon=0
        )
        if state is not None:
            self._recover(state)
        elif self.storage is not None:
            # fresh directory (or crashed before the first commit): any
            # table/REMIX files present are orphans of an uncommitted
            # flush, but WAL blocks written before the crash are real
            # acknowledged data — adopt and replay them (empty checkpoint,
            # so every written block shows as an epoch flip)
            self.storage.gc_orphans(set())
            if self.wal.recover_tail():
                self._replay_wal()
        # optional background scrubber (rate-limited integrity pass)
        self._scrub_stop = threading.Event()
        self._scrub_thread: threading.Thread | None = None
        if self.storage is not None and self.cfg.scrub_interval_s > 0:
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="remixdb-scrub", daemon=True
            )
            self._scrub_thread.start()

    def _scrub_loop(self) -> None:
        while not self._scrub_stop.wait(self.cfg.scrub_interval_s):
            try:
                self.scrub(full=False)
            except Exception:
                # scrubbing must never take the store down; failures are
                # visible through io_giveup / events
                pass

    @classmethod
    def open(cls, data_dir: str, config: RemixDBConfig | None = None
             ) -> "RemixDB":
        """Open (or create) a persistent RemixDB rooted at ``data_dir``:
        recovers partitions from the committed manifest and replays the
        WAL tail on top (§4.3)."""
        cfg = config or RemixDBConfig()
        cfg = dataclasses.replace(cfg, data_dir=data_dir)
        return cls(cfg)

    @property
    def partitions(self):
        """The current Version's partitions (immutable tuple). Mutating
        store state goes through ``flush()``/``VersionSet.publish``."""
        return self.versions.current.partitions

    # ---- registry-backed views of the legacy accounting attributes ----
    @property
    def user_bytes(self) -> int:
        return self._c_user_bytes.value

    @property
    def table_bytes_written(self) -> int:
        return self._c_table_bytes.value

    @property
    def _retired_disk_bytes(self) -> int:
        return self._c_retired_bytes.value

    @property
    def compaction_totals(self) -> dict:
        kinds = {}
        for k in sorted(self._comp_kinds):
            v = self.registry.counter("compaction_plans", kind=k).value
            if v:
                kinds[k] = v
        return dict(
            rounds=self._c_comp_rounds.value,
            kinds=kinds,
            bytes_written=self._c_comp_bytes.value,
        )

    def _ckb_memo(self, field: str) -> int:
        """Aggregate CKB interval-memo accounting over resident readers
        (header-cheap: never materializes a reader)."""
        total = 0
        for p in self.partitions:
            for t in p.tables:
                ck = getattr(t, "_ckb", None)
                if ck is not None:
                    total += ck.memo_stats()[field]
        return total

    def _recover(self, state: dict) -> None:
        """Rebuild partitions/WAL/MemTable from a committed manifest."""
        from repro_torch.io.manifest import live_files

        if int(state.get("vw", self.cfg.vw)) != self.cfg.vw:
            raise ValueError(
                f"data dir has vw={state['vw']}, config has vw={self.cfg.vw}"
            )
        # files a crashed flush wrote but never committed are orphans:
        # collect them before building table handles over the directory
        self.storage.gc_orphans(live_files(state))
        # adopt the persisted group size: the on-disk REMIXes were built
        # with it and the cold path serves them directly — keeping a
        # mismatched cfg.d would make cold and promoted query windows
        # cover different slot counts (vw, by contrast, changes the value
        # API shape, so a mismatch there is an error)
        d_disk = int(state.get("d", self.cfg.d))
        if d_disk != self.cfg.d:
            self.cfg = dataclasses.replace(self.cfg, d=d_disk)
        parts: list[Partition] = [
            self._build_partition(pe) for pe in state["partitions"]
        ]
        # degraded spans (quarantined tables) survive restarts
        self._unavailable = [dict(s) for s in state.get("unavailable", [])]
        if not parts:
            parts = [Partition(lo=0, d=self.cfg.d, device=self.device)]
        self.seq = int(state.get("seq", 1))
        # publishing releases the construction placeholder, whose release
        # hook garbage-collects files the manifest doesn't reference
        self.versions.publish(
            sorted(parts, key=lambda p: p.lo), seq_horizon=self.seq
        )
        self.wal.restore_state(state["wal"])
        self.wal.recover_tail()
        self._replay_wal()
        self.events.emit("recover", partitions=len(parts),
                         memtable=len(self.mem))

    def _build_partition(self, pe: dict) -> Partition:
        """One Partition (table handles + excised spans + preloaded
        REMIX) from its manifest entry — shared by recovery, replica
        catch-up adoption, and shard absorption."""
        from repro_torch.io.remix_io import load_remix

        tables = []
        for nm in pe["tables"]:
            t = Table.from_file(
                self.storage.table_path(nm),
                cache_mode=self.cfg.cache_mode,
                ckb_decode=self.cfg.ckb_decode,
            )
            t.attach_cache(self.block_cache)
            t.attach_io(self.io)
            tables.append(t)
        p = Partition(lo=int(pe["lo"]), tables=tables, d=self.cfg.d,
                      device=self.device)
        by_name = dict(zip(pe["tables"], tables))
        for se in pe.get("excised", []):
            span_tabs = tuple(
                by_name[nm] for nm in se["tables"] if nm in by_name
            )
            if span_tabs:
                p.excised.append(ExcisedSpan(
                    int(se["lo"]), int(se["hi"]), int(se["seq"]),
                    span_tabs,
                ))
        if pe.get("remix"):
            p.remix_name = pe["remix"]
            try:
                # into host memory: the cold path walks it there, and the
                # partition's first device build moves it to the card
                p.preload_index(
                    load_remix(self.storage.remix_path(pe["remix"]),
                               io=self.io, device="cpu")
                )
            except CorruptionError as e:
                # a corrupt REMIX never blocks open: queries rebuild
                # the index from the (verified) tables, and the next
                # scrub() re-persists it from the CKBs
                self._c_corruption.inc()
                self.events.emit(
                    "corruption", target="remix",
                    file=os.path.basename(e.file),
                    section=e.section, blocks=[], detail=e.detail,
                )
        return p

    def _replay_wal(self) -> None:
        """Rebuild the MemTable from the WAL's live log; advance seq past
        every replayed record and the WAL's durable sequence horizon."""
        self.mem = self.recover_memtable()
        for e in self.mem.data.values():
            self.seq = max(self.seq, e.seq + 1)
        self.seq = max(self.seq, self.wal.max_seq + 1)

    def _commit(self, parts) -> None:
        """Durably publish ``parts`` as the next manifest version — the
        version edge (atomic rename commit, §4.3)."""
        state = dict(
            seq=int(self.seq),
            vw=self.cfg.vw,
            d=self.cfg.d,
            partitions=[partition_entry(p) for p in parts],
            wal=self.wal.save_state(),
            unavailable=[dict(s) for s in self._unavailable],
        )
        self.storage.commit(state)

    def _gc_files(self, from_flush: bool = False) -> None:
        """Reclaim table/REMIX files no live Version references.

        The live set spans *every* pinned Version, not only the
        committed one: files superseded by a commit survive until the
        last snapshot reading them unpins (no mid-read deletion), then
        the release hook calls back here. Never interleaves with a
        flush mid-write — fresh tables (and ``.tmp`` staging files)
        belong to no Version until publish and would be collected as
        orphans: other threads block on the flush lock, and a release
        reached *from inside* the flush (same thread, via publish or a
        snapshot finalizer) defers to the collection flush() itself
        runs after publishing.
        """
        if self._in_flush and not from_flush:
            return  # fast path: flush-end gc will cover it
        # non-blocking from release hooks: a reader dropping the last pin
        # right as a flush starts must not stall for the whole compaction.
        # Skipping is safe — files are immutable orphans once unreferenced
        # and the next collection (flush end, close, open) reclaims them.
        if not self._flush_lock.acquire(blocking=from_flush):
            return
        try:
            if self._in_flush and not from_flush:
                return
            live: set[str] = set()
            for v in self.versions.live_versions():
                live |= v.file_names()
            with self._incoming_lock:
                removed = self.storage.gc_orphans(live | self._incoming)
            if removed:
                self.events.emit("file_gc", removed=len(removed))
        finally:
            self._flush_lock.release()

    def reserve_incoming(self, name: str) -> None:
        """Keep file GC away from ``name`` until :meth:`release_incoming`:
        call before the file's bytes land in this store's directory."""
        with self._incoming_lock:
            self._incoming.add(name)

    def release_incoming(self, names) -> None:
        """Drop reservations made by :meth:`reserve_incoming`."""
        with self._incoming_lock:
            self._incoming.difference_update(names)

    def abandon_incoming(self, names) -> None:
        """Release the reservations of a copy that failed and delete its
        files (and staging leftovers), except any that a Version or the
        committed manifest already names."""
        from repro_torch.io.manifest import live_files

        names = set(names)
        with self._flush_lock:
            live = live_files(self.storage.load_state() or {})
            for v in self.versions.live_versions():
                live |= v.file_names()
            self.release_incoming(names)
            for name in names - live:
                path = (self.storage.table_path(name) if name.endswith(".sst")
                        else self.storage.remix_path(name))
                for f in (path, path + ".ship-tmp"):
                    if os.path.exists(f):
                        os.remove(f)

    def _on_version_release(self, version, remaining) -> None:
        """A Version's last pin dropped: fold the physical-read counters
        of tables only it referenced, then drop their files."""
        live_ids = {id(t) for v in remaining for t in v.tables()}
        retired = sum(
            t._reader.disk_bytes_read
            for t in version.tables()
            if id(t) not in live_ids and t._reader is not None
        )
        if retired:  # hooks run on whichever thread unpins
            self._c_retired_bytes.inc(retired)
        if self.device_views is not None:
            # device-side leg of the pin lifecycle: views whose partition
            # is in no live Version release their HBM with the Version
            self.device_views.retain(
                {id(p) for v in remaining for p in v.partitions}
            )
        if self.storage is not None:
            self._gc_files()

    def close(self) -> None:
        """Flush WAL buffers and, in persistent mode, commit a manifest so
        reopening needs no tail scan. The MemTable stays in the WAL. Frees
        the store's device views and its partitions' device indexes."""
        if self._scrub_thread is not None:
            self._scrub_stop.set()
            self._scrub_thread.join(timeout=5.0)
            self._scrub_thread = None
        if self._ops_engine is not None:
            self._ops_engine.close()
        if self.cfg.background_compaction:
            self.wait_for_compaction()
        self.wal.sync()
        if self.storage is not None:
            self._commit(self.versions.current.partitions)
            self.wal.release_quarantine()
            self._gc_files()
        self.events.close()
        # release the card now: a store sits in reference cycles, so its
        # views and indexes would otherwise wait for the cyclic collector
        # (the reference keeps them until gc.collect()). A partition read
        # after close() rebuilds its index lazily.
        if self.device_views is not None:
            self.device_views.clear()
        for v in self.versions.live_versions():
            for p in v.partitions:
                p.release_device()

    # ---------------- durability: scrub / repair / health ----------------
    def scrub(self, full: bool = True, repair: bool = True) -> dict:
        """One integrity pass over the committed state; self-heals.

        Verifies every table checksum granule, every persisted REMIX and
        manifest/CURRENT agreement against a pinned Version (concurrent
        flushes never race it). ``full=True`` runs unthrottled (the
        synchronous operator call); ``full=False`` paces reads at
        ``cfg.scrub_bytes_per_sec`` (the background loop). With
        ``repair=True`` a corrupt REMIX is rebuilt from the tables' CKBs
        (§3.4 redundancy) and committed as a new manifest version, and a
        table with unrecoverable granules is quarantined — dropped from
        the manifest with its key span recorded so reads over it degrade
        to :class:`UnavailableSpanError` instead of silently missing
        rows. Also age-purges the quarantine directory. Returns the
        :class:`~repro_torch.db.scrub.ScrubReport` as a dict.
        """
        from repro_torch.db.scrub import RateLimiter, scrub_version

        if self.storage is None:
            return dict(clean=True, files_checked=0, bytes_read=0,
                        findings=[], repaired=[], quarantined=[],
                        duration_s=0.0)
        limiter = RateLimiter(0 if full else self.cfg.scrub_bytes_per_sec)
        with self.snapshot() as snap:
            rep = scrub_version(self.storage, snap.version.partitions,
                                limiter)
        self._c_scrub_passes.inc()
        self._c_scrub_bytes.inc(rep.bytes_read)
        if rep.findings:
            self._c_corruption.inc(len(rep.findings))
            for f in rep.findings:
                fd = f.to_dict()
                fd["target"] = fd.pop("kind")  # "kind" is emit()'s own
                self.events.emit("corruption", **fd)
            if repair:
                self._repair(rep)
        purged = self.storage.purge_quarantine(
            self.cfg.quarantine_purge_age_s
        )
        if purged:
            self._c_quarantine_purged.inc(len(purged))
            self.events.emit("quarantine_purge", removed=len(purged))
        out = rep.to_dict()
        self._last_scrub = dict(
            clean=out["clean"],
            files_checked=out["files_checked"],
            bytes_read=out["bytes_read"],
            findings=len(rep.findings),
            repaired=len(rep.repaired),
            quarantined=len(rep.quarantined),
        )
        self.events.emit("scrub", **self._last_scrub)
        return out

    def _table_span(self, p: Partition, t: Table) -> tuple[int, int | None]:
        """Inclusive key span a quarantined table may have covered.

        Prefers the table's own first/last key (via the CKB); if those
        bytes are themselves unreadable, degrade the whole partition
        span — over-refusing is safe, silently missing rows is not.
        """
        try:
            lo = int(CK.unpack_u64(t.key_at(0)))
            hi = int(CK.unpack_u64(t.key_at(t.n - 1)))
            return lo, hi
        except Exception:
            parts = self.partitions
            idx = next(
                (i for i, q in enumerate(parts) if q is p), None
            )
            if idx is not None and idx + 1 < len(parts):
                return parts[idx].lo, parts[idx + 1].lo - 1
            return (p.lo, None)

    def _repair(self, rep) -> None:
        """Apply repairs for a scrub's findings via a manifest version
        edge (never in place): REMIX rebuild from CKBs for ``remix``
        findings, quarantine + degraded-span bookkeeping for ``table``
        findings. ``manifest`` findings are surfaced only — the manifest
        is the root of trust, there is nothing to rebuild it from.
        """
        from repro_torch.db.scrub import rebuild_remix

        bad_tables = {
            f.file for f in rep.findings if f.kind == "table"
        }
        bad_remix = {
            os.path.basename(f.file)
            for f in rep.findings if f.kind == "remix"
        }
        if not bad_tables and not bad_remix:
            return
        with self._flush_lock:
            parts = self.versions.current.partitions
            new_parts: list[Partition] = []
            changed = False
            for p in parts:
                bad_in_p = [t for t in p.tables if t.path in bad_tables]
                remix_bad = bool(p.remix_name) and p.remix_name in bad_remix
                if not bad_in_p and not remix_bad:
                    new_parts.append(p)
                    continue
                changed = True
                for t in bad_in_p:
                    lo, hi = self._table_span(p, t)
                    nm = os.path.basename(t.path)
                    self._unavailable.append(
                        dict(lo=int(lo),
                             hi=None if hi is None else int(hi),
                             tables=[nm])
                    )
                    self._c_quarantined.inc()
                    rep.quarantined.append(nm)
                    self.events.emit("quarantine", file=nm, lo=int(lo),
                                     hi=hi if hi is None else int(hi))
                keep = [t for t in p.tables if t.path not in bad_tables]
                p2 = p.clone_with_tables(keep)
                if keep and (remix_bad or bad_in_p):
                    # rebuild the index from the surviving tables' CKBs
                    # (no value bytes read) and persist it under a fresh
                    # name — the corrupt file is never overwritten
                    remix = rebuild_remix(
                        keep, d=max(self.cfg.d, len(keep))
                    )
                    nm = self.storage.write_remix(remix)
                    p2.remix_name = nm
                    p2.preload_index(remix)
                    if remix_bad:
                        self._c_repair_remix.inc()
                        rep.repaired.append(nm)
                        self.events.emit("repair", target="remix",
                                         partition=int(p.lo), file=nm)
                new_parts.append(p2)
            if not changed:
                return
            # the version edge: commit, publish, then GC — dropped files
            # move to quarantine/ once their last pinned Version releases
            with self._write_lock:
                self._commit(new_parts)
            with self._state_lock:
                self.versions.publish(new_parts, seq_horizon=self.seq)
            self._gc_files(from_flush=True)

    def health(self) -> dict:
        """Operator-facing durability summary: degradation status, the
        unavailable key spans, quarantine backlog, and the retry /
        corruption / scrub / repair counters."""
        qdir = (
            self.storage.quarantine_dir if self.storage is not None
            else None
        )
        qfiles = (
            len(os.listdir(qdir))
            if qdir is not None and os.path.isdir(qdir) else 0
        )
        parts = self.partitions
        pl = []
        for i, p in enumerate(parts):
            p_hi = parts[i + 1].lo - 1 if i + 1 < len(parts) else None
            deg = any(
                (p_hi is None or int(s["lo"]) <= p_hi)
                and (s.get("hi") is None or p.lo <= int(s["hi"]))
                for s in self._unavailable
            )
            pl.append(dict(lo=int(p.lo), tables=len(p.tables),
                           degraded=deg))
        return dict(
            status="degraded" if self._unavailable else "ok",
            unavailable=[dict(s) for s in self._unavailable],
            quarantine_files=qfiles,
            partitions=pl,
            io=dict(retries=self._c_io_retry.value,
                    giveups=self._c_io_giveup.value),
            corruption_detected=self._c_corruption.value,
            scrub=dict(passes=self._c_scrub_passes.value,
                       bytes_read=self._c_scrub_bytes.value,
                       last=self._last_scrub),
            repair=dict(
                remix_rebuilt=self._c_repair_remix.value,
                tables_quarantined=self._c_quarantined.value,
                quarantine_purged=self._c_quarantine_purged.value,
            ),
        )

    # ---------------- operation layer (API v2) ----------------
    def engine(self):
        """This store's op-layer :class:`repro_torch.db.executor.Executor`
        (one shard: the store itself), created on first use."""
        if self._ops_engine is None:
            with self._engine_lock:
                if self._ops_engine is None:
                    from repro_torch.db.executor import Executor

                    self._ops_engine = Executor(
                        [(0, self)],
                        max_inflight_bytes=self.cfg.max_inflight_bytes,
                        workers=self.cfg.submit_workers,
                        registry=self.registry,
                        events=self.events,
                        trace_sample_rate=self.cfg.trace_sample_rate,
                    )
        return self._ops_engine

    def submit(self, batch, *, sync: bool = False):
        """Submit a typed op :class:`~repro_torch.db.ops.Batch`; returns a
        future resolving to a :class:`~repro_torch.db.ops.BatchResult`. The
        single entry point every read/write below compiles onto."""
        return self.engine().submit(batch, sync=sync)

    def _run_one(self, op: Op):
        """Wrapper helper: one-op batch, inline, unwrap or re-raise."""
        r = self.engine().submit(Batch([op]), sync=True).result().results[0]
        r.raise_if_error()
        return r

    # ---------------- write path ----------------
    def put(self, key: int, val, ttl: float | None = None) -> None:
        # eager shape/dtype validation so bad input raises here, with
        # the original exception type, not inside the executor
        val = np.asarray(val, np.uint32).reshape(self.cfg.vw)
        self._run_one(Op.put(int(key), val, ttl=ttl))

    def delete(self, key: int) -> None:
        self._run_one(Op.delete(int(key)))

    def delete_range(self, start: int, end: int) -> None:
        """Delete every key in [start, end) with one range tombstone."""
        self._run_one(Op.delete_range(int(start), int(end)))

    def cas(self, key: int, expect, val, ttl: float | None = None):
        """Compare-and-swap: install ``val`` (or delete it, when ``val``
        is None) iff the key's current value equals ``expect`` (None =
        expect-absent). Returns ``(ok, actual)`` — ``actual`` is the
        conflicting current value (None when absent) on failure."""
        r = self._run_one(Op.cas(int(key), expect, val, ttl=ttl))
        return bool(r.found), r.value

    def put_batch(self, keys, vals, ttl=None) -> None:
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32).reshape(len(keys), self.cfg.vw)
        self._run_one(Op.put(keys, vals, ttl=ttl))

    def _apply_writes(self, keys, vals, tombs, exps=None) -> None:
        """The physical write primitive: one group-committed row chunk.

        A single WAL ``append_batch`` (group commit under the configured
        ``sync_policy``) plus the MemTable apply, in row order, under the
        write lock — ``put``/``delete``/``put_batch`` are one-chunk
        special cases and a mixed op batch's write stage lands here once
        per shard. The flush trigger runs after the lock is released so
        a triggered compaction never deadlocks against the writer."""
        keys = np.asarray(keys, np.uint64)
        n = len(keys)
        if n == 0:
            return
        vals = np.asarray(vals, np.uint32).reshape(n, self.cfg.vw)
        tombs = np.asarray(tombs, bool)
        exps = (
            np.zeros(n, np.uint32) if exps is None
            else np.broadcast_to(
                np.asarray(exps, np.uint32), (n,)
            ).copy()
        )
        with self._write_lock:
            seqs = np.arange(self.seq, self.seq + n, dtype=np.uint64)
            self.wal.append_batch(keys, seqs, tombs, vals, exps=exps)
            # MemTable inserts take the state lock so concurrent readers
            # can materialize a stable view of the live overlay (cursor
            # seeks iterate it; dict iteration must not race a resize)
            with self._state_lock:
                self.seq = self.mem.put_batch(keys, vals, self.seq,
                                              tomb=tombs, exp=exps)
            self._c_user_bytes.inc(n * (8 + 4 * self.cfg.vw))
        self._maybe_flush()

    def _apply_delete_range(self, lo: int, hi: int) -> None:
        """Physical primitive for one DeleteRange op: a single WAL range
        record + the MemTable range tombstone, under the write lock."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return
        with self._write_lock:
            s = self.seq
            self.wal.append_range(lo, hi, s)
            with self._state_lock:
                self.mem.delete_range(lo, hi, s)
                self.seq = s + 1
            self._c_user_bytes.inc(8 + 4 * self.cfg.vw)
        self._c_delete_range.inc()
        self._maybe_flush()

    def _apply_cas(self, key: int, expect, val, exp: int = 0):
        """Physical primitive for one Cas op. Atomicity rides the write
        lock: the read of the current committed value and the conditional
        append happen with every other writer excluded. Returns
        ``(ok, actual)`` where ``actual`` is the pre-op value (None when
        absent) — reported back on conflict."""
        key = int(key)
        with self._write_lock:
            with self._view() as v:
                cur = self._get_at(v, key)
            if expect is None:
                ok = cur is None
            else:
                ok = cur is not None and np.array_equal(
                    np.asarray(cur, np.uint32).reshape(-1),
                    np.asarray(expect, np.uint32).reshape(-1),
                )
            if not ok:
                self._c_cas_conflict.inc()
                return False, cur
            tomb = val is None
            row = (
                np.zeros((1, self.cfg.vw), np.uint32)
                if tomb
                else np.asarray(val, np.uint32).reshape(1, self.cfg.vw)
            )
            seqs = np.array([self.seq], np.uint64)
            self.wal.append_batch(
                np.array([key], np.uint64), seqs, np.array([tomb]), row,
                exps=np.array([exp], np.uint32),
            )
            with self._state_lock:
                self.seq = self.mem.put_batch(
                    np.array([key], np.uint64), row, self.seq,
                    tomb=np.array([tomb]), exp=np.array([exp], np.uint32),
                )
            self._c_user_bytes.inc(8 + 4 * self.cfg.vw)
        self._maybe_flush()
        return True, cur

    def _maybe_flush(self):
        if len(self.mem) >= self.cfg.memtable_entries:
            self.flush()

    # ---------------- flush / compaction ----------------
    def flush(self) -> dict:
        """Freeze the MemTable and run one compaction round (§4.2),
        building the next Version off to the side.

        Readers are never blocked or invalidated: live partitions are
        not mutated (copy-on-write ``execute``), the manifest commit is
        the durable version edge, and only then is the new Version
        published with a pointer swap. Snapshots opened before the flush
        keep serving the old Version until they close.

        With ``background_compaction`` this returns right after the
        freeze (``{"kinds": {}, "background": True}``): the compaction +
        manifest commit + publish run on a background thread under the
        writer lock, at most one round in flight — a second flush (or
        ``close``/``wait_for_compaction``) joins the pending round
        first. Reads during the round see the frozen overlay + the old
        Version, exactly like a reader that raced a synchronous flush.
        """
        if not self.cfg.background_compaction:
            with self._flush_lock:
                return self._flush_locked()
        with self._flush_gate:
            self.wait_for_compaction()
            with self._flush_lock:
                frozen = self._freeze()
            if frozen is None:
                return dict(kinds={})
            t = threading.Thread(
                target=self._bg_compact, args=frozen, daemon=True
            )
            with self._bg_lock:
                self._bg_thread = t
            t.start()
        return dict(kinds={}, background=True)

    def wait_for_compaction(self) -> None:
        """Join the in-flight background compaction round, if any;
        re-raises its failure. No-op in synchronous mode."""
        with self._bg_lock:
            t = self._bg_thread
        if t is not None:
            t.join()
        with self._bg_lock:
            # only clear the round we joined: a concurrent flush() may
            # already have installed the next round's thread
            if self._bg_thread is t:
                self._bg_thread = None
            err, self._bg_error = self._bg_error, None
        if err is not None:
            raise err

    def _bg_compact(self, *frozen) -> None:
        try:
            with self._flush_lock:
                self._compact(*frozen)
        except BaseException as e:  # surfaced by wait_for_compaction()
            self._bg_error = e
        finally:
            with self._state_lock:
                self._flush_overlay = None
                self._flush_ranges = None
                self._in_flush = False

    def _freeze(self):
        """Swap in a fresh MemTable and install the frozen overlay; the
        start-of-flush edge shared by both flush modes. Returns the
        ``_compact`` arguments, or None when there is nothing to flush."""
        with self._state_lock:
            keys, vals, seq, tomb, counts, exp = self.mem.to_arrays()
            if len(keys) == 0 and not self.mem.ranges:
                return None
            hot = counts > self.cfg.hot_threshold
            frozen = self.mem
            # freeze edge: from here until publish, readers overlay the
            # frozen entries — pairing the old Version with the drained
            # live MemTable would make the data under compaction invisible
            self.mem = MemTable(vw=self.cfg.vw)
            self._flush_overlay = frozen.data
            self._flush_ranges = list(frozen.ranges)
            self._in_flush = True
        self.events.emit("flush", entries=int(len(keys)),
                         hot=int(hot.sum()), ranges=len(frozen.ranges))
        return (frozen, keys, vals, seq, tomb, exp, hot)

    def _flush_locked(self) -> dict:
        frozen = self._freeze()
        if frozen is None:
            return dict(kinds={})
        try:
            return self._compact(*frozen)
        finally:
            with self._state_lock:
                self._flush_overlay = None
                self._flush_ranges = None
                self._in_flush = False

    def _fold_flush_ranges(self, p: Partition, span, ranges) -> Partition:
        """Clip this flush's range tombstones to one partition and fold
        them in, returning a clone: tables falling entirely inside a
        range are dropped whole (their files are never read again), the
        remainder get an excised span pinned to the surviving tables."""
        plo, phi = span
        clipped = [
            (max(lo, plo), min(hi, phi), s)
            for lo, hi, s in ranges
            if max(lo, plo) < min(hi, phi)
        ]
        if not clipped:
            return p
        keep, dropped = [], 0
        for t in p.tables:
            if t.n and any(
                rl <= int(CK.unpack_u64(t.key_at(0)))
                and int(CK.unpack_u64(t.key_at(t.n - 1))) < rh
                for rl, rh, _ in clipped
            ):
                dropped += 1
            else:
                keep.append(t)
        base = p
        # table list unchanged: the persisted REMIX still describes the
        # clone exactly (covered rows are hidden structurally at read
        # time), so the cold-serving state survives the fold
        p = p.clone_with_tables(keep, carry_built=not dropped)
        if not dropped:
            p.remix_name = base.remix_name
        else:
            self._c_rtomb_drop.inc(dropped)
            self.events.emit("range_tombstone_drop", lo=int(p.lo),
                             tables=int(dropped))
        for rl, rh, rs in clipped:
            p.attach_excised(rl, rh, rs)
        return p

    def _compact(self, frozen, keys, vals, seq, tomb, exp, hot) -> dict:
        t_round = time.monotonic()
        # hot keys skip compaction; carried over with halved counters
        # (under the state lock: with background compaction, writers may
        # be inserting into the live MemTable concurrently)
        with self._state_lock:
            for k in np.asarray(keys[hot], np.uint64).tolist():
                self.mem.carry_over(int(k), frozen.data[int(k)])
        keys, vals, seq, tomb, exp = (
            keys[~hot], vals[~hot], seq[~hot], tomb[~hot], exp[~hot],
        )
        # route new data to partitions of the current version; range
        # tombstones frozen with this MemTable fold into per-partition
        # excised spans (on clones — published only at the version edge)
        base = self.versions.current.partitions
        spans = partition_spans([p.lo for p in base])
        pidx = route_host([p.lo for p in base], keys)
        plans: list[Plan] = []
        clones: list[Partition] = []
        for i, p in enumerate(base):
            m = pidx == i
            if frozen.ranges:
                p = self._fold_flush_ranges(p, spans[i], frozen.ranges)
            clones.append(p)
            t = Table(keys=keys[m], vals=vals[m], seq=seq[m], tomb=tomb[m],
                      exp=exp[m])
            plans.append(plan_partition(p, t, self.cfg.compaction))
        apply_abort_budget(plans, self.cfg.compaction)
        kinds: dict[str, int] = {}
        round_bytes = 0
        new_parts: list[Partition] = []
        for p, pl in zip(clones, plans):
            kinds[pl.kind] = kinds.get(pl.kind, 0) + 1
            res = execute(pl, self.cfg.compaction, storage=self.storage,
                          registry=self.registry)
            self._c_table_bytes.inc(res.bytes_written)
            round_bytes += res.bytes_written
            if res.rows_expired:
                self._c_ttl_dropped.inc(res.rows_expired)
            if res.carried is not None:  # aborted: back into the MemTable
                with self._state_lock:
                    for j in range(res.carried.n):
                        e = frozen.data[int(res.carried.keys[j])]
                        self.mem.carry_over(int(res.carried.keys[j]), e)
            if res.new_partitions is not None:
                new_parts.extend(res.new_partitions)
            else:
                new_parts.append(p)
        new_parts.sort(key=lambda p: p.lo)
        # WAL GC: only carried/hot keys (plus anything written since the
        # freeze) remain live in the log (§4.3). The write lock stalls
        # concurrent appenders for the GC + checkpoint window so no
        # record can land between the live-key snapshot and the rewrite
        # — a put that misses the snapshot would otherwise be dropped
        # from the log while only existing in the volatile MemTable.
        # In persistent mode freed blocks stay quarantined until the new
        # mapping table is committed with the manifest: a crash in between
        # must still be able to replay the previous checkpoint's blocks.
        with self._write_lock:
            with self._state_lock:
                live_keys = set(self.mem.data.keys())
                live_range_seqs = {s for _, _, s in self.mem.ranges}
            self.wal.gc(live_keys, defer_free=self.storage is not None,
                        live_range_seqs=live_range_seqs)
            self.events.emit("wal_gc", live_keys=len(live_keys),
                             used_blocks=self.wal.used_blocks())
            if self.storage is not None:
                self._commit(new_parts)  # the version edge
                self.events.emit("wal_checkpoint",
                                 blocks=self.wal.used_blocks())
        # pointer swap: readers pinning the old Version keep it alive
        # (with no pins its exclusively-owned files are reclaimed at the
        # flush-end gc below); the frozen overlay retires in the same
        # critical section so no reader pairs the new Version with it
        with self._state_lock:
            v = self.versions.publish(new_parts, seq_horizon=self.seq)
            self._flush_overlay = None
            self._flush_ranges = None
        self.events.emit("version_publish", vid=v.vid,
                         partitions=len(new_parts))
        if self.storage is not None:
            with self._write_lock:
                self.wal.release_quarantine()
            self._gc_files(from_flush=True)
        stats = dict(kinds=kinds)
        self.compaction_log.append(stats)
        self._c_comp_rounds.inc()
        self._c_comp_bytes.inc(round_bytes)
        self._comp_kinds.update(kinds)
        dt = time.monotonic() - t_round
        self._h_flush.observe(dt)
        self.events.emit("compaction", kinds=dict(kinds),
                         bytes_written=int(round_bytes),
                         duration_s=round(dt, 6))
        return stats

    # ---------------- replication / cluster ----------------
    def replication_snapshot(self, from_seq: int = 0,
                             version: int | None = None):
        """Atomically capture what a follower needs to catch up:
        ``(manifest state, live WAL records after from_seq, committed
        manifest version)``.

        When ``version`` matches the committed manifest version the
        state is returned as ``None`` and the records are the WAL tail
        past ``from_seq`` (the cheap steady-state path); otherwise the
        full committed state plus *all* live records are returned so the
        follower can adopt the new file set and rebuild its overlay.
        The write lock serializes against concurrent appends, WAL GC,
        and flush commits, so state and records are always consistent
        with each other.
        """
        if self.storage is None:
            raise RuntimeError("replication needs a persistent store "
                               "(data_dir)")
        with self._write_lock:
            cur = self.storage.manifest.current_version()
            if version is not None and int(version) == cur:
                return None, list(self.wal.read_from(from_seq)), cur
            return self.storage.load_state(), \
                list(self.wal.read_from(0)), cur

    def apply_replication(self, records, advance_to: int | None = None
                          ) -> int:
        """Apply WAL-shaped records ``(key, seq, flags, exp, val)`` from
        a primary into the MemTable, oldest first — no local WAL append
        (the primary's log is the durability root; a follower restart
        re-ships or re-catches-up). Records at or below the local seq
        horizon are skipped. ``advance_to`` bumps the horizon past
        records a span-restricted follower clipped away, so the next
        tail read does not re-fetch them. Returns the number applied."""
        n = 0
        with self._write_lock, self._state_lock:
            for k, s, fl, e, v in sorted(records, key=lambda r: int(r[1])):
                s = int(s)
                if s < self.seq:
                    continue
                if fl & FLAG_RANGE:
                    self.mem.delete_range(int(k), unpack_range_hi(v), s)
                else:
                    self.mem.put(int(k), v, s,
                                 tomb=bool(fl & FLAG_TOMB), exp=int(e))
                self.seq = s + 1
                n += 1
            if advance_to is not None:
                self.seq = max(self.seq, int(advance_to))
        return n

    def adopt_version(self, state: dict, records,
                      advance_to: int | None = None) -> None:
        """Replica catch-up across a primary flush: adopt a newer
        committed manifest ``state`` (files already fetched into this
        store's directory) and rebuild the overlay from the primary's
        live WAL ``records`` — together they are exactly the state the
        primary itself would recover to. Readers swap atomically from
        the old Version + overlay to the new pair; pinned snapshots keep
        the old one until they unpin."""
        if int(state.get("vw", self.cfg.vw)) != self.cfg.vw:
            raise ValueError("adopt_version: vw mismatch")
        parts = [self._build_partition(pe) for pe in state["partitions"]]
        if not parts:
            parts = [Partition(lo=0, d=self.cfg.d, device=self.device)]
        mem = MemTable(vw=self.cfg.vw)
        seq = int(state.get("seq", 1))
        for k, s, fl, e, v in sorted(records, key=lambda r: int(r[1])):
            if fl & FLAG_RANGE:
                mem.delete_range(int(k), unpack_range_hi(v), int(s))
            else:
                mem.put(int(k), v, int(s),
                        tomb=bool(fl & FLAG_TOMB), exp=int(e))
            seq = max(seq, int(s) + 1)
        if advance_to is not None:
            seq = max(seq, int(advance_to))
        with self._state_lock:
            self.seq = max(self.seq, seq)
            self.mem = mem
            self._unavailable = [
                dict(s) for s in state.get("unavailable", [])
            ]
            self.versions.publish(
                sorted(parts, key=lambda p: p.lo), seq_horizon=self.seq
            )

    def absorb_shard(self, lo: int, hi: int, state: dict, records,
                     rename=None) -> dict:
        """Merge a retired right-neighbor shard's key span [lo, hi) into
        this store (the live half of a shard merge; the neighbor's files
        were already copied into this directory, under ``rename`` when
        basenames collided).

        Under the flush + write locks: purge this store's stale entries
        in the span (leftovers from a past split — the absorbed shard
        owns the authoritative copy), GC the WAL down to the surviving
        overlay, append the neighbor's live records (their original
        seqs; ranges are disjoint so cross-store seq collisions never
        compare on the same key), adopt its partitions, and commit one
        manifest covering the union.
        """
        if self.storage is None:
            raise RuntimeError("absorb_shard needs a persistent store")
        with self._flush_lock:
            with self._write_lock:
                recs = sorted(records, key=lambda r: int(r[1]))
                with self._state_lock:
                    self.mem.purge_range(lo, hi)
                    live_keys = set(self.mem.data.keys())
                    live_range_seqs = {s for _, _, s in self.mem.ranges}
                # stale WAL records in the span must not resurface on
                # recovery: rebuild the virtual log around the purge
                self.wal.gc(live_keys, defer_free=True,
                            live_range_seqs=live_range_seqs)
                for k, s, fl, e, v in recs:
                    self.wal.append(int(k), int(s), False, v, exp=int(e),
                                    flags=int(fl))
                self.wal.sync()
                # adopt the neighbor's partitions, clamping lows into the
                # span: a store opened fresh labels its first partition
                # lo=0 even when serving [lo, hi) — its rows are still in
                # span (cluster routing), only the label moves. Partitions
                # at/above ``hi`` are stale leftovers of a split the
                # neighbor itself underwent: skipped, their data lives in
                # the shard beyond ``hi``.
                new_parts = []
                for pe in state["partitions"]:
                    if int(pe["lo"]) >= hi:
                        continue
                    pe2 = dict(partition_entry_renamed(pe, rename))
                    pe2["lo"] = max(int(pe2["lo"]), lo)
                    new_parts.append(self._build_partition(pe2))
                with self._state_lock:
                    cur = self.versions.current.partitions
                    parts = sorted(
                        [p for p in cur if not (lo <= p.lo < hi)]
                        + new_parts,
                        key=lambda p: p.lo,
                    )
                    for k, s, fl, e, v in recs:
                        if fl & FLAG_RANGE:
                            self.mem.delete_range(
                                int(k), unpack_range_hi(v), int(s)
                            )
                        else:
                            self.mem.put(int(k), v, int(s),
                                         tomb=bool(fl & FLAG_TOMB),
                                         exp=int(e))
                        self.seq = max(self.seq, int(s) + 1)
                    self.seq = max(self.seq, int(state.get("seq", 1)))
                    for s in state.get("unavailable", []):
                        se = dict(s)
                        l2, h2 = max(int(se["lo"]), lo), min(int(se["hi"]), hi)
                        if l2 < h2:
                            se["lo"], se["hi"] = l2, h2
                            self._unavailable.append(se)
                self._commit(parts)
            self.wal.release_quarantine()
            with self._state_lock:
                self.versions.publish(parts, seq_horizon=self.seq)
            if rename:
                self.release_incoming(rename.values())
        self._gc_files()
        self.events.emit("shard_absorb", lo=lo, hi=min(hi, 2**64 - 1),
                         partitions=len(new_parts), records=len(recs))
        return dict(partitions=len(new_parts), records=len(recs))

    # ---------------- snapshots / cursors ----------------
    def snapshot(self) -> Snapshot:
        """A pinned, point-in-time view of the whole store: the current
        Version plus a frozen MemTable overlay. Reads through it are
        immune to concurrent flushes; close it (or use ``with``) to let
        retired versions free their tables/files. The public MVCC
        handle (§4.2's "old version remains servable").

        O(1): the overlay is a frozen layered view
        (``MemTable.snapshot_view``), not a dict copy — snapshotting a
        full MemTable costs the same as an empty one."""
        with self._state_lock:
            v = self.versions.pin_current()
            overlay = (
                self._flush_overlay
                if self._flush_overlay is not None
                else self.mem.snapshot_view()
            )
            return Snapshot(self, v, overlay, seq=self.seq, pinned=True,
                            ranges=self._live_ranges())

    @contextlib.contextmanager
    def _view(self):
        """Ephemeral *pinned* view of the live state for one read call:
        same code path as public snapshots, sharing the live overlay
        dict instead of copying it. The pin matters — without it a
        concurrent flush could release the version and delete its files
        mid-read; a Python reference keeps objects alive, not files."""
        with self._state_lock:
            v = self.versions.pin_current()
            src = (
                self._flush_overlay
                if self._flush_overlay is not None
                else self.mem.data
            )
            snap = Snapshot(self, v, src, seq=self.seq, pinned=True,
                            shared=True, ranges=self._live_ranges())
        try:
            yield snap
        finally:
            snap.close()

    def _live_ranges(self) -> tuple:
        """Unflushed range tombstones a new view must honor (call under
        ``_state_lock``): the frozen MemTable's while a flush is in
        flight (they become partition spans only at publish), else the
        live MemTable's."""
        src = (
            self._flush_ranges
            if self._flush_overlay is not None
            else self.mem.ranges
        )
        return tuple(src or ())

    def cursor(self, start: int = 0, width: int = 64) -> RemixCursor:
        """A streaming cursor (seek/peek/next/skip/next_batch, §3.2) over
        a fresh snapshot; the snapshot is released when the cursor is
        closed. Long scans seek once and stream."""
        cur = RemixCursor(self.snapshot(), width=width, owns_snapshot=True)
        cur.seek(int(start))
        return cur

    # ---------------- read path ----------------
    def _query_mod(self):
        if self.cfg.use_kernels:
            from repro_torch.kernels import ops

            return ops
        return Q

    def _qkw(self) -> dict:
        """Query kwargs of the plain path: the in-group mode, ``auto``
        resolved once at construction (binary on the CPU, vector on
        CUDA); only valid modes reach seek. The kernels take none."""
        if self.cfg.use_kernels:
            return {}
        return dict(ingroup=self._ingroup)

    def _device_view(self, p: Partition):
        """Resident device view for a promoted partition (uploaded on
        first use), or None — disabled, over budget, or ineligible —
        in which case callers answer from the legacy path."""
        if self.device_views is None:
            return None
        return self.device_views.view_for(p)

    def _cold_ok(self, p: Partition) -> bool:
        """Serve this partition via block-granular cold reads?

        True only while the recovered on-disk REMIX still matches the
        table list and the observed cold workload hasn't yet justified
        building the device RunSet (promotion)."""
        if not (
            self.cfg.cold_reads
            and self.block_cache is not None
            and p.cold_ready()
        ):
            return False
        if not p.should_promote(self.cfg.promote_fraction):
            return True
        # promotion edge: first read that tips this partition over emits
        # one lifecycle event (the flag lives on the partition so its
        # clones in later Versions don't re-emit)
        if not getattr(p, "_promotion_emitted", False):
            p._promotion_emitted = True
            self.events.emit("promotion", lo=int(p.lo),
                             tables=len(p.tables),
                             cold_gets=int(p.cold_gets),
                             cold_scans=int(p.cold_scans))
        return False

    def get(self, key: int):
        r = self._run_one(Op.get(int(key)))
        return r.value if r.found else None

    # ---- graceful degradation over quarantined spans ----
    def _check_unavailable_point(self, key: int) -> None:
        """Raise :class:`UnavailableSpanError` if ``key`` falls in a span
        whose backing table was quarantined as unrecoverable — a typed
        refusal, never a silent miss."""
        for s in self._unavailable:
            hi = s.get("hi")
            if int(s["lo"]) <= key and (hi is None or key <= int(hi)):
                raise UnavailableSpanError(
                    int(s["lo"]), hi if hi is None else int(hi),
                    tuple(s.get("tables", ())),
                )

    def _check_unavailable_scan(self, start: int) -> None:
        """Scans are refused conservatively: a scan starting at or below
        a degraded span's upper bound could silently skip its rows."""
        for s in self._unavailable:
            hi = s.get("hi")
            if hi is None or start <= int(hi):
                raise UnavailableSpanError(
                    int(s["lo"]), hi if hi is None else int(hi),
                    tuple(s.get("tables", ())),
                )

    def _get_at(self, view: Snapshot, key: int):
        e = view.overlay.get(int(key))
        if e is not None:
            return None if entry_dead(e, clock.now()) else e.val
        if view.ranges and view.covers(int(key)):
            return None  # hidden by an unflushed range tombstone
        if self._unavailable:
            self._check_unavailable_point(int(key))
        parts = view.partitions
        p = parts[route_one(parts, int(key))]
        if self._cold_ok(p):
            found, val = p.cold_get(int(key))
            return val if found else None
        dv = self._device_view(p)
        if dv is not None:
            f, v = self.device_views.get_batch(
                dv, np.array([key], np.uint64), clock.now()
            )
            return v[0] if bool(f[0]) else None
        remix, runset = p.index()
        qk = as_words(CK.pack_u64(np.array([key], np.uint64)), p.device)
        found, val = self._query_mod().get(remix, runset, qk, **self._qkw())
        return u32_np(val)[0] if bool(found[0]) else None

    def get_batch(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookups. Returns (found (Q,), vals (Q,VW))."""
        r = self._run_one(Op.multiget(keys))
        return r.found, r.vals

    def _get_batch_at(self, view: Snapshot, keys):
        keys = np.asarray(keys, np.uint64)
        found = np.zeros(len(keys), bool)
        vals = np.zeros((len(keys), self.cfg.vw), np.uint32)
        rest = []
        now = clock.now()
        for i, k in enumerate(keys.tolist()):
            e = view.overlay.get(k)
            if e is not None:
                found[i] = not entry_dead(e, now)
                vals[i] = e.val
            elif not (view.ranges and view.covers(k)):
                rest.append(i)
        parts = view.partitions
        if rest and self._unavailable:
            for i in rest:
                self._check_unavailable_point(int(keys[i]))
        if rest:
            rest = np.array(rest)
            pidx = route_host([p.lo for p in parts], keys[rest])
            for pi in np.unique(pidx):
                sel = rest[pidx == pi]
                p = parts[pi]
                if self._cold_ok(p):
                    f, v = p.cold_get_batch(keys[sel])
                    found[sel] = f
                    vals[sel[f]] = v[f]
                    continue
                dv = self._device_view(p)
                if dv is not None:
                    f, v = self.device_views.get_batch(dv, keys[sel], now)
                    found[sel] = f
                    vals[sel] = v
                    continue
                remix, runset = p.index()
                kq = keys[sel]
                pad = _pow2pad(len(kq))
                kq = np.pad(kq, (0, pad - len(kq)))
                qk = as_words(CK.pack_u64(kq), p.device)
                f, v = self._query_mod().get(remix, runset, qk, **self._qkw())
                found[sel] = f.cpu().numpy()[: len(sel)]
                vals[sel] = u32_np(v)[: len(sel)]
        return found, vals

    def scan(self, start_key: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Range scan: one cursor seek + ``next_batch(n)`` over the merged
        view (partitions + MemTable overlay)."""
        r = self._run_one(Op.scan(int(start_key), int(n)))
        return r.keys, r.vals

    def _scan_at(self, view: Snapshot, start_key: int, n: int,
                 interrupt=None):
        if self._unavailable:
            self._check_unavailable_scan(int(start_key))
        cur = RemixCursor(view, width=max(8, n + n // 2),
                          interrupt=interrupt)
        cur.seek(int(start_key))
        return cur.next_batch(n)

    def scan_batch(self, starts, n: int):
        """Batched range scans (one window call per touched partition).

        Returns (keys (Q, n) uint64, valid (Q, n)). Queries whose range
        crosses a partition boundary fall back to the cursor path.
        """
        from repro_torch.db.executor import scan_batch_via_ops

        return scan_batch_via_ops(self.engine(), starts, n)

    def _scan_batch_at(self, view: Snapshot, starts, n: int):
        """(keys (Q, n), valid (Q, n)) for a pinned view — the snapshot
        API's batched scan, reformatted from :meth:`_scan_group_at`."""
        starts = np.asarray(starts, np.uint64)
        q = len(starts)
        out_k = np.zeros((q, n), np.uint64)
        out_m = np.zeros((q, n), bool)
        for i, (kk, _) in enumerate(
            self._scan_group_at(view, starts, n, with_vals=False)
        ):
            kk = kk[:n]
            out_k[i, : len(kk)] = kk
            out_m[i, : len(kk)] = True
        return out_k, out_m

    def _scan_group_at(self, view: Snapshot, starts, n,
                       with_vals: bool = True, interrupts=None) -> list:
        """Vectorized group of range scans over one pinned view: the
        physical primitive behind Scan ops, ``scan_batch`` and the serve
        engine's batched scans. ``n`` may be a scalar or a (Q,) array —
        heterogeneous scan groups merge their row windows so overlapping
        scans of different lengths share granule fetches (cold path) and
        one window call (promoted path).

        One window (or cold batched) call per touched partition;
        per query the window is clipped to the partition span, and any
        under-full row falls back to the cursor path — the fixed window
        alone can't distinguish "partition tail reached" from "window
        swallowed by a tombstone run or a partition boundary", and the
        cursor handles both (so promotion never changes results).
        Batches over a non-empty overlay take the cursor path per query,
        like the legacy ``scan_batch`` did.

        Returns one entry per query: ``(keys (M,), vals (M, VW))`` with
        ``vals`` None when ``with_vals`` is False, or the
        :class:`~repro_torch.db.ops.OpInterrupted` instance when that query's
        ``interrupts`` checker fired mid-scan (deadline/cancel) — the
        executor converts it to a per-op status.
        """
        starts = np.asarray(starts, np.uint64)
        q = len(starts)
        if self._unavailable:
            for s in starts.tolist():
                self._check_unavailable_scan(int(s))
        checks = interrupts if interrupts is not None else [None] * q
        ns = np.zeros(q, np.int64) + np.asarray(n, np.int64)
        empty_v = np.zeros((0, self.cfg.vw), np.uint32)
        empty_row = (np.zeros(0, np.uint64), empty_v if with_vals else None)
        out: list = [None] * q
        act = ns > 0
        for qi in np.flatnonzero(~act):
            out[qi] = empty_row
        if not act.any():
            return out

        def row_fallback(qi):
            try:
                kk, vv = self._scan_at(
                    view, int(starts[qi]), int(ns[qi]), interrupt=checks[qi]
                )
            except OpInterrupted as e:
                return e
            return kk, (vv if with_vals else None)

        # a lone scan keeps the legacy streaming profile: the cursor
        # path pipelines value/tomb blocks ahead (Fig 10, prefetch_depth)
        # — the batched window path instead coalesces across queries,
        # which only wins with > 1 scan sharing granules. Batches over a
        # non-empty overlay (entries or unflushed range tombstones)
        # merge per query through the cursor too.
        if q == 1 or view.overlay or view.ranges:
            return [
                out[qi] if out[qi] is not None else row_fallback(qi)
                for qi in range(q)
            ]
        parts = view.partitions
        spans = partition_spans([p.lo for p in parts])
        pidx = route_host([p.lo for p in parts], starts)
        widths = ns + np.maximum(8, ns // 2)
        for pi in np.unique(pidx[act]):
            sel = np.flatnonzero((pidx == pi) & act)
            p = parts[pi]
            hi = spans[pi][1]

            def emit_row(qi, kk, vv):
                nn = int(ns[qi])
                m = kk < hi  # clip to the partition's key span
                kk = kk[m][:nn]
                if len(kk) < nn:
                    out[qi] = row_fallback(qi)
                    return
                out[qi] = (kk, vv[m][:nn] if with_vals else None)

            if self._cold_ok(p):
                # per-query widths: the coalesced fetch set merges row
                # windows across different n values (shared granules)
                for qi, (kk, vv, _) in zip(
                    sel, p.cold_scan_batch(starts[sel], widths[sel])
                ):
                    emit_row(qi, kk, vv)
                continue
            # promoted: one fixed-width window call per partition (the
            # reference's shape); max width over the group, per-query n
            # clipping keeps results bit-identical to per-n groups
            width = int(widths[sel].max())
            dv = self._device_view(p)
            if dv is not None:
                for qi, (kk, vv) in zip(
                    sel,
                    self.device_views.scan_windows(
                        dv, starts[sel], width, clock.now(),
                        with_vals=with_vals,
                    ),
                ):
                    emit_row(qi, kk, vv)
                continue
            remix, runset = p.index()
            sq = starts[sel]
            pad = _pow2pad(len(sq))
            sq = np.pad(sq, (0, pad - len(sq)))
            qk = as_words(CK.pack_u64(sq), p.device)
            kw = dict(self._qkw())
            if not self.cfg.use_kernels:
                # return no values when the caller only needs keys,
                # e.g. scan_batch
                kw["with_vals"] = with_vals
            keys, vals, valid, _ = self._query_mod().scan(
                remix, runset, qk, width=width, **kw
            )
            keys = CK.unpack_u64(u32_np(keys))[: len(sel)]
            valid = valid.cpu().numpy()[: len(sel)]
            vals = None if vals is None else u32_np(vals)[: len(sel)]
            for row, qi in enumerate(sel):
                v = vals[row][valid[row]] if vals is not None else None
                emit_row(qi, keys[row][valid[row]], v)
        return out

    # ---------------- stats / recovery ----------------
    def write_amplification(self) -> float:
        total = self.table_bytes_written + self.wal.bytes_written
        return total / max(1, self.user_bytes)

    def disk_bytes_read(self) -> int:
        """Physical table-file bytes read so far (cache hits excluded).

        Monotonic: counts from handles retired with their last Version
        are folded into ``_retired_disk_bytes`` on release; live counts
        span every pinned Version (tables shared between versions are
        counted once).
        """
        total = self._retired_disk_bytes
        seen: set[int] = set()
        for v in self.versions.live_versions():
            for t in v.tables():
                if id(t) in seen:
                    continue
                seen.add(id(t))
                if t._reader is not None:
                    total += t._reader.disk_bytes_read
        return total

    def stats(self) -> dict:
        """Store counters. Introspection-safe: never force-loads a lazy
        table handle (entries come from cached file headers) and never
        builds a partition index."""
        parts = self.partitions
        out = dict(
            partitions=len(parts),
            tables=sum(len(p.tables) for p in parts),
            entries=sum(p.n_entries for p in parts),
            resident_tables=sum(
                t.resident for p in parts for t in p.tables
            ),
            memtable=len(self.mem),
            wa=self.write_amplification(),
            wal_blocks=self.wal.used_blocks(),
            # all physical table-file reads, not only cold-path ones
            # (whole-table loads and rebuilds count too)
            disk_bytes_read=self.disk_bytes_read(),
            cold=dict(
                gets=sum(p.cold_gets for p in parts),
                scans=sum(p.cold_scans for p in parts),
            ),
            versions=self.versions.stats(),
            compaction=dict(
                rounds=self.compaction_totals["rounds"],
                bytes_written=self.compaction_totals["bytes_written"],
                kinds=dict(self.compaction_totals["kinds"]),
                log_rounds=len(self.compaction_log),
                in_flight=bool(self._in_flush),
            ),
        )
        out["health"] = self.health()
        if self._ops_engine is not None:
            out["engine"] = self._ops_engine.stats()
        if self.block_cache is not None:
            out["cache"] = self.block_cache.stats()
            # promotion decision inputs per cold-servable partition
            # (header-only table reads; nothing is force-loaded)
            out["cache"]["promotion"] = [
                p.promotion_inputs(self.cfg.promote_fraction)
                for p in parts
                if p.cold_ready()
            ]
        return out

    def metrics(self) -> dict:
        """One merged observability snapshot (``{"metrics": [...]}``):
        this store's registry plus any component running its own (an
        externally shared :class:`~repro_torch.io.blockcache.BlockCache`).
        Render with :func:`repro_torch.obs.render_prometheus`, diff with
        :func:`repro_torch.obs.diff_snapshots` (or ``tools/obstool.py``)."""
        parts = [self.registry.snapshot()]
        bc = self.block_cache
        if bc is not None and getattr(bc, "registry", None) is not None \
                and bc.registry is not self.registry:
            parts.append(bc.registry.snapshot())
        eng = self._ops_engine
        if eng is not None and eng.registry is not self.registry:
            parts.append(eng.registry.snapshot())
        return merge_snapshots(*parts)

    def recover_memtable(self) -> MemTable:
        """Rebuild the MemTable from the WAL's live virtual log (§4.3).

        Replays in sequence order so a range tombstone re-hides exactly
        the older point entries it hid before the crash."""
        mem = MemTable(vw=self.cfg.vw)
        for k, s, fl, e, v in sorted(self.wal.replay(), key=lambda r: r[1]):
            if fl & FLAG_RANGE:
                mem.delete_range(k, unpack_range_hi(v), s)
            else:
                mem.put(k, v, s, tomb=bool(fl & FLAG_TOMB), exp=int(e))
        return mem
