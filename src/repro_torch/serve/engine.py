"""The KV-store serving front, carried from ``repro.serve.engine``.

:class:`KVServeEngine` fronts one or more persistent
:class:`repro_torch.db.store.RemixDB` shards with a **single block cache
shared across every partition of every shard**, so cold-start queries on
any shard warm the same bytes-budgeted pool and the operator gets one
hit/miss/eviction view of the whole serving node. Each shard keeps its
own device views on its own device (``RemixDBConfig.device``, the card
by default).

The reference module also holds the LLM batch engine (``ServeEngine``,
``ServeStats``); it needs the model stack and is not ported yet.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np


class KVServeEngine:
    """Range-sharded RemixDB serving front with one shared block cache.

    ``shards`` maps inclusive lower key bounds to store data directories
    (or existing :class:`RemixDB` instances); every store is opened with
    the *same* :class:`repro_torch.io.blockcache.BlockCache`, so the byte
    budget — and the hit/miss accounting — spans all partitions of all
    shards instead of fragmenting per store. Point and range queries are
    routed by key range, mirroring the store's own routing one level up.

    The serving surface is the op layer (API v2): :meth:`submit` takes a
    typed :class:`repro_torch.db.ops.Batch` — mixed gets, multigets, scans,
    puts and deletes, with per-op deadlines/priorities — and the shared
    :class:`repro_torch.db.executor.Executor` fans it out across shards
    (writes to the owning shard, reads through **one pinned snapshot per
    touched shard per batch**) and back in. Every legacy method below is
    a thin wrapper building a one-kind batch and blocking on the future,
    so both surfaces stay bit-for-bit identical — the serving-side MVCC
    contract is unchanged. ``snapshot()`` exposes the pinned handle for
    callers that want consistency across *multiple* requests (e.g. a
    streaming cursor per shard).
    """

    def __init__(
        self,
        shards: list[tuple[int, object]],
        cache_bytes: int = 64 << 20,
        config=None,
        max_inflight_bytes: int = 256 << 20,
        submit_workers: int = 2,
        metrics: bool = True,
        trace_sample_rate: float = 0.0,
    ):
        from repro_torch.db.executor import Executor
        from repro_torch.db.store import RemixDB, RemixDBConfig
        from repro_torch.io.blockcache import BlockCache
        from repro_torch.obs.events import EventLog, NULL_EVENTS
        from repro_torch.obs.metrics import MetricsRegistry

        if not shards:
            raise ValueError("KVServeEngine needs at least one shard")
        # serving-tier observability: the shared cache and the cross-shard
        # executor record into this registry; each shard store keeps its
        # own (metrics() merges them under per-shard labels)
        self.registry = MetricsRegistry(enabled=metrics)
        self.events = EventLog() if metrics else NULL_EVENTS
        self.cache = BlockCache(cache_bytes, registry=self.registry)
        self._config = config
        self._metrics_on = metrics
        self._max_inflight_bytes = max_inflight_bytes
        self._submit_workers = submit_workers
        self._trace_sample_rate = trace_sample_rate
        self.lows, self.shards = self._prepare_shards(shards)
        self.engine = self._build_engine()

    def _prepare_shards(self, shards):
        """Open/adopt ``(lo, dir-or-store)`` pairs onto the shared cache."""
        from repro_torch.db.store import RemixDB, RemixDBConfig

        lows: list[int] = []
        out: list[RemixDB] = []
        for lo, db in sorted(shards, key=lambda s: s[0]):
            if not isinstance(db, RemixDB):
                cfg0 = self._config or RemixDBConfig()
                cfg = dataclasses.replace(
                    cfg0,
                    data_dir=str(db),
                    block_cache=self.cache,
                    metrics=cfg0.metrics and self._metrics_on,
                    trace_sample_rate=self._trace_sample_rate,
                )
                db = RemixDB(cfg)
            elif db.storage is not None and db.block_cache is not self.cache:
                # adopt a pre-opened store into the shared pool: swap its
                # private cache out of every table handle (already-cached
                # blocks stay in the old pool and simply age out)
                db.block_cache = self.cache
                for p in db.partitions:
                    for t in p.tables:
                        t.attach_cache(self.cache)
            lows.append(int(lo))
            out.append(db)
        return lows, out

    def _build_engine(self):
        from repro_torch.db.executor import Executor

        return Executor(
            list(zip(self.lows, self.shards)),
            max_inflight_bytes=self._max_inflight_bytes,
            workers=self._submit_workers,
            registry=self.registry,
            events=self.events,
            trace_sample_rate=self._trace_sample_rate,
        )

    def swap_shards(self, shards) -> None:
        """Atomically install a new shard routing table — the cutover
        step of a live shard split/merge. Builds a fresh Executor over
        the new ``(lo, store-or-dir)`` list (same shared cache/registry;
        the counters keep accumulating), swaps it in, then drains and
        closes the old executor. Callers must quiesce submissions around
        the swap (``cluster.Cluster`` gates them); in-flight batches on
        the old executor finish normally — their stores stay open — so
        no op ever fails from a swap."""
        lows, stores = self._prepare_shards(shards)
        old = self.engine
        self.shards = stores
        self.lows = lows
        self.engine = self._build_engine()
        old.close(wait=True)
        self.events.emit("route_swap", shards=len(lows),
                         lows=[str(lo) for lo in lows])

    def _route(self, key: int) -> "object":
        return self.shards[max(0, bisect.bisect_right(self.lows, key) - 1)]

    # ---------------- operation layer (API v2) ----------------
    def submit(self, batch, *, sync: bool = False):
        """Submit a typed op batch across all shards; returns a future
        resolving to a :class:`repro_torch.db.ops.BatchResult`."""
        return self.engine.submit(batch, sync=sync)

    def _run_one(self, op):
        from repro_torch.db.ops import Batch

        r = self.engine.submit(Batch([op]), sync=True).result().results[0]
        r.raise_if_error()
        return r

    def close(self) -> None:
        """Drain and stop the op executor (the stores stay open)."""
        self.engine.close()

    # ---------------- legacy wrappers ----------------
    def get(self, key: int):
        """Point lookup, routed through the batched path: a scalar get is
        a batch of one, so cold shards answer it with the same vectorized
        ``cold_get_batch`` machinery (and the same block accounting) as a
        256-key batch."""
        from repro_torch.db.ops import Op

        r = self._run_one(Op.multiget(np.array([int(key)], np.uint64)))
        return r.vals[0] if bool(r.found[0]) else None

    def snapshot(self, key: int | None = None):
        """Pin a consistent view: of the shard owning ``key``, or (when
        ``key`` is None) a list of per-shard snapshots in key order —
        close each (or use ``with``) when done."""
        if key is not None:
            return self._route(int(key)).snapshot()
        return [db.snapshot() for db in self.shards]

    def get_batch(self, keys):
        """Batched point lookups: one vectorized ``get_batch`` call per
        touched shard — a sharded batch costs O(shards) batched calls,
        never O(keys) scalar gets — each through a Version pinned for
        the duration of the batch (the store's ephemeral view: pinned
        like a snapshot but sharing the live overlay, so the serving hot
        path never copies a MemTable per request)."""
        from repro_torch.db.ops import Op

        r = self._run_one(Op.multiget(keys))
        return r.found, r.vals

    def scan(self, start_key: int, n: int):
        """Cross-shard range scan: drain shards in key order until full,
        each shard read through a snapshot pinned for the call."""
        from repro_torch.db.ops import Op

        r = self._run_one(Op.scan(int(start_key), int(n)))
        return r.keys, r.vals

    def scan_batch(self, starts, n: int):
        """Batched cross-shard range scans (serve-side analogue of
        ``RemixDB.scan_batch``): one vectorized window call per touched
        (shard, partition), under-full scans drain follow-on shards in
        key order. Returns (keys (Q, n) uint64, valid (Q, n))."""
        from repro_torch.db.executor import scan_batch_via_ops

        return scan_batch_via_ops(self.engine, starts, n)

    def put(self, key: int, val) -> None:
        """Upsert, routed to the owning shard's WAL + MemTable."""
        from repro_torch.db.ops import Op

        vw = self.shards[0].cfg.vw
        val = np.asarray(val, np.uint32).reshape(vw)
        self._run_one(Op.put(int(key), val))

    def put_batch(self, keys, vals) -> None:
        """Vectorized upserts: rows are routed to their owning shards
        and each shard's slice group-commits through its WAL in one
        append (cross-shard write fan-out of a single op)."""
        from repro_torch.db.ops import Op

        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32).reshape(
            len(keys), self.shards[0].cfg.vw
        )
        self._run_one(Op.put(keys, vals))

    def delete(self, key: int) -> None:
        """Tombstone write, routed to the owning shard."""
        from repro_torch.db.ops import Op

        self._run_one(Op.delete(int(key)))

    def delete_range(self, start: int, end: int) -> None:
        """Range tombstone over ``[start, end)``; the executor clips the
        span to each owning shard (one WAL record per touched shard)."""
        from repro_torch.db.ops import Op

        self._run_one(Op.delete_range(int(start), int(end)))

    def cas(self, key: int, expect, val, *, ttl=None):
        """Atomic compare-and-swap on the owning shard. Returns
        ``(swapped, actual)`` — on conflict ``actual`` is the current
        value (None when absent)."""
        from repro_torch.db.ops import Op

        vw = self.shards[0].cfg.vw
        if expect is not None:
            expect = np.asarray(expect, np.uint32).reshape(vw)
        if val is not None:
            val = np.asarray(val, np.uint32).reshape(vw)
        r = self._run_one(Op.cas(int(key), expect, val, ttl=ttl))
        return bool(r.found), r.value

    def flush(self) -> list[dict]:
        """Flush every shard (memtable freeze + compaction round each)."""
        return [db.flush() for db in self.shards]

    def stats(self) -> dict:
        """Aggregated serving stats + the shared cache's counters."""
        per = [db.stats() for db in self.shards]
        return dict(
            shards=len(self.shards),
            cache=self.cache.stats(),
            engine=self.engine.stats(),
            disk_bytes_read=sum(s["disk_bytes_read"] for s in per),
            cold=dict(
                gets=sum(s["cold"]["gets"] for s in per),
                scans=sum(s["cold"]["scans"] for s in per),
            ),
            stores=per,
        )

    def scrub(self, full: bool = True, repair: bool = True) -> list[dict]:
        """Run an integrity scrub on every shard (see
        :meth:`repro_torch.db.store.RemixDB.scrub`); one report per shard."""
        return [db.scrub(full=full, repair=repair) for db in self.shards]

    def health(self) -> dict:
        """Node-level durability summary: ``degraded`` if *any* shard is,
        with each shard's own report keyed by its lower key bound."""
        per = {
            str(lo): db.health()
            for lo, db in zip(self.lows, self.shards)
        }
        degraded = any(h["status"] != "ok" for h in per.values())
        return dict(
            status="degraded" if degraded else "ok",
            shards=per,
            corruption_detected=sum(
                h["corruption_detected"] for h in per.values()
            ),
            quarantine_files=sum(
                h["quarantine_files"] for h in per.values()
            ),
        )

    def metrics(self) -> dict:
        """One labelled observability snapshot for the whole serving
        node: the serving tier's registry (shared cache + cross-shard
        executor) stamped ``tier="serve"``, plus every shard store's
        registry stamped with its lower key bound (``shard="<lo>"``).
        Render with :func:`repro_torch.obs.render_prometheus`."""
        from repro_torch.obs.metrics import merge_snapshots

        parts = [(self.registry.snapshot(), dict(tier="serve"))]
        for lo, db in zip(self.lows, self.shards):
            parts.append((db.registry.snapshot(), dict(shard=str(lo))))
        return merge_snapshots(*parts)
