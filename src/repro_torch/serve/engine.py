"""Serving engines: the LLM batch engine and the KV-store front-end.

:class:`ServeEngine` drives the model serving pipeline (prefix cache +
prefill + decode): longest-prefix match (REMIX batched lookup) → copy
cached KV pages into the decode cache → prefill the uncached suffix →
greedy decode → register new pages. With or without the prefix cache the
outputs are the same tokens; the cache only removes recomputation.

:class:`KVServeEngine`, carried from ``repro.serve.engine``, fronts one or
more persistent :class:`repro_torch.db.store.RemixDB` shards with a
**single block cache shared across every partition of every shard**, so
cold-start queries on any shard warm the same bytes-budgeted pool and the
operator gets one hit/miss/eviction view of the whole serving node. Each
shard keeps its own device views on its own device
(``RemixDBConfig.device``, the card by default).
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.models.kvcache import PrefixCache
from repro_torch.models.layers import tree_map


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    prefill_tokens: int = 0
    cached_tokens: int = 0
    decoded_tokens: int = 0


class ServeEngine:
    """Greedy LLM serving over ``decode_step``, with an optional
    :class:`PrefixCache` (dense and moe families).

    ``params`` is a value tree; it is moved to ``device`` (the card by
    default), where the decode cache lives too.
    """

    def __init__(
        self, cfg: ModelConfig, params, max_seq: int = 256,
        prefix_cache: PrefixCache | None = None, device="cuda",
    ):
        self.device = resolve(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_seq = max_seq
        self.prefix = prefix_cache
        self.stats = ServeStats()

    def _decode(self, cache, tok: torch.Tensor, pos: int):
        return M.decode_step(self.cfg, self.params, cache, tok, pos)

    def _prefill_tokens(self, cache, tokens: torch.Tensor, start: int):
        """Teacher-forced decode_step loop over the uncached suffix."""
        logits = None
        for t in range(start, len(tokens)):
            logits, cache = self._decode(cache, tokens[t : t + 1], t)
        return logits, cache

    def generate(self, prompt: np.ndarray, max_new: int = 16) -> np.ndarray:
        """Greedy generation for one request (batch=1 internally)."""
        cfg = self.cfg
        self.stats.requests += 1
        cache = M.init_cache(cfg, 1, self.max_seq, device=self.device)
        use_prefix = self.prefix is not None and cfg.family in ("dense", "moe")
        start = 0
        if use_prefix:
            n_cached, slots = self.prefix.match(prompt)
            if n_cached == len(prompt):
                # a fully cached prompt still prefills its last page: the
                # first new token needs that position's logits
                n_cached -= self.prefix.page_size
                slots = slots[:-1]
            if n_cached:
                k, v = self.prefix.gather(slots)  # (L, n, KVH, hd) float16
                # float16 -> float32 -> cache dtype, the reference's casts
                cache["k"][:, 0, :n_cached] = k.float().to(cache["k"].dtype)
                cache["v"][:, 0, :n_cached] = v.float().to(cache["v"].dtype)
                start = n_cached
                self.stats.cached_tokens += n_cached
        toks = torch.as_tensor(np.asarray(prompt), device=self.device)
        logits, cache = self._prefill_tokens(cache, toks, start)
        self.stats.prefill_tokens += len(prompt) - start
        out = []
        pos = len(prompt)
        tok = torch.argmax(logits[0]).reshape(1)
        for _ in range(max_new):
            out.append(int(tok))
            logits, cache = self._decode(cache, tok, pos)
            pos += 1
            tok = torch.argmax(logits[0]).reshape(1)
        if use_prefix:
            full = np.concatenate([prompt, np.array(out, prompt.dtype)])
            self.prefix.register(full, cache["k"][:, 0], cache["v"][:, 0])
        self.stats.decoded_tokens += len(out)
        return np.array(out, np.int32)


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
