"""An in-process fleet of RemixDB range shards with live resharding.

:class:`Cluster` owns a :class:`repro_torch.serve.engine.KVServeEngine` (one
shared block cache, one op executor) plus the distribution machinery:

- **Live split**: ship the hot shard's upper span to a fresh directory
  while traffic keeps flowing (snapshot ship + catch-up rounds), then
  gate submissions for one final catch-up and an atomic routing-table
  swap (:meth:`KVServeEngine.swap_shards`). No op ever fails: in-flight
  batches drain on the old executor, gated callers simply wait out the
  cutover.
- **Merge**: the inverse — bulk-copy the right shard's immutable files
  into the left neighbor under fresh names while live, then gate, take
  an atomic ``replication_snapshot`` delta, and
  :meth:`RemixDB.absorb_shard` the span in one manifest commit.
- **Replicas**: :meth:`add_replica` ships a full-range follower that
  catches up via manifest diff + WAL tail replay.
- **Placement**: a background loop watches per-shard routed-op counts
  and splits the hottest shard at the boundary
  :func:`repro_torch.cluster.placement.pick_split` proposes.

Split points align to source partition boundaries, and the split source
is range-trimmed after cutover (``delete_range`` over the moved span),
so a later merge absorbs cleanly; the executor additionally clips scan
results to each shard's routed span, so even an untrimmed source never
leaks stale rows through the serve tier.
"""
from __future__ import annotations

import bisect
import logging
import os
import threading

from repro_torch.cluster.placement import pick_split
from repro_torch.cluster.replica import Replica, ShardFollower
from repro_torch.cluster.ship import clip_records, fetch_files, subset_state
from repro_torch.db.sharded import partition_spans

log = logging.getLogger(__name__)

KEY_SPACE = 1 << 64


class Cluster:
    """A range-sharded serving fleet rooted at one directory.

    ``lows=None`` reopens whatever ``shard-*`` directories already exist
    under ``root`` (a restarted cluster recovers its layout from disk);
    otherwise one shard directory per lower bound is created/opened.
    All public traffic methods are gated on an RLock so a split/merge
    cutover is atomic with respect to submissions — callers block for
    the (short) swap instead of failing.
    """

    def __init__(self, root: str, lows=(0,), config=None,
                 cache_bytes: int = 64 << 20,
                 max_inflight_bytes: int = 256 << 20,
                 submit_workers: int = 2, metrics: bool = True,
                 trace_sample_rate: float = 0.0, io=None):
        from repro_torch.serve.engine import KVServeEngine

        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        if lows is None:
            found = sorted(
                int(name.split("-", 1)[1])
                for name in os.listdir(self.root)
                if name.startswith("shard-")
            )
            lows = tuple(found) if found else (0,)
        self._io = io
        self.serve = KVServeEngine(
            [(int(lo), self._dir_for(int(lo))) for lo in lows],
            cache_bytes=cache_bytes, config=config,
            max_inflight_bytes=max_inflight_bytes,
            submit_workers=submit_workers, metrics=metrics,
            trace_sample_rate=trace_sample_rate,
        )
        self.registry = self.serve.registry
        self.events = self.serve.events
        self.replicas: list[Replica] = []
        # submissions gate: held for the duration of a cutover; re-entrant
        # so admin ops can call the traffic surface they gate
        self._gate = threading.RLock()
        # serializes split/merge/replica admin against each other (and the
        # placement loop); re-entrant so maybe_split -> split nests
        self._admin = threading.RLock()
        self._ops_by_shard: dict[int, int] = {}
        self._placer: threading.Thread | None = None
        self._placer_stop: threading.Event | None = None
        self._c_splits = self.registry.counter("shard_split")
        self._c_merges = self.registry.counter("shard_merge")
        self.registry.gauge("cluster_shards",
                            fn=lambda: len(self.serve.lows))

    def _dir_for(self, lo: int) -> str:
        return os.path.join(self.root, f"shard-{int(lo):020d}")

    # ---------------- traffic (gated) ----------------
    def submit(self, batch, *, sync: bool = False):
        """Submit a typed op batch; see :meth:`KVServeEngine.submit`.
        Routed-op counts feed the placement loop."""
        with self._gate:
            self._count(batch)
            return self.serve.submit(batch, sync=sync)

    def _count(self, batch) -> None:
        for op in getattr(batch, "ops", ()):
            k = getattr(op, "key", None)
            if k is None:
                k = getattr(op, "start", None)
            if k is None:
                keys = getattr(op, "keys", None)
                if keys is None or not len(keys):
                    continue
                self._count_keys(keys)
                continue
            self._count_keys([k])

    def _count_keys(self, keys) -> None:
        """Per-shard routed-op accounting feeding the placement loop."""
        lows = self.serve.lows
        for k in keys:
            lo = lows[max(0, bisect.bisect_right(lows, int(k)) - 1)]
            self._ops_by_shard[lo] = self._ops_by_shard.get(lo, 0) + 1

    def _gated(self, fn, keys, *args, **kw):
        with self._gate:
            self._count_keys(keys)
            return fn(*args, **kw)

    def get(self, key):
        return self._gated(self.serve.get, [key], key)

    def get_batch(self, keys):
        return self._gated(self.serve.get_batch, keys, keys)

    def scan(self, start, n):
        return self._gated(self.serve.scan, [start], start, n)

    def scan_batch(self, starts, n):
        return self._gated(self.serve.scan_batch, starts, starts, n)

    def put(self, key, val):
        return self._gated(self.serve.put, [key], key, val)

    def put_batch(self, keys, vals):
        return self._gated(self.serve.put_batch, keys, keys, vals)

    def delete(self, key):
        return self._gated(self.serve.delete, [key], key)

    def delete_range(self, start, end):
        return self._gated(self.serve.delete_range, [start], start, end)

    def flush(self):
        with self._gate:
            return self.serve.flush()

    def stats(self) -> dict:
        return self.serve.stats()

    def metrics(self) -> dict:
        return self.serve.metrics()

    def health(self) -> dict:
        return self.serve.health()

    @property
    def lows(self) -> list[int]:
        return list(self.serve.lows)

    def spans(self) -> list[tuple[int, int]]:
        return partition_spans(self.serve.lows)

    # ---------------- resharding ----------------
    def _owner(self, at: int) -> int:
        return max(0, bisect.bisect_right(self.serve.lows, int(at)) - 1)

    def _align_split(self, src, at: int, lo: int, hi: int) -> int:
        """Snap ``at`` to the nearest source partition boundary inside
        ``(lo, hi)``; flushes the shard once to materialize boundaries
        when it has none (all data still in the MemTable)."""
        for attempt in range(2):
            bounds = [int(p.lo) for p in src.partitions if lo < p.lo < hi]
            if bounds:
                return min(bounds, key=lambda b: abs(b - int(at)))
            if attempt == 0:
                src.flush()
        return int(at)

    def split(self, at: int, *, align: bool = True,
              catchup_rounds: int = 8, lag_target: int = 256,
              trim_source: bool = True) -> dict:
        """Split the shard owning ``at`` into ``[lo, at)`` + ``[at, hi)``
        while serving traffic; returns a report dict.

        Phases: (1) live — ship a snapshot of ``[at, hi)`` into a fresh
        shard directory and run catch-up rounds while writes continue;
        (2) gated — drain in-flight batches, one final catch-up against
        the now-quiesced source (converges immediately), trim the moved
        span out of the source, and swap the routing table. The gate is
        held only for phase 2, so the expensive byte copy happens under
        full traffic and no operation ever observes a half-split fleet.
        """
        with self._admin:
            with self._gate:
                lows = list(self.serve.lows)
                shards = list(self.serve.shards)
            at = int(at)
            si = max(0, bisect.bisect_right(lows, at) - 1)
            lo_i, hi_i = partition_spans(lows)[si]
            src = shards[si]
            if align:
                at = self._align_split(src, at, lo_i, hi_i)
            if not lo_i < at < hi_i:
                raise ValueError(
                    f"split point {at} outside owning span "
                    f"[{lo_i}, {hi_i}) or already a boundary")
            dst_dir = self._dir_for(at)
            fol = ShardFollower(src, dst_dir, lo=at, hi=hi_i,
                                io=self._io, registry=self.registry,
                                events=self.events)
            fol.catch_up_until(lag_target=lag_target,
                               max_rounds=catchup_rounds)
            with self._gate:
                self.serve.engine.close(wait=True)
                final = fol.catch_up_until(lag_target=0, max_rounds=4)
                if trim_source:
                    # drop the moved span from the source so its own
                    # scans (and a later merge) never see stale rows;
                    # must come *after* the last catch-up or the
                    # tombstone would replicate onto the new shard
                    src.delete_range(at, min(hi_i, KEY_SPACE - 1))
                pairs = list(zip(lows, shards))
                pairs.insert(si + 1, (at, fol.db))
                self.serve.swap_shards(pairs)
                moved = self._ops_by_shard.get(lo_i, 0) // 2
                self._ops_by_shard[lo_i] = moved
                self._ops_by_shard[at] = moved
            self._c_splits.inc()
            self.events.emit("shard_split", at=str(at), src_lo=str(lo_i),
                             hi=str(min(hi_i, KEY_SPACE - 1)),
                             shipped_bytes=fol.report["bytes"],
                             final_lag=final["lag"])
            return dict(at=at, src_lo=lo_i, hi=hi_i,
                        shipped=fol.report, final=final)

    def merge(self, at: int, *, flush_source: bool = True) -> dict:
        """Merge the shard starting at boundary ``at`` into its left
        neighbor while serving traffic; the inverse of :meth:`split`.

        Phase 1 (live): bulk-copy the right shard's immutable files into
        the neighbor's directory under freshly allocated names. Phase 2
        (gated): drain, take the right shard's atomic
        ``replication_snapshot``, copy any files that appeared since,
        absorb span + records into the neighbor in one manifest commit,
        and swap routing without the retired shard. Its directory is
        left on disk for operator cleanup."""
        with self._admin:
            with self._gate:
                lows = list(self.serve.lows)
                shards = list(self.serve.shards)
            at = int(at)
            if at not in lows or at == lows[0]:
                raise ValueError(f"{at} is not a mergeable shard boundary")
            si = lows.index(at)
            b, a = shards[si], shards[si - 1]
            lo_b, hi_b = partition_spans(lows)[si]
            if flush_source:
                # shrink the gated delta: move B's overlay into tables
                # while traffic still flows
                b.flush()
            io = self._io if self._io is not None else b.io
            # the copies belong to no Version of A until absorb_shard
            # commits them: reserve each name before its bytes land so
            # A's file GC (a flush's, a release hook's) leaves them be
            rename: dict[str, str] = {}
            try:
                state0 = b.storage.load_state()
                if state0 is not None:
                    fetch_files(subset_state(state0, at, hi_b), b.storage,
                                a.storage, io=io, rename=rename,
                                reserve=a.reserve_incoming)
                with self._gate:
                    self.serve.engine.close(wait=True)
                    state1, recs, _ver = b.replication_snapshot(0)
                    recs = clip_records(recs, at, hi_b)
                    if state1 is not None:
                        sub = subset_state(state1, at, hi_b)
                        fetch_files(sub, b.storage, a.storage, io=io,
                                    rename=rename,
                                    reserve=a.reserve_incoming)
                    else:
                        sub = dict(seq=int(b.seq), partitions=[],
                                   unavailable=[])
                    report = a.absorb_shard(at, hi_b, sub, recs,
                                            rename=rename)
                    pairs = [(lo, db) for lo, db in zip(lows, shards)
                             if lo != at]
                    self.serve.swap_shards(pairs)
                    self._ops_by_shard[lows[si - 1]] = (
                        self._ops_by_shard.get(lows[si - 1], 0)
                        + self._ops_by_shard.pop(at, 0))
            except BaseException:
                # keeps whatever absorb_shard already committed
                a.abandon_incoming(rename.values())
                raise
            b.close()
            retired_dir = b.cfg.data_dir
            if retired_dir and os.path.basename(
                    retired_dir).startswith("shard-"):
                # move the retired directory out of the shard namespace so
                # a reopened cluster's layout discovery does not resurrect
                # it; kept on disk for operator cleanup
                base = os.path.join(
                    os.path.dirname(retired_dir),
                    "retired-" + os.path.basename(retired_dir)[len("shard-"):])
                dst = base
                n = 0
                while os.path.exists(dst):
                    n += 1
                    dst = f"{base}.{n}"
                os.rename(retired_dir, dst)
            self._c_merges.inc()
            self.events.emit("shard_merge", at=str(at),
                             into=str(lows[si - 1]),
                             files=len(rename), **report)
            return dict(at=at, into=lows[si - 1], files=len(rename),
                        **report)

    # ---------------- replicas ----------------
    def add_replica(self, shard_lo: int = 0, dst_dir: str | None = None
                    ) -> Replica:
        """Ship a full-range read replica of one shard; it serves reads
        from its own store and catches up on demand (``catch_up`` /
        ``catch_up_until``)."""
        with self._admin:
            si = self.serve.lows.index(int(shard_lo))
            src = self.serve.shards[si]
            if dst_dir is None:
                dst_dir = os.path.join(
                    self.root,
                    f"replica-{int(shard_lo):020d}-{len(self.replicas)}")
            rep = Replica(src, dst_dir, io=self._io,
                          registry=self.registry, events=self.events)
            self.replicas.append(rep)
            return rep

    # ---------------- placement ----------------
    def maybe_split(self, factor: float = 2.0, min_ops: int = 512):
        """Split the hottest shard when its routed-op count exceeds
        ``factor`` times the mean of the others (or ``min_ops`` total
        for a single-shard fleet). Returns the split point or None."""
        with self._admin:
            lows = list(self.serve.lows)
            counts = {lo: int(self._ops_by_shard.get(lo, 0))
                      for lo in lows}
            total = sum(counts.values())
            if total < min_ops:
                return None
            hot = max(lows, key=lambda lo: counts[lo])
            others = [counts[lo] for lo in lows if lo != hot]
            if others:
                baseline = sum(others) / len(others)
                if counts[hot] < factor * max(1.0, baseline):
                    return None
            si = lows.index(hot)
            lo_i, hi_i = partition_spans(lows)[si]
            at = pick_split(self.serve.shards[si], lo_i, hi_i)
            if at is None or at in lows:
                return None
            self.split(at)
            return at

    def start_placement(self, interval_s: float = 0.5,
                        factor: float = 2.0, min_ops: int = 512) -> None:
        """Run :meth:`maybe_split` periodically in a daemon thread."""
        if self._placer is not None:
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.maybe_split(factor=factor, min_ops=min_ops)
                except Exception:
                    log.exception("placement round failed")

        self._placer_stop = stop
        self._placer = threading.Thread(
            target=loop, name="cluster-placement", daemon=True)
        self._placer.start()

    def stop_placement(self) -> None:
        if self._placer is None:
            return
        self._placer_stop.set()
        self._placer.join()
        self._placer = None
        self._placer_stop = None

    # ---------------- lifecycle ----------------
    def close(self) -> None:
        self.stop_placement()
        with self._gate:
            self.serve.close()
            for rep in self.replicas:
                rep.close()
            for db in self.serve.shards:
                db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
