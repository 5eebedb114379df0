"""Shared LRU cache of checksum-verified file blocks (carried from
``repro.io.blockcache``; pure Python).

One :class:`BlockCache` instance is shared by every lazy table handle of a
store (and, through the serving engine, across stores): the cache key
is ``(file identity, block index)``, so partitions compete for one
bytes-budgeted pool instead of each hoarding private copies.
Cached payloads are the *verified* 64 KB checksum granules of SSTable
data regions — a hit skips both the disk read and the CRC32C check, which
is safe because table files are immutable and readers bind the file's
inode + mtime into the key (``SSTableReader._cache_key``): a file *name*
can be reused by a later ``Storage`` (ids restart at 1 + the highest
surviving file), but a reused name never resolves to stale blocks.

Capacity is a byte budget, not an entry count: eviction pops
least-recently-used granules until the budget holds. Hit/miss/eviction
counters live in a :class:`repro_torch.obs.metrics.MetricsRegistry` (names
``cache_*``); the legacy attributes (``cache.hits`` …) and the
``stats()`` dict read straight from the registry instruments, so
``RemixDB.stats()["cache"]`` is bit-compatible with the pre-registry
layout.

Payloads are any immutable bytes-like object. In ``cache_mode="copy"``
(the default) they are heap ``bytes``; in ``cache_mode="mmap"``
(:class:`repro_torch.io.sstable.SSTableReader`) they are zero-copy
``memoryview`` slices of the table file's mapping — the budget then
bounds *verified mapped* bytes rather than heap copies, and an eviction
merely drops the view (a later access re-serves the same pages without
another checksum pass).

Prefetch accounting (paper Fig 10 pipeline): blocks inserted through
:meth:`prefetch` are tagged until their first ``get``. A tagged block
served to a reader counts as a *prefetch hit*; a tagged block evicted
(or cleared) before anyone read it counts as *prefetch waste*. The
counters surface in ``stats()`` so cold-scan pipelining can prove it
fetches no block the eager path would not have fetched.

Tracing: when a trace is active on the calling thread (see
:mod:`repro_torch.obs.tracing`), :meth:`get_or_load` records a ``cache_fetch``
span (with hit/miss and byte count); the miss path's ``loader()`` runs
inside it, so ``disk_read`` leaf spans from the SSTable reader nest
underneath.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

DEFAULT_CAPACITY = 64 << 20  # 64 MB


class BlockCache:
    """Bytes-budgeted LRU over immutable, already-verified file blocks."""

    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY,
                 registry: "_metrics.MetricsRegistry | None" = None):
        if capacity_bytes <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self._blocks: OrderedDict[Hashable, bytes] = OrderedDict()
        self.cached_bytes = 0
        self._prefetched: set[Hashable] = set()
        reg = registry if registry is not None else _metrics.MetricsRegistry()
        self.registry = reg
        self._c_hits = reg.counter("cache_hits")
        self._c_misses = reg.counter("cache_misses")
        self._c_evictions = reg.counter("cache_evictions")
        self._c_pf_issued = reg.counter("cache_prefetch_issued")
        self._c_pf_hits = reg.counter("cache_prefetch_hits")
        self._c_pf_waste = reg.counter("cache_prefetch_waste")
        reg.gauge("cache_entries", fn=lambda: len(self._blocks))
        reg.gauge("cache_cached_bytes", fn=lambda: self.cached_bytes)
        reg.gauge("cache_capacity_bytes", fn=lambda: self.capacity_bytes)

    # legacy counter attributes — live views over the registry
    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @property
    def evictions(self) -> int:
        return self._c_evictions.value

    @property
    def prefetch_issued(self) -> int:
        return self._c_pf_issued.value

    @property
    def prefetch_hits(self) -> int:
        return self._c_pf_hits.value

    @property
    def prefetch_waste(self) -> int:
        return self._c_pf_waste.value

    def __len__(self) -> int:
        return len(self._blocks)

    def contains(self, key: Hashable) -> bool:
        """Residence probe with **no** side effects: hit/miss counters,
        LRU order and prefetch tags are untouched. Lets readers plan
        around residency (e.g. skip pipelining a fully-warm window)
        without distorting the accounting the tests assert on."""
        return key in self._blocks

    def get(self, key: Hashable) -> bytes | None:
        """Cached payload for ``key`` (marks it most-recently-used)."""
        data = self._blocks.get(key)
        if data is None:
            self._c_misses.inc()
            return None
        self._blocks.move_to_end(key)
        self._c_hits.inc()
        if key in self._prefetched:
            self._prefetched.discard(key)
            self._c_pf_hits.inc()
        return data

    def put(self, key: Hashable, data: bytes) -> None:
        """Insert ``data``; evicts LRU entries to stay within budget.

        Payloads larger than the whole budget are served but not cached.
        """
        old = self._blocks.pop(key, None)
        if old is not None:
            self.cached_bytes -= len(old)
        if len(data) > self.capacity_bytes:
            return
        self._blocks[key] = data
        self.cached_bytes += len(data)
        while self.cached_bytes > self.capacity_bytes:
            vkey, victim = self._blocks.popitem(last=False)
            self.cached_bytes -= len(victim)
            self._c_evictions.inc()
            if vkey in self._prefetched:
                self._prefetched.discard(vkey)
                self._c_pf_waste.inc()

    def get_or_load(self, key: Hashable, loader: Callable[[], bytes]) -> bytes:
        """``get`` with a miss-path ``loader()`` whose result is cached."""
        tr = _tracing.current()
        if tr is None:
            data = self.get(key)
            if data is None:
                data = loader()
                self.put(key, data)
            return data
        with tr.span("cache_fetch") as sp:
            data = self.get(key)
            hit = data is not None
            if data is None:
                data = loader()
                self.put(key, data)
            sp.args.update(hit=hit, bytes=len(data))
        return data

    def prefetch(self, key: Hashable, loader: Callable[[], bytes]) -> None:
        """Load ``key`` into the cache ahead of demand (Fig 10 pipeline).

        No-op when the block is already resident (the demand path — or an
        earlier prefetch — won the race). A prefetched block stays tagged
        until its first :meth:`get`; see the module docstring for how the
        hit/waste counters resolve. Prefetch loads do not count as misses:
        ``misses`` keeps meaning "demand reads that had to touch disk".
        """
        if key in self._blocks:
            return
        data = loader()
        self.put(key, data)
        if key in self._blocks:  # may be budget-rejected (oversized payload)
            self._prefetched.add(key)
            self._c_pf_issued.inc()

    def clear(self) -> None:
        self._blocks.clear()
        self.cached_bytes = 0
        self._c_pf_waste.inc(len(self._prefetched))
        self._prefetched.clear()

    def stats(self) -> dict:
        return dict(
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
            entries=len(self._blocks),
            cached_bytes=self.cached_bytes,
            capacity_bytes=self.capacity_bytes,
            prefetch_issued=self.prefetch_issued,
            prefetch_hits=self.prefetch_hits,
            prefetch_waste=self.prefetch_waste,
        )
