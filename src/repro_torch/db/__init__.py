"""RemixDB (paper §4): a REMIX-indexed, tiered-compaction, partitioned store.

  - memtable:   sorted write buffer with 8-bit update counters (§4.2 TRIAD)
  - wal:        4 KB-block write-ahead log with virtual logs + GC (§4.3)
  - partition:  key-range partition = table files + one REMIX
  - compaction: abort / minor / major / split procedures (§4.2)
  - version:    immutable refcounted Versions + pinned Snapshots (MVCC)
  - cursor:     RemixCursor — §3.2 seek/peek/next/skip over a snapshot
  - ops:        typed operation model (Op / Batch / OpResult, API v2)
  - executor:   planner–executor behind submit(): admission, deadlines,
                cross-shard fan-out, async futures
  - store:      the RemixDB public API
  - scrub:      integrity scrub, rate limiter, REMIX rebuild from CKBs
  - sharded:    range routing, and the store sharded over the ranks of a
                process group (``all_to_all_single`` query exchange)
  - sstable:    baseline SSTable metadata (block index + bloom filters)
  - baseline:   LevelDB-like leveled / tiered comparison stores
"""
from repro_torch.db.cursor import RemixCursor  # noqa: F401
from repro_torch.db.executor import Executor  # noqa: F401
from repro_torch.db.ops import (  # noqa: F401
    Batch,
    BatchResult,
    Op,
    OpKind,
    OpResult,
    OpStatus,
)
from repro_torch.db.store import RemixDB, RemixDBConfig  # noqa: F401
from repro_torch.db.version import Snapshot, Version, VersionSet  # noqa: F401
