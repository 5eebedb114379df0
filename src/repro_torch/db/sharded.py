"""Host-side range routing for RemixDB's partitions and shards.

The reference module also holds the distributed store: partitions sharded
over a JAX mesh, queries exchanged with ``shard_map`` + ``all_to_all``.
That half is not ported yet (it becomes ``torch.distributed``
``all_to_all_single`` in a later slice); this module carries only the
routing rules that the store, its cursor and its executor share.
"""
from __future__ import annotations

import bisect

import numpy as np


def route_host(lows, keys) -> np.ndarray:
    """Host-side range routing: owner index per key.

    ``lows`` are the sorted inclusive lower bounds of the ranges (the
    first covers everything below it too); one vectorized searchsorted
    routes a whole batch. This is the single routing primitive shared by
    ``RemixDB`` (partition routing in ``flush``/``get_batch``/
    ``scan_batch``) and ``the serving engine`` (shard routing), so a
    sharded batch is split with the same arithmetic at every level.
    """
    lows = np.asarray(lows, np.uint64)
    keys = np.asarray(keys, np.uint64)
    return np.maximum(np.searchsorted(lows, keys, side="right") - 1, 0)


def route_one(parts_or_lows, key: int) -> int:
    """Scalar :func:`route_host`: owning range index of one key.

    Accepts a sequence of partitions/shards (anything with ``.lo``) or
    raw lower bounds — the single routing rule shared by the store's
    point reads and the cursor's seek.
    """
    lows = [int(getattr(x, "lo", x)) for x in parts_or_lows]
    return max(0, bisect.bisect_right(lows, int(key)) - 1)


def partition_spans(lows) -> list[tuple[int, int]]:
    """``[lo, hi)`` key spans for sorted inclusive lower bounds.

    The companion of :func:`route_host`: each range's exclusive upper
    bound is the next range's lower bound (the last spans to 2**64).
    Shared by the store's scans and :class:`repro_torch.db.cursor.RemixCursor`
    so partition/shard boundaries are computed by one rule everywhere.
    Python ints, not uint64: the final bound 2**64 must be representable.
    """
    lows = [int(x) for x in lows]
    return list(zip(lows, lows[1:] + [1 << 64]))
