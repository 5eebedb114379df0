"""Load-driven placement: where to split a hot shard.

REMIX partitions already carry per-partition access counters
(``cold_gets``/``cold_scans``, the paper's hot/cold accounting), so the
split point that best halves a shard's *observed* load is computable
from state the store maintains anyway. When a shard has seen no cold
traffic (fresh, or everything served from the MemTable) the row counts
are the fallback, halving data volume instead.
"""
from __future__ import annotations

from repro_torch.db.sharded import partition_spans

KEY_SPACE = 1 << 64


def pick_split(db, lo: int = 0, hi: int | None = None) -> int | None:
    """The partition boundary inside ``(lo, hi)`` nearest the cumulative
    half of the shard's weight (observed cold traffic, falling back to
    row counts). Returns ``None`` when the span has fewer than two
    partitions — there is no boundary to split at without a rewrite,
    which this tier never does.
    """
    lo = int(lo)
    hi = KEY_SPACE if hi is None else int(hi)
    parts = sorted(db.partitions, key=lambda p: p.lo)
    spans = partition_spans([p.lo for p in parts])
    inside = [p for p, (plo, phi) in zip(parts, spans)
              if phi > lo and plo < hi]
    if len(inside) < 2:
        return None
    loads = [int(p.cold_gets) + int(p.cold_scans) for p in inside]
    if sum(loads) == 0:
        loads = [int(p.n_entries) for p in inside]
    total = sum(loads)
    if total == 0:
        # no signal at all: bisect the partition list
        return int(inside[len(inside) // 2].lo)
    best, best_err = None, None
    cum = 0
    for i in range(len(inside) - 1):
        cum += loads[i]
        boundary = int(inside[i + 1].lo)
        err = abs(2 * cum - total)  # |cum - total/2| without the division
        if boundary > lo and (best_err is None or err < best_err):
            best, best_err = boundary, err
    return best
