"""Store read path (db/store.py ``_get_batch_at``): the ``store.overlay``
spans, the per-key memtable overlay probe, the range-tombstone check and
the routing to partitions, in ms a request of the window."""


def read(run):
    sp = run.spans(r"store\.overlay")
    return sum(s.duration for s in sp) * 1e3 / len(run.window) if sp else None
