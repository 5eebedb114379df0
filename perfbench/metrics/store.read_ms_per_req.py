"""Store read path and cursor (db/store.py, db/cursor.py): self time of the
``shardN:read`` spans (their cache_fetch / disk_read / ckb_decode children
taken out), in ms a request of the window."""


def read(run):
    sp = run.spans(r"shard\d+:read")
    if not sp:
        return None
    return sum(s.self_time() for s in sp) * 1e3 / len(run.window)
