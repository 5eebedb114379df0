"""``tests/test_system.py:24`` (``test_kvstore_end_to_end``) on twin stores
(``tests/torch_twin.py``): the RemixDB lifecycle — load, compactions of
every kind, point and range queries, overwrites and deletes, WAL recovery
— run on the reference's store and the port's on the CPU with every
answer equal bit for bit, both held to a dict + sorted-list oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from torch_twin import pair_class  # noqa: E402

RemixDB = pair_class(RRemixDB)


def test_kvstore_end_to_end(tmp_path):
    rng = np.random.default_rng(123)
    db = RemixDB(RemixDBConfig(
        memtable_entries=1024,
        wal_dir=str(tmp_path),
        compaction=CompactionConfig(table_cap=512, t_max=6),
        hot_threshold=4,
    ))
    oracle: dict[int, int] = {}
    for epoch in range(6):  # mixed inserts / overwrites / deletes
        keys = rng.choice(20_000, size=1500, replace=False).astype(np.uint64)
        vals = rng.integers(1, 2**31, size=(1500, 2)).astype(np.uint32)
        db.put_batch(keys, vals)
        for k, v in zip(keys.tolist(), vals):
            oracle[k] = int(v[0])
        dels = rng.choice(keys, size=50, replace=False)
        for k in dels.tolist():
            db.delete(k)
            oracle.pop(k, None)
        db.flush()
    probe = rng.choice(20_000, size=800, replace=False).astype(np.uint64)
    found, vals = db.get_batch(probe)
    for i, k in enumerate(probe.tolist()):
        if k in oracle:
            assert found[i] and int(vals[i, 0]) == oracle[k], k
        else:
            assert not found[i], k
    live = np.array(sorted(oracle), np.uint64)
    for start in rng.choice(live, size=10):
        kk, _ = db.scan(int(start), 40)
        i0 = int(np.searchsorted(live, start))
        np.testing.assert_array_equal(kk, live[i0: i0 + 40])
    kinds = {k for st in db.compaction_log for k in st["kinds"]}
    assert "minor" in kinds and ("major" in kinds or "split" in kinds)
    db.put(10**9, [42, 0])
    db.wal.sync()
    mem = db.recover_memtable()
    assert mem.get(10**9) is not None and int(mem.get(10**9).val[0]) == 42
