"""The paper's baseline stores (``repro_torch.db.baseline``) against the
JAX package's, as twins (``tests/torch_twin.py``): every call goes to the
reference's store and to the port's on the CPU, and the answers must be
equal bit for bit — found masks, values, scan keys and masks, and the
written-byte counters behind write amplification.

The cases are ``tests/test_db.py:157``, ``:188`` and ``:206`` run on twin
stores, plus the written bytes of each store counted alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db.baseline import BaselineConfig  # noqa: E402
from repro.db.baseline import LeveledStore as RLeveled  # noqa: E402
from repro.db.baseline import TieredStore as RTiered  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from torch_twin import pair_class  # noqa: E402

LeveledStore = pair_class(RLeveled)
TieredStore = pair_class(RTiered)
RemixDB = pair_class(RRemixDB)


def small_cfg(tmp_path, **kw):
    return RemixDBConfig(
        memtable_entries=kw.pop("memtable_entries", 512),
        compaction=CompactionConfig(table_cap=256, t_max=6),
        wal_dir=str(tmp_path),
        hot_threshold=kw.pop("hot_threshold", 255),
        **kw,
    )


def written(store) -> tuple[int, int]:
    """(table_bytes_written, user_bytes), equal integers in both packages."""
    t, u = store.table_bytes_written, store.user_bytes
    assert isinstance(t, int) and isinstance(u, int)
    return t, u


def test_baseline_stores_agree_with_remixdb(tmp_path):
    rng = np.random.default_rng(3)
    keys = rng.choice(30_000, size=4000, replace=False).astype(np.uint64)
    vals = np.stack([keys & 0xFFFFFFFF, keys >> 32], 1).astype(np.uint32)
    bcfg = BaselineConfig(memtable_entries=512, table_cap=512)
    stores = [LeveledStore(bcfg), TieredStore(bcfg)]
    db = RemixDB(small_cfg(tmp_path, memtable_entries=512))
    for chunk in range(0, 4000, 1000):
        sl = slice(chunk, chunk + 1000)
        db.put_batch(keys[sl], vals[sl])
        for s in stores:
            s.put_batch(keys[sl], vals[sl])
    db.flush()
    for s in stores:
        s.flush()
    probe = np.concatenate([keys[::13], np.array([30_001], np.uint64)])
    f0, v0 = db.get_batch(probe)
    for s in stores:
        f, v = s.get_batch(probe)
        np.testing.assert_array_equal(f, f0)
        np.testing.assert_array_equal(v[f], v0[f0])
    skeys = np.sort(keys)
    start = int(skeys[100])
    k0, _ = db.scan(start, 50)
    for s in stores:
        k, _ = s.scan(start, 50)
        np.testing.assert_array_equal(k, k0)
    assert stores[1].write_amplification() <= stores[0].write_amplification()
    for s in stores + [db]:
        written(s)


def test_scan_batch_matches_scan(tmp_path):
    rng = np.random.default_rng(9)
    keys = rng.choice(50_000, size=6000, replace=False).astype(np.uint64)
    db = RemixDB(small_cfg(tmp_path, memtable_entries=1024))
    lv = LeveledStore(BaselineConfig(memtable_entries=1024, table_cap=1024))
    vals = np.zeros((len(keys), 2), np.uint32)
    db.put_batch(keys, vals)
    lv.put_batch(keys, vals)
    db.flush()
    lv.flush()
    starts = rng.choice(np.sort(keys), 40)
    for s in (db, lv):
        bk, bm = s.scan_batch(starts, 20)
        for i, st in enumerate(starts):
            kk, _ = s.scan(int(st), 20)
            np.testing.assert_array_equal(bk[i][bm[i]], kk[:20])


@pytest.mark.parametrize("cls", ["leveled", "tiered"])
def test_scan_batch_over_a_memtable_matches_scan(cls):
    """A batched scan over a non-empty memtable answers every start as
    ``scan`` does (the port batches the per-start merging iterator), with
    versions in several runs, tombstones and fresh memtable keys."""
    rng = np.random.default_rng(5)
    store = (LeveledStore if cls == "leveled" else TieredStore)(
        BaselineConfig(memtable_entries=256, table_cap=256))
    keys = np.arange(1, 3001, dtype=np.uint64) * 16
    store.put_batch(keys, np.zeros((len(keys), 2), np.uint32))
    for _ in range(4):  # versions of a hot span in several runs
        hot = keys[200:700]
        store.put_batch(hot, np.ones((len(hot), 2), np.uint32))
    store.put(int(keys[250]) + 1, np.full(2, 7, np.uint32))
    seq = store.seq  # a tombstone straight into the memtable (no delete API)
    store.mem.put(int(keys[260]), np.zeros(2, np.uint32), seq, tomb=True)
    store.seq = seq + 1
    starts = np.concatenate([keys[[0, 190, 240, 255, 690, 2990]],
                             rng.choice(keys, 20)])
    for n in (1, 10, 50):
        bk, bm = store.scan_batch(starts, n)
        for i, st in enumerate(starts):
            kk, _ = store.scan(int(st), n)
            np.testing.assert_array_equal(bk[i][bm[i]], kk[:n])


def test_write_amplification_ordering(tmp_path):
    """Paper fig 16 premise: tiered < RemixDB (tiered + REMIX) < leveled,
    in both packages, with equal written bytes."""
    rng = np.random.default_rng(4)
    n = 60_000
    keys = rng.permutation(n).astype(np.uint64)
    vals = np.zeros((n, 2), np.uint32)
    cfg = RemixDBConfig(
        memtable_entries=2048,
        wal_dir=str(tmp_path),
        compaction=CompactionConfig(table_cap=2048, t_max=10),
    )
    db = RemixDB(cfg)
    lv = LeveledStore(BaselineConfig(memtable_entries=2048, table_cap=2048))
    tr = TieredStore(BaselineConfig(memtable_entries=2048, table_cap=2048))
    for c in range(0, n, 2048):
        sl = slice(c, c + 2048)
        db.put_batch(keys[sl], vals[sl])
        lv.put_batch(keys[sl], vals[sl])
        tr.put_batch(keys[sl], vals[sl])
    db.flush()
    lv.flush()
    tr.flush()
    wa_db = db.table_bytes_written / max(1, db.user_bytes)
    wa_lv = lv.write_amplification()
    wa_tr = tr.write_amplification()
    assert wa_tr < wa_db < wa_lv, (wa_tr, wa_db, wa_lv)
    assert [written(s)[1] for s in (db, lv, tr)] == [n * 16] * 3
