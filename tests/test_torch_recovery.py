"""Store-level recovery and build-kind cases of ``tests/test_io.py``
(lines 191–314), held between the JAX package and the port on twin
stores (``tests/torch_twin.py``): every call goes to the reference's
``RemixDB`` and to the port's on the CPU, each in its own data directory
(the port's is ``<dir>.port``), and the answers must be equal bit for
bit; each case's own assertions then hold for both, and the files each
side leaves on disk are checked on both sides.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.io import manifest as RMan  # noqa: E402
from repro_torch.io import manifest as TMan  # noqa: E402
from torch_twin import pair_class  # noqa: E402

RemixDB = pair_class(RRemixDB)


def _mkdb(data_dir, **kw):
    return RemixDB(RemixDBConfig(
        memtable_entries=kw.pop("memtable_entries", 512),
        compaction=CompactionConfig(table_cap=256, t_max=6),
        data_dir=str(data_dir),
        hot_threshold=kw.pop("hot_threshold", 255),
        **kw,
    ))


def _pair(kv):
    k = np.asarray(kv, np.uint64)
    return k, np.stack([k & 0xFFFFFFFF, k >> 32], 1).astype(np.uint32)


def test_reopen_identical_after_compaction_cycles(tmp_path):
    db = _mkdb(tmp_path / "db")
    rng = np.random.default_rng(5)
    chunks = []
    for _ in range(4):  # >= 3 flush/compaction cycles
        keys, vals = _pair(rng.choice(100_000, size=600, replace=False))
        db.put_batch(keys, vals)
        db.flush()
        chunks.append(keys)
    kinds = {k for st in db.compaction_log for k in st["kinds"]}
    assert "minor" in kinds
    dead = int(chunks[0][0])
    db.delete(dead)
    db.close()
    probe = np.concatenate(chunks + [np.array([100_001], np.uint64)])
    f0, v0 = db.get_batch(probe)
    k0, vv0 = db.scan(0, 500)
    db2 = RemixDB.open(str(tmp_path / "db"))
    f1, v1 = db2.get_batch(probe)
    k1, vv1 = db2.scan(0, 500)
    np.testing.assert_array_equal(f0, f1)
    np.testing.assert_array_equal(v0[f0], v1[f1])
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(vv0, vv1)
    assert db2.get(dead) is None


def test_crash_mid_flush_recovers_from_wal(tmp_path, monkeypatch):
    db = _mkdb(tmp_path / "db", memtable_entries=1 << 30)
    db.put_batch(*_pair(np.arange(0, 1000)))
    db.flush()  # committed version 1
    db.put_batch(*_pair(np.arange(1000, 2000)))
    db.wal.sync()  # records durable; memtable not yet flushed
    # power loss after tables/remix are written but before the commit
    for storage in (RMan.Storage, TMan.Storage):
        monkeypatch.setattr(storage, "commit", lambda self, state: (_ for _ in ()).throw(
            RuntimeError("power loss")))
    with pytest.raises(RuntimeError):
        db.flush()  # both sides raise
    monkeypatch.undo()
    db2 = RemixDB.open(str(tmp_path / "db"))
    f, v = db2.get_batch(np.arange(0, 2000, dtype=np.uint64))
    assert f.all()
    np.testing.assert_array_equal(v[:, 0], np.arange(2000, dtype=np.uint32))
    kk, _ = db2.scan(0, 2000)
    np.testing.assert_array_equal(kk, np.arange(2000, dtype=np.uint64))
    for side in (db2.ref, db2.port):  # the crashed flush's files collected
        live = {n for pe in side.storage.load_state()["partitions"] for n in pe["tables"]}
        assert set(os.listdir(side.storage.tables_dir)) == live


def test_wal_tail_recovery_without_close(tmp_path):
    db = _mkdb(tmp_path / "db", memtable_entries=1 << 30)
    k = np.arange(500, dtype=np.uint64)
    db.put_batch(k, np.zeros((500, 2), np.uint32))
    db.flush()  # checkpoint
    for i in range(300):  # post-checkpoint appends (no commit follows)
        db.put(10_000 + i, [i, 0])
    db.wal.sync()
    db2 = RemixDB.open(str(tmp_path / "db"))
    f, v = db2.get_batch(np.arange(10_000, 10_300, dtype=np.uint64))
    assert f.all()
    np.testing.assert_array_equal(v[:, 0], np.arange(300, dtype=np.uint32))
    f, _ = db2.get_batch(k)
    assert f.all()
    assert db2.seq == db.seq


def test_crash_before_first_commit_recovers_wal(tmp_path):
    db = _mkdb(tmp_path / "db", memtable_entries=1 << 30)
    k, vals = _pair(np.arange(500))
    db.put_batch(k, vals)
    db.wal.sync()  # durable; no flush, no commit, hard crash
    db2 = RemixDB.open(str(tmp_path / "db"))
    f, v = db2.get_batch(k)
    assert f.all()
    np.testing.assert_array_equal(v[:, 0], np.arange(500, dtype=np.uint32))
    assert db2.seq == db.seq


def test_superseded_files_reclaimed_at_commit(tmp_path):
    db = _mkdb(tmp_path / "db")
    rng = np.random.default_rng(7)
    for _ in range(4):
        keys = rng.choice(100_000, size=600, replace=False).astype(np.uint64)
        db.put_batch(keys, np.zeros((600, 2), np.uint32))
        db.flush()
    for side in (db.ref, db.port):
        state = side.storage.load_state()
        live_tables = {n for pe in state["partitions"] for n in pe["tables"]}
        live_remix = {pe["remix"] for pe in state["partitions"] if pe["remix"]}
        assert set(os.listdir(side.storage.tables_dir)) == live_tables
        assert set(os.listdir(side.storage.remix_dir)) == live_remix
    assert db.storage.load_state() is not None  # the two states compared equal


def test_partition_build_kinds(tmp_path):
    """Minor compactions rebuild incrementally; splits fall back to scratch."""
    db = _mkdb(tmp_path / "db", memtable_entries=400)
    rng = np.random.default_rng(6)
    seen = set()
    for _ in range(8):
        keys = rng.choice(50_000, size=400, replace=False).astype(np.uint64)
        db.put_batch(keys, np.zeros((400, 2), np.uint32))
        db.flush()
        seen.update(p.last_build_kind for p in db.partitions)
    assert "incremental" in seen
    found, _ = db.get_batch(keys[:100])
    assert found.all()
