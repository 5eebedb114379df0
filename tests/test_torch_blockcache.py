"""The cold read path and block cache, held between the JAX package and
the port: the cold get/scan cases of ``tests/test_blockcache.py`` (lines
120–293) run on twin stores (``tests/torch_twin.py``). The reference
writes each on-disk store and the port opens a byte-identical copy of it
(``<root>.port``); every call goes to both stores, and the answers — hot
and cold, found masks, values, scan keys, stats, raised errors — must be
equal, after which the case's own assertions hold for both.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.remix import build_remix  # noqa: E402
from repro.core.runs import make_run  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.db.wal import WAL  # noqa: E402
from repro.io.manifest import Storage  # noqa: E402
from repro.io.sstable import SSTableReader  # noqa: E402
from torch_twin import pair_class  # noqa: E402

RemixDB = pair_class(RRemixDB)


def _commit_store(root, runs, d=32, seq=1_000_000):
    """Commit prebuilt runs as a single-partition on-disk store, and copy
    it to the port's twin directory."""
    storage = Storage(root)
    names = [
        storage.write_table(
            np.asarray(run.keys), np.asarray(run.vals),
            np.asarray(run.seq), np.asarray(run.tomb),
        )
        for run in runs
    ]
    remix, _ = build_remix(runs, d=d)
    xname = storage.write_remix(remix)
    wal = WAL(storage.wal_path())
    storage.commit(dict(seq=seq, vw=2, d=d,
                        partitions=[dict(lo=0, tables=names, remix=xname)],
                        wal=wal.save_state()))
    shutil.copytree(root, root + ".port")


def _build_store(root, r_tables=4, n_per_table=4096, tomb_every=0, d=32):
    rng = np.random.default_rng(1)
    total = r_tables * n_per_table
    domain = np.arange(1, total + 1, dtype=np.uint64) * 8
    owner = rng.integers(0, r_tables, total)
    runs, seqbase = [], 1
    for i in range(r_tables):
        kk = domain[owner == i]
        tomb = np.zeros(len(kk), bool)
        if tomb_every:
            tomb[::tomb_every] = True
        runs.append(make_run(kk, seq=np.arange(seqbase, seqbase + len(kk),
                                               dtype=np.uint32), tomb=tomb))
        seqbase += len(kk)
    _commit_store(root, runs, d=d, seq=seqbase)
    return domain


def _cold_cfg(**kw):
    # promote_fraction > 1 pins the store to the cold path for the whole test
    return RemixDBConfig(promote_fraction=kw.pop("promote_fraction", 2.0), **kw)


def both(twin_obj, attr):
    """An attribute of each side of a twin (for objects, not values)."""
    return getattr(twin_obj.ref, attr), getattr(twin_obj.port, attr)


def test_cold_get_matches_hot(tmp_path):
    root = str(tmp_path / "db")
    domain = _build_store(root, tomb_every=7)
    rng = np.random.default_rng(2)
    probes = np.concatenate(
        [rng.choice(domain, 300, replace=False), rng.choice(domain, 100) + 1,
         np.array([0, int(domain[-1]) + 10], np.uint64)]).astype(np.uint64)
    hot = RemixDB.open(root, RemixDBConfig(cold_reads=False))
    cold = RemixDB.open(root, _cold_cfg())
    f0, v0 = hot.get_batch(probes)
    f1, v1 = cold.get_batch(probes)
    np.testing.assert_array_equal(f0, f1)
    np.testing.assert_array_equal(v0[f0], v1[f1])
    st = cold.stats()
    assert st["cold"]["gets"] == len(probes)
    assert st["cache"]["hits"] > 0
    assert st["resident_tables"] == 0
    assert cold.disk_bytes_read() <= hot.disk_bytes_read()


def test_cold_scan_matches_hot(tmp_path):
    root = str(tmp_path / "db")
    domain = _build_store(root, tomb_every=5)
    hot = RemixDB.open(root, RemixDBConfig(cold_reads=False))
    cold = RemixDB.open(root, _cold_cfg())
    for start, n in [(0, 100), (int(domain[777]), 64), (int(domain[-3]), 50)]:
        k0, v0 = hot.scan(start, n)
        k1, v1 = cold.scan(start, n)
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_array_equal(v0, v1)
    assert cold.stats()["cold"]["scans"] > 0
    assert cold.stats()["resident_tables"] == 0


def test_cold_scan_batch_matches_hot(tmp_path):
    root = str(tmp_path / "db")
    domain = _build_store(root, tomb_every=3)
    hot = RemixDB.open(root, RemixDBConfig(cold_reads=False))
    cold = RemixDB.open(root, _cold_cfg())
    starts = np.array([0, int(domain[100]), int(domain[-50]), int(domain[-1]) + 8],
                      np.uint64)
    k0, m0 = hot.scan_batch(starts, 20)
    k1, m1 = cold.scan_batch(starts, 20)
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(m0, m1)


def test_cold_scan_placeholder_landing_matches_device(tmp_path):
    root = str(tmp_path / "db")
    rng = np.random.default_rng(9)
    u_a = np.arange(1, 401, dtype=np.uint64) * 4
    u_b = np.sort(rng.choice(u_a, 160, replace=False))  # newer versions
    _commit_store(root, [make_run(u_a, seq=np.arange(1, 401, dtype=np.uint32)),
                         make_run(u_b, seq=np.arange(1000, 1160, dtype=np.uint32))],
                  d=4)
    hot = RemixDB.open(root, RemixDBConfig(cold_reads=False))
    cold = RemixDB.open(root, _cold_cfg())
    starts = np.arange(0, int(u_a[-1]) + 8, 3, dtype=np.uint64)
    k0, m0 = hot.scan_batch(starts, 16)
    k1, m1 = cold.scan_batch(starts, 16)
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(m0, m1)


def test_scan_survives_tombstone_runs_wider_than_window(tmp_path):
    root = str(tmp_path / "db")
    u = np.arange(1, 101, dtype=np.uint64) * 10
    tomb = np.zeros(100, bool)
    tomb[:60] = True  # first 60 keys deleted
    _commit_store(root, [make_run(u, seq=np.arange(1, 101, dtype=np.uint32), tomb=tomb)])
    for cfg in (RemixDBConfig(cold_reads=False), _cold_cfg()):
        db = RemixDB.open(root, cfg)
        kk, _ = db.scan(5, 4)  # width 8 << 60 tombstones
        np.testing.assert_array_equal(kk, u[60:64])
        kb, mb = db.scan_batch(np.array([5], np.uint64), 4)
        np.testing.assert_array_equal(kb[0][mb[0]], u[60:64])


def test_recovery_adopts_persisted_group_size(tmp_path):
    root = str(tmp_path / "db")
    domain = _build_store(root, d=8)
    db = RemixDB.open(root)  # default config asks for d=32
    assert db.cfg.d == 8
    starts = np.array([0, int(domain[50]), int(domain[-30])], np.uint64)
    k0, m0 = RemixDB.open(root, RemixDBConfig(cold_reads=False)).scan_batch(starts, 16)
    k1, m1 = RemixDB.open(root, _cold_cfg()).scan_batch(starts, 16)
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(m0, m1)


def test_cold_promotion_builds_device_index(tmp_path):
    root = str(tmp_path / "db")
    domain = _build_store(root)
    db = RemixDB.open(root, RemixDBConfig(promote_fraction=0.0))
    assert db.get(int(domain[5])) is not None  # promoted immediately
    assert db.stats()["cold"]["gets"] == 0
    ref_p, port_p = db.ref.partitions[0], db.port.partitions[0]
    assert ref_p._remix is not None
    # the port's twin reads through its device views: the promoted
    # partition's device index is its view's
    assert id(port_p) in db.port.device_views._views


def test_corruption_detected_only_when_block_touched(tmp_path):
    root = str(tmp_path / "db")
    domain = _build_store(root, r_tables=1, n_per_table=40_000)
    storage = Storage(root)
    name = storage.manifest.load()["partitions"][0]["tables"][0]
    rd = SSTableReader(storage.table_path(name))
    vlo, vhi = rd._section_range("vals")
    bb = rd.block_bytes
    bad = (vlo - rd._data_start + bb - 1) // bb  # first granule inside vals
    blo = rd._data_start + bad * bb
    assert blo >= vlo and blo + bb <= vhi, "vals section too small for test"
    for path in (storage.table_path(name), Storage(root + ".port").table_path(name)):
        with open(path, "r+b") as f:
            f.seek(blo + 17)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    row_bad = (blo + bb // 2 - vlo) // rd.row_bytes("vals")
    row_ok = 10
    assert not (blo <= vlo + row_ok * rd.row_bytes("vals") < blo + bb)
    db = RemixDB.open(root, _cold_cfg())
    assert db.get(int(domain[row_ok])) is not None  # untouched block: fine
    with pytest.raises(ValueError, match="checksum"):
        db.get(int(domain[row_bad]))  # raised by both, same class


def test_stats_and_repr_do_not_force_load(tmp_path):
    root = str(tmp_path / "db")
    _build_store(root)
    db = RemixDB.open(root, _cold_cfg())
    st = db.stats()
    assert st["entries"] == 4 * 4096 and st["tables"] == 4
    for p in db.port.partitions:
        repr(p)
    assert db.stats()["resident_tables"] == 0
