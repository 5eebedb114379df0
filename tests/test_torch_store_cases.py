"""The store's tier-1 cases, held between the JAX package and the port.

Each case is a test of ``test_db``, ``test_versions``, ``test_batch_query``,
``test_ops``, ``test_delete_range``, ``test_model_store`` or
``test_device_view`` run on a twin store (``tests/torch_twin.py``): every
call goes to the reference's ``RemixDB`` and to the port's
``RemixDB(device="cpu")``, their answers must be equal bit for bit, and
the case's own assertions then hold for both. Where the reference's
config leaves ``device_path`` at ``"auto"`` (its legacy path on the
CPU), the port runs ``"on"``: its device views with the kernels' plain
versions, so every case also holds the port's device path to the
reference's host path. Cases that need one side's internals run on the
port alone and say so.
"""
import os
import random
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.remix import build_remix  # noqa: E402
from repro.core.runs import make_run  # noqa: E402
from repro.db import clock as rclock  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.ops import Batch, Op, OpInterrupted, OpKind, OpStatus  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.db.wal import WAL  # noqa: E402
from repro.io.manifest import Storage  # noqa: E402
from repro_torch.db import clock as tclock  # noqa: E402
from repro_torch.db import store as TS  # noqa: E402
from repro_torch.db.ops import OpInterrupted as TOpInterrupted  # noqa: E402
from repro_torch.db.ops import OpStatus as TOpStatus  # noqa: E402
from torch_twin import pair_class, twin_dir  # noqa: E402

RemixDB = pair_class(RRemixDB)
T0 = 1_000_000.0


@pytest.fixture(autouse=True)
def _reset_clocks():
    yield
    rclock.reset()
    tclock.reset()


def set_clock(fn):
    """One logical clock for both packages."""
    rclock.set_source(fn)
    tclock.set_source(fn)


def _cfg(tmp_path=None, **kw):
    comp = kw.pop("compaction", CompactionConfig(table_cap=256, t_max=6))
    return RemixDBConfig(
        memtable_entries=kw.pop("memtable_entries", 1 << 30),
        compaction=comp,
        wal_dir=str(tmp_path) if tmp_path is not None else None,
        hot_threshold=kw.pop("hot_threshold", 255),
        **kw,
    )


def _fill(db, keys):
    keys = np.asarray(keys, np.uint64)
    vals = np.stack([keys & 0xFFFFFFFF, keys >> 32], 1).astype(np.uint32)
    db.put_batch(keys, vals)
    return vals


def _metric(db, name):
    return sum(s["value"] for s in db.registry.snapshot()["metrics"]
               if s["name"] == name)


# ------------------------------------------------------------ test_db
def test_put_get_scan_roundtrip(tmp_path):
    db = RemixDB(_cfg(tmp_path, memtable_entries=512))
    rng = np.random.default_rng(0)
    keys = rng.choice(100_000, size=3000, replace=False).astype(np.uint64)
    _fill(db, keys)
    db.flush()
    probe = np.concatenate([keys[:500], np.array([100_001, 100_002], np.uint64)])
    found, got = db.get_batch(probe)
    assert found[:500].all() and not found[500:].any()
    np.testing.assert_array_equal(
        got[:500, 0], (probe[:500] & 0xFFFFFFFF).astype(np.uint32))
    skeys = np.sort(keys)
    kk, _ = db.scan(int(skeys[1000]), 64)
    np.testing.assert_array_equal(kk, skeys[1000:1064])


def test_overwrite_and_delete(tmp_path):
    db = RemixDB(_cfg(tmp_path, memtable_entries=512))
    db.put(5, [1, 1])
    db.put(6, [2, 2])
    db.flush()
    db.put(5, [9, 9])
    db.delete(6)
    db.flush()
    assert int(db.get(5)[0]) == 9
    assert db.get(6) is None
    kk, _ = db.scan(0, 10)
    assert list(kk) == [5]


@pytest.mark.parametrize("case", ["kinds", "split"])
def test_compaction_progress(tmp_path, case):
    """Minor compactions, then majors or splits; partitions route exactly
    across their boundaries."""
    if case == "kinds":
        cfg = _cfg(tmp_path, memtable_entries=400,
                   compaction=CompactionConfig(table_cap=128, t_max=4,
                                               split_m=2))
        db = RemixDB(cfg)
        rng = np.random.default_rng(1)
        for _ in range(20):
            keys = rng.choice(50_000, size=400, replace=False).astype(np.uint64)
            db.put_batch(keys, np.zeros((400, 2), np.uint32))
            db.flush()
        kinds = {k for st in db.compaction_log for k in st["kinds"]}
        assert "minor" in kinds and ("major" in kinds or "split" in kinds)
        found, _ = db.get_batch(keys[:100])
        assert found.all()
    else:
        cfg = _cfg(tmp_path, memtable_entries=2048,
                   compaction=CompactionConfig(table_cap=128, t_max=3,
                                               split_m=2))
        db = RemixDB(cfg)
        keys = np.arange(0, 4096, dtype=np.uint64)
        for _ in range(4):
            db.put_batch(keys, np.zeros((len(keys), 2), np.uint32))
            db.flush()
        assert len(db.partitions) > 1
        found, _ = db.get_batch(keys[::17])
        assert found.all()
        kk, _ = db.scan(0, 200)
        np.testing.assert_array_equal(kk, keys[:200])
    s = db.stats()
    assert s["partitions"] >= 1 and s["tables"] >= 1
    db.write_amplification()


def test_hot_keys_stay_buffered(tmp_path):
    db = RemixDB(_cfg(tmp_path, hot_threshold=3))
    for i in range(6):
        db.put(42, [i, i])
    db.put(7, [7, 7])
    db.flush()
    in_tables = [int(k) for p in db.partitions for t in p.tables for k in t.keys]
    assert 7 in in_tables and 42 not in in_tables
    assert db.mem.get(42).count == 3
    assert int(db.get(42)[0]) == 5


def test_wal_recovery_and_gc(tmp_path):
    db = RemixDB(_cfg(tmp_path / "a"))
    for i in range(100):
        db.put(i, [i, 0])
    db.delete(50)
    db.wal.sync()
    mem = db.recover_memtable()
    assert len(mem) == 100
    assert mem.get(50).tomb and not mem.get(51).tomb
    for i in range(100, 2000):
        db.put(i, [i, 0])
    db.flush()
    assert db.wal.used_blocks() == 0
    db2 = RemixDB(_cfg(tmp_path / "b", hot_threshold=2))
    for _ in range(5):
        for k in (1, 2, 3):
            db2.put(k, [k, 0])
    db2.flush()
    assert {k for k, *_ in db2.wal.replay()} == {1, 2, 3}


def test_scan_batch_matches_scan(tmp_path):
    db = RemixDB(_cfg(tmp_path, memtable_entries=512))
    rng = np.random.default_rng(2)
    keys = rng.choice(20_000, size=2500, replace=False).astype(np.uint64)
    _fill(db, keys)
    db.flush()
    for k in keys[::9].tolist():
        db.delete(int(k))
    starts = np.sort(rng.choice(20_000, 40, replace=False)).astype(np.uint64)
    kb, mb = db.scan_batch(starts, 16)
    for i, s in enumerate(starts.tolist()):
        kk, _ = db.scan(s, 16)
        np.testing.assert_array_equal(kb[i][mb[i]], kk)


# ------------------------------------------------------ test_versions
def test_snapshot_isolated_from_flush(tmp_path):
    db = RemixDB(_cfg(tmp_path))
    _fill(db, np.arange(0, 3000, 3, dtype=np.uint64))
    db.delete(6)
    pre_k, pre_v = db.scan(0, 10_000)
    with db.snapshot() as snap:
        db.put_batch(np.arange(1, 3000, 3, dtype=np.uint64),
                     np.zeros((1000, 2), np.uint32))
        db.delete(9)
        db.flush()
        k1, v1 = snap.scan(0, 10_000)
        np.testing.assert_array_equal(k1, pre_k)
        np.testing.assert_array_equal(v1, pre_v)
        assert snap.get(6) is None and snap.get(9) is not None
        f, _ = snap.get_batch(np.array([1, 4, 9], np.uint64))
        assert list(f) == [False, False, True]
    assert db.get(9) is None and db.get(1) is not None


def test_snapshot_versions_refcount_and_release(tmp_path):
    db = RemixDB(_cfg(tmp_path))
    _fill(db, np.arange(100, dtype=np.uint64))
    db.flush()
    assert db.stats()["versions"]["pinned"] == 0
    s1, s2 = db.snapshot(), db.snapshot()
    assert db.stats()["versions"]["pinned"] == 2
    _fill(db, np.arange(100, 200, dtype=np.uint64))
    db.flush()
    assert db.stats()["versions"]["live"] == 2
    s1.close()
    s1.close()
    assert db.stats()["versions"]["live"] == 2
    s2.close()
    st = db.stats()["versions"]
    assert st["live"] == 1 and st["pinned"] == 0


def test_cursor_ops_peek_next_skip(tmp_path):
    db = RemixDB(_cfg(tmp_path))
    _fill(db, np.arange(10, 200, 10, dtype=np.uint64))
    db.flush()
    db.put(15, [7, 7])
    db.delete(30)
    with db.cursor(start=11) as cur:
        assert cur.peek()[0] == 15
        k, v = cur.next()
        assert k == 15 and int(v[0]) == 7
        assert cur.next()[0] == 20
        assert cur.skip(2) == 2
        assert cur.next()[0] == 60
        kk, _ = cur.next_batch(4)
        np.testing.assert_array_equal(kk, [70, 80, 90, 100])
        assert [k for k, _ in cur] == list(range(110, 200, 10))
        assert cur.next() is None and cur.skip(5) == 0


@pytest.mark.parametrize("path", ["overlay", "device", "cold"])
def test_cursor_matches_scan_on_each_read_path(tmp_path, path):
    root = str(tmp_path / "db")
    rng = np.random.default_rng(5)
    keys = np.sort(rng.choice(100_000, 4000, replace=False).astype(np.uint64))
    if path == "cold":
        db = RemixDB.open(root, _cfg(promote_fraction=1e9))
    elif path == "device":
        db = RemixDB.open(root, _cfg(cold_reads=False))
    else:
        db = RemixDB(_cfg(tmp_path))
    _fill(db, keys)
    if path != "overlay":
        db.flush()
        for k in keys[::7].tolist():
            db.delete(int(k))
        db.flush()
        if path == "cold":
            db.close()
            db = RemixDB.open(root, _cfg(promote_fraction=1e9))
            assert all(p.cold_ready() for p in db.partitions)
    for start, n in [(0, 100), (int(keys[1000]), 64), (int(keys[-5]), 50)]:
        k_scan, v_scan = db.scan(start, n)
        with db.cursor(start=start) as cur:
            k_cur, v_cur = cur.next_batch(n)
        np.testing.assert_array_equal(k_cur, k_scan)
        np.testing.assert_array_equal(v_cur, v_scan)
        kb, mb = db.scan_batch(np.array([start], np.uint64), n)
        np.testing.assert_array_equal(kb[0][mb[0]], k_scan[:n])
    if path == "cold":
        assert db.stats()["resident_tables"] == 0


def test_cursor_streams_across_partitions_and_overlay(tmp_path):
    db = RemixDB(_cfg(tmp_path, memtable_entries=2048,
                      compaction=CompactionConfig(table_cap=128, t_max=3,
                                                  split_m=2)))
    keys = np.arange(0, 4096, dtype=np.uint64)
    for _ in range(3):
        db.put_batch(keys, np.zeros((len(keys), 2), np.uint32))
        db.flush()
    assert len(db.partitions) > 1
    db.put(4096, [1, 1])
    with db.cursor() as cur:
        kk, _ = cur.next_batch(5000)
    np.testing.assert_array_equal(kk, np.arange(0, 4097, dtype=np.uint64))


def test_cursor_survives_concurrent_flush_and_files_pinned(tmp_path):
    root = str(tmp_path / "db")
    cfg = RemixDBConfig(memtable_entries=1 << 30, hot_threshold=255,
                        compaction=CompactionConfig(table_cap=256, t_max=2),
                        promote_fraction=1e9)
    db = RemixDB.open(root, cfg)
    keys = np.arange(1, 4001, dtype=np.uint64) * 4
    _fill(db, keys)
    db.flush()
    db.close()
    db = RemixDB.open(root, cfg)
    assert all(p.cold_ready() for p in db.partitions)
    pre_k, _ = db.scan(0, 10_000)
    snap = db.snapshot()
    cur = snap.cursor(start=0, width=64)
    got_k = [cur.next_batch(500)[0]]
    db.delete(int(keys[1000]))
    _fill(db, keys + 1)
    db.flush()
    pinned = snap.version.file_names()
    current = db.versions.current.file_names()
    assert pinned - current
    for root_side in twin_dir(root):
        for name in pinned:
            sub = "tables" if name.endswith(".sst") else "remix"
            assert os.path.exists(os.path.join(root_side, sub, name)), name
    while True:
        kk, _ = cur.next_batch(500)
        if len(kk) == 0:
            break
        got_k.append(kk)
    np.testing.assert_array_equal(np.concatenate(got_k), pre_k)
    cur.close()
    snap.close()
    for root_side in twin_dir(root):
        on_disk = set(os.listdir(os.path.join(root_side, "tables")))
        assert on_disk == {n for n in current if n.endswith(".sst")}
    k_live, _ = db.scan(0, 20_000)
    db.close()
    db2 = RemixDB.open(root, cfg)
    k_rec, _ = db2.scan(0, 20_000)
    np.testing.assert_array_equal(k_rec, k_live)
    assert db2.get(int(keys[1000])) is None


def test_snapshot_taken_mid_flush_sees_pre_flush_state(tmp_path, monkeypatch):
    """Port alone: the spy patches the port's ``store.execute``."""
    db = TS.RemixDB(TS.RemixDBConfig(memtable_entries=1 << 30,
                                     wal_dir=str(tmp_path), device="cpu"))
    keys = np.arange(0, 500, 5, dtype=np.uint64)
    _fill(db, keys)
    db.delete(10)
    pre_k, pre_v = db.scan(0, 10_000)
    grabbed = {}
    real_execute = TS.execute

    def spy(plan, cfg, storage=None, **kw):
        if "snap" not in grabbed:
            grabbed["snap"] = db.snapshot()
        return real_execute(plan, cfg, storage=storage, **kw)

    monkeypatch.setattr(TS, "execute", spy)
    db.flush()
    with grabbed["snap"] as snap:
        kk, vv = snap.scan(0, 10_000)
        np.testing.assert_array_equal(kk, pre_k)
        np.testing.assert_array_equal(vv, pre_v)
        assert snap.get(10) is None
    np.testing.assert_array_equal(db.scan(0, 10_000)[0], pre_k)


def test_compaction_log_ring_and_totals(tmp_path):
    db = RemixDB(_cfg(tmp_path, memtable_entries=400, compaction_log_rounds=4,
                      compaction=CompactionConfig(table_cap=128, t_max=4)))
    rng = np.random.default_rng(1)
    for _ in range(10):
        ks = rng.choice(50_000, size=400, replace=False).astype(np.uint64)
        db.put_batch(ks, np.zeros((400, 2), np.uint32))
        db.flush()
    assert len(db.compaction_log) == 4
    st = db.stats()["compaction"]
    assert st["rounds"] == 10 and st["log_rounds"] == 4
    assert st["bytes_written"] > 0


def _write_committed(root, keys, d=32, n_tables=1, tomb=None, seed=0):
    """A committed on-disk store written by the reference's I/O layer,
    copied for the port: both open the same bytes."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n_tables, len(keys))
    dead = np.zeros(len(keys), bool) if tomb is None else tomb
    storage = Storage(root)
    names, runs, seq = [], [], 1
    for i in range(n_tables):
        m = owner == i
        run = make_run(keys[m], seq=np.arange(seq, seq + m.sum(), dtype=np.uint32),
                       tomb=dead[m])
        seq += int(m.sum())
        runs.append(run)
        names.append(storage.write_table(
            np.asarray(run.keys), np.asarray(run.vals),
            np.asarray(run.seq), np.asarray(run.tomb)))
    remix, _ = build_remix(runs, d=d)
    storage.commit(dict(
        seq=len(keys) + 1, vw=2, d=d,
        partitions=[dict(lo=0, tables=names, remix=storage.write_remix(remix))],
        wal=WAL(storage.wal_path()).save_state(),
    ))
    shutil.copytree(root, twin_dir(root)[1])


def test_promotion_driven_by_served_workload(tmp_path):
    root = str(tmp_path / "db")
    n = 60_000
    keys = np.arange(1, n + 1, dtype=np.uint64) * 8
    _write_committed(root, keys)
    db = RemixDB.open(root, _cfg(promote_fraction=1e9))
    [p] = db.partitions
    start = int(keys[n // 2])
    for _ in range(40):
        kk, _ = db.scan(start, 500)
        assert len(kk) == 500
    inputs = p.promotion_inputs(0.3)
    assert inputs["served_bytes"] >= inputs["threshold_bytes"]
    assert inputs["disk_bytes"] < inputs["threshold_bytes"]
    assert inputs["promote"] and p.should_promote(0.3)
    st = db.stats()["cache"]["promotion"]
    assert len(st) == 1 and st[0]["cold_scans"] >= 40
    assert db.stats()["resident_tables"] == 0


def test_snapshot_semantics_walk(tmp_path):
    """The snapshot property of ``test_versions`` over seeded walks."""
    for seed in range(6):
        rng = random.Random(seed)
        db = RemixDB(_cfg(tmp_path / f"w{seed}"))
        ref: dict[int, int] = {}
        pre = [(rng.random() < 0.7, rng.randrange(41), rng.randrange(2**31))
               for _ in range(rng.randrange(1, 40))]
        post = [(rng.random() < 0.7, rng.randrange(41), rng.randrange(2**31))
                for _ in range(rng.randrange(1, 25))]
        for i, (is_put, k, v) in enumerate(pre):
            if is_put:
                db.put(k, [v, 0])
                ref[k] = v
            else:
                db.delete(k)
                ref.pop(k, None)
            if seed % 2 and i == len(pre) // 2:
                db.flush()
        with db.snapshot() as snap:
            for is_put, k, v in post:
                (db.put(k, [v, 0]) if is_put else db.delete(k))
            db.flush()
            kk, vv = snap.scan(0, 1000)
            np.testing.assert_array_equal(kk, np.array(sorted(ref), np.uint64))
            probes = np.arange(0, 42, dtype=np.uint64)
            fb, vb = snap.get_batch(probes)
            for i, k in enumerate(probes.tolist()):
                v = snap.get(k)
                assert bool(fb[i]) == (v is not None)
            with snap.cursor() as cur:
                ck, cv = cur.next_batch(1000)
            np.testing.assert_array_equal(ck, kk)
            np.testing.assert_array_equal(cv, vv)


# --------------------------------------------------- test_batch_query
def _build_store(root, n_tables=4, n_per_table=1500, partitions=1, seed=0):
    """``test_batch_query``'s committed store: tombstone-heavy tables, one
    REMIX per partition; the port opens a copy of the same bytes."""
    rng = np.random.default_rng(seed)
    total = n_tables * n_per_table
    domain = np.arange(1, total + 1, dtype=np.uint64) * 16
    owner = rng.integers(0, n_tables, total)
    dead = np.zeros(total, bool)
    dead[::3] = True
    storage = Storage(root)
    parts = []
    bounds = np.linspace(0, total, partitions + 1).astype(int)
    for pi in range(partitions):
        sl = slice(bounds[pi], bounds[pi + 1])
        pk, po, pd = domain[sl], owner[sl], dead[sl]
        names, runs, seqbase = [], [], 1
        for i in range(n_tables):
            m = po == i
            run = make_run(pk[m], seq=np.arange(seqbase, seqbase + m.sum(),
                                                dtype=np.uint32), tomb=pd[m])
            seqbase += int(m.sum())
            runs.append(run)
            names.append(storage.write_table(
                np.asarray(run.keys), np.asarray(run.vals),
                np.asarray(run.seq), np.asarray(run.tomb)))
        remix, _ = build_remix(runs, d=16)
        parts.append(dict(lo=0 if pi == 0 else int(pk[0]), tables=names,
                          remix=storage.write_remix(remix)))
    storage.commit(dict(seq=10 * total, vw=2, d=16, partitions=parts,
                        wal=WAL(storage.wal_path()).save_state()))
    shutil.copytree(root, twin_dir(root)[1])
    return domain, dead


def _probes(domain, rng, q):
    hits = rng.choice(domain, q // 2, replace=False).astype(np.uint64)
    miss = rng.choice(domain, q - q // 2, replace=False).astype(np.uint64) + 1
    out = np.concatenate([hits, miss])
    rng.shuffle(out)
    return out


def _bq_cfg(**kw):
    kw.setdefault("promote_fraction", 1e9)
    return RemixDBConfig(**kw)


@pytest.mark.parametrize("cache_mode", ["copy", "mmap"])
def test_cold_get_batch_matches_scalar_and_device(tmp_path, cache_mode):
    root = str(tmp_path / "db")
    domain, dead = _build_store(root)
    probe = _probes(domain, np.random.default_rng(1), 128)
    db_b = RemixDB.open(root, _bq_cfg(cache_mode=cache_mode))
    assert all(p.cold_ready() for p in db_b.partitions)
    f_b, v_b = db_b.get_batch(probe)
    p0 = RemixDB.open(root, _bq_cfg()).partitions[0]
    for i, k in enumerate(probe.tolist()):
        got, val = p0.cold_get(k)
        assert got == bool(f_b[i])
        if got:
            np.testing.assert_array_equal(val, v_b[i])
    db_d = RemixDB.open(root, _bq_cfg(cold_reads=False))
    f_d, v_d = db_d.get_batch(probe)
    np.testing.assert_array_equal(f_b, f_d)
    np.testing.assert_array_equal(v_b[f_b], v_d[f_d])
    key_dead = dict(zip(domain.tolist(), dead.tolist()))
    for i, k in enumerate(probe.tolist()):
        if k in key_dead:
            assert bool(f_b[i]) == (not key_dead[k])
    c = db_b.stats()["cache"]
    assert c["evictions"] == 0


def test_cross_partition_batches(tmp_path):
    root = str(tmp_path / "db")
    domain, _ = _build_store(root, partitions=3)
    probe = _probes(domain, np.random.default_rng(3), 96)
    db = RemixDB.open(root, _bq_cfg())
    assert len(db.partitions) == 3
    f_b, v_b = db.get_batch(probe)
    db_s = RemixDB.open(root, _bq_cfg())
    for i, k in enumerate(probe.tolist()):
        v = db_s.get(k)
        assert bool(f_b[i]) == (v is not None)
    starts = np.array([domain[0], domain[len(domain) // 3 - 2], domain[-40]],
                      np.uint64)
    kk, mm = db.scan_batch(starts, 30)
    for row, s in enumerate(starts):
        ref, _ = db_s.scan(int(s), 30)
        np.testing.assert_array_equal(kk[row][mm[row]], ref)


@pytest.mark.parametrize("width", [7, 40, 200])
def test_cold_scan_batch_matches_scalar(tmp_path, width):
    root = str(tmp_path / "db")
    domain, _ = _build_store(root)
    rng = np.random.default_rng(4)
    starts = np.concatenate([rng.choice(domain, 24).astype(np.uint64),
                             [domain[0] - 1, domain[-1], domain[-1] + 5]])
    pb = RemixDB.open(root, _bq_cfg()).partitions[0]
    ps = RemixDB.open(root, _bq_cfg()).partitions[0]
    outs = pb.cold_scan_batch(starts, width)
    for s, (kk, vv, more) in zip(starts.tolist(), outs):
        k_ref, v_ref, m_ref = ps.cold_scan(s, width)
        np.testing.assert_array_equal(kk, k_ref)
        np.testing.assert_array_equal(vv, v_ref)
        assert more == m_ref


def test_prefetch_scan_parity_and_counters(tmp_path):
    root = str(tmp_path / "db")
    domain, _ = _build_store(root, n_per_table=4000)
    starts = np.random.default_rng(5).choice(domain, 8).astype(np.uint64)
    db_e = RemixDB.open(root, _bq_cfg(prefetch_depth=0))
    db_p = RemixDB.open(root, _bq_cfg(prefetch_depth=2))
    for s in starts.tolist():
        ke, ve = db_e.scan(s, 60)
        kp, vp = db_p.scan(s, 60)
        np.testing.assert_array_equal(ke, kp)
        np.testing.assert_array_equal(ve, vp)
    assert db_p.disk_bytes_read() <= db_e.disk_bytes_read()
    c = db_p.stats()["cache"]
    assert c["prefetch_issued"] > 0 and c["prefetch_hits"] > 0


def test_scan_batch_equals_sequential_after_promotion(tmp_path):
    root = str(tmp_path / "db")
    domain, _ = _build_store(root)
    starts = np.array([domain[10], domain[500], domain[-30]], np.uint64)
    cold_k, cold_m = RemixDB.open(root, _bq_cfg()).scan_batch(starts, 20)
    dev_k, dev_m = RemixDB.open(root, _bq_cfg(cold_reads=False)).scan_batch(
        starts, 20)
    np.testing.assert_array_equal(cold_k[cold_m], dev_k[dev_m])
    np.testing.assert_array_equal(cold_m, dev_m)


def test_heterogeneous_scan_group(tmp_path):
    root = str(tmp_path / "db")
    domain, _ = _build_store(root, n_per_table=4000)
    starts = np.sort(np.random.default_rng(9).choice(domain[:-400], 12,
                                                     replace=False))
    ns = [7, 90] * 6
    ops = [Op.scan(int(s), n) for s, n in zip(starts.tolist(), ns)]
    db_m = RemixDB.open(root, _bq_cfg())
    res_m = db_m.engine().execute(Batch(ops)).results
    db_s = RemixDB.open(root, _bq_cfg())
    for want in (7, 90):
        sub = [i for i, n in enumerate(ns) if n == want]
        res_s = db_s.engine().execute(Batch([ops[i] for i in sub])).results
        for i, r in zip(sub, res_s):
            np.testing.assert_array_equal(res_m[i].keys, r.keys)
    acc_m, acc_s = db_m.stats()["cache"], db_s.stats()["cache"]
    assert acc_m["misses"] == acc_s["misses"] and acc_m["hits"] < acc_s["hits"]


def test_sync_policy_and_bad_knobs(tmp_path):
    root = str(tmp_path / "db")
    db = RemixDB.open(root, RemixDBConfig(sync_policy="always"))
    db.put(7, [1, 2])
    db.put(9, [3, 4])
    db2 = RemixDB.open(root, RemixDBConfig())  # no close(): still durable
    np.testing.assert_array_equal(db2.get(7), [1, 2])
    np.testing.assert_array_equal(db2.get(9), [3, 4])
    for bad in (dict(cache_mode="zero-copy"), dict(prefetch_depth=-1),
                dict(device_path="maybe"), dict(device_slice=0)):
        with pytest.raises(ValueError):
            RemixDB(RemixDBConfig(**bad))
    with pytest.raises(ValueError):
        RemixDB.open(str(tmp_path / "x"), RemixDBConfig(sync_policy="x"))


# ------------------------------------------------------------ test_ops
def _fill_ops(db, lo=1, n=300, step=7):
    keys = np.arange(lo, lo + n, dtype=np.uint64) * step
    _fill(db, keys)
    return keys


def test_mixed_batch_equals_legacy_sequence():
    db_a, db_b = RemixDB(_cfg()), RemixDB(_cfg())
    for db in (db_a, db_b):
        _fill_ops(db)
    ops = [
        Op.get(7), Op.put(7, [9, 9]), Op.get(7), Op.scan(0, 10), Op.delete(14),
        Op.get(14), Op.multiget([7, 14, 21, 99999]),
        Op.put(np.array([50, 51], np.uint64), np.ones((2, 2), np.uint32)),
        Op.scan(49, 4),
    ]
    legacy = []
    for op in ops:
        if op.kind is OpKind.GET:
            legacy.append(db_b.get(op.key))
        elif op.kind is OpKind.MULTIGET:
            legacy.append(db_b.get_batch(op.keys))
        elif op.kind is OpKind.SCAN:
            legacy.append(db_b.scan(op.start, op.n))
        elif op.kind is OpKind.PUT:
            legacy.append(db_b.put(op.key, op.val) if op.keys is None
                          else db_b.put_batch(op.keys, op.val))
        else:
            legacy.append(db_b.delete(op.key))
    res = db_a.submit(Batch(list(ops)), sync=True).result()
    assert res.ok
    for op, ref, r in zip(ops, legacy, res.results):
        if op.kind is OpKind.GET:
            assert (ref is not None) == bool(r.found)
        elif op.kind is OpKind.SCAN:
            np.testing.assert_array_equal(ref[0], r.keys)
    assert res.stats["ops"] == len(ops) and res.stats["kinds"]["get"] == 3
    np.testing.assert_array_equal(db_a.scan(0, 1000)[0], db_b.scan(0, 1000)[0])


def test_deadline_exceeded_does_not_poison_batch():
    db = RemixDB(_cfg())
    keys = _fill_ops(db)
    ops = [
        Op.get(int(keys[0]), deadline_ms=-1.0), Op.get(int(keys[1])),
        Op.scan(0, 5, deadline_ms=-1.0), Op.put(123456, [1, 2], deadline_ms=-1.0),
        Op.multiget(keys[:4]),
    ]
    res = db.submit(Batch(ops), sync=True).result()
    assert res.results[0].status is OpStatus.DEADLINE_EXCEEDED
    assert res.results[1].ok and res.results[1].found
    assert res.results[3].status is OpStatus.DEADLINE_EXCEEDED
    assert db.get(123456) is None
    assert res.stats["deadline_exceeded"] == 3 and not res.ok


def test_cursor_interrupt_hook():
    """Port alone: the hook raises the port's OpInterrupted."""
    from repro_torch.db.cursor import RemixCursor

    db = TS.RemixDB(TS.RemixDBConfig(memtable_entries=1 << 30, device="cpu"))
    _fill_ops(db, n=500)
    db.flush()
    calls = [0]

    def boom():
        calls[0] += 1
        if calls[0] > 2:
            raise TOpInterrupted(TOpStatus.DEADLINE_EXCEEDED)

    with db.snapshot() as snap:
        cur = RemixCursor(snap, width=8, interrupt=boom)
        cur.seek(0)
        with pytest.raises(TOpInterrupted):
            while cur.next() is not None:
                pass
    assert calls[0] > 2
    assert OpInterrupted.__name__ == TOpInterrupted.__name__


def test_midrun_cancel_releases_pins(tmp_path):
    """Port alone: a blocked worker, a mid-run cancel, no leaked pins."""
    import threading

    from repro_torch.db.ops import Batch as TBatch
    from repro_torch.db.ops import Op as TOp

    db = TS.RemixDB.open(str(tmp_path / "db"), TS.RemixDBConfig(
        memtable_entries=1 << 30, submit_workers=1, device="cpu",
        device_path="on"))
    keys = _fill_ops(db)
    db.flush()
    gate, entered = threading.Event(), threading.Event()
    orig = db._get_batch_at

    def blocked(view, qk):
        entered.set()
        gate.wait(10)
        return orig(view, qk)

    db._get_batch_at = blocked
    try:
        fut = db.submit(TBatch([TOp.multiget(keys[:4]), TOp.put(999999, [1, 1]),
                                TOp.multiget(keys[:4])]))
        assert entered.wait(10)
        assert not fut.cancel()
        gate.set()
        res = fut.result(timeout=10)
    finally:
        db._get_batch_at = orig
        gate.set()
    assert res.results[0].ok
    assert res.results[1].status is TOpStatus.CANCELLED
    assert db.get(999999) is None
    assert db.versions.stats()["pinned"] == 0
    db.close()


def test_async_submit_and_background_compaction(tmp_path):
    """Async futures on the submit workers, and a background compaction
    racing reads and writes, give the synchronous answers."""
    db_bg = RemixDB.open(str(tmp_path / "bg"), RemixDBConfig(
        memtable_entries=500, background_compaction=True))
    db_sy = RemixDB.open(str(tmp_path / "sy"), RemixDBConfig(memtable_entries=500))
    for db in (db_bg, db_sy):
        _fill_ops(db, n=450)
    assert db_bg.flush().get("background")
    assert db_bg.get(7) is not None
    db_bg.put(888888, [8, 8])
    db_bg.wait_for_compaction()
    db_sy.flush()
    db_sy.put(888888, [8, 8])
    for db in (db_bg, db_sy):
        _fill_ops(db, lo=2000, n=600)
    db_bg.wait_for_compaction()
    futs = [db_bg.submit(Batch([Op.multiget(np.arange(0, 5000, 7, dtype=np.uint64)),
                                Op.scan(100 * i, 40)])) for i in range(6)]
    for i, f in enumerate(futs):
        r = f.result(timeout=30)
        assert r.ok
        np.testing.assert_array_equal(r.results[1].keys, db_sy.scan(100 * i, 40)[0])
    ka, va = db_bg.scan(0, 3000)
    kb, vb = db_sy.scan(0, 3000)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(va, vb)
    assert db_bg.stats()["compaction"]["rounds"] >= 2
    db_bg.close()
    db_re = RemixDB.open(str(tmp_path / "bg"))
    np.testing.assert_array_equal(db_re.scan(0, 3000)[0], kb)


def test_op_model_and_executor_plan():
    with pytest.raises(ValueError):
        Op.scan(0, -1)
    db = RemixDB(_cfg())
    _fill_ops(db, n=50)
    f, v = db.get_batch(np.zeros(0, np.uint64))
    assert len(f) == 0 and v.shape == (0, 2)
    db.put_batch(np.zeros(0, np.uint64), np.zeros((0, 2), np.uint32))
    eng = db.engine()
    b = Batch([Op.get(7, priority=1), Op.scan(0, 4, priority=5),
               Op.put(1, [1, 1]), Op.get(14)])
    stages = eng.plan(b)
    assert [s.kind for s in stages] == ["read", "write", "read"]
    assert eng.submit(b, sync=True).result().ok
    s = eng.stats()
    assert s["batches"] >= 1 and s["admission"]["inflight_bytes"] == 0


def test_delete_range_and_cas_op_kinds():
    db = RemixDB(_cfg())
    keys = np.arange(0, 100, dtype=np.uint64)
    db.put_batch(keys, np.stack([keys, keys], 1).astype(np.uint32))
    res = db.submit(Batch([
        Op.put(200, [5, 5]), Op.delete_range(10, 60), Op.get(20),
        Op.cas(200, np.array([5, 5], np.uint32), [6, 6]), Op.get(200),
    ]), sync=True).result()
    assert res.ok and not res.results[2].found and res.results[3].found
    assert list(res.results[4].value.reshape(-1)) == [6, 6]
    r = db.submit(Batch([Op.cas(200, np.array([5, 5], np.uint32), [7, 7])]),
                  sync=True).result().results[0]
    assert not r.found and list(r.value.reshape(-1)) == [6, 6]


# ---------------------------------------------------- test_delete_range
def _dr_cfg(**kw):
    return RemixDBConfig(
        vw=2, memtable_entries=kw.pop("memtable_entries", 1 << 15),
        compaction=kw.pop("compaction", CompactionConfig(table_cap=1 << 15,
                                                         t_max=4)),
        hot_threshold=255, **kw)


def test_cold_cursor_skips_excised_span(tmp_path):
    d = str(tmp_path / "db")
    db = RemixDB.open(d, _dr_cfg())
    ks = np.arange(8192, dtype=np.uint64)
    db.put_batch(ks, np.stack([ks.astype(np.uint32), ks.astype(np.uint32) + 1], 1))
    db.flush()
    db.delete_range(2048, 6144)
    db.flush()
    db.close()
    db = RemixDB.open(d, _dr_cfg())
    p = db.versions.current.partitions[0]
    assert db._cold_ok(p)
    assert p.full_spans() == [(2048, 6144)]
    with db.cursor(width=64) as cur:
        cur.seek(0)
        got = [k for k, _ in cur]
    assert got == [k for k in range(8192) if not 2048 <= k < 6144]
    db.disk_bytes_read()
    db.close()


def test_whole_table_drop_at_flush(tmp_path):
    d = str(tmp_path / "db")
    db = RemixDB.open(d, _dr_cfg(memtable_entries=256))
    ks = np.arange(1000, 1200, dtype=np.uint64)
    db.put_batch(ks, np.stack([ks, ks], 1).astype(np.uint32))
    db.flush()
    db.delete_range(0, 5000)
    db.flush()
    assert sum(len(p.tables) for p in db.versions.current.partitions) == 0
    assert db.events.list(kind="range_tombstone_drop")
    assert len(db.scan(0, 10_000)[0]) == 0
    db.close()


def test_partial_span_scan_and_get_parity(tmp_path):
    d = str(tmp_path / "db")
    db = RemixDB.open(d, _dr_cfg(memtable_entries=256, compaction=CompactionConfig(
        table_cap=256, t_max=6)))
    ks1 = np.arange(0, 600, 2, dtype=np.uint64)
    db.put_batch(ks1, np.stack([ks1, ks1], 1).astype(np.uint32))
    db.flush()
    db.delete_range(100, 400)
    ks2 = np.arange(1, 600, 2, dtype=np.uint64)
    db.put_batch(ks2, np.stack([ks2, ks2], 1).astype(np.uint32))
    db.flush()
    live = sorted({int(k) for k in ks1 if not 100 <= k < 400} | {int(k) for k in ks2})
    assert [int(k) for k in db.scan(0, 10_000)[0]] == live
    with db.cursor(width=16) as cur:
        cur.seek(0)
        assert [k for k, _ in cur] == live
    f, _ = db.get_batch(np.array([200, 201, 98, 350], np.uint64))
    assert list(f) == [False, True, True, False]
    db.close()


def test_ttl_expiry_and_compaction_gc(tmp_path):
    t = [1000.0]
    set_clock(lambda: t[0])
    d = str(tmp_path / "db")
    db = RemixDB.open(d, _dr_cfg(memtable_entries=128, compaction=CompactionConfig(
        table_cap=128, t_max=2)))
    ks = np.arange(0, 100, dtype=np.uint64)
    db.put_batch(ks, np.stack([ks, ks], 1).astype(np.uint32), ttl=60)
    ks2 = np.arange(100, 200, dtype=np.uint64)
    db.put_batch(ks2, np.stack([ks2, ks2], 1).astype(np.uint32))
    db.flush()
    assert db.get(5) is not None
    t[0] = 1061.0
    assert db.get(5) is None
    assert [int(k) for k in db.scan(0, 1000)[0]] == list(range(100, 200))
    for i in range(6):
        db.put_batch(ks, np.full((100, 2), 7 + i, np.uint32), ttl=1)
        t[0] += 5.0
        db.flush()
    assert _metric(db.ref, "ttl_expired_dropped") > 0
    assert _metric(db.port, "ttl_expired_dropped") == _metric(
        db.ref, "ttl_expired_dropped")
    db.close()


def test_cas_semantics(tmp_path):
    db = RemixDB.open(str(tmp_path / "db"), _dr_cfg())
    assert db.cas(1, None, [1, 1])[0]
    assert not db.cas(1, None, [2, 2])[0]
    ok, cur = db.cas(1, np.array([1, 1], np.uint32), [3, 3])
    assert ok
    ok, cur = db.cas(1, np.array([1, 1], np.uint32), [4, 4])
    assert not ok and list(cur.reshape(-1)) == [3, 3]
    assert db.cas(1, np.array([3, 3], np.uint32), None)[0]
    assert db.get(1) is None
    db.close()


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_admission_and_sequencer(pkg):
    """``test_ops``'s admission controller and shard sequencer cases, run
    on each package's classes."""
    import importlib
    import threading
    import time

    ex = importlib.import_module(f"{pkg}.db.executor")
    adm = ex.AdmissionController(100)
    assert adm.acquire(80)
    got = []
    t = threading.Thread(target=lambda: got.append(adm.acquire(50)))
    t.start()
    time.sleep(0.05)
    assert not got
    adm.release(80)
    t.join(5)
    assert not t.is_alive() and got == [True]
    adm.release(50)
    s = adm.stats()
    assert s["inflight_bytes"] == 0 and s["waits"] == 1 and s["peak_bytes"] == 80
    assert adm.acquire(100)
    assert not adm.acquire(10, deadline_at=time.monotonic() + 0.01)
    adm.release(100)
    sq = ex.ShardSequencer(2)
    t1, t2, t3 = sq.register([0]), sq.register([0, 1]), sq.register([0])
    assert sq.register([]) is None
    assert sq.await_turn(t1)
    sq.release(t3)
    sq.release(t2)
    unblocked = threading.Event()

    def waiter():
        assert sq.await_turn(sq.register([0, 1]))
        unblocked.set()

    th = threading.Thread(target=waiter)
    th.start()
    assert not unblocked.wait(0.1)
    sq.release(t1)
    assert unblocked.wait(2.0)
    th.join(5)
    assert not th.is_alive()


def test_submit_deadline_expires_while_queued():
    db = RemixDB(_cfg(max_inflight_bytes=64))
    _fill_ops(db, n=10)
    for side in (db.ref, db.port):  # fill each side's admission budget
        assert side.engine().admission.acquire(64)
    try:
        res = db.submit(Batch([Op.get(7, deadline_ms=30.0), Op.get(14, deadline_ms=30.0)]),
                        sync=True).result(timeout=10)
        assert all(r.status is OpStatus.DEADLINE_EXCEEDED for r in res.results)
        assert not res.stats["executed"]
    finally:
        for side in (db.ref, db.port):
            side.engine().admission.release(64)
    assert db.submit(Batch([Op.get(7)]), sync=True).result().ok


def test_queued_cancel_and_error_traceback(tmp_path):
    """Port alone (both patch the port's ``_get_batch_at``): a queued
    future cancels outright and pins nothing; an op error re-raises with
    the failing frame innermost."""
    import threading
    import traceback

    from repro_torch.db.ops import Batch as TBatch
    from repro_torch.db.ops import Op as TOp

    db = TS.RemixDB.open(str(tmp_path / "db"), TS.RemixDBConfig(
        memtable_entries=1 << 30, submit_workers=1, device="cpu",
        device_path="on"))
    keys = _fill_ops(db)
    db.flush()
    gate, entered = threading.Event(), threading.Event()
    orig = db._get_batch_at

    def blocked(view, qk):
        entered.set()
        gate.wait(10)
        return orig(view, qk)

    db._get_batch_at = blocked
    try:
        f1 = db.submit(TBatch([TOp.multiget(keys[:4])]))
        assert entered.wait(10)
        f2 = db.submit(TBatch([TOp.multiget(keys[:4])]))
        assert f2.cancel()
        gate.set()
        assert f1.result(timeout=10).ok
        with pytest.raises(Exception):
            f2.result(timeout=10)
    finally:
        db._get_batch_at = orig
        gate.set()
    assert db.versions.stats()["pinned"] == 0

    def boom(view, qk):
        raise RuntimeError("injected read failure")

    db._get_batch_at = boom
    try:
        r = db.submit(TBatch([TOp.multiget(keys[:2])]), sync=True).result().results[0]
        assert r.status is TOpStatus.ERROR and r.exc is not None
        with pytest.raises(RuntimeError, match="injected read failure"):
            r.raise_if_error()
        assert traceback.extract_tb(r.exc.__traceback__)[-1].name == "boom"
    finally:
        db._get_batch_at = orig
    db.close()


def test_cold_scan_prefetch_issues_each_granule_once(tmp_path, monkeypatch):
    """Port alone: the lookahead pipeline issues each (vals, tomb) granule
    to the port's block cache at most once per window emission."""
    from repro_torch.io.blockcache import BlockCache as TBlockCache

    root = str(tmp_path / "db")
    domain, _ = _build_store(root, n_per_table=4000)
    db = TS.RemixDB.open(twin_dir(root)[1], TS.RemixDBConfig(
        promote_fraction=1e9, prefetch_depth=2, device="cpu"))
    issued = []
    orig = TBlockCache.prefetch

    def spy(self, key, loader):
        issued.append(key)
        return orig(self, key, loader)

    monkeypatch.setattr(TBlockCache, "prefetch", spy)
    db.scan(int(domain[100]), 120)
    assert issued and len(issued) == len(set(issued))
    db.close()
