"""The ``KVServeEngine`` cases of the reference's tests, held between the
JAX package and the port.

Each case is a test of ``test_batch_query``, ``test_ops``,
``test_delete_range``, ``test_obs``, ``test_blockcache`` or ``test_faults``
run on a twin engine (``tests/torch_twin.py``): the reference's
``repro.serve.KVServeEngine`` and the port's, each over its own shard
directories (the port's are the reference's with ``.port`` appended),
every call made on both and the answers compared bit for bit; the case's
own assertions then hold for both. The port's shards run on the CPU with
their device views (``device_path="on"``, the kernels' plain versions)
where the reference's run its host path.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.remix import build_remix  # noqa: E402
from repro.core.runs import make_run  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.ops import Batch, Op  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.db.wal import WAL  # noqa: E402
from repro.io.faults import UnavailableSpanError, flip_bytes  # noqa: E402
from repro.io.manifest import Storage  # noqa: E402
from repro.serve import KVServeEngine as RKVServeEngine  # noqa: E402
from torch_twin import pair_class, twin_dir  # noqa: E402

RemixDB = pair_class(RRemixDB)
KVServeEngine = pair_class(RKVServeEngine)


def _fill(db, lo=1, n=300, step=7):
    keys = np.arange(lo, lo + n, dtype=np.uint64) * step
    vals = np.stack([keys & 0xFFFFFFFF, keys >> 32], 1).astype(np.uint32)
    db.put_batch(keys, vals)
    return keys


def _close(eng):
    eng.close()
    for db in eng.shards:
        db.close()


# --------------------------------------------------- test_batch_query
def test_serve_engine_get_routes_through_batch(tmp_path):
    roots = []
    for i, lo in enumerate([0, 1 << 20]):
        root = str(tmp_path / f"s{i}")
        db = RemixDB.open(root, RemixDBConfig())
        base = lo + 100
        for k in range(base, base + 50):
            db.put(k, [k & 0xFFFF, 1])
        db.flush()
        db.close()
        roots.append((lo, root))
    eng = KVServeEngine(roots, config=RemixDBConfig(promote_fraction=1e9))
    np.testing.assert_array_equal(eng.get(105), [105 & 0xFFFF, 1])
    assert eng.get(55) is None
    keys = np.array([105, (1 << 20) + 120, 55], np.uint64)
    found, vals = eng.get_batch(keys)
    np.testing.assert_array_equal(found, [True, True, False])
    np.testing.assert_array_equal(vals[1], [((1 << 20) + 120) & 0xFFFF, 1])
    # one shared cache across shards sees the traffic
    assert eng.stats()["cache"]["hits"] + eng.stats()["cache"]["misses"] > 0
    _close(eng)


# ------------------------------------------------------------ test_ops
def _two_shards(tmp_path, n):
    split = 1 << 32
    roots = []
    for i, lo in enumerate((0, split)):
        root = str(tmp_path / f"s{i}")
        db = RemixDB.open(root, RemixDBConfig(memtable_entries=1 << 30))
        _fill(db, lo=lo // 7 + 1, n=n)
        db.flush()
        db.close()
        roots.append(root)
    return split, roots


def test_mixed_batch_cross_shard_serve(tmp_path):
    split, roots = _two_shards(tmp_path, 200)
    eng = KVServeEngine(
        [(0, roots[0]), (split, roots[1])],
        config=RemixDBConfig(promote_fraction=1e9),
    )
    k0, k1 = 7, (split // 7 + 1) * 7
    ops = [
        Op.get(k0),
        Op.get(k1),
        Op.multiget(np.array([k0, k1, 5], np.uint64)),  # spans both shards
        Op.scan(k0, 5),
        Op.scan(k1, 5),
        Op.put(split + 42, [4, 2]),
        Op.get(split + 42),
    ]
    res = eng.submit(Batch(list(ops)), sync=True).result()
    assert res.ok
    # equals the legacy per-op calls
    assert np.array_equal(res.results[0].value, eng.get(k0))
    assert np.array_equal(res.results[1].value, eng.get(k1))
    f, v = eng.get_batch(np.array([k0, k1, 5], np.uint64))
    np.testing.assert_array_equal(res.results[2].found, f)
    np.testing.assert_array_equal(res.results[2].vals, v)
    kk, vv = eng.scan(k1, 5)
    np.testing.assert_array_equal(res.results[4].keys, kk)
    # the put landed on shard 1's memtable, not shard 0's
    assert eng.shards[1].mem.get(split + 42) is not None
    assert eng.shards[0].mem.get(split + 42) is None
    _close(eng)


def test_serve_scan_batch_and_writes(tmp_path):
    split, roots = _two_shards(tmp_path, 150)
    eng = KVServeEngine(
        [(0, roots[0]), (split, roots[1])],
        config=RemixDBConfig(promote_fraction=1e9),
    )
    # scan_batch == per-start legacy scans (including a cross-shard one)
    starts = np.array([7, split - 10, (split // 7 + 2) * 7], np.uint64)
    out_k, out_m = eng.scan_batch(starts, 6)
    for i, s in enumerate(starts.tolist()):
        kk, _ = eng.scan(s, 6)
        np.testing.assert_array_equal(out_k[i, : len(kk)], kk)
        assert out_m[i, : len(kk)].all() and not out_m[i, len(kk):].any()
    # vectorized cross-shard put_batch + delete
    wk = np.array([3, split + 3], np.uint64)
    eng.put_batch(wk, np.full((2, 2), 5, np.uint32))
    assert eng.get(3).tolist() == [5, 5]
    assert eng.get(split + 3).tolist() == [5, 5]
    eng.delete(3)
    assert eng.get(3) is None
    _close(eng)


def test_async_write_batches_apply_in_submission_order(tmp_path):
    """Two+ racing async batches: per-shard write effects land in
    submission order, so the last-submitted put wins every key — even with
    multiple submit workers draining the queue concurrently. The
    interleaved reads see whichever puts ran before them, so each side's
    futures are checked on their own; the final state is compared."""
    eng = KVServeEngine(
        [(0, str(tmp_path / "a")), (1 << 32, str(tmp_path / "b"))],
        config=RemixDBConfig(), submit_workers=4,
    )
    try:
        ka, kb = 5, (1 << 32) + 5
        futs = []
        rounds = 60
        for i in range(rounds):
            ks = np.array([ka, kb], np.uint64)
            vs = np.full((2, 2), i, np.uint32)
            futs.append(eng.submit(Batch([Op.put(ks, vs)])))
            if i % 7 == 0:
                futs.append(eng.submit(Batch([Op.multiget(ks)])))
        for f in futs:
            assert f.ref.result(timeout=30).ok and f.port.result(timeout=30).ok
        for key in (ka, kb):
            _, vals = eng.get_batch(np.array([key], np.uint64))
            assert int(vals[0][0]) == rounds - 1, key
        assert eng.registry.counter("engine_ordered_batches").value >= rounds
    finally:
        _close(eng)


# ---------------------------------------------------- test_delete_range
def test_serve_engine_cross_shard_delete_range_and_cas(tmp_path):
    """DeleteRange fans out clipped per shard; CAS routes to the owner."""
    dirs = [str(tmp_path / f"s{i}") for i in range(3)]
    eng = KVServeEngine(
        list(zip([0, 1000, 2000], dirs)),
        config=RemixDBConfig(
            vw=2, memtable_entries=256, hot_threshold=255,
            compaction=CompactionConfig(table_cap=1 << 15, t_max=4)),
    )
    try:
        ks = np.arange(0, 3000, 7, dtype=np.uint64)
        eng.put_batch(ks, np.stack([ks, ks], 1).astype(np.uint32))
        eng.flush()
        eng.delete_range(500, 2500)  # clips into all three shards
        kk, _ = eng.scan(0, 1000)
        assert all(not 500 <= int(k) < 2500 for k in kk)
        assert eng.get(497) is not None and eng.get(504) is None
        assert eng.get(2506) is not None  # 7·358, past the range
        ok, cur = eng.cas(5000, None, np.array([4, 4], np.uint32))
        assert ok and cur is None
        ok, cur = eng.cas(
            5000, np.array([9, 9], np.uint32), np.array([5, 5], np.uint32)
        )
        assert not ok and list(cur.reshape(-1)) == [4, 4]
        ok, _ = eng.cas(5000, np.array([4, 4], np.uint32), None)
        assert ok and eng.get(5000) is None
    finally:
        _close(eng)


# ------------------------------------------------------------ test_obs
def test_traced_cross_shard_batch(tmp_path):
    """A traced mixed cross-shard batch: the answers equal between the
    packages; each package's own trace is a well-formed span tree whose
    leaves cover >= 90% of the batch (timings differ, so each side's trace
    is checked on its own)."""
    split = 1 << 32
    dirs = []
    for i, lo in enumerate((0, split)):
        d = str(tmp_path / f"s{i}")
        db = RemixDB.open(d, RemixDBConfig(memtable_entries=1 << 30))
        _fill(db, lo=lo + 1, n=200, step=1)
        db.flush()
        db.close()
        dirs.append(d)
    eng = KVServeEngine([(0, dirs[0]), (split, dirs[1])], config=RemixDBConfig())
    b = (
        Batch(trace=True)
        .get(5)
        .get(split + 10)
        .multiget(np.arange(20, 30, dtype=np.uint64))
        .scan(split + 50, 16)
        .put(9, [1, 2])
        .delete(split + 60)
    )
    res = eng.submit(b, sync=True).result()
    assert res.ok
    port_res = eng.port.submit(
        Batch(trace=True).get(5).get(split + 10).scan(split + 50, 16), sync=True).result()
    for tr in (res.trace, port_res.trace):
        assert tr is not None and tr.well_formed()
        names = [s.name for s in tr.spans()]
        assert names[0] == "batch" and "plan" in names
        assert any(n == "shard0:read" for n in names)
        assert any(n == "shard1:read" for n in names)
        assert tr.leaf_coverage() >= 0.9, tr.leaf_coverage()
        doc = json.loads(tr.to_chrome_json())
        assert doc["displayTimeUnit"] == "ms"
        assert len(doc["traceEvents"]) == len(names)
        assert all(e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0
                   for e in doc["traceEvents"])
    assert any(s.name.endswith(":commit") for s in res.trace.spans())
    _close(eng)


# ----------------------------------------------------- test_blockcache
def _build_store(root, r_tables=4, n_per_table=4096, offset=0):
    """``test_blockcache``'s committed single-partition store; the port
    opens a copy of the same bytes. Returns the keys."""
    rng = np.random.default_rng(1)
    total = r_tables * n_per_table
    domain = np.uint64(offset) + np.arange(1, total + 1, dtype=np.uint64) * 8
    owner = rng.integers(0, r_tables, total)
    runs, seqbase = [], 1
    for i in range(r_tables):
        kk = domain[owner == i]
        runs.append(make_run(kk, seq=np.arange(seqbase, seqbase + len(kk),
                                               dtype=np.uint32)))
        seqbase += len(kk)
    storage = Storage(root)
    names = [storage.write_table(np.asarray(r.keys), np.asarray(r.vals),
                                 np.asarray(r.seq), np.asarray(r.tomb))
             for r in runs]
    remix, _ = build_remix(runs, d=32)
    storage.commit(dict(seq=seqbase, vw=2, d=32,
                        partitions=[dict(lo=0, tables=names,
                                         remix=storage.write_remix(remix))],
                        wal=WAL(storage.wal_path()).save_state()))
    shutil.copytree(root, twin_dir(root)[1])
    return domain


def test_kv_serve_engine_shared_cache(tmp_path):
    from repro_torch.serve import KVServeEngine as TKVServeEngine

    root0, root1 = str(tmp_path / "shard0"), str(tmp_path / "shard1")
    keys0 = _build_store(root0)
    split = int(keys0[-1]) + 1
    keys1 = _build_store(root1, offset=split)
    eng = KVServeEngine([(0, root0), (split, root1)], cache_bytes=8 << 20,
                        config=RemixDBConfig(promote_fraction=2.0))
    assert type(eng.port) is TKVServeEngine
    for side in (eng.ref, eng.port):
        for db in side.shards:
            assert db.block_cache is side.cache  # one pool across all shards
    assert eng.get(int(keys0[7])) is not None
    assert eng.get(int(keys1[7])) is not None  # routed to the second shard
    f, v = eng.get_batch(np.array([int(keys0[3]), int(keys1[9]), 1], np.uint64))
    assert f[0] and f[1] and not f[2]
    kk, vv = eng.scan(0, 40)
    assert len(kk) == 40 and np.all(np.diff(kk.astype(np.int64)) > 0)
    st = eng.stats()
    assert st["shards"] == 2 and st["cold"]["gets"] >= 3
    assert st["cache"]["misses"] > 0
    _close(eng)


# ---------------------------------------------------------- test_faults
def _fault_cfg(**kw):
    return RemixDBConfig(
        vw=2, memtable_entries=kw.pop("memtable_entries", 64),
        compaction=CompactionConfig(table_cap=256, t_max=4),
        hot_threshold=255, **kw)


def _fill_range(db, lo, hi, tag=1):
    ks = np.arange(lo, hi, dtype=np.uint64)
    vs = np.stack([ks.astype(np.uint32), np.full(len(ks), tag, np.uint32)], 1)
    db.put_batch(ks, vs)


def test_serve_engine_health_and_scrub(tmp_path):
    """KVServeEngine aggregates shard healths and fans scrub() out: a
    corruption on one shard degrades the node view but not the other
    shard's span. The same byte is flipped in both packages' table."""
    d0, d1 = str(tmp_path / "s0"), str(tmp_path / "s1")
    for d, lo, hi in ((d0, 0, 200), (d1, 1000, 1200)):
        db = RemixDB.open(d, _fault_cfg())
        _fill_range(db, lo, hi)
        db.flush()
        db.close()

    eng = KVServeEngine([(0, d0), (1000, d1)], config=_fault_cfg())
    try:
        assert eng.health()["status"] == "ok"
        reports = eng.scrub(full=True)
        assert len(reports) == 2 and all(r["clean"] for r in reports)
    finally:
        eng.close()

    for d in twin_dir(d0):
        sst = sorted(os.listdir(os.path.join(d, "tables")))
        path = os.path.join(d, "tables", sst[0])
        flip_bytes(path, os.path.getsize(path) // 2, 4)
    eng = KVServeEngine([(0, d0), (1000, d1)], config=_fault_cfg())
    try:
        reports = eng.scrub(full=True)
        assert not reports[0]["clean"] and reports[1]["clean"]
        h = eng.health()
        assert h["status"] == "degraded"
        assert h["shards"]["0"]["status"] == "degraded"
        assert h["shards"]["1000"]["status"] == "ok"
        assert h["corruption_detected"] >= 1
        # the healthy shard keeps serving
        v = eng.get(1005)
        assert v is not None and int(v[0]) == 1005
        with pytest.raises(UnavailableSpanError):
            eng.get(0)
    finally:
        eng.close()
