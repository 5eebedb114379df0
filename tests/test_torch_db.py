"""The port's store modules against the JAX package's, module by module.

The same seeded numpy inputs go to ``repro.db.*`` and ``repro_torch.db.*``:
the memtable (entries, update counters, hot-key carry), the WAL (file
bytes, replay across packages, GC, ``recover_tail`` after a torn block,
the sync policies), versions and snapshots (refcounts, the release
hook), the op model (validation, byte sizes), the compaction planner and
the table helpers (``merge_tables``, ``chunk_table``, ``excise_rows``),
host routing, the REMIX rebuild of the scrubber, and the cold read path
on files the reference wrote. Integers compare exactly (tolerance 0).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.remix import build_remix  # noqa: E402
from repro.core.runs import make_run  # noqa: E402
from repro.db import compaction as RC  # noqa: E402
from repro.db import memtable as RM  # noqa: E402
from repro.db import ops as RO  # noqa: E402
from repro.db import partition as RP  # noqa: E402
from repro.db import scrub as RS  # noqa: E402
from repro.db import sharded as RSH  # noqa: E402
from repro.db import version as RV  # noqa: E402
from repro.db import wal as RW  # noqa: E402
from repro.io import remix_io as RIO  # noqa: E402
from repro.io.blockcache import BlockCache as RCache  # noqa: E402
from repro.io.manifest import Storage  # noqa: E402
from repro_torch.db import compaction as TC  # noqa: E402
from repro_torch.db import memtable as TM  # noqa: E402
from repro_torch.db import ops as TO  # noqa: E402
from repro_torch.db import partition as TP  # noqa: E402
from repro_torch.db import scrub as TS  # noqa: E402
from repro_torch.db import sharded as TSH  # noqa: E402
from repro_torch.db import version as TV  # noqa: E402
from repro_torch.db import wal as TW  # noqa: E402
from repro_torch.io import remix_io as TIO  # noqa: E402
from repro_torch.io.blockcache import BlockCache as TCache  # noqa: E402
from torch_twin import assert_same  # noqa: E402

VW = 2


def _vals(rng, n, vw=VW):
    return rng.integers(0, 2**32, (n, vw), dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------- memtable
def _memtable_ops(mt, seed):
    rng = np.random.default_rng(seed)
    seq = 1
    for step in range(40):
        r = rng.random()
        if r < 0.4:
            n = int(rng.integers(1, 30))
            keys = rng.integers(0, 200, n).astype(np.uint64)
            exp = None if rng.random() < 0.5 else rng.integers(0, 5, n).astype(np.uint32)
            seq = mt.put_batch(keys, _vals(rng, n), seq, exp=exp)
        elif r < 0.7:
            k = int(rng.integers(0, 200))
            mt.put(k, _vals(rng, 1)[0], seq, tomb=bool(rng.random() < 0.3),
                   exp=int(rng.integers(0, 3)))
            seq += 1
        elif r < 0.8:
            lo = int(rng.integers(0, 200))
            mt.delete_range(lo, lo + int(rng.integers(1, 40)), seq)
            seq += 1
        elif r < 0.9:
            mt.purge_range(int(rng.integers(0, 100)), int(rng.integers(100, 200)))
        else:
            view = mt.snapshot_view()
            list(view.items())
    return mt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memtable_parity(seed):
    r = _memtable_ops(RM.MemTable(vw=VW), seed)
    t = _memtable_ops(TM.MemTable(vw=VW), seed)
    assert_same(r.to_arrays(), t.to_arrays(), "to_arrays")
    assert_same(r.ranges, t.ranges, "ranges")
    assert len(r) == len(t) and r.approx_bytes() == t.approx_bytes()
    for k in range(0, 200, 3):
        assert_same(r.get(k), t.get(k), f"get({k})")
        assert r.covers(k) == t.covers(k)
    # the hot-key carry halves the counter and folds into a newer entry
    for mt in (r, t):
        e = mt.get(7) or mt.get(8)
        mt.carry_over(1000, RM.Entry(seq=9, tomb=False, val=np.ones(VW, np.uint32),
                                     count=200))
        mt.carry_over(7, RM.Entry(seq=3, tomb=False, val=np.zeros(VW, np.uint32),
                                  count=9))
        assert e is None or e.count >= 1
    assert_same(r.to_arrays(), t.to_arrays(), "after carry")
    for e in (RM.Entry(1, False, np.zeros(2, np.uint32), 1, exp=5),
              RM.Entry(1, True, np.zeros(2, np.uint32), 1)):
        for now in (4.0, 5.0, 6.0):
            assert RM.entry_dead(e, now) == TM.entry_dead(e, now)


# ---------------------------------------------------------------- WAL
def _wal_records(w, seed, n=700):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 5000, n).astype(np.uint64)
    for i in range(0, n, 100):
        k = keys[i:i + 100]
        w.append_batch(k, np.arange(i + 1, i + 1 + len(k), dtype=np.uint32),
                       rng.random(len(k)) < 0.1, _vals(rng, len(k)),
                       rng.integers(0, 3, len(k)).astype(np.uint32))
        w.append(int(rng.integers(0, 5000)), n + i + 1, False, _vals(rng, 1)[0], exp=7)
        w.append_range(100 + i, 200 + i, 2 * n + i)
    return keys


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _replay(w):
    return [(int(k), int(s), int(fl), int(e), np.asarray(v)) for k, s, fl, e, v in w.replay()]


@pytest.mark.parametrize("policy", ["none", "block", "always"])
def test_wal_bytes_and_cross_replay(tmp_path, policy):
    rp, tp = str(tmp_path / "r.log"), str(tmp_path / "t.log")
    rw, tw = RW.WAL(rp, vw=VW, sync_policy=policy), TW.WAL(tp, vw=VW, sync_policy=policy)
    keys = _wal_records(rw, 0)
    _wal_records(tw, 0)
    rw.sync(), tw.sync()
    assert _read(rp) == _read(tp)
    assert rw.bytes_written == tw.bytes_written and rw.used_blocks() == tw.used_blocks()
    assert_same(rw.save_state(), tw.save_state(), "state")
    assert rw.manifest() == tw.manifest()
    assert_same(_replay(rw), _replay(tw), "replay")
    assert_same(list(rw.read_from(300)), list(tw.read_from(300)), "read_from")
    # each package replays the other's file from its checkpoint
    state = rw.save_state()
    for W, path in ((TW.WAL, rp), (RW.WAL, tp)):
        w = W(path, vw=VW)
        w.restore_state(state)
        assert_same(_replay(w), _replay(rw), f"cross replay {W.__module__}")
    # GC: keep a subset of the keys, the remapped/rewritten logs agree
    live = set(int(k) for k in keys[::3])
    rw.gc(live), tw.gc(live)
    rw.sync(), tw.sync()
    assert _read(rp) == _read(tp)
    assert_same(_replay(rw), _replay(tw), "after gc")
    assert rw.free == tw.free
    with pytest.raises(ValueError):
        TW.WAL(str(tmp_path / "bad.log"), sync_policy="sometimes")


def test_wal_recover_tail_after_torn_block(tmp_path):
    """Appends after a checkpoint are adopted by the epoch-flip scan; a
    torn last block is dropped by both packages alike."""
    rp, tp = str(tmp_path / "r.log"), str(tmp_path / "t.log")
    for W, path in ((RW.WAL, rp), (TW.WAL, tp)):
        w = W(path, vw=VW)
        _wal_records(w, 1, n=300)
        w.sync()
    ckpt = None
    for W, path in ((RW.WAL, rp), (TW.WAL, tp)):
        w = W(path, vw=VW)
        w.recover_tail()
        ckpt = w.save_state() if ckpt is None else ckpt
        _wal_records(w, 2, n=400)
        w.sync()
    assert _read(rp) == _read(tp)
    size = os.path.getsize(rp)
    for path in (rp, tp):  # tear the last block mid-record
        with open(path, "r+b") as f:
            f.truncate(size - RW.BLOCK // 2)
    outs = []
    for W, path in ((RW.WAL, rp), (TW.WAL, tp), (TW.WAL, rp), (RW.WAL, tp)):
        w = W(path, vw=VW)
        w.restore_state(ckpt)
        outs.append((w.recover_tail(), _replay(w), w.max_seq))
    for o in outs[1:]:
        assert_same(o, outs[0], "recover_tail")
    assert outs[0][0] > 0


# ---------------------------------------------------------------- versions
def test_versionset_refcounts_and_release_hook():
    released = {"ref": [], "port": []}

    def hook(side):
        return lambda v, live: released[side].append(
            (v.vid, sorted(x.vid for x in live)))

    r = RV.VersionSet(on_release=hook("ref"))
    t = TV.VersionSet(on_release=hook("port"))
    for vs in (r, t):
        vs.publish(["p0"], seq_horizon=0)
        a = vs.pin_current()
        b = vs.pin_current()
        vs.publish(["p1"], seq_horizon=5)
        c = vs.pin_current()
        vs.unpin(a)
        assert vs.stats()["live"] == 2
        vs.publish(["p2"], seq_horizon=9)
        vs.unpin(b)
        vs.unpin(c)
    assert r.stats() == t.stats()
    assert released["ref"] == released["port"] == [(1, [2, 3]), (2, [3])]
    assert [v.vid for v in r.live_versions()] == [v.vid for v in t.live_versions()]
    assert r.current.seq_horizon == t.current.seq_horizon == 9


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("make", [
    lambda O: O.Op.scan(0, -1),
    lambda O: O.Op.delete_range(60, 10),
    lambda O: O.Op.put(np.array([1, 2], np.uint64), np.ones((3, 2), np.uint32)),
    lambda O: O.Op.multiget(np.zeros((2, 2), np.uint64)),
    lambda O: O.Op.cas(1, np.ones(3, np.uint32), [1, 1]),
])
def test_op_validation_errors_match(make):
    errs = []
    for O in (RO, TO):
        try:
            make(O)
            errs.append(None)
        except Exception as e:  # the class and message are compared
            errs.append((type(e).__name__, str(e)))
    assert errs[0] == errs[1]


def test_op_sizes_and_batch_model():
    ops = lambda O: [  # noqa: E731
        O.Op.get(1), O.Op.multiget([1, 2, 3]), O.Op.scan(5, 10),
        O.Op.put(7, [1, 2], ttl=30), O.Op.put(np.arange(4, dtype=np.uint64),
                                               np.ones((4, 2), np.uint32)),
        O.Op.delete(3), O.Op.delete_range(1, 9), O.Op.cas(2, None, [3, 3]),
    ]
    for a, b in zip(ops(RO), ops(TO)):
        assert a.kind.value == b.kind.value
        assert (a.is_read, a.write_rows(), a.cost_bytes(VW), repr(a)) == (
            b.is_read, b.write_rows(), b.cost_bytes(VW), repr(b))
    rb, tb = RO.Batch(ops(RO)), TO.Batch(ops(TO))
    assert (len(rb), rb.cost_bytes(VW), repr(rb)) == (len(tb), tb.cost_bytes(VW), repr(tb))
    assert [s.name for s in RO.OpStatus] == [s.name for s in TO.OpStatus]


# ------------------------------------------------- compaction + table helpers
def _table_data(rng, n, lo=0, span=4000, ttl=False):
    keys = np.sort(rng.choice(span, n, replace=False)).astype(np.uint64) + np.uint64(lo)
    exp = np.zeros(n, np.uint32)
    if ttl:
        m = rng.random(n) < 0.2
        exp[m] = rng.choice([90, 200], int(m.sum()))
    return dict(keys=keys, vals=_vals(rng, n), seq=rng.integers(1, 10**6, n).astype(np.uint32),
                tomb=rng.random(n) < 0.1, exp=exp)


def _tables(seed, sizes):
    rng = np.random.default_rng(seed)
    data = [_table_data(rng, n, ttl=i % 2 == 0) for i, n in enumerate(sizes)]
    return ([RP.Table(**d) for d in data], [TP.Table(**d) for d in data])


def _cols(t):
    return (t.keys, t.vals, t.seq, t.tomb, t.exp)


@pytest.mark.parametrize("drop_tombs", [False, True])
def test_merge_chunk_excise_match(drop_tombs):
    rt, tt = _tables(0, [300, 500, 200])
    rsp = [RP.ExcisedSpan(500, 1500, 10**7, tuple(rt[:2]))]
    tsp = [TP.ExcisedSpan(500, 1500, 10**7, tuple(tt[:2]))]
    for a, b in zip(rt, tt):
        ra, na = RP.excise_rows(a, rsp)
        tb_, nb = TP.excise_rows(b, tsp)
        assert na == nb
        assert_same(_cols(ra), _cols(tb_), "excise_rows")
    st_r, st_t = {}, {}
    mr = RP.merge_tables(rt, drop_tombs=drop_tombs, excised=rsp, now=100, stats=st_r)
    mt = TP.merge_tables(tt, drop_tombs=drop_tombs, excised=tsp, now=100, stats=st_t)
    assert st_r == st_t
    assert_same(_cols(mr), _cols(mt), "merge_tables")
    for a, b in zip(RP.chunk_table(mr, 128), TP.chunk_table(mt, 128)):
        assert_same(_cols(a), _cols(b), "chunk_table")


@pytest.mark.parametrize("sizes,new", [
    ([100], 50), ([100] * 9, 60), ([100] * 10, 60), ([60, 900, 1000], 900),
    ([500] * 10, 2000),
])
def test_plan_partition_kinds_match(sizes, new):
    rt, tt = _tables(1, sizes + [new])
    cfg = dict(table_cap=1000, t_max=10)
    rp = RP.Partition(0, rt[:-1], d=32)
    tp = TP.Partition(0, tt[:-1], d=32, device="cpu")
    a = RC.plan_partition(rp, rt[-1], RC.CompactionConfig(**cfg))
    b = TC.plan_partition(tp, tt[-1], TC.CompactionConfig(**cfg))
    assert (a.kind, a.major_inputs, a.est_wa) == (b.kind, b.major_inputs, b.est_wa)
    plans_r, plans_t = [a], [b]
    RC.apply_abort_budget(plans_r, RC.CompactionConfig(**cfg))
    TC.apply_abort_budget(plans_t, TC.CompactionConfig(**cfg))
    assert [p.kind for p in plans_r] == [p.kind for p in plans_t]


def test_execute_split_keeps_the_partitions_device():
    _, tt = _tables(2, [900, 900, 900])
    p = TP.Partition(0, tt[:-1], d=32, device="cpu")
    plan = TC.plan_partition(p, tt[-1], TC.CompactionConfig(table_cap=300, t_max=2))
    res = TC.execute(plan, TC.CompactionConfig(table_cap=300, t_max=2))
    assert plan.kind == "split" and len(res.new_partitions) > 1
    assert all(q.device.type == "cpu" for q in res.new_partitions)
    clone = p.clone_with_tables(tt[:1])
    assert clone.device == p.device


def test_host_routing_matches():
    rng = np.random.default_rng(3)
    lows = [0, 100, 5000, 1 << 40]
    keys = rng.integers(0, 1 << 41, 500).astype(np.uint64)
    assert_same(RSH.route_host(lows, keys), TSH.route_host(lows, keys))
    assert [RSH.route_one(lows, int(k)) for k in keys[:50]] == [
        TSH.route_one(lows, int(k)) for k in keys[:50]]
    assert RSH.partition_spans(lows) == TSH.partition_spans(lows)


# ------------------------------------------------- cold path + scrub rebuild
def _write_store(root, seed=4, n_tables=3, n=2500, d=16):
    """One partition of SSTables + a REMIX written by the reference."""
    rng = np.random.default_rng(seed)
    storage = Storage(root)
    domain = np.arange(1, n * n_tables + 1, dtype=np.uint64) * 8
    owner = rng.integers(0, n_tables, len(domain))
    names, runs = [], []
    for i in range(n_tables):
        k = domain[owner == i]
        run = make_run(k, vals_np=_vals(rng, len(k)),
                       seq=np.arange(1, len(k) + 1, dtype=np.uint32) + i * n,
                       tomb=rng.random(len(k)) < 0.15)
        runs.append(run)
        names.append(storage.write_table(np.asarray(run.keys), np.asarray(run.vals),
                                         np.asarray(run.seq), np.asarray(run.tomb)))
    remix, _ = build_remix(runs, d=d)
    return storage, names, storage.write_remix(remix), domain


def _cold_partition(mod, io_mod, storage, names, xname, cache, **kw):
    tables = []
    for nm in names:
        t = mod.Table.from_file(storage.table_path(nm))
        t.attach_cache(cache)
        tables.append(t)
    p = mod.Partition(0, tables, d=16, **kw)
    p.preload_index(io_mod.load_remix(storage.remix_path(xname),
                                      **({"device": "cpu"} if kw else {})))
    return p


def test_cold_path_on_reference_files(tmp_path):
    storage, names, xname, domain = _write_store(str(tmp_path / "db"))
    rp = _cold_partition(RP, RIO, storage, names, xname, RCache(1 << 20))
    tp = _cold_partition(TP, TIO, storage, names, xname, TCache(1 << 20), device="cpu")
    assert rp.cold_ready() and tp.cold_ready()
    rng = np.random.default_rng(5)
    probe = np.concatenate([rng.choice(domain, 200), rng.choice(domain, 50) + 1])
    assert_same(rp.cold_get_batch(probe), tp.cold_get_batch(probe), "cold_get_batch")
    for k in probe[:20].tolist():
        assert_same(rp.cold_get(k), tp.cold_get(k), f"cold_get({k})")
    starts = np.sort(rng.choice(domain, 16))
    for width in (7, np.arange(16) * 5 + 3):
        assert_same(rp.cold_scan_batch(starts, width), tp.cold_scan_batch(starts, width),
                    "cold_scan_batch")
    sr, st = rp.cold_cursor_seek(int(starts[3])), tp.cold_cursor_seek(int(starts[3]))
    assert_same(sr, st, "cursor state")
    for _ in range(4):
        assert_same(rp.cold_cursor_window(sr, 40, prefetch_depth=1),
                    tp.cold_cursor_window(st, 40, prefetch_depth=1), "window")
        assert_same(sr, st, "cursor state")
    assert rp.cold_disk_bytes() == tp.cold_disk_bytes() > 0
    assert_same(rp.promotion_inputs(0.5), tp.promotion_inputs(0.5), "promotion")
    # a promoted partition's first device build moves the host REMIX to
    # its device and reuses it (no rebuild)
    remix, _ = tp.index()
    assert tp.last_build_kind == "reuse" and remix.anchors.device.type == "cpu"


def test_scrub_rebuild_remix_and_rate_limiter(tmp_path):
    storage, names, xname, _ = _write_store(str(tmp_path / "db"), seed=6)
    tables_r = [RP.Table.from_file(storage.table_path(n)) for n in names]
    tables_t = [TP.Table.from_file(storage.table_path(n)) for n in names]
    a, b = RS.rebuild_remix(tables_r, d=16), TS.rebuild_remix(tables_t, d=16)
    pr, pt = str(tmp_path / "r.rmx"), str(tmp_path / "t.rmx")
    RIO.dump_remix(a, pr)
    TIO.dump_remix(b, pt)
    assert _read(pr) == _read(pt) == _read(storage.remix_path(xname))
    assert b.anchors.device.type == "cpu"
    rep_r = RS.scrub_version(storage, [RP.Partition(0, tables_r, d=16)])
    rep_t = TS.scrub_version(storage, [TP.Partition(0, tables_t, d=16, device="cpu")])
    assert rep_r.clean and rep_t.clean
    assert rep_r.bytes_read == rep_t.bytes_read
    lim = TS.RateLimiter(0)
    lim(1 << 20)


def test_store_imports_with_jax_and_repro_blocked():
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.db, repro_torch.db.store\n"
            "print(repro_torch.db.RemixDB.__module__)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.path.join(root, "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "repro_torch.db.store"


def _closed_store_refs(pkg, tmp_path, device_path):
    """A store with resident device views and built partition indexes:
    (weakrefs to a view tensor and to each partition's index tensors,
    answers before close(), answers after close()); the store is closed
    and deleted, and the cyclic collector is off throughout."""
    import gc
    import weakref

    from repro.db.compaction import CompactionConfig as RCC

    store_mod = __import__(f"{pkg}.db.store", fromlist=["RemixDB"])
    comp = RCC(table_cap=256, t_max=6)
    if pkg == "repro_torch":
        comp = TC.CompactionConfig(table_cap=256, t_max=6)
    kw = dict(device="cpu") if pkg == "repro_torch" else {}
    db = store_mod.RemixDB(store_mod.RemixDBConfig(
        memtable_entries=1 << 30, wal_dir=str(tmp_path), compaction=comp,
        device_path=device_path, **kw))
    keys = np.arange(3000, dtype=np.uint64) * 7
    db.put_batch(keys, np.stack([keys & 0xFFFF, keys >> 3], 1).astype(np.uint32))
    db.flush()
    probe = np.concatenate([keys[::5], keys[:50] + 1])
    before = db.get_batch(probe), db.scan_batch(keys[::300], 20)
    # the stacked runs of each view and of each partition's index (on the
    # CPU the last built REMIX stays where it is: it is the host copy)
    refs = [weakref.ref(v.runset.keys) for v in db.device_views._views.values()]
    for p in db.partitions:
        remix, runset = p.index()
        refs.append(weakref.ref(runset.keys))
    assert len(refs) >= 2
    gc.disable()
    try:
        db.close()
        after = db.get_batch(probe), db.scan_batch(keys[::300], 20)
        del db, p, remix, runset
        alive = [r() is not None for r in refs]
    finally:
        gc.enable()
    gc.collect()
    return alive, [r() is not None for r in refs], before, after


def test_close_frees_device_views_and_indexes_without_gc(tmp_path):
    """``RemixDB.close()`` releases the device views and every partition's
    device index at once: with the cyclic collector off, nothing is left
    after ``close()`` and ``del``. A read after ``close()`` rebuilds its
    index and answers as before.

    A divergence kept on record: the reference's ``close()`` releases
    neither, and its store sits in reference cycles, so its device arrays
    wait for ``gc.collect()`` (asserted below)."""
    alive, _, before, after = _closed_store_refs("repro_torch", tmp_path / "p", "on")
    assert not any(alive), alive
    for a, b in zip(before, after):
        assert_same(a, b, "read after close()")
    ref_alive, ref_after_gc, _, _ = _closed_store_refs("repro", tmp_path / "r", "on")
    assert all(ref_alive) and not any(ref_after_gc)
