"""The cluster tier's tier-1 cases (``tests/test_cluster.py``), held between
the JAX package and the port.

Each case runs on twins (``tests/torch_twin.py``): the reference's
``repro.cluster`` objects and the port's, each over its own directories
(the port's are the reference's with ``.port`` appended), every call made
on both and the answers compared bit for bit; the case's own assertions
then hold for both. A fault plan is carried to the port as a fresh plan
with the same rules and seed, so both ships see the same faults. Shipped
directories and every shard directory of a fleet are byte-identical
between the packages, and each package reopens a fleet that the other
wrote. ``split_under_async_traffic`` runs on the port alone: its threads
interleave differently on each side. The file-GC windows of a merge and
of a replica's catch-up run each package on its own and record where
they part: the port survives them, the reference raises.
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster import Cluster as RCluster  # noqa: E402
from repro.cluster import Replica as RReplica  # noqa: E402
from repro.cluster import ship_snapshot as r_ship_snapshot  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.io.faults import FaultPlan, IOContext, TransientIOError  # noqa: E402
from torch_twin import PORT_CPU, pair_class, same_dir_bytes, to_port, twin_dir  # noqa: E402

RemixDB = pair_class(RRemixDB)
Cluster = pair_class(RCluster)
Replica = pair_class(RReplica)
ship_snapshot = pair_class(r_ship_snapshot)

KEY_RANGE = 1 << 16


def _cfg(**kw):
    return RemixDBConfig(
        vw=2,
        memtable_entries=kw.pop("memtable_entries", 1 << 10),
        compaction=kw.pop(
            "compaction", CompactionConfig(table_cap=1 << 12, t_max=4)
        ),
        **kw,
    )


def _vals(keys, tag):
    keys = np.asarray(keys, np.uint64)
    return np.stack(
        [keys.astype(np.uint32), np.full(len(keys), tag, np.uint32)], 1
    )


def _assert_same_reads(cluster, mono, *, n=KEY_RANGE, probes=None):
    """Topology is invisible to reads."""
    ck, cv = cluster.scan(0, n)
    mk, mv = mono.scan(0, n)
    np.testing.assert_array_equal(ck, mk)
    np.testing.assert_array_equal(cv, mv)
    if probes is not None and len(probes):
        probes = np.asarray(sorted(set(probes)), np.uint64)
        cf, cg = cluster.get_batch(probes)
        mf, mg = mono.get_batch(probes)
        np.testing.assert_array_equal(cf, mf)
        hit = np.asarray(cf, bool)
        np.testing.assert_array_equal(cg[hit], mg[hit])


def _workload(rng, cluster, mono, rounds=4, ops_per_round=6):
    """Apply one random op mix to both sides; returns probe keys."""
    touched = []
    for _ in range(rounds):
        for _ in range(ops_per_round):
            roll = rng.random()
            if roll < 0.6:
                ks = rng.choice(KEY_RANGE, size=64, replace=False).astype(np.uint64)
                vs = _vals(ks, rng.integers(1, 1 << 16))
                cluster.put_batch(ks, vs)
                mono.put_batch(ks, vs)
                touched.extend(int(k) for k in ks[:8])
            elif roll < 0.8:
                lo = int(rng.integers(0, KEY_RANGE - 1))
                hi = lo + int(rng.integers(1, KEY_RANGE // 8))
                cluster.delete_range(lo, hi)
                mono.delete_range(lo, hi)
            else:
                k = int(rng.integers(0, KEY_RANGE))
                cluster.delete(k)
                mono.delete(k)
                touched.append(k)
    return touched


def _same_fleet_bytes(root):
    """Every shard directory of a twin fleet, byte for byte."""
    ref, port = twin_dir(root)
    names = sorted(n for n in os.listdir(ref) if n.startswith("shard-"))
    assert names == sorted(n for n in os.listdir(port) if n.startswith("shard-"))
    for n in names:
        same_dir_bytes(os.path.join(ref, n), os.path.join(port, n))
    return names


# ---------------------------------------------------------------- ship
def test_ship_snapshot_bit_identical(tmp_path):
    db = RemixDB.open(str(tmp_path / "src"), _cfg())
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 20, size=3000, replace=False).astype(np.uint64)
    db.put_batch(keys[:2000], _vals(keys[:2000], 1))
    db.flush()
    db.put_batch(keys[2000:], _vals(keys[2000:], 2))  # overlay rides along
    db.delete_range(100, 5000)

    report = ship_snapshot(db, str(tmp_path / "copy"))
    assert report["files"] >= 2 and report["bytes"] > 0
    assert len(same_dir_bytes(*twin_dir(tmp_path / "copy"))) >= report["files"]

    db2 = RemixDB.open(str(tmp_path / "copy"), _cfg())
    try:
        for args in ((0, 4000), (1 << 19, 500)):
            np.testing.assert_array_equal(db.scan(*args)[0], db2.scan(*args)[0])
            np.testing.assert_array_equal(db.scan(*args)[1], db2.scan(*args)[1])
        f1, g1 = db.get_batch(keys)
        f2, g2 = db2.get_batch(keys)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(g1, g2)
    finally:
        db2.close()
        db.close()


def test_ship_snapshot_retries_transient_faults(tmp_path):
    """Transient EIO on the shipped table/REMIX reads: the copy path
    retries through the fault-plan budget and completes in both packages;
    each plan's fired counters prove the faults were exercised."""
    db = RemixDB.open(str(tmp_path / "src"), _cfg())
    keys = np.arange(0, 2000, dtype=np.uint64)
    db.put_batch(keys, _vals(keys, 3))
    db.flush()

    plan = (FaultPlan(seed=7)
            .transient_read(".sst", count=2)
            .transient_read(".rmx", count=1))
    io = IOContext(plan=plan, retries=4)
    report = ship_snapshot(db, str(tmp_path / "copy"), io=io)
    assert plan.fired["transient_read"] == 3  # every rule consumed
    assert to_port(plan).fired["transient_read"] == 3
    assert report["files"] >= 2
    same_dir_bytes(*twin_dir(tmp_path / "copy"))

    db2 = RemixDB.open(str(tmp_path / "copy"), _cfg())
    try:
        np.testing.assert_array_equal(db.scan(0, 3000)[0], db2.scan(0, 3000)[0])
    finally:
        db2.close()
        db.close()


def test_ship_snapshot_gives_up_past_retry_budget(tmp_path):
    db = RemixDB.open(str(tmp_path / "src"), _cfg())
    db.put_batch(np.arange(100, dtype=np.uint64), _vals(np.arange(100), 1))
    db.flush()
    io = IOContext(plan=FaultPlan().transient_read(".sst", count=10), retries=2)
    with pytest.raises(TransientIOError):  # and the port raised it too
        ship_snapshot(db, str(tmp_path / "copy"), io=io)
    db.close()


# ------------------------------------------------------------- replicas
def test_replica_catchup_converges_after_writer_pause(tmp_path):
    db = RemixDB.open(str(tmp_path / "src"), _cfg())
    rng = np.random.default_rng(1)
    keys = rng.choice(1 << 20, size=2000, replace=False).astype(np.uint64)
    db.put_batch(keys[:1000], _vals(keys[:1000], 1))
    db.flush()

    rep = Replica(db, str(tmp_path / "replica"))
    try:
        # steady state: tail-only rounds, no file fetches
        db.put_batch(keys[1000:1500], _vals(keys[1000:1500], 2))
        r = rep.catch_up()
        assert r["lag"] == 0 and r["files"] == 0 and r["applied"] == 500

        # across a primary flush + range delete: manifest-diff fetch
        db.put_batch(keys[1500:], _vals(keys[1500:], 3))
        db.delete_range(4096, 8192)
        db.flush()
        r = rep.catch_up()
        assert r["lag"] == 0 and r["files"] > 0

        # writer paused: the gauge reads zero and reads are identical
        snap = rep.db.registry.snapshot()
        lags = [m for m in snap["metrics"] if m["name"] == "replica_seq_lag"]
        assert lags and all(m["value"] == 0 for m in lags)
        np.testing.assert_array_equal(db.scan(0, 4000)[0], rep.scan(0, 4000)[0])
        np.testing.assert_array_equal(db.scan(0, 4000)[1], rep.scan(0, 4000)[1])

        # idle rounds are cheap and stable
        r = rep.catch_up()
        assert r == dict(applied=0, files=0, bytes=0, version=r["version"], lag=0)
    finally:
        rep.close()
        db.close()


def test_replica_lag_tracks_writes(tmp_path):
    db = RemixDB.open(str(tmp_path / "src"), _cfg())
    db.put_batch(np.arange(100, dtype=np.uint64), _vals(np.arange(100), 1))
    rep = Replica(db, str(tmp_path / "replica"))
    try:
        assert rep.seq_lag() == 0
        db.put_batch(np.arange(100, 150, dtype=np.uint64), _vals(np.arange(100, 150), 2))
        assert rep.seq_lag() == 50
        rep.catch_up_until(lag_target=0)
        assert rep.seq_lag() == 0
    finally:
        rep.close()
        db.close()


# --------------------------------------------------- split/merge (diff)
def test_split_merge_differential_vs_monolith(tmp_path):
    """Random workloads interleaved with live splits and merges: the
    cluster stays read-identical to a monolithic store at every topology
    step, including after reopen from disk; every shard directory is
    byte-identical between the packages."""
    rng = np.random.default_rng(11)
    mono = RemixDB.open(str(tmp_path / "mono"), _cfg())
    root = str(tmp_path / "fleet")
    cluster = Cluster(root, lows=(0,), config=_cfg())
    try:
        probes = _workload(rng, cluster, mono)
        _assert_same_reads(cluster, mono, probes=probes)

        cluster.split(KEY_RANGE // 2)
        assert len(cluster.lows) == 2
        _assert_same_reads(cluster, mono, probes=probes)

        probes += _workload(rng, cluster, mono)
        _assert_same_reads(cluster, mono, probes=probes)

        cluster.split(KEY_RANGE // 4)
        cluster.flush()
        mono.flush()
        assert len(_same_fleet_bytes(root)) == 3
        probes += _workload(rng, cluster, mono)
        _assert_same_reads(cluster, mono, probes=probes)

        # merge everything back down to one shard
        while len(cluster.lows) > 1:
            cluster.merge(cluster.lows[-1])
            _assert_same_reads(cluster, mono, probes=probes)
        probes += _workload(rng, cluster, mono)
        _assert_same_reads(cluster, mono, probes=probes)

        snap = cluster.metrics()
        counters = {m["name"]: m.get("value", 0)
                    for m in snap["metrics"]
                    if m.get("type") == "counter"
                    and m.get("labels", {}).get("tier") == "serve"}
        assert counters.get("shard_split") == 2
        assert counters.get("shard_merge") == 2
        assert counters.get("snapshot_ship_bytes", 0) > 0

        # topology survives reopen
        ck, cv = cluster.scan(0, KEY_RANGE)
        cluster.close()
        assert _same_fleet_bytes(root) == ["shard-00000000000000000000"]
        reopened = Cluster(root, lows=None, config=_cfg())
        try:
            assert reopened.lows == [0]
            np.testing.assert_array_equal(reopened.scan(0, KEY_RANGE)[0], ck)
            np.testing.assert_array_equal(reopened.scan(0, KEY_RANGE)[1], cv)
        finally:
            reopened.close()
        cluster = None
    finally:
        if cluster is not None:
            cluster.close()
        mono.close()


def test_split_under_async_traffic_zero_failed_ops(tmp_path):
    """Port alone (four threads interleave differently on each side): a
    live split and a merge back mid-traffic; every submitted op completes
    OK — gated callers wait out the cutover, nothing fails."""
    from repro_torch.cluster import Cluster as TCluster
    from repro_torch.db.ops import Batch, Op

    cluster = TCluster(str(tmp_path / "fleet"), lows=(0,),
                       config=to_port(_cfg(), PORT_CPU))
    failures = []
    completed = [0]
    stop = threading.Event()

    def traffic(tid):
        rng = np.random.default_rng(100 + tid)
        while not stop.is_set():
            ks = rng.integers(0, KEY_RANGE, size=32).astype(np.uint64)
            try:
                futs = [
                    cluster.submit(Batch([Op.put(ks, _vals(ks, tid + 1))])),
                    cluster.submit(Batch([Op.multiget(ks), Op.scan(int(ks[0]), 16)])),
                ]
                for f in futs:
                    for r in f.result(timeout=60).results:
                        r.raise_if_error()
                completed[0] += 1
            except Exception as e:  # pragma: no cover - the assertion
                failures.append(repr(e))

    threads = [threading.Thread(target=traffic, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        cluster.flush()
        cluster.split(KEY_RANGE // 2)
        time.sleep(0.3)
        cluster.merge(cluster.lows[1])
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    assert completed[0] > 0
    assert cluster.lows == [0]
    cluster.close()


def _packages():
    """(name, cluster module, replica module, store class, store config)
    of each side."""
    import repro.cluster.cluster as r_cluster
    import repro.cluster.replica as r_replica
    import repro_torch.cluster.cluster as t_cluster
    import repro_torch.cluster.replica as t_replica
    from repro_torch.db.store import RemixDB as TRemixDB

    return (("reference", r_cluster, r_replica, RRemixDB, _cfg()),
            ("port", t_cluster, t_replica, TRemixDB,
             to_port(_cfg(), PORT_CPU)))


def test_merge_survives_flush_during_copy(tmp_path, monkeypatch):
    """A flush of the absorbing shard while the merge's live copy is on
    disk but committed by no Version of that shard: its file GC must
    leave the copies alone. The port reserves each name before the bytes
    land; the reference's GC quarantines them and the merge's absorb then
    raises ``FileNotFoundError``."""
    rng = np.random.default_rng(21)
    keys = rng.choice(KEY_RANGE, size=6000, replace=False).astype(np.uint64)
    extra = keys[keys < KEY_RANGE // 2][:200]
    for name, cmod, _rmod, _store, cfg in _packages():
        real = cmod.fetch_files
        copied, calls = [], []

        def fetch(*a, **kw):
            out = real(*a, **kw)
            copied.extend(kw["rename"].values())
            calls.append(1)
            if len(calls) == 1:
                cluster.put_batch(extra, _vals(extra, 9))
                cluster.serve.shards[0].flush()
            return out

        monkeypatch.setattr(cmod, "fetch_files", fetch)
        cluster = cmod.Cluster(str(tmp_path / name), lows=(0,), config=cfg)
        try:
            cluster.put_batch(keys[:4000], _vals(keys[:4000], 1))
            cluster.flush()
            cluster.split(KEY_RANGE // 2)
            cluster.put_batch(keys[4000:], _vals(keys[4000:], 2))
            absorbing = cluster.serve.shards[0].cfg.data_dir
            if name == "reference":
                with pytest.raises(FileNotFoundError):
                    cluster.merge(cluster.lows[1])
                continue
            cluster.merge(cluster.lows[1])
            assert cluster.lows == [0] and copied
            oracle = {int(k): 1 for k in keys[:4000]}
            oracle.update({int(k): 2 for k in keys[4000:]})
            oracle.update({int(k): 9 for k in extra})
            order = np.asarray(sorted(oracle), np.uint64)
            want = _vals(order, 0)
            want[:, 1] = [oracle[int(k)] for k in order]
            found, vals = cluster.get_batch(order)
            assert np.asarray(found, bool).all()
            np.testing.assert_array_equal(np.asarray(vals), want)
            sk, sv = cluster.scan(0, KEY_RANGE)
            np.testing.assert_array_equal(np.asarray(sk), order)
            np.testing.assert_array_equal(np.asarray(sv), want)
            qdir = os.path.join(absorbing, "quarantine")
            held = set(os.listdir(qdir)) if os.path.isdir(qdir) else set()
            assert not held & set(copied)
        finally:
            cluster.close()


def test_replica_catchup_pin_drop_during_fetch(tmp_path, monkeypatch):
    """The replica catch-up's window between ``fetch_files`` and
    ``adopt_version``: the last pin of a retired Version of the replica's
    store drops there, and its release hook runs the store's file GC.
    The port reserves the fetched names and catches up; the reference's
    GC quarantines them and ``adopt_version`` raises
    ``FileNotFoundError``."""
    rng = np.random.default_rng(22)
    keys = rng.choice(1 << 20, size=3000, replace=False).astype(np.uint64)
    outcome = {}
    for name, _cmod, rmod, store, cfg in _packages():
        real = rmod.fetch_files
        armed = []

        def fetch(*a, **kw):
            out = real(*a, **kw)
            if armed:
                armed.pop().close()
            return out

        monkeypatch.setattr(rmod, "fetch_files", fetch)
        db = store.open(str(tmp_path / name / "src"), cfg)
        rep = rmod.Replica(db, str(tmp_path / name / "replica"))
        try:
            db.put_batch(keys[:1000], _vals(keys[:1000], 1))
            db.flush()
            rep.catch_up()
            pinned = rep.db.snapshot()  # holds the current Version
            db.put_batch(keys[1000:2000], _vals(keys[1000:2000], 2))
            db.flush()
            rep.catch_up()  # retires the pinned Version
            db.put_batch(keys[2000:], _vals(keys[2000:], 3))
            db.flush()
            armed.append(pinned)
            try:
                r = rep.catch_up()
                outcome[name] = "ok"
                assert r["lag"] == 0 and r["files"] > 0
                np.testing.assert_array_equal(db.scan(0, 1 << 20)[0],
                                              rep.scan(0, 1 << 20)[0])
                np.testing.assert_array_equal(db.scan(0, 1 << 20)[1],
                                              rep.scan(0, 1 << 20)[1])
            except FileNotFoundError:
                outcome[name] = "FileNotFoundError"
        finally:
            rep.close()
            db.close()
    assert outcome == dict(reference="FileNotFoundError", port="ok")


def test_placement_splits_hot_shard(tmp_path):
    """A zipfian-hot shard with enough routed ops and a materialized
    partition boundary gets split at a boundary near the load median."""
    cluster = Cluster(
        str(tmp_path / "fleet"), lows=(0,),
        config=_cfg(compaction=CompactionConfig(table_cap=1024, t_max=4)),
    )
    try:
        ks = np.arange(0, 8192, dtype=np.uint64)
        cluster.put_batch(ks, _vals(ks, 1))
        cluster.flush()
        rng = np.random.default_rng(5)
        for _ in range(40):
            cluster.get_batch(rng.integers(0, 4096, size=32).astype(np.uint64))
        assert cluster.maybe_split(factor=2.0, min_ops=16) is not None
        assert len(cluster.lows) == 2
        # counters reset enough that an idle fleet does not re-split
        assert cluster.maybe_split(factor=1 << 30, min_ops=16) is None
    finally:
        cluster.close()


def test_cluster_replica_via_add_replica(tmp_path):
    cluster = Cluster(str(tmp_path / "fleet"), lows=(0,), config=_cfg())
    try:
        ks = np.arange(0, 1000, dtype=np.uint64)
        cluster.put_batch(ks, _vals(ks, 1))
        rep = cluster.add_replica(0)
        cluster.put_batch(ks[:100], _vals(ks[:100], 2))
        rep.catch_up_until(lag_target=0)
        np.testing.assert_array_equal(cluster.scan(0, 2000)[0], rep.scan(0, 2000)[0])
        np.testing.assert_array_equal(cluster.scan(0, 2000)[1], rep.scan(0, 2000)[1])
    finally:
        cluster.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reopens_the_others_fleet(tmp_path, writer):
    """A fleet written, split and merged by one package is reopened by the
    other through ``Cluster(lows=None)`` and reads back the same."""
    from repro_torch.cluster import Cluster as TCluster

    classes = {"reference": (RCluster, _cfg()), "port": (TCluster, to_port(_cfg(), PORT_CPU))}
    reader = "port" if writer == "reference" else "reference"
    rng = np.random.default_rng(3)
    root = str(tmp_path / "fleet")
    cls, cfg = classes[writer]
    c = cls(root, lows=(0,), config=cfg)
    ks = rng.choice(KEY_RANGE, size=3000, replace=False).astype(np.uint64)
    c.put_batch(ks, _vals(ks, 1))
    c.flush()
    c.split(KEY_RANGE // 2)
    c.split(KEY_RANGE // 4)
    c.put_batch(ks[:500], _vals(ks[:500], 2))  # unflushed: the WAL carries it
    c.delete_range(100, 9000)
    c.merge(c.lows[-1])
    lows = c.lows
    want = c.scan(0, KEY_RANGE)
    c.close()
    cls, cfg = classes[reader]
    c2 = cls(root, lows=None, config=cfg)
    try:
        assert c2.lows == lows and len(lows) == 2
        got = c2.scan(0, KEY_RANGE)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        f, v = c2.get_batch(ks)
        wf = np.isin(ks, want[0])
        np.testing.assert_array_equal(f, wf)
    finally:
        c2.close()
    assert any(n.startswith("retired-") for n in os.listdir(root))


# ------------------------------------------------------------- nightly
@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(8))
def test_nightly_replica_catchup_matrix(tmp_path, seed):
    """Multi-seed replica convergence on twins: randomized op mixes with
    flush points in between; after every burst the replica catches up and
    reads identically; final lag is exactly zero."""
    rng = np.random.default_rng(seed)
    db = RemixDB.open(str(tmp_path / "src"), _cfg(memtable_entries=256))
    rep = Replica(db, str(tmp_path / "replica"))
    try:
        for burst in range(5):
            for _ in range(int(rng.integers(2, 6))):
                if rng.random() < 0.7:
                    ks = rng.choice(4096, size=64, replace=False).astype(np.uint64)
                    db.put_batch(ks, _vals(ks, burst + 1))
                else:
                    lo = int(rng.integers(0, 4000))
                    db.delete_range(lo, lo + int(rng.integers(1, 500)))
            if rng.random() < 0.5:
                db.flush()
            rep.catch_up_until(lag_target=0)
            assert rep.seq_lag() == 0
            np.testing.assert_array_equal(db.scan(0, 5000)[0], rep.scan(0, 5000)[0])
            np.testing.assert_array_equal(db.scan(0, 5000)[1], rep.scan(0, 5000)[1])
    finally:
        rep.close()
        db.close()


@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(4))
def test_nightly_split_merge_matrix(tmp_path, seed):
    """Randomized topology churn on twins, checked against a monolith."""
    rng = np.random.default_rng(1000 + seed)
    mono = RemixDB.open(str(tmp_path / "mono"), _cfg())
    cluster = Cluster(str(tmp_path / "fleet"), lows=(0,), config=_cfg())
    try:
        probes = []
        for _ in range(5):
            probes += _workload(rng, cluster, mono, rounds=2)
            lows = cluster.lows
            if len(lows) > 2 and rng.random() < 0.5:
                cluster.merge(lows[int(rng.integers(1, len(lows)))])
            else:
                try:
                    cluster.split(int(rng.integers(1, KEY_RANGE)))
                except ValueError:
                    pass  # span had no usable boundary; topology keeps
            _assert_same_reads(cluster, mono, probes=probes)
    finally:
        cluster.close()
        mono.close()
