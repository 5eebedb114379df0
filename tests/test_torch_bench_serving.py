"""The port's serving benchmarks (``repro_torch.bench.engine_bench`` and
``cluster_bench``) against the reference's (``benchmarks/``), on the CPU at
the reference's ``--tiny`` sizes: the same shard files, the same mixed op
batches and answers through ``KVServeEngine.submit`` and the scalar loop,
the same metrics snapshot, an O(1) snapshot pin; the cluster's preload,
live split, replica catch-up (lag 0) and counters equal to the
reference's, and the port's split under its zipfian submitters with 0
failed ops. No test here asserts a time or a ratio of times; the ``slow``
cases run the port's whole ``run(tiny=True)`` with its bars.
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's benchmarks live at the root
    sys.path.insert(0, str(ROOT))

import benchmarks.cluster_bench as RCl  # noqa: E402
import benchmarks.engine_bench as RE  # noqa: E402
from repro.cluster import Cluster as RCluster  # noqa: E402
from repro.db.ops import Batch as RBatch  # noqa: E402
from repro.db.store import RemixDBConfig as RCfg  # noqa: E402
from repro.serve.engine import KVServeEngine as RKV  # noqa: E402
from repro_torch.bench import cluster_bench as TCl  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import engine_bench as TE  # noqa: E402
from repro_torch.cluster import Cluster as TCluster  # noqa: E402
from repro_torch.db.ops import Batch as TBatch  # noqa: E402
from repro_torch.db.store import RemixDB as TDB  # noqa: E402
from repro_torch.db.store import RemixDBConfig as TCfg  # noqa: E402
from repro_torch.serve.engine import KVServeEngine as TKV  # noqa: E402
from torch_twin import assert_same, same_dir_bytes, twin_dir  # noqa: E402

CPU = "cpu"
R_TABLES, N_PER_TABLE = TE.SIZES["tiny"]
N_PER_SHARD = TCl.SIZES["tiny"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Both packages' two engine shards at the tiny size: (reference roots,
    port roots, key domains)."""
    base = tmp_path_factory.mktemp("shards")
    ref = [str(base / f"ref{i}") for i in range(2)]
    port = [str(base / f"port{i}") for i in range(2)]
    domains = []
    for i in range(2):
        d = RE._build_shard(ref[i], i * RE.SPLIT, R_TABLES, N_PER_TABLE, seed=i)
        np.testing.assert_array_equal(
            TE._build_shard(port[i], i * TE.SPLIT, R_TABLES, N_PER_TABLE, seed=i), d)
        domains.append(d)
    return ref, port, domains


def _engines(ref, port):
    """Both packages' engines over their shards, promotion off (the op
    layer over the cold engine is the subject, as in the benchmark)."""
    r = RKV([(0, ref[0]), (RE.SPLIT, ref[1])], config=RCfg(promote_fraction=1e9))
    t = TKV([(0, port[0]), (TE.SPLIT, port[1])],
            config=TCfg(promote_fraction=1e9, device=CPU))
    return r, t


def _ops(mod, domains, seed, q=256):
    return mod._mixed_ops(domains, np.random.default_rng(seed), q)


def _op_fields(op):
    return (op.kind.name, op.key, op.start, op.n)


def test_build_shard_writes_the_same_files(shards):
    ref, port, _ = shards
    for a, b in zip(ref, port):
        assert len(same_dir_bytes(a, b)) == R_TABLES + 4


def test_mixed_batches_match_reference(shards):
    """``bench_mixed``'s batches: the same ops, the same answers through
    ``submit`` on both packages, the port's scalar loop equal to its
    ``submit`` (``_check_equal``), and equal metrics snapshots after the
    same work."""
    ref, port, domains = shards
    reng, teng = _engines(ref, port)
    try:
        for seed in (29, 30):
            rops, tops = _ops(RE, domains, seed), _ops(TE, domains, seed)
            assert [_op_fields(o) for o in tops] == [_op_fields(o) for o in rops]
            assert {o.kind.name for o in tops} == {"GET", "SCAN"}
            rres = reng.submit(RBatch(list(rops)), sync=True).result()
            tres = teng.submit(TBatch(list(tops)), sync=True).result()
            assert_same(rres.results, tres.results, f"batch {seed}")
            TE._check_equal(tops, TE._scalar_loop(teng, tops), tres)
            RE._check_equal(rops, RE._scalar_loop(reng, rops), rres)
        assert_same(reng.metrics(), teng.metrics(), "metrics")
    finally:
        reng.close(), teng.close()


def test_async_trace_and_artifacts(shards, tmp_path):
    """``bench_async``'s batches complete ok; a traced batch is well formed
    and its Chrome trace and the metrics snapshot save and load."""
    import json

    from repro_torch.obs.metrics import load_snapshot, save_snapshot

    ref, port, domains = shards
    teng = TKV([(0, port[0]), (TE.SPLIT, port[1])],
               config=TCfg(promote_fraction=1e9, device=CPU))
    try:
        csv = TC.CSV()
        TE.bench_async(teng, domains, csv)
        assert csv.rows[0].startswith("engine_async_submit,")
        traced = teng.submit(TBatch(_ops(TE, domains, 43, 64), trace=True),
                             sync=True).result()
        assert traced.ok and traced.trace is not None and traced.trace.well_formed()
        snap = teng.metrics()
    finally:
        teng.close()
    save_snapshot(snap, tmp_path / "OBS_snapshot.json")
    traced.trace.save_chrome(str(tmp_path / "OBS_trace.json"))
    assert load_snapshot(tmp_path / "OBS_snapshot.json") == json.loads(json.dumps(snap))
    assert json.load(open(tmp_path / "OBS_trace.json"))


def test_snapshot_pin_is_o1(tmp_path):
    """``bench_snapshot_o1``'s claim without its clock: a snapshot of a full
    memtable freezes the layer it has, and a second snapshot shares it (no
    copy of the overlay)."""
    n = 1 << 12
    db = TDB.open(str(tmp_path / "db"), TCfg(memtable_entries=4 * n, device=CPU))
    try:
        ks = np.arange(n, dtype=np.uint64)
        db.put_batch(ks, np.stack([ks.astype(np.uint32), np.ones(n, np.uint32)], 1))
        assert len(db.mem.data) >= n
        a, b = db.snapshot(), db.snapshot()
        try:
            assert len(a.overlay) == len(b.overlay) == n
            assert all(x is y for x, y in zip(a.overlay.layers, b.overlay.layers))
        finally:
            a.close(), b.close()
    finally:
        db.close()


def _preload(cluster, keyspace):
    ks = np.arange(keyspace, dtype=np.uint64)
    for i in range(0, keyspace, 1 << 14):
        sl = ks[i:i + (1 << 14)]
        cluster.put_batch(sl, np.stack([sl.astype(np.uint32),
                                        np.zeros(len(sl), np.uint32)], 1))
    cluster.flush()
    return ks


def test_cluster_split_and_replica_match_reference(tmp_path):
    """``cluster_bench``'s topology steps without the traffic (whose
    interleaving is the scheduler's): the same preload, split report,
    replica lag before and after catch-up, answers and serve counters as
    the reference's ``Cluster``."""
    keyspace = TCl.SHARDS * N_PER_SHARD
    span = keyspace // TCl.SHARDS
    lows = tuple(i * span for i in range(TCl.SHARDS))
    rdir, tdir = twin_dir(tmp_path / "fleet")  # paths compare equal across twins
    rc = RCluster(rdir, lows=lows, config=RCl._cfg())
    tc = TCluster(tdir, lows=lows, config=TCl._cfg(CPU))
    try:
        out = {}
        for name, c in (("ref", rc), ("port", tc)):
            ks = _preload(c, keyspace)
            report = c.split(span // 2)
            rep = c.add_replica(c.lows[0])
            wk = np.arange(0, span // 4, dtype=np.uint64)
            c.put_batch(wk, np.stack([wk.astype(np.uint32),
                                      np.full(len(wk), 9, np.uint32)], 1))
            lag_before = rep.seq_lag()
            final = rep.catch_up_until(lag_target=0)
            assert rep.seq_lag() == 0
            snap = c.metrics()
            counters = {m["name"]: m.get("value", 0) for m in snap["metrics"]
                        if m.get("type") == "counter"
                        and m.get("labels", {}).get("tier") == "serve"}
            out[name] = dict(
                lows=tuple(c.lows), at=report["at"], shipped=report["shipped"],
                final_lag=report["final"]["lag"], lag_before=lag_before,
                applied=final["applied"], reads=c.get_batch(ks), counters=counters)
        assert out["port"]["lows"] == out["ref"]["lows"] and len(out["port"]["lows"]) == 4
        assert out["port"]["lag_before"] > 0
        assert_same(out["ref"], out["port"], "cluster")
    finally:
        rc.close(), tc.close()


def test_cluster_split_under_traffic_fails_no_op(tmp_path, monkeypatch):
    """The port's ``_Traffic`` (3 zipfian submitters, a quarter puts) across
    a live split: 0 failed ops and batches on both sides of the split."""
    keyspace = TCl.SHARDS * N_PER_SHARD
    span = keyspace // TCl.SHARDS
    c = TCluster(str(tmp_path / "fleet"), lows=tuple(i * span for i in range(TCl.SHARDS)),
                 config=TCl._cfg(CPU))
    try:
        _preload(c, keyspace)
        traffic = TCl._Traffic(c, keyspace)
        traffic.start()
        t0 = time.perf_counter()
        time.sleep(0.5)
        t1 = time.perf_counter()
        c.split(span // 2)
        t2 = time.perf_counter()
        time.sleep(0.5)
        traffic.stop()
        assert all(not t.is_alive() for t in traffic._threads)
        assert traffic.failed == []
        assert len(traffic.window(t0, t1)) > 0 and len(traffic.window(t2, time.perf_counter())) > 0
        assert len(c.lows) == TCl.SHARDS + 1
    finally:
        c.close()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["engine", "cluster"])
def test_serving_run_with_its_bars(name, tmp_path):
    """The port's whole ``run(tiny=True)`` on the CPU with every bar it
    asserts, and its JSON record beside the reference's keys."""
    mod = TE if name == "engine" else TCl
    record = mod.run(TC.CSV(), tiny=True, json_path=str(tmp_path / "b.json"), device=CPU)
    assert record["card"] == "cpu"
    if name == "engine":
        assert (tmp_path / "OBS_snapshot.json").exists() and (tmp_path / "OBS_trace.json").exists()
    else:
        assert record["failed_ops"] == 0 and record["replica"]["lag_after_catchup"] == 0
