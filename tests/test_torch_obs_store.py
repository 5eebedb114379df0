"""The store-level cases of ``tests/test_obs.py``, held between the JAX
package and the port.

Each case runs on a twin store (``tests/torch_twin.py``): every call goes to
the reference's ``RemixDB`` and to the port's ``RemixDB(device="cpu")``,
their answers must be equal, and the case's own assertions then hold for
both. Times are left out: the harness skips wall-time fields and latency
buckets, and the event log is compared by kind and fields, never by
timestamp. The port's twin runs its device views where the reference's
host path does not (the harness's ``device_path="on"``): their events are
left out of the port's log where the reference has none, as the harness
leaves out their metrics. Where an assertion needs one object's identity (the
engine's last trace) it is made on each side.
"""
import glob
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.db import clock as rclock  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.ops import Batch  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.io.faults import flip_bytes  # noqa: E402
from repro.obs.metrics import render_prometheus  # noqa: E402
from repro_torch.db import clock as tclock  # noqa: E402
from repro_torch.obs.metrics import render_prometheus as t_render_prometheus  # noqa: E402
from torch_twin import assert_same, pair_class, twin_dir  # noqa: E402

RemixDB = pair_class(RRemixDB)


def _fill(db, lo=1, n=300, step=7):
    keys = np.arange(lo, lo + n, dtype=np.uint64) * step
    vals = np.stack([keys & 0xFFFFFFFF, keys >> 32], 1).astype(np.uint32)
    db.put_batch(keys, vals)
    return keys


# the events of the device views, which the port's twin runs (its
# ``device_path="on"``) where the reference's host path has none
DEVICE_VIEW_EVENTS = ("device_upload", "device_evict")


def _events(db, kind=None):
    """The twin store's events as ``(kind, fields)``, equal between the
    packages: timestamps and wall-time fields left out, and the port's
    device-view events where the reference has none."""
    ref, port = ([(e.kind, e.fields) for e in side.events.list(kind=kind)]
                 for side in (db.ref, db.port))
    if not any(k in DEVICE_VIEW_EVENTS for k, _ in ref):
        port = [(k, f) for k, f in port if k not in DEVICE_VIEW_EVENTS]
    assert_same(ref, port, "events")
    return ref


def _kinds(db):
    return [k for k, _ in _events(db)]


def test_store_stats_keys_unchanged(tmp_path):
    db = RemixDB.open(str(tmp_path / "db"), RemixDBConfig(memtable_entries=1 << 30))
    keys = _fill(db)
    db.flush()
    db.get(int(keys[0]))
    s = db.stats()
    assert set(s) == {
        "partitions", "tables", "entries", "resident_tables", "memtable",
        "wa", "wal_blocks", "disk_bytes_read", "cold", "versions",
        "compaction", "health", "engine", "cache",
    }
    assert set(s["health"]) == {
        "status", "unavailable", "quarantine_files", "partitions", "io",
        "corruption_detected", "scrub", "repair",
    }
    assert s["health"]["status"] == "ok"
    assert s["health"]["partitions"][0]["degraded"] is False
    assert set(s["compaction"]) == {"rounds", "bytes_written", "kinds", "log_rounds", "in_flight"}
    assert s["compaction"]["rounds"] == 1
    assert s["compaction"]["kinds"] == {"minor": 1}
    assert s["compaction"]["bytes_written"] == db.table_bytes_written > 0
    assert set(s["cold"]) == {"gets", "scans"}
    assert set(s["versions"]) == {"current", "live", "pinned"}
    assert set(s["cache"]) >= {
        "hits", "misses", "evictions", "entries", "cached_bytes", "capacity_bytes",
    }
    assert s["wa"] == pytest.approx(
        (db.table_bytes_written + db.wal.bytes_written) / max(1, db.user_bytes))
    eng = s["engine"]
    assert set(eng) == {
        "batches", "completed", "cancelled_batches", "ops",
        "deadline_exceeded", "cancelled_ops", "errors", "io_errors",
        "queue_depth", "workers", "admission", "shards",
    }
    assert eng["io_errors"] == 0
    assert eng["ops"] == {
        "get": 1, "multiget": 0, "scan": 0, "put": 1, "delete": 0,
        "delete_range": 0, "cas": 0,
    }
    assert set(eng["admission"]) == {"max_bytes", "inflight_bytes", "peak_bytes", "admitted", "waits"}
    db.close()


def test_metrics_snapshot_and_disabled_store(tmp_path):
    db = RemixDB.open(str(tmp_path / "on"), RemixDBConfig(memtable_entries=1 << 30))
    _fill(db)
    db.flush()
    snap = db.metrics()
    names = {s["name"] for s in snap["metrics"]}
    assert {"db_user_bytes", "db_table_bytes_written", "wal_bytes_written",
            "cache_hits", "versions_published", "db_flush_seconds"} <= names
    assert "db_flush_seconds_count 1" in render_prometheus(snap)
    assert "db_flush_seconds_count 1" in t_render_prometheus(db.port.metrics())
    db.close()
    off = RemixDB(RemixDBConfig(metrics=False, memtable_entries=1 << 30))
    _fill(off)
    off.flush()
    assert off.metrics() == {"metrics": []}
    assert _events(off) == []
    assert off.stats()["compaction"]["rounds"] == 0
    off.close()


def test_trace_sample_rate():
    db = RemixDB(RemixDBConfig(memtable_entries=1 << 30, trace_sample_rate=0.5))
    _fill(db, n=50)  # the fill batch consumes the sampler's first pick
    futures = [db.submit(Batch().get(7), sync=True) for _ in range(4)]
    traces = [f.result().trace for f in futures]
    assert [t is not None for t in traces] == [False, True, False, True]
    assert traces[1].sampled
    for side in ("ref", "port"):
        last = getattr(db.engine(), side).last_trace
        assert last is getattr(futures[3], side).result().trace
    db.close()


def test_store_event_lifecycle(tmp_path):
    sink = tmp_path / "ev.jsonl"
    db = RemixDB.open(
        str(tmp_path / "db"),
        RemixDBConfig(memtable_entries=1 << 30, event_log_path=str(sink)),
    )
    _fill(db)
    db.flush()
    kinds = _kinds(db)
    for a, b in (
        ("flush", "wal_gc"),
        ("wal_gc", "wal_checkpoint"),
        ("wal_checkpoint", "version_publish"),
        ("version_publish", "compaction"),
    ):
        assert kinds.index(a) < kinds.index(b), kinds
    assert _events(db, "flush")[0][1]["entries"] == 300
    comp = _events(db, "compaction")[0][1]
    assert comp["kinds"] == {"minor": 1}
    assert comp["bytes_written"] > 0
    db.close()
    # each side's JSONL sink holds its log, timestamps aside
    ref, port = ([{k: v for k, v in json.loads(ln).items() if k not in ("seq", "ts")}
                  for ln in open(path).read().splitlines()] for path in twin_dir(sink))
    port = [ln for ln in port if ln["kind"] not in DEVICE_VIEW_EVENTS]
    assert_same(ref, port, "sink")
    assert [ln["kind"] for ln in ref] == kinds
    db2 = RemixDB.open(str(tmp_path / "db"), RemixDBConfig(memtable_entries=1 << 30))
    assert _kinds(db2) == ["recover"]
    db2.close()


def test_executor_failure_event():
    db = RemixDB(RemixDBConfig(memtable_entries=1 << 30))
    _fill(db, n=20)
    eng = db.engine()

    class Boom(Exception):
        pass

    originals = (eng.ref.plan, eng.port.plan)
    eng.plan = lambda batch: (_ for _ in ()).throw(Boom("planner down"))
    try:
        res = db.submit(Batch().get(1), sync=True).result()
        assert not res.ok
        with pytest.raises(Boom):
            res.results[0].raise_if_error()
    finally:
        eng.ref.plan, eng.port.plan = originals
    errs = _events(db, "batch_error")
    assert len(errs) == 1 and "Boom" in errs[0][1]["error"]
    assert eng.registry.counter("engine_batch_failures").value == 1
    db.close()


def test_ckb_memo_bounded(tmp_path):
    """The CKB interval memo (an array-held memo in the port) stays within
    the store's ``cache_bytes // 64`` budget, evicts, and reads back through
    the ``ckb_memo_*`` gauges."""
    cfg = RemixDBConfig(memtable_entries=1 << 30, cache_bytes=16 << 10, promote_fraction=1e9)
    db = RemixDB.open(str(tmp_path / "db"), cfg)
    keys = _fill(db, n=4000, step=3)
    db.flush()
    db.close()
    db = RemixDB.open(str(tmp_path / "db"), cfg)
    rng = np.random.default_rng(3)
    for _ in range(6):
        qs = rng.choice(keys, 64, replace=False).astype(np.uint64)
        f, _ = db.get_batch(qs)
        assert f.all()
    budget = (16 << 10) // 64
    entries = db._ckb_memo("entries")
    assert 0 < entries <= budget + 64  # <= budget rounded up to one row
    assert db._ckb_memo("evictions") > 0
    vals = {s["name"]: s["value"] for s in db.metrics()["metrics"]
            if s["name"].startswith("ckb_memo")}
    assert vals["ckb_memo_entries"] == entries
    assert vals["ckb_memo_evictions"] == db._ckb_memo("evictions")
    assert vals["ckb_memo_bytes"] > 0
    db.close()


def test_write_surface_counters_and_drop_event(tmp_path, monkeypatch):
    t = [1000.0]
    monkeypatch.setattr(rclock, "_source", lambda: t[0])
    monkeypatch.setattr(tclock, "_source", lambda: t[0])
    db = RemixDB.open(
        str(tmp_path / "db"),
        RemixDBConfig(memtable_entries=128, hot_threshold=255,
                      compaction=CompactionConfig(table_cap=128, t_max=2)),
    )

    def counter(name):
        return sum(s["value"] for s in db.registry.snapshot()["metrics"] if s["name"] == name)

    try:
        keys = np.arange(0, 100, dtype=np.uint64)
        db.put_batch(keys, np.stack([keys, keys], 1).astype(np.uint32), ttl=30)
        db.flush()
        db.delete_range(10, 40)
        db.delete_range(50, 60)
        assert counter("delete_range") == 2
        ok, _ = db.cas(5, np.array([9, 9], np.uint32), np.array([1, 1], np.uint32))
        assert not ok
        ok, _ = db.cas(5, np.array([5, 5], np.uint32), np.array([1, 1], np.uint32))
        assert ok
        assert counter("cas_conflict") == 1
        db.delete_range(0, 1000)
        db.flush()
        drops = _events(db, "range_tombstone_drop")
        assert drops and drops[0][1]["tables"] >= 1
        assert counter("range_tombstone_drop") >= 1
        t[0] = 1031.0
        for i in range(6):
            db.put_batch(keys, np.full((100, 2), i + 1, np.uint32), ttl=1)
            t[0] += 5.0
            db.flush()
        assert counter("ttl_expired_dropped") > 0
    finally:
        db.close()


def test_scrub_counters_and_events(tmp_path):
    db = RemixDB.open(str(tmp_path / "db"), RemixDBConfig(memtable_entries=1 << 30))
    _fill(db)
    db.flush()
    rep = db.scrub(full=True)
    assert rep["clean"] and rep["bytes_read"] > 0

    def c(n):
        return db.registry.counter(n).value

    assert c("scrub_passes") == 1
    assert c("scrub_bytes_read") == rep["bytes_read"]
    assert c("corruption_detected") == 0
    db.close()

    for root in twin_dir(tmp_path / "db"):
        rx = sorted(glob.glob(f"{root}/remix/*.rmx"))
        flip_bytes(rx[0], 64, 4)
    db = RemixDB.open(str(tmp_path / "db"), RemixDBConfig(memtable_entries=1 << 30))
    rep = db.scrub(full=True)
    assert not rep["clean"] and rep["repaired"]
    assert c("corruption_detected") >= 1
    assert c("repair_remix_rebuilt") == 1
    assert c("repair_table_quarantined") == 0
    kinds = _kinds(db)
    assert kinds.index("corruption") < kinds.index("repair") < kinds.index("scrub")
    assert _events(db, "corruption")[-1][1]["target"] == "remix"
    names = {s["name"] for s in db.metrics()["metrics"]}
    assert {"scrub_passes", "scrub_bytes_read", "corruption_detected",
            "repair_remix_rebuilt", "repair_table_quarantined",
            "quarantine_purged", "io_retry", "io_giveup"} <= names
    assert db.scrub(full=True)["clean"]
    db.close()
