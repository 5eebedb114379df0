"""The point-read path traced from inside: the spans under ``shardN:read``
of a traced 256-get batch (one device round trip for all of a store's
partitions), on a multi-partition store and on a 2-shard
``KVServeEngine``, with the device views' plain path on the CPU
(``device_path="on"``, ``device="cpu"``); each span's CPU time; the
``gc`` leaf of a collection inside an active trace.
"""
import gc

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.db.compaction import CompactionConfig  # noqa: E402
from repro_torch.db.ops import Batch, Op  # noqa: E402
from repro_torch.db.sharded import route_host  # noqa: E402
from repro_torch.db.store import RemixDB, RemixDBConfig  # noqa: E402
from repro_torch.kernels import device_view  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.serve.engine import KVServeEngine  # noqa: E402

N_KEYS = 4096  # 8 partitions at a 512-entry memtable and 256-entry tables
SLACK = 1e-4  # the CPU clock is read just after the wall clock, at both ends


def _cfg(**kw):
    return RemixDBConfig(device="cpu", device_path="on", vw=2, memtable_entries=512,
                         compaction=CompactionConfig(table_cap=256), **kw)


def _data(seed=0, n=N_KEYS):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, n, replace=False).astype(np.uint64)
    vals = np.stack([keys & 0xFFFFFFFF, keys >> np.uint64(32)], 1).astype(np.uint32)
    return rng, keys, vals


def _gets(keys):
    return Batch([Op.get(int(k)) for k in keys], trace=True)


def _untraced(keys):
    return Batch([Op.get(int(k)) for k in keys])


def _answers(res):
    return [(r.found, None if r.value is None else r.value.tolist()) for r in res.results]


def _touched(store, keys):
    """Partitions of ``store`` that ``keys`` route to."""
    parts = store.partitions
    return parts, sorted(set(route_host([p.lo for p in parts], keys).tolist()))


def _check_read(read, n_parts):
    """``shardN:read``'s children in order: the keys, the overlay, one
    resolve a partition touched, then one dispatch (its ``parts`` the
    partitions touched) and one sync for all of them, the results."""
    kids = [c for c in read.children if c.name != "gc"]
    names = [c.name for c in kids]
    assert names == (["exec.keys", "store.overlay"] + ["view.resolve"] * n_parts
                     + ["view.dispatch", "view.sync", "exec.results"]), names
    assert kids[-3].args["parts"] == n_parts


def _check_clocks(tr):
    assert tr.well_formed()
    assert tr.leaf_coverage() >= 0.9, tr.leaf_coverage()
    for s in tr.spans():
        assert 0.0 <= s.cpu <= s.duration + SLACK, (s.name, s.cpu, s.duration)
    assert tr.root.args["thread"]
    doc = tr.to_chrome()
    assert doc["traceEvents"][0]["ts"] == 0
    assert all(ev["args"]["cpu_us"] >= 0 for ev in doc["traceEvents"])


def _uploads(tr):
    return [u for r in tr.find("view.resolve") for u in r.children if u.name == "view.upload"]


def test_store_read_spans():
    rng, keys, vals = _data()
    db = RemixDB(_cfg())
    try:
        db.put_batch(keys, vals)
        db.flush()
        q = rng.choice(keys, 256)
        parts, touched = _touched(db, q)
        assert len(touched) >= 2

        s0 = device_view.SYNCS
        first = db.submit(_gets(q)).result()
        s1 = device_view.SYNCS
        plain = db.submit(_untraced(q)).result()
        s2 = device_view.SYNCS
        again = db.submit(_gets(q)).result()
        s3 = device_view.SYNCS
        assert plain.trace is None
        assert _answers(first) == _answers(plain) == _answers(again)
        assert s1 - s0 == s2 - s1 == s3 - s2 == 1  # one round trip a store batch
        for k, r in zip(q.tolist(), first.results):
            assert r.found and r.value.tolist() == [k & 0xFFFFFFFF, k >> 32]

        for tr in (first.trace, again.trace):
            (read,) = tr.find("shard0:read")
            _check_read(read, len(touched))
            _check_clocks(tr)
        # an upload the first time each partition is touched, none after
        ups = _uploads(first.trace)
        assert len(ups) == len(touched) and not _uploads(again.trace)
        views = [db.device_views.view_for(parts[i]) for i in touched]
        assert [u.args["bytes"] for u in ups] == [v.nbytes for v in views]
        assert all(u.args["tier"] == "full" for u in ups)
    finally:
        db.close()


def test_two_shard_engine_read_spans(tmp_path):
    rng, keys, vals = _data(1, 2 * N_KEYS)  # N_KEYS a shard
    split = int(np.sort(keys)[N_KEYS])
    eng = KVServeEngine([(0, tmp_path / "s0"), (split, tmp_path / "s1")], config=_cfg())
    try:
        eng.put_batch(keys, vals)
        eng.flush()
        q = rng.choice(keys, 256)
        lows = np.array(eng.lows, np.uint64)
        shard_of = np.searchsorted(lows, q, side="right") - 1
        s0 = device_view.SYNCS
        res = eng.submit(_gets(q)).result()
        s1 = device_view.SYNCS
        plain = eng.submit(_untraced(q)).result()
        assert _answers(res) == _answers(plain)
        assert device_view.SYNCS - s1 == s1 - s0
        tr = res.trace
        _check_clocks(tr)
        total = 0
        for si, store in enumerate(eng.shards):
            _, touched = _touched(store, q[shard_of == si])
            assert len(touched) >= 2
            (read,) = tr.find(f"shard{si}:read")
            _check_read(read, len(touched))
            total += len(touched)
        assert s1 - s0 == len(eng.shards)  # one round trip a shard's batch
        assert len(_uploads(tr)) == total
    finally:
        eng.close()
        for db in eng.shards:
            db.close()


def test_gc_leaf_only_inside_an_active_trace():
    tr = tracing.Trace()
    with tracing.activate(tr):
        gc.collect()  # the root is the innermost span: a leaf of the root
        with tr.span("work"):
            gc.collect()
    tr.finish()
    (work,) = tr.find("work")
    gcs = tr.find("gc")
    top = [g for g in gcs if g in tr.root.children]
    assert top and all(g.t1 <= work.t0 for g in top)
    assert [g for g in gcs if g not in top] and all(g in work.children for g in gcs if g not in top)
    assert [c.name for c in tr.root.children if c.name != "gc"] == ["work"]
    assert all(any(g.args["generation"] == 2 for g in part) for part in (top, work.children))
    assert all(g.args["collected"] >= 0 and 0 <= g.cpu <= g.duration + SLACK for g in gcs)
    assert tr.well_formed()

    idle = tracing.Trace()  # recorded into, never activated
    with idle.span("work"):
        gc.collect()
    idle.finish()
    assert not idle.find("gc")
