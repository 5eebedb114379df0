"""The port's ``RemixDB`` against the JAX package's, on one seeded op stream.

The same stream — put, put_batch, delete, delete_range, CAS, TTL'd puts
under one logical clock, flushes that reach minor, major and split
compactions — goes into the reference's ``RemixDB`` (its legacy host path
on the CPU) and the port's ``RemixDB(device="cpu")`` through a twin
(``tests/torch_twin.py``), with the port over ``device_path`` "on" / "off"
and ``use_kernels``. Every read API (get, get_batch, scan, scan_batch,
cursor, snapshot reads, submit sync and async) must answer the same, bit
for bit, and so must the compaction kinds, the write amplification and
``stats()``'s counters. After the stream the table, REMIX, manifest and
WAL files of the two data directories are byte-identical, and each
package opens the other's directory, unflushed WAL tail included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db import clock as rclock  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.ops import Batch, Op  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro_torch.db import clock as tclock  # noqa: E402
from repro_torch.db.store import RemixDB as TRemixDB  # noqa: E402
from repro_torch.db.store import RemixDBConfig as TConfig  # noqa: E402
from torch_twin import Twin, pair_class, same_dir_bytes, twin_dir  # noqa: E402

T0 = 1_700_000_000.0
DOMAIN = 6000
MODES = {
    "on": dict(device_path="on"),
    "on-kernels": dict(device_path="on", use_kernels=True),
    "off": dict(device_path="off"),
    "off-kernels": dict(device_path="off", use_kernels=True),
}


@pytest.fixture
def logical_clock():
    t = [T0]
    rclock.set_source(lambda: t[0])
    tclock.set_source(lambda: t[0])
    yield t
    rclock.reset()
    tclock.reset()


def _cfg(**kw):
    return RemixDBConfig(
        vw=2, memtable_entries=kw.pop("memtable_entries", 384),
        hot_threshold=255,
        compaction=CompactionConfig(table_cap=128, t_max=3, split_m=2), **kw)


def _vals(rng, n):
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _reads(db, rng, batch_sizes=(1, 40)):
    """Every read API once; the twin compares each answer."""
    for q in batch_sizes:
        probe = rng.integers(0, DOMAIN, q).astype(np.uint64)
        db.get_batch(probe)
    db.get(int(rng.integers(0, DOMAIN)))
    starts = np.sort(rng.integers(0, DOMAIN, 12)).astype(np.uint64)
    db.scan_batch(starts, 9)
    db.scan(int(starts[0]), 50)
    with db.cursor(int(starts[1]), width=8) as cur:
        cur.next_batch(30)
        cur.skip(5)
        cur.peek()
    res = db.submit(Batch([Op.get(int(starts[2])), Op.multiget(starts),
                           Op.scan(int(starts[3]), 20)]), sync=True).result()
    assert res.ok
    fut = db.submit(Batch([Op.multiget(starts[::-1]), Op.scan(0, 15)]))
    assert fut.result(timeout=30).ok


def _stream(db, clock_t, seed, steps=36):
    """The seeded op stream; reads after every few writes."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        r = rng.random()
        if r < 0.35:
            n = int(rng.integers(50, 200))
            keys = rng.choice(DOMAIN, n, replace=False).astype(np.uint64)
            ttl = None if rng.random() < 0.7 else rng.choice([5, 60], n)
            db.put_batch(keys, _vals(rng, n), ttl=ttl)
        elif r < 0.50:
            k = int(rng.integers(0, DOMAIN))
            db.put(k, _vals(rng, 1)[0], ttl=None if rng.random() < 0.5 else 30)
            db.delete(int(rng.integers(0, DOMAIN)))
        elif r < 0.60:
            lo = int(rng.integers(0, DOMAIN))
            db.delete_range(lo, lo + int(rng.integers(1, 300)))
        elif r < 0.72:
            k = int(rng.integers(0, DOMAIN))
            db.cas(k, db.get(k), _vals(rng, 1)[0])
            db.cas(k, None, _vals(rng, 1)[0])
        elif r < 0.82:
            clock_t[0] += float(rng.integers(1, 40))
        else:
            db.flush()
        if step % 4 == 3:
            _reads(db, rng)
    db.flush()
    _reads(db, rng, batch_sizes=(1, 7, 300))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_op_stream_twin(tmp_path, logical_clock, mode):
    root = str(tmp_path / "db")
    db = pair_class(RRemixDB, dict(device="cpu", **MODES[mode])).open(
        root, _cfg())
    _stream(db, logical_clock, seed=0)
    kinds = db.stats()["compaction"]["kinds"]
    assert {"minor", "split"} <= set(kinds), kinds
    assert db.write_amplification() > 1.0
    assert len(db.partitions) > 1
    with db.snapshot() as snap:
        db.put_batch(np.arange(0, 40, dtype=np.uint64), np.ones((40, 2), np.uint32))
        snap.scan(0, 100)
        snap.get_batch(np.arange(0, 40, dtype=np.uint64))
    db.close()
    same_dir_bytes(*twin_dir(root))


def test_op_stream_reaches_major(tmp_path, logical_clock):
    """Overwrite-heavy batches drive a major compaction; the files stay
    byte-identical."""
    root = str(tmp_path / "db")
    db = pair_class(RRemixDB).open(root, _cfg(memtable_entries=256))
    rng = np.random.default_rng(3)
    hot = np.arange(0, 4000, 3, dtype=np.uint64)
    for _ in range(8):
        keys = rng.choice(hot, 256, replace=False)
        db.put_batch(keys, _vals(rng, 256))
    _reads(db, rng)
    assert "major" in db.stats()["compaction"]["kinds"]
    db.close()
    same_dir_bytes(*twin_dir(root))


@pytest.mark.parametrize("unflushed", [0, 150])
def test_each_package_opens_the_others_directory(tmp_path, logical_clock,
                                                 unflushed):
    """A directory written by one package opens in the other — recovered
    from the manifest, WAL tail replayed into the memtable — and answers
    like its own reopened store, cold first and promoted after."""
    root = str(tmp_path / "db")
    db = pair_class(RRemixDB).open(root, _cfg())
    rng = np.random.default_rng(11)
    for _ in range(5):
        keys = rng.choice(DOMAIN, 300, replace=False).astype(np.uint64)
        db.put_batch(keys, _vals(rng, 300))
    db.delete_range(100, 400)
    db.flush()
    if unflushed:
        keys = rng.choice(DOMAIN, unflushed, replace=False).astype(np.uint64)
        db.put_batch(keys, _vals(rng, unflushed), ttl=100)
        db.delete(int(keys[0]))
    db.close()
    ref_dir, port_dir = twin_dir(root)
    same_dir_bytes(ref_dir, port_dir)
    cfg = dict(promote_fraction=0.05)
    swapped = Twin(RRemixDB.open(port_dir, RemixDBConfig(**cfg)),
                   TRemixDB.open(ref_dir, TConfig(device="cpu",
                                                  device_path="on", **cfg)))
    own = TRemixDB.open(port_dir, TConfig(device="cpu", device_path="on", **cfg))
    assert len(swapped.mem) == unflushed
    assert swapped.port.stats()["cold"]["gets"] == 0
    for _ in range(6):
        probe = rng.integers(0, DOMAIN, 200).astype(np.uint64)
        f, v = swapped.get_batch(probe)
        fo, vo = own.get_batch(probe)
        np.testing.assert_array_equal(f, fo)
        np.testing.assert_array_equal(v[f], vo[fo])
        starts = np.sort(rng.integers(0, DOMAIN, 16)).astype(np.uint64)
        swapped.scan_batch(starts, 12)
    assert swapped.port.stats()["cold"]["gets"] > 0
    assert swapped.port.events.list("promotion")
    assert swapped.port.registry.counter("device_batches").value > 0
    swapped.close()
    own.close()


def test_async_submits_share_the_device_views(tmp_path):
    """Many submit workers asking for the same partitions' views at once
    upload each view once and count its bytes once (the manager's lock;
    the reference has none), and answer like the synchronous path."""
    import sys

    from repro_torch.db.compaction import CompactionConfig as TCompaction
    from repro_torch.db.ops import Batch as TBatch
    from repro_torch.db.ops import Op as TOp

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for trial in range(4):
            db = TRemixDB(TConfig(
                vw=2, memtable_entries=2048, data_dir=str(tmp_path / f"t{trial}"),
                device="cpu", device_path="on", submit_workers=8,
                compaction=TCompaction(table_cap=512, t_max=3)))
            rng = np.random.default_rng(trial)
            keys = rng.choice(1 << 20, 8000, replace=False).astype(np.uint64)
            db.put_batch(keys, np.stack([keys, keys], 1).astype(np.uint32))
            db.flush()
            probes = [rng.choice(keys, 64) for _ in range(24)]
            futs = [db.submit(TBatch([TOp.multiget(q)])) for q in probes]
            for q, f in zip(probes, futs):
                r = f.result(timeout=60).results[0]
                assert r.found.all()
                np.testing.assert_array_equal(r.vals[:, 0], q.astype(np.uint32))
            mgr = db.device_views
            assert len(mgr) == len(db.partitions) > 1
            assert mgr.resident_bytes == sum(v.nbytes for v in mgr._views.values())
            assert len(db.events.list("device_upload")) == len(db.partitions)
            db.close()
    finally:
        sys.setswitchinterval(old)
