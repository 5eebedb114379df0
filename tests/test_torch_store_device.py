"""The device-view and model-store cases, held between the JAX package
and the port on twin stores (``tests/torch_twin.py``).

``test_model_store``'s seeded walks (put, TTL, delete, delete_range, CAS,
clock advances, flushes, pinned snapshots, a reopen) compare every answer
of the two stores. ``test_device_view``'s cases run the port's device
views (``device_path="on"``, the kernels' plain versions on the CPU) in
every residency tier against the reference's host and cold paths, with
the port's manager state checked on the port side.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db import clock as rclock  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro_torch.db import clock as tclock  # noqa: E402
from repro_torch.db import store as TS  # noqa: E402
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


def _metric(db, name):
    return sum(s["value"] for s in db.registry.snapshot()["metrics"]
               if s["name"] == name)


# ---------------------------------------------------- test_model_store
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_differential_random_walk(tmp_path, seed):
    """``test_model_store``'s walk: put/TTL/delete/delete_range/CAS,
    clock advances, flushes and pinned snapshots, then a reopen; every
    step compares the twin's answers."""
    rng = random.Random(seed)
    t = T0
    set_clock(lambda: T0)
    d = str(tmp_path / f"walk{seed}")
    cfg = RemixDBConfig(vw=2, memtable_entries=128, hot_threshold=255,
                        compaction=CompactionConfig(table_cap=128, t_max=3))
    db = RemixDB.open(d, cfg)
    snaps = []
    for i in range(120):
        r = rng.random()
        if r < 0.30:
            db.put(rng.randrange(600), np.array([rng.randrange(1, 1 << 31)] * 2,
                                                np.uint32),
                   ttl=rng.choice([None, None, 5, 50]))
        elif r < 0.40:
            db.delete(rng.randrange(600))
        elif r < 0.52:
            lo = rng.randrange(600)
            db.delete_range(lo, min(600, lo + rng.randrange(1, 200)))
        elif r < 0.64:
            k = rng.randrange(600)
            cur = db.get(k)
            expect = cur if rng.random() < 0.5 else None
            db.cas(k, expect, None if rng.random() < 0.2
                   else np.array([rng.randrange(1, 1 << 31)] * 2, np.uint32))
        elif r < 0.74:
            t += rng.randrange(1, 40)
            set_clock(lambda t=t: float(t))
        elif r < 0.86:
            db.flush()
        else:
            snaps.append(db.snapshot())
        if i % 7 == 0:
            db.scan(0, 610)
            with db.cursor(width=7) as cur:
                cur.seek(0)
                list(cur)
            db.get_batch(np.arange(0, 600, 3, dtype=np.uint64))
    for s in snaps:
        s.scan(0, 610)
        s.close()
    db.close()
    db = RemixDB.open(d, cfg)
    db.scan(0, 610)
    db.get_batch(np.arange(0, 600, dtype=np.uint64))
    db.close()


# ---------------------------------------------------- test_device_view
def _populate(root, seed, n=500):
    """``test_device_view``'s mixed workload, written by the twin store
    (so both directories hold the same bytes); returns the key domain."""
    set_clock(lambda: T0)
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 20, size=n, replace=False).astype(np.uint64)
    cfg = RemixDBConfig(vw=2, hot_threshold=255, memtable_entries=128,
                        compaction=CompactionConfig(table_cap=128, t_max=3),
                        device_path="off")
    db = RemixDB.open(root, cfg)
    for i, k in enumerate(keys.tolist()):
        db.put(k, [i & 0xFFFF, i ^ 7])
    for k in keys[: n // 10].tolist():
        db.delete(k)
    db.put_batch(keys[n // 10: n // 5], np.full((n // 10, 2), 9, np.uint32), ttl=50)
    lo = int(keys[n // 4])
    db.delete_range(lo, lo + 4096)
    db.flush()
    db.close()
    return np.sort(keys)


def _dv_cfg(**kw):
    return RemixDBConfig(vw=2, hot_threshold=255, memtable_entries=128,
                         compaction=CompactionConfig(table_cap=128, t_max=3),
                         **kw)


def _agree(db, domain, rng):
    probe = np.concatenate([domain, rng.choice(domain, 64, replace=False) + 1,
                            [0, 1 << 21]]).astype(np.uint64)
    f, _ = db.get_batch(probe)
    starts = np.sort(rng.choice(domain, 24, replace=False))
    for n in (1, 7, 33):
        for s in starts[:8]:
            db.scan(int(s), n)
        db.scan_batch(starts, n)
    for k in probe[:24].tolist():
        db.get(k)
    return int(f.sum())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_parity_differential(tmp_path, seed):
    """The port's device views (``device_path="on"``) against the
    reference's host path, promoted and cold, across a TTL expiry that
    the views evaluate at query time."""
    root = str(tmp_path / "db")
    domain = _populate(root, seed)
    rng = np.random.default_rng(seed + 100)
    dev = pair_class(RRemixDB, dict(device="cpu", device_path="on")).open(
        root, _dv_cfg(device_path="off", cold_reads=False))
    cold = RemixDB.open(root, _dv_cfg(device_path="off", promote_fraction=1e9))
    found_now = _agree(dev, domain, rng)
    _agree(cold, domain, rng)
    assert len(dev.port.device_views) > 0
    ups = _metric(dev.port, "device_batches")
    set_clock(lambda: T0 + 60.0)
    assert _agree(dev, domain, rng) < found_now
    assert _metric(dev.port, "device_batches") > ups
    assert not dev.port.events.list("device_evict")  # no re-upload at expiry
    dev.close(), cold.close()


@pytest.mark.parametrize("budget", ["index", "none", "one_view"])
def test_device_budget_tiers(tmp_path, budget):
    """Index tier (values gathered through the block cache), no tier at
    all (``device_fallback_total``, legacy path), and LRU under a budget
    of one full view: answers equal the reference's host path."""
    root = str(tmp_path / "db")
    seed, n = {"index": (7, 500), "none": (11, 500), "one_view": (17, 800)}[budget]
    domain = _populate(root, seed=seed, n=n)
    probe = TS.RemixDB.open(twin_dir(root)[1], TS.RemixDBConfig(
        device="cpu", device_path="off"))
    full = min(p.device_view_bytes(True) for p in probe.partitions)
    idx = max(p.device_view_bytes(False) for p in probe.partitions)
    per = max(p.device_view_bytes(True) for p in probe.partitions)
    probe.close()
    cap = {"index": full - 1, "none": 16, "one_view": per}[budget]
    dev = pair_class(RRemixDB, dict(device="cpu", device_path="on",
                                    device_budget_bytes=cap, device_slice=4)
                     ).open(root, _dv_cfg(device_path="off", cold_reads=False))
    _agree(dev, domain, np.random.default_rng(8))
    mgr = dev.port.device_views
    if budget == "index":
        assert idx < full
        assert {v.tier for v in mgr._views.values()} == {"index"}
    elif budget == "none":
        assert len(mgr) == 0 and _metric(dev.port, "device_fallback_total") > 0
        assert _metric(dev.port, "device_batches") == 0
    else:
        assert mgr.resident_bytes <= cap
    dev.close()


def test_upload_metrics_and_version_release(tmp_path):
    root = str(tmp_path / "db")
    domain = _populate(root, seed=13)
    dev = pair_class(RRemixDB, dict(device="cpu", device_path="on")).open(
        root, _dv_cfg(device_path="off", cold_reads=False))
    dev.get_batch(np.random.default_rng(14).choice(domain, 64, replace=False))
    port = dev.port
    assert _metric(port, "device_rows_gathered") > 0
    assert _metric(port, "hbm_resident_bytes") == port.device_views.resident_bytes > 0
    assert all(e.fields["bytes"] > 0 for e in port.events.list("device_upload"))
    set_clock(lambda: T0 + 1.0)
    for k in domain[::3].tolist():
        dev.put(k, [1, 2])
    dev.flush()
    assert any(e.fields["reason"] == "version_release"
               for e in port.events.list("device_evict"))
    dev.close()
