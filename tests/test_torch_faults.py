"""The fault-plan cases of the reference's tier-1 tests
(``tests/test_faults.py`` and ``tests/test_recovery_faults.py``), held
between the JAX package and the port.

Each case runs on twin stores (``tests/torch_twin.py``): every call goes
to the reference's ``RemixDB`` and to the port's ``RemixDB(device="cpu")``
over its own directory (the reference's with ``.port`` appended), the
answers — data, typed errors, scrub reports, health — must be equal, and
the case's own assertions then hold for both. A ``FaultPlan`` is carried
to the port as a fresh plan with the same rules and seed, so both stores
see the same faults; at-rest damage (a flipped byte, a forged CURRENT, a
torn WAL image, a crash image) is made the same way in both directories,
and a bombed manifest commit is armed in both packages. The background
scrubber runs on the port alone: its passes follow the wall clock.
"""
import glob
import os
import random
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.ops import Batch, Op, OpStatus  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro.io import manifest as r_manifest  # noqa: E402
from repro.io.faults import (CorruptionError, FaultPlan, TransientIOError,  # noqa: E402
                             UnavailableSpanError, flip_bytes)
from repro_torch.io import manifest as t_manifest  # noqa: E402
from torch_twin import PORT_CPU, pair_class, to_port, twin_dir  # noqa: E402

RemixDB = pair_class(RRemixDB)

pytestmark = pytest.mark.faults


def _cfg(plan=None, **kw):
    return RemixDBConfig(
        vw=2,
        memtable_entries=kw.pop("memtable_entries", 64),
        compaction=CompactionConfig(table_cap=256, t_max=4),
        hot_threshold=255,
        fault_plan=plan,
        **kw,
    )


def _fill(db, lo, hi, tag=1):
    ks = np.arange(lo, hi, dtype=np.uint64)
    vs = np.stack([ks.astype(np.uint32), np.full(len(ks), tag, np.uint32)], 1)
    db.put_batch(ks, vs)
    return {int(k): (int(v[0]), int(v[1])) for k, v in zip(ks, vs)}


def _seed_store(d, n=500, flush=True):
    db = RemixDB.open(d, _cfg())
    model = _fill(db, 0, n)
    if flush:
        db.flush()
    db.close()
    return model


def _files(d, sub, pat):
    return sorted(glob.glob(os.path.join(d, sub, pat)))


def _both(d, path):
    """``path`` under the twin directory ``d``, in both packages' copies."""
    rel = os.path.relpath(path, d)
    return [os.path.join(x, rel) for x in twin_dir(d)]


def _flip(d, path, offset, nbytes):
    for p in _both(d, path):
        flip_bytes(p, offset, nbytes)


def _check_never_wrong(db, model, hi=1 << 20):
    """Every observable outcome is correct data, a typed error, or a typed
    degraded span — never wrong bytes (and the same in both packages)."""
    try:
        kk, vv = db.scan(0, hi)
    except (CorruptionError, UnavailableSpanError):
        pass
    else:
        got = {int(k): (int(v[0]), int(v[1])) for k, v in zip(kk, vv)}
        for k, v in got.items():
            assert model.get(k) == v, f"silent wrong read at {k}"
    for k in list(model)[:: max(1, len(model) // 16)]:
        try:
            v = db.get(k)
        except (CorruptionError, UnavailableSpanError):
            continue
        if v is not None:
            assert (int(v[0]), int(v[1])) == model[k]


def _vals_offset(db):
    rd = db.partitions[0].tables[0]._rd()
    lo, _ = rd._section_range("vals")
    return lo


# ------------------------------------------------ transient EIO × target
@pytest.mark.parametrize("target", [".sst", ".rmx", "MANIFEST", "wal.log"])
def test_transient_read_absorbed_by_retry(tmp_path, target):
    d = str(tmp_path / "db")
    model = _seed_store(d)
    plan = FaultPlan(seed=7).transient_read(target, count=1)
    db = RemixDB.open(d, _cfg(plan=plan, io_retries=2))
    try:
        kk, vv = db.scan(0, 1 << 20)
        got = {int(k): (int(v[0]), int(v[1])) for k, v in zip(kk, vv)}
        assert got == model
        assert plan.stats()["transient_read"] >= 1
        assert to_port(plan).stats() == plan.stats()
        assert db.registry.counter("io_retry").value >= 1
        assert db.registry.counter("io_giveup").value == 0
        assert db.health()["io"]["retries"] >= 1
    finally:
        db.close()


def test_transient_read_giveup_is_typed(tmp_path):
    d = str(tmp_path / "db")
    _seed_store(d)
    plan = FaultPlan(seed=7).transient_read(".sst", count=50)
    db = RemixDB.open(d, _cfg(plan=plan, io_retries=2))
    try:
        with pytest.raises(TransientIOError):
            db.scan(0, 1 << 20)
        assert db.registry.counter("io_giveup").value >= 1
    finally:
        db.close()


# --------------------------------------------------- bit-flip × target
def test_bitflip_sstable_detected_and_quarantined(tmp_path):
    d = str(tmp_path / "db")
    model = _seed_store(d)
    sst = _files(d, "tables", "*.sst")
    assert len(sst) >= 2
    db = RemixDB.open(d, _cfg())
    try:
        lo = _vals_offset(db)
        db.close()
        _flip(d, sst[0], lo + 8, 4)

        db = RemixDB.open(d, _cfg())
        _check_never_wrong(db, model)
        rep = db.scrub(full=True)
        assert not rep["clean"]
        assert [f["kind"] for f in rep["findings"]] == ["table"]
        assert rep["findings"][0]["blocks"]
        assert rep["quarantined"] == [os.path.basename(sst[0])]
        h = db.health()
        assert h["status"] == "degraded"
        span = h["unavailable"][0]
        assert span["tables"] == [os.path.basename(sst[0])]
        with pytest.raises(UnavailableSpanError):
            db.get(int(span["lo"]))
        if span["hi"] is not None and span["hi"] + 1 in model:
            ok = db.get(span["hi"] + 1)
            assert (int(ok[0]), int(ok[1])) == model[span["hi"] + 1]
        with pytest.raises(UnavailableSpanError):
            db.scan(0, 10)
        _check_never_wrong(db, model)
        db.close()

        # degradation is manifest state: it survives a clean reopen
        db = RemixDB.open(d, _cfg())
        assert db.health()["status"] == "degraded"
        with pytest.raises(UnavailableSpanError):
            db.get(int(span["lo"]))
        _check_never_wrong(db, model)
    finally:
        db.close()


def test_bitflip_remix_auto_repaired(tmp_path):
    d = str(tmp_path / "db")
    db = RemixDB.open(d, _cfg())
    _fill(db, 0, 500)
    db.flush()
    kk0, vv0 = db.scan(0, 1 << 20)
    db.close()
    rx = _files(d, "remix", "*.rmx")
    assert rx
    _flip(d, rx[0], 100, 4)

    db = RemixDB.open(d, _cfg())
    try:
        rep = db.scrub(full=True)
        assert not rep["clean"]
        assert [f["kind"] for f in rep["findings"]] == ["remix"]
        assert len(rep["repaired"]) == 1
        assert db.registry.counter("repair_remix_rebuilt").value == 1
        assert db.scrub(full=True)["clean"]
        kk, vv = db.scan(0, 1 << 20)
        assert np.array_equal(kk, kk0) and np.array_equal(vv, vv0)
        assert db.health()["status"] == "ok"
    finally:
        db.close()
    db = RemixDB.open(d, _cfg())
    try:
        assert db.scrub(full=True)["clean"]
        kk, vv = db.scan(0, 1 << 20)
        assert np.array_equal(kk, kk0) and np.array_equal(vv, vv0)
    finally:
        db.close()


def test_bitflip_manifest_detected(tmp_path):
    d = str(tmp_path / "db")
    _seed_store(d)
    mf = _files(d, ".", "MANIFEST-*")
    _flip(d, mf[0], 10, 4)
    with pytest.raises(CorruptionError) as ei:
        RemixDB.open(d, _cfg())
    assert ei.value.section == "manifest"


def test_bitflip_current_mismatch_scrubbed(tmp_path):
    d = str(tmp_path / "db")
    _seed_store(d)
    db = RemixDB.open(d, _cfg())
    dirs = twin_dir(d)
    try:
        state = db.storage.manifest.load()
        ver = state["version"]
        for x in dirs:  # forge a stale CURRENT pointing at a renamed body
            shutil.copy(os.path.join(x, f"MANIFEST-{ver:06d}"),
                        os.path.join(x, f"MANIFEST-{ver + 7:06d}"))
            with open(os.path.join(x, "CURRENT"), "w") as f:
                f.write(f"MANIFEST-{ver + 7:06d}\n")
        rep = db.scrub(full=True, repair=False)
        assert [f["kind"] for f in rep["findings"]] == ["manifest"]
    finally:
        for x in dirs:  # restore so close() can commit
            with open(os.path.join(x, "CURRENT"), "w") as f:
                f.write(f"MANIFEST-{ver:06d}\n")
            os.remove(os.path.join(x, f"MANIFEST-{ver + 7:06d}"))
        db.close()


def test_bitflip_wal_detected(tmp_path):
    d = str(tmp_path / "db")
    db = RemixDB.open(d, _cfg(memtable_entries=1 << 30))
    _fill(db, 0, 300)
    db.close()
    _flip(d, os.path.join(d, "wal.log"), 100, 4)
    with pytest.raises(CorruptionError) as ei:
        RemixDB.open(d, _cfg(memtable_entries=1 << 30))
    assert ei.value.section == "wal"


# --------------------------------------------------- torn write × target
def test_torn_write_sstable_detected(tmp_path):
    d = str(tmp_path / "db")
    plan = FaultPlan(seed=3).torn_write(".sst", keep=0.5, count=1)
    db = RemixDB.open(d, _cfg(plan=plan))
    model = _fill(db, 0, 500)
    db.flush()
    kk, vv = db.scan(0, 1 << 20)
    assert len(kk) == len(model)
    db.close()
    assert plan.stats()["torn_write"] == 1
    assert to_port(plan).stats() == plan.stats()
    try:
        db2 = RemixDB.open(d, _cfg())
    except CorruptionError:
        return  # detected at open, in both packages
    try:
        _check_never_wrong(db2, model)
        rep = db2.scrub(full=True, repair=False)
        assert not rep["clean"]
        assert any(f["kind"] == "table" for f in rep["findings"])
    finally:
        db2.close()


def test_torn_write_manifest_detected(tmp_path):
    d = str(tmp_path / "db")
    plan = FaultPlan(seed=3).torn_write("MANIFEST", keep=0.4, count=1)
    db = RemixDB.open(d, _cfg(plan=plan, memtable_entries=1 << 30))
    _fill(db, 0, 500)
    db.close()
    assert plan.stats()["torn_write"] == 1
    assert to_port(plan).stats() == plan.stats()
    with pytest.raises(CorruptionError) as ei:
        RemixDB.open(d, _cfg())
    assert ei.value.section == "manifest"


def test_torn_write_wal_never_wrong(tmp_path):
    d = str(tmp_path / "db")
    plan = FaultPlan(seed=3).torn_write("wal.log", keep=0.5, count=1)
    db = RemixDB.open(d, _cfg(plan=plan, memtable_entries=1 << 30))
    model = _fill(db, 0, 200)
    db.close()
    assert plan.stats()["torn_write"] >= 1
    assert to_port(plan).stats() == plan.stats()
    try:
        db2 = RemixDB.open(d, _cfg(memtable_entries=1 << 30))
    except CorruptionError:
        return
    try:
        kk, vv = db2.scan(0, 1 << 20)
        for k, v in zip(kk, vv):
            assert model[int(k)] == (int(v[0]), int(v[1]))
    finally:
        db2.close()


def test_failed_fsync_surfaces(tmp_path):
    d = str(tmp_path / "db")
    plan = FaultPlan(seed=3).fail_fsync(".sst", count=1)
    db = RemixDB.open(d, _cfg(plan=plan, memtable_entries=1 << 30))
    _fill(db, 0, 500)
    with pytest.raises(OSError):
        db.flush()


# ------------------------------------------------------- containment
def test_containment_mixed_batch(tmp_path):
    d = str(tmp_path / "db")
    model = _seed_store(d)
    sst = _files(d, "tables", "*.sst")
    db = RemixDB.open(d, _cfg())
    try:
        lo = _vals_offset(db)
        db.close()
        _flip(d, sst[0], lo + 8, 4)

        db = RemixDB.open(d, _cfg())
        rep = db.scrub(full=True)
        assert rep["quarantined"]
        span = db.health()["unavailable"][0]
        bad_key = int(span["lo"])
        good_key = span["hi"] + 1 if span["hi"] is not None else None
        ops = [Op.get(bad_key), Op.put(10**9, np.array([7, 7], np.uint32)),
               Op.get(10**9)]
        if good_key is not None and good_key in model:
            ops.append(Op.get(good_key))
            ops.append(Op.multiget([good_key, bad_key]))
        res = db.submit(Batch(ops), sync=True).result()
        sts = [r.status for r in res.results]
        assert sts[0] == OpStatus.IO_ERROR
        assert sts[1] == OpStatus.OK and sts[2] == OpStatus.OK
        if good_key is not None and good_key in model:
            assert sts[3] == OpStatus.OK
            v = res.results[3].value
            assert (int(v[0]), int(v[1])) == model[good_key]
            assert sts[4] == OpStatus.IO_ERROR
        with pytest.raises(UnavailableSpanError):
            res.results[0].raise_if_error()
        assert res.stats["io_errors"] >= 1
        assert db.engine().stats()["io_errors"] >= 1
    finally:
        db.close()


def test_containment_transient_multiget_isolated(tmp_path):
    d = str(tmp_path / "db")
    model = _seed_store(d)
    sst = _files(d, "tables", "*.sst")
    plan = FaultPlan(seed=5).transient_read(os.path.basename(sst[0]), count=-1)
    db = RemixDB.open(d, _cfg(plan=plan, io_retries=1))
    try:
        keys = sorted(model)
        res = db.submit(Batch([Op.multiget(keys[:4]), Op.multiget(keys[-4:])]),
                        sync=True).result()
        sts = [r.status for r in res.results]
        assert OpStatus.IO_ERROR in sts
        for r, ks in zip(res.results, (keys[:4], keys[-4:])):
            if r.status == OpStatus.OK:
                for j, k in enumerate(ks):
                    assert (int(r.vals[j][0]), int(r.vals[j][1])) == model[k]
    finally:
        db.close()


# --------------------------------------- cache hygiene (never unverified)
@pytest.mark.parametrize("mode", ["copy", "mmap"])
def test_unverified_bytes_never_cached(tmp_path, mode):
    d = str(tmp_path / "db")
    model = _seed_store(d)
    sst = _files(d, "tables", "*.sst")
    db = RemixDB.open(d, _cfg(cache_mode=mode))
    try:
        lo = _vals_offset(db)
        db.close()
        _flip(d, sst[0], lo + 8, 4)
        db = RemixDB.open(d, _cfg(cache_mode=mode))
        with pytest.raises(CorruptionError):
            db.scan(0, 1 << 20)
        with pytest.raises(CorruptionError):  # and again: not cached
            db.scan(0, 1 << 20)
        db.close()
        _flip(d, sst[0], lo + 8, 4)  # heal the bytes (XOR is invertible)
        db = RemixDB.open(d, _cfg(cache_mode=mode))
        kk, vv = db.scan(0, 1 << 20)
        got = {int(k): (int(v[0]), int(v[1])) for k, v in zip(kk, vv)}
        assert got == model
    finally:
        db.close()


# ------------------------------------------------------ quarantine purge
def test_quarantine_age_purge(tmp_path):
    d = str(tmp_path / "db")
    _seed_store(d)
    db = RemixDB.open(d, _cfg(quarantine_purge_age_s=3600.0))
    try:
        qdir = db.storage.quarantine_dir
        for q in _both(d, qdir):
            os.makedirs(q, exist_ok=True)
            old, fresh = os.path.join(q, "t-old.sst"), os.path.join(q, "t-fresh.sst")
            for p in (old, fresh):
                with open(p, "wb") as f:
                    f.write(b"x" * 64)
            past = os.path.getmtime(old) - 7200
            os.utime(old, (past, past))
        rep = db.scrub(full=True)
        assert rep["clean"]
        for q in _both(d, qdir):
            assert not os.path.exists(os.path.join(q, "t-old.sst"))
            assert os.path.exists(os.path.join(q, "t-fresh.sst"))
        assert db.registry.counter("quarantine_purged").value == 1
        assert db.health()["repair"]["quarantine_purged"] == 1
        kinds = [e.kind for e in db.events.list()]
        assert "quarantine_purge" in kinds
    finally:
        db.close()


# ------------------------------------- seeded bit-rot property (satellite)
def _bitrot_roundtrip(tmp_path, seed):
    """Flip one seeded random byte anywhere under the store (the same file
    and offset in both packages' copies), reopen, and drive scans + probes
    + scrub: every outcome is correct data, a typed error, or a
    quarantined span, and the same in both."""
    rng = random.Random(seed)
    d = str(tmp_path / f"db{seed}")
    model = _seed_store(d, n=400)
    files = []
    for root, _, fs in os.walk(d):
        files.extend(os.path.join(root, f) for f in fs)
    victim = rng.choice(sorted(files))
    off = rng.randrange(max(1, os.path.getsize(victim)))
    _flip(d, victim, off, 1)

    try:
        db = RemixDB.open(d, _cfg())
    except CorruptionError:
        return
    try:
        _check_never_wrong(db, model)
        try:
            db.scrub(full=True)
        except (CorruptionError, TransientIOError):
            pass
        _check_never_wrong(db, model)
    finally:
        db.close()
    try:
        db = RemixDB.open(d, _cfg())
    except CorruptionError:
        return
    try:
        _check_never_wrong(db, model)
    finally:
        db.close()


@pytest.mark.parametrize("seed", range(4))
def test_bitrot_property_deterministic(tmp_path, seed):
    _bitrot_roundtrip(tmp_path, seed)


@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(4, 36))
def test_bitrot_property_matrix(tmp_path, seed):
    _bitrot_roundtrip(tmp_path, seed)


# -------------------------------------------------- background scrubber
def test_background_scrub_thread(tmp_path):
    """Port alone (its passes follow the wall clock): the interval-driven
    scrubber runs, records passes, and is joined cleanly at close."""
    from repro_torch.db.store import RemixDB as TRemixDB

    d = str(tmp_path / "db")
    _seed_store(d)
    db = TRemixDB.open(twin_dir(d)[1], to_port(_cfg(scrub_interval_s=0.05), PORT_CPU))
    try:
        deadline = time.monotonic() + 10.0
        while (time.monotonic() < deadline
               and db.registry.counter("scrub_passes").value == 0):
            time.sleep(0.02)
        assert db.registry.counter("scrub_passes").value >= 1
        assert db.health()["scrub"]["last"] is not None
        assert db.health()["scrub"]["last"]["clean"]
    finally:
        db.close()
    assert db._scrub_thread is None


# ================================================ test_recovery_faults
def _rcfg(**kw):
    return RemixDBConfig(
        vw=2,
        memtable_entries=kw.pop("memtable_entries", 256),
        compaction=CompactionConfig(table_cap=256, t_max=4),
        hot_threshold=255,
        **kw,
    )


def _crash_image(src, dst):
    """A copy of each package's live directory (never closed cleanly)."""
    for a, b in zip(twin_dir(src), twin_dir(dst)):
        shutil.copytree(a, b)
    return dst


def _assert_state(db, model):
    kk, vv = db.scan(0, 1 << 20)
    got = {int(k): (int(v[0]), int(v[1])) for k, v in zip(kk, vv)}
    assert got == model


def _tear_wal(live, img, pre):
    """Give each image's WAL its durable bytes from before the kill point."""
    for d, data in zip(twin_dir(img), pre):
        with open(os.path.join(d, "wal.log"), "r+b") as f:
            f.seek(0)
            f.write(data)
            f.truncate(len(data))


def _wal_bytes(d):
    out = []
    for x in twin_dir(d):
        with open(os.path.join(x, "wal.log"), "rb") as f:
            out.append(f.read())
    return out


def test_crash_after_wal_range_append(tmp_path):
    d = str(tmp_path / "live")
    db = RemixDB.open(d, _rcfg())
    model = _fill(db, 0, 400, tag=1)
    db.flush()
    model.update(_fill(db, 400, 500, tag=2))
    db.delete_range(100, 450)
    for k in [k for k in model if 100 <= k < 450]:
        del model[k]
    db.put(120, np.array([120, 3], np.uint32))
    model[120] = (120, 3)
    db.wal.sync()
    img = _crash_image(d, str(tmp_path / "crash"))
    db.close()

    db2 = RemixDB.open(img, _rcfg())
    try:
        _assert_state(db2, model)
        assert db2.get(200) is None
        assert db2.get(120) is not None
        db2.flush()
        _assert_state(db2, model)
    finally:
        db2.close()
    db3 = RemixDB.open(img, _rcfg())
    try:
        _assert_state(db3, model)
    finally:
        db3.close()


def test_crash_torn_wal_range_append(tmp_path):
    d = str(tmp_path / "live")
    db = RemixDB.open(d, _rcfg())
    model = _fill(db, 0, 300, tag=1)
    db.flush()
    db.wal.sync()
    assert os.path.basename(db.wal.path) == "wal.log"
    pre = _wal_bytes(d)
    assert pre[0] == pre[1]
    db.delete_range(50, 250)
    db.wal.sync()
    img = _crash_image(d, str(tmp_path / "crash"))
    db.close()
    _tear_wal(d, img, pre)

    db2 = RemixDB.open(img, _rcfg())
    try:
        _assert_state(db2, model)
    finally:
        db2.close()


def _commit_bomb(monkeypatch, fail_on):
    """Arm both packages' ``io.manifest._atomic_write`` to raise for a path
    containing ``fail_on`` (CURRENT flip or MANIFEST body)."""
    reals = [(m, m._atomic_write) for m in (r_manifest, t_manifest)]

    def bomb_for(real):
        def bomb(path, data, io=None):
            if fail_on in os.path.basename(path):
                raise OSError(f"injected crash writing {os.path.basename(path)}")
            return real(path, data, io=io)
        return bomb

    for m, real in reals:
        monkeypatch.setattr(m, "_atomic_write", bomb_for(real))

    def disarm():
        for m, real in reals:
            monkeypatch.setattr(m, "_atomic_write", real)
    return disarm


@pytest.mark.parametrize("fail_on", ["CURRENT", "MANIFEST"])
def test_crash_mid_manifest_commit(tmp_path, monkeypatch, fail_on):
    d = str(tmp_path / "live")
    db = RemixDB.open(d, _rcfg())
    model = _fill(db, 0, 400, tag=1)
    db.flush()
    db.delete_range(100, 300)
    for k in [k for k in model if 100 <= k < 300]:
        del model[k]
    model.update(_fill(db, 500, 550, tag=2))
    disarm = _commit_bomb(monkeypatch, fail_on)
    with pytest.raises(OSError, match="injected crash"):
        db.flush()
    disarm()
    db.wal.sync()
    img = _crash_image(d, str(tmp_path / "crash"))
    db.close()

    db2 = RemixDB.open(img, _rcfg())
    try:
        _assert_state(db2, model)
        assert db2.get(150) is None
        db2.flush()
        _assert_state(db2, model)
    finally:
        db2.close()
    db3 = RemixDB.open(img, _rcfg())
    try:
        _assert_state(db3, model)
        assert db3.get(150) is None
    finally:
        db3.close()


def test_wal_read_from_tail_follow(tmp_path):
    d = str(tmp_path / "live")
    db = RemixDB.open(d, _rcfg(memtable_entries=1 << 14))
    _fill(db, 0, 600, tag=1)
    db.delete_range(50, 80)
    mid_seq = db.seq - 1
    _fill(db, 600, 900, tag=2)
    db.delete_range(700, 720)

    recs = list(db.wal.read_from(0))
    assert len(recs) == 902
    assert sorted(int(r[1]) for r in recs) == list(range(1, 903))

    tail = list(db.wal.read_from(mid_seq))
    assert {int(r[1]) for r in tail} == set(range(mid_seq + 1, 903))
    keys = {int(r[0]) for r in tail if not r[2] & 2}
    assert keys == set(range(600, 900))

    assert list(db.wal.read_from(db.seq)) == []

    db.put(10, np.array([10, 9], np.uint32))
    again = sorted((r for r in db.wal.read_from(0) if int(r[0]) == 10),
                   key=lambda r: int(r[1]))
    assert int(again[-1][4][1]) == 9
    db.close()


def test_wal_read_from_torn_tail_image(tmp_path):
    d = str(tmp_path / "live")
    db = RemixDB.open(d, _rcfg(memtable_entries=1 << 14))
    model = _fill(db, 0, 300, tag=1)
    db.wal.sync()
    pre = _wal_bytes(d)
    db.put(999, np.array([999, 7], np.uint32))  # will be torn away
    db.wal.sync()
    img = _crash_image(d, str(tmp_path / "crash"))
    db.close()
    _tear_wal(d, img, pre)

    db2 = RemixDB.open(img, _rcfg(memtable_entries=1 << 14))
    try:
        _assert_state(db2, model)
        recs = list(db2.wal.read_from(0))
        assert {int(r[0]) for r in recs} == set(range(0, 300))
        assert 999 not in {int(r[0]) for r in recs}
        top = max(int(r[1]) for r in recs)
        assert list(db2.wal.read_from(top)) == []
        assert len(list(db2.wal.read_from(top - 1))) == 1
    finally:
        db2.close()


@pytest.mark.nightly
@pytest.mark.parametrize("fail_on", ["CURRENT", "MANIFEST"])
@pytest.mark.parametrize("seed", range(6))
def test_crash_matrix_random_workloads(tmp_path, monkeypatch, seed, fail_on):
    rng = random.Random(seed)
    d = str(tmp_path / "live")
    db = RemixDB.open(d, _rcfg(memtable_entries=128))
    model = {}
    for round_ in range(4):
        for _ in range(rng.randrange(50, 150)):
            k = rng.randrange(1000)
            v = (rng.randrange(1 << 31), round_)
            db.put(k, np.array(v, np.uint32))
            model[k] = v
        if rng.random() < 0.7:
            lo = rng.randrange(900)
            hi = lo + rng.randrange(1, 300)
            db.delete_range(lo, hi)
            for k in [k for k in model if lo <= k < hi]:
                del model[k]
        if round_ < 3:
            db.flush()
    disarm = _commit_bomb(monkeypatch, fail_on)
    try:
        db.flush()
    except OSError:
        pass
    disarm()
    db.wal.sync()
    img = _crash_image(d, str(tmp_path / f"crash{seed}"))
    db.close()
    db2 = RemixDB.open(img, _rcfg(memtable_entries=128))
    try:
        _assert_state(db2, model)
    finally:
        db2.close()
