"""The port's DeviceViewManager against the JAX package's, on the same
in-memory partitions (tombstones, TTL expiries, an excised span).

The reference runs its Pallas kernels in interpret mode; the port runs on
the CPU (``device="cpu"``), where its kernel wrappers take their plain
versions. Answers, resident bytes, counters, events, LRU eviction order
and the one-sync-per-batch contract must match exactly (tolerance 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels.device_view as RDV  # noqa: E402
import repro_torch.kernels.device_view as TDV  # noqa: E402
from repro.db.partition import Partition as RPartition  # noqa: E402
from repro.db.partition import Table as RTable  # noqa: E402
from repro.obs.events import EventLog as REventLog  # noqa: E402
from repro.obs.metrics import MetricsRegistry as RRegistry  # noqa: E402
from repro_torch.db.partition import Partition as TPartition  # noqa: E402
from repro_torch.db.partition import Table as TTable  # noqa: E402
from repro_torch.obs.events import EventLog as TEventLog  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry as TRegistry  # noqa: E402

NOW = 1_000_000
N, VW, D = 150, 2, 16
METRICS = ("device_batches", "device_rows_gathered", "device_fallback_total",
           "hbm_resident_bytes")


def table_data(rng, lo, i, domain):
    keys = np.sort(rng.choice(domain, N, replace=False))
    exp = np.zeros(N, np.uint32)
    ttl = rng.random(N) < 0.2
    exp[ttl] = rng.choice([NOW - 10, NOW + 10, NOW + 100], int(ttl.sum()))
    return dict(
        keys=keys,
        vals=rng.integers(0, 2**32, (N, VW), dtype=np.uint64).astype(np.uint32),
        seq=(np.arange(N) + i * N + 1).astype(np.uint32),
        tomb=rng.random(N) < 0.1,
        exp=exp,
    )


def make_pair(seed, lo, n_tables=3):
    """The same partition in both packages: ``n_tables`` overlapping
    tables, an excised span over the first two, and one spare table."""
    rng = np.random.default_rng(seed)
    domain = np.uint64(lo) + np.arange(0, 4 * N, dtype=np.uint64) * np.uint64(7)
    data = [table_data(rng, lo, i, domain) for i in range(n_tables + 1)]
    pair = []
    for P, T, kw in ((RPartition, RTable, {}), (TPartition, TTable, {"device": "cpu"})):
        tables = [T(**d) for d in data]
        p = P(lo, tables[:2], d=D, **kw)
        p.attach_excised(int(domain[100]), int(domain[160]), seq=10**6)
        p.tables.extend(tables[2:n_tables])
        pair.append((p, tables[n_tables]))
    return pair, domain


def managers(budget):
    rr, tr = RRegistry(), TRegistry()
    re_, te = REventLog(), TEventLog()
    rm = RDV.DeviceViewManager(budget, registry=rr, events=re_, interpret=True)
    tm = TDV.DeviceViewManager(budget, registry=tr, events=te, device="cpu")
    return (rm, rr, re_), (tm, tr, te)


def metric(reg, name):
    return sum(s["value"] for s in reg.snapshot()["metrics"] if s["name"] == name)


def events(log):
    return [(e.kind, e.fields) for e in log.list()]


def assert_same_state(ref, port):
    (rm, rr, re_), (tm, tr, te) = ref, port
    assert rm.resident_bytes == tm.resident_bytes
    assert len(rm) == len(tm)
    for name in METRICS:
        assert metric(rr, name) == metric(tr, name), name
    assert events(re_) == events(te)


def probes(rng, domain):
    return np.concatenate([domain[rng.integers(0, len(domain), 120)],
                           domain[:5] + np.uint64(1), domain[-1:] + np.uint64(3)])


def test_batches_match_reference():
    (rp, _), (tp, _) = make_pair(0, 1 << 40)[0]
    ref, port = managers(1 << 30)
    rv, tv = ref[0].view_for(rp), port[0].view_for(tp)
    assert rv.nbytes == tv.nbytes and rv.tier == tv.tier == "full"
    rng = np.random.default_rng(1)
    domain = make_pair(0, 1 << 40)[1]
    for now in (NOW, NOW + 50):  # the second instant expires more rows
        q = probes(rng, domain)
        r0, t0 = RDV.SYNCS, TDV.SYNCS
        fr, vr = ref[0].get_batch(rv, q, now)
        ft, vt = port[0].get_batch(tv, q, now)
        assert (RDV.SYNCS - r0, TDV.SYNCS - t0) == (1, 1)
        np.testing.assert_array_equal(fr, ft)
        np.testing.assert_array_equal(vr, vt)
        assert vt.dtype == np.uint32 and 0 < ft.sum() < len(q)
        starts = q[:40]
        for with_vals in (True, False):
            r0, t0 = RDV.SYNCS, TDV.SYNCS
            a = ref[0].scan_windows(rv, starts, 21, now, with_vals=with_vals)
            b = port[0].scan_windows(tv, starts, 21, now, with_vals=with_vals)
            assert (RDV.SYNCS - r0, TDV.SYNCS - t0) == (1, 1)
            for (ka, va), (kb, vb) in zip(a, b):
                np.testing.assert_array_equal(ka, kb)
                if with_vals:
                    np.testing.assert_array_equal(va, vb)
                else:
                    assert va is None and vb is None
            assert sum(len(k) for k, _ in b) > 0
    assert_same_state(ref, port)


def test_resident_bytes_and_upload_events_match():
    pairs = [make_pair(s, (s + 1) << 40)[0] for s in range(3)]
    ref, port = managers(1 << 30)
    for (rp, _), (tp, _) in pairs:
        ref[0].view_for(rp)
        port[0].view_for(tp)
        assert_same_state(ref, port)
    assert port[0].resident_bytes == sum(
        e.fields["bytes"] for e in port[2].list("device_upload")) > 0


def test_lru_eviction_order_matches():
    pairs = [make_pair(s, (s + 1) << 40)[0] for s in range(3)]
    one = max(tp.device_view_bytes(True) for _, (tp, _) in pairs)
    ref, port = managers(2 * one + one // 2)  # room for two views
    order = [0, 1, 0, 2, 1, 0, 2]
    for i in order:
        (rp, _), (tp, _) = pairs[i]
        assert (ref[0].view_for(rp) is None) == (port[0].view_for(tp) is None)
        assert_same_state(ref, port)
    evicted = [e.fields["lo"] for e in port[2].list("device_evict")]
    assert evicted and all(e.fields["reason"] == "budget"
                           for e in port[2].list("device_evict"))
    assert port[0].resident_bytes <= 2 * one + one // 2
    assert evicted == [e.fields["lo"] for e in ref[2].list("device_evict")]


def test_retain_and_clear_match():
    pairs = [make_pair(s, (s + 1) << 40)[0] for s in range(3)]
    ref, port = managers(1 << 30)
    for (rp, _), (tp, _) in pairs:
        ref[0].view_for(rp)
        port[0].view_for(tp)
    ref[0].retain({id(pairs[1][0][0])})
    port[0].retain({id(pairs[1][1][0])})
    assert_same_state(ref, port)
    assert len(port[0]) == 1
    ref[0].clear()
    port[0].clear()
    assert_same_state(ref, port)
    assert port[0].resident_bytes == 0 and len(port[0]) == 0
    reasons = [e.fields["reason"] for e in port[2].list("device_evict")]
    assert reasons == ["version_release", "version_release", "clear"]


def test_budget_fallback_matches():
    (rp, _), (tp, _) = make_pair(3, 1 << 40)[0]
    ref, port = managers(16)
    assert ref[0].view_for(rp) is None and port[0].view_for(tp) is None
    assert_same_state(ref, port)
    assert metric(port[1], "device_fallback_total") == 1


def test_appended_table_rebuilds_incrementally():
    pair, domain = make_pair(4, 1 << 40)
    (rp, rnew), (tp, tnew) = pair
    ref, port = managers(1 << 30)
    ref[0].view_for(rp)
    port[0].view_for(tp)
    assert rp.last_build_kind == tp.last_build_kind == "scratch"
    rp.tables.append(rnew)
    tp.tables.append(tnew)
    ref[0].clear()
    port[0].clear()
    rv, tv = ref[0].view_for(rp), port[0].view_for(tp)
    assert rp.last_build_kind == tp.last_build_kind == "incremental"
    rb, tb = rp._built_remix, tp._built_remix
    np.testing.assert_array_equal(np.asarray(rb.anchors), tb.anchors.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(rb.cursors), tb.cursors.numpy())
    np.testing.assert_array_equal(np.asarray(rb.selectors), tb.selectors.numpy())
    assert rb.storage_bytes() == tb.storage_bytes() and rp.remix_bytes == tp.remix_bytes
    q = probes(np.random.default_rng(5), domain)
    for a, b in zip(ref[0].get_batch(rv, q, NOW), port[0].get_batch(tv, q, NOW)):
        np.testing.assert_array_equal(a, b)
    assert_same_state(ref, port)


def _arrays(remix, runset, exp=None):
    out = [remix.anchors, remix.cursors, remix.selectors, runset.keys,
           runset.vals, runset.seq, runset.tomb, runset.lens]
    return out + ([exp] if exp is not None else [])


def _assert_arrays_equal(ref_arrays, port_arrays):
    for a, b in zip(ref_arrays, port_arrays, strict=True):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(a, b)


def test_device_index_arrays_match():
    (rp, _), (tp, _) = make_pair(6, 1 << 40)[0]
    _assert_arrays_equal(_arrays(*rp.device_index()), _arrays(*tp.device_index()))
    for with_vals in (True, False):
        assert rp.device_view_bytes(with_vals) == tp.device_view_bytes(with_vals)
    assert rp.n_entries == tp.n_entries
    assert rp.estimate_remix_bytes(100) == tp.estimate_remix_bytes(100)


def test_partition_index_bakes_liveness_like_reference(monkeypatch):
    """``index()`` bakes tombstones, TTL expiry at build time and excised
    spans into the runset, and rebuilds once the clock passes the next
    expiry — in step with the reference."""
    import repro.db.clock as rclock
    import repro_torch.db.clock as tclock
    from repro.core import query as RQ
    from repro_torch.core import query as TQ

    pair, domain = make_pair(7, 1 << 40)
    (rp, _), (tp, _) = pair
    q = probes(np.random.default_rng(8), domain)
    from repro.core.keys import pack_u64

    qk = pack_u64(q)
    for now in (NOW, NOW + 50):
        monkeypatch.setattr(rclock, "_source", lambda: float(now))
        monkeypatch.setattr(tclock, "_source", lambda: float(now))
        (rm, rs), (tm, ts) = rp.index(), tp.index()
        _assert_arrays_equal(_arrays(rm, rs), _arrays(tm, ts))
        fr, vr = RQ.get(rm, rs, qk)
        ft, vt = TQ.get(tm, ts, torch.from_numpy(qk.view(np.int32)))
        np.testing.assert_array_equal(np.asarray(fr), ft.numpy())
        np.testing.assert_array_equal(np.asarray(vr), vt.numpy().view(np.uint32))
        assert rp.last_build_kind == tp.last_build_kind


# ---- the index residency tier: file-backed partitions ----

def make_file_pair(root, seed, lo, n_tables=4, n=2000, vw=3):
    """The same file-backed partition in both packages, over SSTables the
    reference wrote: ``n_tables`` overlapping tables with tombstones and
    TTLs, and an excised span over the first two."""
    from repro.core.keys import pack_u64
    from repro.io import Storage

    rng = np.random.default_rng(seed)
    domain = np.uint64(lo) + np.arange(1, 3 * n, dtype=np.uint64) * np.uint64(5)
    storage = Storage(str(root))
    names = []
    for i in range(n_tables):
        keys = np.sort(rng.choice(domain, n, replace=False))
        exp = np.zeros(n, np.uint32)
        ttl = rng.random(n) < 0.2
        exp[ttl] = rng.choice([NOW - 10, NOW + 10, NOW + 100], int(ttl.sum()))
        names.append(storage.write_table(
            pack_u64(keys),
            rng.integers(0, 2**32, (n, vw), dtype=np.uint64).astype(np.uint32),
            (np.arange(n) + i * n + 1).astype(np.uint32), rng.random(n) < 0.1,
            exp=exp))
    pair = []
    for P, T, kw in ((RPartition, RTable, {}), (TPartition, TTable, {"device": "cpu"})):
        tables = [T.from_file(storage.table_path(m)) for m in names]
        p = P(lo, tables[:2], d=D, **kw)
        p.attach_excised(int(domain[200]), int(domain[700]), seq=10**6)
        p.tables.extend(tables[2:])
        pair.append(p)
    return pair, domain


def index_managers(budget):
    """Both managers, with 4-query pipeline slices."""
    rr, tr = RRegistry(), TRegistry()
    re_, te = REventLog(), TEventLog()
    rm = RDV.DeviceViewManager(budget, slice_width=4, registry=rr, events=re_,
                               interpret=True)
    tm = TDV.DeviceViewManager(budget, slice_width=4, registry=tr, events=te,
                               device="cpu")
    return (rm, rr, re_), (tm, tr, te)


def between_tiers(p):
    """A budget below the full view and above the index view."""
    full, index = p.device_view_bytes(True), p.device_view_bytes(False)
    assert index < full
    return (full + index) // 2


def vals_read(p):
    return [t._rd().bytes_read["vals"] for t in p.tables]


def test_index_tier_batches_match_reference(tmp_path):
    (rp, tp), domain = make_file_pair(tmp_path, 20, 1 << 40)
    ref, port = index_managers(between_tiers(tp))
    rv, tv = ref[0].view_for(rp), port[0].view_for(tp)
    assert rv.tier == tv.tier == "index"
    assert rv.nbytes == tv.nbytes and rv.vw == tv.vw == 3
    assert tv.runset.vw == 1  # dummy values on the card
    assert vals_read(rp) == vals_read(tp) == [0] * 4  # no value byte at upload
    assert_same_state(ref, port)
    rng = np.random.default_rng(21)
    for now in (NOW, NOW + 50):
        q = probes(rng, domain)
        r0, t0 = RDV.SYNCS, TDV.SYNCS
        fr, vr = ref[0].get_batch(rv, q, now)
        ft, vt = port[0].get_batch(tv, q, now)
        assert (RDV.SYNCS - r0, TDV.SYNCS - t0) == (1, 1)
        np.testing.assert_array_equal(fr, ft)
        np.testing.assert_array_equal(vr, vt)
        assert vt.dtype == np.uint32 and 0 < ft.sum() < len(q)
        starts = q[:42]  # 11 slices of 4, the last one ragged
        for with_vals, syncs in ((True, 11), (False, 1)):
            r0, t0 = RDV.SYNCS, TDV.SYNCS
            a = ref[0].scan_windows(rv, starts, 21, now, with_vals=with_vals)
            b = port[0].scan_windows(tv, starts, 21, now, with_vals=with_vals)
            assert (RDV.SYNCS - r0, TDV.SYNCS - t0) == (syncs, syncs)
            assert len(a) == len(b) == len(starts)
            for (ka, va), (kb, vb) in zip(a, b):
                np.testing.assert_array_equal(ka, kb)
                if with_vals:
                    np.testing.assert_array_equal(va, vb)
                    assert vb.dtype == np.uint32
                else:
                    assert va is None and vb is None
            assert sum(len(k) for k, _ in b) > 0
    assert vals_read(rp) == vals_read(tp) and sum(vals_read(tp)) > 0
    assert_same_state(ref, port)


def test_index_tier_eviction_matches_reference(tmp_path):
    pairs = [make_file_pair(tmp_path / str(s), 30 + s, (s + 1) << 40)[0]
             for s in range(3)]
    ref, port = index_managers(between_tiers(pairs[0][1]))
    for i in (0, 1, 0, 2):  # each upload evicts the one before it
        rp, tp = pairs[i]
        rv, tv = ref[0].view_for(rp), port[0].view_for(tp)
        assert rv.tier == tv.tier == "index"
        assert_same_state(ref, port)
        assert len(port[0]) == 1 and port[0].resident_bytes == tv.nbytes
    evicted = [(e.fields["lo"], e.fields["tier"], e.fields["reason"])
               for e in port[2].list("device_evict")]
    assert evicted == [((s + 1) << 40, "index", "budget") for s in (0, 1, 0)]
    assert all(sum(vals_read(tp)) == 0 for _, tp in pairs)


def test_device_index_without_vals_matches_reference(tmp_path):
    (rp, tp), _ = make_file_pair(tmp_path, 40, 1 << 40, n_tables=3)
    _assert_arrays_equal(_arrays(*rp.device_index(with_vals=False)),
                         _arrays(*tp.device_index(with_vals=False)))
    assert vals_read(rp) == vals_read(tp) == [0] * 3
    assert rp.last_build_kind == tp.last_build_kind == "scratch"
    assert repr(rp) == repr(tp)


@pytest.mark.parametrize("file_backed", [True, False])
def test_no_tier_fits_falls_back_like_reference(tmp_path, file_backed):
    """Below the index view, or between the tiers with in-memory tables,
    neither package uploads: both count one fallback."""
    if file_backed:
        (rp, tp), _ = make_file_pair(tmp_path, 50, 1 << 40, n_tables=3)
        budget = tp.device_view_bytes(False) - 1
    else:
        (rp, _), (tp, _) = make_pair(51, 1 << 40)[0]
        budget = between_tiers(tp)
    ref, port = index_managers(budget)
    assert ref[0].view_for(rp) is None and port[0].view_for(tp) is None
    assert_same_state(ref, port)
    assert metric(port[1], "device_fallback_total") == 1


def test_persisted_remix_is_reused_at_upload(tmp_path):
    """persist_index → load_remix → preload_index: the index-tier upload
    reuses the loaded REMIX, in both packages, over the same files."""
    import repro.io as RIO
    import repro_torch.io as TIO

    (rp, tp), domain = make_file_pair(tmp_path, 60, 1 << 40, n_tables=3)
    storage = RIO.Storage(str(tmp_path / "x"))
    rp.persist_index(storage)
    tstorage = TIO.Storage(str(tmp_path / "y"))
    tp.persist_index(tstorage)
    with open(storage.remix_path(rp.remix_name), "rb") as f, \
            open(tstorage.remix_path(tp.remix_name), "rb") as g:
        assert f.read() == g.read()
    (rp2, tp2), _ = make_file_pair(tmp_path / "again", 60, 1 << 40, n_tables=3)
    rp2.preload_index(RIO.load_remix(storage.remix_path(rp.remix_name)))
    tp2.preload_index(TIO.load_remix(tstorage.remix_path(tp.remix_name), device="cpu"))
    ref, port = index_managers(between_tiers(tp2))
    rv, tv = ref[0].view_for(rp2), port[0].view_for(tp2)
    assert rp2.last_build_kind == tp2.last_build_kind == "reuse"
    assert rv.tier == tv.tier == "index" and sum(vals_read(tp2)) == 0
    q = probes(np.random.default_rng(61), domain)
    for a, b in zip(ref[0].get_batch(rv, q, NOW), port[0].get_batch(tv, q, NOW)):
        np.testing.assert_array_equal(a, b)
    assert_same_state(ref, port)
