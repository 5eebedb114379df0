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
