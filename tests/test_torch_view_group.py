"""One device round trip for all of a store batch's device-view partitions.

``DeviceViewManager.get_batch`` takes a list of views with a list of key
arrays: one query upload, three launches a view, one packed buffer, one
fetch. Held here on the CPU (the kernels' plain versions), on a persistent
store of 11 partitions under a device budget that puts some on the full
tier and some on the index tier: the grouped call against one call a view
(bit for bit) and against the JAX package's store, at two clock readings
(TTL expiries), with tombstones, a range tombstone, a one-key view and
segments on power-of-two boundaries; the counters of one round trip; and
``get_resolve``'s ``out=`` buffer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.devtrace import KernelCalls  # noqa: E402
from repro.db import clock as rclock  # noqa: E402
from repro.db.compaction import CompactionConfig  # noqa: E402
from repro.db.store import RemixDB as RRemixDB  # noqa: E402
from repro.db.store import RemixDBConfig  # noqa: E402
from repro_torch.db import clock as tclock  # noqa: E402
from repro_torch.db import store as TS  # noqa: E402
from repro_torch.db.sharded import route_host  # noqa: E402
from repro_torch.kernels import device_view as DV  # noqa: E402
from repro_torch.kernels import get_resolve as TG  # noqa: E402
from torch_twin import pair_class, twin_dir  # noqa: E402

RemixDB = pair_class(RRemixDB)
T0 = 1_000_000.0
N_KEYS = 1500  # 11 partitions at a 128-entry memtable and 128-entry tables
# keys a view gets, in turn: one key, on and just past power-of-two
# boundaries (the upload pads each segment to a power of two, at least 8),
# and every key routed to the partition
SIZES = (1, 8, 9, 16, 17, None)


@pytest.fixture(autouse=True)
def _reset_clocks():
    yield
    rclock.reset()
    tclock.reset()


def _set_clock(t):
    rclock.set_source(lambda: t)
    tclock.set_source(lambda: t)


def _metric(db, name):
    return sum(s["value"] for s in db.registry.snapshot()["metrics"] if s["name"] == name)


@pytest.fixture(scope="module")
def populated(tmp_path_factory):
    """Both packages' data dirs, written by the twin store: puts, point
    deletes, TTLs of 10 and 50 s and a range delete, flushed; the keys."""
    root = str(tmp_path_factory.mktemp("group") / "db")
    _set_clock(T0)
    rng = np.random.default_rng(5)
    keys = rng.choice(1 << 20, size=N_KEYS, replace=False).astype(np.uint64)
    cfg = RemixDBConfig(vw=2, hot_threshold=255, memtable_entries=128,
                        compaction=CompactionConfig(table_cap=128, t_max=3),
                        device_path="off")
    db = RemixDB.open(root, cfg)
    for i, k in enumerate(keys.tolist()):
        db.put(k, [i & 0xFFFF, i ^ 7])
    for k in keys[:150].tolist():
        db.delete(k)
    db.put_batch(keys[150:300], np.full((150, 2), 9, np.uint32), ttl=10)
    db.put_batch(keys[300:450], np.full((150, 2), 11, np.uint32), ttl=50)
    lo = int(keys[500])
    db.delete_range(lo, lo + 4096)
    db.flush()
    db.close()
    rclock.reset()
    tclock.reset()
    return root, np.sort(keys)


def _budget(root):
    """A budget that holds the small partitions' full views and only the
    index views of the large ones (every index view fits)."""
    probe = TS.RemixDB.open(twin_dir(root)[1], TS.RemixDBConfig(device="cpu", device_path="off"))
    full = sorted(p.device_view_bytes(True) for p in probe.partitions)
    idx = max(p.device_view_bytes(False) for p in probe.partitions)
    probe.close()
    cap = max(idx, full[len(full) // 2])
    assert full[0] <= cap < full[-1]
    return cap


def _open(root, tiers):
    _set_clock(T0)
    kw = dict(device="cpu", device_path="on", device_slice=4)
    if tiers == "mixed":
        kw["device_budget_bytes"] = _budget(root)
    return pair_class(RRemixDB, kw).open(root, RemixDBConfig(
        vw=2, hot_threshold=255, memtable_entries=128,
        compaction=CompactionConfig(table_cap=128, t_max=3),
        device_path="off", cold_reads=False))


def _probes(domain, rng):
    return np.concatenate([domain, rng.choice(domain, 200) + np.uint64(1),
                           [0, (1 << 20) + 5]]).astype(np.uint64)


def _segments(port, keys):
    """Each partition's view and its keys, cut to ``SIZES`` in turn."""
    parts = port.partitions
    pidx = route_host([p.lo for p in parts], keys)
    views, segs = [], []
    for i, p in enumerate(parts):
        k = keys[pidx == i]
        n = SIZES[i % len(SIZES)]
        views.append(port.device_views.view_for(p))
        segs.append(k if n is None else k[:n])
    assert all(v is not None for v in views)
    assert {len(s) for s in segs} >= {1, 8, 9, 16, 17}
    return views, segs


@pytest.mark.parametrize("tiers", ["mixed", "full"])
def test_grouped_get_equals_one_call_a_view_and_the_reference(populated, tiers):
    root, domain = populated
    db = _open(root, tiers)
    try:
        port, mgr = db.port, db.port.device_views
        views, segs = _segments(port, _probes(domain, np.random.default_rng(6)))
        assert len(views) >= 6
        want = {"mixed": {"full", "index"}, "full": {"full"}}[tiers]
        assert {v.tier for v in views} == want
        found_at = []
        for t in (T0, T0 + 20.0):  # the 10-s TTLs expire in between
            _set_clock(t)
            s0, b0 = DV.SYNCS, _metric(port, "device_batches")
            f0 = _metric(port, "device_view_fetches")
            fg, vg = mgr.get_batch(views, segs, t)
            assert DV.SYNCS - s0 == 1
            assert _metric(port, "device_batches") - b0 == len(views)
            assert _metric(port, "device_view_fetches") - f0 == 1
            each = [mgr.get_batch(v, k, t) for v, k in zip(views, segs)]
            np.testing.assert_array_equal(fg, np.concatenate([f for f, _ in each]))
            np.testing.assert_array_equal(vg, np.concatenate([v for _, v in each]))
            assert fg.dtype == bool and vg.dtype == np.uint32
            assert vg.shape == (sum(map(len, segs)), 2)
            # the JAX package's store (host path) on the same keys
            fr, vr = db.ref.get_batch(np.concatenate(segs))
            np.testing.assert_array_equal(np.asarray(fr), fg)
            np.testing.assert_array_equal(np.asarray(vr)[fg], vg[fg])
            found_at.append(int(fg.sum()))
        assert 0 < found_at[1] < found_at[0] < len(fg)
    finally:
        db.close()


@pytest.mark.parametrize("tiers", ["mixed", "full"])
def test_store_batch_is_one_round_trip(populated, tiers):
    """A store's get_batch over every partition: one sync, one fetch, a
    device batch a partition touched; the twin holds its answers to the
    reference's."""
    root, domain = populated
    db = _open(root, tiers)
    try:
        port = db.port
        probe = _probes(domain, np.random.default_rng(7))
        db.get_batch(probe)  # uploads the views
        touched = len(np.unique(route_host([p.lo for p in port.partitions], probe)))
        assert touched == len(port.partitions) >= 6
        for t in (T0, T0 + 20.0):
            _set_clock(t)
            s0, b0 = DV.SYNCS, _metric(port, "device_batches")
            f0 = _metric(port, "device_view_fetches")
            found, _ = db.get_batch(probe)
            assert DV.SYNCS - s0 == 1
            assert _metric(port, "device_batches") - b0 == touched
            assert _metric(port, "device_view_fetches") - f0 == 1
            assert 0 < found.sum() < len(probe)
            s0 = DV.SYNCS
            db.get(int(probe[0]))  # one key: one view
            assert DV.SYNCS - s0 == 1
    finally:
        db.close()


def test_grouped_get_reads_the_same_kernel_work(populated):
    """The roofline readers' hooks (``perfbench.devtrace.KernelCalls``) see
    the same anchor_search calls (anchors, query rows) and selector_decode
    shapes whether the views go in one call or one call each."""
    root, domain = populated
    db = _open(root, "mixed")
    try:
        mgr = db.port.device_views
        views, segs = _segments(db.port, _probes(domain, np.random.default_rng(8)))
        seen = []
        for grouped in (True, False):
            with KernelCalls() as kc:
                if grouped:
                    mgr.get_batch(views, segs, T0)
                else:
                    for v, k in zip(views, segs):
                        mgr.get_batch(v, k, T0)
            seen.append(([(id(a), q.shape) for a, q in kc.anchor], kc.decode))
        assert seen[0] == seen[1]
        assert len(seen[0][0]) == len(views)
    finally:
        db.close()


def _resolve_args():
    """get_resolve's operands on one in-memory partition's view (CPU)."""
    from repro_torch.db.partition import Partition, Table
    from repro_torch.kernels import anchor_search as TA
    from repro_torch.kernels import selector_decode as TSD

    rng = np.random.default_rng(9)
    domain = np.arange(1, 3000, dtype=np.uint64) * np.uint64(13)
    tables = []
    for i in range(3):
        n = 600
        tables.append(Table(
            keys=np.sort(rng.choice(domain, n, replace=False)),
            seq=(np.arange(n) + i * n + 1).astype(np.uint32),
            vals=rng.integers(0, 2**32, (n, 3), dtype=np.uint64).astype(np.uint32),
            tomb=rng.random(n) < 0.1,
            exp=np.where(rng.random(n) < 0.2, rng.choice([90, 110], n), 0).astype(np.uint32)))
    remix, runset, exp = Partition(0, tables, d=16, device="cpu").device_index()
    mgr = DV.DeviceViewManager(1 << 30, device="cpu")
    q = mgr._queries(domain[rng.integers(0, len(domain), 60)])
    sel = remix.selectors.reshape(remix.g, remix.d)
    g = TA.anchor_search(remix.anchors, q)
    return (q, g, *TSD.selector_decode(sel, remix.cursors, rows=g), runset.keys,
            runset.vals, runset.tomb, exp, sel, remix.cursors, 100)


def test_get_resolve_out_writes_only_its_slice():
    args = _resolve_args()
    want = TG.get_resolve(*args)
    q, w = want.shape
    assert (q, w) == (64, 6)
    buf = torch.full((3 * q * w,), -7, dtype=torch.int32)
    out = buf[q * w: 2 * q * w].view(q, w)
    got = TG.get_resolve(*args, out=out)
    assert got is out
    assert torch.equal(out, want)
    assert torch.equal(TG.get_resolve_plain(*args), want)
    assert bool((buf[: q * w] == -7).all()) and bool((buf[2 * q * w:] == -7).all())
    assert bool(want[:, 0].any()) and not bool(want[:, 0].all())


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_get_resolve_rejects_a_wrong_out(bad):
    args = _resolve_args()
    q, w = 64, 6
    out = {"shape": torch.empty((q + 1, w), dtype=torch.int32),
           "dtype": torch.empty((q, w), dtype=torch.int64),
           "contiguity": torch.empty((w, q), dtype=torch.int32).t()}[bad]
    with pytest.raises(ValueError, match="out"):
        TG.get_resolve(*args, out=out)
