"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one (marker ``cuda``).
They import no JAX, so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer results: tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import as_words, sm_count  # noqa: E402
from repro_torch.kernels import anchor_search as TA  # noqa: E402
from repro_torch.kernels import get_resolve as TG  # noqa: E402
from repro_torch.kernels import selector_decode as TS  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def sorted_anchors(rng, g, kw, nq=300):
    """Sorted (g, kw) uint32 anchors with ties, sign-bit words, +inf tail;
    ``nq`` queries."""
    rows = rng.integers(0, 2**32, size=(2 * g + 8, kw), dtype=np.uint64)
    rows[:, 0] %= max(1, g // 3)
    rows[: g // 2, 0] |= 1 << 31
    rows = np.unique(rows.astype(np.uint32), axis=0)[: g - g // 5]
    a = np.full((g, kw), 0xFFFFFFFF, np.uint32)
    a[: len(rows)] = rows
    q = rng.integers(0, 2**32, size=(nq, kw), dtype=np.uint64).astype(np.uint32)
    q[:100] = rows[rng.integers(0, len(rows), 100)]
    q[100] = 0
    q[101] = 0xFFFFFFFF  # at the +inf tail
    q[102] = rows[-1]
    q[102, -1] += np.uint32(1)  # past the last real anchor
    q[103] = 0xFFFFFFFF
    q[103, -1] = 0xFFFFFFFE  # the largest key below +inf
    return a, q


# G not a multiple of the sample stride, and G beyond the main path's
# 32,768, where the stride doubles past one line
@pytest.mark.parametrize("g", [1, 5, 17, 513, 5000, 100_003, 262_144, 1 << 20])
def test_anchor_kernels_match_plain(card, g):
    """Both of the kernel's searches: a warp per query (300 queries) and
    the shared-memory sample (enough queries for every SM to sample)."""
    rng = np.random.default_rng(g)
    many = TA.SAMPLE_MIN_QUERIES_PER_SM * sm_count(torch.empty(0, device=card)) + 5
    for kw in (1, 2, 3):
        for nq in (300, many):
            a, q = sorted_anchors(rng, g, kw, nq)
            ta, tq = as_words(a, card), as_words(q, card)
            n0 = TA.anchor_search.launches
            got = TA.anchor_search(ta, tq)
            assert TA.anchor_search.launches == n0 + 1
            assert torch.equal(got, TA.anchor_search_plain(ta, tq))
            assert torch.equal(TA.anchor_le_count(ta, tq), TA.anchor_le_count_plain(ta, tq))


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_selector_decode_matches_plain(card, d):
    rng = np.random.default_rng(d)
    for r in sorted({1, min(d, 16), d // 4 or 1}):
        for dtype in (np.uint8, np.int32):
            sel = rng.integers(0, r + 2, (300, d)) | (rng.integers(0, 2, (300, d)) << 7)
            sel[rng.random((300, d)) < 0.2] = 127
            cur = rng.integers(0, 1 << 20, (300, r)).astype(np.int32)
            ts = torch.from_numpy(sel.astype(dtype)).to(card)
            tc = torch.from_numpy(cur).to(card)
            n0 = TS.selector_decode.launches
            got = TS.selector_decode(ts, tc)
            assert TS.selector_decode.launches == n0 + 1
            for x, y in zip(got, TS.selector_decode_plain(ts, tc)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_selector_decode_rows_match_plain(card, d):
    """Group ids into (G, D) / (G, R) tables: repeated and unordered ids,
    all-pad rows, runids >= R (no cursor, no count) and runid 127; 1,200
    rows (a row group per warp) and 40,000 (more than the card holds at
    once: four per warp)."""
    rng = np.random.default_rng(100 + d)
    g = 500
    for r, n in [(r, 1200) for r in sorted({1, min(d, 16), d // 4 or 1})] + [(min(d, 8), 40_000)]:
        for dtype in (np.uint8, np.int32):
            sel = rng.integers(0, r + 3, (g, d)) | (rng.integers(0, 2, (g, d)) << 7)
            sel[rng.random((g, d)) < 0.05] = 255
            sel[rng.random((g, d)) < 0.2] = 127
            sel[::9] = 127
            cur = rng.integers(0, 1 << 20, (g, r)).astype(np.int32)
            rows = np.concatenate([rng.integers(0, g, n - g), np.arange(g)[::-1]])
            ts = torch.from_numpy(sel.astype(dtype)).to(card)
            tc = torch.from_numpy(cur).to(card)
            tr = torch.from_numpy(rows.astype(np.int32)).to(card)
            n0 = TS.selector_decode.launches
            got = TS.selector_decode(ts, tc, rows=tr)
            assert TS.selector_decode.launches == n0 + 1
            for x, y in zip(got, TS.selector_decode_plain(ts, tc, rows=tr)):
                assert torch.equal(x, y)


def _ttl_partition(rng, domain, vw, d, dev, n=1500, runs=4):
    """A partition of ``runs`` overlapping tables of ``n`` keys from
    ``domain`` with tombstones, TTL expiries at 90, 100 and 110 and an
    excised span, on ``dev``."""
    from repro_torch.db.partition import Partition, Table

    tables = []
    for i in range(runs):
        keys = np.sort(rng.choice(domain, n, replace=False))
        exp = np.where(rng.random(n) < 0.2, rng.choice([90, 100, 110], n), 0)
        tables.append(Table(
            keys=keys, seq=(np.arange(n) + i * n + 1).astype(np.uint32),
            vals=rng.integers(0, 2**32, (n, vw), dtype=np.uint64).astype(np.uint32),
            tomb=rng.random(n) < 0.05, exp=exp.astype(np.uint32)))
    p = Partition(0, tables, d=d, device=dev)
    p.attach_excised(int(domain[100]), int(domain[300]), seq=10**6)
    return p


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_get_resolve_matches_plain(card, d):
    """get_resolve against its plain version on a partition's device views,
    bit for bit on all outputs: VW 1, 30 and 250 (and the index tier's
    1-word dummy values); 8 to 65,536 queries as get_batch uploads them,
    padded to a power of two with key 0, with keys past the last one, at
    ``now`` = 100, where some rows expire exactly."""
    from repro_torch.kernels import device_view as DV

    rng = np.random.default_rng(200 + d)
    domain = np.arange(1, 5000, dtype=np.uint64) * np.uint64(977)
    mgr = DV.DeviceViewManager(1 << 30, device=card)
    edges = np.array([0, 2**64 - 1, domain[-1] + 1], np.uint64)
    found = []
    for vw in (1, 30, 250):
        p = _ttl_partition(rng, domain, vw, d, card)
        for with_vals in (True, False) if vw == 30 else (True,):
            remix, runset, exp = p.device_index(with_vals=with_vals)
            assert runset.vw == (vw if with_vals else 1)
            sel = remix.selectors.reshape(remix.g, remix.d)
            for qn in (8, 64, 256, 65_536):
                keys = np.concatenate([domain[rng.integers(0, len(domain), qn - 5)], edges])
                tq = mgr._queries(keys)
                assert tq.shape[0] == qn
                g = TA.anchor_search(remix.anchors, tq)
                args = (tq, g, *TS.selector_decode(sel, remix.cursors, rows=g), runset.keys,
                        runset.vals, runset.tomb, exp, sel, remix.cursors, 100)
                n0 = TG.get_resolve.launches
                got = TG.get_resolve(*args)
                assert TG.get_resolve.launches == n0 + 1
                want = TG.get_resolve_plain(*args)
                assert got.shape == (qn, 3 + runset.vw)
                assert torch.equal(got, want), (vw, with_vals, qn)
                found.append(want[:, 0].cpu())
    found = torch.cat(found)
    assert bool(found.any()) and not bool(found.all())


def test_get_batch_is_three_launches_and_one_sync(card):
    """One full-tier get_batch: one launch each of anchor_search,
    selector_decode and get_resolve, at most 20 aten ops, one result
    fetch and no other synchronisation; the CPU's answers."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import device_view as DV

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    domain = np.arange(1, 5000, dtype=np.uint64) * np.uint64(977)
    keys = domain[np.random.default_rng(8).integers(0, len(domain), 200)]
    answers = []
    for dev in ("cpu", card):
        p = _ttl_partition(np.random.default_rng(7), domain, 30, 32, dev)
        mgr = DV.DeviceViewManager(1 << 30, device=dev)
        v = mgr.view_for(p)
        assert v.tier == "full"
        answers.append(mgr.get_batch(v, keys, 100))  # the card's builds the library
    launches = lambda: (TA.anchor_search.launches, TS.selector_decode.launches,  # noqa: E731
                        TG.get_resolve.launches)
    n0, s0 = launches(), DV.SYNCS
    torch.cuda.set_sync_debug_mode("error")
    try:
        with Ops() as ops:
            found, vals = mgr.get_batch(v, keys, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tuple(b - a for a, b in zip(n0, launches())) == (1, 1, 1)
    assert len(ops.names) <= 20, ops.names
    assert DV.SYNCS - s0 == 1
    for f, x in answers:
        np.testing.assert_array_equal(found, f)
        np.testing.assert_array_equal(vals, x)
    assert found.any() and not found.all()


def _six_views(dev):
    """A manager on ``dev`` and six VW-30 views (3 tables of 800 keys, D 32)
    with their keys: one key, 8, 9, 16, 200 and 256 (power-of-two segments
    and ones just past)."""
    from repro_torch.kernels import device_view as DV

    rng = np.random.default_rng(21)
    domain = np.arange(1, 3000, dtype=np.uint64) * np.uint64(977)
    mgr = DV.DeviceViewManager(1 << 30, device=dev)
    views = [mgr.view_for(_ttl_partition(rng, domain, 30, 32, dev, n=800, runs=3))
             for _ in range(6)]
    keys = [domain[rng.integers(0, len(domain), n)] for n in (1, 8, 9, 16, 200, 256)]
    return mgr, views, keys


def test_grouped_get_is_one_sync_and_three_launches_a_view(card):
    """Six views in one get_batch under the sync debug mode ``error``: one
    result fetch, each kernel launched once a view; the answers of six
    one-view calls and of the CPU, bit for bit."""
    from repro_torch.kernels import device_view as DV

    cpu_mgr, cpu_views, keys = _six_views("cpu")
    want = cpu_mgr.get_batch(cpu_views, keys, 100)
    mgr, views, _ = _six_views(card)
    mgr.get_batch(views[0], keys[0], 100)  # builds the library
    launches = lambda: (TA.anchor_search.launches, TS.selector_decode.launches,  # noqa: E731
                        TG.get_resolve.launches)
    n0, s0 = launches(), DV.SYNCS
    torch.cuda.set_sync_debug_mode("error")
    try:
        found, vals = mgr.get_batch(views, keys, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tuple(b - a for a, b in zip(n0, launches())) == (6, 6, 6)
    assert DV.SYNCS - s0 == 1
    each = [mgr.get_batch(v, k, 100) for v, k in zip(views, keys)]
    for got, one, cpu in zip((found, vals), zip(*each), want):
        np.testing.assert_array_equal(got, np.concatenate(one))
        np.testing.assert_array_equal(got, cpu)
    assert found.any() and not found.all()


def test_grouped_get_reads_the_same_kernel_work_on_card(card):
    """The roofline readers' hooks (``perfbench.devtrace.KernelCalls``)
    record the same (anchors, Q) pairs and decode shapes for six views in
    one get_batch as for six one-view calls."""
    from perfbench.devtrace import KernelCalls

    mgr, views, keys = _six_views(card)
    seen = []
    for grouped in (True, False):
        with KernelCalls() as kc:
            if grouped:
                mgr.get_batch(views, keys, 100)
            else:
                for v, k in zip(views, keys):
                    mgr.get_batch(v, k, 100)
        seen.append(([(id(a), q.shape[0]) for a, q in kc.anchor], kc.decode))
    assert seen[0] == seen[1] and len(seen[0][0]) == 6


def test_device_view_on_card_matches_cpu(card):
    """The same partition answered on the card (kernels) and on the CPU
    (plain versions), with one sync per batch on the card."""
    from repro_torch.db.partition import Partition, Table
    from repro_torch.kernels import device_view as DV

    rng = np.random.default_rng(3)
    domain = np.arange(1, 5000, dtype=np.uint64) * np.uint64(977)
    tables = []
    for i in range(4):
        keys = np.sort(rng.choice(domain, 1500, replace=False))
        exp = np.where(rng.random(1500) < 0.2, rng.choice([90, 110], 1500), 0)
        tables.append(dict(
            keys=keys, seq=(np.arange(1500) + i * 1500 + 1).astype(np.uint32),
            vals=rng.integers(0, 2**32, (1500, 4), dtype=np.uint64).astype(np.uint32),
            tomb=rng.random(1500) < 0.05, exp=exp.astype(np.uint32)))
    q = domain[rng.integers(0, len(domain), 256)]
    answers = []
    for dev in ("cpu", card):
        p = Partition(0, [Table(**t) for t in tables], d=32, device=dev)
        p.attach_excised(int(domain[100]), int(domain[300]), seq=10**6)
        mgr = DV.DeviceViewManager(1 << 30, device=dev)
        v = mgr.view_for(p)
        s0 = DV.SYNCS
        answers.append((mgr.get_batch(v, q, 100),
                        mgr.scan_windows(v, q[:64], 75, 100)))
        assert DV.SYNCS - s0 == 2
    (fa, va), rows_a = answers[0]
    (fb, vb), rows_b = answers[1]
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(va, vb)
    for (ka, xa), (kb, xb) in zip(rows_a, rows_b):
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(xa, xb)


def test_index_tier_on_card_matches_cpu(card, tmp_path):
    """A file-backed partition under a budget that only its index view
    fits: the same answers on the card and on the CPU, no value byte read
    at upload, one sync per get and per scan without values, one per
    4-query slice of a scan with values."""
    from repro_torch.core.keys import pack_u64
    from repro_torch.db.partition import Partition, Table
    from repro_torch.io import BlockCache, Storage
    from repro_torch.kernels import device_view as DV

    rng = np.random.default_rng(5)
    domain = np.arange(1, 6000, dtype=np.uint64) * np.uint64(977)
    storage = Storage(str(tmp_path))
    names = []
    for i in range(4):
        keys = np.sort(rng.choice(domain, 2000, replace=False))
        exp = np.where(rng.random(2000) < 0.2, rng.choice([90, 110], 2000), 0)
        names.append(storage.write_table(
            pack_u64(keys),
            rng.integers(0, 2**32, (2000, 4), dtype=np.uint64).astype(np.uint32),
            (np.arange(2000) + i * 2000 + 1).astype(np.uint32),
            rng.random(2000) < 0.05, exp=exp.astype(np.uint32)))
    q = domain[rng.integers(0, len(domain), 256)]
    answers = []
    for dev in ("cpu", card):
        tables = [Table.from_file(storage.table_path(n)) for n in names]
        cache = BlockCache(1 << 20)
        for t in tables:
            t.attach_cache(cache)
        p = Partition(0, tables, d=32, device=dev)
        p.attach_excised(int(domain[100]), int(domain[300]), seq=10**6)
        budget = (p.device_view_bytes(True) + p.device_view_bytes(False)) // 2
        mgr = DV.DeviceViewManager(budget, slice_width=4, device=dev)
        v = mgr.view_for(p)
        assert v.tier == "index"
        assert sum(t._rd().bytes_read["vals"] for t in tables) == 0
        s0 = DV.SYNCS
        got = mgr.get_batch(v, q, 100)
        assert DV.SYNCS - s0 == 1
        rows = mgr.scan_windows(v, q[:30], 75, 100)
        assert DV.SYNCS - s0 == 1 + 8
        keys_only = mgr.scan_windows(v, q[:30], 75, 100, with_vals=False)
        assert DV.SYNCS - s0 == 1 + 8 + 1
        answers.append((got, rows, keys_only))
    (fa, va), rows_a, ko_a = answers[0]
    (fb, vb), rows_b, ko_b = answers[1]
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(va, vb)
    for (ka, xa), (kb, xb), (kc, _) in zip(rows_a, rows_b, ko_b):
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ka, kc)


def test_store_on_card_matches_cpu(card, tmp_path):
    """A small RemixDB on the card (``device_path="auto"``: device views)
    and one on the CPU take the same op stream and answer alike; the card
    store reads through its views."""
    from repro_torch.db import clock
    from repro_torch.db.compaction import CompactionConfig
    from repro_torch.db.store import RemixDB, RemixDBConfig

    clock.set_source(lambda: 1_000_000.0)
    try:
        stores = []
        for dev in ("cpu", card):
            cfg = RemixDBConfig(vw=4, memtable_entries=2048, device=str(dev),
                                compaction=CompactionConfig(table_cap=1024, t_max=4))
            stores.append(RemixDB.open(str(tmp_path / str(dev)), cfg))
        rng = np.random.default_rng(9)
        for _ in range(12):
            keys = rng.integers(0, 1 << 30, 1500).astype(np.uint64)
            vals = rng.integers(0, 2**32, (1500, 4), dtype=np.uint64).astype(np.uint32)
            dels = rng.choice(keys, 20)
            for db in stores:
                db.put_batch(keys, vals, ttl=None)
                for k in dels.tolist():
                    db.delete(k)
        for db in stores:
            db.delete_range(1 << 28, 1 << 29)
            db.flush()
        cpu, gpu = stores
        assert gpu.device_views is not None and cpu.device_views is None
        q = rng.integers(0, 1 << 30, 4096).astype(np.uint64)
        fa, va = cpu.get_batch(q)
        fb, vb = gpu.get_batch(q)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(va[fa], vb[fb])
        starts = np.sort(rng.integers(0, 1 << 30, 64)).astype(np.uint64)
        ka, ma = cpu.scan_batch(starts, 50)
        kb, mb = gpu.scan_batch(starts, 50)
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(ka[ma], kb[mb])
        for s in starts[:4].tolist():
            for x, y in zip(cpu.scan(s, 30), gpu.scan(s, 30)):
                np.testing.assert_array_equal(x, y)
        assert len(gpu.device_views) > 0
        assert gpu.registry.counter("device_batches").value > 0
        for db in stores:
            db.close()
        # reopened: REMIX files recovered into host memory, then a flush
        # whose compaction extends them and moves them to the card
        stores = [RemixDB.open(str(tmp_path / str(dev)), RemixDBConfig(
            vw=4, memtable_entries=2048, device=str(dev),
            compaction=CompactionConfig(table_cap=1024, t_max=4)))
            for dev in ("cpu", card)]
        keys = rng.integers(0, 1 << 30, 1500).astype(np.uint64)
        vals = rng.integers(0, 2**32, (1500, 4), dtype=np.uint64).astype(np.uint32)
        for db in stores:
            db.put_batch(keys, vals)
            db.flush()
        cpu, gpu = stores
        assert gpu.partitions[0].device.type == "cuda"
        q = np.concatenate([q, keys[:512]])
        fa, va = cpu.get_batch(q)
        fb, vb = gpu.get_batch(q)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(va[fa], vb[fb])
        ka, ma = cpu.scan_batch(starts, 50)
        kb, mb = gpu.scan_batch(starts, 50)
        np.testing.assert_array_equal(ka[ma], kb[mb])
        for db in stores:
            db.close()
    finally:
        clock.reset()


def test_cluster_on_card_matches_cpu(card, tmp_path):
    """A 2-shard Cluster on the card and one on the CPU take the same op
    stream, a live split and a merge back; they answer alike at every step,
    and the card fleet reads through its shards' device views."""
    from repro_torch.cluster import Cluster
    from repro_torch.db.compaction import CompactionConfig
    from repro_torch.db.store import RemixDBConfig

    fleets = [Cluster(str(tmp_path / f"fleet{i}"), lows=(0, 1 << 29), config=RemixDBConfig(
        vw=4, memtable_entries=2048, device=str(dev),
        compaction=CompactionConfig(table_cap=1024, t_max=4)))
        for i, dev in enumerate(("cpu", card))]
    rng = np.random.default_rng(11)
    q = rng.integers(0, 1 << 30, 4096).astype(np.uint64)
    starts = np.sort(rng.integers(0, 1 << 30, 64)).astype(np.uint64)

    def same():
        (fa, va), (fb, vb) = (c.get_batch(q) for c in fleets)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(va[fa], vb[fb])
        (ka, ma), (kb, mb) = (c.scan_batch(starts, 50) for c in fleets)
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(ka[ma], kb[mb])

    try:
        for _ in range(8):
            keys = rng.integers(0, 1 << 30, 1500).astype(np.uint64)
            vals = rng.integers(0, 2**32, (1500, 4), dtype=np.uint64).astype(np.uint32)
            for c in fleets:
                c.put_batch(keys, vals)
        for c in fleets:
            c.delete_range(1 << 27, 1 << 28)
            c.flush()
        q[:2048] = rng.choice(keys, 2048)
        same()
        at = [c.split(3 << 28)["at"] for c in fleets]
        assert at[0] == at[1] and fleets[1].lows == fleets[0].lows
        same()
        for c in fleets:
            c.put_batch(keys[:500], vals[:500] ^ np.uint32(1))
        same()
        for c in fleets:
            c.merge(at[0])
        assert fleets[0].lows == fleets[1].lows == [0, 1 << 29]
        same()
        gpu = fleets[1].serve.shards
        assert all(db.device.type == "cuda" and db.device_views is not None for db in gpu)
        assert sum(db.registry.counter("device_batches").value for db in gpu) > 0
    finally:
        for c in fleets:
            c.close()


def _held_after_close(card, root, release: bool) -> tuple[int, int, int]:
    """Device bytes a store holds while open, after ``close()`` and
    ``del`` with the cyclic collector off, and after ``gc.collect()``.
    ``release=False`` runs ``close()`` as the reference's does: views and
    indexes are not released."""
    import gc

    from repro_torch.db.compaction import CompactionConfig
    from repro_torch.db.partition import Partition
    from repro_torch.db.store import RemixDB, RemixDBConfig
    from repro_torch.kernels.device_view import DeviceViewManager

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    saved = Partition.release_device, DeviceViewManager.clear
    if not release:
        Partition.release_device = DeviceViewManager.clear = lambda self: None
    gc.disable()
    try:
        db = RemixDB(RemixDBConfig(
            vw=4, memtable_entries=1 << 30, wal_dir=str(root), device=str(card),
            compaction=CompactionConfig(table_cap=4096, t_max=6)))
        keys = np.arange(20_000, dtype=np.uint64) * 11
        db.put_batch(keys, np.zeros((len(keys), 4), np.uint32))
        db.flush()
        db.get_batch(keys[::7])
        db.scan_batch(keys[::997], 50)
        for p in db.partitions:
            p.index()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(card) - base
        db.close()
        del db, p
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated(card) - base
    finally:
        gc.enable()
        Partition.release_device, DeviceViewManager.clear = saved
    gc.collect()
    torch.cuda.synchronize()
    return held, left, torch.cuda.memory_allocated(card) - base


def test_close_frees_device_memory_without_gc(card, tmp_path):
    """After ``RemixDB.close()`` and ``del``, ``memory_allocated`` is back
    at its base with no ``gc.collect()``: close() drops the views and each
    partition's device index and moves its last built REMIX to the host.

    A divergence kept on record: the reference's ``close()`` releases
    neither, and a store sits in reference cycles, so its device memory
    waits for the collector. The same store closed that way holds its
    memory past ``del`` until ``gc.collect()`` (asserted below)."""
    _held_after_close(card, tmp_path / "warm", True)  # lazy one-time buffers
    held, left, _ = _held_after_close(card, tmp_path / "port", True)
    assert held > 0 and left == 0, (held, left)
    held, left, after_gc = _held_after_close(card, tmp_path / "ref", False)
    assert left > 0 and after_gc == 0, (held, left, after_gc)


def test_baselines_on_card_match_cpu(card):
    """The merging iterator, the bloom probe and both baseline stores on
    the card answer as on the CPU, bit for bit."""
    from repro_torch.core import merge_iter as M
    from repro_torch.core.bloom import bloom_maybe_contains, build_bloom
    from repro_torch.core.runs import make_run, stack_runs
    from repro_torch.db.baseline import BaselineConfig, LeveledStore, TieredStore

    rng = np.random.default_rng(5)
    runs = {}
    for dev in ("cpu", card):
        rr = np.random.default_rng(6)
        runs[str(dev)] = [make_run(np.sort(rr.choice(1 << 20, 5000, replace=False)
                                           .astype(np.uint64) << np.uint64(33)),
                                   seq=i, tomb=rr.random(5000) < 0.1, device=dev)
                          for i in range(6)]
    q = (rng.integers(0, 1 << 20, 2048).astype(np.uint64) << np.uint64(33))
    qw = np.stack([(q >> np.uint64(32)).astype(np.uint32), (q & np.uint64(0xFFFFFFFF))
                   .astype(np.uint32)], 1)
    out = {}
    for dev, rr in runs.items():
        rs, qt = stack_runs(rr), as_words(qw, dev)
        bf = build_bloom([r.keys for r in rr], device=dev)
        out[dev] = [t.cpu() for t in (M.seek_cursors(rs, qt), *M.merge_get(rs, qt),
                                      *M.merge_scan(rs, qt[:256], 64),
                                      bloom_maybe_contains(bf, qt))]
    for a, b in zip(out["cpu"], out[str(card)]):
        assert torch.equal(a, b)
    for cls in (LeveledStore, TieredStore):
        stores = [cls(BaselineConfig(memtable_entries=4096, table_cap=4096,
                                     device=str(dev))) for dev in ("cpu", card)]
        keys = rng.permutation(40_000).astype(np.uint64) * 8
        for s in stores:
            for c in range(0, len(keys), 4096):
                s.put_batch(keys[c:c + 4096], np.zeros((4096, 2), np.uint32)[: len(keys[c:c + 4096])])
            s.put(int(keys[3]) + 1, np.ones(2, np.uint32))
        probe = np.concatenate([keys[:1000], keys[:1000] + 1])
        a, b = (s.get_batch(probe) for s in stores)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        a, b = (s.scan_batch(keys[:64], 50) for s in stores)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert stores[1].table_bytes_written == stores[0].table_bytes_written


FAMILY_ARCHS = ["qwen2.5-3b", "minicpm3-4b", "qwen3-moe-235b-a22b", "mamba2-130m",
                "zamba2-2.7b", "seamless-m4t-medium", "gemma2-27b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_llm_family_on_card_matches_cpu(card, arch):
    """A forward and two decode steps of one arch per family, float32, on
    the card against the CPU: 1e-3 absolute on logits (|logits| ~1.5; the
    card's float32 matmuls sum in another order)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as LM
    from repro_torch.models.layers import split_params, tree_map

    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=2), dtype="float32")
    params = split_params(LM.init_params(cfg, 0, device="cpu"))[0]
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))
    batch = dict(tokens=tokens)
    if cfg.family == "encdec":
        batch["frontend"] = torch.as_tensor(rng.normal(size=(2, 16, cfg.d_model)), dtype=torch.float32)
    out = {}
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev), params)
        logits = [LM.forward(cfg, p, {k: v.to(dev) for k, v in batch.items()})]
        cache = LM.init_cache(cfg, 2, 8, dtype=torch.float32, device=dev)
        for pos in range(2):
            lg, cache = LM.decode_step(cfg, p, cache, tokens[:, pos].to(dev), pos)
            logits.append(lg)
        out[str(dev)] = [t.cpu() for t in logits]
    for a, b in zip(out["cpu"], out[str(card)]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_serve_engine_on_card(card):
    """The engine on the card: identical tokens with and without the
    prefix cache, and the CPU engine's tokens (float32)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as LM
    from repro_torch.models.kvcache import PrefixCache
    from repro_torch.models.layers import split_params
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(
        reduced(get_config("qwen2.5-3b"), n_layers=2, d_model=128, d_ff=256, vocab=64),
        dtype="float32")
    params = split_params(LM.init_params(cfg, 2, device="cpu"))[0]
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 8).astype(np.int32)])
               for _ in range(3)]
    outs = []
    for dev, cached in (("cpu", False), (card, False), (card, True)):
        pc = PrefixCache(cfg, n_pages=64, page_size=8, device=dev) if cached else None
        eng = ServeEngine(cfg, params, max_seq=96, prefix_cache=pc, device=dev)
        outs.append([eng.generate(p, max_new=8) for p in prompts])
    assert eng.stats.cached_tokens > 0 and pc.pool_k.device.type == "cuda"
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_page_table_on_card_matches_cpu(card):
    from repro_torch.models.kvcache import RemixPageTable

    tables = [RemixPageTable(d=8, device=dev) for dev in ("cpu", card)]
    rng = np.random.default_rng(5)
    keys = []
    for _ in range(12):  # past max_runs: tiered merges
        for _ in range(40):
            h = int(rng.integers(0, 2**63))
            slot, ln = int(rng.integers(0, 1000)), int(rng.integers(1, 100))
            keys.append(h)
            for t in tables:
                t.add(np.uint64(h), slot, ln)
        for t in tables:
            t.flush_generation()
    probes = np.array(keys[::3] + [1, 2, 3], np.uint64)
    for a, b in zip(*(t.lookup_batch(probes) for t in tables)):
        np.testing.assert_array_equal(a, b)


def test_train_loss_and_grads_on_card_match_cpu(card):
    """qwen2.5-3b at its published widths cut to 2 layers, float32
    activations: the loss and every grad leaf on the card against the CPU.
    Both sum their float32 GEMMs in their own order (no TF32): loss 1e-4
    absolute, each leaf 1e-4 relative (Frobenius)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as LM
    from repro_torch.models.layers import split_params, tree_map
    from repro_torch.train.optimizer import flat_leaves

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2, dtype="float32")
    params = split_params(LM.init_params(cfg, 0, device="cpu"))[0]
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (1, 16)), dtype=torch.int32)
             for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        loss = LM.loss_fn(cfg, p, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, flat_leaves(p))
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out[str(card)]
    assert abs(lc - lg) <= 1e-4, (lc, lg)
    for a, b in zip(gc, gg):
        assert bool(torch.isfinite(b).all())
        assert float((a - b).norm() / a.norm().clamp(min=1e-30)) <= 1e-4


def test_data_pipeline_on_card_equals_cpu(card):
    from repro_torch.data.pipeline import DataPipeline

    for shard in (0, 1):
        kw = dict(vocab=151936, batch=8, seq=128, seed=3, shard_index=shard, shard_count=2)
        cpu = DataPipeline(**kw, device="cpu")
        dev = DataPipeline(**kw, device=str(card))
        for step in (0, 7):
            a, b = cpu.get_batch(step), dev.get_batch(step)
            assert b["tokens"].device.type == "cuda"
            for k in ("tokens", "labels"):
                assert torch.equal(a[k], b[k].cpu())


def test_checkpoint_on_card_round_trips(card, tmp_path):
    """A tree on the card crosses the pinned staging buffer both ways: the
    files equal those written from the same tree on the CPU, and the
    restore puts every leaf back on the card bit for bit."""
    import zipfile

    from repro_torch.train import checkpoint as C

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 5, 7, generator=g), "b": {"c": torch.randn(11, generator=g)}}
    opt = {"mu": {"w": torch.randn(3, 5, 7, generator=g).bfloat16()},
           "step": torch.tensor(4, dtype=torch.int32)}
    on_card = [{k: (v.to(card) if isinstance(v, torch.Tensor) else
                    {j: u.to(card) for j, u in v.items()}) for k, v in t.items()}
               for t in (params, opt)]
    C.save(str(tmp_path / "cpu"), 1, params, opt)
    C.save(str(tmp_path / "card"), 1, *on_card)
    with zipfile.ZipFile(tmp_path / "cpu" / "step_1" / "arrays.npz") as a, \
            zipfile.ZipFile(tmp_path / "card" / "step_1" / "arrays.npz") as b:
        assert a.namelist() == b.namelist()
        assert all(a.read(n) == b.read(n) for n in a.namelist())
    rp, ro, _ = C.restore(str(tmp_path / "card"), device=str(card))
    assert rp["w"].is_cuda and ro["mu"]["w"].dtype == torch.bfloat16
    assert torch.equal(rp["w"].cpu(), params["w"]) and torch.equal(rp["b"]["c"].cpu(), params["b"]["c"])
    assert torch.equal(ro["mu"]["w"].cpu(), opt["mu"]["w"]) and int(ro["step"]) == 4


def test_kernels_bench_on_card(card, tmp_path):
    """``kernels_bench.run(tiny=True)`` on the card: both kernels launch in
    the micro rows and on the device path, one sync per batch, the device
    and legacy paths agree (asserted inside), and the JSON names the card."""
    from repro_torch.bench import common, kernels_bench

    before = (TA.anchor_search.launches, TS.selector_decode.launches)
    record = kernels_bench.run(common.CSV(), tiny=True, json_path=str(tmp_path / "k.json"),
                               device=str(card))
    assert TA.anchor_search.launches > before[0] and TS.selector_decode.launches > before[1]
    assert record["pipeline"]["backend"] == "cuda"
    assert record["pipeline"]["syncs_per_batch"] == 1.0
    assert record["card"].startswith("NVIDIA")
