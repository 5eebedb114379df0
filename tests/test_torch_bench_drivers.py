"""The port's system benchmarks (``repro_torch.bench``: cache, kernels,
batch, cursor, rebuild, scrub) against the reference's (``benchmarks/``),
on the CPU at the reference's ``--tiny`` store size (4 tables x 4,096
entries): the same files on disk, the same answers, bytes read, cache
counters and syncs per batch, the same CSV rows (``kernels``' two renamed
rows mapped). No test here asserts a time or a ratio of times: the pieces
below each ``run()`` are called instead. The ``slow`` cases run the port's
whole ``run()`` with its bars.
"""
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's benchmarks live at the root
    sys.path.insert(0, str(ROOT))

import benchmarks.batch_bench as RB  # noqa: E402
import benchmarks.cache_bench as RCache  # noqa: E402
import benchmarks.common as RC  # noqa: E402
import benchmarks.cursor_bench as RCur  # noqa: E402
import benchmarks.kernels_bench as RK  # noqa: E402
import benchmarks.rebuild_bench as RR  # noqa: E402
import benchmarks.scrub_bench as RS  # noqa: E402
from repro.db.store import RemixDB as RDB  # noqa: E402
from repro.db.store import RemixDBConfig as RCfg  # noqa: E402
from repro.kernels import device_view as RDV  # noqa: E402
from repro_torch.bench import batch_bench as TB  # noqa: E402
from repro_torch.bench import cache_bench as TCache  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import cursor_bench as TCur  # noqa: E402
from repro_torch.bench import kernels_bench as TK  # noqa: E402
from repro_torch.bench import rebuild_bench as TR  # noqa: E402
from repro_torch.bench import scrub_bench as TS  # noqa: E402
from repro_torch.db.store import RemixDB as TDB  # noqa: E402
from repro_torch.db.store import RemixDBConfig as TCfg  # noqa: E402
from repro_torch.kernels import device_view as TDV  # noqa: E402
from torch_twin import assert_same, same_dir_bytes  # noqa: E402

CPU = "cpu"
TINY = dict(r_tables=4, n_per_table=1 << 12)  # every benchmark's --tiny store
# the port's names for the reference's Pallas-interpret rows
RENAMED = {"kernels_anchor_search_pallas_interp": "kernels_anchor_search_cuda",
           "kernels_seek_fused_interp": "kernels_seek_fused"}


def names(csv):
    return [RENAMED.get(r.split(",")[0], r.split(",")[0]) for r in csv.rows]


def fields(row: str, *keys) -> dict:
    """The ``key=value`` fields of a CSV row's derived column."""
    derived = row.split(",", 2)[2].replace(" ", ";")
    got = dict(f.split("=", 1) for f in derived.split(";") if "=" in f)
    return {k: got[k] for k in keys}


def once(fn, *args, **kw) -> float:
    """``time_batched`` without its repeats: times are not compared here."""
    fn(*args)
    return 1e-3


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The reference's and the port's ``build_store`` at the tiny size:
    (reference root, port root, key domain)."""
    base = tmp_path_factory.mktemp("stores")
    ref, port = str(base / "ref"), str(base / "port")
    domain = RCache.build_store(ref, **TINY)
    np.testing.assert_array_equal(TCache.build_store(port, **TINY), domain)
    return ref, port, domain


def test_build_store_writes_the_same_files(stores):
    ref, port, _ = stores
    compared = same_dir_bytes(ref, port)
    assert len(compared) == TINY["r_tables"] + 4  # tables, REMIX, manifest, CURRENT, WAL


@pytest.mark.parametrize("cold", [False, True])
def test_cache_first_get_reads_the_same_bytes(stores, cold):
    """``cache_bench``'s first get after recovery, its warm get and its cold
    scan: the same values, physical bytes and block-cache counters."""
    ref, port, domain = stores
    probe = int(domain[len(domain) // 3])
    rdb, rv, _, rb = RCache._first_get(ref, probe, cold)
    tdb, tv, _, tb = TCache._first_get(port, probe, cold, CPU)
    try:
        np.testing.assert_array_equal(rv, tv)
        assert rb == tb > 0
        if cold:
            assert_same(rdb.stats()["cache"], tdb.stats()["cache"], "cache")
            for db in (rdb, tdb):
                db.get(int(domain[len(domain) // 7]))
            assert rdb.disk_bytes_read() == tdb.disk_bytes_read()
        start = int(domain[len(domain) // 2])
        (rk, rvals), (tk, tvals) = rdb.scan(start, 100), tdb.scan(start, 100)
        np.testing.assert_array_equal(rk, tk)
        np.testing.assert_array_equal(rvals, tvals)
        assert len(tk) == 100
    finally:
        rdb.close(), tdb.close()


def test_kernels_device_pipeline_matches_reference(stores):
    """``kernels_bench``'s device pipeline: the same probe, found masks,
    values and scan windows on the device path (``device_path="on"``, the
    kernels' plain versions here) and the legacy path, one sync per batch
    on both packages."""
    ref, port, domain = stores
    probe = RK._probe(domain, np.random.default_rng(11), RK.BATCH)
    np.testing.assert_array_equal(TK._probe(domain, np.random.default_rng(11), TK.BATCH), probe)
    starts = np.sort(np.random.default_rng(5).choice(domain[:-200], TK.SCAN_Q, replace=False))
    for mode in ("on", "off"):
        rdb = RDB.open(ref, RCfg(cold_reads=False, device_path=mode))
        tdb = TDB.open(port, TCfg(cold_reads=False, device_path=mode, device=CPU))
        try:
            assert_same(rdb.get_batch(probe), tdb.get_batch(probe), f"{mode} get_batch")
            assert_same(rdb.scan_batch(starts, TK.SCAN_N), tdb.scan_batch(starts, TK.SCAN_N),
                        f"{mode} scan_batch")
            if mode == "on":
                r0, t0 = RDV.SYNCS, TDV.SYNCS
                rdb.get_batch(probe), tdb.get_batch(probe)
                assert RDV.SYNCS - r0 == TDV.SYNCS - t0 == 1
                assert len(tdb.device_views) == len(rdb.device_views) == 1
        finally:
            rdb.close(), tdb.close()


def test_kernels_run_rows_json_and_observe(stores, tmp_path, monkeypatch):
    """The port's whole ``kernels_bench.run(tiny=True)`` (no bar of it is a
    time): the reference's rows under the rename map, its JSON keys plus
    ``card``, one sync per batch, and ``observe`` called once with the
    device-path store and the benchmark's batches."""
    ref, _, domain = stores
    for mod in (RK, TK):
        monkeypatch.setattr(mod, "time_batched", once)
    rcsv, tcsv = RC.CSV(), TC.CSV()
    RK.bench_micro(rcsv)
    RK.bench_device_pipeline(ref, domain, rcsv)
    seen = []
    out = str(tmp_path / "k.json")
    record = TK.run(tcsv, tiny=True, json_path=out, device=CPU,
                    observe=lambda tag, stores, batches: seen.append(
                        (tag, sorted(stores), [(label, len(k), n) for label, k, n in batches])))
    assert names(tcsv) == names(rcsv)
    assert seen == [("kernels", ["remixdb"], [("get 256", 256, None), ("scan16 64", 64, 16)])]
    assert record["card"] == "cpu" and record["pipeline"]["backend"] == "cpu"
    assert record["pipeline"]["syncs_per_batch"] == 1.0
    assert set(record) == {"bench", "unix_time", "card", "store", "pipeline"}
    assert set(record["pipeline"]) == {
        "backend", "batch", "syncs_per_batch", "device_get_us_per_key", "host_get_us_per_key",
        "get_speedup", "device_scan_us_per_query", "host_scan_us_per_query",
        "hbm_resident_bytes"}
    assert os.path.exists(out)


def test_batch_cold_engine_matches_reference(stores):
    """``batch_bench`` below its timed bar: the scalar loop and the batched
    get on both packages' cold stores give the same answers, and the
    coalescing, prefetch and CKB-decoder rows carry the same counts."""
    ref, port, domain = stores
    keys = RB._probe(domain, np.random.default_rng(7), 256)
    rdb, tdb = RDB.open(ref, RB._cold_cfg()), TDB.open(port, TB._cold_cfg(CPU))
    try:
        assert all(p.cold_ready() for p in tdb.partitions)
        scalar = TB._scalar_get_loop(tdb, keys)
        assert_same(RB._scalar_get_loop(rdb, keys), scalar, "scalar loop")
        assert_same(scalar, tdb.get_batch(keys), "batched get")
    finally:
        rdb.close(), tdb.close()
    rcsv, tcsv = RC.CSV(), TC.CSV()
    RB.bench_coalescing(ref, domain, rcsv)
    TB.bench_coalescing(port, domain, tcsv, device=CPU)
    RB.bench_prefetch_scan(ref, domain, rcsv)
    TB.bench_prefetch_scan(port, domain, tcsv, device=CPU)
    RB.bench_ckb_decoder(ref, domain, rcsv, strict=False)
    TB.bench_ckb_decoder(port, domain, tcsv, strict=False, device=CPU)
    assert names(tcsv) == names(rcsv)
    assert tcsv.rows[0] == rcsv.rows[0]  # granules, loads, hits
    keys = ("bytes_eager", "bytes_prefetch", "issued", "hits", "waste")
    assert fields(tcsv.rows[1], *keys) == fields(rcsv.rows[1], *keys)
    assert tcsv.rows[2] == rcsv.rows[2]  # bytes with and without the decoder


def test_batch_matrix_and_device_rows(stores):
    """``bench_query_matrix``'s JSON rows and ``bench_device_vs_host``'s CSV
    rows: the same batches, ops and names (their values are times)."""
    ref, port, domain = stores
    rrows = RB.bench_query_matrix(ref, domain)
    trows = TB.bench_query_matrix(port, domain, device=CPU)
    assert [(r["op"], r["batch"], sorted(r)) for r in trows] == [
        (r["op"], r["batch"], sorted(r)) for r in rrows]
    rcsv, tcsv = RC.CSV(), TC.CSV()
    rdev = RB.bench_device_vs_host(ref, domain, rcsv)
    tdev = TB.bench_device_vs_host(port, domain, tcsv, device=CPU)
    assert names(tcsv) == names(rcsv) and sorted(tdev) == sorted(rdev)


@pytest.mark.parametrize("n,interval", [(1, 16), (37, 16), (100, 8), (4096, 16), (5000, 64)])
def test_ckb_interval_decoder_matches_reference(n, interval):
    """The batched cold get's CKB decoder (``CKBReader.decode_intervals``,
    decoded as u64 words in the port) returns the reference's arrays bit
    for bit, the positions past each interval's count included, for all
    intervals at once and for a sample (memoized across calls)."""
    from repro.io import ckb as RCkb
    from repro_torch.core.keys import pack_u64
    from repro_torch.io import ckb as TCkb

    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 2**30, n).astype(np.uint64)
                     * rng.choice([1, 64, 2**20, 2**33], n).astype(np.uint64))
    blob = TCkb.encode_ckb(pack_u64(keys), restart_interval=interval)
    assert blob == RCkb.encode_ckb(pack_u64(keys), restart_interval=interval)
    fetch = lambda lo, hi: blob[lo:hi]  # noqa: E731
    ref, port = RCkb.CKBReader(len(blob), fetch), TCkb.CKBReader(len(blob), fetch)
    every = np.arange(port.n_restarts)
    sample = np.unique(rng.choice(every, min(len(every), 40)))
    for js in (sample, every):
        (rk, rc), (tk, tc) = ref.decode_intervals(js), port.decode_intervals(js)
        assert tk.dtype == rk.dtype and tk.shape == rk.shape
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tc, rc)
    np.testing.assert_array_equal(np.concatenate([tk[i, :tc[i]] for i in range(len(every))]),
                                  keys)


@pytest.mark.parametrize("budget_intervals", [None, 1, 7, 30])
def test_ckb_interval_memo_evicts_as_reference(budget_intervals):
    """The port holds decoded intervals in arrays where the reference holds
    an LRU ``OrderedDict``: over a stream of batches, under each budget,
    the same keys come back, the same intervals stay held and the same
    count is evicted."""
    from repro.io import ckb as RCkb
    from repro_torch.core.keys import pack_u64
    from repro_torch.io import ckb as TCkb

    keys = np.arange(1, 3001, dtype=np.uint64) * 977
    blob = TCkb.encode_ckb(pack_u64(keys), restart_interval=16)
    fetch = lambda lo, hi: blob[lo:hi]  # noqa: E731
    budget = None if budget_intervals is None else budget_intervals * 16
    ref = RCkb.CKBReader(len(blob), fetch, memo_entries=budget)
    port = TCkb.CKBReader(len(blob), fetch, memo_entries=budget)
    rng = np.random.default_rng(3)
    for size in (5, 12, 1, 40, 3, 20, 188, 9, 9, 60):
        js = np.unique(rng.integers(0, 60 if size < 100 else port.n_restarts, size))
        (rk, rc), (tk, tc) = ref.decode_intervals(js), port.decode_intervals(js)
        np.testing.assert_array_equal(tk, rk)
        np.testing.assert_array_equal(tc, rc)
        assert port.memo_stats() == ref.memo_stats()
        held = np.sort(port._iv_owner[port._iv_owner >= 0])
        np.testing.assert_array_equal(held, np.sort(np.array(list(ref._iv), np.int64)))


@pytest.mark.parametrize("label", ["long", "short"])
def test_cursor_and_reseek_rows_match_reference(stores, label):
    """``cursor_bench``'s two streams return the same rows on both packages
    (and the cursor the re-seeking loop's)."""
    ref, port, domain = stores
    total = len(domain)
    length = (total * 3) // 4 if label == "long" else 4 * RCur.CHUNK
    start = int(domain[total // 8])
    rdb, tdb = RDB.open(ref, RCur._cold_cfg()), TDB.open(port, TCur._cold_cfg(CPU))
    try:
        want = RCur._stream_reseek(rdb, start, length)
        assert len(want) == length
        np.testing.assert_array_equal(TCur._stream_reseek(tdb, start, length), want)
        np.testing.assert_array_equal(TCur._stream_cursor(tdb, start, length), want)
        np.testing.assert_array_equal(RCur._stream_cursor(rdb, start, length), want)
    finally:
        rdb.close(), tdb.close()


def test_rebuild_reads_the_same_bytes():
    """``rebuild_bench.run`` on both packages (its bars are bit identity and
    0 value bytes, not times): the same bytes read per section."""
    rcsv, tcsv = RC.CSV(), TC.CSV()
    RR.run(rcsv)
    TR.run(tcsv, device=CPU)
    assert names(tcsv) == names(rcsv)
    assert tcsv.rows[0].split(",")[2] == rcsv.rows[0].split(",")[2]  # scratch bytes
    assert tcsv.rows[1].split(",")[2] == rcsv.rows[1].split(",")[2]  # incremental bytes
    keys = ("n_old_entries", "read_reduction", "bit_identical")
    assert fields(tcsv.rows[2], *keys) == fields(rcsv.rows[2], *keys)
    assert fields(tcsv.rows[2], "bit_identical") == {"bit_identical": "True"}
    assert fields(tcsv.rows[1], "value_bytes_read") == {"value_bytes_read": "0"}


def test_scrub_repair_matches_reference(tmp_path, monkeypatch):
    """``scrub_bench.run`` on both packages (its bars: clean, repaired,
    reads identical): the same files checked, the same findings and
    repairs."""
    monkeypatch.setattr(RS, "tempfile", types.SimpleNamespace(
        mkdtemp=lambda prefix="": str(tmp_path)))  # the reference leaves its dir
    rcsv, tcsv = RC.CSV(), TC.CSV()
    RS.run(rcsv)
    TS.run(tcsv, device=CPU)
    assert names(tcsv) == names(rcsv) == ["scrub_full", "scrub_paced", "repair_remix"]
    assert fields(tcsv.rows[0], "files") == fields(rcsv.rows[0], "files")
    assert fields(tcsv.rows[2], "findings", "repaired") == fields(
        rcsv.rows[2], "findings", "repaired") == {"findings": "1", "repaired": "1"}


@pytest.mark.slow
@pytest.mark.parametrize("name", ["cache", "kernels", "batch", "cursor", "rebuild", "scrub"])
def test_driver_run_with_its_bars(name, tmp_path):
    """The port's whole ``run()`` on the CPU with every bar it asserts
    (``--tiny`` where the benchmark has it; cache, rebuild and scrub at their
    only size)."""
    mod = dict(cache=TCache, kernels=TK, batch=TB, cursor=TCur, rebuild=TR, scrub=TS)[name]
    csv = TC.CSV()
    if name in ("kernels", "batch", "cursor"):
        record = mod.run(csv, tiny=True, json_path=str(tmp_path / "b.json"), device=CPU)
        assert record["card"] == "cpu"
    else:
        mod.run(csv, device=CPU)
    assert csv.rows
