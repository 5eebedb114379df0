"""Cold-start query cost: block cache + partial loads vs whole-table loads.

The port of ``benchmarks/cache_bench.py``. A persistent store is built on
disk (R tables x N entries + REMIX + manifest), then reopened two ways and
hit with the *first* query after recovery:

  - ``whole``  (``cold_reads=False``): the first query materializes the
    partition's RunSet on the store's device, loading every section of
    every table;
  - ``cold``   (default): anchors binary search + bounded CKB restart-
    point seeks + single value/tomb block fetches through the shared
    LRU :class:`repro_torch.io.blockcache.BlockCache`.

Reported per path: first-query latency, physical bytes read
(``store.disk_bytes_read()``, cache hits excluded) and the cache
hit/miss counters from ``store.stats()``. The acceptance bar is that a
cold point query reads < 10 % of the bytes the whole-table path reads.

``python -m repro_torch.bench.cache_bench [--device cpu]`` or
``python -m repro_torch.bench.run --only cache``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.bench.common import CSV
from repro_torch.core.remix import build_remix
from repro_torch.core.runs import make_run
from repro_torch.db.store import RemixDB, RemixDBConfig
from repro_torch.db.wal import WAL
from repro_torch.device import u32_np
from repro_torch.io.manifest import Storage

R_TABLES = 8
N_PER_TABLE = 1 << 17
D = 32
MAX_COLD_FRACTION = 0.10  # acceptance bar for a cold point query


def build_store(
    root: str,
    seed: int = 0,
    r_tables: int = R_TABLES,
    n_per_table: int = N_PER_TABLE,
    d: int = D,
) -> np.ndarray:
    """A committed single-partition store on disk; returns its key domain.

    The files are written on the host; a store opened over them puts its
    index on the device its config names."""
    rng = np.random.default_rng(seed)
    total = r_tables * n_per_table
    domain = np.arange(1, total + 1, dtype=np.uint64) * 64
    owner = rng.integers(0, r_tables, total)
    storage = Storage(root)
    names, runs, seqbase = [], [], 1
    for i in range(r_tables):
        kk = domain[owner == i]
        run = make_run(
            kk, seq=np.arange(seqbase, seqbase + len(kk), dtype=np.uint32),
            device="cpu",
        )
        seqbase += len(kk)
        runs.append(run)
        names.append(
            storage.write_table(
                u32_np(run.keys), u32_np(run.vals), u32_np(run.seq),
                run.tomb.numpy(),
            )
        )
    remix, _ = build_remix(runs, d=d)
    xname = storage.write_remix(remix)
    wal = WAL(storage.wal_path())
    storage.commit(
        dict(
            seq=seqbase, vw=2, d=d,
            partitions=[dict(lo=0, tables=names, remix=xname)],
            wal=wal.save_state(),
        )
    )
    return domain


def _first_get(root: str, key: int, cold: bool, device):
    db = RemixDB.open(root, RemixDBConfig(cold_reads=cold, device=device))
    t0 = time.perf_counter()
    val = db.get(key)
    dt = time.perf_counter() - t0
    return db, val, dt, db.disk_bytes_read()


def run(csv: CSV, device="cuda") -> None:
    with tempfile.TemporaryDirectory(prefix="cache-bench-") as tmp:
        root = os.path.join(tmp, "db")
        domain = build_store(root, r_tables=R_TABLES, n_per_table=N_PER_TABLE)
        file_bytes = sum(
            os.path.getsize(os.path.join(root, "tables", f))
            for f in os.listdir(os.path.join(root, "tables"))
        )
        probe = int(domain[len(domain) // 3])

        db_w, v_w, t_whole, b_whole = _first_get(root, probe, False, device)
        db_c, v_c, t_cold, b_cold = _first_get(root, probe, True, device)
        if v_w is None or v_c is None or not np.array_equal(v_w, v_c):
            raise AssertionError(
                f"cold/whole point queries disagree: {v_c} vs {v_w}"
            )
        cache = db_c.stats()["cache"]

        # warm repeat: same partition, different key — counts cache hits
        t0 = time.perf_counter()
        db_c.get(int(domain[len(domain) // 7]))
        t_warm = time.perf_counter() - t0
        b_warm = db_c.disk_bytes_read() - b_cold

        # cold range scan: partial RunSet materialization per block range
        db_s = RemixDB.open(root, RemixDBConfig(device=device))
        t0 = time.perf_counter()
        kk, _ = db_s.scan(int(domain[len(domain) // 2]), 100)
        t_scan = time.perf_counter() - t0
        b_scan = db_s.disk_bytes_read()
        k_ref, _ = db_w.scan(int(domain[len(domain) // 2]), 100)
        if not np.array_equal(kk, k_ref):
            raise AssertionError("cold scan disagrees with whole-table scan")
        for db in (db_w, db_c, db_s):
            db.close()

    frac = b_cold / max(1, b_whole)
    csv.emit(
        "cache_whole_get", t_whole * 1e6,
        f"bytes_read={b_whole};table_file_bytes={file_bytes}",
    )
    csv.emit(
        "cache_cold_get", t_cold * 1e6,
        f"bytes_read={b_cold};fraction_of_whole={frac:.4f};"
        f"cache_hits={cache['hits']};cache_misses={cache['misses']};"
        f"cache_evictions={cache['evictions']}",
    )
    csv.emit("cache_warm_get", t_warm * 1e6, f"extra_bytes_read={b_warm}")
    csv.emit(
        "cache_cold_scan100", t_scan * 1e6,
        f"bytes_read={b_scan};fraction_of_whole={b_scan / max(1, b_whole):.4f};"
        f"keys_returned={len(kk)}",
    )
    # the latency ratio is indicative only: the whole-table path's first
    # query also pays the upload to the device, and it runs first so the
    # cold run sees a warmer OS page cache — the byte counts (and the
    # < 10 % assert) are the subsystem's real claim
    csv.emit(
        "cache_summary", 0.0,
        f"r_tables={R_TABLES};n_per_table={N_PER_TABLE};"
        f"cold_get_read_reduction={b_whole / max(1, b_cold):.1f}x;"
        f"first_query_speedup_incl_jit={t_whole / max(t_cold, 1e-9):.1f}x",
    )
    if frac >= MAX_COLD_FRACTION:
        raise AssertionError(
            f"cold point query read {frac:.1%} of the whole-table bytes "
            f"(acceptance bar: < {MAX_COLD_FRACTION:.0%})"
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, device=args.device)
