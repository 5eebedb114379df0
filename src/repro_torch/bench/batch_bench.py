"""Batched cold-query engine: vectorized multi-gets vs the scalar loop.

The port of ``benchmarks/batch_bench.py``. The experiment behind the batched query execution layer (paper §3.2–3.3
adapted to block-granular I/O, plus the Fig 10 value-block pipeline):

- **multi-get**: a recovered (cold) store answers a 256-key batch either
  with a Python loop over scalar ``cold_get`` (PR-2 behaviour) or with
  one vectorized ``cold_get_batch`` per partition — anchors binary
  search over the whole batch at once, grouped per-run seeks, and every
  touched (file, block) granule fetched exactly once. Acceptance:
  **>= 5x** steady-state throughput at batch 256, asserted below, plus
  bit-identical results.
- **coalescing**: on a fresh open, one 256-key batch must show cache
  ``misses == entries`` with zero evictions — each granule the batch
  touches was loaded exactly once.
- **prefetch**: cold scans with ``prefetch_depth > 0`` must read no more
  value blocks than the eager path (equal ``disk_bytes_read``) while
  reporting pipeline hit/waste counters.
- **ckb decoder**: batched seeks resolving keys from the prefix-
  compressed CKB entry stream (``ckb_decode``, default) must return
  bit-identical results while reading strictly fewer physical bytes
  than the fixed-width keys-section path (asserted on the full-size
  store; the tiny store's sections share 64 KB granules, so there the
  bar is "no extra bytes").

Also writes ``BENCH_queries.json`` (cold/warm get + scan throughput at
batch 1/64/256; default ``build/bench/``).

``python -m repro_torch.bench.batch_bench [--tiny] [--json PATH]
[--device cpu]`` or ``python -m repro_torch.bench.run --only batch``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.bench.cache_bench import build_store
from repro_torch.bench.common import CSV, card, json_path_for, write_json
from repro_torch.db.store import RemixDB, RemixDBConfig

MIN_BATCH_SPEEDUP = 5.0  # acceptance bar at batch 256
BATCH_SIZES = (1, 64, 256)
SCAN_N = 50  # keys per range query in the scan rows

# full-size store (default) vs smoke store (--tiny)
SIZES = dict(full=(8, 1 << 16), tiny=(4, 1 << 12))


def _cold_cfg(device, **kw) -> RemixDBConfig:
    # promotion off: the subject under test is the cold engine itself
    return RemixDBConfig(promote_fraction=1e9, device=device, **kw)


def _probe(domain: np.ndarray, rng, q: int) -> np.ndarray:
    return rng.choice(domain, size=q, replace=False).astype(np.uint64)


def _scalar_get_loop(db: RemixDB, keys: np.ndarray):
    found = np.zeros(len(keys), bool)
    vals = np.zeros((len(keys), db.cfg.vw), np.uint32)
    for i, k in enumerate(keys.tolist()):
        v = db.get(k)
        if v is not None:
            found[i] = True
            vals[i] = v
    return found, vals


def _throughput(fn, batches: list[np.ndarray]) -> float:
    """Keys/second over the given query batches (steady state)."""
    t0 = time.perf_counter()
    n = 0
    for b in batches:
        fn(b)
        n += len(b)
    return n / (time.perf_counter() - t0)


def bench_multiget(root: str, domain: np.ndarray, csv: CSV, q: int = 256,
                   device="cuda"):
    rng = np.random.default_rng(7)
    warmups = [_probe(domain, rng, q) for _ in range(4)]
    batches = [_probe(domain, rng, q) for _ in range(4)]

    db_s = RemixDB.open(root, _cold_cfg(device))
    db_b = RemixDB.open(root, _cold_cfg(device))
    assert all(p.cold_ready() for p in db_s.partitions), "store not cold"
    # equivalence on the warmup batches — which also bring each path's
    # block working set (CKB/keys/tomb/vals granules) into the shared
    # cache, so the timed section compares engine throughput rather than
    # each side's first-touch checksum transient — then steady-state
    # throughput on fresh keys
    for warm in warmups:
        f_s, v_s = _scalar_get_loop(db_s, warm)
        f_b, v_b = db_b.get_batch(warm)
        if not (np.array_equal(f_s, f_b)
                and np.array_equal(v_s[f_s], v_b[f_b])):
            raise AssertionError("batched cold gets disagree with scalar loop")
    tput_s = _throughput(lambda b: _scalar_get_loop(db_s, b), batches)
    tput_b = _throughput(lambda b: db_b.get_batch(b), batches)
    speedup = tput_b / max(tput_s, 1e-9)
    csv.emit(
        "batch_multiget_scalar", 1e6 * q / tput_s,
        f"q={q};keys_per_s={tput_s:.0f}",
    )
    csv.emit(
        "batch_multiget_vectorized", 1e6 * q / tput_b,
        f"q={q};keys_per_s={tput_b:.0f};speedup={speedup:.1f}x",
    )
    if speedup < MIN_BATCH_SPEEDUP:
        raise AssertionError(
            f"batched cold multi-get is only {speedup:.1f}x the scalar "
            f"loop at batch {q} (acceptance bar: >= {MIN_BATCH_SPEEDUP}x)"
        )
    return speedup


def bench_coalescing(root: str, domain: np.ndarray, csv: CSV, q: int = 256,
                     device="cuda"):
    """Each (file, block) granule touched by a batch is fetched once."""
    rng = np.random.default_rng(11)
    db = RemixDB.open(root, _cold_cfg(device))
    db.get_batch(_probe(domain, rng, q))
    c = db.stats()["cache"]
    if c["evictions"] != 0 or c["misses"] != c["entries"]:
        raise AssertionError(
            f"coalescing violated: {c['misses']} loads for "
            f"{c['entries']} distinct granules ({c['evictions']} evictions)"
        )
    csv.emit(
        "batch_get_coalescing", 0.0,
        f"granules={c['entries']};loads={c['misses']};hits={c['hits']}",
    )


def bench_prefetch_scan(root: str, domain: np.ndarray, csv: CSV, device="cuda"):
    """Fig 10 pipeline: same results, same value blocks as eager."""
    rng = np.random.default_rng(13)
    starts = _probe(domain, rng, 16)
    db_e = RemixDB.open(root, _cold_cfg(device, prefetch_depth=0))
    db_p = RemixDB.open(root, _cold_cfg(device, prefetch_depth=2))
    t0 = time.perf_counter()
    ref = [db_e.scan(int(s), SCAN_N) for s in starts]
    t_e = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = [db_p.scan(int(s), SCAN_N) for s in starts]
    t_p = time.perf_counter() - t0
    for (k1, v1), (k2, v2) in zip(ref, got):
        if not (np.array_equal(k1, k2) and np.array_equal(v1, v2)):
            raise AssertionError("prefetched scan disagrees with eager scan")
    b_e, b_p = db_e.disk_bytes_read(), db_p.disk_bytes_read()
    if b_p > b_e:
        raise AssertionError(
            f"prefetched scans read {b_p} bytes > eager {b_e}"
        )
    c = db_p.stats()["cache"]
    csv.emit(
        "scan_prefetch_pipeline", t_p * 1e6 / len(starts),
        f"eager_us={t_e * 1e6 / len(starts):.0f};bytes_eager={b_e};"
        f"bytes_prefetch={b_p};issued={c['prefetch_issued']};"
        f"hits={c['prefetch_hits']};waste={c['prefetch_waste']}",
    )


def bench_ckb_decoder(root: str, domain: np.ndarray, csv: CSV,
                      strict: bool, q: int = 256, device="cuda") -> float:
    """Vectorized CKB entry-stream decoder: same results, fewer bytes."""
    rng = np.random.default_rng(23)
    probes = _probe(domain, rng, q)
    db_on = RemixDB.open(root, _cold_cfg(device))
    db_off = RemixDB.open(root, _cold_cfg(device, ckb_decode=False))
    f1, v1 = db_on.get_batch(probes)
    f0, v0 = db_off.get_batch(probes)
    if not (np.array_equal(f1, f0) and np.array_equal(v1, v0)):
        raise AssertionError(
            "CKB-decoded seeks disagree with keys-section seeks"
        )
    b_on, b_off = db_on.disk_bytes_read(), db_off.disk_bytes_read()
    if b_on > b_off or (strict and b_on >= b_off):
        raise AssertionError(
            f"CKB entry-stream decoder saved no bytes: "
            f"{b_on} vs {b_off} (keys-section path)"
        )
    savings = 1 - b_on / max(b_off, 1)
    csv.emit(
        "batch_ckb_decoder", 0.0,
        f"bytes_decode={b_on};bytes_fixed={b_off};savings={savings:.1%}",
    )
    return savings


def bench_query_matrix(root: str, domain: np.ndarray, device="cuda") -> list[dict]:
    """Cold/warm get + scan throughput at batch 1/64/256 (JSON rows)."""
    rng = np.random.default_rng(17)
    rows = []
    for q in BATCH_SIZES:
        db = RemixDB.open(root, _cold_cfg(device))
        keys = _probe(domain, rng, q)
        starts = _probe(domain, rng, q)
        for op, fn, per in (
            ("get", lambda: db.get_batch(keys), q),
            ("scan", lambda: db.scan_batch(starts, SCAN_N), q),
        ):
            t0 = time.perf_counter()
            fn()
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn()
            warm = time.perf_counter() - t0
            rows.append(
                dict(op=op, batch=q,
                     cold_qps=round(per / cold, 1),
                     warm_qps=round(per / warm, 1),
                     cold_us_per_query=round(1e6 * cold / per, 2),
                     warm_us_per_query=round(1e6 * warm / per, 2))
            )
    return rows


def bench_device_vs_host(root: str, domain: np.ndarray, csv: CSV,
                         device="cuda") -> dict:
    """Promoted-path comparison: the persistent device view
    (``device_path="on"``, the CUDA kernels on a card) vs the legacy
    promoted path (``"off"``: the plain query engine on the store's
    device), batch-256 gets and 64x16 scans, parity asserted.
    ``kernels_bench`` owns the sync-count bar and the device-speedup
    report; this row tracks the same pipeline on the query store."""
    rng = np.random.default_rng(23)
    keys = _probe(domain, rng, 256)
    starts = np.sort(rng.choice(domain[:-200], 64, replace=False))
    out = {}
    for mode in ("off", "on"):
        db = RemixDB.open(root, RemixDBConfig(cold_reads=False,
                                              device_path=mode, device=device))
        f, v = db.get_batch(keys)  # warm: upload / cache
        db.scan_batch(starts, 16)
        t0 = time.perf_counter()
        for _ in range(3):
            db.get_batch(keys)
        tg = (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        for _ in range(3):
            db.scan_batch(starts, 16)
        ts = (time.perf_counter() - t0) / 3
        out[mode] = (f, v, tg, ts)
        db.close()
    (fh, vh, hg, hs), (fd, vd, dg, ds) = out["off"], out["on"]
    assert np.array_equal(fh, fd) and np.array_equal(vh[fh], vd[fd])
    csv.emit("batch_device_get256", dg / 256 * 1e6,
             f"host={hg / 256 * 1e6:.2f}us")
    csv.emit("batch_device_scan64x16", ds / 64 * 1e6,
             f"host={hs / 64 * 1e6:.2f}us")
    return dict(
        get_us_device=round(dg / 256 * 1e6, 3),
        get_us_host=round(hg / 256 * 1e6, 3),
        scan_us_device=round(ds / 64 * 1e6, 2),
        scan_us_host=round(hs / 64 * 1e6, 2),
    )


def run(csv: CSV, tiny: bool = False, json_path: str | None = None,
        device="cuda") -> dict:
    """Every part on one store; writes the JSON record and returns it."""
    r_tables, n_per_table = SIZES["tiny" if tiny else "full"]
    with tempfile.TemporaryDirectory(prefix="batch-bench-") as tmp:
        root = os.path.join(tmp, "db")
        domain = build_store(
            root, r_tables=r_tables, n_per_table=n_per_table
        )
        speedup = bench_multiget(root, domain, csv, device=device)
        bench_coalescing(root, domain, csv, device=device)
        bench_prefetch_scan(root, domain, csv, device=device)
        savings = bench_ckb_decoder(root, domain, csv, strict=not tiny,
                                    device=device)
        matrix = bench_query_matrix(root, domain, device=device)
        versus = bench_device_vs_host(root, domain, csv, device=device)
    csv.emit(
        "batch_summary", 0.0,
        f"r_tables={r_tables};n_per_table={n_per_table};"
        f"multiget_speedup={speedup:.1f}x",
    )
    record = dict(
        bench="queries",
        unix_time=int(time.time()),
        card=card(device),
        store=dict(r_tables=r_tables, n_per_table=n_per_table),
        scan_n=SCAN_N,
        multiget_speedup_at_256=round(speedup, 2),
        ckb_decode_savings=round(savings, 3),
        queries=matrix,
        device_vs_host=versus,
    )
    write_json(json_path_for("queries", json_path), record)
    return record



if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke store (4 tables x 4096 entries)")
    ap.add_argument("--json", default=None, help="BENCH_queries.json path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, tiny=args.tiny, json_path=args.json, device=args.device)
