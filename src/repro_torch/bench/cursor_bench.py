"""Streaming range scans: one RemixCursor vs repeated ``scan()`` re-seeks.

The port of ``benchmarks/cursor_bench.py``. The experiment behind the cursor layer (paper §3.2): a long or streaming
scan consumed in chunks either re-seeks per chunk — every ``scan(start,
n)`` pays the partition route, the anchors binary search, one bounded
CKB restart-point seek *per run*, and a fresh window walk — or holds one
:class:`repro_torch.db.cursor.RemixCursor`, which seeks once and then advances
a persisted view position (comparison-free ``next``, §3.3) per chunk.

Both paths run against the same recovered (cold) store with a shared
block cache and are verified to return identical rows. Acceptance:
cursor streaming is **>= 2x** the re-seeking loop on long scans
(``MIN_CURSOR_SPEEDUP``, asserted below). Writes ``BENCH_cursor.json``
(default ``build/bench/``).

``python -m repro_torch.bench.cursor_bench [--tiny] [--json PATH]
[--device cpu]`` or ``python -m repro_torch.bench.run --only cursor``.
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

MIN_CURSOR_SPEEDUP = 2.0  # acceptance bar on the long scan
CHUNK = 64  # rows per consumer step (a streaming client's batch)

# full-size store (default) vs smoke store (--tiny): (tables, n/table)
SIZES = dict(full=(6, 1 << 14), tiny=(4, 1 << 11))


def _cold_cfg(device, **kw) -> RemixDBConfig:
    # promotion off: the subject under test is the streaming read path
    return RemixDBConfig(promote_fraction=1e9, device=device, **kw)


def _stream_reseek(db: RemixDB, start: int, total: int) -> np.ndarray:
    """Consume ``total`` rows in CHUNK-sized scans, re-seeking each time
    (the pre-cursor client pattern)."""
    out, lo = [], int(start)
    got = 0
    while got < total:
        kk, _ = db.scan(lo, min(CHUNK, total - got))
        if len(kk) == 0:
            break
        out.append(kk)
        got += len(kk)
        lo = int(kk[-1]) + 1
    return np.concatenate(out) if out else np.zeros(0, np.uint64)


def _stream_cursor(db: RemixDB, start: int, total: int) -> np.ndarray:
    """Consume ``total`` rows from one cursor: seek once, then
    ``next_batch`` per chunk."""
    out, got = [], 0
    with db.cursor(start=start, width=CHUNK + CHUNK // 2) as cur:
        while got < total:
            kk, _ = cur.next_batch(min(CHUNK, total - got))
            if len(kk) == 0:
                break
            out.append(kk)
            got += len(kk)
    return np.concatenate(out) if out else np.zeros(0, np.uint64)


def _time(fn, *args, repeats: int = 3) -> tuple[float, np.ndarray]:
    """Best-of-N wall time (seconds) + the last result. The first call
    warms the shared block cache so both paths measure steady state."""
    fn(*args)
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run(csv: CSV, tiny: bool = False, json_path: str | None = None,
        device="cuda") -> dict:
    """Both scans on one cold store; writes the JSON record and returns it."""
    r_tables, n_per_table = SIZES["tiny" if tiny else "full"]
    with tempfile.TemporaryDirectory(prefix="cursor-bench-") as tmp:
        root = os.path.join(tmp, "db")
        domain = build_store(root, r_tables=r_tables, n_per_table=n_per_table)
        db = RemixDB.open(root, _cold_cfg(device))
        assert all(p.cold_ready() for p in db.partitions), "store not cold"

        results: dict[str, dict] = {}
        total = len(domain)
        for label, length in [("long", (total * 3) // 4), ("short", 4 * CHUNK)]:
            start = int(domain[total // 8])
            t_re, k_re = _time(_stream_reseek, db, start, length)
            t_cu, k_cu = _time(_stream_cursor, db, start, length)
            np.testing.assert_array_equal(k_cu, k_re)  # identical rows
            speedup = t_re / max(t_cu, 1e-9)
            results[label] = dict(
                rows=int(length),
                chunk=CHUNK,
                reseek_us=t_re * 1e6,
                cursor_us=t_cu * 1e6,
                speedup=speedup,
            )
            csv.emit(
                f"cursor_stream_{label}", t_cu * 1e6 / max(1, length),
                f"rows={length} speedup={speedup:.2f}x_vs_reseek",
            )
        db.close()
    long_speedup = results["long"]["speedup"]
    assert long_speedup >= MIN_CURSOR_SPEEDUP, (
        f"cursor streaming {long_speedup:.2f}x < {MIN_CURSOR_SPEEDUP}x "
        f"over re-seeking scans on the long range"
    )
    record = dict(
        card=card(device),
        store=dict(tables=r_tables, n_per_table=n_per_table, tiny=bool(tiny)),
        scans=results,
        min_speedup=MIN_CURSOR_SPEEDUP,
    )
    write_json(json_path_for("cursor", json_path), record)
    print(f"# long-scan speedup {long_speedup:.2f}x")
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke size (small store, same assertions)")
    ap.add_argument("--json", default=None, help="BENCH_cursor.json path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, tiny=args.tiny, json_path=args.json, device=args.device)


if __name__ == "__main__":
    main()
