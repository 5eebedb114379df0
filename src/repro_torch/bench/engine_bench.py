"""Op-layer engine: mixed typed batches vs the scalar legacy loop.

The port of ``benchmarks/engine_bench.py``. The experiment behind the v2
operation API (`repro_torch.db.ops` + `repro_torch.db.executor`): a
range-sharded :class:`repro_torch.serve.KVServeEngine`
(two cold shards, one shared block cache) answers a **mixed** batch of
256 ops — point gets and range scans, spanning both shards — two ways:

- **scalar legacy loop**: one ``eng.get(k)`` / ``eng.scan(s, n)`` call
  per op, in order (the pre-v2 serving pattern);
- **submit()**: the same ops as one typed ``Batch`` through the
  planner–executor — reads grouped per shard (one pinned snapshot per
  shard per batch), point lookups vectorized into one ``get_batch``
  per shard, scans into one window call per (shard, partition).

Acceptance (asserted): bit-identical results, and mixed-batch
throughput **>= 5x** the scalar loop at batch 256. The pure-kind paths
(a gets-only / scans-only batch through ``submit()`` vs the direct
legacy batched calls) are measured as ratios so the op layer provably
adds no regression over ``BENCH_queries.json``'s vectorized paths.

Also writes ``BENCH_engine.json`` and, beside it, the run's labelled
metrics snapshot (``OBS_snapshot.json``) and one traced batch as a Chrome
trace (``OBS_trace.json``); default ``build/bench/``.

``python -m repro_torch.bench.engine_bench [--tiny] [--json P]
[--device cpu]`` or ``python -m repro_torch.bench.run --only engine``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.bench.common import CSV, card, json_path_for, write_json
from repro_torch.core.remix import build_remix
from repro_torch.core.runs import make_run
from repro_torch.db.ops import Batch, Op, OpKind
from repro_torch.db.store import RemixDBConfig
from repro_torch.db.wal import WAL
from repro_torch.device import u32_np
from repro_torch.io.manifest import Storage
from repro_torch.obs.metrics import save_snapshot
from repro_torch.serve.engine import KVServeEngine

MIN_MIXED_SPEEDUP = 5.0  # acceptance bar at batch 256
MIN_PURE_RATIO = 0.5  # submit() vs direct batched call, safety net
MIN_METRICS_RATIO = 0.95  # metrics-on vs metrics-off throughput floor
MAX_SNAPSHOT_RATIO = 10.0  # full-memtable snapshot pin vs empty (O(1) bar)
# alternating metrics-on/off reps (the reference's 5). Metrics cost ~1% of
# a batch on an H100 host, but that host's speed swung by up to 60% within
# a run: a median of 5 reps spread 0.903-1.211 and fell under the 0.95 bar
# in 4 of 14 runs, a median of 30 spread 0.939-1.033 (2 of 14 under); a
# median of 100 cuts that spread by ~1.8x. The bar is unchanged
METRICS_REPS = 100
SCAN_N = 20
SPLIT = 1 << 40  # shard boundary

# full-size shard (default) vs smoke shard (--tiny)
SIZES = dict(full=(8, 1 << 15), tiny=(4, 1 << 12))


def _build_shard(root: str, lo: int, r_tables: int, n_per_table: int,
                 seed: int) -> np.ndarray:
    """A committed single-partition store whose keys start at ``lo``
    (written on the host)."""
    rng = np.random.default_rng(seed)
    total = r_tables * n_per_table
    domain = np.uint64(lo) + np.arange(1, total + 1, dtype=np.uint64) * 64
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
    remix, _ = build_remix(runs, d=32)
    xname = storage.write_remix(remix)
    wal = WAL(storage.wal_path())
    storage.commit(
        dict(seq=seqbase, vw=2, d=32,
             partitions=[dict(lo=int(lo), tables=names, remix=xname)],
             wal=wal.save_state())
    )
    return domain


def _mixed_ops(domains: list[np.ndarray], rng, q: int) -> list[Op]:
    """3/4 gets + 1/4 scans, interleaved, spanning every shard."""
    ops: list[Op] = []
    for i in range(q):
        dom = domains[i % len(domains)]
        if i % 4 == 3:
            ops.append(Op.scan(int(rng.choice(dom)), SCAN_N))
        else:
            ops.append(Op.get(int(rng.choice(dom))))
    return ops


def _scalar_loop(eng: KVServeEngine, ops: list[Op]) -> list:
    out = []
    for op in ops:
        if op.kind is OpKind.SCAN:
            out.append(eng.scan(op.start, op.n))
        else:
            out.append(eng.get(op.key))
    return out


def _check_equal(ops, legacy, res) -> None:
    for op, ref, r in zip(ops, legacy, res.results):
        assert r.ok, f"{op} -> {r.status}"
        if op.kind is OpKind.SCAN:
            kr, vr = ref
            if not (np.array_equal(kr, r.keys)
                    and np.array_equal(vr, r.vals)):
                raise AssertionError(f"scan mismatch for {op}")
        else:
            a = ref is not None
            b = bool(r.found)
            if a != b or (a and not np.array_equal(ref, r.value)):
                raise AssertionError(f"get mismatch for {op}")


def _throughput(fn, items: list) -> float:
    t0 = time.perf_counter()
    n = 0
    for it in items:
        fn(it)
        n += len(it.ops) if isinstance(it, Batch) else len(it)
    return n / (time.perf_counter() - t0)


def bench_mixed(eng, domains, csv: CSV, q: int = 256) -> float:
    rng = np.random.default_rng(29)
    warm = [_mixed_ops(domains, rng, q) for _ in range(4)]
    timed = [_mixed_ops(domains, rng, q) for _ in range(4)]
    for ops in warm:  # equivalence + working-set warmup for both paths
        legacy = _scalar_loop(eng, ops)
        res = eng.submit(Batch(list(ops)), sync=True).result()
        _check_equal(ops, legacy, res)
    tput_s = _throughput(lambda ops: _scalar_loop(eng, ops), timed)
    tput_b = _throughput(
        lambda ops: eng.submit(Batch(list(ops)), sync=True).result(), timed
    )
    speedup = tput_b / max(tput_s, 1e-9)
    csv.emit("engine_mixed_scalar", 1e6 * q / tput_s,
             f"q={q};ops_per_s={tput_s:.0f}")
    csv.emit("engine_mixed_submit", 1e6 * q / tput_b,
             f"q={q};ops_per_s={tput_b:.0f};speedup={speedup:.1f}x")
    if speedup < MIN_MIXED_SPEEDUP:
        raise AssertionError(
            f"mixed op batch is only {speedup:.1f}x the scalar legacy "
            f"loop at batch {q} (bar: >= {MIN_MIXED_SPEEDUP}x)"
        )
    return speedup


def bench_pure_paths(eng, domains, csv: CSV, q: int = 256
                     ) -> tuple[float, float]:
    """submit() must not regress the pre-v2 vectorized physical paths.

    The direct side calls the snapshot-level primitives exactly the way
    the legacy (pre-op-layer) ``get_batch``/``scan_batch`` bodies did —
    routing, one pinned view + one vectorized call per shard — so the
    ratio isolates the op layer's planning/wrapping overhead."""
    from repro_torch.db.sharded import route_host

    rng = np.random.default_rng(31)
    keys = np.concatenate(
        [rng.choice(d, q // len(domains), replace=False) for d in domains]
    ).astype(np.uint64)
    starts = np.concatenate(
        [rng.choice(d, 8, replace=False) for d in domains]
    ).astype(np.uint64)

    def direct_get():
        found = np.zeros(len(keys), bool)
        vals = np.zeros((len(keys), eng.shards[0].cfg.vw), np.uint32)
        sid = route_host(eng.lows, keys)
        for s in np.unique(sid):
            m = sid == s
            with eng.shards[s]._view() as view:
                f, v = view.get_batch(keys[m])
            found[m] = f
            vals[m] = v
        return found, vals

    def submit_get():
        return eng.submit(Batch([Op.multiget(keys)]), sync=True).result()

    def direct_scan():
        sid = route_host(eng.lows, starts)
        out = [None] * len(starts)
        for s in np.unique(sid):
            m = np.flatnonzero(sid == s)
            with eng.shards[s]._view() as view:
                rows = eng.shards[s]._scan_group_at(
                    view, starts[m], SCAN_N, with_vals=False
                )
            for qi, row in zip(m, rows):
                out[qi] = row
        return out

    def submit_scan():
        b = Batch([Op.scan(int(s), SCAN_N, with_vals=False)
                   for s in starts.tolist()])
        return eng.submit(b, sync=True).result()

    ratios = []
    for name, direct, submit in (
        ("get", direct_get, submit_get),
        ("scan", direct_scan, submit_scan),
    ):
        direct(), submit()  # warm
        t_d, t_s = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            direct()
            t_d.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            submit()
            t_s.append(time.perf_counter() - t0)
        med_d, med_s = np.median(t_d), np.median(t_s)
        ratio = med_d / max(med_s, 1e-9)
        ratios.append(ratio)
        csv.emit(f"engine_pure_{name}", 1e6 * med_s,
                 f"direct_us={1e6 * med_d:.0f};ratio={ratio:.2f}")
        if ratio < MIN_PURE_RATIO:
            raise AssertionError(
                f"pure {name} path through submit() is {1 / ratio:.1f}x "
                f"slower than the direct physical call"
            )
    return ratios[0], ratios[1]


def bench_async(eng, domains, csv: CSV, q: int = 256) -> float:
    """Async submission: N batches in flight through the worker pool."""
    rng = np.random.default_rng(37)
    batches = [Batch(_mixed_ops(domains, rng, q)) for _ in range(4)]
    t0 = time.perf_counter()
    futs = [eng.submit(b) for b in batches]
    for f in futs:
        assert f.result(timeout=300).ok
    dt = time.perf_counter() - t0
    tput = 4 * q / dt
    csv.emit("engine_async_submit", 1e6 * q / tput,
             f"batches=4;ops_per_s={tput:.0f}")
    return tput


def bench_metrics_overhead(roots, domains, csv: CSV, q: int = 256,
                           reps: int = METRICS_REPS, device="cuda") -> float:
    """Observability must be ~free: mixed-batch throughput with the
    metrics registry on vs the no-op instruments, alternating reps on
    two engines over the same shard files (read-only workload)."""
    cfg = RemixDBConfig(promote_fraction=1e9, device=device)
    addrs = [(0, roots[0]), (SPLIT, roots[1])]
    eng_on = KVServeEngine(addrs, config=cfg)
    eng_off = KVServeEngine(addrs, config=cfg, metrics=False)
    rng = np.random.default_rng(41)
    batches = [_mixed_ops(domains, rng, q) for _ in range(3)]

    def one(eng) -> float:
        t0 = time.perf_counter()
        for ops in batches:
            assert eng.submit(Batch(list(ops)), sync=True).result().ok
        return len(batches) * q / (time.perf_counter() - t0)

    try:
        one(eng_on), one(eng_off)  # warm both working sets
        on, off = [], []
        for _ in range(reps):  # alternate so drift hits both sides
            on.append(one(eng_on))
            off.append(one(eng_off))
        ratio = float(np.median(on) / max(np.median(off), 1e-9))
    finally:
        eng_on.close()
        eng_off.close()
    csv.emit("engine_metrics_overhead", 1e6 * q / np.median(on),
             f"q={q};ratio_on_off={ratio:.3f}")
    if ratio < MIN_METRICS_RATIO:
        raise AssertionError(
            f"metrics-on throughput is {ratio:.3f}x metrics-off "
            f"(bar: >= {MIN_METRICS_RATIO}x)"
        )
    return ratio


def bench_snapshot_o1(csv: CSV, tiny: bool = False, device="cuda") -> float:
    """``RemixDB.snapshot()`` must be O(1) in resident MemTable entries:
    the layered MemTable freezes its mutable layer instead of copying the
    overlay dict, so pinning a view of a full memtable costs the same as
    an empty one. This is what makes the cluster tier's per-batch
    snapshot pinning and replication captures free."""
    from repro_torch.db.store import RemixDB

    n = (1 << 12) if tiny else (1 << 15)
    reps = 300

    def pin_cost(db) -> float:
        t_best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                db.snapshot().close()
            t_best = min(t_best, (time.perf_counter() - t0) / reps)
        return t_best

    with tempfile.TemporaryDirectory(prefix="snap-bench-") as tmp:
        cfg = RemixDBConfig(memtable_entries=4 * n, device=device)
        db = RemixDB.open(os.path.join(tmp, "db"), cfg)
        try:
            empty_s = pin_cost(db)
            ks = np.arange(n, dtype=np.uint64)
            db.put_batch(
                ks, np.stack([ks.astype(np.uint32),
                              np.ones(n, np.uint32)], 1))
            assert len(db.mem.data) >= n  # resident, not flushed
            full_s = pin_cost(db)
        finally:
            db.close()
    ratio = full_s / max(empty_s, 1e-9)
    csv.emit("engine_snapshot_pin", 1e6 * full_s,
             f"entries={n};empty_us={1e6 * empty_s:.2f};"
             f"ratio={ratio:.2f}")
    if ratio > MAX_SNAPSHOT_RATIO:
        raise AssertionError(
            f"snapshot() on a {n}-entry memtable costs {ratio:.1f}x the "
            f"empty-memtable pin (bar: <= {MAX_SNAPSHOT_RATIO}x — it "
            f"must not scale with resident entries)"
        )
    return ratio


def run(csv: CSV, tiny: bool = False, json_path: str | None = None,
        device="cuda") -> dict:
    """Every part; writes the JSON record, the metrics snapshot and the
    trace, and returns the record."""
    r_tables, n_per_table = SIZES["tiny" if tiny else "full"]
    with tempfile.TemporaryDirectory(prefix="engine-bench-") as tmp:
        roots = [os.path.join(tmp, f"shard{i}") for i in range(2)]
        domains = [
            _build_shard(roots[i], i * SPLIT, r_tables, n_per_table, seed=i)
            for i in range(2)
        ]
        # promotion off: the op layer over the cold engine is the subject
        cfg = RemixDBConfig(promote_fraction=1e9, device=device)
        eng = KVServeEngine(
            [(0, roots[0]), (SPLIT, roots[1])], config=cfg
        )
        speedup = bench_mixed(eng, domains, csv)
        get_ratio, scan_ratio = bench_pure_paths(eng, domains, csv)
        async_tput = bench_async(eng, domains, csv)
        # observability artifacts off the same engine: one traced batch
        # and the full labelled registry snapshot
        rng = np.random.default_rng(43)
        traced = eng.submit(
            Batch(_mixed_ops(domains, rng, 64), trace=True), sync=True
        ).result()
        trace = traced.trace
        assert trace is not None and trace.well_formed()
        snap = eng.metrics()
        estats = eng.stats()["engine"]
        eng.close()
        metrics_ratio = bench_metrics_overhead(roots, domains, csv,
                                               device=device)
    snapshot_ratio = bench_snapshot_o1(csv, tiny=tiny, device=device)
    csv.emit(
        "engine_summary", 0.0,
        f"r_tables={r_tables};n_per_table={n_per_table};"
        f"mixed_speedup={speedup:.1f}x",
    )
    out = json_path_for("engine", json_path)
    res_dir = os.path.dirname(out) or "."
    os.makedirs(res_dir, exist_ok=True)
    # sibling artifacts: the labelled snapshot and the Chrome trace
    # (chrome://tracing / Perfetto-loadable)
    save_snapshot(snap, os.path.join(res_dir, "OBS_snapshot.json"))
    trace.save_chrome(os.path.join(res_dir, "OBS_trace.json"))
    # executor section read back from the registry snapshot (the same
    # samples OBS_snapshot.json carries), not from ad-hoc counters
    ops_by_kind = {
        s["labels"]["kind"]: s["value"]
        for s in snap["metrics"]
        if s["name"] == "engine_ops"
    }
    batch_hist = next(
        (s for s in snap["metrics"] if s["name"] == "engine_batch_seconds"),
        None,
    )
    record = dict(
        bench="engine",
        unix_time=int(time.time()),
        card=card(device),
        store=dict(shards=2, r_tables=r_tables,
                   n_per_table=n_per_table),
        scan_n=SCAN_N,
        mixed_speedup_at_256=round(speedup, 2),
        pure_get_ratio=round(get_ratio, 3),
        pure_scan_ratio=round(scan_ratio, 3),
        async_ops_per_s=round(async_tput, 1),
        metrics_overhead_ratio=round(metrics_ratio, 3),
        snapshot_pin_ratio_full_vs_empty=round(snapshot_ratio, 3),
        executor=dict(
            batches=sum(
                s["value"]
                for s in snap["metrics"]
                if s["name"] == "engine_batches"
            ),
            ops=ops_by_kind,
            batch_seconds=None if batch_hist is None else dict(
                count=batch_hist["count"],
                p50=batch_hist["p50"],
                p99=batch_hist["p99"],
            ),
            admission=estats["admission"],
        ),
        trace=dict(
            spans=len(trace.spans()),
            leaf_coverage=round(trace.leaf_coverage(), 3),
        ),
    )
    write_json(out, record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke shards (4 tables x 4096 entries each)")
    ap.add_argument("--json", default=None, help="BENCH_engine.json path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, tiny=args.tiny, json_path=args.json, device=args.device)
