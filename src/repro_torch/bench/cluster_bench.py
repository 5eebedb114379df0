"""Cluster tier under fire: live shard split mid-run, replicas catching up.

The port of ``benchmarks/cluster_bench.py``. Three range shards behind one
:class:`repro_torch.cluster.Cluster` serve
zipfian traffic from concurrent submitters while the hottest shard is
split live. The acceptance bars (asserted, not just reported):

- zero failed operations across the whole run — the cutover gates
  submissions instead of failing them;
- post-split p99 batch latency <= 2x the pre-split p99 (the split may
  briefly stall the gate but must not degrade steady-state serving);
- a read replica converges to sequence lag 0 once the writer pauses.

Writes ``BENCH_cluster.json`` (default ``build/bench/``).
``python -m repro_torch.bench.cluster_bench [--tiny] [--json P]
[--device cpu]`` or ``python -m repro_torch.bench.run --only cluster``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.bench.common import CSV, card, json_path_for, write_json, zipf_keys
from repro_torch.cluster import Cluster
from repro_torch.db.compaction import CompactionConfig
from repro_torch.db.ops import Batch, Op
from repro_torch.db.store import RemixDBConfig

SIZES = {  # n keys preloaded per shard
    "tiny": 8_192,
    "full": 49_152,
}
SHARDS = 3
BATCH = 64
THREADS = 3


def _cfg(device) -> RemixDBConfig:
    return RemixDBConfig(
        vw=2,
        device=device,
        memtable_entries=1 << 12,
        compaction=CompactionConfig(table_cap=1 << 12, t_max=4),
    )


class _Traffic:
    """Zipfian read/write submitters recording per-batch latencies."""

    def __init__(self, cluster: Cluster, keyspace: int, seed: int = 0):
        self.cluster = cluster
        self.keyspace = keyspace
        self.seed = seed
        self.failed: list[str] = []
        self.lat: list[tuple[float, float]] = []  # (t_done, seconds)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _loop(self, tid: int) -> None:
        rng = np.random.default_rng(self.seed + tid)
        # zipfian ranks permuted over the key domain: hot keys spread
        # across the space but concentrated in popularity
        perm = np.random.default_rng(7).permutation(self.keyspace)
        while not self._stop.is_set():
            ranks = zipf_keys(rng, self.keyspace, BATCH)
            ks = perm[ranks].astype(np.uint64)
            write = rng.random() < 0.25
            if write:
                vs = np.stack([ks.astype(np.uint32),
                               np.full(BATCH, tid + 1, np.uint32)], 1)
                batch = Batch([Op.put(ks, vs)])
            else:
                batch = Batch([Op.multiget(ks)])
            t0 = time.perf_counter()
            try:
                res = self.cluster.submit(batch).result(timeout=120)
                for r in res.results:
                    r.raise_if_error()
            except Exception as e:  # noqa: BLE001 - the bench asserts
                with self._lock:
                    self.failed.append(repr(e))
                continue
            t1 = time.perf_counter()
            with self._lock:
                self.lat.append((t1, t1 - t0))

    def start(self) -> None:
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True)
            for i in range(THREADS)
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join()

    def window(self, t0: float, t1: float) -> np.ndarray:
        with self._lock:
            return np.array([s for td, s in self.lat if t0 <= td < t1])


def _p(arr: np.ndarray, q: float) -> float:
    return float(np.percentile(arr, q)) if len(arr) else float("nan")


def run(csv: CSV, tiny: bool = False, json_path: str | None = None,
        device="cuda") -> dict:
    """The whole run; writes the JSON record and returns it."""
    n_per_shard = SIZES["tiny" if tiny else "full"]
    keyspace = SHARDS * n_per_shard
    span = keyspace // SHARDS
    phase_s = 2.0 if tiny else 5.0
    with tempfile.TemporaryDirectory(prefix="cluster-bench-") as tmp:
        cluster = Cluster(
            os.path.join(tmp, "fleet"),
            lows=tuple(i * span for i in range(SHARDS)),
            config=_cfg(device),
        )
        ks = np.arange(keyspace, dtype=np.uint64)
        for i in range(0, keyspace, 1 << 14):
            sl = ks[i:i + (1 << 14)]
            cluster.put_batch(
                sl, np.stack([sl.astype(np.uint32),
                              np.zeros(len(sl), np.uint32)], 1))
        cluster.flush()

        traffic = _Traffic(cluster, keyspace)
        traffic.start()
        t_start = time.perf_counter()
        time.sleep(phase_s)
        t_pre_end = time.perf_counter()

        # live split of the hottest (zipf-head) shard, mid-run
        t_split0 = time.perf_counter()
        report = cluster.split(span // 2)
        t_split1 = time.perf_counter()
        assert len(cluster.lows) == SHARDS + 1

        time.sleep(phase_s)
        t_post_end = time.perf_counter()
        traffic.stop()

        pre = traffic.window(t_start, t_pre_end)
        post = traffic.window(t_split1, t_post_end)
        p99_pre, p99_post = _p(pre, 99), _p(post, 99)
        ratio = p99_post / p99_pre if p99_pre else float("nan")
        n_ops = len(traffic.lat) * BATCH

        csv.emit("cluster_pre_split_p99", 1e6 * p99_pre,
                 f"batches={len(pre)};shards={SHARDS}")
        csv.emit("cluster_post_split_p99", 1e6 * p99_post,
                 f"batches={len(post)};shards={SHARDS + 1};"
                 f"ratio={ratio:.2f}")
        csv.emit("cluster_split_gate", 1e6 * (t_split1 - t_split0),
                 f"shipped_bytes={report['shipped']['bytes']}")

        assert not traffic.failed, traffic.failed[:5]
        if len(pre) >= 50 and len(post) >= 50 and ratio > 2.0:
            raise AssertionError(
                f"post-split p99 {1e3 * p99_post:.2f}ms is {ratio:.2f}x "
                f"pre-split (bar: <= 2x)")

        # replica: catch up live, then converge to 0 once writes pause
        rep = cluster.add_replica(cluster.lows[0])
        wk = np.arange(0, span // 4, dtype=np.uint64)
        cluster.put_batch(
            wk, np.stack([wk.astype(np.uint32),
                          np.full(len(wk), 9, np.uint32)], 1))
        lag_before = rep.seq_lag()
        t_rep0 = time.perf_counter()
        final = rep.catch_up_until(lag_target=0)
        t_rep1 = time.perf_counter()
        assert rep.seq_lag() == 0, rep.seq_lag()
        csv.emit("cluster_replica_catchup", 1e6 * (t_rep1 - t_rep0),
                 f"lag_before={lag_before};lag_after=0")

        snap = cluster.metrics()
        counters = {
            m["name"]: m.get("value", 0)
            for m in snap["metrics"]
            if m.get("type") == "counter"
            and m.get("labels", {}).get("tier") == "serve"
        }
        lows_after = cluster.lows
        cluster.close()

    csv.emit(
        "cluster_summary", 0.0,
        f"shards={SHARDS}->{len(lows_after)};ops={n_ops};failed=0",
    )
    record = dict(
        bench="cluster",
        unix_time=int(time.time()),
        card=card(device),
        store=dict(shards_before=SHARDS,
                   shards_after=len(lows_after),
                   keys=keyspace, batch=BATCH,
                   threads=THREADS, phase_s=phase_s),
        ops=n_ops,
        failed_ops=len(traffic.failed),
        p99_pre_split_ms=round(1e3 * p99_pre, 3),
        p99_post_split_ms=round(1e3 * p99_post, 3),
        p50_pre_split_ms=round(1e3 * _p(pre, 50), 3),
        p50_post_split_ms=round(1e3 * _p(post, 50), 3),
        post_over_pre_p99=round(ratio, 3),
        split=dict(
            at=report["at"],
            gate_ms=round(1e3 * (t_split1 - t_split0), 3),
            shipped_bytes=report["shipped"]["bytes"],
            shipped_files=report["shipped"]["files"],
            final_lag=report["final"]["lag"],
        ),
        replica=dict(
            lag_before_catchup=int(lag_before),
            lag_after_catchup=0,
            catchup_ms=round(1e3 * (t_rep1 - t_rep0), 3),
            applied=final["applied"],
        ),
        counters=dict(
            shard_split=counters.get("shard_split", 0),
            snapshot_ship_bytes=counters.get(
                "snapshot_ship_bytes", 0),
            snapshot_ship_files=counters.get(
                "snapshot_ship_files", 0),
            replica_catchup_seqs=counters.get(
                "replica_catchup_seqs", 0),
        ),
    )
    write_json(json_path_for("cluster", json_path), record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke sizes (3 shards x 8192 keys)")
    ap.add_argument("--json", default=None, help="BENCH_cluster.json path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, tiny=args.tiny, json_path=args.json, device=args.device)
