"""Shared by the benchmark's CPU tests: tiny runs of its cells on the
CPU, with the device views' plain path (no card, no kernel build), and a
copy of the benchmark to which a test adds cells as files and entries."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import run_cell  # noqa: E402

TINY = {"keys": 2048, "system": {"memtable_entries": 512, "table_cap": 256,
                                 "device_path": "on"}}
SEED = 4_000_000_123  # a driver-like seed: more than 32 bits


def tiny(workload, seed=SEED, seconds=0.3, trace=False, root=ROOT, **kw):
    return run_cell(root, workload, seed, seconds, trace, device="cpu",
                    overrides=TINY, **kw)


# YCSB-E as a later PR would add it: Seek+Next50 scans and 5% inserts that
# keep the memtable non-empty, so the scans take the cursor.
SCAN_MIX = dict(clients=4, batch_ops=16, proportions=dict(scan=0.95, insert=0.05),
                request_distribution="zipfian", zipf_theta=0.99, scan_length=50,
                warmup_requests=8)


def bench_copy(tmp_path):
    """The benchmark's configurations, mixes and readers copied under
    ``tmp_path``; returns its ``BENCHMARK.json`` to add entries to."""
    (tmp_path / "perfbench").mkdir()
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "perfbench" / sub, tmp_path / "perfbench" / sub)
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def scan_bench(tmp_path):
    """A copy of the benchmark with the scan cell ``ycsb-e.kv120`` added
    from files alone (mix ``scan-insert``); returns its root."""
    doc = bench_copy(tmp_path)
    (tmp_path / "perfbench" / "traffic" / "scan-insert.json").write_text(json.dumps(SCAN_MIX))
    doc["workloads"].append(dict(name="ycsb-e.kv120", config="remixdb-kv120",
                                 traffic="scan-insert", chips=1, why="a test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path
