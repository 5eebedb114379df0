"""Tiny runs of every cell on the CPU, and a cell added from files alone."""
import json

import pytest

from perfbench_tiny import ROOT, bench_copy, scan_bench, tiny

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_of_each_cell(cell):
    out = tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = out["metrics"]
    assert set(m) == {"ops_per_s", "p50_ms", "p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell,want", [
    ("ycsb-c.kv120", {"exec.queue_ms.p95", "store.read_ms_per_req", "view.syncs_per_req"}),
    ("ycsb-c.kv1k-serve3", {"exec.queue_ms.p95", "store.read_ms_per_req", "view.syncs_per_req"}),
])
def test_traced_run_reads_the_program_spans_and_counters(cell, want):
    """Per-layer metrics of a traced run; those of the card's profiler are
    left out on the CPU, where there is nothing to read."""
    out = tiny(cell, trace=True, seconds=0.5)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == want
    assert "breakdown" not in out


def test_a_scan_cell_added_as_files_only(tmp_path):
    """A YCSB-E cell (scans over a non-empty memtable, inserts) and a reader
    of the write path's commit spans, added as files and entries: the
    generator, the comparison and the harness take them unchanged."""
    root = scan_bench(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perfbench" / "metrics" / "commit_ms.p95.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    d = [s.duration for s in run.spans(r'shard\\d+:commit')]\n"
        "    return float(np.percentile(d, 95)) * 1e3 if d else None\n")
    doc["per_layer"].append(dict(name="commit_ms.p95", unit="ms", better="lower",
                                 source="program_span", layer="write path",
                                 moves="p95_ms", workloads=["ycsb-e.kv120"]))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    out = tiny("ycsb-e.kv120", root=root, trace=True, seconds=0.5)
    assert out["correct"], out["checks"]
    assert out["metrics"]["commit_ms.p95"]["value"] > 0
    assert set(out["checks"]) == {"wrong_loaded", "wrong_scans", "lost_writes"}


def test_a_cell_mix_and_metric_added_as_files_only(tmp_path):
    """A new mix, a new per-layer metric and a new cell are files and
    entries: copied beside the benchmark's own, they run unchanged code."""
    doc = bench_copy(tmp_path)
    (tmp_path / "perfbench" / "traffic" / "throwaway.json").write_text(json.dumps(
        dict(clients=2, batch_ops=8, proportions=dict(read=0.5, update=0.25, rmw=0.25),
             request_distribution="latest", warmup_requests=2)))
    (tmp_path / "perfbench" / "metrics" / "ops_per_req.py").write_text(
        "def read(run):\n    return run.ok_ops() / max(1, len(run.completed()))\n")
    doc["workloads"].append(dict(name="throwaway.kv120", config="remixdb-kv120",
                                 traffic="throwaway", chips=1, why="a test"))
    doc["per_layer"].append(dict(name="ops_per_req", unit="ops/req", better="higher",
                                 source="program_counter", layer="executor",
                                 moves="ops_per_s", workloads=["throwaway.kv120"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    out = tiny("throwaway.kv120", root=tmp_path, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["ops_per_req"]["value"] == 8
    assert {"wrong_reads", "lost_writes"} <= set(out["checks"])
