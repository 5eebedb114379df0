"""The port's YCSB benchmark (``repro_torch.bench.fig17_ycsb``) against the
reference's (``benchmarks/fig17_ycsb.py``), on the CPU at a tiny scale and
300 operations per workload: the same row names in the same order. The
port's run also holds its three stores to the numpy oracle after the load
and after the last workload (``check_answers``). Timed values are not
compared.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's benchmarks live at the root
    sys.path.insert(0, str(ROOT))

import benchmarks.common as RC  # noqa: E402
import benchmarks.fig17_ycsb as R17  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import fig17_ycsb as T17  # noqa: E402

CPU = "cpu"
SCALE = 1 / 64  # 937 keys, memtable of 128 entries


def names(csv):
    return [line.split(",")[0] for line in csv.rows]


def test_fig17_rows(monkeypatch):
    monkeypatch.setattr(R17, "N_KEYS", int(R17.N_KEYS * SCALE))
    monkeypatch.setattr(R17, "MEM", int(R17.MEM * SCALE))
    monkeypatch.setattr(R17, "OPS", 300)
    monkeypatch.setattr(T17, "OPS", 300)
    ref, port = RC.CSV(), TC.CSV()
    R17.run(ref)
    seen = []
    T17.run(port, scale=SCALE, device=CPU, check_answers=True,
            observe=lambda tag, stores, batches: seen.append(
                (tag, sorted(stores), [(label, len(k), n) for label, k, n in batches])))
    assert names(port) == names(ref)
    # observe: after the load and after the last workload, with the
    # check's batches and the workloads' 256-key gets and 64-start scans
    sent = [("get (check)", 4096, None), ("scan50 (check)", 64, 50),
            ("get 256 (zipf)", 256, None), ("scan50 64 (zipf)", 64, 50)]
    assert seen == [("fig17 load", ["leveled", "remixdb", "tiered"], sent),
                    ("fig17 end", ["leveled", "remixdb", "tiered"], sent)]


def test_check_scan_batch_holds_a_baseline_to_its_scan():
    """After the workloads the baselines' scans are held to their own
    ``scan`` per start; a scan_batch that drops a key fails it."""
    from repro_torch.db.baseline import BaselineConfig, LeveledStore

    s = LeveledStore(BaselineConfig(vw=2, memtable_entries=64, table_cap=64, device=CPU))
    keys = np.arange(1, 301, dtype=np.uint64) * 8
    for c in range(0, len(keys), 64):
        s.put_batch(keys[c: c + 64], np.zeros((len(keys[c: c + 64]), 2), np.uint32))
    s.put(int(keys[5]) + 1, np.ones(2, np.uint32))  # the memtable overlay
    assert len(s.mem)
    starts = keys[[0, 3, 100, 290]]
    T17.check_scan_batch(s, "leveled", starts, "t", n=10)
    real = s.scan_batch

    def short(st, n):
        k, m = real(st, n)
        m[1, 4] = False
        return k, m

    s.scan_batch = short
    with pytest.raises(AssertionError, match="is not its scan"):
        T17.check_scan_batch(s, "leveled", starts, "t", n=10)
