"""The port's fig14–16 benchmark (``repro_torch.bench.fig14_16_stores``)
against the reference's (``benchmarks/``), on the CPU at a tiny scale: the
same row names in the same order, and fig16's write amplification (the
stores' written bytes over the user's) equal. The port's run also holds
its three stores to the numpy oracle after every load (``check_answers``).
Timed values are not compared. fig17 is in ``tests/test_torch_bench_ycsb.py``.
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
import benchmarks.fig14_16_stores as R14  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import fig14_16_stores as T14  # noqa: E402

CPU = "cpu"
SCALE = 1 / 64  # 1,875 keys, memtable and tables of 128 entries


def names(csv):
    return [line.split(",")[0] for line in csv.rows]


def test_fig14_16_rows_and_write_amplification(monkeypatch):
    for name in ("N_KEYS", "MEM", "CAP"):
        monkeypatch.setattr(R14, name, int(getattr(R14, name) * SCALE))
    ref, port = RC.CSV(), TC.CSV()
    R14.run(ref)
    seen = []
    T14.run(port, scale=SCALE, device=CPU, check_answers=True,
            observe=lambda tag, stores, batches: seen.append(
                (tag, [(label, len(k), n) for label, k, n in batches])))
    assert names(port) == names(ref)
    # observe: after each load, the check's batches and the figure's own
    check = [("get (check)", 4096, None), ("scan50 (check)", 64, 50)]
    seeks = [(f"seek {p}", 512, 1) for p in ("seq", "zipf", "uni")]
    scans = [(f"scan{n}", 256, n) for n in (10, 50, 200)]
    assert seen == [("fig14 40B", check + seeks), ("fig14 120B", check + seeks + scans),
                    ("fig14 400B", check + seeks), ("fig16 120B", check)]
    wa = lambda csv: [r for r in csv.rows if r.startswith("fig16_")]  # noqa: E731
    # the write rows' derived WA, and the RemixDB tables+WAL row, are equal
    assert [r.split(",")[2] for r in wa(port)] == [r.split(",")[2] for r in wa(ref)]
    assert wa(port)[-1] == wa(ref)[-1]


class _Store:
    """A store whose scans come back one key short from the second start."""

    def __init__(self, skeys):
        self.skeys = skeys

    def scan_batch(self, starts, n):
        at = np.searchsorted(self.skeys, starts)
        k = np.zeros((len(starts), n), np.uint64)
        m = np.zeros((len(starts), n), bool)
        for i, a in enumerate(at):
            got = self.skeys[a: a + n - (i > 0)]
            k[i, : len(got)], m[i, : len(got)] = got, True
        return k, m


def test_check_scans_takes_no_short_scan():
    """A scan short of the oracle's fails the check, for every store."""
    skeys = np.arange(1, 1001, dtype=np.uint64) * 8
    starts = skeys[[10, 500]]
    T14.check_scans(_Store(skeys), "leveled", skeys, starts[:1], "t")
    with pytest.raises(AssertionError, match="is not the oracle's"):
        T14.check_scans(_Store(skeys), "leveled", skeys, starts, "t")
