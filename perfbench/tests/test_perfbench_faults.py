"""The comparison has to fail: the control (the reference store in the
program's place with 16-bit value words) and the program with its timed
path broken underneath, once for each fault a cell can have."""
import numpy as np
import pytest

from perfbench_tiny import ROOT, scan_bench, tiny

from perfbench import loop
from perfbench.system import ProgramSystem

from repro_torch.db import executor as EX
from repro_torch.db import ops as OPS
from repro_torch.db import store as ST
from repro_torch.db.cursor import RemixCursor
from repro_torch.kernels import device_view as DV

CELLS = ["ycsb-c.kv120", "ycsb-e.kv120", "ycsb-c.kv1k-serve3"]


def _root(cell, tmp_path):
    """The scan cell is not in BENCHMARK.json; its mix comes from files."""
    return scan_bench(tmp_path) if cell == "ycsb-e.kv120" else ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    out = tiny(cell, control=True, root=_root(cell, tmp_path))
    assert not out["correct"]
    assert max(c["value"] for c in out["checks"].values()) > 0


def _unchanged(monkeypatch):
    """A write acknowledged and never applied: the state stays as it was."""
    monkeypatch.setattr(ST.RemixDB, "_apply_writes", lambda self, *a, **k: None)


def _half_gets(monkeypatch):
    """Half of a get batch left out: its second half reads as absent."""
    orig = DV.DeviceViewManager.get_batch

    def half(self, dv, keys, now):
        f, v = orig(self, dv, keys, now)
        f = f.copy()
        f[len(f) // 2:] = False
        return f, v

    monkeypatch.setattr(DV.DeviceViewManager, "get_batch", half)


def _truncated_results(monkeypatch):
    """Half of the batch left out of its answer: the executor's result list
    holds the first half of the ops' results (a one-op batch keeps its op)."""
    def half(results, stats, trace=None):
        return OPS.BatchResult(list(results)[: max(1, len(results) // 2)], stats, trace=trace)

    monkeypatch.setattr(EX, "BatchResult", half)


def _half_scans(monkeypatch):
    """Half of each scan's rows left out."""
    orig = RemixCursor.next_batch

    def half(self, n):
        k, v = orig(self, n)
        return k[: len(k) // 2], v[: len(k) // 2]

    monkeypatch.setattr(RemixCursor, "next_batch", half)


def _no_fan_in(monkeypatch):
    """The exchange between shards left out: the shards after the first
    answer nothing to the fan-in (their keys read as absent)."""
    orig = ST.RemixDB._get_batch_at

    def first_only(self, view, keys):
        f, v = orig(self, view, keys)
        if not self.cfg.data_dir.endswith("shard0"):
            f = np.zeros_like(f)
        return f, v

    monkeypatch.setattr(ST.RemixDB, "_get_batch_at", first_only)


def _altered_fetch(monkeypatch):
    """An answer altered where it is produced: a bit of the last array a
    device view fetches (the values) flipped."""
    orig = DV._fetch

    def flip(*tensors):
        out = orig(*tensors)
        last = out[-1]
        if last.size and last.dtype != bool:
            last = last.copy()
            last.reshape(-1)[0] ^= 1
            out[-1] = last
        return out

    monkeypatch.setattr(DV, "_fetch", flip)


def _altered_window(monkeypatch):
    """An answer altered where it is produced: the cursor's first row of
    every window comes back with a bit flipped."""
    orig = RemixCursor._next_window

    def flip(self):
        kk, vv, done = orig(self)
        if len(vv):
            vv = np.array(vv, copy=True)
            vv[0, 0] ^= 1
        return kk, vv, done

    monkeypatch.setattr(RemixCursor, "_next_window", flip)


FAULTS = {
    "ycsb-c.kv120": [_half_gets, _altered_fetch, _truncated_results],
    "ycsb-e.kv120": [_unchanged, _half_scans, _altered_window],
    "ycsb-c.kv1k-serve3": [_half_gets, _no_fan_in, _altered_fetch, _truncated_results],
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, tmp_path):
    """The fault goes in once set-up has loaded the store: it breaks the
    path that the warm-up and the window drive."""
    load = ProgramSystem.load

    def load_then_break(self, keys, vals):
        load(self, keys, vals)
        fault(monkeypatch)

    monkeypatch.setattr(ProgramSystem, "load", load_then_break)
    monkeypatch.setattr(loop, "WARMUP_MAX_S", 5.0)  # a broken store may never be ready
    out = tiny(cell, root=_root(cell, tmp_path))
    assert not out["correct"], out["checks"]
