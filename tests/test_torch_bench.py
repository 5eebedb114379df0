"""The port's figure benchmarks (``repro_torch.bench``) against the
reference's (``benchmarks/``), on the CPU at a tiny scale: the same row
names in the same order, the same tables, and the analytic rows equal to
the printed precision. Timed values are not compared (the CPU's times say
nothing of the card's). The store-level figures are in
``tests/test_torch_bench_stores.py``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's benchmarks live at the root
    sys.path.insert(0, str(ROOT))

import benchmarks.common as RC  # noqa: E402
import benchmarks.fig11_queries as R11  # noqa: E402
import benchmarks.fig13_groupsize as R13  # noqa: E402
import benchmarks.table1_storage as RT1  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import fig11_queries as T11  # noqa: E402
from repro_torch.bench import fig13_groupsize as T13  # noqa: E402
from repro_torch.bench import table1_storage as TT1  # noqa: E402
from repro_torch.device import u32_np  # noqa: E402

CPU = "cpu"


def once(fn, *args, **kw) -> float:
    """``time_batched`` without its repeats: the rows' times are not
    compared here, only their names and the answers."""
    fn(*args)
    return 1e-3


@pytest.fixture
def untimed(monkeypatch):
    for mod in (R11, T11, R13, T13):
        monkeypatch.setattr(mod, "time_batched", once)


def names(csv):
    """Each row's name, with its ``R=`` / ``D=`` parameter."""
    return [r[0] + ("," + r[1] if "=" in r[1] else "") for r in
            (line.split(",") for line in csv.rows)]


@pytest.mark.parametrize("locality", ["weak", "strong"])
@pytest.mark.parametrize("r,n", [(1, 700), (3, 1000), (4, 64)])
def test_make_tables_equal(locality, r, n):
    ref_runs, ref_keys = RC.make_tables(r, n, locality=locality)
    runs, keys = TC.make_tables(r, n, locality=locality, device=CPU)
    np.testing.assert_array_equal(ref_keys, keys)
    assert len(runs) == len(ref_runs)
    for a, b in zip(ref_runs, runs):
        for f in ("keys", "vals", "seq"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), u32_np(getattr(b, f)))
        np.testing.assert_array_equal(np.asarray(a.tomb), b.tomb.numpy())


@pytest.mark.parametrize("locality", ["weak", "strong"])
def test_fig11_rows_and_answers(locality, monkeypatch, untimed):
    """The same rows as the reference's benchmark, with every answer held to
    the numpy oracle (``check_answers``) and the analytic rows equal."""
    monkeypatch.setattr(R11, "N_PER_TABLE", 256)
    ref, port = RC.CSV(), TC.CSV()
    R11.run(ref, locality=locality, rs=(1, 2))
    T11.run(port, locality=locality, rs=(1, 2), n_per_table=256, device=CPU,
            check_answers=True)
    assert names(port) == names(ref)
    assert port.rows[-2:] == ref.rows[-2:]  # the analytic comparison counts
    bloom = [r for r in port.rows if "_get_sstable_bloom," in r]
    assert bloom and all(r.endswith("corrected probe (non-wrapping bit positions)")
                         for r in bloom)


def test_fig11_checks_catch_a_wrong_answer(monkeypatch, untimed):
    """The oracle checks fail when an engine answers wrong."""
    from repro_torch.core import merge_iter as M

    real = M.seek_cursors
    monkeypatch.setattr(M, "seek_cursors", lambda rs, q: real(rs, q) + 1)
    with pytest.raises(AssertionError, match="merging seek"):
        T11.run(TC.CSV(), rs=(2,), n_per_table=128, device=CPU, check_answers=True)


def test_fig13_rows(monkeypatch, untimed):
    ref, port = RC.CSV(), TC.CSV()
    real = RC.make_tables
    monkeypatch.setattr(R13, "make_tables", lambda r, n, **kw: real(r, 256, **kw))
    R13.run(ref)
    T13.run(port, n_per_table=256, device=CPU)
    assert names(port) == names(ref)
    # bytes per key of the built index: a count, equal in both
    assert [r for r in port.rows if "index_bytes" in r] == \
        [r for r in ref.rows if "index_bytes" in r]


def test_table1_rows_equal():
    """Every row, analytic and the built REMIX's cross-check, equal to the
    reference's to the printed precision."""
    ref, port = RC.CSV(), TC.CSV()
    RT1.run(ref)
    TT1.run(port, device=CPU)
    assert port.rows == ref.rows
    assert len(port.rows) == 8 * 6 + 3


def test_zipf_keys_equal():
    a = RC.zipf_keys(np.random.default_rng(3), 10_000, 512)
    b = TC.zipf_keys(np.random.default_rng(3), 10_000, 512)
    np.testing.assert_array_equal(a, b)


def test_profile_is_off_by_default_and_rows_print_as_the_reference(capsys):
    csv = TC.CSV()
    assert csv.profile is False
    csv.emit("x,R=1", 1.23456, "d", call=lambda: pytest.fail("profiled while off"))
    assert capsys.readouterr().out == "x,R=1,1.235,d\n"
    assert csv.profiles == {}


def test_profile_belongs_to_the_row_given_the_call(monkeypatch, capsys):
    """A profiling CSV profiles the ``call`` each row is given, once, with
    that row's time, and keeps it under that row's name; a row given no
    call carries none (the profiler itself needs the card)."""
    seen = []

    def fake(fn, wall_s=None):
        fn()
        seen.append(wall_s)
        return dict(busy_us=1.0, launches=2, busy_share=0.5)

    monkeypatch.setattr(TC, "profile_call", fake)
    csv = TC.CSV(profile=True)
    calls = []
    csv.emit("a", 1.0, "", call=lambda: calls.append("a"), wall_s=0.25)
    csv.emit("b", 2.0, "")
    csv.emit("c", 3.0, "", call=lambda: calls.append("c"))
    assert calls == ["a", "c"] and seen == [0.25, None]
    assert list(csv.profiles) == ["a", "c"]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "a,1.000," and out[1].startswith("# profile a: device busy 1.0 us")
    assert out[2] == "b,2.000," and out[3] == "c,3.000,"


def test_run_cli_lists_the_six_entries():
    from repro_torch.bench import run

    # the six figures, then the eight system benchmarks (ported later)
    assert list(run.benches(CPU)) == ["fig11", "fig12", "fig13", "table1",
                                      "fig14_16", "fig17", "kernels", "rebuild",
                                      "scrub", "cache", "batch", "cursor", "engine",
                                      "cluster"]
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--only", "table1",
         "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr
    out = p.stdout.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("table1_UDB_sstable_BI,") and "# table1 done" in out[-1]
