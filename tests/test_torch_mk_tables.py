"""``repro_torch.tools.mk_tables`` against the reference's ``results/mk_tables.py``.

Records come from the port's dry run: the cheapest cell that
``tests/test_torch_launch_dryrun.py`` runs (``mamba2-130m decode_32k``) and
one that the dry run skips (``qwen2.5-3b long_500k``). Both packages' table
functions get the same analysed rows; the port's tables equal the
reference's apart from the column ``trace s`` (the reference's
``compile s``) and the single-pod mesh label (``32x8`` for ``16x16``).
"""
import importlib.util
import json
import pathlib

import pytest

pytest.importorskip("torch")

from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.roofline import analyze_cell  # noqa: E402
from repro_torch.tools import mk_tables as T  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("ref_mk_tables", ROOT / "results" / "mk_tables.py")
ref_mk_tables = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_mk_tables)

CELLS = (("mamba2-130m", "decode_32k"), ("qwen2.5-3b", "long_500k"))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "base.jsonl"
    for arch, shape in CELLS:
        with pytest.raises(SystemExit) as done:
            D.main(["--device", "cpu", "--arch", arch, "--shape", shape, "--out", str(path)])
        assert done.value.code == 0
    return path


def _as_reference(rows):
    """The same rows as the reference's tables read them."""
    out = []
    for r in rows:
        if r.get("status") == "ok":
            r = dict(r, compile_s=r["trace_s"],
                     mesh="16x16" if r["mesh"] == T.SINGLE_POD else r["mesh"])
        out.append(r)
    return out


def test_records_one_ok_one_skipped(records):
    recs = [json.loads(line) for line in open(records)]
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        ("mamba2-130m", "decode_32k", "ok"), ("qwen2.5-3b", "long_500k", "skipped")]


def test_dryrun_table_matches_reference(records):
    rows = T.load(str(records))
    port = T.dryrun_table(rows).splitlines()
    ref = ref_mk_tables.dryrun_table(_as_reference(rows)).splitlines()
    assert port[0] == ref[0].replace("| compile s |", "| trace s |")
    assert "| trace s |" in port[0]
    ok_row = f"| mamba2-130m | decode_32k | {T.SINGLE_POD} | {rows[0]['trace_s']} |"
    assert port[2].startswith(ok_row)
    assert port[2] == ref[2].replace("| 16x16 |", f"| {T.SINGLE_POD} |")
    assert port[3] == ref[3]
    assert port[3] == ("| qwen2.5-3b | long_500k | 32x8 | — | — | — | — | "
                       "SKIPPED: pure full-attention arch: 500k decode skipped (D |")
    assert len(port) == 2 + len(CELLS)


def test_roofline_table_matches_reference(records):
    rows = T.load(str(records))
    for other in (None, rows):
        port = T.roofline_table(rows, other)
        ref_rows = _as_reference(rows)
        ref = ref_mk_tables.roofline_table(ref_rows, ref_rows if other else None)
        assert port == ref
    lines = T.roofline_table(rows).splitlines()
    assert len(lines) == 3  # the skipped cell has no roofline row
    bottleneck = analyze_cell(json.loads(open(records).readline()))["bottleneck"]
    assert lines[2].split(" | ")[5] == bottleneck


def test_command_line(records, capsys):
    assert T.main(["--base", str(records), "--opt", str(records)]) == 0
    out = capsys.readouterr().out
    assert "### Dry-run (both meshes)" in out and "### Roofline (single-pod 32×8)" in out
    assert "| trace s |" in out and "SKIPPED: " in out and "pp |" in out
