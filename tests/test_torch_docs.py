"""``repro_torch.tools.check_docs``: the repo's doc snippets on the port.

The blocks are the ones the reference's ``tools/check_docs.blocks`` finds in
``docs/*.md``; each runs through the port's rewrite map on the CPU, one case
per block. A block the map cannot carry is reported as ``FAIL``, never
skipped.
"""
import importlib.util
import pathlib

import pytest

pytest.importorskip("torch")

from repro_torch.tools import check_docs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("ref_check_docs", ROOT / "tools" / "check_docs.py")
ref_check_docs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_check_docs)

REF_BLOCKS = [
    (f"docs/{doc.name}:{line}", code)
    for doc in sorted((ROOT / "docs").glob("*.md"))
    for line, code in ref_check_docs.blocks(doc.read_text())
]


def test_fourteen_blocks_as_the_reference_finds_them():
    assert len(REF_BLOCKS) == 14
    assert check_docs.collect(check_docs.DOCS) == REF_BLOCKS


@pytest.mark.parametrize("label,code", REF_BLOCKS, ids=[lb for lb, _ in REF_BLOCKS])
def test_block_runs_on_the_port(label, code):
    carried = check_docs.carry(code, "cpu")
    assert "repro." not in carried.replace("repro_torch.", "")
    assert check_docs.run_block(code, label, "cpu") is None


def test_uncarried_block_is_reported_as_fail(tmp_path, monkeypatch, capsys):
    (tmp_path / "A.md").write_text(
        "```python\nimport jax\n```\n\n"
        "```python\nfrom repro.db.store import RemixDB as DB, RemixDBConfig\n"
        "db = DB(RemixDBConfig(**{}))\n```\n\n"
        "```python\nfrom repro.db.store import RemixDB as DB\n"
        "db = DB()\ndb.put(3, [1, 2])\nassert db.get(3).tolist() == [1, 2]\n```\n"
    )
    monkeypatch.setattr(check_docs, "DOCS", tmp_path)
    assert check_docs.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("FAIL ") and "A.md:2: cannot carry: imports jax" in out[0]
    assert out[1].startswith("FAIL ") and "cannot carry: RemixDBConfig(**...)" in out[1]
    assert out[-2].startswith("ok ")
    assert out[-1] == "1/3 doc snippets passed"
