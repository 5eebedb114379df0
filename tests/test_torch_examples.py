"""The port's examples (``repro_torch.examples``) and ``obstool``
(``repro_torch.tools``) against the reference's (``examples/``,
``tools/obstool.py``), on the CPU: quickstart prints what the reference
prints; kvstore_serving (at 40,000 keys) prints the same lines apart from
its times, with the same answers and write amplification; the serving
example's tokens equal the reference engine's from the reference's params
(float32); train_lm resumes exactly and writes a checkpoint the
reference's ``restore`` reads; obstool's ``show`` / ``--prom`` / ``diff``
output is the reference tool's, byte for byte, and ``health`` exits as
the reference's does on a clean and on a corrupted store.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.train import checkpoint as RCk  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.db.store import RemixDB, RemixDBConfig  # noqa: E402
from repro_torch.examples import kvstore_serving as TKV  # noqa: E402
from repro_torch.examples import quickstart as TQ  # noqa: E402
from repro_torch.examples import serve_llm_prefix_cache as TServe  # noqa: E402
from repro_torch.examples import train_lm as TTrain  # noqa: E402
from repro_torch.io.faults import flip_bytes  # noqa: E402
from repro_torch.models.convert import numpy_from_params, params_from_numpy  # noqa: E402
from repro_torch.obs.metrics import save_snapshot  # noqa: E402
from repro_torch.tools import obstool as TObs  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def run_reference(name: str, subs=(), tmp=None) -> tuple[dict, str]:
    """Execute ``examples/<name>`` with each ``(old, new)`` text substitution
    (the scripts take no arguments); returns its globals and its stdout.
    ``tmp``: where its ``tempfile.mkdtemp`` points."""
    path = ROOT / "examples" / name
    src = path.read_text()
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    ns = {"__name__": "reference_example"}
    out = io.StringIO()
    import tempfile

    mkdtemp = tempfile.mkdtemp
    if tmp is not None:
        tempfile.mkdtemp = lambda prefix="": str(tmp)
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(src, str(path), "exec"), ns)
    finally:
        tempfile.mkdtemp = mkdtemp
    return ns, out.getvalue()


def stdout_of(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(*args)
    return got, out.getvalue()


def untimed(text: str) -> str:
    """Printed lines with their times replaced."""
    return re.sub(r"\d+\.\d+ ?m?s\b", "<t>", text)


def test_quickstart_prints_the_reference_arrays():
    _, want = run_reference("quickstart.py")
    _, got = stdout_of(TQ.main, ["--device", CPU])
    assert got == want
    assert "scan(17, 6): [17 23 29 31 43 52]" in got


def test_kvstore_serving_matches_reference(tmp_path):
    n = 40_000  # the reference's 200,000 at a fifth: 3 tables, minor compactions
    ns, want = run_reference("kvstore_serving.py", [("N = 200_000", f"N = {n}")],
                             tmp=tmp_path / "ref")
    got, printed = stdout_of(TKV.serve, n, str(tmp_path / "port"), CPU)
    assert untimed(printed) == untimed(want)
    np.testing.assert_array_equal(got["probe"], ns["probe"])
    np.testing.assert_array_equal(got["found"], ns["found"])
    assert got["stats"]["wa"] == ns["st"]["wa"] and got["kinds"] == ns["kinds"]
    assert got["hot"] and got["present"] and got["found"].all()


def test_serving_example_tokens_equal_reference():
    """The reference example's engine run in float32, and the port's
    ``serve`` on the same requests from the reference's params: the same
    tokens with and without the cache, the same prefill and reuse."""
    ns, _ = run_reference("serve_llm_prefix_cache.py",
                          [("vocab=2048)", 'vocab=2048, dtype="float32")')])
    cfg = dataclasses.replace(reduced(get_config(TServe.ARCH), **TServe.WIDTHS),
                              dtype="float32")
    assert cfg.d_model == ns["cfg"].d_model and cfg.n_layers == ns["cfg"].n_layers
    for a, b in zip(TServe.make_requests(cfg.vocab), ns["requests"]):
        np.testing.assert_array_equal(a, b)
    pv = params_from_numpy(jax.tree.map(np.asarray, ns["pv"]), CPU)
    got, _ = stdout_of(TServe.serve, cfg, pv, ns["requests"], CPU)
    for a, b in zip(got["plain"] + got["cached"], ns["outs_plain"] + ns["outs_cached"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert dataclasses.astuple(got["stats"]) == dataclasses.astuple(ns["eng"].stats)
    assert dataclasses.astuple(got["cached_stats"]) == dataclasses.astuple(ns["eng2"].stats)
    assert got["lookups"] == ns["cache"].table.lookups > 0


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_train_lm_resumes_exactly_and_reference_reads_checkpoint(tmp_path, monkeypatch):
    """Four steps straight, and two steps then a resumed run to four: the
    same last loss and the same params; the reference's
    ``checkpoint.restore`` reads the resumed run's last checkpoint."""
    monkeypatch.setattr(TTrain, "REDUCED", dict(d_model=64, n_layers=2, vocab=256, d_ff=128,
                                                n_heads=4, n_kv_heads=2, head_dim=16))
    args = ["--batch", "2", "--seq", "16", "--device", CPU]
    straight, _ = stdout_of(TTrain.main, args + ["--steps", "4", "--ckpt", str(tmp_path / "a")])
    first, _ = stdout_of(TTrain.main, args + ["--steps", "2", "--ckpt", str(tmp_path / "b")])
    resumed, printed = stdout_of(TTrain.main, args + ["--steps", "4", "--ckpt",
                                                      str(tmp_path / "b")])
    assert first["start"] == 0 and resumed["start"] == 2
    assert "resumed from checkpoint at step 2" in printed
    assert resumed["losses"][3] == straight["losses"][3]
    want = flat(numpy_from_params(straight["params"]))
    rp, ro, extra = RCk.restore(str(tmp_path / "b"))
    assert extra["data"]["step"] == 4 and RCk.latest_step(str(tmp_path / "b")) == 4
    got = flat(jax.tree.map(np.asarray, rp))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def ref_obstool():
    spec = importlib.util.spec_from_file_location("ref_obstool", ROOT / "tools" / "obstool.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A flushed persistent store (the port's, on the CPU) and two metrics
    snapshots of it: before and after a batch of reads."""
    base = tmp_path_factory.mktemp("obs")
    root = str(base / "db")
    db = RemixDB.open(root, RemixDBConfig(memtable_entries=1 << 12, device=CPU))
    try:
        ks = np.arange(1, 20_001, dtype=np.uint64) * 8
        db.put_batch(ks, np.stack([ks.astype(np.uint32), np.ones(len(ks), np.uint32)], 1))
        db.flush()
        save_snapshot(db.metrics(), base / "before.json")
        db.get_batch(ks[::7])
        db.scan_batch(ks[::997], 20)
        save_snapshot(db.metrics(), base / "after.json")
    finally:
        db.close()
    return base


def _both(ref_obstool, argv, port_extra=()):
    """(reference rc, stdout), (port rc, stdout) of one command line."""
    ref = stdout_of(ref_obstool.main, list(argv))
    port = stdout_of(TObs.main, list(argv) + list(port_extra))
    return ref, port


@pytest.mark.parametrize("cmd", ["show", "show --prom", "show --filter cache",
                                 "diff", "diff --filter table"])
def test_obstool_output_equals_reference(ref_obstool, store_dir, cmd):
    before, after = str(store_dir / "before.json"), str(store_dir / "after.json")
    words = cmd.split()
    argv = [words[0]] + ([before, after] if words[0] == "diff" else [after]) + words[1:]
    ref, port = _both(ref_obstool, argv)
    assert port == ref and ref[0] == 0 and ref[1]


def test_obstool_health_exit_codes_equal_reference(ref_obstool, store_dir, tmp_path):
    """``health`` on a clean store exits 0; ``health --scrub`` on a copy
    with a flipped table byte exits non-zero, on both tools (each tool on
    its own copy: the scrub quarantines what it cannot repair)."""
    clean = str(store_dir / "db")
    ref, port = _both(ref_obstool, ["health", clean], ["--device", CPU])
    assert ref[0] == port[0] == 0
    assert "status: ok" in port[1]
    rots = []
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        shutil.copytree(clean, d)
        tables = sorted(os.listdir(os.path.join(d, "tables")))
        t = os.path.join(d, "tables", tables[0])
        flip_bytes(t, offset=os.path.getsize(t) // 4, nbytes=1)
        rots.append(d)
    ref = stdout_of(ref_obstool.main, ["health", rots[0], "--scrub"])
    port = stdout_of(TObs.main, ["health", rots[1], "--scrub", "--device", CPU])
    assert ref[0] == port[0] != 0
    assert "status: ok" not in port[1]


def test_obstool_health_needs_a_card_by_default(store_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TObs.main(["health", str(store_dir / "db")])
