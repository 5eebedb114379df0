"""Scaffold checks for the PyTorch/CUDA port (``src/repro_torch``): it
imports neither JAX nor the JAX package, and its entry points refuse to
run on the CPU unless asked to."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch."))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(bad), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 []"), out.stdout
    assert len(MODULES) >= 15


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.M,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), path


def test_forbidden_pattern_tells_repro_from_repro_torch():
    assert FORBIDDEN.search("from repro.core import keys")
    assert FORBIDDEN.search("import repro.kernels.ops as ops")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.core import keys")
    assert not FORBIDDEN.search("import repro_torch")


def _entry_points():
    from repro_torch.core.remix import remix_from_arrays, remix_from_order
    from repro_torch.core.runs import make_run, runset_from_arrays
    from repro_torch.db.partition import Partition
    from repro_torch.device import resolve
    from repro_torch.kernels.device_view import DeviceViewManager

    k = np.zeros((1, 2), np.uint32)
    one = np.zeros(1, np.int32)
    return {
        "resolve": lambda: resolve(),
        "DeviceViewManager": lambda: DeviceViewManager(1 << 20),
        "Partition": lambda: Partition(0, []),
        "make_run": lambda: make_run(np.arange(4, dtype=np.uint64)),
        "remix_from_arrays": lambda: remix_from_arrays(k, one[:, None], np.zeros(8, np.uint8), 1, 8),
        "runset_from_arrays": lambda: runset_from_arrays(k[None], k[None], one[None], one[None] > 0, one),
        "remix_from_order": lambda: remix_from_order(one, one, one > -1, [k], 8),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_entry_points_run_on_the_cpu_when_asked():
    from repro_torch.core.runs import make_run
    from repro_torch.db.partition import Partition
    from repro_torch.kernels.device_view import DeviceViewManager

    assert make_run(np.arange(4, dtype=np.uint64), device="cpu").keys.device.type == "cpu"
    assert Partition(0, [], device="cpu").device.type == "cpu"
    assert DeviceViewManager(1 << 20, device="cpu").device.type == "cpu"


def test_file_backed_table_answers_from_the_header(tmp_path):
    """A lazy ``Table(path=...)`` answers ``n``, ``vw`` and ``repr`` from
    the file's header and loads no section."""
    from repro_torch.db.partition import Table
    from repro_torch.io import write_sstable

    keys = np.stack([np.zeros(100, np.uint32), np.arange(100, dtype=np.uint32)], 1)
    path = str(tmp_path / "t.sst")
    write_sstable(path, keys, np.zeros((100, 3), np.uint32), np.arange(100),
                  np.zeros(100, bool))
    t = Table(path=path)
    assert repr(t) == f"Table(path={path!r}, n=?, resident=False)"
    assert (t.n, t.vw) == (100, 3)
    assert repr(t) == f"Table(path={path!r}, n=100, resident=False)"
    assert not t.resident
    assert not any(t._rd().bytes_read.values())
