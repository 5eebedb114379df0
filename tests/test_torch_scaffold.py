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
    assert {"repro_torch.serve", "repro_torch.serve.engine", "repro_torch.cluster",
            "repro_torch.cluster.cluster", "repro_torch.cluster.replica",
            "repro_torch.cluster.ship", "repro_torch.cluster.placement",
            "repro_torch.core.bloom", "repro_torch.core.merge_iter",
            "repro_torch.db.baseline", "repro_torch.db.sstable",
            "repro_torch.db.sharded", "repro_torch.configs.remixdb",
            "repro_torch.bench.common", "repro_torch.bench.fig11_queries",
            "repro_torch.bench.fig13_groupsize", "repro_torch.bench.table1_storage",
            "repro_torch.bench.fig14_16_stores", "repro_torch.bench.fig17_ycsb",
            "repro_torch.bench.run", "repro_torch.configs.base",
            "repro_torch.configs.qwen2_5_3b", "repro_torch.models.sharding",
            "repro_torch.models.layers", "repro_torch.models.model",
            "repro_torch.models.kvcache", "repro_torch.models.convert",
            "repro_torch.train.optimizer", "repro_torch.train.train_step",
            "repro_torch.train.checkpoint", "repro_torch.train.compress",
            "repro_torch.train.minipack", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.shapes", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline"} <= set(MODULES)


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
    """Each entry point, called with a scratch directory."""
    from repro_torch.bench.common import make_tables, qkeys
    from repro_torch.cluster import Cluster
    from repro_torch.configs.remixdb import RemixServiceConfig
    from repro_torch.core.bloom import build_bloom
    from repro_torch.core.remix import remix_from_arrays, remix_from_order
    from repro_torch.db.baseline import LeveledStore, TieredStore
    from repro_torch.db.sharded import build_demo_state
    from repro_torch.db.sstable import SSTableMeta
    from repro_torch.core.runs import make_run, runset_from_arrays
    from repro_torch.db.partition import Partition
    from repro_torch.db.store import RemixDB
    from repro_torch.device import resolve
    from repro_torch.kernels.device_view import DeviceViewManager
    from repro_torch.serve import KVServeEngine, ServeEngine
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.kvcache import PrefixCache, RemixPageTable
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.dryrun import main as dryrun_main
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.train.checkpoint import restore

    lm = reduced(get_config("qwen2.5-3b"), n_layers=1, d_model=64, d_ff=64, vocab=32)
    k = np.zeros((1, 2), np.uint32)
    one = np.zeros(1, np.int32)
    return {
        "resolve": lambda tmp: resolve(),
        "DeviceViewManager": lambda tmp: DeviceViewManager(1 << 20),
        "Partition": lambda tmp: Partition(0, []),
        "RemixDB": lambda tmp: RemixDB(),
        "KVServeEngine": lambda tmp: KVServeEngine([(0, str(tmp / "s0"))]),
        "Cluster": lambda tmp: Cluster(str(tmp / "fleet")),
        "make_run": lambda tmp: make_run(np.arange(4, dtype=np.uint64)),
        "remix_from_arrays": lambda tmp: remix_from_arrays(k, one[:, None], np.zeros(8, np.uint8), 1, 8),
        "runset_from_arrays": lambda tmp: runset_from_arrays(k[None], k[None], one[None], one[None] > 0, one),
        "remix_from_order": lambda tmp: remix_from_order(one, one, one > -1, [k], 8),
        "build_bloom": lambda tmp: build_bloom([k]),
        "SSTableMeta.build": lambda tmp: SSTableMeta.build(np.arange(4, dtype=np.uint64), 24),
        "LeveledStore": lambda tmp: LeveledStore(),
        "TieredStore": lambda tmp: TieredStore(),
        "build_demo_state": lambda tmp: build_demo_state(
            RemixServiceConfig(entries_per_run=8, runs_per_partition=1), 2),
        "make_tables": lambda tmp: make_tables(1, 8),
        "qkeys": lambda tmp: qkeys(np.random.default_rng(0), 100, 4),
        "init_params": lambda tmp: init_params(lm, 0),
        "init_cache": lambda tmp: init_cache(lm, 1, 8),
        "params_from_numpy": lambda tmp: params_from_numpy({"w": np.zeros(2, np.float32)}),
        "RemixPageTable": lambda tmp: RemixPageTable(),
        "PrefixCache": lambda tmp: PrefixCache(lm, 4),
        "ServeEngine": lambda tmp: ServeEngine(lm, {}),
        "DataPipeline.get_batch": lambda tmp: DataPipeline(vocab=32, batch=1, seq=4).get_batch(0),
        "checkpoint.restore": lambda tmp: restore(str(tmp / "ckpt")),
        "launch.train.main": lambda tmp: train_main(["--steps", "1", "--ckpt", str(tmp / "c")]),
        "launch.dryrun.main": lambda tmp: dryrun_main(["--arch", "mamba2-130m",
                                                       "--shape", "decode_32k"]),
        "launch.mesh.make_debug_mesh": lambda tmp: make_debug_mesh(),
        "launch.mesh.make_production_mesh": lambda tmp: make_production_mesh(),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name](tmp_path)


def test_entry_points_run_on_the_cpu_when_asked(tmp_path):
    from repro_torch.core.runs import make_run
    from repro_torch.db.partition import Partition
    from repro_torch.kernels.device_view import DeviceViewManager

    assert make_run(np.arange(4, dtype=np.uint64), device="cpu").keys.device.type == "cpu"
    assert Partition(0, [], device="cpu").device.type == "cpu"
    assert DeviceViewManager(1 << 20, device="cpu").device.type == "cpu"
    from repro_torch.db.store import RemixDB, RemixDBConfig

    db = RemixDB(RemixDBConfig(device="cpu"))
    assert db.device.type == "cpu" and db.device_views is None
    assert db.partitions[0].device.type == "cpu"
    from repro_torch.cluster import Cluster

    with Cluster(str(tmp_path / "fleet"), lows=(0, 1 << 32),
                 config=RemixDBConfig(device="cpu")) as c:
        assert [db.device.type for db in c.serve.shards] == ["cpu", "cpu"]


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
