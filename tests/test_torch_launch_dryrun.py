"""The port's dry run and roofline (``repro_torch.launch.dryrun`` /
``shapes`` / ``roofline``) against the JAX package's.

The twin of ``tests/test_dryrun_sharded.py::test_dryrun_cell_compiles``:
the same two cells, run by the port's command line on a fake (32, 8)
mesh of 256 ranks, each in its own interpreter. Their per-device
``arg_bytes`` equal what the reference's rules place on each device.
The counting is held on a hand-checked sharded matmul; the carried HLO
parser gives the reference's totals on an HLO text the reference
compiles; the roofline applies the reference's formulas with H100
constants.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.launch import shapes as RSH  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import sharding as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import shapes as TSH  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401
from torch_mesh import fake_world, start_py, wait_all  # noqa: E402

CELLS = [("qwen2.5-3b", "train_4k"), ("mamba2-130m", "decode_32k")]
DRYRUN = "import sys; from repro_torch.launch.dryrun import main; main(sys.argv[1:])"


@pytest.fixture(scope="module", autouse=True)
def cell_runs():
    """Both cells' command lines, started together as the module starts;
    the other tests run while they do, and the cell tests (last in the
    file) wait for them."""
    procs = {c: start_py(DRYRUN, "--device", "cpu", "--arch", c[0], "--shape", c[1])
             for c in CELLS}
    yield procs
    for p in procs.values():  # a deselected cell test leaves its run going
        p.kill()
        p.wait()


class MeshDesc:
    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _per_device(shape, itemsize, spec, mesh) -> int:
    local = list(shape)
    for i, part in enumerate(spec):
        if part is not None:
            axes = (part,) if isinstance(part, str) else part
            local[i] //= math.prod(mesh.shape[a] for a in axes)
    return math.prod(local) * itemsize


def _reference_arg_bytes(arch, shape) -> int:
    """Per-device bytes of the cell's inputs under the reference's rules on
    the port's (32, 8) mesh: params, then the AdamW moments (float32, as
    the params), step and batch for a train cell, or cache and token for
    a decode cell (placed as the reference's dry run places them)."""
    mesh = MeshDesc((32, 8), ("data", "model"))
    rules = RS.ShardingRules(mesh=mesh)
    cfg = RC.get_config(arch)
    pv, pax = RL.split_params(jax.eval_shape(lambda: RM.init_params(cfg, jax.random.key(0))))
    axes = jax.tree.leaves(pax, is_leaf=lambda x: isinstance(x, tuple))
    vals = jax.tree.leaves(pv)
    total = sum(_per_device(v.shape, v.dtype.itemsize, rules.physical(a, shape=v.shape), mesh)
                for v, a in zip(vals, axes))
    spec = RSH.input_specs(cfg, shape)
    if spec["kind"] == "train":
        total += 2 * sum(_per_device(v.shape, 4, rules.physical(a, shape=v.shape), mesh)
                         for v, a in zip(vals, axes)) + 4
        for leaf in spec["batch"].values():
            logical = ("batch",) + (None,) * (leaf.ndim - 1)
            total += _per_device(leaf.shape, leaf.dtype.itemsize,
                                 rules.physical(logical, shape=leaf.shape), mesh)
        return total
    for leaf in jax.tree.leaves(spec["cache"]):
        logical = D._cache_logical(leaf.ndim)
        total += _per_device(leaf.shape, leaf.dtype.itemsize,
                             rules.physical(logical, shape=leaf.shape), mesh)
    tok = spec["token"]
    return total + _per_device(tok.shape, 4, rules.physical(("batch",), shape=tok.shape), mesh)


def test_remixdb_cell_counts_the_all_to_alls():
    """The sharded get over the flattened (32, 8) mesh: its four
    all_to_all's (queries, flags there; found, values back), each over
    the whole mesh."""
    D.fake_world(False)
    try:
        rec = D.run_cell("remixdb", "service", False, device="cpu")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["shape"] == "get_524288"
    coll = rec["collectives"]
    assert coll["counts"] == {"all-to-all": 4} and coll["by_axis"] == {"data+model": coll["total"]}
    cfg = TC.get_config("remixdb")
    nq = cfg.query_batch // 256
    cap = max(1, 2 * nq // 256)
    # (256, cap) slots out and back: queries (KW words), flags (1 byte),
    # found (1 byte), values (VW words)
    assert coll["total"] == 256 * cap * (4 * cfg.kw + 1 + 1 + 4 * cfg.vw)


def test_flops_are_per_device_on_a_hand_checked_matmul():
    """(4096 x 2048) @ (2048 x 11008) on a fake (2, 2) mesh, rows over data
    and columns over model: each device multiplies its (2048 x 2048) by
    (2048 x 5504), a quarter of the global FLOPs, with no collective. With
    the weight's rows also split over data, DTensor gathers the smaller
    operand (``a``, 32 MiB against the weight's 43 MiB) over data and
    splits it by columns: still a quarter of the FLOPs, one all-gather."""
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        axes = D.group_axes(mesh)
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(4096, 2048), mesh, [Shard(0), Replicate()])
            b = distribute_tensor(torch.empty(2048, 11008), mesh, [Replicate(), Shard(1)])
            counter = D.DeviceCounter(axes)
            with counter:
                c = a @ b
            assert c.to_local().shape == (2048, 5504)
            assert counter.flops == 2 * 4096 * 2048 * 11008 // 4
            assert counter.collectives()["total"] == 0
            assert counter.bytes == (2048 * 2048 + 2048 * 5504 + 2048 * 5504) * 4
            b2 = distribute_tensor(torch.empty(2048, 11008), mesh, [Shard(0), Shard(1)])
            counter = D.DeviceCounter(axes)
            with counter:
                a @ b2
            assert counter.flops == 2 * 4096 * 2048 * 11008 // 4
            coll = counter.collectives()
            assert coll["counts"] == {"all-gather": 1}
            assert coll["by_axis"] == {"data": 4096 * 2048 * 4}  # a, whole


def _specs_equal(port, ref) -> None:
    if isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            _specs_equal(port[k], ref[k])
    elif isinstance(port, torch.Tensor):
        assert tuple(port.shape) == tuple(ref.shape)
        assert str(port.dtype).split(".")[-1] == str(ref.dtype)
    else:
        assert port == ref


@pytest.mark.parametrize("shape", list(RSH.SHAPES))
def test_input_specs_equal_the_reference(shape):
    """Every arch's inputs for the shape: the same keys, shapes and dtypes
    (the reference's caches from ``jax.eval_shape``), and the same
    support verdicts."""
    assert TSH.SHAPES == RSH.SHAPES
    for arch in RC.ARCHS:
        r, t = RSH.input_specs(RC.get_config(arch), shape), TSH.input_specs(TC.get_config(arch), shape)
        _specs_equal(t, r)
        assert TSH.cell_supported(TC.get_config(arch), shape) == RSH.cell_supported(
            RC.get_config(arch), shape)


def _scan_hlo() -> str:
    """Optimized HLO of a small ``lax.scan`` with a dot in its body and one
    at top level, from the reference's own compiler."""

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None

        c, _ = jax.lax.scan(body, x, None, length=7)
        return c @ w.T

    x, w = jnp.ones((16, 32)), jnp.ones((32, 32))
    return jax.jit(f).lower(x, w).compile().as_text()


def test_carried_hlo_parser_gives_the_reference_totals():
    text = _scan_hlo()
    assert TR.total_cost(text) == RR.total_cost(text)
    assert TR.total_cost(text)["flops"] >= 7 * 2 * 16 * 32 * 32  # the body counted per trip
    line = "%ag = f32[8,128]{1,0} all-gather(f32[1,128]{1,0} %p), dimensions={0}"
    assert TR.collective_line_bytes(line) == RR.collective_line_bytes(line) == ("all-gather", 4096)


def test_analyze_cell_is_the_reference_with_h100_constants(monkeypatch):
    """A record without ``by_axis`` (one of the reference's): the
    reference's formulas with 989.4 TFLOP/s, 3.35 TB/s and the InfiniBand
    link; a record with it puts ``model`` bytes on NVLink."""
    rec = dict(arch="qwen2.5-3b", shape="train_4k", mesh="32x8", chips=256, status="ok",
               kind="train", flops=3.1e14, bytes_accessed=2.2e12, active_params=3.09e9,
               collectives=dict(bytes={"all-gather": 4e10}, total=4e10))
    monkeypatch.setattr(RR, "PEAK_FLOPS", 989.4e12)
    monkeypatch.setattr(RR, "HBM_BW", 3.35e12)
    monkeypatch.setattr(RR, "LINK_BW", 50e9)
    assert TR.analyze_cell(rec) == RR.analyze_cell(rec)
    rec["collectives"]["by_axis"] = {"model": 3e10, "data": 1e10}
    row = TR.analyze_cell(rec)
    assert row["t_collective"] == pytest.approx(3e10 / 450e9 + 1e10 / 50e9, rel=1e-12)
    assert row["t_compute"] == 3.1e14 / 989.4e12 and row["t_memory"] == 2.2e12 / 3.35e12
    dec = dict(rec, shape="decode_32k", kind="decode")
    assert TR.analyze_cell(dec)["model_flops"] == 2.0 * 3.09e9 * 128
    assert TR.analyze_cell(dict(rec, tokens=1024))["model_flops"] == 6.0 * 3.09e9 * 1024
    for name in ("PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "IB_BW"):
        assert getattr(TR, name) in (989.4e12, 3.35e12, 450e9, 50e9)
    src = open(TR.__file__).read()
    assert "197e12" not in src and "819e9" not in src  # no v5e constant left


def test_dryrun_without_cuda_raises_and_records_an_error(capsys):
    """Asked for the card where there is none: an error, no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.main(["--arch", "mamba2-130m", "--shape", "decode_32k"])
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "nope", "--shape", "decode_32k", "--device", "cpu"])
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["status"] == "error" and "unknown arch" in rec["error"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_runs(cell_runs, arch, shape):
    out = wait_all([cell_runs[(arch, shape)]], 900)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "32x8"
    assert rec["chips"] == 256
    assert rec["collectives"]["total"] > 0  # the mesh is actually used
    assert sum(rec["collectives"]["by_axis"].values()) == rec["collectives"]["total"]
    assert rec["arg_bytes"] == _reference_arg_bytes(arch, shape)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["temp_bytes"] > 0
    cfg = TC.get_config(arch)
    assert (rec["n_params"], rec["active_params"]) == (cfg.n_params(), cfg.active_params())
    row = TR.analyze_cell(rec)
    assert row["bottleneck"] in ("compute", "memory", "collective") and row["roofline_frac"] > 0
