"""Dry run: every (arch × shape × mesh) cell's step, run once on fake
tensors over a fake process group (the reference's ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 fake XLA host devices
and reads XLA's memory and cost analyses and the HLO's collectives. The
port has no compiler to ask, so it runs the step itself, as rank 0 of a
``fake`` process group of 256 (``(32, 8)``) or 512 (``(2, 32, 8)``) ranks,
with every tensor a ``FakeTensor`` (shapes, dtypes and devices; no data,
no kernel). Params, optimizer state, batch and cache are DTensors placed
by the sharding rules; DTensor then issues the collectives that the
placements need, and the fake group answers them without moving data.

What one device does is counted by :class:`DeviceCounter`, a
``TorchDispatchMode`` that sees the *local* shards (it lets DTensor
unwrap first) and the ``_c10d_functional`` / ``c10d`` collectives:

  - ``flops``: from each local matmul's shapes (``torch.utils.flop_counter``'s
    formulas); per device, not global;
  - ``bytes_accessed``: the bytes of every local op's tensor inputs and
    outputs, ops without a tensor result and views excluded. This is unfused eager traffic: every
    elementwise op reads and writes HBM, where XLA's count is of its
    fused program, so the port's figure is an upper bound of the same
    program's traffic;
  - ``collectives``: result bytes and counts by kind (the reference's
    names), and ``by_axis``: bytes by the mesh axes of each collective's
    group (``"data+model"`` for a flattened group);
  - ``arg_bytes``: the per-device bytes of the placed inputs, exactly;
    ``out_bytes`` / ``alias_bytes``: the step's outputs, and those of them
    that are inputs updated in place (the train step's params and
    moments; XLA's donated buffers);
  - ``temp_bytes``: the peak of the storages that the step's ops
    allocated and that were alive at once.

The record keeps the reference's keys where the meaning is the same;
``lower_s`` / ``compile_s`` become ``trace_s`` (there is no compile).
The reference's ``DRYRUN_HLO_DIR`` has no counterpart: there is no HLO.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod] [--out results.jsonl]
  (``--device cpu`` where there is no card: the fake tensors then say CPU)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh, mesh_name
from repro_torch.launch.shapes import SHAPES, cell_supported, input_specs
from repro_torch.launch.train import shard_tree
from repro_torch.models import model as M
from repro_torch.models.layers import split_params, tree_map
from repro_torch.models.sharding import ShardingRules, place, set_rules
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

# collective ops → the reference's (HLO) kind names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "wait_tensor"}
_DEVICE = torch.ops.prim.device.default


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Per-device bytes of a tree's tensors (a DTensor's local shard)."""
    return sum(
        _nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in _tensors(tree)
    )


def group_axes(mesh) -> dict:
    """Process-group name → the mesh axes it spans (``"data+model"`` for a
    group over the whole mesh: its flattened group, or the world)."""
    names = list(mesh.mesh_dim_names)
    out = {mesh.get_group(i).group_name: n for i, n in enumerate(names)}
    whole = "+".join(names)
    if mesh.size() == dist.get_world_size():
        out.setdefault(dist.group.WORLD.group_name, whole)
    if mesh.ndim > 1:
        out.setdefault(mesh._flatten().get_group().group_name, whole)
    return out


# DTensor's own work inside an op's dispatch, which is not the device's:
# shard-offset arithmetic with small host tensors (``torch.arange`` ...
# ``.tolist()``; under FakeTensorMode those values could not be read), and
# the op run once at global shapes to learn its output's shape (a cache
# miss of the sharding propagation)
_SHARD_ARITHMETIC = {"local_shard_size_and_offset", "_local_shard_size_and_offset"}
_SHAPE_PROPAGATION = "_propagate_tensor_meta"
_OWN_CODE = f"{__name__.split('.')[0]}/"  # frames of this package's modules


def _dtensor_bookkeeping() -> str | None:
    """``"host"`` inside DTensor's shard arithmetic, ``"shape"`` inside its
    shape propagation, None for the step's own ops."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_name in _SHARD_ARITHMETIC:
            return "host"
        if code.co_name.startswith(_SHAPE_PROPAGATION):
            return "shape"
        if _OWN_CODE in code.co_filename:  # the step's own code: no deeper
            return None
        f = f.f_back
    return None


class DeviceCounter(TorchDispatchMode):
    """Counts one device's work: FLOPs, eager bytes, collectives and the
    peak of live allocations. Enter it after ``FakeTensorMode`` (so that it
    is on top of the mode stack); an op on DTensors is handed back
    (``NotImplemented``) so that DTensor runs it, and the local ops and
    collectives it issues come back here."""

    def __init__(self, axes_of_group: dict | None = None):
        super().__init__()
        self.axes_of_group = axes_of_group or {}
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.by_axis: dict[str, int] = {}
        self._live: dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is _DEVICE:  # metadata, asked often: no work, no memory
            return func(*args, **kwargs)
        aside = _dtensor_bookkeeping()
        if aside == "host" and not any(
            isinstance(t, FakeTensor) for t in _tensors(args) + _tensors(kwargs)
        ):
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if aside is not None:
            return out
        name = func.__name__.split(".")[0]
        ns = func.namespace
        outs = _tensors(out)
        if ns in ("_c10d_functional", "c10d") and name in COLLECTIVE_KINDS:
            self._collective(COLLECTIVE_KINDS[name], func, args, kwargs, outs)
        else:
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if outs and not func.is_view and name not in _NO_TRAFFIC:
                self.bytes += sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs))
                self.bytes += sum(_nbytes(t) for t in outs)
        if not func.is_view:
            # an in-place op's result is its input's storage: not a new one
            ins = {t.untyped_storage()._cdata for t in _tensors(args) + _tensors(kwargs)}
            for t in outs:
                if t.untyped_storage()._cdata not in ins:
                    self._alloc(t)
        return out

    def _collective(self, kind, func, args, kwargs, outs):
        # the result's bytes, as the reference counts an HLO collective;
        # c10d's in-place ops write into their first argument
        res = outs if func.namespace == "_c10d_functional" else _tensors(args[0])
        size = sum(_nbytes(t) for t in res)
        group = None
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, str) and a in self.axes_of_group:
                group = a
            elif isinstance(a, torch.ScriptObject):
                try:
                    group = dist.ProcessGroup.unbox(a).group_name
                except Exception:  # not a process group
                    pass
        axis = self.axes_of_group.get(group, "other")
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + size
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.by_axis[axis] = self.by_axis.get(axis, 0) + size

    def _alloc(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._live.pop(key, 0)

    def collectives(self) -> dict:
        return dict(
            bytes=dict(self.coll_bytes), counts=dict(self.coll_counts),
            total=sum(self.coll_bytes.values()), by_axis=dict(self.by_axis),
        )


def _fake(spec: torch.Tensor, device) -> torch.Tensor:
    """A fake tensor like a meta spec, on ``device`` (inside FakeTensorMode)."""
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def _cache_logical(nd: int) -> tuple:
    """The reference's decode-cache axes: (L, B, S, KVH, hd) → batch +
    cache_seq (+ kv_heads); (L, B, S, latent) (MLA) → batch + cache_seq."""
    if nd == 5:
        return (None, "batch", "cache_seq", "kv_heads", None)
    if nd == 4:
        return (None, "batch", "cache_seq", None)
    if nd == 3:
        return (None, "batch", None)
    return (None, "batch") + (None,) * (nd - 2)


def _batch_axes(tree):
    return tree_map(lambda t: ("batch",) + (None,) * (t.ndim - 1), tree)


def run_cell(arch: str, shape: str, multi_pod: bool, moment_dtype: str = "float32",
             overrides: dict | None = None, device="cuda") -> dict:
    """Run one cell once on fake tensors; returns its record. Needs a
    process group of the production mesh's size (``main`` starts a fake
    one)."""
    device = resolve(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rules = ShardingRules(mesh=mesh)
    set_rules(rules)
    try:
        rec = dict(arch=arch, shape=shape, mesh=mesh_name(mesh), chips=mesh.size())
        if arch == "remixdb":
            return _run_remixdb_cell(rec, mesh, device)
        cfg = get_config(arch)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
            rec["overrides"] = dict(overrides)
        okay, why = cell_supported(cfg, shape)
        if not okay:
            rec.update(status="skipped", reason=why)
            return rec
        return count_step(rec, cfg, input_specs(cfg, shape), rules, device, moment_dtype)
    finally:
        set_rules(ShardingRules(mesh=None))


def count_step(rec: dict, cfg, spec: dict, rules, device, moment_dtype="float32",
               opt_cfg: OptConfig | None = None) -> dict:
    """Place the cell's inputs on ``rules.mesh`` as fake tensors, run its
    step once under a :class:`DeviceCounter`, and fill in ``rec``."""
    mesh = rules.mesh
    kind = spec["kind"]
    counter = DeviceCounter(group_axes(mesh) if mesh.size() > 1 else {})
    with FakeTensorMode(allow_non_fake_inputs=True):
        pv, pax = split_params(M.init_params(cfg, 0, device=device))
        pv = shard_tree(pv, pax, rules)
        if kind == "train":
            opt_cfg = opt_cfg or OptConfig(moment_dtype=moment_dtype)
            opt = init_opt_state(opt_cfg, pv)
            batch = shard_tree(
                tree_map(lambda t: _fake(t, device), spec["batch"]),
                _batch_axes(spec["batch"]), rules,
            )
            args = (pv, opt, batch)
            step = make_train_step(cfg, opt_cfg)
        elif kind == "prefill":
            batch = shard_tree(
                tree_map(lambda t: _fake(t, device), spec["batch"]),
                _batch_axes(spec["batch"]), rules,
            )
            args = (pv, batch)

            def step(p, b):
                with torch.no_grad():
                    return M.prefill(cfg, p, b)
        else:  # decode
            cache = {
                k: place(_fake(v, device), mesh, rules.placements(_cache_logical(v.ndim), v.shape))
                for k, v in spec["cache"].items()
            }
            tok = place(_fake(spec["token"], device), mesh,
                        rules.placements(("batch",), spec["token"].shape))
            args = (pv, cache, tok)
            pos = spec["pos"]

            def step(p, c, t):
                with torch.no_grad():
                    return M.decode_step(cfg, p, c, t, pos)
        arg_bytes = local_bytes(args)
        t0 = time.time()
        with counter:
            out = step(*args)
        trace_s = time.time() - t0
        ins = {t.untyped_storage()._cdata for t in _local_tensors(args)}
        outs = _local_tensors(out)
        out_bytes = sum(_nbytes(t) for t in outs)
        alias = sum(_nbytes(t) for t in outs if t.untyped_storage()._cdata in ins)
        del out, args
    return _finish(rec, cfg, kind, counter, trace_s, arg_bytes, out_bytes, alias)


def _local_tensors(tree) -> list:
    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


def _finish(rec, cfg, kind, counter, trace_s, arg_bytes, out_bytes, alias_bytes):
    rec.update(
        status="ok",
        kind=kind,
        trace_s=round(trace_s, 1),
        flops=float(counter.flops),
        bytes_accessed=float(counter.bytes),
        arg_bytes=int(arg_bytes),
        out_bytes=int(out_bytes),
        temp_bytes=int(counter.peak),
        alias_bytes=int(alias_bytes),
        collectives=counter.collectives(),
    )
    if cfg is not None and hasattr(cfg, "n_params"):
        rec["n_params"] = cfg.n_params()
        rec["active_params"] = cfg.active_params()
    return rec


def _run_remixdb_cell(rec, mesh, device):
    """The sharded get over the flattened mesh: this rank's shard of the
    store and its slice of the query batch, as fake tensors; the local get
    is the plain ``core.query.get`` (the fake tensors launch no kernel)."""
    from repro_torch.core.remix import Remix
    from repro_torch.core.runs import RunSet
    from repro_torch.db.sharded import abstract_state, make_sharded_get

    cfg = get_config("remixdb")
    n_shards = mesh.size()
    remix_s, runset_s = abstract_state(cfg, n_shards)
    dtypes = dict(uint32=torch.int32, int32=torch.int32, uint8=torch.uint8, bool=torch.bool)
    counter = DeviceCounter(group_axes(mesh))
    step, _ = make_sharded_get(cfg, mesh)
    with FakeTensorMode():
        def local(desc):  # one shard: the stacked shape without its lead
            (shape, dt) = desc
            return torch.empty(shape[1:], dtype=dtypes[dt], device=device)

        remix = Remix(
            anchors=local(remix_s["anchors"]), cursors=local(remix_s["cursors"]),
            selectors=local(remix_s["selectors"]),
            n_entries=cfg.runs_per_partition * cfg.entries_per_run, d=cfg.group_d,
        )
        runset = RunSet(**{k: local(v) for k, v in runset_s.items()})
        queries = torch.empty((cfg.query_batch // n_shards, cfg.kw), dtype=torch.int32,
                              device=device)
        args = (remix, runset, queries)
        arg_bytes = local_bytes([remix.anchors, remix.cursors, remix.selectors,
                                 *dataclasses.astuple(runset), queries])
        t0 = time.time()
        with counter:
            out = step(*args)
        trace_s = time.time() - t0
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
    rec["shape"] = f"get_{cfg.query_batch}"
    return _finish(rec, None, "kvstore", counter, trace_s, arg_bytes, out_bytes, 0)


def fake_world(multi_pod: bool):
    """Start a fake process group of the production mesh's size (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    world = math.prod(PRODUCTION[bool(multi_pod)][0])
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dry-run the port's cells on a fake mesh.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument(
        "--override", default=None,
        help='JSON dict of ModelConfig overrides, e.g. {"param_dtype":"bfloat16"}',
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None
    resolve(args.device)

    cells = []
    if args.all:
        for arch in ARCHS + ["remixdb"]:
            shapes = list(SHAPES) if arch != "remixdb" else ["service"]
            for shape in shapes:
                for mp in ([False, True] if args.multipod else [False]):
                    cells.append((arch, shape, mp))
    else:
        cells.append((args.arch, args.shape, args.multipod))

    out = open(args.out, "a") if args.out else None
    failures = 0
    for arch, shape, mp in cells:
        try:
            fake_world(mp)
            rec = run_cell(
                arch, shape, mp, moment_dtype=args.moment_dtype,
                overrides=overrides, device=args.device,
            )
        except Exception as e:
            failures += 1
            rec = dict(
                arch=arch, shape=shape, mesh="2x32x8" if mp else "32x8",
                status="error", error=f"{type(e).__name__}: {e}",
            )
            traceback.print_exc()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
