"""Logical-axis sharding rules (MaxText-style).

Tensors are annotated with *logical* axis names; a rule table maps them to
physical mesh axes. Axes that do not divide evenly are dropped (replicated)
so one rule set works across all ten architectures.

The rule table and :meth:`ShardingRules.physical` are the reference's,
in plain Python: a spec is a tuple with one entry per tensor dimension
(``None``, an axis name, or a tuple of axis names), trailing ``None``
trimmed. :meth:`ShardingRules.physical` takes a
``torch.distributed`` ``DeviceMesh`` or any object with ``axis_names`` and
a ``shape`` mapping from axis name to size.

On a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) a spec becomes DTensor
placements (:meth:`ShardingRules.placements`, the reference's ``named``):
``shard_tree`` in the launcher places params and optimizer state with
them, and :func:`shard` inside the model redistributes activations to
them, as the reference's ``with_sharding_constraint`` does. Without a mesh,
or on a mesh of one device, :func:`shard` returns its input: the model's
plain path never sees a DTensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# default logical → physical mapping (single- and multi-pod meshes)
DEFAULT_RULES: dict[str, Sequence[str] | str | None] = {
    "batch": ("pod", "data"),  # data parallel over pod×data
    "seq": None,  # sequence replicated in training/prefill
    "cache_seq": "model",  # decode KV cache: sequence sharded over model
    "embed": None,  # activation d_model dim
    "vocab": "model",  # embedding/logits vocab dim (TP)
    "heads": "model",  # attention heads (TP)
    "kv_heads": None,  # GQA kv heads often tiny: replicate by default
    "mlp": "model",  # FFN hidden dim (TP)
    "experts": "model",  # MoE expert dim (EP-as-TP over experts)
    "expert_mlp": None,  # per-expert FFN hidden: replicated by default
    "fsdp": "data",  # weight d_in dim (ZeRO-3 style)
    "layers": None,  # stacked-scan layer dim
    "ssm_state": None,
    "conv": None,
}


def mesh_axes(mesh) -> dict | None:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``) or of
    any object with ``axis_names`` and a ``shape`` mapping; None without a
    mesh."""
    if mesh is None:
        return None
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@dataclasses.dataclass
class ShardingRules:
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))
    mesh: object | None = None

    def physical(self, logical: Sequence[str | None], shape=None) -> tuple:
        """Map logical axis names to a partition spec, dropping non-divisible
        or unknown axes (replication)."""
        sizes = mesh_axes(self.mesh)
        used: set[str] = set()
        parts = []
        if shape is not None:
            logical = tuple(logical)[: len(shape)]
        for i, name in enumerate(logical):
            spec = self.rules.get(name) if name else None
            if spec is None:
                parts.append(None)
                continue
            axes = (spec,) if isinstance(spec, str) else tuple(spec)
            if sizes is not None:
                axes = tuple(a for a in axes if a in sizes and a not in used)
                size = math.prod(sizes[a] for a in axes)
                if shape is not None and axes and shape[i] % size != 0:
                    axes = ()
            if not axes:
                parts.append(None)
            else:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def placements(self, logical: Sequence[str | None], shape) -> list:
        """DTensor placements on ``self.mesh`` (a ``DeviceMesh``) for a tensor
        of ``shape`` annotated ``logical``: the counterpart of the
        reference's ``named``. One entry per mesh dim: ``Shard(i)`` where
        tensor dim ``i`` maps to that mesh axis, else ``Replicate()``.

        A tensor dim mapped to several mesh axes (``batch`` → ``("pod",
        "data")``) is ``Shard(i)`` on each; DTensor splits it over those mesh
        dims in mesh order, outermost first, which is JAX's major-to-minor
        order when the axes are listed in mesh order (checked here).
        """
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for i, part in enumerate(self.physical(logical, shape=shape)):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else part
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(
                    f"mesh axes {axes} of tensor dim {i} are not in mesh order "
                    f"{tuple(names)}: DTensor cannot split them in that order"
                )
            for d in dims:
                out[d] = Shard(i)
        return out

    def constraint(self, x, *logical):
        """Place ``x`` by logical names: the identity without a mesh or on a
        mesh of one device (as the reference's ``with_sharding_constraint``
        is a no-op there). Otherwise a DTensor is redistributed to the
        rules' placements, and a plain tensor, taken as the same value on
        every rank, becomes a DTensor with them; both are differentiable."""
        mesh = self.mesh
        if mesh is None or mesh.size() == 1:
            return x
        want = self.placements(logical, x.shape)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(x.placements) == tuple(want):
            return x
        if any(p.is_partial() for p in x.placements):
            return _ReducePartial.apply(x, want)
        return x.redistribute(mesh, want)


class _ReducePartial(torch.autograd.Function):
    """Redistribute a partial sum; its grad comes back replicated on the
    partial dims (every partial term's grad is the whole grad), where
    DTensor's own backward would hand on a partial grad and the next
    matmul's backward would gather its weight instead of reducing."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.back = [Replicate() if p.is_partial() else p for p in x.placements]
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


# a module-level current rule set that model code reads; a launcher swaps it
_CURRENT = ShardingRules(mesh=None)


def set_rules(rules: ShardingRules):
    global _CURRENT
    _CURRENT = rules


def get_rules() -> ShardingRules:
    return _CURRENT


def shard(x, *logical):
    return _CURRENT.constraint(x, *logical)


def gather_fsdp(w):
    """A weight as a layer uses it: a DTensor is all-gathered over the mesh
    axes that ``fsdp`` maps to, keeping its other shards (ZeRO-3's gather
    before use; GSPMD makes the same choice for these rules, where
    DTensor's per-op choice would gather the activations instead). Any
    other tensor is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    spec = _CURRENT.rules.get("fsdp")
    axes = (spec,) if isinstance(spec, str) else tuple(spec or ())
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if p.is_shard() and names[i] in axes else p
          for i, p in enumerate(w.placements)]
    return w if tuple(pl) == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def shard_index(mesh, dims) -> int:
    """This rank's index among the shards that mesh ``dims`` split a dim
    into, outermost first (DTensor's order)."""
    coord, part = mesh.get_coordinate(), 0
    for i in dims:
        part = part * mesh.shape[i] + coord[i]
    return part


def place(t, mesh, placements):
    """``t`` on ``mesh`` with ``placements``: a DTensor, each rank keeping
    its shard of its own ``t`` (every caller holds the same whole value on
    every rank: a seeded init, a checkpoint file), or on a mesh of one
    device the plain tensor moved to that device."""
    if mesh.size() == 1:
        return t.to(torch.device(mesh.device_type))
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


@contextlib.contextmanager
def on_mesh():
    """Let plain tensors made inside the model (positions, masks, the
    optimizer's schedule) meet DTensors as if replicated, while the
    current rules have a mesh of more than one device. The flag is the one
    ``torch.distributed.tensor.experimental.implicit_replication`` sets;
    it is restored on exit, so the context nests."""
    mesh = _CURRENT.mesh
    if mesh is None or mesh.size() == 1:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    old = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = old
