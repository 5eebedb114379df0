"""Logical-axis sharding rules (MaxText-style).

Tensors are annotated with *logical* axis names; a rule table maps them to
physical mesh axes. Axes that do not divide evenly are dropped (replicated)
so one rule set works across all ten architectures.

The rule table and :meth:`ShardingRules.physical` are the reference's,
in pure Python: a spec is a tuple with one entry per tensor dimension
(``None``, an axis name, or a tuple of axis names), trailing ``None``
trimmed. A mesh is any object with ``axis_names`` and a ``shape`` mapping
from axis name to size. Without a mesh :func:`shard` returns its input,
as the reference does; placing tensors on a device mesh is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

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


@dataclasses.dataclass
class ShardingRules:
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))
    mesh: object | None = None

    def physical(self, logical: Sequence[str | None], shape=None) -> tuple:
        """Map logical axis names to a partition spec, dropping non-divisible
        or unknown axes (replication)."""
        mesh = self.mesh
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
            if mesh is not None:
                axes = tuple(a for a in axes if a in mesh.axis_names and a not in used)
                size = math.prod(mesh.shape[a] for a in axes)
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

    def constraint(self, x, *logical):
        """Place ``x`` by logical names: the identity without a mesh."""
        if self.mesh is None:
            return x
        raise NotImplementedError("device-mesh placement is not ported")


# a module-level current rule set that model code reads; a launcher swaps it
_CURRENT = ShardingRules(mesh=None)


def set_rules(rules: ShardingRules):
    global _CURRENT
    _CURRENT = rules


def get_rules() -> ShardingRules:
    return _CURRENT


def shard(x, *logical):
    return _CURRENT.constraint(x, *logical)
