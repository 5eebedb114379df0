"""Device meshes on ``torch.distributed`` (the reference's
``repro.launch.mesh``).

The production meshes keep the reference's axis names and chip counts:
256 ranks as ``("data", "model")``, 512 as ``("pod", "data", "model")``.
Their shape is chosen for HGX H100 nodes, not for a TPU pod: ``(32, 8)``
and ``(2, 32, 8)``. ``model`` is one node's 8 GPUs, which NVLink joins
all to all; ``data`` (and ``pod``) cross nodes over InfiniBand. The
reference's ``(16, 16)`` is one v5e pod slice, where every axis rides the
same ICI torus; on H100 a 16-wide model axis would span two nodes and put
every tensor-parallel collective on InfiniBand.

A mesh covers exactly the ranks of the process group: a shape whose size
differs from the world size raises, as ``jax.make_mesh`` does when the
device count does not match; nothing is shrunk quietly. Without a process
group, :func:`ensure_process_group` starts a one-rank group (``gloo`` for
the CPU, ``nccl`` for the card) on an in-process store, so a single
process gets a 1 x 1 mesh.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve

PRODUCTION = {False: ((32, 8), ("data", "model")),
              True: ((2, 32, 8), ("pod", "data", "model"))}


def mesh_name(mesh: DeviceMesh) -> str:
    """``"32x8"`` / ``"2x32x8"``: the mesh's shape as the dry run names it."""
    return "x".join(str(n) for n in mesh.shape)


def ensure_process_group(device="cuda") -> bool:
    """Start a one-rank process group if none is up; True if it started
    one (the caller then destroys it when done)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if resolve(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _mesh(shape: tuple, axes: tuple, device: torch.device) -> DeviceMesh:
    ensure_process_group(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {shape} over {axes} needs {math.prod(shape)} ranks; the "
            f"process group has {world}"
        )
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The 256-rank ``(32, 8)`` or, with ``multi_pod``, the 512-rank
    ``(2, 32, 8)`` mesh over the current process group."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return _mesh(shape, axes, resolve(device))


def make_debug_mesh(n: int | None = None, device="cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over ``n`` ranks (the world size when
    None; 1 without a process group): ``model`` is 4, 2 or 1, the largest
    that divides ``n``, as in the reference."""
    device = resolve(device)
    if not n:
        ensure_process_group(device)
        n = dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return _mesh((n // model, model), ("data", "model"), device)
