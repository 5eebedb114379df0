"""The port's device meshes and placements (``repro_torch.launch.mesh``,
``models.sharding``) against the JAX package's.

Placements are held leaf for leaf against the reference's rules on the
production and debug meshes: the per-device bytes of every param of every
arch are equal. Meshes are built on fake process groups (one process
standing for one rank). The mesh branches of the model — dense_ec MoE
with ``moe_local_dispatch`` and flash attention's K/V pin — run on 8 real
gloo ranks, the reference on fake XLA host devices in its own process.
"""
import math
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import sharding as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch.train import shard_tree  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.convert import jax_tree_keys  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401
from torch_mesh import RANK_PROLOGUE, fake_world, start_py, start_ranks, wait_all  # noqa: E402

MESHES = [((32, 8), ("data", "model")), ((2, 32, 8), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 2), ("data", "model"))]


class MeshDesc:
    """A mesh as the reference's ``physical`` reads one: names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _ref_bytes(shape, dtype, spec, mesh: MeshDesc) -> int:
    local = list(shape)
    for i, part in enumerate(spec):
        if part is not None:
            axes = (part,) if isinstance(part, str) else part
            local[i] //= math.prod(mesh.shape[a] for a in axes)
    return math.prod(local) * np.dtype(dtype).itemsize


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_placement_parity_every_leaf(arch):
    """Every leaf's per-device bytes under the port's ``placements`` equal
    the reference's ``physical`` on (32, 8), (2, 32, 8), (4, 2), (2, 2);
    the port's local shards come from DTensor itself (meta tensors)."""
    rp = jax.eval_shape(lambda: RM.init_params(RC.get_config(arch), jax.random.key(0)))
    rv, rax = RL.split_params(rp)
    rkeys = jax_tree_keys(rv)
    r_axes = dict(zip(rkeys, jax.tree.leaves(rax, is_leaf=lambda x: isinstance(x, tuple))))
    r_vals = dict(zip(rkeys, jax.tree.leaves(rv)))
    with FakeTensorMode():
        pv, pax = L.split_params(M.init_params(TC.get_config(arch), 0, device="cpu"))
    leaves = list(zip(jax_tree_keys(pv), L.tree_leaves(pv), L.tree_leaves(pax)))
    assert sorted(k for k, _, _ in leaves) == sorted(rkeys)
    for shape, names in MESHES:
        desc = MeshDesc(shape, names)
        rrules = RS.ShardingRules(mesh=desc)
        with fake_world(math.prod(shape)):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            rules = S.ShardingRules(mesh=mesh)
            for key, v, ax in leaves:
                r = r_vals[key]
                want = _ref_bytes(r.shape, r.dtype, rrules.physical(r_axes[key], shape=r.shape), desc)
                meta = torch.empty(v.shape, dtype=v.dtype, device="meta")
                local = distribute_tensor(meta, mesh, rules.placements(ax, v.shape)).to_local()
                got = local.numel() * local.element_size()
                assert got == want, (arch, shape, key)


@pytest.mark.parametrize("n", [256, 512])
def test_production_and_debug_meshes(n):
    """Names and shapes under a fake world: the production mesh of its
    size, and the debug mesh's split (model 4, 2 or 1) of 1, 6, 8 ranks."""
    multi = n == 512
    with fake_world(n):
        m = TM.make_production_mesh(multi_pod=multi, device="cpu")
        want = ((2, 32, 8), ("pod", "data", "model")) if multi else ((32, 8), ("data", "model"))
        assert (tuple(m.shape), m.mesh_dim_names) == want
        assert TM.mesh_name(m) == ("2x32x8" if multi else "32x8") and m.size() == n
        with pytest.raises(ValueError, match=f"needs {1536 // n} ranks; the process group has {n}"):
            TM._mesh((1536 // n,), ("data",), torch.device("cpu"))
    for world, shape in ((1, (1, 1)), (6, (3, 2)), (8, (2, 4))):
        with fake_world(world):
            m = TM.make_debug_mesh(device="cpu")
            assert (tuple(m.shape), m.mesh_dim_names) == (shape, ("data", "model"))
            with pytest.raises(ValueError, match=f"needs 256 ranks; the process group has {world}"):
                TM.make_production_mesh(device="cpu")


def test_mesh_alone_is_one_rank_and_production_raises():
    """Without a process group the debug mesh is 1 x 1 (a one-rank group is
    started); the production meshes raise the world-size error."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    started = TM.ensure_process_group("cpu")
    try:
        assert started and tuple(TM.make_debug_mesh(device="cpu").shape) == (1, 1)
        for multi, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks; the process group has 1"):
                TM.make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        dist.destroy_process_group()


def test_constraint_and_shard_tree_on_a_fake_mesh():
    """``constraint`` places or redistributes by the rules; ``shard_tree``
    makes DTensors with ``placements``; on one device both leave plain
    tensors as they are."""
    x = torch.arange(64.0).reshape(8, 8)
    with fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        rules = S.ShardingRules(mesh=mesh)
        y = rules.constraint(x, "batch", "mlp")
        assert y.placements == (Shard(0), Shard(1)) and y.to_local().shape == (2, 4)
        assert torch.equal(y.to_local(), x[:2, :4])  # rank 0's block
        z = rules.constraint(y, "batch", None)
        assert z.placements == (Shard(0), Replicate()) and z.to_local().shape == (2, 8)
        assert rules.constraint(z, "batch", None) is z
        tree = shard_tree(dict(a=x, b=dict(c=torch.ones(3))),
                          dict(a=("fsdp", "mlp"), b=dict(c=(None,))), rules)
        assert tree["a"].placements == (Shard(0), Shard(1))
        assert tree["b"]["c"].placements == (Replicate(), Replicate())
    with fake_world(1):
        one = S.ShardingRules(mesh=init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model")))
        assert one.constraint(x, "batch", "mlp") is x
        placed = shard_tree(dict(a=x), dict(a=("fsdp", "mlp")), one)
        assert type(placed["a"]) is torch.Tensor and torch.equal(placed["a"], x)


REF_ORDER = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 4, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
devs = list(mesh.devices.flat)  # rank order: row-major over the mesh
out = {}
for name, spec in (("pod_data", P(("pod", "data"))), ("data_model", P(("data", "model"))),
                   ("pod_data_model", P(("pod", "data", "model")))):
    idx = NamedSharding(mesh, spec).devices_indices_map((32, 1))
    out[name] = [idx[d][0].start or 0 for d in devs]
print(json.dumps(out))
"""


def test_multi_axis_shard_order_is_jax_major_to_minor():
    """A dim split over several mesh axes: each rank's rows under DTensor's
    ``Shard`` on each axis equal the rows JAX gives the device at the same
    mesh position (16 fake XLA host devices)."""
    import json

    ref = start_py(REF_ORDER)
    rules_of = {"pod_data": ("pod", "data"), "data_model": ("data", "model"),
                "pod_data_model": ("pod", "data", "model")}
    got = {k: [] for k in rules_of}
    x = torch.arange(32).reshape(32, 1)
    for r in range(16):
        with fake_world(16, rank=r):
            mesh = init_device_mesh("cpu", (2, 4, 2), mesh_dim_names=("pod", "data", "model"))
            for k, axes in rules_of.items():
                rules = S.ShardingRules(rules=dict(S.DEFAULT_RULES, rows=axes), mesh=mesh)
                local = distribute_tensor(x, mesh, rules.placements(("rows", None), x.shape),
                                          src_data_rank=None).to_local()
                got[k].append(int(local[0, 0]))
    want = json.loads(wait_all([ref], 300).strip().splitlines()[-1])
    assert got == want
    with fake_world(16):
        mesh = init_device_mesh("cpu", (2, 4, 2), mesh_dim_names=("pod", "data", "model"))
        rules = S.ShardingRules(rules=dict(S.DEFAULT_RULES, rows=("data", "pod")), mesh=mesh)
        with pytest.raises(ValueError, match="not in mesh order"):
            rules.placements(("rows", None), x.shape)


# ---------------------------------------------------------------- model branches
MOE = dict(moe_local_dispatch=True, dtype="float32", param_dtype="float32")
B, SEQ = 4, 16

REF_MOE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import layers as L
from repro.models.sharding import ShardingRules, set_rules
cfg = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")), **{moe!r})
mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
set_rules(ShardingRules(mesh=mesh))
d = np.load(sys.argv[1])
p = {{k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}}
x, r = jnp.asarray(d["x"]), jnp.asarray(d["r"])
with jax.set_mesh(mesh):
    out = jax.jit(lambda p, x: L.moe(cfg, p, x))(p, x)
    grads = jax.jit(jax.grad(lambda p: (L.moe(cfg, p, x) * r).sum()))(p)
np.savez(sys.argv[2], moe=np.asarray(out), **{{"g_" + k: np.asarray(v) for k, v in grads.items()}})
"""

PORT_MESH = RANK_PROLOGUE + """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import shard_tree
from repro_torch.models import layers as L, sharding as S
cfg = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")), **{moe!r})
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
rules = S.ShardingRules(mesh=mesh)
S.set_rules(rules)
d = np.load(argv[0])
axes = L.split_params(L.init_moe(cfg, torch.Generator().manual_seed(0)))[1]
p = shard_tree({{k: torch.as_tensor(d[k]) for k in axes}}, axes, rules)
x = rules.constraint(torch.as_tensor(d["x"]), "batch", "seq", "embed")
q, k, v = (rules.constraint(torch.as_tensor(d[n]), "batch", "seq", "heads", None)
           for n in ("q", "k", "v"))
for t in p.values():
    t.requires_grad_(True)
with S.on_mesh():
    moe = L.moe(cfg, p, x)
    (moe * torch.as_tensor(d["r"])).sum().backward()
    out = moe.full_tensor().detach()
    grads = {{k: t.grad.full_tensor() for k, t in p.items()}}
    pinned = L.flash_attention(q, k, v, block=16, pin_kv=True).full_tensor()
    free = L.flash_attention(q, k, v, block=16, pin_kv=False).full_tensor()
if rank == 0:
    np.savez(argv[1], moe=out.numpy(), pinned=pinned.numpy(), free=free.numpy(),
             **{{"g_" + k: g.numpy() for k, g in grads.items()}})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's MoE on 4 XLA devices (data 4) and the port's MoE and
    flash attention on 8 gloo ranks in a (4, 2) mesh (data 4), run
    together once for the module."""
    tmp = tmp_path_factory.mktemp("mesh_branches")
    rng = np.random.default_rng(0)
    rcfg = RC.reduced(RC.get_config("qwen3-moe-235b-a22b"))
    import dataclasses

    rcfg = dataclasses.replace(rcfg, **MOE)
    p = RL.split_params(RL.init_moe(rcfg, jax.random.key(1)))[0]
    arrays = {k: np.asarray(v, np.float32) for k, v in p.items()}
    # tokens leaning to expert 0, so that it overflows its capacity: in a
    # group of 16 tokens (capacity 8) more often than in one of 64 (24)
    u = arrays["router"][:, 0] / np.linalg.norm(arrays["router"][:, 0])
    arrays["x"] = (rng.normal(size=(B, SEQ, rcfg.d_model)) + 3 * u).astype(np.float32)
    arrays["r"] = rng.normal(size=(B, SEQ, rcfg.d_model)).astype(np.float32)  # d loss / d out
    for n, heads in (("q", 4), ("k", 2), ("v", 2)):
        arrays[n] = rng.normal(size=(B, 40, heads, 16)).astype(np.float32)
    inp = str(tmp / "in.npz")
    np.savez(inp, **arrays)
    ref = start_py(textwrap.dedent(REF_MOE).format(moe=MOE), inp, tmp / "ref.npz")
    port = start_ranks(PORT_MESH.format(moe=MOE), 8, tmp / "rendezvous", inp, tmp / "port.npz")
    wait_all([ref, *port], 600)
    return arrays, np.load(tmp / "ref.npz"), np.load(tmp / "port.npz")


def test_moe_local_dispatch_on_a_mesh_equals_the_reference(mesh_runs):
    """dense_ec with ``moe_local_dispatch``: 4 groups (data 4), each with
    its own capacity; experts split over model 2 in the port (a partial
    sum), whole in the reference (model 1); the output and the weights'
    grads of a weighted sum of it. Tolerance as in
    ``test_attention_property``. The groups change the answer (expert 0
    overflows differently), so one group of all tokens differs."""
    arrays, ref, port = mesh_runs
    np.testing.assert_allclose(port["moe"], ref["moe"], rtol=2e-3, atol=2e-3)
    for k in ("router", "w_gate", "w_up", "w_down"):  # the backward too
        np.testing.assert_allclose(port["g_" + k], ref["g_" + k], rtol=2e-3, atol=2e-3, err_msg=k)
    tcfg = TC.reduced(TC.get_config("qwen3-moe-235b-a22b"))
    import dataclasses

    tcfg = dataclasses.replace(tcfg, **MOE)
    p = {k: torch.tensor(arrays[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    one_group = L.moe(tcfg, p, torch.tensor(arrays["x"])).numpy()
    assert not np.allclose(one_group, ref["moe"], rtol=2e-3, atol=2e-3)


def test_flash_attention_pin_kv_keeps_the_forward(mesh_runs):
    """K/V pinned by batch (replicated over model) or left as placed: the
    same forward on the mesh, equal to the plain one without a mesh."""
    arrays, _, port = mesh_runs
    np.testing.assert_array_equal(port["pinned"], port["free"])
    plain = L.flash_attention(*(torch.tensor(arrays[n]) for n in "qkv"), block=16)
    np.testing.assert_allclose(port["pinned"], plain.numpy(), rtol=1e-6, atol=1e-6)
    for pin in (True, False):  # without a mesh the pin is nothing
        assert torch.equal(
            L.flash_attention(*(torch.tensor(arrays[n]) for n in "qkv"), block=16,
                              pin_kv=pin), plain)
