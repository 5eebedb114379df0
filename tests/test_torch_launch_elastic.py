"""The elastic restart of the port's launcher path, on real gloo ranks: the
twin of ``tests/test_dryrun_sharded.py::test_elastic_restart_resharding``.

A reduced qwen2.5-3b (2 layers, d_model 128, d_ff 256, vocab 128, in
float32) trains 3 steps on 8 ranks in a (4, 2) mesh and is saved; 4 ranks
in a (2, 2) mesh restore it through ``restore(shardings=...)``, each leaf
placed on the new mesh as it is read, and train steps 3 and 4. The
restored leaves equal the saved ones bit for bit, and the sharded steps'
losses equal a one-process run's: sharding does not change the math.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401
from torch_mesh import RANK_PROLOGUE, start_ranks, wait_all  # noqa: E402

SMALL = dict(n_layers=2, d_model=128, d_ff=256, vocab=128)
F32 = dict(dtype="float32", param_dtype="float32")

COMMON = RANK_PROLOGUE + """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.train import param_axes, shard_tree, tree_map2, value
from repro_torch.models import model as M
from repro_torch.models.layers import split_params
from repro_torch.models.sharding import ShardingRules, set_rules
from repro_torch.train import checkpoint as C
from repro_torch.train.optimizer import OptConfig, flat_leaves, init_opt_state
from repro_torch.train.train_step import make_train_step
ckpt = argv[0]
cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b"), **{small!r}), **{f32!r})
opt_cfg = OptConfig(lr=1e-3, total_steps=10)
data = DataPipeline(vocab=cfg.vocab, batch=8, seq=16, seed=0, device="cpu")
BATCH_AXES = dict(tokens=("batch",), labels=("batch",))

def mesh_of(shape):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = ShardingRules(mesh=mesh)
    set_rules(rules)
    return mesh, rules

def steps(pv, opt, lo, hi, rules):
    step = make_train_step(cfg, opt_cfg)
    losses = []
    for i in range(lo, hi):
        pv, opt, m = step(pv, opt, shard_tree(data.get_batch(i), BATCH_AXES, rules))
        losses.append(float(value(m["loss"])))
    return pv, opt, losses

def whole(tree):  # every leaf's full value (a collective: all ranks call it)
    return {{str(i): value(v).detach().numpy().copy() for i, v in enumerate(flat_leaves(tree))}}
"""

SAVE = COMMON + """
mesh, rules = mesh_of((4, 2))
pv, pax = split_params(M.init_params(cfg, 0, device="cpu"))
pv = shard_tree(pv, pax, rules)
opt = init_opt_state(opt_cfg, pv)
pv, opt, losses = steps(pv, opt, 0, 3, rules)
assert type(flat_leaves(pv)[0]).__name__ == "DTensor"
saved = whole(dict(params=pv, opt=opt))
C.save(ckpt, 3, pv, opt, extra=dict(data=data.state(3)))
if rank == 0:
    np.savez(argv[1], losses=np.array(losses), **{{"leaf" + k: v for k, v in saved.items()}})
dist.destroy_process_group()
"""

RESTORE = COMMON + """
mesh, rules = mesh_of((2, 2))
shapes, pax = param_axes(cfg)
pshard = tree_map2(lambda s, ax: (mesh, rules.placements(ax, s)), shapes, pax)
oshard = dict(mu=pshard, nu=pshard, step=(mesh, rules.placements((), ())))
pv, opt, extra = C.restore(ckpt, shardings=(pshard, oshard), device="cpu")
assert extra["data"]["step"] == 3
assert all(type(t).__name__ == "DTensor" for t in flat_leaves(dict(p=pv, o=opt)))
restored = whole(dict(params=pv, opt=opt))
pv, opt, losses = steps(pv, opt, 3, 5, rules)
if rank == 0:
    np.savez(argv[1], losses=np.array(losses), **{{"leaf" + k: v for k, v in restored.items()}})
dist.destroy_process_group()
"""


def _one_process_losses(n: int) -> list:
    import dataclasses

    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b"), **SMALL), **F32)
    opt_cfg = OptConfig(lr=1e-3, total_steps=10)
    data = DataPipeline(vocab=cfg.vocab, batch=8, seq=16, seed=0, device="cpu")
    pv = split_params(M.init_params(cfg, 0, device="cpu"))[0]
    opt = init_opt_state(opt_cfg, pv)
    step = make_train_step(cfg, opt_cfg)
    out = []
    for i in range(n):
        pv, opt, m = step(pv, opt, data.get_batch(i))
        out.append(float(m["loss"]))
    return out


def test_elastic_restart_8_to_4_gloo_ranks(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    fmt = dict(small=SMALL, f32=F32)
    wait_all(start_ranks(SAVE.format(**fmt), 8, tmp_path / "r8", ckpt, tmp_path / "a.npz"), 600)
    wait_all(start_ranks(RESTORE.format(**fmt), 4, tmp_path / "r4", ckpt, tmp_path / "b.npz"), 600)
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    leaves = [k for k in a.files if k.startswith("leaf")]
    assert leaves and sorted(leaves) == sorted(k for k in b.files if k.startswith("leaf"))
    for k in leaves:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert np.isfinite(b["losses"]).all() and len(b["losses"]) == 2
    np.testing.assert_allclose(a["losses"], _one_process_losses(3), rtol=1e-5)
