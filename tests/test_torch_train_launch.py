"""The port's training launcher (``repro_torch.launch.train.main``) on the
CPU, and the reference launcher's defects that the port keeps, each shown
in both packages.

The launcher runs the ``reduced`` qwen2.5-3b (4 layers, d_model 256,
vocab 512) for a few steps at batch 2 x 16 tokens.
"""
import ast
import inspect
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as RL  # noqa: E402
from repro.train import checkpoint as RCk  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train.optimizer import flat_leaves  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401
from torch_mesh import fake_world  # noqa: E402

SMALL = ["--arch", "qwen2.5-3b", "--batch", "2", "--seq", "16"]


def port_main(ckpt, *args):
    return TL.main([*SMALL, "--ckpt", str(ckpt), "--device", "cpu", *args])


def test_launcher_trains_and_resumes(tmp_path, capsys):
    pv, opt = port_main(tmp_path, "--steps", "3", "--ckpt-every", "1000")
    out = capsys.readouterr().out
    assert "arch: qwen2.5-3b" in out and "step     0 loss" in out and "step     2 loss" in out
    assert "tok/s" in out
    assert C.latest_step(str(tmp_path)) == 3 and int(opt["step"]) == 3
    pv2, opt2 = port_main(tmp_path, "--steps", "5", "--ckpt-every", "1000", "--resume")
    assert "resumed at step 3" in capsys.readouterr().out
    assert C.latest_step(str(tmp_path)) == 5 and int(opt2["step"]) == 5
    assert all(bool(torch.isfinite(t).all()) for t in flat_leaves(pv2))
    _, ro, extra = C.restore(str(tmp_path), device="cpu")
    assert extra == dict(data=dict(seed=0, step=5, shard=0)) and int(ro["step"]) == 5


def test_step_timeout_exits_75_with_checkpoint(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_main(tmp_path, "--steps", "3", "--step-timeout", "1e-9")
    assert e.value.code == 75
    assert C.latest_step(str(tmp_path)) == 0
    _, opt, extra = C.restore(str(tmp_path), device="cpu")
    assert extra["data"]["step"] == 0 and int(opt["step"]) == 1


@pytest.mark.parametrize("flag", ["--production-mesh", "--multipod"])
def test_mesh_flags_raise(tmp_path, flag, capsys, monkeypatch):
    """``--production-mesh`` builds the (32, 8) mesh and, with
    ``--multipod``, the (2, 32, 8) one, over a process group of 256 / 512
    ranks (a fake one here; the launcher stops once the mesh is up). Any
    other world size raises; the launcher alone is a world of one."""
    flags = ["--production-mesh"] + ([flag] if flag == "--multipod" else [])
    world = 512 if flag == "--multipod" else 256
    with pytest.raises(ValueError, match=f"needs {world} ranks; the process group has 1"):
        port_main(tmp_path, "--steps", "1", *flags)
    for other in (world // 2, world):
        def stop(*a, **kw):
            raise KeyboardInterrupt

        monkeypatch.setattr(TL, "DataPipeline", stop)
        with fake_world(other), pytest.raises(
            ValueError if other != world else KeyboardInterrupt
        ):
            port_main(tmp_path, "--steps", "1", *flags)
    want = {"data": 32, "model": 8} if world == 256 else {"pod": 2, "data": 32, "model": 8}
    assert f"mesh: {want}" in capsys.readouterr().out


def test_no_reduced_selects_published_widths(tmp_path, monkeypatch):
    """The reference's ``--reduced`` is ``store_true`` with
    ``default=True``: its full widths cannot be asked for. The port's
    ``--no-reduced`` builds them (caught before any weight is made)."""
    assert TL.parse_args([]).reduced and not TL.parse_args(["--no-reduced"]).reduced
    ref = RL.main.__code__.co_consts  # the reference's parser lives in main
    assert "--reduced" in ref and "--no-reduced" not in ref
    seen = {}

    def stop(cfg, gen, device):
        seen["cfg"] = cfg
        raise KeyboardInterrupt

    monkeypatch.setattr(TL.M, "init_params", stop)
    with pytest.raises(KeyboardInterrupt):
        port_main(tmp_path, "--steps", "1", "--no-reduced")
    cfg = seen["cfg"]
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.d_ff) == (36, 2048, 151936, 11008)


def test_grad_compress_is_parsed_but_unused(tmp_path):
    """A reference defect the port keeps: ``--grad-compress`` is parsed and
    never read (in the reference's ``main`` the name occurs once, in its
    ``add_argument``); the port trains bit for bit the same with it."""
    src = inspect.getsource(RL.main)
    assert "args.grad_compress" not in src and '"--grad-compress"' in src
    a, _ = port_main(tmp_path / "a", "--steps", "2")
    b, _ = port_main(tmp_path / "b", "--steps", "2", "--grad-compress")
    for x, y in zip(flat_leaves(a), flat_leaves(b)):
        assert torch.equal(x, y)


def _stores_never_loads(fn, name: str) -> bool:
    tree = ast.parse(inspect.getsource(fn).lstrip())
    names = [n for n in ast.walk(tree) if isinstance(n, ast.Name) and n.id == name]
    return (any(isinstance(n.ctx, ast.Store) for n in names)
            and not any(isinstance(n.ctx, ast.Load) for n in names))


def test_reference_launcher_defects_kept(tmp_path, monkeypatch):
    """Both launchers, 3 steps with a checkpoint every step:

    - ``data_shards`` is computed and never used: the reference assigns it
      and reads it nowhere; both build the pipeline with ``shard_count=1``;
    - a periodic checkpoint taken after step N's update records data step
      N, so a resume from it runs step N again: ``step_1`` holds two
      updates (opt step 2) and says data step 1, in both packages.
    """
    assert _stores_never_loads(RL.main, "data_shards")
    made = []
    for mod in (RL, TL):
        real = mod.DataPipeline

        def spy(*a, real=real, **kw):
            made.append(kw)
            return real(*a, **kw)

        monkeypatch.setattr(mod, "DataPipeline", spy)
    args = [*SMALL, "--steps", "3", "--ckpt-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *args, "--ckpt", str(tmp_path / "ref")])
    RL.main()
    TL.main([*args, "--ckpt", str(tmp_path / "port"), "--device", "cpu"])
    assert [kw["shard_count"] for kw in made] == [1, 1]
    assert all(kw.get("shard_index", 0) == 0 and kw["seed"] == 0 for kw in made)
    _, ropt, rextra = RCk.restore(str(tmp_path / "ref"), step=1)
    _, topt, textra = C.restore(str(tmp_path / "port"), step=1, device="cpu")
    assert rextra == textra == dict(data=dict(seed=0, step=1, shard=0))
    assert int(np.asarray(ropt["step"])) == int(topt["step"]) == 2
    for d in ("ref", "port"):
        assert sorted(p.name for p in (tmp_path / d).iterdir() if p.name.startswith("step_")) \
            == ["step_1", "step_2", "step_3"]
