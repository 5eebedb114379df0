"""Training launcher (the reference's ``repro.launch.train``).

Brings up the device mesh, places params and optimizer state with the
logical-axis rules, runs the train step with checkpoint/restart, and
keeps the reference's fault-tolerance contract:

  - checkpoint every N steps (atomic; resumable mid-run, ``--resume``);
  - deterministic counter-based data pipeline → exact skip-ahead on
    restart;
  - elastic restart: ``--resume`` restores each leaf straight onto the
    current mesh (``restore(shardings=...)``); the checkpoint stores
    whole arrays, not device layouts, so the mesh may differ from the
    one that saved it;
  - a per-step wall-clock watchdog (``--step-timeout``) that checkpoints
    and exits 75 (EX_TEMPFAIL) so the scheduler restarts from the last
    step.

Run it as ``python -m repro_torch.launch.train --arch qwen2.5-3b`` (the
card; ``--device cpu`` for the CPU). ``--reduced`` (the default) trains
the small same-family config; ``--no-reduced`` trains the published
widths. The reference's ``--reduced`` is ``store_true`` with
``default=True``, so its full widths cannot be asked for from its command
line.

The mesh is :func:`make_debug_mesh` over the process group (1 x 1 when
the launcher runs alone: it then starts and ends a one-rank group, and
every tensor stays a plain tensor on the device), or with
``--production-mesh`` the ``(32, 8)`` mesh, ``(2, 32, 8)`` with
``--multipod``; those need a process group of 256 / 512 ranks and raise
otherwise. As in the reference, ``--multipod`` without
``--production-mesh`` changes nothing, ``--grad-compress`` is parsed but
not wired to the step, the data-parallel width ``data_shards`` is
computed and not used (the pipeline is built with ``shard_count=1``), and
a periodic or watchdog checkpoint taken after step N's update records
data step N, so a resume from it runs step N again.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve
from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import is_param, split_params, tree_map  # noqa: F401
from repro_torch.models.sharding import ShardingRules, mesh_axes, place, set_rules
from repro_torch.train import checkpoint as C
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train a language model with the port.")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--step-timeout", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of nested dicts of one structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def shard_tree(tree_vals, tree_axes, rules):
    """Place every leaf by its logical axes on ``rules.mesh``: a DTensor
    with :meth:`ShardingRules.placements`, or on a mesh of one device the
    plain tensor on that device."""
    return tree_map2(
        lambda v, ax: place(v, rules.mesh, rules.placements(ax, v.shape)),
        tree_vals, tree_axes,
    )


def param_axes(cfg):
    """(shapes, logical axes) of ``cfg``'s param tree, from fake tensors:
    nothing is allocated."""
    with FakeTensorMode():
        vals, axes = split_params(M.init_params(cfg, 0, device="cpu"))
    return tree_map(lambda v: tuple(v.shape), vals), axes


def value(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def main(argv=None):
    """Run the launcher on ``argv`` (``sys.argv[1:]`` when None); returns
    the trained (params, opt_state)."""
    args = parse_args(argv)
    device = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    started = ensure_process_group(device)
    try:
        return _run(args, cfg, device)
    finally:
        set_rules(ShardingRules(mesh=None))
        if started:
            dist.destroy_process_group()


def _run(args, cfg, device):
    mesh = (
        make_production_mesh(multi_pod=args.multipod, device=device)
        if args.production_mesh
        else make_debug_mesh(device=device)
    )
    rules = ShardingRules(mesh=mesh)
    set_rules(rules)
    sizes = mesh_axes(mesh)
    print(f"mesh: {sizes}  device: {device}  arch: {cfg.name} "
          f"({cfg.n_params()/1e6:.0f}M params)")

    data_shards = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    data = DataPipeline(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0,
        shard_count=1, device=str(device),
    )
    opt_cfg = OptConfig(total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)
    shapes, pax = param_axes(cfg)

    start = 0
    if args.resume and C.latest_step(args.ckpt) is not None:
        pshard = tree_map2(lambda s, ax: (mesh, rules.placements(ax, s)), shapes, pax)
        oshard = dict(mu=pshard, nu=pshard, step=(mesh, rules.placements((), ())))
        pv, opt, extra = C.restore(args.ckpt, shardings=(pshard, oshard), device=device)
        start = extra["data"]["step"]
        print(f"resumed at step {start} (placed on the current mesh)")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        pv = split_params(M.init_params(cfg, gen, device=device))[0]
        pv = shard_tree(pv, pax, rules)
        opt = init_opt_state(opt_cfg, pv)

    t_run = time.time()
    for step in range(start, args.steps):
        t0 = time.time()
        batch = shard_tree(data.get_batch(step), dict(tokens=("batch",), labels=("batch",)), rules)
        pv, opt, metrics = step_fn(pv, opt, batch)
        if args.step_timeout and (time.time() - t0) > args.step_timeout:
            print(f"step {step} exceeded {args.step_timeout}s — "
                  "checkpointing and aborting for reschedule")
            C.save(args.ckpt, step, pv, opt, extra=dict(data=data.state(step)))
            raise SystemExit(75)  # EX_TEMPFAIL → scheduler restarts
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(value(metrics['loss'])):.4f} "
                  f"lr {float(value(metrics['lr'])):.2e} "
                  f"{(time.time()-t0)*1e3:.0f} ms/step")
        if step and step % args.ckpt_every == 0:
            C.save(args.ckpt, step, pv, opt, extra=dict(data=data.state(step)))
    C.save(args.ckpt, args.steps, pv, opt, extra=dict(data=data.state(args.steps)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tok = (args.steps - start) * args.batch * args.seq
    print(f"done: {tok / (time.time()-t_run):,.0f} tok/s")
    return pv, opt


if __name__ == "__main__":
    main()
