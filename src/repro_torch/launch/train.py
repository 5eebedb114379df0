"""Training launcher (the reference's ``repro.launch.train``).

Builds the model on one device, runs the train step with
checkpoint/restart, and keeps the reference's fault-tolerance contract:

  - checkpoint every N steps (atomic; resumable mid-run, ``--resume``);
  - deterministic counter-based data pipeline → exact skip-ahead on
    restart;
  - a per-step wall-clock watchdog (``--step-timeout``) that checkpoints
    and exits 75 (EX_TEMPFAIL) so the scheduler restarts from the last
    step.

Run it as ``python -m repro_torch.launch.train --arch qwen2.5-3b`` (the
card; ``--device cpu`` for the CPU). ``--reduced`` (the default) trains
the small same-family config; ``--no-reduced`` trains the published
widths. The reference's ``--reduced`` is ``store_true`` with
``default=True``, so its full widths cannot be asked for from its command
line.

As in the reference, ``--grad-compress`` is parsed but not wired to the
step (one device has nothing to all-reduce), and a periodic or watchdog
checkpoint taken after step N's update records data step N, so a resume
from it runs step N again. Device meshes (``--production-mesh``,
``--multipod``) wait for the port's ``launch/mesh.py`` (ROADMAP queue 1,
item 14) and raise.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.models.layers import split_params
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


def main(argv=None):
    """Run the launcher on ``argv`` (``sys.argv[1:]`` when None); returns
    the trained (params, opt_state)."""
    args = parse_args(argv)
    if args.production_mesh or args.multipod:
        raise NotImplementedError(
            "--production-mesh / --multipod need the port's device mesh "
            "(launch/mesh.py, ROADMAP queue 1, item 14)"
        )
    device = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"device: {device}  arch: {cfg.name} ({cfg.n_params()/1e6:.0f}M params)")

    data = DataPipeline(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0,
        shard_count=1, device=str(device),
    )
    opt_cfg = OptConfig(total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)

    start = 0
    if args.resume and C.latest_step(args.ckpt) is not None:
        pv, opt, extra = C.restore(args.ckpt, device=device)
        start = extra["data"]["step"]
        print(f"resumed at step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        pv = split_params(M.init_params(cfg, gen, device=device))[0]
        opt = init_opt_state(opt_cfg, pv)

    t_run = time.time()
    for step in range(start, args.steps):
        t0 = time.time()
        batch = data.get_batch(step)
        pv, opt, metrics = step_fn(pv, opt, batch)
        if args.step_timeout and (time.time() - t0) > args.step_timeout:
            print(f"step {step} exceeded {args.step_timeout}s — "
                  "checkpointing and aborting for reschedule")
            C.save(args.ckpt, step, pv, opt, extra=dict(data=data.state(step)))
            raise SystemExit(75)  # EX_TEMPFAIL → scheduler restarts
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
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
