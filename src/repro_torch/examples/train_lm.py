"""End-to-end training driver: train a ~100M-param LM for a few hundred
steps with checkpoint/restart, demonstrating the full train stack
(data pipeline → model → AdamW → checkpointing).

    python -m repro_torch.examples.train_lm --steps 300 --arch mamba2-130m [--device cpu]

The port of ``examples/train_lm.py``: the same flags plus ``--device``.
A run whose ``--ckpt`` holds a checkpoint resumes from the latest one.
"""
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

# ~100M-parameter same-family config (dense ~119M)
REDUCED = dict(d_model=768, n_layers=12, vocab=32000, d_ff=2048,
               n_heads=12, n_kv_heads=4, head_dim=64)


def main(argv=None) -> dict:
    """Train on ``argv``; returns the start step, the losses logged by
    step, and the final params and optimizer state."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro-torch-train-ckpt"))
    ap.add_argument("--full-size", action="store_true",
                    help="use the arch's real config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg, **REDUCED)
    print(f"arch={cfg.name} params~{cfg.n_params()/1e6:.0f}M "
          f"(training {args.steps} steps, batch {args.batch}x{args.seq})")

    opt_cfg = OptConfig(lr=3e-4, warmup=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg)
    data = DataPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0,
                        device=str(device))

    start = 0
    if C.latest_step(args.ckpt) is not None:
        pv, opt, extra = C.restore(args.ckpt, device=device)
        start = extra["data"]["step"]
        print(f"resumed from checkpoint at step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        pv, _ = split_params(M.init_params(cfg, gen, device=device))
        opt = init_opt_state(opt_cfg, pv)

    losses = {}
    t0 = time.time()
    for step in range(start, args.steps):
        pv, opt, metrics = step_fn(pv, opt, data.get_batch(step))
        if step % 20 == 0 or step == args.steps - 1:
            loss = losses[step] = float(metrics["loss"])
            tput = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {tput:,.0f} tok/s")
        if step and step % 100 == 0:
            C.save(args.ckpt, step, pv, opt, extra=dict(data=data.state(step)))
            print(f"  checkpointed at step {step}")
    C.save(args.ckpt, args.steps, pv, opt,
           extra=dict(data=data.state(args.steps)))
    print("done; final checkpoint written to", args.ckpt)
    return dict(start=start, losses=losses, params=pv, opt=opt)


if __name__ == "__main__":
    main()
