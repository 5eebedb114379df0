"""AdamW with warmup-cosine schedule, as the reference's
(``repro.train.optimizer``): global grad-norm clip, bias-corrected
moments, decoupled weight decay, moments stored in ``moment_dtype``.

The update runs **in place**: params and moments are overwritten, one
slice of at most ``CHUNK`` elements along a leaf's leading axis at a
time (one layer of a stacked weight), so the float32 temporaries of the
formula never exceed a slice. Each element goes through the reference's
float32 steps in the reference's order. ``apply_updates`` returns the
same tensors it was given (and the same ``opt_state`` dict, its ``step``
advanced), as ``decode_step`` returns its caches.

As in the reference, weight decay applies to every leaf with
``ndim >= 2``: stacked per-layer norm scales and biases, shaped
(layers, d), are decayed, the unstacked ``final_norm`` is not.
"""
from __future__ import annotations

import dataclasses
import math

import torch

CHUNK = 1 << 24  # elements per in-place slice (64 MB of float32)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16


def flat_leaves(tree) -> list:
    """The leaves of a nested-dict tree in the reference's order (keys
    sorted at every level, as ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    return [tree]


def unflatten_like(tree, leaves):
    """``leaves`` (in :func:`flat_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(tree)


def schedule(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int or an integer tensor) as a float32
    tensor: linear warmup, then cosine down to 10% of ``lr``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup) / max(1, cfg.total_steps - cfg.warmup), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: OptConfig, params):
    """Zero moments beside each param, on its device and, for a DTensor
    param, in its placements; ``step`` 0 (int32)."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree, dtype=dt)  # a DTensor keeps its placements

    device = flat_leaves(params)[0].device
    return dict(
        mu=zeros(params),
        nu=zeros(params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _slices(t: torch.Tensor):
    """Views of ``t`` along its leading axis, each at most ``CHUNK``
    elements (a whole row when one row is larger)."""
    if t.ndim == 0:
        yield t
        return
    rows = max(1, CHUNK // max(1, t[0].numel()))
    for lo in range(0, t.shape[0], rows):
        yield t[lo : lo + rows]


@torch.no_grad()
def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (reference order) of the float32 sum of
    squares, each leaf summed a slice at a time."""
    gsq = 0
    for g in flat_leaves(grads):
        leaf = 0
        for gc in _slices(g):
            leaf = leaf + torch.sum(torch.square(gc.float()))
        gsq = gsq + leaf
    return torch.sqrt(gsq)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step in place → (params, opt_state, dict(grad_norm, lr))."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    lr = schedule(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1**step
    bc2 = 1 - cfg.b2**step

    flat = zip(
        flat_leaves(params), flat_leaves(grads),
        flat_leaves(opt_state["mu"]), flat_leaves(opt_state["nu"]),
    )
    for p, g, mu, nu in flat:
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        for pc, gc, muc, nuc in zip(_slices(p), _slices(g), _slices(mu), _slices(nu)):
            g32 = gc.float() * scale
            mu32 = muc.float() * cfg.b1 + g32 * (1 - cfg.b1)
            nu32 = nuc.float() * cfg.b2 + torch.square(g32) * (1 - cfg.b2)
            delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
            p32 = pc.float()
            pc.copy_(p32 - lr * (delta + decay * p32))
            muc.copy_(mu32)
            nuc.copy_(nu32)
    return params, opt_state, dict(grad_norm=gnorm, lr=lr)
