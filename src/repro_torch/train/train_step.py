"""The train step: loss → grads → AdamW, with microbatch gradient
accumulation (the reference's ``repro.train.train_step``).

Grads come from ``torch.autograd.grad`` over the param tree's leaves;
the leaves are marked ``requires_grad`` on the step's first call. The
optimizer then updates those same tensors in place
(:func:`repro_torch.train.optimizer.apply_updates`). Metrics stay on the
device as tensors: the host reads them only where it prints.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.sharding import on_mesh
from repro_torch.train.optimizer import OptConfig, apply_updates, flat_leaves, unflatten_like


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) → (params, opt, metrics).

    ``microbatches > 1`` splits the batch on its leading axis and averages
    the float32 grads and the losses of the pieces, as the reference's
    ``lax.scan`` does.
    """

    def grads_of(leaves, params, batch):
        loss = M.loss_fn(cfg, params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    @on_mesh()
    def train_step(params, opt_state, batch):
        leaves = flat_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        if microbatches == 1:
            loss, grads = grads_of(leaves, params, batch)
        else:
            if any(v.shape[0] % microbatches for v in batch.values()):
                raise ValueError(f"batch does not split into {microbatches} microbatches")
            pieces = {k: v.chunk(microbatches) for k, v in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            lsum = 0.0
            for i in range(microbatches):
                loss, g = grads_of(leaves, params, {k: v[i] for k, v in pieces.items()})
                with torch.no_grad():
                    for a, gi in zip(gsum, g):
                        a.add_(gi)
                del g
                lsum = lsum + loss
            with torch.no_grad():
                grads = [a.div_(microbatches) for a in gsum]
            loss = lsum / microbatches
        params, opt_state, info = apply_updates(
            opt_cfg, params, unflatten_like(params, grads), opt_state
        )
        return params, opt_state, dict(loss=loss, **info)

    return train_step
