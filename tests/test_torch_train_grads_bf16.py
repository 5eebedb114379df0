"""Loss and gradients of the port against the JAX package with the
configs' own bfloat16 activations (all ten architectures at ``reduced``,
the reference's params, one batch of tokens and labels).

Looser than the float32 case (``test_torch_train_grads.py``): both
packages round to bfloat16 after each op, but the reference runs jitted
and XLA's fusions skip some of those roundings, so a value one bfloat16
ulp apart (2^-8 relative) travels through the layers and back.

- loss: 5e-3 absolute (1.9e-5 to 1.1e-3 seen on a ~6.3 loss);
- each grad leaf: finite, relative Frobenius error 0.1 (1.9e-2 to
  4.9e-2 seen, the SSM's ``a_log`` largest).

The two MoE families are held to finiteness and the loss bound at 2e-2
only (2.7e-3 and 6.8e-3 seen): their router logits tie in bfloat16, and
a one-ulp step moves a token to another expert, which changes that
expert's grads outright. Their grads are compared in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_train_grads import (  # noqa: E402
    flat, reference_loss_and_grads, rel_err, twin_train_batch,
)
from torch_lm import f32, one_torch_thread, twin_configs, twin_params  # noqa: E402,F401

MOE = ("qwen3-moe-235b-a22b", "arctic-480b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_bfloat16(arch):
    rcfg, tcfg = twin_configs(arch)
    assert tcfg.dtype == "bfloat16"
    pv, tp = twin_params(rcfg)
    rb, tb = twin_train_batch(tcfg)
    ref_loss, ref_grads = reference_loss_and_grads(rcfg, pv, rb)
    leaves = flat(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = M.loss_fn(tcfg, tp, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert np.isfinite(loss.item())
    assert abs(loss.item() - ref_loss) <= (2e-2 if arch in MOE else 5e-3), (loss.item(), ref_loss)
    for k, g in grads.items():
        a = f32(g)
        assert a.shape == ref_grads[k].shape and np.isfinite(a).all(), k
        if arch not in MOE:
            err = rel_err(a, ref_grads[k])
            assert err <= 0.1, (k, err)
