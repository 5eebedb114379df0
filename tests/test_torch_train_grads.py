"""Loss and gradients of the port against the JAX package.

``flash_attention``'s backward against autograd of a naive softmax
attention in float64 (causal, window, softcap, GQA, several q and kv
blocks). Tolerance 2e-5 absolute + 2e-4 relative: the kernel computes in
float32 (its inputs are cast), so its grads carry float32 rounding over
a few dozen terms; the values are O(1).

``loss_fn`` and every grad leaf of all ten architectures at ``reduced``
with ``dtype="float32"`` activations, on the reference's params and one
batch of tokens and labels, against ``jax.value_and_grad(loss_fn)``:

- loss: 1e-5 absolute (a ~6.3 loss; the packages differ only in GEMM
  summation order and the last ulp of transcendentals: 0 to 4.8e-7 seen);
- each grad leaf: relative Frobenius error 1e-4 (1.7e-6 to 9.0e-6 seen;
  the SSM's ``a_log`` and ``dt_bias`` pass through ``exp`` and
  ``softplus`` twice and lead).

The port's backward runs through a ``LanguageModel``'s params, each
turned to ``requires_grad_(True)``, and ``loss.backward()`` with
``remat=True`` (every block checkpointed), and through
``torch.autograd.grad`` with ``remat=False``; the two give equal values
(a recompute on the CPU repeats every op exactly).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from torch_lm import f32, one_torch_thread, twin_configs, twin_params  # noqa: E402,F401

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4


def naive_attention64(q, k, v, causal, window, cap):
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    kk = torch.repeat_interleave(k, h // kvh, dim=2)
    vv = torch.repeat_interleave(v, h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    if cap:
        s = torch.tanh(s / cap) * cap
    i, j = np.arange(sq)[:, None], np.arange(k.shape[1])[None, :]
    mask = np.ones((sq, k.shape[1]), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    s = torch.where(torch.as_tensor(mask)[None, None], s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize(
    "causal,window,cap,h,kvh",
    [
        (True, None, None, 4, 4),
        (True, None, None, 4, 2),  # GQA
        (True, 8, None, 4, 2),  # sliding window
        (True, None, 20.0, 4, 1),  # softcap, one kv head
        (True, 8, 20.0, 2, 2),
        (False, None, None, 4, 2),
    ],
)
def test_flash_attention_backward_matches_naive_float64(causal, window, cap, h, kvh):
    rng = np.random.default_rng(7)
    b, s, hd = 2, 40, 16
    arrays = [rng.normal(size=(b, s, n, hd)) for n in (h, kvh, kvh)]
    dout = torch.as_tensor(rng.normal(size=(b, s, h, hd)))
    q, k, v = (torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in arrays)
    out = L.flash_attention(q, k, v, causal=causal, window=window, cap=cap, block=16)
    got = torch.autograd.grad(out, (q, k, v), dout.float())
    q64, k64, v64 = (torch.tensor(a, requires_grad=True) for a in arrays)
    ref = naive_attention64(q64, k64, v64, causal, window, cap)
    want = torch.autograd.grad(ref, (q64, k64, v64), dout)
    np.testing.assert_allclose(out.detach().double().numpy(), ref.detach().numpy(),
                               rtol=2e-4, atol=2e-5)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def flat(tree, prefix=""):
    """path → leaf, keys sorted (the reference's leaf order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def twin_train_batch(cfg, b=2, s=32):
    """(reference batch, port batch): tokens, labels (some masked) and the
    frontend stub, from one numpy seed."""
    rng = np.random.default_rng(0)
    arrays = dict(
        tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        labels=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
    )
    arrays["labels"][:, -3:] = -1
    if cfg.frontend == "vlm":
        arrays["frontend"] = rng.normal(size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frontend"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return (
        {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: torch.as_tensor(v) for k, v in arrays.items()},
    )


def reference_loss_and_grads(rcfg, pv, rb):
    fn = jax.jit(jax.value_and_grad(lambda p, bb: RM.loss_fn(rcfg, p, bb)))
    loss, grads = fn(pv, rb)
    return float(loss), {k: f32(v) for k, v in flat(grads).items()}


def rel_err(a, r) -> float:
    return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_float32(arch):
    rcfg, tcfg = twin_configs(arch, dtype="float32")
    pv, tp = twin_params(rcfg)
    rb, tb = twin_train_batch(tcfg)
    ref_loss, ref_grads = reference_loss_and_grads(rcfg, pv, rb)

    model = M.LanguageModel(tcfg, tp)
    for p in model.parameters():
        p.requires_grad_(True)
    loss = M.loss_fn(tcfg, model.params, tb)
    loss.backward()
    grads = {k: p.grad for k, p in flat(model.params).items()}
    assert set(grads) == set(ref_grads)
    assert abs(loss.item() - ref_loss) <= LOSS_ATOL, (loss.item(), ref_loss)
    for k, g in grads.items():
        assert g is not None and g.shape == ref_grads[k].shape, k
        err = rel_err(f32(g), ref_grads[k])
        assert err <= GRAD_RTOL, (k, err)

    leaves = list(flat(model.params).values())
    loss2 = M.loss_fn(tcfg, model.params, tb, remat=False)
    again = torch.autograd.grad(loss2, leaves)
    assert torch.equal(loss2, loss)
    for k, a, g in zip(grads, again, grads.values()):
        assert torch.equal(a, g), k
