"""``forward`` and ``decode_step`` of every architecture, port against the
JAX package, on the reference's params at ``reduced`` size.

Tolerances on logits (|logits| ~1.5 at these sizes):

- ``dtype="float32"`` configs, float32 decode caches: 1e-4 absolute. The
  packages differ only in matmul accumulation order and in the last ulp
  of transcendentals (~1e-6 seen).
- ``dtype="bfloat16"`` configs, the default bfloat16 caches: 5e-2
  absolute on logits, 3e-2 relative (Frobenius norm) on each cache.
  Elementwise steps round alike, op by op (bit for bit,
  ``test_torch_models.py``), but the reference runs jitted, and XLA's
  fusions drop some of the bfloat16 roundings between ops; a value a
  hair's width apart then rounds to a neighbouring bfloat16 value (one
  ulp at 4.0 is 3.1e-2), and that ulp travels through the layers. The MoE families in bfloat16 are left to
  the float32 case: their router logits tie in bfloat16, and such a
  one-ulp step moves a token to another expert.

The reference's ``encdec_prepare_cross`` cannot run (its scan body takes
the carry for the layer's params: ROADMAP queue 3), so the encdec case
projects the reference's cross K/V layer by layer in the test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402
from torch_lm import f32, twin_batch, twin_configs, twin_params  # noqa: E402

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
MOE = ("qwen3-moe-235b-a22b", "arctic-480b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_two_decode_steps_match_jax(arch, dtype):
    rcfg, tcfg = twin_configs(arch, dtype=dtype)
    pv, tp = twin_params(rcfg)
    rng = np.random.default_rng(0)
    rb, tb = twin_batch(tcfg, rng)
    atol = ATOL[dtype]
    logits = M.forward(tcfg, tp, tb)
    assert logits.shape == (2, 32 + (tcfg.frontend_len if tcfg.frontend == "vlm" else 0), tcfg.vocab)
    assert bool(torch.isfinite(logits).all())
    if dtype == "bfloat16" and arch in MOE:
        return
    ref = jax.jit(lambda p, b: RM.forward(rcfg, p, b, remat=False))(pv, rb)
    np.testing.assert_allclose(f32(logits), f32(ref), rtol=0, atol=atol)

    cache_dt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jdt, tdt = cache_dt[dtype]
    rc = RM.init_cache(rcfg, 2, 16, dtype=jdt)
    tc = M.init_cache(tcfg, 2, 16, dtype=tdt, device="cpu")
    if tcfg.family == "encdec":  # cross K/V from an encoder output, as prefill writes them
        enc = rng.normal(size=(2, 8, tcfg.d_model)).astype(np.float32)
        rk, rv = ref_cross(rcfg, pv, jnp.asarray(enc, jdt))
        tk, tv = M.encdec_prepare_cross(tcfg, tp, torch.as_tensor(enc).to(tdt))
        np.testing.assert_allclose(f32(tk), f32(rk), rtol=0, atol=atol)
        np.testing.assert_allclose(f32(tv), f32(rv), rtol=0, atol=atol)
        rc = dict(rc, cross_k=rk.astype(jdt), cross_v=rv.astype(jdt))
        tc = dict(tc, cross_k=tk.to(tdt), cross_v=tv.to(tdt))
    step = jax.jit(lambda p, c, t, pos: RM.decode_step(rcfg, p, c, t, pos))
    toks = rng.integers(0, tcfg.vocab, (2, 2)).astype(np.int32)
    for pos in range(2):
        rl, rc = step(pv, rc, jnp.asarray(toks[:, pos]), pos)
        tl, tc = M.decode_step(tcfg, tp, tc, torch.as_tensor(toks[:, pos]), pos)
        np.testing.assert_allclose(f32(tl), f32(rl), rtol=0, atol=atol, err_msg=f"pos {pos}")
    assert set(tc) == set(rc)
    for name in tc:  # the caches: states, KV, latents, conv windows
        assert tc[name].dtype == getattr(torch, str(rc[name].dtype)), name
        a, r = f32(tc[name]), f32(rc[name])
        if dtype == "float32":
            np.testing.assert_allclose(a, r, rtol=0, atol=atol, err_msg=name)
        else:
            assert np.linalg.norm(a - r) <= 3e-2 * np.linalg.norm(r), name


def ref_cross(cfg, pv, enc):
    """The reference's cross K/V projection, one layer at a time."""
    cross = pv["dec_blocks"]["cross"]
    b, s, _ = enc.shape
    shape = (b, s, cfg.n_kv_heads, cfg.hd)
    ks = [(enc @ cross["wk"][i].astype(enc.dtype)).reshape(shape) for i in range(cfg.dec_layers)]
    vs = [(enc @ cross["wv"][i].astype(enc.dtype)).reshape(shape) for i in range(cfg.dec_layers)]
    return jnp.stack(ks), jnp.stack(vs)


def test_reference_encdec_prepare_cross_cannot_run():
    """Reference defect (ROADMAP queue 3): ``encdec_prepare_cross`` scans
    with ``one(bp, _)``, so the carry (None) stands in for the layer's
    params. The port's loop projects each layer (the case above)."""
    rcfg, tcfg = twin_configs("seamless-m4t-medium")
    pv, tp = twin_params(rcfg)
    enc = np.random.default_rng(1).normal(size=(1, 4, tcfg.d_model)).astype(np.float32)
    with pytest.raises(TypeError, match="not subscriptable"):
        RM.encdec_prepare_cross(rcfg, pv, jnp.asarray(enc))
    tk, tv = M.encdec_prepare_cross(tcfg, tp, torch.as_tensor(enc))
    rk, rv = ref_cross(rcfg, pv, jnp.asarray(enc))
    np.testing.assert_allclose(f32(tk), f32(rk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(tv), f32(rv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b", "mamba2-130m", "gemma2-27b"])
def test_decode_matches_forward(arch):
    """Greedy decode logits must match teacher-forced forward logits (the
    port's twin of ``test_models_smoke.py``'s case: bfloat16, 3e-2)."""
    _, cfg = twin_configs(arch, n_layers=2)
    params = split_params(M.init_params(cfg, 1, device="cpu"))[0]
    rng = np.random.default_rng(3)
    b, s = 1, 8
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
    full = M.forward(cfg, params, dict(tokens=tokens))
    cache = M.init_cache(cfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        logits, cache = M.decode_step(cfg, params, cache, tokens[:, t], t)
        outs.append(logits)
    np.testing.assert_allclose(f32(torch.stack(outs, 1)), f32(full), rtol=3e-2, atol=3e-2)
