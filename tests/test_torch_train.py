"""The port's optimizer, train step and gradient compression against the
JAX package, on the same numpy inputs.

Tolerances:

- ``schedule``: 2.5e-7 relative (two float32 ulps; the packages' ``cos``
  differ in the last ulp at some steps).
- ``apply_updates``: params 1e-5 relative (1.9e-6 seen after five steps);
  moments 1e-5 of the leaf's largest magnitude: XLA contracts
  ``mu * b1 + g * (1 - b1)`` into one fused multiply-add, torch rounds
  the product first, so an element that nearly cancels differs in its
  last bits; ``grad_norm`` 1e-6 relative (summation order). With
  bfloat16 moments a float32 difference of one ulp can round a moment to
  the neighbouring bfloat16 value (2^-8 relative), which moves Adam's
  step by ~0.4%: there moments agree to one bfloat16 ulp (rtol 2^-7) and
  params to 2e-4 absolute at lr 1e-2 (7.7e-5 seen).
- The train step (float32 activations, lr 1e-2): losses 1e-5 absolute,
  the first step's grads 1e-4 relative (Frobenius, per leaf), params after
  three steps 2e-4 absolute (8.0e-5 seen). Adam's first step is
  ``g / (|g| + eps)``, a sign, so an element whose grad lies within float
  error of zero could move by up to ``2 * lr`` where the two packages'
  grads differ in sign; that the grads agree to 1e-4 first is what keeps
  the bound.
- ``quantize`` / ``dequantize``: bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.data.pipeline import DataPipeline as RefData  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import split_params as ref_split  # noqa: E402
from repro.train import compress as RC  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import numpy_from_params, params_from_numpy  # noqa: E402
from repro_torch.train import compress as TC  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from test_torch_train_grads import flat, rel_err  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"blocks": {"w": (2, 8, 16), "ln": (2, 16)}, "embed": (32, 16), "final_norm": (16,)}


def np_tree(fn, shapes=SHAPES):
    return {k: np_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def leaves32(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flat(tree).items()}


@pytest.mark.parametrize("total", [10, 1000])
def test_schedule_matches_reference(total):
    for w in (1, 100):
        rc, tc = RO.OptConfig(warmup=w, total_steps=total), TO.OptConfig(warmup=w, total_steps=total)
        for step in sorted({0, 1, w - 1, w, w + 1, total // 2, total - 1, total, total + 7}):
            want = float(RO.schedule(rc, jnp.int32(step)))
            got = TO.schedule(tc, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), want, rtol=2.5e-7, err_msg=f"step {step}")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("steps", [1, 5])
def test_apply_updates_matches_reference(monkeypatch, steps, clip, moments):
    monkeypatch.setattr(TO, "CHUNK", 40)  # several in-place slices a leaf
    rng = np.random.default_rng(steps * 4 + clip * 2 + (moments == "bfloat16"))
    params = np_tree(lambda s: rng.normal(size=s).astype(np.float32))
    gscale = 100.0 if clip else 1e-3  # grad norm ~2,500 or ~0.025 against clip 1.0
    grads = [np_tree(lambda s: (gscale * rng.normal(size=s)).astype(np.float32))
             for _ in range(steps)]
    kw = dict(lr=1e-2, warmup=2, total_steps=10, moment_dtype=moments)
    rc, tc = RO.OptConfig(**kw), TO.OptConfig(**kw)
    rp = jax.tree.map(jnp.asarray, params)
    ro = RO.init_opt_state(rc, rp)
    tp = params_from_numpy(params, "cpu")
    to = TO.init_opt_state(tc, tp)
    ids = [id(t) for t in TO.flat_leaves(dict(p=tp, o=to))]
    upd = jax.jit(lambda p, g, o: RO.apply_updates(rc, p, g, o))
    for g in grads:
        rp, ro, rinfo = upd(rp, jax.tree.map(jnp.asarray, g), ro)
        tp2, to2, tinfo = TO.apply_updates(tc, tp, params_from_numpy(g, "cpu"), to)
        assert tp2 is tp and to2 is to  # updated in place
        np.testing.assert_allclose(tinfo["grad_norm"].item(), float(rinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tinfo["lr"].item(), float(rinfo["lr"]), rtol=2.5e-7)
    assert [id(t) for t in TO.flat_leaves(dict(p=tp, o=to))] == ids
    assert int(to["step"]) == int(ro["step"]) == steps
    bf16 = moments == "bfloat16"
    for k, want in leaves32(rp).items():
        np.testing.assert_allclose(f32(tp, k), want, rtol=1e-5, atol=2e-4 if bf16 else 0,
                                   err_msg=k)
    for m in ("mu", "nu"):
        assert all(t.dtype == getattr(torch, moments) for t in TO.flat_leaves(to[m]))
        for k, want in leaves32(ro[m]).items():
            got = f32(to[m], k)
            if bf16:
                np.testing.assert_allclose(got, want, rtol=2**-7, err_msg=f"{m} {k}")
            else:
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (m, k)


def f32(tree, key) -> np.ndarray:
    return flat(numpy_from_params(tree))[key].astype(np.float32)


def test_weight_decay_reaches_stacked_1d_params():
    """A reference defect both packages keep: decay applies where
    ``p.ndim >= 2``, which a stacked (layers, d) norm scale or bias
    passes. With zero grads Adam's step is 0, so only the decay moves a
    param: the stacked ``blocks/ln`` shrinks by ``lr * wd``, the unstacked
    ``final_norm`` does not move."""
    params = np_tree(lambda s: np.full(s, 2.0, np.float32))
    zeros = np_tree(lambda s: np.zeros(s, np.float32))
    rc, tc = RO.OptConfig(lr=0.5, warmup=1), TO.OptConfig(lr=0.5, warmup=1)
    rp = jax.tree.map(jnp.asarray, params)
    rp, _, rinfo = RO.apply_updates(rc, rp, jax.tree.map(jnp.asarray, zeros), RO.init_opt_state(rc, rp))
    tp = params_from_numpy(params, "cpu")
    TO.apply_updates(tc, tp, params_from_numpy(zeros, "cpu"), TO.init_opt_state(tc, tp))
    lr = float(rinfo["lr"])
    for got in (leaves32(rp), flat(numpy_from_params(tp))):
        np.testing.assert_allclose(got["blocks/ln"], 2.0 - lr * 0.1 * 2.0, rtol=1e-6)
        np.testing.assert_array_equal(got["final_norm"], 2.0)


def tiny(dtype="float32"):
    over = dict(n_layers=2, d_model=128, d_ff=256, vocab=128, dtype=dtype)
    rcfg = ref_reduced(ref_get_config("qwen2.5-3b"), **over)
    tcfg = reduced(get_config("qwen2.5-3b"), **over)
    pv = ref_split(RM.init_params(rcfg, jax.random.key(0)))[0]
    return rcfg, tcfg, pv


def port_batch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def test_train_step_matches_reference_three_steps():
    rcfg, tcfg, pv = tiny()
    tp = params_from_numpy(jax.tree.map(np.asarray, pv), "cpu")
    data = RefData(vocab=tcfg.vocab, batch=8, seq=32, seed=1)

    # grads before the optimizer, first batch
    b0 = data.get_batch(0)
    rg = jax.jit(jax.grad(lambda p, b: RM.loss_fn(rcfg, p, b)))(pv, b0)
    leaves = flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tg = torch.autograd.grad(M.loss_fn(tcfg, tp, port_batch(b0)), list(leaves.values()))
    for k, g in zip(leaves, tg):
        assert rel_err(g.numpy(), np.asarray(flat(rg)[k])) <= 1e-4, k

    kw = dict(lr=1e-2, warmup=5, total_steps=60)
    ro, to = RO.OptConfig(**kw), TO.OptConfig(**kw)
    ropt, topt = RO.init_opt_state(ro, pv), TO.init_opt_state(to, tp)
    rstep, tstep = jax.jit(ref_make_train_step(rcfg, ro)), TS.make_train_step(tcfg, to)
    for i in range(3):
        b = data.get_batch(i)
        pv, ropt, rm = rstep(pv, ropt, b)
        tp, topt, tm = tstep(tp, topt, port_batch(b))
        assert set(tm) == {"loss", "grad_norm", "lr"}
        assert all(isinstance(v, torch.Tensor) for v in tm.values())
        assert abs(tm["loss"].item() - float(rm["loss"])) <= 1e-5, i
        np.testing.assert_allclose(tm["grad_norm"].item(), float(rm["grad_norm"]), rtol=1e-5)
        got = flat(numpy_from_params(tp))
        for k, want in leaves32(pv).items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-4, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_microbatch_accumulation_matches_full(monkeypatch, dtype):
    """``make_train_step(microbatches=2)``'s grads (caught before the
    optimizer) and loss against the full batch's, at the reference test's
    tolerance (bfloat16: atol 5e-3, rtol 0.1), and in float32 against the
    reference's mean of the two halves' grads (1e-4 relative)."""
    rcfg, tcfg, pv = tiny(dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, pv), "cpu")
    b = RefData(vocab=tcfg.vocab, batch=8, seq=32, seed=1).get_batch(0)
    seen = {}

    def catch(cfg, params, grads, opt_state):
        seen["grads"] = flat(grads)
        return params, opt_state, {}

    monkeypatch.setattr(TS, "apply_updates", catch)
    step = TS.make_train_step(tcfg, TO.OptConfig(), microbatches=2)
    _, _, metrics = step(tp, None, port_batch(b))
    leaves = flat(tp)
    full_loss = M.loss_fn(tcfg, tp, port_batch(b))
    full = dict(zip(leaves, torch.autograd.grad(full_loss, list(leaves.values()))))
    halves = [M.loss_fn(tcfg, tp, {k: v[i * 4:(i + 1) * 4] for k, v in port_batch(b).items()})
              for i in range(2)]
    assert torch.equal(metrics["loss"], (0.0 + halves[0] + halves[1]) / 2)
    for k, g in seen["grads"].items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), full[k].float().numpy(), atol=5e-3, rtol=0.1)
    if dtype == "float32":
        mb = jax.tree.map(lambda x: x.reshape(2, 4, *x.shape[1:]), b)
        grad = jax.jit(jax.grad(lambda p, bb: RM.loss_fn(rcfg, p, bb)))
        g0, g1 = (grad(pv, jax.tree.map(lambda x: x[i], mb)) for i in range(2))
        acc = flat(jax.tree.map(lambda a, c: (a + c) / 2, g0, g1))
        for k, g in seen["grads"].items():
            assert rel_err(g.numpy(), np.asarray(acc[k])) <= 1e-4, k


def test_quantize_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    for shape, s in (((128,), 1.0), ((4, 33), 1e-3), ((7,), 1e4)):
        g = (s * rng.normal(size=shape)).astype(np.float32)
        r = (0.01 * s * rng.normal(size=shape)).astype(np.float32)
        g[0] = 0.5 * s  # ties on the rounding grid are likely elsewhere too
        rq, rs, rr = RC.quantize(jnp.asarray(g), jnp.asarray(r))
        tq, ts, tr = TC.quantize(torch.as_tensor(g), torch.as_tensor(r))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert ts.item() == float(rs)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(rr))
        np.testing.assert_array_equal(TC.dequantize(tq, ts).numpy(), np.asarray(RC.dequantize(rq, rs)))
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]) * (127.0 / 2.5)  # scale 1/127 * 2.5
    q, _, _ = TC.quantize(x, torch.zeros_like(x))
    assert q.tolist() == [25, 76, 127, -25, -127]  # 25.4 → 25, 76.2 → 76


def test_quantize_error_feedback():
    """Twin of the reference's: accumulated dequantized updates converge to
    the sum; a single shot's error is bounded by scale / 2."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(128,)), dtype=torch.float32)
    res = torch.zeros_like(g)
    total_q = torch.zeros_like(g)
    for _ in range(50):
        q, scale, res = TC.quantize(g, res)
        total_q = total_q + TC.dequantize(q, scale)
    np.testing.assert_allclose(total_q.numpy() / 50, g.numpy(), atol=2e-3)
    q, scale, r2 = TC.quantize(g, torch.zeros_like(g))
    assert float(r2.abs().max()) <= float(scale) / 2 + 1e-6


PSUM_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.train.compress import compressed_psum

    def run(rank, world, init, out):
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        data = np.load(out + "/in.npz")
        grads = {"a": torch.as_tensor(data[f"a{rank}"]),
                 "b": {"c": torch.as_tensor(data[f"c{rank}"])}}
        res = {"a": torch.as_tensor(data[f"ra{rank}"]), "b": {"c": torch.zeros(3, 5)}}
        mean, new_res = compressed_psum(grads, res)
        np.savez(f"{out}/out{rank}.npz", a=mean["a"].numpy(), c=mean["b"]["c"].numpy(),
                 ra=new_res["a"].numpy(), rc=new_res["b"]["c"].numpy())
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        out, world = sys.argv[1], int(sys.argv[2])
        mp.spawn(run, args=(world, "file://" + out + "/rdv", out), nprocs=world)
""")


def test_compressed_psum_four_gloo_ranks(tmp_path):
    """Four gloo ranks, one process each, against numpy: the scale is the
    max of the ranks' scales, each rank's payload is its own rounding on
    that scale, the mean is their int32 sum times the scale over 4, and
    each rank keeps its own residual."""
    world = 4
    rng = np.random.default_rng(11)
    arrays = {}
    for r in range(world):
        arrays[f"a{r}"] = (rng.normal(size=(64,)) * (r + 1)).astype(np.float32)
        arrays[f"ra{r}"] = (0.01 * rng.normal(size=(64,))).astype(np.float32)
        arrays[f"c{r}"] = rng.normal(size=(3, 5)).astype(np.float32)
    np.savez(tmp_path / "in.npz", **arrays)
    script = tmp_path / "psum.py"
    script.write_text(PSUM_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, str(script), str(tmp_path), str(world)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]

    def oracle(gs, rs):
        xs = [g + r for g, r in zip(gs, rs)]
        scale = max(np.float32(max(np.abs(x).max(), 1e-12)) / np.float32(127.0) for x in xs)
        qs = [np.clip(np.round(x / scale), -127, 127) for x in xs]
        mean = np.sum([q.astype(np.int32) for q in qs], axis=0).astype(np.float32) * scale / np.float32(world)
        return mean, [x - q * scale for x, q in zip(xs, qs)]

    mean_a, res_a = oracle([arrays[f"a{r}"] for r in range(world)], [arrays[f"ra{r}"] for r in range(world)])
    mean_c, res_c = oracle([arrays[f"c{r}"] for r in range(world)], [np.zeros((3, 5), np.float32)] * world)
    for r in range(world):
        out = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_allclose(out["a"], mean_a, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["c"], mean_c, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["ra"], res_a[r], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["rc"], res_c[r], rtol=1e-6, atol=1e-7)
