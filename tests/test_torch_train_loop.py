"""Training behaviour of the port on its own pipeline (twins of the
training cases of ``tests/test_train_serve.py`` and of
``tests/test_system.py::test_lm_pipeline_end_to_end``), checkpoints that
each package writes and the other restores, and the manifest's msgpack.

The port's tokens come from its own generator (threefry is not
reproduced), so these twins hold the port to the reference's bars, not
to its numbers. Exact resume is bit for bit on the CPU. Checkpoints
cross leaf for leaf, bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as RM  # noqa: E402
from repro.models.layers import split_params as ref_split  # noqa: E402
from repro.train import checkpoint as RCk  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, batch_seed  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import numpy_from_params, params_from_numpy  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import minipack  # noqa: E402
from repro_torch.train.optimizer import OptConfig, flat_leaves, init_opt_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from test_torch_train import tiny  # noqa: E402
from test_torch_train_grads import flat  # noqa: E402
from torch_lm import one_torch_thread  # noqa: E402,F401


def tiny_setup(steps=60, vocab=128, seed=1):
    """The reference test's ``tiny_setup`` on the port."""
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=2, d_model=128, d_ff=256, vocab=vocab)
    pv = split_params(M.init_params(cfg, 0, device="cpu"))[0]
    opt_cfg = OptConfig(lr=1e-2, warmup=5, total_steps=steps)
    opt = init_opt_state(opt_cfg, pv)
    step_fn = make_train_step(cfg, opt_cfg)
    data = DataPipeline(vocab=cfg.vocab, batch=8, seq=32, seed=seed, device="cpu")
    return cfg, pv, opt, step_fn, data


def test_loss_decreases():
    cfg, pv, opt, step_fn, data = tiny_setup()
    losses = []
    for i in range(40):
        pv, opt, m = step_fn(pv, opt, data.get_batch(i))
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]
    assert np.isfinite(losses).all()


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}


def test_checkpoint_exact_resume(tmp_path):
    cfg, pv, opt, step_fn, data = tiny_setup()
    p1, o1 = clone(pv), clone(opt)
    for i in range(10):
        p1, o1, _ = step_fn(p1, o1, data.get_batch(i))
    p2, o2 = clone(pv), clone(opt)
    for i in range(5):
        p2, o2, _ = step_fn(p2, o2, data.get_batch(i))
    C.save(str(tmp_path), 5, p2, o2, extra=dict(data=data.state(5)))
    del p2, o2
    rp, ro, extra = C.restore(str(tmp_path), device="cpu")
    assert extra["data"]["step"] == 5
    for i in range(extra["data"]["step"], 10):
        rp, ro, _ = step_fn(rp, ro, data.get_batch(i))
    for a, b in zip(flat_leaves(dict(p=p1, o=o1)), flat_leaves(dict(p=rp, o=ro))):
        assert torch.equal(a, b)


def test_checkpoint_keep_and_latest(tmp_path):
    cfg, pv, opt, step_fn, data = tiny_setup()
    for s in (1, 2, 3, 4):
        C.save(str(tmp_path), s, pv, opt, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    assert C.latest_step(str(tmp_path)) == 4
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_data_pipeline_determinism_and_sharding():
    d = DataPipeline(vocab=100, batch=8, seq=16, seed=7, device="cpu")
    b1, b2 = d.get_batch(3), d.get_batch(3)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], d.get_batch(4)["tokens"])
    s0 = DataPipeline(vocab=100, batch=8, seq=16, seed=7, shard_index=0, shard_count=2, device="cpu")
    s1 = DataPipeline(vocab=100, batch=8, seq=16, seed=7, shard_index=1, shard_count=2, device="cpu")
    a, b = s0.get_batch(0), s1.get_batch(0)
    assert a["tokens"].shape == (4, 16)
    assert not torch.equal(a["tokens"], b["tokens"])
    assert batch_seed(7, 0, 0) != batch_seed(7, 0, 1) != batch_seed(7, 1, 0)


def test_data_pipeline_mix_and_labels():
    """The reference's mix and labels: tokens int32 in [0, vocab); about
    80% + 20%/64 of them below vocab // 64; labels the tokens shifted
    left, the last position 0."""
    d = DataPipeline(vocab=6400, batch=64, seq=128, seed=2, device="cpu")
    b = d.get_batch(0)
    t, lab = b["tokens"], b["labels"]
    assert t.dtype == lab.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 6400
    common = float((t < 100).float().mean())
    assert abs(common - (0.8 + 0.2 / 64)) < 0.01, common
    assert torch.equal(lab[:, :-1], t[:, 1:]) and not lab[:, -1].any()
    assert d.state(5) == dict(seed=2, step=5, shard=0)


def test_convert_round_trip():
    rcfg, tcfg, pv = tiny()
    ref = jax.tree.map(np.asarray, pv)
    back = numpy_from_params(params_from_numpy(ref, "cpu"))
    assert flat(back).keys() == flat(ref).keys()
    for k, v in flat(ref).items():
        assert flat(back)[k].dtype == v.dtype
        np.testing.assert_array_equal(flat(back)[k], v)
    bf = {"w": torch.tensor([1.5, -3.0078125], dtype=torch.bfloat16)}
    assert numpy_from_params(bf)["w"].dtype == np.float32
    assert torch.equal(params_from_numpy(numpy_from_params(bf), "cpu", dtype=torch.bfloat16)["w"],
                       bf["w"])


def reference_state(moments="float32"):
    """The reference's params and an optimizer state with non-zero
    moments (one update on random grads)."""
    rcfg, _, pv = tiny()
    rc = RO.OptConfig(moment_dtype=moments)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), pv)
    pv, opt, _ = RO.apply_updates(rc, pv, grads, RO.init_opt_state(rc, pv))
    return pv, opt


def bits(a) -> np.ndarray:
    """An array's raw bytes (a bfloat16 or 2-byte void leaf as uint16)."""
    a = np.asarray(a).reshape(-1)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint8)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_restored_by_port(tmp_path, moments):
    pv, opt = reference_state(moments)
    RCk.save(str(tmp_path), 7, pv, opt, extra=dict(data=dict(seed=0, step=7, shard=0)))
    tp, to, extra = C.restore(str(tmp_path), device="cpu")
    assert extra == dict(data=dict(seed=0, step=7, shard=0))
    want = flat(dict(params=pv, opt=opt))
    got = flat(dict(params=tp, opt=to))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype) == f"torch.{w.dtype}", k
        got_bits = (g.view(torch.int16).numpy().view(np.uint16).reshape(-1)
                    if g.dtype == torch.bfloat16 else bits(g.numpy()))
        np.testing.assert_array_equal(got_bits, bits(w), err_msg=k)


def test_port_checkpoint_restored_by_reference(tmp_path):
    pv, opt = reference_state()
    tp = params_from_numpy(jax.tree.map(np.asarray, pv), "cpu")
    to = params_from_numpy(jax.tree.map(np.asarray, opt), "cpu")
    C.save(str(tmp_path), 3, tp, to, extra=dict(data=dict(seed=1, step=3, shard=0)))
    rp, ro, extra = RCk.restore(str(tmp_path))
    assert extra == dict(data=dict(seed=1, step=3, shard=0))
    assert RCk.latest_step(str(tmp_path)) == 3
    want = flat(dict(params=pv, opt=opt))
    got = flat(dict(params=rp, opt=ro))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(bits(got[k]), bits(w), err_msg=k)


def test_bfloat16_moments_cross_as_bits(tmp_path):
    """A reference defect kept on record: it writes ``ml_dtypes`` bfloat16
    leaves as ``.npy`` descr ``'<V2'``, which ``np.load`` reads back as
    raw 2-byte voids, so its own ``restore`` cannot rebuild the leaf. The
    port writes the same bytes under the same descr and reads a 2-byte
    void as bfloat16: the npz members are byte-identical, and the port
    restores both packages' files."""
    pv, opt = reference_state("bfloat16")
    RCk.save(str(tmp_path / "ref"), 1, pv, opt)
    with pytest.raises(TypeError, match="V2 is not a valid JAX array type"):
        RCk.restore(str(tmp_path / "ref"))
    tp = params_from_numpy(jax.tree.map(np.asarray, pv), "cpu")
    to = dict(params_from_numpy(jax.tree.map(np.asarray, opt), "cpu"))
    for m in ("mu", "nu"):
        to[m] = params_from_numpy(jax.tree.map(np.asarray, opt[m]), "cpu", dtype=torch.bfloat16)
    C.save(str(tmp_path / "port"), 1, tp, to)
    import zipfile

    with zipfile.ZipFile(tmp_path / "ref" / "step_1" / "arrays.npz") as zr, \
            zipfile.ZipFile(tmp_path / "port" / "step_1" / "arrays.npz") as zp:
        assert zr.namelist() == zp.namelist()
        for name in zr.namelist():
            assert zr.read(name) == zp.read(name), name
    for d in ("ref", "port"):
        _, ro, _ = C.restore(str(tmp_path / d), device="cpu")
        assert ro["mu"]["embed"].dtype == torch.bfloat16
        assert torch.equal(ro["mu"]["embed"], to["mu"]["embed"])


MANIFESTS = [
    dict(step=0, keys=[], extra={}),
    dict(step=30, keys=["opt/mu/embed", "params/blocks/attn/wq"], extra={}),
    dict(step=2**40, keys=["k" * 40, "é" * 200, "x" * 70_000],
         extra=dict(data=dict(seed=0, step=70_000, shard=-3),
                    note=None, ok=True, lr=3e-4, neg=-129, big=-(2**40), tup=(1, 2))),
    dict(step=5, keys=[f"params/l{i}" for i in range(20)],
         extra={str(i): i * 1000 for i in range(17)}),
]


def plain(o):
    """``o`` as msgpack reads it back: tuples become lists."""
    if isinstance(o, dict):
        return {k: plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [plain(v) for v in o]
    return o


@pytest.mark.parametrize("i", range(len(MANIFESTS)))
def test_manifest_round_trip(i):
    m = MANIFESTS[i]
    assert minipack.unpackb(minipack.packb(m)) == plain(m)
    with pytest.raises(ValueError):
        minipack.unpackb(minipack.packb(m)[:-1] if m["keys"] else b"\x81")


@pytest.mark.parametrize("i", range(len(MANIFESTS)))
def test_manifest_bytes_equal_msgpack(i):
    msgpack = pytest.importorskip("msgpack")
    m = MANIFESTS[i]
    raw = minipack.packb(m)
    assert raw == msgpack.packb(m)
    assert minipack.unpackb(raw) == msgpack.unpackb(raw)


def test_lm_pipeline_end_to_end(tmp_path):
    """Train 30 steps, save, restore, serve: greedy decode agrees with the
    forward pass's argmax."""
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=2, d_model=128, d_ff=256, vocab=256)
    pv = split_params(M.init_params(cfg, 0, device="cpu"))[0]
    opt_cfg = OptConfig(lr=5e-3, warmup=5, total_steps=30)
    opt = init_opt_state(opt_cfg, pv)
    step = make_train_step(cfg, opt_cfg)
    data = DataPipeline(vocab=cfg.vocab, batch=8, seq=32, seed=3, device="cpu")
    losses = []
    for i in range(30):
        pv, opt, m = step(pv, opt, data.get_batch(i))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]  # it learns
    C.save(str(tmp_path), 30, pv, opt)
    rp, _, _ = C.restore(str(tmp_path), device="cpu")
    eng = ServeEngine(cfg, rp, max_seq=64, device="cpu")
    prompt = data.get_batch(0)["tokens"][0, :16].numpy()
    out = eng.generate(prompt, max_new=4)
    with torch.no_grad():
        logits = M.forward(cfg, rp, dict(tokens=torch.as_tensor(prompt[None])), remat=False)
    assert int(out[0]) == int(torch.argmax(logits[0, -1]))
