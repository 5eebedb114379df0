"""The port's model configs, params and layers against the JAX package.

Configs are carried as they are: equal field for field. Params carried
across with ``params_from_numpy`` are equal bit for bit. Layers get the
same numpy inputs on both sides, in float32: tolerance 1e-5 absolute and
relative unless a case says otherwise (different matmul and transcendental
implementations; one float32 ulp at 1.0 is 1.2e-7).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import sharding as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from repro_torch.models.convert import jax_tree_keys, params_from_numpy  # noqa: E402
from torch_lm import f32, twin_configs, twin_params  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ configs
def test_archs_and_remixdb_config_equal_the_reference():
    assert TC.ARCHS == RC.ARCHS
    for name in RC.ARCHS + ["remixdb"]:
        assert dataclasses.asdict(TC.get_config(name)) == dataclasses.asdict(RC.get_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("nope")


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_reduced_config_and_counts_equal_the_reference(arch):
    for over in ({}, dict(n_layers=2), dict(n_layers=2, d_model=128, d_ff=256, vocab=64)):
        r, t = RC.reduced(RC.get_config(arch), **over), TC.reduced(TC.get_config(arch), **over)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert (t.hd, t.d_inner, t.ssm_heads) == (r.hd, r.d_inner, r.ssm_heads)
    full_r, full_t = RC.get_config(arch), TC.get_config(arch)
    assert (full_t.n_params(), full_t.active_params()) == (full_r.n_params(), full_r.active_params())


def test_param_count_in_range():
    """Full configs must land near their nominal sizes (sanity of configs)."""
    expect = {
        "internvl2-26b": (17e9, 26e9),  # LM backbone only (InternLM2-20B)
        "qwen2.5-3b": (2.0e9, 3.5e9),
        "mistral-nemo-12b": (10e9, 14e9),
        "minicpm3-4b": (3e9, 5e9),
        "gemma2-27b": (22e9, 30e9),
        "mamba2-130m": (0.1e9, 0.2e9),
        "zamba2-2.7b": (2e9, 3.4e9),
        "arctic-480b": (400e9, 520e9),
        "qwen3-moe-235b-a22b": (200e9, 260e9),
    }
    for name, (lo, hi) in expect.items():
        n = TC.get_config(name).n_params()
        assert lo <= n <= hi, f"{name}: {n/1e9:.1f}B not in [{lo/1e9}, {hi/1e9}]"


def test_sharding_rules_equal_the_reference():
    """``physical`` maps logical axes as the reference does, with and
    without a mesh (one with ``axis_names`` and ``shape`` is enough)."""

    class Mesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 4, "model": 8}

    cases = [
        (("batch", "seq", "embed"), None), (("fsdp", "heads"), (512, 256)),
        (("vocab", "fsdp"), (30, 64)), (("layers", "experts", "fsdp", "expert_mlp"), None),
        (("batch", "cache_seq", "kv_heads", None), (8, 128, 2, 64)), ((None, "heads"), (3, 12)),
    ]
    for mesh in (None, Mesh()):
        r, t = RS.ShardingRules(mesh=mesh), S.ShardingRules(mesh=mesh)
        for logical, shape in cases:
            assert t.physical(logical, shape) == tuple(r.physical(logical, shape))
    x = torch.ones(2, 3)
    assert S.shard(x, "batch", "embed") is x
    # on a DeviceMesh (rank 0 of a fake world of 8) constraint places x:
    # batch over data (pod absent), embed replicated
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch_mesh import fake_world

    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        y = S.ShardingRules(mesh=mesh).constraint(x, "batch", "embed")
        assert isinstance(y, DTensor) and y.placements == (Shard(0), Replicate())
        assert y.to_local().shape == (1, 3) and y.shape == x.shape


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_params_from_numpy_maps_every_leaf(arch):
    """Every leaf of the reference's tree lands under the port's key with
    its shape and bits; a float32 and a bfloat16 (``ml_dtypes``) tree."""
    for param_dtype in ("float32", "bfloat16"):
        rcfg, tcfg = twin_configs(arch, param_dtype=param_dtype)
        pv, rax = RL.split_params(RM.init_params(rcfg, jax.random.key(0)))
        like, axes = L.split_params(M.init_params(tcfg, 0, device="cpu"))
        tree = jax.tree.map(np.asarray, pv)
        carried = params_from_numpy(tree, "cpu", like=like)
        ref_keys = jax_tree_keys(tree)
        assert jax_tree_keys(carried) == jax_tree_keys(like) == ref_keys
        flat_r = dict(zip(ref_keys, jax.tree.leaves(pv)))
        for key, t in zip(jax_tree_keys(carried), L.tree_leaves(carried)):
            r = flat_r[key]
            assert str(t.dtype).split(".")[-1] == str(r.dtype), key
            assert np.array_equal(f32(t), np.asarray(r, np.float32)), key
        assert _axes_equal(axes, rax)


def _axes_equal(port, ref) -> bool:
    if isinstance(port, dict):
        return set(port) == set(ref) and all(_axes_equal(port[k], ref[k]) for k in port)
    return tuple(port) == tuple(ref)


def test_params_from_numpy_refuses_missing_extra_or_reshaped_leaves():
    rcfg, tcfg = twin_configs("qwen2.5-3b", n_layers=1)
    pv, _ = twin_params(rcfg)
    tree = jax.tree.map(np.asarray, pv)
    like = L.split_params(M.init_params(tcfg, 0, device="cpu"))[0]
    del tree["blocks"]["attn"]["bq"]
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match=r"missing \['blocks/attn/bq'\], extra \['extra'\]"):
        params_from_numpy(tree, "cpu", like=like)
    tree = jax.tree.map(np.asarray, pv)
    tree["final_norm"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, "cpu", like=like)


def test_language_model_registers_every_tensor():
    cfg = TC.reduced(TC.get_config("qwen2.5-3b"), n_layers=2)
    params = L.split_params(M.init_params(cfg, 0, device="cpu"))[0]
    lm = M.LanguageModel(cfg, params)
    sd = lm.state_dict()
    assert set(sd) == {"tree." + k.replace("/", ".") for k in jax_tree_keys(params)}
    lm = lm.to(torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in L.tree_leaves(lm.params))
    assert jax_tree_keys(lm.params) == jax_tree_keys(params)
    tok = torch.zeros(1, 4, dtype=torch.long)
    assert lm(dict(tokens=tok)).shape == (1, 4, cfg.vocab)


# ------------------------------------------------------------------ layers
def naive_attention_np(q, k, v, window, cap):
    """``test_models_smoke.py``'s naive causal reference, in numpy."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    kk, vv = np.repeat(k, h // kvh, axis=2), np.repeat(v, h // kvh, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    if cap:
        sc = np.tanh(sc / cap) * cap
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    sc = np.where(mask[None, None], sc, -1e30)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, vv)


@pytest.mark.parametrize("window,cap", [(None, None), (8, None), (None, 20.0), (8, 20.0)])
def test_flash_attention_matches_jax_and_naive(window, cap):
    rng = np.random.default_rng(1)
    b, s, h, kvh, hd = 2, 48, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (h, kvh, kvh))
    out = L.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True, window=window,
                            cap=cap, block=16)
    ref = RL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                             cap=cap, block=16)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)
    # the naive reference: tolerance of test_models_smoke.py:79
    np.testing.assert_allclose(f32(out), naive_attention_np(q, k, v, window, cap),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(causal=False, q_offset=0, kv_len=None),
    dict(causal=True, q_offset=5, kv_len=None),
    dict(causal=False, q_offset=0, kv_len=21),
    dict(causal=True, q_offset=3, kv_len=30, window=7),
])
def test_flash_attention_offsets_and_value_width_match_jax(kw):
    """Offset queries, a masked kv prefix and MLA's value width."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 27, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 33, 1, 16)).astype(np.float32)
    v = rng.normal(size=(2, 33, 1, 24)).astype(np.float32)
    out = L.flash_attention(*map(torch.as_tensor, (q, k, v)), block=8, **kw)
    ref = RL.flash_attention(*map(jnp.asarray, (q, k, v)), block=8, **kw)
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 8, 32)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 20, 2, 32)).astype(np.float32) for _ in range(2))
    for kw in (dict(pos=11), dict(pos=19, window=6), dict(pos=4, cap=5.0)):
        out = L.decode_attention(*map(torch.as_tensor, (q, kc, vc)), **kw)
        ref = RL.decode_attention(*map(jnp.asarray, (q, kc, vc)), **kw)
        np.testing.assert_allclose(f32(out), f32(ref), **TOL)


def test_norm_rope_and_activations_match_jax():
    """Elementwise pieces: float32 within 2 ulp-scale; bfloat16 bit for bit
    (the reference rounds after each step and rounds Python constants to
    the array's dtype; the port does the same)."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 4, 32)) * 3).astype(np.float32)
    scale = rng.normal(size=32).astype(np.float32)
    pos = np.arange(5)[None, :].repeat(3, 0)
    np.testing.assert_allclose(f32(L.rmsnorm(torch.as_tensor(x), torch.as_tensor(scale))),
                               f32(RL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    np.testing.assert_allclose(f32(L.rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)),
                               f32(RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **TOL)
    np.testing.assert_allclose(f32(L.softplus(torch.as_tensor(x))),
                               f32(jax.nn.softplus(jnp.asarray(x))), **TOL)
    xb, jb = torch.as_tensor(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    assert np.array_equal(f32(L.silu(xb)), f32(jax.nn.silu(jb)))
    assert np.array_equal(f32(L.gelu_tanh(xb)), f32(jax.nn.gelu(jb, approximate=True)))
    assert np.array_equal(f32(L.rmsnorm(xb, torch.as_tensor(scale))),
                          f32(RL.rmsnorm(jb, jnp.asarray(scale))))
    s = 1 / math.sqrt(128)
    assert np.array_equal(f32(xb * L.scalar(s, xb)), f32(jb * s))


def ssd_recurrence_np(x, dt, a, bm, cm):
    """``test_models_smoke.py``'s per-step recurrence."""
    b, s, h, p = x.shape
    state = np.zeros((b, h, p, bm.shape[-1]))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a[None])
        state = state * da[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax_and_recurrence(with_state):
    rng = np.random.default_rng(2)
    b, s, h, p, n, chunk = 2, 32, 3, 8, 4, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    init = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_state else None
    args = (x, dt, a, bm, cm)
    y, final = L._ssd_chunked(*map(torch.as_tensor, args), chunk,
                              init_state=None if init is None else torch.as_tensor(init))
    ry, rfinal = RL._ssd_chunked(*map(jnp.asarray, args), chunk,
                                 init_state=None if init is None else jnp.asarray(init))
    np.testing.assert_allclose(f32(y), f32(ry), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(f32(final), f32(rfinal), rtol=1e-5, atol=1e-4)
    if init is None:  # the naive recurrence: tolerance of test_models_smoke.py:107
        ny, nstate = ssd_recurrence_np(*args)
        np.testing.assert_allclose(f32(y), ny, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f32(final), nstate, rtol=1e-4, atol=1e-4)


def _layer_twins(init_ref, rcfg, seed=1):
    p = RL.split_params(init_ref(rcfg, jax.random.key(seed)))[0]
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def test_mamba_forward_and_decode_match_jax():
    rcfg, tcfg = twin_configs("mamba2-130m", dtype="float32")
    rp, tp = _layer_twins(RL.init_mamba, rcfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 21, tcfg.d_model)).astype(np.float32)  # 21: a padded chunk
    y, st = L.mamba_forward(tcfg, tp, torch.as_tensor(x))
    ry, rst = jax.jit(lambda p, x: RL.mamba_forward(rcfg, p, x))(rp, jnp.asarray(x))
    np.testing.assert_allclose(f32(y), f32(ry), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(st), f32(rst), rtol=1e-4, atol=1e-4)
    conv = rng.normal(size=(2, tcfg.conv_width - 1, tcfg.d_inner + 2 * tcfg.ssm_state))
    args = (x[:, 0], f32(st), conv.astype(np.float32))
    out = L.mamba_decode(tcfg, tp, *map(torch.as_tensor, args))
    ref = jax.jit(lambda p, *a: RL.mamba_decode(rcfg, p, *a))(rp, *map(jnp.asarray, args))
    for a, r in zip(out, ref):
        np.testing.assert_allclose(f32(a), f32(r), rtol=1e-4, atol=1e-4)


def test_mla_prefill_and_decode_match_jax():
    rcfg, tcfg = twin_configs("minicpm3-4b", dtype="float32")
    rp, tp = _layer_twins(RL.init_mla, rcfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    pos = np.arange(9)[None, :]
    out, cache = L.mla_attention(tcfg, tp, torch.as_tensor(x), torch.as_tensor(pos))
    rout, rcache = jax.jit(lambda p, x, pos: RL.mla_attention(rcfg, p, x, pos))(
        rp, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(f32(out), f32(rout), **TOL)
    np.testing.assert_allclose(f32(cache), f32(rcache), **TOL)
    full = np.zeros((2, 12, cache.shape[-1]), np.float32)
    full[:, :9] = f32(cache)
    out, new = L.mla_attention(tcfg, tp, torch.as_tensor(x[:, :1]), None,
                               decode_cache=torch.as_tensor(full), pos=9)
    rout, rnew = jax.jit(lambda p, x, c: RL.mla_attention(rcfg, p, x, None, decode_cache=c, pos=9))(
        rp, jnp.asarray(x[:, :1]), jnp.asarray(full))
    np.testing.assert_allclose(f32(out), f32(rout), **TOL)
    np.testing.assert_allclose(f32(new), f32(rnew), **TOL)


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("impl", ["dense_ec", "ragged"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_matches_jax(arch, impl):
    rcfg, tcfg = twin_configs(arch, dtype="float32", moe_impl=impl)
    rp, tp = _layer_twins(RL.init_moe, rcfg)
    x = np.random.default_rng(7).normal(size=(3, 24, tcfg.d_model)).astype(np.float32)
    out = L.moe(tcfg, tp, torch.as_tensor(x))
    ref = RL.moe(rcfg, rp, jnp.asarray(x))
    np.testing.assert_allclose(f32(out), f32(ref), **TOL)


def test_top_k_takes_ties_lowest_index_first():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    v, i = L.top_k(torch.as_tensor(x), 3)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 3)
    assert np.array_equal(i.numpy(), np.asarray(ri)) and np.array_equal(f32(v), f32(rv))


def test_moe_over_capacity_keeps_cap_minus_one_tokens():
    """Reference defect (ROADMAP queue 3): the dense_ec dispatch points
    every over-capacity entry at slot cap-1, so an expert that overflows
    keeps cap-1 tokens, not cap. The port reproduces it. Routing is forced:
    every token picks experts 0 and 1 (top-2 of 8), so both overflow."""
    rcfg, tcfg = twin_configs("qwen3-moe-235b-a22b", dtype="float32")
    rp, tp = _layer_twins(RL.init_moe, rcfg)
    router = np.zeros((tcfg.d_model, tcfg.n_experts), np.float32)
    router[0, 0], router[0, 1] = 5.0, 4.0
    rp = dict(rp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    x = np.random.default_rng(8).normal(size=(1, 20, tcfg.d_model)).astype(np.float32)
    x[..., 0] = 10.0
    cap = max(8, -(-int(math.ceil(20 * 2 / 8 * tcfg.moe_capacity)) // 8) * 8)
    assert cap == 8  # 20 entries per expert against a capacity of 8
    out = f32(L.moe(tcfg, tp, torch.as_tensor(x)))[0]
    ref = f32(RL.moe(rcfg, rp, jnp.asarray(x)))[0]
    np.testing.assert_allclose(out, ref, **TOL)
    served = np.abs(ref).sum(-1) > 0
    assert served.tolist() == [True] * (cap - 1) + [False] * (20 - cap + 1)
