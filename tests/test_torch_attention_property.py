"""Property tests for the port's triangular-flash attention and grouped
MoE: the twins of ``test_attention_property.py``, with its tolerances
(float32: 2e-4 relative, 3e-5 absolute; MoE 2e-3)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402

from repro.models import layers as RL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_lm import f32, twin_configs  # noqa: E402


def naive_attention(q, k, v, causal, window, cap, q_offset, kv_len):
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kk = torch.repeat_interleave(k, h // kvh, dim=2)
    vv = torch.repeat_interleave(v, h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    if cap:
        s = torch.tanh(s / cap) * cap
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = torch.where(torch.as_tensor(mask)[None, None], s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


@settings(max_examples=25, deadline=None)
@given(
    sq=st.integers(1, 40),
    sk=st.integers(1, 70),
    h=st.sampled_from([1, 2, 4]),
    kvh_div=st.sampled_from([1, 2]),
    hd=st.sampled_from([8, 16]),
    hd_v=st.sampled_from([8, 24]),
    causal=st.booleans(),
    window=st.sampled_from([None, 5, 16]),
    cap=st.sampled_from([None, 30.0]),
    offset=st.integers(0, 20),
    block=st.sampled_from([8, 16, 64]),
    seed=st.integers(0, 100),
)
def test_flash_matches_naive(
    sq, sk, h, kvh_div, hd, hd_v, causal, window, cap, offset, block, seed
):
    if kvh_div > h:
        kvh_div = 1
    kvh = h // kvh_div
    # causal self-attention pruning assumes q_offset aligns q & k tails
    if causal and offset + sq > sk:
        offset = max(0, sk - sq)
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(2, sq, h, hd)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(2, sk, kvh, hd)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(2, sk, kvh, hd_v)), dtype=torch.float32)
    out = L.flash_attention(
        q, k, v, causal=causal, window=window, cap=cap, q_offset=offset, block=block,
    )
    ref = naive_attention(q, k, v, causal, window, cap, offset, None)
    # rows with no visible kv position are unspecified — mask them out
    qpos = offset + np.arange(sq)
    visible = np.ones(sq, bool)
    if causal or window:
        lo = qpos - (window or 10**9)
        hi = qpos if causal else np.full(sq, sk - 1)
        visible = (np.minimum(hi, sk - 1) > lo) & (hi >= 0)
    np.testing.assert_allclose(
        f32(out)[:, visible], f32(ref)[:, visible], rtol=2e-4, atol=3e-5,
    )


def test_moe_grouped_matches_ungrouped():
    """With ample capacity, per-row dispatch == one dispatch over all rows
    (the reference vmaps the rows; the port loops over them)."""
    rcfg, cfg = twin_configs("qwen3-moe-235b-a22b", n_layers=1, moe_capacity=4.0)
    rng = np.random.default_rng(0)
    p = RL.split_params(RL.init_moe(rcfg, jax.random.key(1)))[0]
    p = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    x = torch.as_tensor(rng.normal(size=(4, 16, cfg.d_model)), dtype=torch.float32)
    y1 = L.moe(cfg, p, x)
    cfg2 = dataclasses.replace(cfg, moe_local_dispatch=True)
    y2 = torch.cat([L.moe(cfg2, p, xi[None]) for xi in x])
    np.testing.assert_allclose(f32(y1), f32(y2), rtol=2e-3, atol=2e-3)
