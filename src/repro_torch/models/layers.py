"""Model building blocks in plain PyTorch: norms, rope, attention (GQA /
MLA / local+softcap / flash-chunked), gated MLP, MoE, Mamba2 SSD.

The reference's functions, step for step: the same masks, the same
``-1e30`` fill, float32 accumulation where it casts to float32, the same
dtype at every product. No fused attention and no library kernel stand in
for them, so the port's numbers compare like for like.

Params are trees (nested dicts) of ``Param(value, axes)`` where ``axes``
are *logical* sharding axes (see :mod:`repro_torch.models.sharding`);
``split_params`` separates the values from the annotation tree so both
always share one structure. Random draws come from a ``torch.Generator``
(the reference's threefry streams are not reproduced: tests feed the
reference's values in through :mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import get_rules, shard, shard_index

NEG = -1e30  # masked score


@dataclasses.dataclass(frozen=True)
class Param:
    """A parameter leaf: tensor value + static logical sharding axes."""

    value: torch.Tensor
    axes: tuple


def is_param(x):
    return isinstance(x, Param)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def split_params(tree):
    vals = tree_map(lambda p: p.value, tree)
    axes = tree_map(lambda p: p.axes, tree)
    return vals, axes


def mk(gen: torch.Generator, shape, axes, scale=None, dtype=torch.float32):
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    v = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return Param(v.mul_(scale), axes)


def ones(gen: torch.Generator, shape, axes):
    return Param(torch.ones(shape, dtype=torch.float32, device=gen.device), axes)


def zeros(gen: torch.Generator, shape, axes):
    return Param(torch.zeros(shape, dtype=torch.float32, device=gen.device), axes)


def scalar(c: float, x: torch.Tensor) -> float:
    """A Python float as the reference applies it to ``x``: a weak-typed
    scalar, rounded to ``x``'s dtype first (torch would otherwise multiply
    a bfloat16 tensor by the unrounded value)."""
    return torch.tensor(c, dtype=x.dtype).item()


def silu(x):
    """``jax.nn.silu``: x * 1 / (1 + exp(-x)), rounded after each step."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)``, its constants in ``x``'s dtype."""
    k = scalar(math.sqrt(2 / math.pi), x)
    return x * (0.5 * (1.0 + torch.tanh(k * (x + scalar(0.044715, x) * (x * x * x)))))


def softplus(x):
    """``jax.nn.softplus`` = logaddexp(x, 0)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def reshape(x, *shape):
    """``x.reshape(shape)``. On a mesh, DTensor refuses a view that splits
    a sharded dim unevenly (GSPMD would re-shard instead): such a DTensor
    is first replicated on its sharded dims past the leading dims that the
    view keeps. A plain tensor is only reshaped."""
    if not hasattr(x, "placements"):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate

        keep = 0
        while keep < min(x.ndim, len(shape)) and x.shape[keep] == shape[keep]:
            keep += 1
        pl = [Replicate() if p.is_shard() and p.dim >= keep else p for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(*shape)


def cdtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


# ---------------------------------------------------------------- norms/rope
def rmsnorm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x, positions, theta: float):
    """Rotate-half RoPE. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half)
    )
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ------------------------------------------------------------ flash attention

def flash_attention(
    q, k, v, *, causal=True, window=None, cap=None, q_offset=0, kv_len=None,
    block=512, pin_kv=True,
):
    """Blocked online-softmax attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KVH, hd_k/hd_v). GQA via head-group
    reshape; the value width may differ from the qk width (MLA). Never
    materializes (Sq, Sk).

    A loop over a STATIC list of (q-block, kv-block) pairs; for
    self-attention with ``causal=True`` the above-diagonal pairs are
    pruned. ``q_offset`` is the absolute position of q[0]; ``kv_len``
    masks the valid prefix of k/v.

    ``pin_kv`` (on a mesh) places K/V by batch only, replicated over the
    model axis, as the reference does: GQA kv heads are few, and a
    sub-sharded kvh would be re-gathered at every pair. Training turns it
    off (its backward re-gathers the cotangents). Without a mesh it
    changes nothing.

    On a mesh (DTensor inputs, :func:`_flash_on_mesh`) every (batch, head)
    is independent: K/V are expanded to the H query heads and placed as q
    is, and this function runs on each device's local batch and heads.
    """
    if hasattr(q, "placements"):
        return _flash_on_mesh(
            q, k, v, causal=causal, window=window, cap=cap, q_offset=q_offset,
            kv_len=kv_len, block=block, pin_kv=pin_kv,
        )
    orig_dtype = q.dtype
    b, sq, h, hd = q.shape
    hd_v = v.shape[-1]
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // max(1, kvh)
    scale = 1.0 / math.sqrt(hd)
    blk_q = min(block, max(64, sq))
    nq = (sq + blk_q - 1) // blk_q
    padq = nq * blk_q - sq
    nk = (sk + block - 1) // block
    padk = nk * block - sk
    q = (q * scalar(scale, q)).float()
    qg = F.pad(q, (0, 0, 0, 0, 0, padq)).reshape(b, nq, blk_q, kvh, groups, hd)
    kp = F.pad(k, (0, 0, 0, 0, 0, padk)).float().reshape(b, nk, block, kvh, hd)
    vp = F.pad(v, (0, 0, 0, 0, 0, padk)).float().reshape(b, nk, block, kvh, hd_v)
    kv_valid = sk if kv_len is None else kv_len

    # static pair list: prune above-diagonal blocks for causal self-attn
    prune = causal and kv_len is None and isinstance(q_offset, int)
    pairs = [
        (qi, kj)
        for qi in range(nq)
        for kj in range(nk)
        if not prune or kj * block <= q_offset + (qi + 1) * blk_q - 1
    ]
    # the online-softmax state of each q block, replaced (not written in
    # place) at every pair so that autograd can differentiate the loop
    state = (b, blk_q, kvh, groups)
    m = [torch.full(state, NEG, dtype=torch.float32, device=q.device) for _ in range(nq)]
    l = [torch.zeros(state, dtype=torch.float32, device=q.device) for _ in range(nq)]
    acc = [torch.zeros(state + (hd_v,), dtype=torch.float32, device=q.device) for _ in range(nq)]
    ar_q, ar_k = _arange(blk_q, q), _arange(block, q)
    for qi, kj in pairs:
        qb, kb, vb = qg[:, qi], kp[:, kj], vp[:, kj]
        qpos = q_offset + qi * blk_q + ar_q
        kpos = kj * block + ar_k
        s = torch.einsum("bqkgd,bjkd->bqkgj", qb, kb)  # (B,bq,KVH,G,block)
        s = softcap(s, cap)
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
        else:
            mask = torch.ones((blk_q, block), dtype=torch.bool, device=q.device)
        mask = mask & (kpos < kv_valid)[None, :]
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG)
        m_old, l_old, a_old = m[qi], l[qi], acc[qi]
        m_new = torch.maximum(m_old, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l[qi] = l_old * corr + torch.sum(p, dim=-1)
        acc[qi] = a_old * corr[..., None] + torch.einsum("bqkgj,bjkd->bqkgd", p, vb)
        m[qi] = m_new
    out = torch.stack(acc, 1) / torch.clamp(torch.stack(l, 1)[..., None], min=1e-30)
    out = out.reshape(b, nq * blk_q, h, hd_v)[:, :sq]
    return out.to(orig_dtype)


def _flash_on_mesh(q, k, v, *, pin_kv, **kw):
    """:func:`flash_attention` of DTensors, shard-map style: K/V pinned by
    batch (``pin_kv``), expanded from KVH to the H query heads, then q, K
    and V placed by (batch, seq, heads) and the plain function run on each
    device's local tensors (``local_map``). DTensor would otherwise have
    to split a model-sharded head dim into (KVH, groups) and flatten the
    sharded batch and head dims into one matmul batch, which it cannot do
    without gathering."""
    from torch.distributed.tensor.experimental import local_map

    b, sk, kvh, _ = k.shape
    h = q.shape[2]
    if pin_kv:
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
    if h != kvh:
        k, v = (t[:, :, :, None].expand(b, sk, kvh, h // kvh, t.shape[-1])
                .reshape(b, sk, h, t.shape[-1]) for t in (k, v))
    rules = get_rules()
    pl = [rules.placements(("batch", "seq", "heads", None), t.shape) for t in (q, k, v)]
    return local_map(
        lambda ql, kl, vl: flash_attention(ql, kl, vl, pin_kv=False, **kw),
        out_placements=pl[0], in_placements=tuple(pl), in_grad_placements=tuple(pl),
        device_mesh=q.device_mesh, redistribute_inputs=True,
    )(q, k, v)


def decode_attention(q, k_cache, v_cache, *, pos, window=None, cap=None):
    """Single-token attention over a KV cache.

    q: (B, H, hd); caches: (B, S, KVH, hd); attends to positions <= pos.
    Plain einsum + masked softmax.
    """
    b, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    groups = h // max(1, kvh)
    qg = reshape(q * scalar(1.0 / math.sqrt(hd), q), b, kvh, groups, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    scores = softcap(scores, cap)
    kpos = _arange(s, q)
    mask = kpos <= pos
    if window is not None:
        mask = mask & (kpos > pos - window)
    scores = torch.where(mask[None, None, None, :], scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return reshape(out, b, h, hd).to(q.dtype)


# ------------------------------------------------------------------ attention
def init_attention(cfg: ModelConfig, gen):
    hd = cfg.hd
    p = dict(
        wq=mk(gen, (cfg.d_model, cfg.n_heads * hd), ("fsdp", "heads")),
        wk=mk(gen, (cfg.d_model, cfg.n_kv_heads * hd), ("fsdp", "heads")),
        wv=mk(gen, (cfg.d_model, cfg.n_kv_heads * hd), ("fsdp", "heads")),
        wo=mk(gen, (cfg.n_heads * hd, cfg.d_model), ("heads", "fsdp")),
    )
    if cfg.qkv_bias:
        p["bq"] = zeros(gen, (cfg.n_heads * hd,), ("heads",))
        p["bk"] = zeros(gen, (cfg.n_kv_heads * hd,), ("heads",))
        p["bv"] = zeros(gen, (cfg.n_kv_heads * hd,), ("heads",))
    return p


def attention(
    cfg: ModelConfig, p, x, positions, *, causal=True, window=None,
    kv_override=None, pin_kv=True,
):
    """Full-sequence attention (train / prefill). x: (B, S, D)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = (kv_override[0] if kv_override is not None else x) @ p["wk"].to(x.dtype)
    v = (kv_override[1] if kv_override is not None else x) @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = reshape(q, b, s, cfg.n_heads, hd)
    sk = k.shape[1]
    k = reshape(k, b, sk, cfg.n_kv_heads, hd)
    v = reshape(v, b, sk, cfg.n_kv_heads, hd)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    if causal or kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        kpos = positions if kv_override is None else _arange(sk, x)[None, :]
        k = rope(k, kpos, cfg.rope_theta)
    out = flash_attention(
        q, k, v, causal=causal, window=window, cap=cfg.attn_softcap, pin_kv=pin_kv
    )
    out = reshape(out, b, s, cfg.n_heads * hd)
    out = out @ p["wo"].to(x.dtype)
    return shard(out, "batch", "seq", "embed")


def attention_decode(cfg: ModelConfig, p, x, k_cache, v_cache, pos, *, window=None):
    """One-token decode. x: (B, D); caches (B, S, KVH, hd) written at ``pos``
    in place (the reference returns updated copies)."""
    b, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = reshape(q, b, 1, cfg.n_heads, hd)
    k = reshape(k, b, 1, cfg.n_kv_heads, hd)
    v = reshape(v, b, 1, cfg.n_kv_heads, hd)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)[:, 0]
    k = rope(k, posv, cfg.rope_theta)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    k_cache = shard(k_cache, "batch", "cache_seq", "kv_heads", None)
    v_cache = shard(v_cache, "batch", "cache_seq", "kv_heads", None)
    out = decode_attention(
        q, k_cache, v_cache, pos=pos, window=window, cap=cfg.attn_softcap
    )
    out = out.reshape(b, cfg.n_heads * hd) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache


# ------------------------------------------------------------------ MLA
def init_mla(cfg: ModelConfig, gen):
    h = cfg.n_heads
    return dict(
        wq_a=mk(gen, (cfg.d_model, cfg.q_lora), ("fsdp", None)),
        q_norm=zeros(gen, (cfg.q_lora,), (None,)),
        wq_b=mk(gen, (cfg.q_lora, h * (cfg.qk_nope + cfg.qk_rope)), (None, "heads")),
        wkv_a=mk(gen, (cfg.d_model, cfg.kv_lora + cfg.qk_rope), ("fsdp", None)),
        kv_norm=zeros(gen, (cfg.kv_lora,), (None,)),
        wkv_b=mk(gen, (cfg.kv_lora, h * (cfg.qk_nope + cfg.v_head)), (None, "heads")),
        wo=mk(gen, (h * cfg.v_head, cfg.d_model), ("heads", "fsdp")),
    )


def mla_attention(
    cfg: ModelConfig, p, x, positions, *, decode_cache=None, pos=None, pin_kv=True
):
    """Multi-head latent attention (prefill path expands the latent).

    Cache stores the compressed (kv_lora + qk_rope) latent per position;
    decode writes it at ``pos`` in place and uses absorbed projections.
    """
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head
    q = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = q @ p["wq_b"].to(x.dtype)
    kv = x @ p["wkv_a"].to(x.dtype)  # (B, S, kv_lora + dr)
    latent = rmsnorm(kv[..., : cfg.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora :]
    if decode_cache is None:  # train / prefill: expand latent to full kv
        s = x.shape[1]
        q = q.reshape(b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        k_rope_h = rope(k_rope.reshape(b, s, 1, dr), positions, cfg.rope_theta)
        kvx = (latent @ p["wkv_b"].to(x.dtype)).reshape(b, s, h, dn + dv)
        k_nope, v = kvx[..., :dn], kvx[..., dn:]
        k = torch.cat([k_nope, k_rope_h.expand(b, s, h, dr)], -1)
        qf = torch.cat([q_nope, q_rope], -1)
        out = flash_attention(qf, k, v, causal=True, pin_kv=pin_kv)
        out = out.reshape(b, s, h * dv) @ p["wo"].to(x.dtype)
        new_cache = torch.cat([latent, k_rope], -1)  # (B,S,kv_lora+dr)
        return shard(out, "batch", "seq", "embed"), new_cache
    # ---- decode with absorbed projections (cache = latent ++ k_rope) ----
    cache = decode_cache
    new = torch.cat([latent, k_rope], -1)  # (B, 1, kv_lora+dr)
    cache[:, pos] = new[:, 0].to(cache.dtype)
    lat_c = cache[..., : cfg.kv_lora]
    kr_c = cache[..., cfg.kv_lora :]
    q = q.reshape(b, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = rope(q_rope[:, None], posv, cfg.rope_theta)[:, 0]  # (B,h,dr)
    wkv_b = p["wkv_b"].to(x.dtype).reshape(cfg.kv_lora, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope, w_uk)  # absorb k up-proj
    s_len = cache.shape[1]
    kpos = _arange(s_len, x)
    # rope the cached k_rope at its own positions
    kr = rope(kr_c.reshape(b, s_len, 1, dr), kpos[None, :], cfg.rope_theta)[:, :, 0]
    scores = torch.einsum("bhl,bsl->bhs", q_lat.float(), lat_c.float())
    scores = scores + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr.float())
    scores = scores / math.sqrt(dn + dr)
    scores = torch.where((kpos <= pos)[None, None, :], scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhs,bsl->bhl", w, lat_c.float())
    out = torch.einsum("bhl,lhd->bhd", out_lat.to(x.dtype), w_uv)  # absorb v
    out = out.reshape(b, h * dv) @ p["wo"].to(x.dtype)
    return out, cache


# ------------------------------------------------------------------ MLP / MoE
def _act(cfg: ModelConfig):
    return silu if cfg.gated_act == "silu" else gelu_tanh


def init_mlp(cfg: ModelConfig, gen, d_ff=None):
    d_ff = d_ff or cfg.d_ff
    return dict(
        w_gate=mk(gen, (cfg.d_model, d_ff), ("fsdp", "mlp")),
        w_up=mk(gen, (cfg.d_model, d_ff), ("fsdp", "mlp")),
        w_down=mk(gen, (d_ff, cfg.d_model), ("mlp", "fsdp")),
    )


def mlp(cfg: ModelConfig, p, x):
    g = _act(cfg)(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    names = ("batch", "seq", "mlp") if x.ndim == 3 else ("batch", "mlp")
    h = shard(g * u, *names)
    # on a mesh the down projection is a partial sum over the mlp's shards:
    # reduced here, as attention's output is, so that the residual stream
    # stays placed by batch (DTensor would otherwise carry the partial on)
    return shard(h @ p["w_down"].to(x.dtype), *names[:-1], "embed")


def init_moe(cfg: ModelConfig, gen):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return dict(
        router=mk(gen, (d, e), (None, None), scale=0.02),
        w_gate=mk(gen, (e, d, f), ("experts", "fsdp", "expert_mlp")),
        w_up=mk(gen, (e, d, f), ("experts", "fsdp", "expert_mlp")),
        w_down=mk(gen, (e, f, d), ("experts", "expert_mlp", "fsdp")),
    )


def top_k(x, k: int):
    """``lax.top_k``: the k largest along the last axis, ties taken lowest
    index first."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def moe(cfg: ModelConfig, p, x):
    """Mixture of experts over tokens. x: (B, S, D) → (B, S, D).

    dense_ec: capacity-based gather/batched-matmul/scatter.
    ragged: sort + one matmul per expert's contiguous rows (no capacity).

    Without a mesh (or on a mesh of one device) all tokens are one group
    and every expert is local. On a mesh the tokens and expert weights
    are DTensors and the work runs shard-map style on local tensors
    (``local_map``), as the reference's vmap runs under GSPMD:

      - dense_ec with ``moe_local_dispatch``: the tokens split into
        ``groups = pod x data`` groups of the current mesh (when they
        divide the token count), each group with its own capacity, sort
        and scatter (the reference's Switch-style local dispatch); each
        device takes its own groups;
      - otherwise one group, its tokens replicated on every device;
      - experts stay split as the rules place them (``experts`` →
        ``model``): a device computes its experts' share of its tokens'
        outputs, and the output is a partial sum over those mesh dims.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    weights = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
    rules = get_rules()
    mesh = rules.mesh
    if mesh is None or mesh.size() == 1:
        out = _moe_group(cfg, *weights, xf, 0)
        if cfg.moe_impl == "ragged":
            return out.reshape(b, s, d).to(x.dtype)
        return shard(out.reshape(b, s, d), "batch", "seq", "embed").to(x.dtype)

    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    groups = 1
    if cfg.moe_impl == "dense_ec" and cfg.moe_local_dispatch:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        groups = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
        if t % groups:
            groups = 1
    tg = t // groups
    wpl = rules.placements(("experts", None, None), p["w_gate"].shape)
    rep = [Replicate()] * mesh.ndim
    if groups > 1:
        xg = shard(xf.reshape(groups, tg, d), "batch", None, None)
        tpl = rules.placements(("batch", None, None), (groups, tg, d))
    else:
        xg, tpl = xf.reshape(1, t, d), rep
    ep = [i for i, pl in enumerate(wpl) if pl.is_shard()]  # expert-split mesh dims
    opl = [Partial() if i in ep else pl for i, pl in enumerate(tpl)]
    # a device's grads come from its own tokens and its own experts:
    # partial sums over the mesh dims that split either
    xgrad = [Partial() if i in ep else pl for i, pl in enumerate(tpl)]
    rgrad = [Partial() if pl.is_shard() or i in ep else Replicate()
             for i, pl in enumerate(tpl)]
    wgrad = [Partial() if t.is_shard() else w for t, w in zip(tpl, wpl)]

    def local(xg_l, router, wg, wu, wd):
        e0 = shard_index(mesh, ep) * wg.shape[0]
        return torch.stack([_moe_group(cfg, router, wg, wu, wd, xt, e0) for xt in xg_l])

    out = local_map(
        local, out_placements=opl,
        in_placements=(tpl, rep, wpl, wpl, wpl),
        in_grad_placements=(xgrad, rgrad, wgrad, wgrad, wgrad),
        device_mesh=mesh, redistribute_inputs=True,
    )(xg, *weights)
    out = shard(out, "batch", None, None) if groups > 1 else out
    return out.reshape(b, s, d).to(x.dtype)


def _moe_group(cfg: ModelConfig, router, w_gate, w_up, w_down, xf, e0: int):
    """One token group xf (T, D) → (T, D) in the experts' product dtype.

    The expert weights hold experts ``e0 .. e0 + len(w_gate)`` of the
    ``cfg.n_experts``: routing and capacity see every expert; only the
    held ones are computed, so with all experts held (``e0`` 0, the path
    without a mesh) this is the whole output, else that share of it."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    el = w_gate.shape[0]
    logits = (xf @ router.float().to(xf.dtype)).float()
    gate_w, choice = top_k(logits, k)  # (T, k)
    gate_w = torch.softmax(gate_w, dim=-1)
    act = _act(cfg)

    if cfg.moe_impl == "ragged":
        flat_e = choice.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        tok = (_arange(t * k, xf) // k)[order]
        xs = xf[tok]  # (T*k, D)
        counts = torch.bincount(flat_e, minlength=e).tolist()
        ys, rows, lo = [], [], 0
        for i, c in enumerate(counts):  # the reference's ragged_dot groups
            if c and e0 <= i < e0 + el:
                xi = xs[lo : lo + c]
                g = act(xi @ w_gate[i - e0].to(xf.dtype))
                u = xi @ w_up[i - e0].to(xf.dtype)
                ys.append((g * u) @ w_down[i - e0].to(xf.dtype))
                rows.append(_arange(c, xf) + lo)
            lo += c
        out = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
        if not ys:
            return out
        y = torch.cat(ys)
        sel = torch.cat(rows) if el < e else slice(None)
        wflat = gate_w.reshape(-1)[order][sel].to(y.dtype)
        out.index_add_(0, tok[sel], y * wflat[:, None])
        return out

    # dense_ec: fixed expert capacity
    cap = int(math.ceil(t * k / e * cfg.moe_capacity))
    cap = max(8, -(-cap // 8) * 8)
    flat_e = choice.reshape(-1)  # (T*k,)
    flat_t = _arange(t * k, xf) // k
    order = torch.argsort(flat_e, stable=True)
    se, st_ = flat_e[order], flat_t[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    slot = _arange(t * k, xf) - starts[se]  # position within expert
    ok = slot < cap
    se_ok, slot_ok = se[ok], slot[ok]
    gather_idx = torch.zeros((e, cap), dtype=torch.long, device=xf.device)
    gather_idx[se_ok, slot_ok] = st_[ok]
    filled = torch.zeros((e, cap), dtype=torch.bool, device=xf.device)
    filled[se_ok, slot_ok] = True
    wslot = torch.zeros((e, cap), dtype=torch.float32, device=xf.device)
    wslot[se_ok, slot_ok] = gate_w.reshape(-1)[order][ok]
    # The reference points every over-capacity entry at slot cap-1 and
    # scatters (index 0, not filled, weight 0) there; on the CPU the last
    # write wins, so an expert that overflows loses slot cap-1.
    over = counts > cap
    gather_idx[over, cap - 1] = 0
    filled[over, cap - 1] = False
    wslot[over, cap - 1] = 0.0
    gather_idx, filled, wslot = (a[e0 : e0 + el] for a in (gather_idx, filled, wslot))
    xe = xf[gather_idx] * filled[..., None].to(xf.dtype)  # (E,C,D)
    g_ = act(torch.einsum("ecd,edf->ecf", xe, w_gate.to(xf.dtype)))
    u_ = torch.einsum("ecd,edf->ecf", xe, w_up.to(xf.dtype))
    y = torch.einsum("ecf,efd->ecd", g_ * u_, w_down.to(xf.dtype))
    out = torch.zeros((t, d), dtype=y.dtype, device=xf.device)
    out.index_add_(
        0, gather_idx.reshape(-1), (y * wslot[..., None].to(y.dtype)).reshape(el * cap, d)
    )
    return out


# ------------------------------------------------------------------ Mamba2 SSD
def init_mamba(cfg: ModelConfig, gen):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return dict(
        in_proj=mk(gen, (d, 2 * di + 2 * n + h), ("fsdp", "mlp")),
        conv_w=mk(gen, (cfg.conv_width, conv_ch), (None, "mlp"), scale=0.5),
        a_log=zeros(gen, (h,), (None,)),
        dt_bias=zeros(gen, (h,), (None,)),
        d_skip=ones(gen, (h,), (None,)),
        out_norm=zeros(gen, (di,), (None,)),
        out_proj=mk(gen, (di, d), ("mlp", "fsdp")),
    )


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk, init_state=None):
    """SSD (Mamba-2) chunked scan.

    xh: (B,S,H,P) inputs; dt: (B,S,H) >0; a: (H,) (A = -exp(a_log));
    bmat/cmat: (B,S,N). Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    b, s, h, p_ = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    q = chunk
    da = dt * a[None, None, :]  # (B,S,H) negative
    xw = xh * dt[..., None]
    das = da.reshape(b, nc, q, h)
    xws = xw.reshape(b, nc, q, h, p_)
    bs = bmat.reshape(b, nc, q, n)
    cs = cmat.reshape(b, nc, q, n)
    cum = torch.cumsum(das, dim=2)  # (B,NC,Q,H)
    # intra-chunk (diagonal blocks): decay between positions i>=j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,NC,Q,Q,H) i,j
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    l = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", cs, bs)  # (B,NC,Q,Q)
    y_d = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, l, xws)
    # chunk states: contribution of each chunk to its end state
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,NC,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bs, decay_end, xws)
    # inter-chunk recurrence over chunk boundary states
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,NC,H)
    prev = (
        torch.zeros((b, h, p_, n), dtype=torch.float32, device=xh.device)
        if init_state is None
        else init_state.float()
    )
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = states[:, c] + prev * chunk_decay[:, c][..., None, None]
    final = prev
    prevs = torch.stack(prevs, dim=1)  # (B,NC,H,P,N) state entering chunk
    decay_in = torch.exp(cum)  # (B,NC,Q,H) decay from chunk start to i
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cs, decay_in, prevs)
    y = (y_d + y_off).reshape(b, s, h, p_)
    return y, final


def _split_proj(cfg: ModelConfig, proj):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di, n, n, h], dim=-1)


def mamba_forward(cfg: ModelConfig, p, x, *, state=None):
    """Mamba2 block over a full sequence. x: (B,S,D)."""
    b, s, d = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"].to(x.dtype)  # (B,S,2di+2n+h)
    z, xr, bmat, cmat, dt = _split_proj(cfg, proj)
    # depthwise causal conv over (x, B, C)
    xbc = torch.cat([xr, bmat, cmat], -1)  # (B,S,di+2n)
    w = p["conv_w"].to(x.dtype)  # (W, di+2n)
    pad = cfg.conv_width - 1
    xbc_p = F.pad(xbc, (0, 0, pad, 0))
    conv = sum(
        xbc_p[:, i : i + s, :] * w[i][None, None, :]
        for i in range(cfg.conv_width)
    )
    conv = silu(conv)
    xr, bmat, cmat = torch.split(conv, [di, n, n], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,)
    xh = xr.reshape(b, s, h, pd).float()
    # pad S to a chunk multiple; dt=0 on padding keeps the state exact
    padn = (-s) % cfg.ssm_chunk

    def pad2(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, padn)) if padn else t

    y, final = _ssd_chunked(
        pad2(xh), pad2(dt), a, pad2(bmat.float()), pad2(cmat.float()),
        cfg.ssm_chunk, init_state=state,
    )
    y = y[:, :s]
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm(y * silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), final


def mamba_decode(cfg: ModelConfig, p, x, state, conv_state):
    """Single-token Mamba2 step. x: (B,D); state (B,H,P,N); conv (B,W-1,CH)."""
    b, d = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"].to(x.dtype)
    z, xr, bmat, cmat, dt = _split_proj(cfg, proj)
    xbc = torch.cat([xr, bmat, cmat], -1)  # (B, CH)
    w = p["conv_w"].to(x.dtype)
    hist = torch.cat([conv_state, xbc[:, None, :]], 1)  # (B,W,CH)
    conv = silu(torch.einsum("bwc,wc->bc", hist, w))
    new_conv_state = hist[:, 1:]
    xr, bmat, cmat = torch.split(conv, [di, n, n], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a[None, :])  # (B,H)
    xh = xr.reshape(b, h, pd).float()
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], bmat.float())
    state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cmat.float())
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rmsnorm(y * silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), state, new_conv_state
