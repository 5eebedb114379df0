"""Model assembly per architecture family: init / loss / forward / prefill /
decode.

All families stack their repeated block over a leading 'layers' axis, as
the reference does; where it scans the stack with ``lax.scan`` the port
loops over the leading axis in Python. Params are ``Param(value,
logical_axes)`` trees at init; the entry points consume the raw value
tree (see ``split_params``). :class:`LanguageModel` wraps a value tree in
an ``nn.Module`` so ``.to()`` and ``state_dict()`` work; the functions
stay the API.

Training differentiates ``loss_fn`` with ``torch.autograd`` over the
value tree's leaves (:mod:`repro_torch.train.train_step`), which then
updates those same tensors in place. ``remat=True`` runs each block
under ``torch.utils.checkpoint`` (non-reentrant) when autograd records:
the block keeps only its input and recomputes everything else in the
backward pass. The reference's ``jax.checkpoint`` policy
``dots_with_no_batch_dims_saveable`` also keeps the weight products
without a batch dimension; that changes what is stored, not a value.

Decode caches are updated in place: ``decode_step`` writes the new
position into the cache's tensors and returns a dict of the same tensors
(the reference returns updated copies).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.sharding import gather_fsdp, on_mesh, shard, shard_index


# ------------------------------------------------------------------ init
def _stack_layers(inits):
    """Stack per-layer Param trees along a new leading 'layers' axis."""
    first = inits[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in inits]) for k in first}
    return L.Param(torch.stack([p.value for p in inits]), ("layers",) + first.axes)


def _init_block(cfg: ModelConfig, gen):
    p = dict(ln_attn=L.zeros(gen, (cfg.d_model,), (None,)))
    if cfg.family == "mla":
        p["attn"] = L.init_mla(cfg, gen)
    elif cfg.family != "ssm":
        p["attn"] = L.init_attention(cfg, gen)
    p["ln_mlp"] = L.zeros(gen, (cfg.d_model,), (None,))
    if cfg.family == "moe":
        p["moe"] = L.init_moe(cfg, gen)
        if cfg.dense_ff_parallel and cfg.d_ff:
            p["mlp"] = L.init_mlp(cfg, gen)
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(cfg, gen)
    if cfg.post_norms:
        p["ln_attn_post"] = L.zeros(gen, (cfg.d_model,), (None,))
        p["ln_mlp_post"] = L.zeros(gen, (cfg.d_model,), (None,))
    return p


def _init_mamba_block(cfg: ModelConfig, gen):
    return dict(
        ln=L.zeros(gen, (cfg.d_model,), (None,)),
        mamba=L.init_mamba(cfg, gen),
    )


def _generator(gen, device: torch.device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, params asked on {device}")
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def init_params(cfg: ModelConfig, gen, device="cuda"):
    """Random params (a ``Param`` tree) drawn from ``gen`` — a
    ``torch.Generator`` on ``device``, or an int seed for one."""
    gen = _generator(gen, resolve(device))
    params = dict(
        embed=L.mk(gen, (cfg.vocab, cfg.d_model), ("vocab", "fsdp"), scale=0.02),
        final_norm=L.zeros(gen, (cfg.d_model,), (None,)),
    )
    if not cfg.tie_embeddings:
        params["unembed"] = L.mk(
            gen, (cfg.d_model, cfg.vocab), ("fsdp", "vocab"), scale=0.02
        )
    if cfg.family in ("dense", "mla", "moe"):
        params["blocks"] = _stack_layers(
            [_init_block(cfg, gen) for _ in range(cfg.n_layers)]
        )
    elif cfg.family in ("ssm", "hybrid"):
        params["blocks"] = _stack_layers(
            [_init_mamba_block(cfg, gen) for _ in range(cfg.n_layers)]
        )
        if cfg.family == "hybrid":
            params["shared_attn"] = _init_block(cfg, gen)
    elif cfg.family == "encdec":
        params["enc_blocks"] = _stack_layers(
            [_init_block(cfg, gen) for _ in range(cfg.enc_layers)]
        )
        dec = []
        for _ in range(cfg.dec_layers):
            blk = _init_block(cfg, gen)
            blk["cross"] = L.init_attention(cfg, gen)
            blk["ln_cross"] = L.zeros(gen, (cfg.d_model,), (None,))
            dec.append(blk)
        params["dec_blocks"] = _stack_layers(dec)
        params["enc_norm"] = L.zeros(gen, (cfg.d_model,), (None,))
    else:
        raise ValueError(cfg.family)
    if cfg.param_dtype == "bfloat16":
        # store weight matrices in bf16; 1-D params (norm scales, biases,
        # a_log) stay f32 for stability
        params = L.tree_map(
            lambda p: (
                L.Param(p.value.to(torch.bfloat16), p.axes)
                if p.value.dtype == torch.float32 and p.value.ndim >= 2
                else p
            ),
            params,
        )
    return params


def _n_layers(blocks) -> int:
    return L.tree_leaves(blocks)[0].shape[0]


def _layers(blocks) -> list:
    """Every layer of a stacked tree (views), from one ``unbind`` a leaf:
    autograd then stacks the layers' grads into the leaf's grad once,
    where a view taken by indexing would add a zero-filled grad of the
    whole stack for every layer."""
    split = L.tree_map(lambda a: a.unbind(0), blocks)
    return [L.tree_map(lambda t: t[i], split) for i in range(_n_layers(blocks))]


def _gathered(tree):
    """A layer's params as its ops use them (:func:`gather_fsdp` on each
    leaf: the identity without a mesh)."""
    return L.tree_map(gather_fsdp, tree)


# ------------------------------------------------------------------ blocks
def _dense_block(cfg: ModelConfig, p, x, positions, layer_idx: int, enc_out=None,
                 train=False):
    """One transformer block (train/prefill). Handles gemma2 alternation:
    even layers local, odd layers global. ``train`` (the caller's
    ``remat``, as in the reference) turns off flash attention's K/V pin."""
    window = None
    if cfg.window is not None:
        window = cfg.window if layer_idx % 2 == 0 else 1 << 30
    h = L.rmsnorm(x, p["ln_attn"], cfg.norm_eps)
    if cfg.family == "mla":
        a, _ = L.mla_attention(cfg, p["attn"], h, positions, pin_kv=not train)
    else:
        a = L.attention(
            cfg, p["attn"], h, positions, causal=True, window=window, pin_kv=not train
        )
    if cfg.post_norms:
        a = L.rmsnorm(a, p["ln_attn_post"], cfg.norm_eps)
    x = x + a
    if "cross" in p and enc_out is not None:
        h = L.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        c = L.attention(
            cfg, p["cross"], h, positions, causal=False,
            kv_override=(enc_out, enc_out),
        )
        x = x + c
    h = L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps)
    if cfg.family == "moe":
        m = L.moe(cfg, p["moe"], h)
        if cfg.dense_ff_parallel and "mlp" in p:
            m = m + L.mlp(cfg, p["mlp"], h)
    else:
        m = L.mlp(cfg, p["mlp"], h)
    if cfg.post_norms:
        m = L.rmsnorm(m, p["ln_mlp_post"], cfg.norm_eps)
    return x + m


# ------------------------------------------------------------------ forward
def _lookup(table, ids):
    """Rows ``ids`` of the embedding table. A plain table is indexed. A
    DTensor table is looked up shard-map style (``local_map``), as a
    vocab-parallel embedding: each device reads the ids that fall in its
    rows of the table and zeros the rest, and the result is a partial sum
    over the mesh dims that split the vocab (reduced by the caller's
    ``shard``). DTensor's own rules for indexing a sharded table, and for
    its backward, differ between torch releases; these are plain local
    ops."""
    if not hasattr(table, "placements"):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab = [i for i, pl in enumerate(table.placements) if pl.is_shard(0)]
    tpl = [pl if i in vocab else Replicate() for i, pl in enumerate(table.placements)]
    ids_pl = ids.placements if hasattr(ids, "placements") else [Replicate()] * mesh.ndim
    ipl = [Replicate() if i in vocab else pl for i, pl in enumerate(ids_pl)]
    opl = [Partial() if i in vocab else pl for i, pl in enumerate(ipl)]
    # each device's table grad comes from its own ids: a partial sum over
    # the mesh dims that split the ids
    gpl = [Partial() if pl.is_shard() else t for pl, t in zip(ipl, tpl)]

    def local(tab, idx):
        rel = idx.long() - shard_index(mesh, vocab) * tab.shape[0]
        hit = (rel >= 0) & (rel < tab.shape[0])
        return tab[rel.clamp(0, tab.shape[0] - 1)] * hit[..., None].to(tab.dtype)

    return local_map(local, out_placements=opl, in_placements=(tpl, ipl),
                     in_grad_placements=(gpl, ipl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def _embed_tokens(cfg, params, tokens):
    x = _lookup(gather_fsdp(params["embed"]), tokens).to(L.cdtype(cfg))
    if cfg.name.startswith("gemma2"):
        x = x * L.scalar(math.sqrt(cfg.d_model), x)
    return shard(x, "batch", "seq", "embed")


def _logits(cfg, params, x):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = (
        gather_fsdp(params["embed"]).T if cfg.tie_embeddings
        else gather_fsdp(params["unembed"])
    ).to(x.dtype)
    logits = x @ w
    logits = L.softcap(logits.float(), cfg.final_softcap)
    return shard(logits, "batch", "seq", "vocab")


def _resid(t):
    """A block's output placed as the residual stream, by batch (the
    identity without a mesh)."""
    return shard(t, "batch", "seq", "embed") if t.ndim == 3 else shard(t, "batch", "embed")


def _mamba_block(cfg, bp, x):
    h = L.rmsnorm(x, bp["ln"], cfg.norm_eps)
    y, _ = L.mamba_forward(cfg, bp["mamba"], h)
    return x + _resid(y)


def _scan_blocks(cfg, blocks, x, positions, enc_out=None, remat=True):
    # ssm / hybrid backbone blocks hold "mamba"
    return _run_layers(cfg, _layers(blocks), "mamba" in blocks, x, positions, enc_out, remat)


def _run_layers(cfg, layers, is_mamba, x, positions, enc_out=None, remat=True):
    train = remat
    remat = remat and torch.is_grad_enabled()
    for i, bp in enumerate(layers):
        if is_mamba:
            body = lambda x, bp=bp: _mamba_block(cfg, _gathered(bp), x)  # noqa: E731
        else:
            body = lambda x, bp=bp, i=i: _dense_block(  # noqa: E731
                cfg, _gathered(bp), x, positions, i, enc_out=enc_out, train=train
            )
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return x


def _positions(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)[None, :]


@on_mesh()
def forward(cfg: ModelConfig, params, batch, remat=True):
    """Forward → logits. batch: dict(tokens, [frontend])."""
    if cfg.family == "encdec":
        enc_x = batch["frontend"].to(L.cdtype(cfg))  # (B,S,D) stub frames
        enc_x = _scan_blocks(
            cfg, params["enc_blocks"], enc_x, _positions(enc_x.shape[1], enc_x),
            remat=remat,
        )
        enc_out = L.rmsnorm(enc_x, params["enc_norm"], cfg.norm_eps)
        tokens = batch["tokens"]
        x = _embed_tokens(cfg, params, tokens)
        x = _scan_blocks(
            cfg, params["dec_blocks"], x, _positions(tokens.shape[1], x),
            enc_out=enc_out, remat=remat,
        )
        return _logits(cfg, params, x)
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    if cfg.frontend == "vlm" and "frontend" in batch:
        fe = batch["frontend"].to(x.dtype)  # (B, P, D) patch embeddings
        x = torch.cat([fe, x], dim=1)
    positions = _positions(x.shape[1], x)
    if cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, positions, remat=remat)
    else:
        x = _scan_blocks(cfg, params["blocks"], x, positions, remat=remat)
    return _logits(cfg, params, x)


def _hybrid_forward(cfg, params, x, positions, remat=True):
    """zamba2: groups of mamba layers + one SHARED attention block (not
    checkpointed, as in the reference)."""
    per = cfg.attn_every
    n_groups = cfg.n_layers // per
    layers = _layers(params["blocks"])
    for i in range(n_groups):
        x = _run_layers(cfg, layers[i * per : (i + 1) * per], True, x, positions, remat=remat)
        x = _dense_block(cfg, _gathered(params["shared_attn"]), x, positions, 1)
    rem = cfg.n_layers - n_groups * per
    if rem:
        x = _run_layers(cfg, layers[-rem:], True, x, positions, remat=remat)
    return x


@on_mesh()
def loss_fn(cfg: ModelConfig, params, batch, remat=True):
    """Mean next-token negative log-likelihood over the float32 logits.

    batch: dict(tokens, labels, [frontend]); a label < 0 is masked out,
    and the VLM's patch positions are cut before the loss.
    """
    logits = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"].long()
    if cfg.frontend == "vlm" and "frontend" in batch:
        logits = logits[:, batch["frontend"].shape[1] :]
    # a masked label reads position 0; its term is multiplied by 0 below
    if hasattr(logits, "placements"):
        lse, ll = _vocab_parallel_terms(logits, labels.clamp(min=0))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_parallel_terms(logits, labels):
    """(log-sum-exp, the label's logit) of vocab-sharded DTensor logits,
    without gathering the vocab: the row max (detached: the log-sum-exp's
    value and grad do not depend on it) and the sum of exponentials are
    reductions DTensor finishes with a small all-reduce, and the label's
    logit is read shard-map style (``local_map``): each device reads the
    labels that fall in its vocab rows, a partial sum over the vocab's
    mesh dims. ``torch.gather`` on a sharded dim would make its backward
    allocate the whole (batch, seq, vocab) grad on every device."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    m = shard(logits.detach().amax(dim=-1, keepdim=True), "batch", "seq", None)
    total = shard(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True), "batch", "seq", None)
    lse = (m + torch.log(total))[..., 0]
    mesh = logits.device_mesh
    lpl = list(logits.placements)
    vocab = [i for i, pl in enumerate(lpl) if pl.is_shard(logits.ndim - 1)]
    ids_pl = labels.placements if hasattr(labels, "placements") else [Replicate()] * mesh.ndim
    ipl = [Replicate() if i in vocab else pl for i, pl in enumerate(ids_pl)]
    opl = [Partial() if i in vocab else pl for i, pl in enumerate(ipl)]

    def local(lg, idx):
        rel = idx - shard_index(mesh, vocab) * lg.shape[-1]
        hit = (rel >= 0) & (rel < lg.shape[-1])
        got = torch.gather(lg, -1, rel.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return got * hit.to(got.dtype)

    ll = local_map(local, out_placements=opl, in_placements=(lpl, ipl),
                   in_grad_placements=(lpl, ipl), device_mesh=mesh,
                   redistribute_inputs=True)(logits, labels)
    return lse, shard(ll, "batch", "seq")


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device="cuda"):
    """Decode cache per family, zeroed on ``device``."""
    device = resolve(device)
    hd = cfg.hd

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family in ("dense", "moe"):
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, hd)
        return dict(k=z(shape), v=z(shape))
    if cfg.family == "mla":
        return dict(latent=z((cfg.n_layers, batch, seq, cfg.kv_lora + cfg.qk_rope)))
    if cfg.family in ("ssm", "hybrid"):
        cache = dict(
            state=z(
                (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                torch.float32,
            ),
            conv=z(
                (cfg.n_layers, batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
            ),
        )
        if cfg.family == "hybrid":
            n_groups = cfg.n_layers // cfg.attn_every
            cache["k"] = z((n_groups, batch, seq, cfg.n_kv_heads, hd))
            cache["v"] = z((n_groups, batch, seq, cfg.n_kv_heads, hd))
        return cache
    if cfg.family == "encdec":
        shape = (cfg.dec_layers, batch, seq, cfg.n_kv_heads, hd)
        # cross-attention K/V are projected ONCE from the encoder output at
        # prefill time and cached
        return dict(k=z(shape), v=z(shape), cross_k=z(shape), cross_v=z(shape))
    raise ValueError(cfg.family)


def encdec_prepare_cross(cfg: ModelConfig, params, enc_out):
    """Project encoder output to per-layer cross K/V caches (prefill)."""
    hd = cfg.hd
    b, s, _ = enc_out.shape
    ks, vs = [], []
    for layer in _layers(params["dec_blocks"]):
        cross = _gathered(layer["cross"])
        ks.append((enc_out @ cross["wk"].to(enc_out.dtype)).reshape(b, s, cfg.n_kv_heads, hd))
        vs.append((enc_out @ cross["wv"].to(enc_out.dtype)).reshape(b, s, cfg.n_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


def _mamba_decode_layers(cfg, blocks, x, cache, lo: int):
    """Mamba decode over the stacked ``blocks``, on cache layers from ``lo``."""
    for i, bp in enumerate(_layers(blocks)):
        bp = _gathered(bp)
        h = L.rmsnorm(x, bp["ln"], cfg.norm_eps)
        y, st, cv = L.mamba_decode(
            cfg, bp["mamba"], h, cache["state"][lo + i], cache["conv"][lo + i]
        )
        y = _resid(y)
        if cv.dtype != cache["conv"].dtype:
            # the reference's scan carries the state in the promoted dtype
            cache["conv"] = cache["conv"].to(cv.dtype)
        cache["state"][lo + i] = st
        cache["conv"][lo + i] = cv
        x = x + y
    return x


@on_mesh()
def decode_step(cfg: ModelConfig, params, cache, token, pos: int):
    """One decode step. token: (B,) int → (logits (B,V), cache).

    The cache's tensors are written at ``pos`` in place; encdec reads its
    cross K/V from the cache (``encdec_prepare_cross``).
    """
    x = _lookup(gather_fsdp(params["embed"]), token).to(L.cdtype(cfg))
    if cfg.name.startswith("gemma2"):
        x = x * L.scalar(math.sqrt(cfg.d_model), x)
    x = shard(x, "batch", "embed")

    if cfg.family in ("dense", "moe"):
        for i, bp in enumerate(_layers(params["blocks"])):
            bp = _gathered(bp)
            window = None
            if cfg.window is not None:
                window = cfg.window if i % 2 == 0 else 1 << 30
            h = L.rmsnorm(x, bp["ln_attn"], cfg.norm_eps)
            a, _, _ = L.attention_decode(
                cfg, bp["attn"], h, cache["k"][i], cache["v"][i], pos, window=window
            )
            a = _resid(a)
            if cfg.post_norms:
                a = L.rmsnorm(a, bp["ln_attn_post"], cfg.norm_eps)
            x2 = x + a
            h = L.rmsnorm(x2, bp["ln_mlp"], cfg.norm_eps)
            if cfg.family == "moe":
                m = L.moe(cfg, bp["moe"], h[:, None, :])[:, 0]
                if cfg.dense_ff_parallel and "mlp" in bp:
                    m = m + L.mlp(cfg, bp["mlp"], h)
            else:
                m = L.mlp(cfg, bp["mlp"], h)
            if cfg.post_norms:
                m = L.rmsnorm(m, bp["ln_mlp_post"], cfg.norm_eps)
            x = x2 + m
    elif cfg.family == "mla":
        for i, bp in enumerate(_layers(params["blocks"])):
            bp = _gathered(bp)
            h = L.rmsnorm(x, bp["ln_attn"], cfg.norm_eps)
            a, _ = L.mla_attention(
                cfg, bp["attn"], h[:, None, :], None,
                decode_cache=cache["latent"][i], pos=pos,
            )
            x2 = x + a
            h = L.rmsnorm(x2, bp["ln_mlp"], cfg.norm_eps)
            x = x2 + L.mlp(cfg, bp["mlp"], h)
    elif cfg.family == "ssm":
        x = _mamba_decode_layers(cfg, params["blocks"], x, cache, 0)
    elif cfg.family == "hybrid":
        per = cfg.attn_every
        for g in range(cfg.n_layers // per):
            sub = L.tree_map(lambda a: a[g * per : (g + 1) * per], params["blocks"])
            x = _mamba_decode_layers(cfg, sub, x, cache, g * per)
            bp = _gathered(params["shared_attn"])
            h = L.rmsnorm(x, bp["ln_attn"], cfg.norm_eps)
            a, _, _ = L.attention_decode(
                cfg, bp["attn"], h, cache["k"][g], cache["v"][g], pos
            )
            x = x + a
            h = L.rmsnorm(x, bp["ln_mlp"], cfg.norm_eps)
            x = x + L.mlp(cfg, bp["mlp"], h)
    elif cfg.family == "encdec":
        hd = cfg.hd
        for i, bp in enumerate(_layers(params["dec_blocks"])):
            bp = _gathered(bp)
            h = L.rmsnorm(x, bp["ln_attn"], cfg.norm_eps)
            a, _, _ = L.attention_decode(
                cfg, bp["attn"], h, cache["k"][i], cache["v"][i], pos
            )
            x2 = x + a
            h = L.rmsnorm(x2, bp["ln_cross"], cfg.norm_eps)
            q = (h @ bp["cross"]["wq"].to(h.dtype)).reshape(-1, cfg.n_heads, hd)
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            c = L.decode_attention(q, ck, cv, pos=ck.shape[1] - 1)
            c = c.reshape(-1, cfg.n_heads * hd) @ bp["cross"]["wo"].to(h.dtype)
            x2 = x2 + c
            h = L.rmsnorm(x2, bp["ln_mlp"], cfg.norm_eps)
            x = x2 + L.mlp(cfg, bp["mlp"], h)
    else:
        raise ValueError(cfg.family)

    logits = _logits(cfg, params, x[:, None, :])[:, 0]
    return logits, dict(cache)


def prefill(cfg: ModelConfig, params, batch):
    """Prefill: full forward returning last-position logits (cache writes are
    exercised by decode_step). No remat, so K/V stay pinned on a mesh, as
    in the reference."""
    return forward(cfg, params, batch, remat=False)[:, -1]


# ------------------------------------------------------------------ module
class _Tree(nn.Module):
    """One level of a param tree: sub-dicts as submodules, tensors as
    (frozen) parameters, in the tree's key order."""

    def __init__(self, tree: dict):
        super().__init__()
        self.keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def values(self) -> dict:
        return {
            k: self._modules[k].values() if k in self._modules else self._parameters[k]
            for k in self.keys
        }


class LanguageModel(nn.Module):
    """A value tree as an ``nn.Module``: ``.to()``, ``state_dict()`` and
    ``parameters()`` see every tensor; ``params`` gives the tree back for
    the functional entry points.

    Its tensors are frozen, as serving holds them. To train, turn on
    ``requires_grad_(True)`` on the leaves (``make_train_step`` does so on
    its first call); ``loss_fn`` on ``params`` is then differentiable,
    training holds a grad per leaf, and the train step updates the
    parameters in place, so this module sees each step's values.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @property
    def params(self) -> dict:
        return self.tree.values()

    def forward(self, batch, remat=True):
        return forward(self.cfg, self.params, batch, remat=remat)

    def decode_step(self, cache, token, pos: int):
        return decode_step(self.cfg, self.params, cache, token, pos)
