"""Architecture registry: one module per assigned architecture + the paper's
own RemixDB service config. ``get_config(name)`` / ``--arch <id>``.

Carried from the reference as they are (pure Python): ``ModelConfig``
(:mod:`repro_torch.configs.base`), the ten language-model architectures,
``get_config`` / ``reduced``, and the paper's system config ``remixdb``
(:class:`repro_torch.configs.remixdb.RemixServiceConfig`), which sizes the
sharded store of :mod:`repro_torch.db.sharded`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.remixdb import CONFIG, RemixServiceConfig  # noqa: F401

_MODULES = {
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
}

ARCHS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib

    if name == "remixdb":
        return importlib.import_module("repro_torch.configs.remixdb").CONFIG
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS + ['remixdb']}")
    return importlib.import_module(_MODULES[name]).CONFIG


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=256,
        n_heads=max(1, min(cfg.n_heads, 4)),
        n_kv_heads=max(0, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0,
        d_ff=512 if cfg.d_ff else 0,
        vocab=512,
        head_dim=64 if cfg.head_dim else None,
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
    )
    if cfg.family == "mla":
        small.update(q_lora=96, kv_lora=64, qk_nope=32, qk_rope=16, v_head=32)
    if cfg.family == "moe":
        small.update(n_experts=8, top_k=min(cfg.top_k, 2), d_ff_expert=128)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.family == "hybrid":
        small.update(attn_every=2)
    if cfg.family == "encdec":
        small.update(enc_layers=2, dec_layers=2, n_layers=4)
    if cfg.n_kv_heads and cfg.n_kv_heads == cfg.n_heads:
        small["n_kv_heads"] = small["n_heads"]  # keep MHA shape relation
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
