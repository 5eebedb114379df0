"""Assigned input shapes and abstract input specs per (arch × shape) cell
(the reference's ``repro.launch.shapes``).

Shapes (LM family): train_4k / prefill_32k / decode_32k / long_500k.
``decode_*`` and ``long_*`` run ``decode_step`` (one token against a KV
cache of seq_len); ``long_500k`` only for sub-quadratic archs (ssm/hybrid).
All inputs are tensors on the ``meta`` device — shapes and dtypes, no
data; the dry run makes fake tensors like them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype spec: an empty tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Abstract inputs for the cell's step function (tokens/labels/cache...)."""
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]
    kind = info["kind"]
    i32, f32 = torch.int32, torch.float32
    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            batch = dict(
                frontend=sds((b, s, cfg.d_model), f32),
                tokens=sds((b, s), i32),
                labels=sds((b, s), i32),
            )
        elif cfg.frontend == "vlm":
            batch = dict(
                tokens=sds((b, s - cfg.frontend_len), i32),
                labels=sds((b, s - cfg.frontend_len), i32),
                frontend=sds((b, cfg.frontend_len, cfg.d_model), f32),
            )
        else:
            batch = dict(tokens=sds((b, s), i32), labels=sds((b, s), i32))
        if kind == "prefill":
            batch.pop("labels")
        return dict(kind=kind, batch=batch)
    # decode: the port's own cache, made on the meta device
    from repro_torch.models import model as M

    spec = dict(
        kind="decode",
        cache=M.init_cache(cfg, b, s, device="meta"),
        token=sds((b,), i32),
        pos=s - 1,
    )
    if cfg.family == "encdec":
        spec["enc_out"] = sds((b, s, cfg.d_model), torch.bfloat16)
    return spec
