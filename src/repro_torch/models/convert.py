"""Carry param trees between the reference and the port.

``params_from_numpy`` takes the reference's value tree
(``split_params(init_params(...))[0]``) with every leaf as a numpy array
and returns the port's tree, leaf for leaf under the same keys. A
``bfloat16`` leaf (``ml_dtypes``) goes through float32, which is exact,
to ``torch.bfloat16``. ``numpy_from_params`` is the reverse: the port's
tree (params, grads or optimizer state) as host numpy arrays, a
``bfloat16`` leaf as float32 (exact).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def jax_tree_keys(tree, prefix: str = "") -> dict[str, tuple]:
    """Every leaf of a nested-dict tree: its '/'-joined key path → shape."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(jax_tree_keys(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None, like=None):
    """The reference's numpy value tree as the port's tensor tree.

    ``dtype`` casts every float leaf. ``like`` (a port value tree, e.g.
    ``split_params(init_params(cfg, ...))[0]``) is the structure to
    expect: every leaf of ``like`` must be mapped, with its shape, and
    ``tree`` may hold no other.
    """
    device = resolve(device)
    if like is not None:
        got, want = jax_tree_keys(tree), jax_tree_keys(like)
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise KeyError(f"param keys differ: missing {missing}, extra {extra}")
        bad = [k for k in want if got[k] != want[k]]
        if bad:
            raise ValueError(
                "param shapes differ: " + ", ".join(f"{k} {got[k]} != {want[k]}" for k in bad)
            )

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf(t, device, dtype)

    return walk(tree)


def numpy_from_params(tree):
    """The port's tensor tree as a numpy tree under the same keys (host
    copies; ``bfloat16`` leaves as float32)."""
    if isinstance(tree, dict):
        return {k: numpy_from_params(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()
