"""Multiword fixed-width keys.

Keys are lexicographically-ordered vectors of ``KW`` uint32 words, word 0
most significant. The default ``KW=2`` gives a 64-bit keyspace, matching the
paper's 16-byte hex-encoded 64-bit integer keys. The all-ones key is reserved
as the +inf sentinel used for padding (queries must not use it).

On the torch side a key is a (..., KW) int32 tensor holding the words'
bits (see :mod:`repro_torch.device`); every comparison here orders the
words unsigned. All helpers are vectorized over leading batch dims and
free of data-dependent host control flow, so they never wait on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import ordered, resolve

KW = 2  # default number of uint32 words per key (64-bit keys)

UINT32_MAX = np.uint32(0xFFFFFFFF)
INF_WORD = -1  # the +inf sentinel word (0xFFFFFFFF) as an int32 bit-view


def max_key(kw: int = KW, device="cuda") -> torch.Tensor:
    """The +inf sentinel key (all words 0xFFFFFFFF)."""
    return torch.full((kw,), INF_WORD, dtype=torch.int32, device=resolve(device))


def pack_u64(x) -> np.ndarray:
    """Pack uint64 scalars/arrays into (..., 2) uint32 big-word-first keys."""
    x = np.asarray(x, dtype=np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def unpack_u64(k) -> np.ndarray:
    """Inverse of :func:`pack_u64` (for tests / host-side code)."""
    k = np.asarray(k)
    if k.dtype == np.int32:
        k = k.view(np.uint32)
    return (k[..., 0].astype(np.uint64) << np.uint64(32)) | k[..., 1].astype(
        np.uint64
    )


def key_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last axis. Broadcasts leading dims."""
    a, b = ordered(a), ordered(b)
    kw = a.shape[-1]
    lt = a < b
    eq = a == b
    out = lt[..., 0]
    carry = eq[..., 0]
    for w in range(1, kw):
        out = out | (carry & lt[..., w])
        carry = carry & eq[..., w]
    return out


def key_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def key_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return key_lt(a, b) | key_eq(a, b)


def _bsearch(keys: torch.Tensor, queries: torch.Tensor, pred) -> torch.Tensor:
    """Fixed-step vectorized binary search.

    ``keys``: (N, KW) sorted ascending. ``queries``: (Q, KW).
    ``pred(kmid, q) -> bool``: True means "go right" (lo = mid + 1).
    Returns (Q,) int32 insertion points in [0, N].
    """
    n = keys.shape[0]
    q = queries.shape[0]
    lo = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    if n == 0:
        return lo
    hi = torch.full((q,), n, dtype=torch.int32, device=queries.device)
    steps = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid = keys[mid.clamp(0, n - 1)]
        go_right = pred(kmid, queries)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def lower_bound(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """First index i with keys[i] >= query. keys (N,KW) sorted, queries (Q,KW)."""
    return _bsearch(keys, queries, key_lt)


def upper_bound(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """First index i with keys[i] > query."""
    return _bsearch(keys, queries, key_le)


def sort_indices_np(keys: np.ndarray, seq: np.ndarray | None = None) -> np.ndarray:
    """Host-side stable ordering by (key asc, seq desc). keys (N,KW) uint32."""
    keys = np.asarray(keys, np.uint32)
    cols = []
    if seq is not None:
        seq = np.asarray(seq, np.uint64)
        cols.append(np.uint64(0xFFFFFFFFFFFFFFFF) - seq)  # seq desc
    for w in range(keys.shape[-1] - 1, -1, -1):
        cols.append(keys[:, w])
    return np.lexsort(cols)  # last col = primary = word 0
