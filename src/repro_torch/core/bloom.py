"""Bloom filters — the paper's point-query baseline (10 bits/key, k=7).

Vectorized build and probe over multiword keys; one filter per run, stacked
(R, words) so a query batch probes all runs at once.

The hash runs on int32 bit-views of the uint32 words: an int32 multiply
or add keeps the same low 32 bits as the unsigned one, and a logical
right shift is the arithmetic one with the sign-extended bits masked off.
Bit positions are ``(h1 + j * h2) mod nbits`` in int64, exactly as the
reference's build computes them in uint64. The reference's probe does the
same sum in uint32, which wraps at 2**32 and misses inserted keys whenever
``nbits`` is not a power of two; this probe does not wrap, so a key the
build inserted is always reported as maybe present.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import as_words, resolve


def _i32(u: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return u - (1 << 32) if u >= 1 << 31 else u


MIX1 = _i32(0x9E3779B1)
MIX2 = _i32(0x85EBCA77)
MIX3 = _i32(0xC2B2AE3D)
H1_SEED = _i32(0x811C9DC5)
H2_SEED = _i32(0x01000193)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit-views (``>>`` of the uint32)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _mix(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent 32-bit hashes from (..., KW) int32 key words,
    returned as int32 bit-views."""
    h1 = torch.full(words.shape[:-1], H1_SEED, dtype=torch.int32,
                    device=words.device)
    h2 = torch.full_like(h1, H2_SEED)
    for w in range(words.shape[-1]):
        x = words[..., w]
        h1 = (h1 ^ x) * MIX1
        h1 = h1 ^ _shr(h1, 15)
        h2 = (h2 + x) * MIX2
        h2 = h2 ^ _shr(h2, 13)
    h1 = (h1 ^ _shr(h1, 16)) * MIX3
    h2 = h2 ^ _shr(h2, 16)
    return h1, h2


def _unsigned(h: torch.Tensor) -> torch.Tensor:
    """int32 bit-view -> int64 holding the uint32 value."""
    return h.to(torch.int64) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BloomSet:
    bits: torch.Tensor  # (R, W) int32 bit-views of the uint32 bit arrays
    nbits: int
    k: int


def build_bloom(
    run_keys, bits_per_key: int = 10, k: int = 7, device="cuda"
) -> BloomSet:
    """One filter per run. ``run_keys``: (Ni, KW) uint32 arrays (or int32
    word tensors). The bit arrays equal the reference's, bit for bit."""
    device = resolve(device)
    run_keys = [
        kk.cpu().numpy() if isinstance(kk, torch.Tensor) else np.asarray(kk)
        for kk in run_keys
    ]
    nbits = max(64, bits_per_key * max(len(kk) for kk in run_keys))
    nbits = ((nbits + 31) // 32) * 32
    words = nbits // 32
    bits = np.zeros((len(run_keys), words), np.uint32)
    for i, kk in enumerate(run_keys):
        if len(kk) == 0:
            continue
        h1, h2 = _mix(as_words(kk, "cpu"))
        h1, h2 = _unsigned(h1).numpy(), _unsigned(h2).numpy()
        bitmap = np.zeros(nbits, bool)
        for j in range(k):
            bitmap[(h1 + j * h2) % nbits] = True
        # bit p of the filter is bit p % 32 of word p // 32: packed
        # little-endian, as the reference's ``bits[p // 32] |= 1 << p % 32``
        bits[i] = np.packbits(bitmap, bitorder="little").view("<u4")
    return BloomSet(bits=as_words(bits, device), nbits=nbits, k=k)


def bloom_maybe_contains(bf: BloomSet, queries: torch.Tensor) -> torch.Tensor:
    """(Q, KW) int32 word queries -> (Q, R) bool 'may contain'."""
    h1, h2 = _mix(queries)
    h1, h2 = _unsigned(h1), _unsigned(h2)
    bits = _unsigned(bf.bits)  # (R, W)
    out = torch.ones((queries.shape[0], bf.bits.shape[0]), dtype=torch.bool,
                     device=queries.device)
    for j in range(bf.k):
        pos = (h1 + j * h2) % bf.nbits  # no wrap: < 7 * 2**32 in int64
        hit = (bits[:, pos // 32].T >> (pos % 32)[:, None]) & 1
        out = out & (hit != 0)
    return out
