"""The yardstick of the two CUDA kernels: peaks of the card, and the least
time each call could take, from the operands it was given.

Frozen copies of ``chip_smoke.py``'s ``int32_rate``, ``bound_ms`` and
``search_probes``: the bound of a call is the larger of its bytes over the
card's HBM rate and its 32-bit integer operations over the INT32 rate
(INT32 lanes x SMs x the SM's maximum clock). An anchor search reads the
distinct anchor rows that a binary search over its queries touches, its
queries, and writes one int32 a query; it does two word compares a probe.
A selector decode reads a row id, D selector bytes and R cursor words a
row and writes ten bytes a slot; it does eight integer operations a slot.
"""
from __future__ import annotations

import subprocess

HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
KW = 2  # key words of a 64-bit key


def int32_rate() -> float:
    """Peak 32-bit integer ops/s of card 0."""
    import torch

    p = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    mhz = float(p.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def bound_s(nbytes: float, ops: float, int_rate: float) -> float:
    return max(nbytes / HBM_BPS, ops / int_rate)


def pack64(w):
    """Ordered int64 of (N, 2) uint32-bit-view int32 words."""
    w = w.long() & 0xFFFFFFFF
    return (((w[:, 0] - (1 << 31)) << 32) | w[:, 1]).contiguous()


def search_probes(a64, q64) -> tuple:
    """Distinct anchor rows, and probes in all, that a binary search of each
    row of ordered int64 queries ``q64`` (C, Q) over ``a64`` (G,) reads:
    two (C,) tensors, one entry per call."""
    import torch

    g = a64.shape[0]
    c = q64.shape[0]
    lo = torch.zeros_like(q64)
    n = torch.full_like(q64, g)
    seen = torch.zeros((c, g), dtype=torch.bool, device=a64.device)
    call = torch.arange(c, device=a64.device)[:, None].expand_as(q64)
    probes = torch.zeros(c, dtype=torch.long, device=a64.device)
    while bool((n > 0).any()):
        act = n > 0
        half = n >> 1
        mid = lo + half
        seen[call[act], mid[act]] = True
        probes += act.sum(1)
        le = act & (a64[mid.clamp(max=g - 1)] <= q64)
        lo = torch.where(le, mid + 1, lo)
        n = torch.where(le, n - half - 1, torch.where(act, half, n))
    return seen.sum(1), probes


def anchor_search_bound(anchors, queries, int_rate: float) -> float:
    """Least seconds of anchor_search calls on one anchor table: ``queries``
    is a list of the calls' (Q, 2) query words, all of one Q."""
    import torch

    a64 = pack64(anchors)
    total = 0.0
    for c in range(0, len(queries), 512):
        part = queries[c:c + 512]
        q64 = torch.stack([pack64(q) for q in part])
        rows, probes = search_probes(a64, q64)
        q = q64.shape[1]
        nbytes = rows.double() * KW * 4 + q * (KW * 4 + 4)
        ops = probes.double() * KW * 2
        total += float(torch.maximum(nbytes / HBM_BPS, ops / int_rate).sum())
    return total


def selector_decode_bound(n: int, d: int, r: int, int_rate: float) -> float:
    """Least seconds of one selector_decode call over ``n`` rows."""
    return bound_s(n * 4 + n * d + n * r * 4 + n * d * 10, n * d * 8, int_rate)
