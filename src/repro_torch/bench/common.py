"""Shared benchmark helpers: table generation (weak/strong locality), timing,
CSV emission. Mirrors the paper's §5.1 setup: keys 64-bit, R tables × N
keys each, uniform random query keys.

Timing synchronises the card around every call. A ``CSV(profile=True)``
runs one more call of each row's operation (``emit(..., call=)``) under
``torch.profiler``, and the row carries that call's device-busy time and
its count of device launches (the device's kernels, copies and fills).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.core.runs import make_run
from repro_torch.device import as_words, resolve


def make_tables(
    r: int,
    n_per_table: int = 65536,
    locality: str = "weak",
    chunk: int = 64,
    seed: int = 0,
    vw: int = 2,
    device="cuda",
):
    """R tables as in §5.1: each key assigned to a random table (weak) or in
    64-key consecutive chunks (strong). Returns list[Run] (keys disjoint)."""
    rng = np.random.default_rng(seed)
    total = r * n_per_table
    keys = np.arange(1, total + 1, dtype=np.uint64) * 64  # spaced key domain
    if locality == "weak":
        owner = rng.integers(0, r, total)
    else:
        n_chunks = (total + chunk - 1) // chunk
        chunk_owner = rng.integers(0, r, n_chunks)
        owner = np.repeat(chunk_owner, chunk)[:total]
    runs = []
    for i in range(r):
        kk = keys[owner == i]
        runs.append(make_run(kk, seq=i, vw=vw, device=device))
    return runs, keys


def sync() -> None:
    """Wait for the card, where one is in use (the reference's
    ``block_until_ready``)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_batched(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median wall-time per call of a batched op (seconds)."""
    for _ in range(warmup):
        fn(*args)
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def profile_call(fn, wall_s: float | None = None) -> dict:
    """Run ``fn`` once under the profiler: its device-busy µs, its busy
    share of ``wall_s`` (the call's time; timed here, unprofiled, when not
    given) and its device launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    if wall_s is None:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_s = time.perf_counter() - t0
    # device activity only: a host-op trace of a merging scan's ~10^4 ops
    # takes the profiler seconds to assemble
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in dev)
    return dict(busy_us=float(busy), launches=len(dev),
                busy_share=float(busy / max(1e-9, wall_s * 1e6)))


def qkeys(rng, keyspace_max: int, q: int, device="cuda") -> torch.Tensor:
    return as_words(
        CK.pack_u64(rng.integers(1, keyspace_max, q).astype(np.uint64)),
        resolve(device),
    )


class CSV:
    """The rows printed so far; with ``profile`` on, each row given a
    ``call`` also carries that call's profile (:func:`profile_call`)."""

    def __init__(self, profile: bool = False):
        self.rows = []
        self.profile = profile
        self.profiles: dict[str, dict] = {}

    def emit(self, name: str, us_per_call: float, derived: str = "",
             call=None, wall_s: float | None = None):
        """Print one row; ``call`` runs the row's operation once more (its
        timed call took ``wall_s``) to profile it when ``profile`` is on."""
        line = f"{name},{us_per_call:.3f},{derived}"
        self.rows.append(line)
        print(line, flush=True)
        if self.profile and call is not None:
            p = self.profiles[name] = profile_call(call, wall_s)
            print(f"# profile {name}: device busy {p['busy_us']:.1f} us/call "
                  f"(share {p['busy_share']:.3f}), {p['launches']} device "
                  f"launches/call", flush=True)


def zipf_keys(rng, n_keys: int, q: int, theta: float = 0.99) -> np.ndarray:
    """YCSB-style zipfian item sampler over [0, n_keys)."""
    # rejection-free approximate zipfian via inverse-CDF on a harmonic grid
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    w = 1.0 / ranks ** theta
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(q)
    return np.searchsorted(cdf, u).astype(np.int64)


def check(cond, msg: str) -> None:
    """A figure's answer check (``check_answers=True``): raise on a wrong one."""
    if not cond:
        raise AssertionError(msg)
