"""Fig 11 (weak locality) + Fig 12 (strong locality): Seek, Seek+Next50 and
Get throughput vs number of tables, REMIX vs merging iterator vs bloom.

Reported as µs/op at batch Q (the relative trends vs R are the paper's
claims — REMIX's advantage grows with table count). The bloom row probes
with the port's non-wrapping bit positions (:mod:`repro_torch.core.bloom`),
so, unlike the reference's, its filter never drops a key it holds.

With ``check_answers=True`` every answer is held to a numpy oracle over the
tables' keys: both seeks land on the first key >= the query, both scans
return a correct prefix of the keys from there, the three gets find every
probed key with its value, and the bloom has no false negative.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.bench.common import CSV, check, make_tables, qkeys, time_batched
from repro_torch.core import keys as CK
from repro_torch.core import merge_iter as M
from repro_torch.core import query as Q
from repro_torch.core.bloom import bloom_maybe_contains, build_bloom
from repro_torch.core.remix import build_remix
from repro_torch.device import as_words, u32_np

RS = (1, 2, 4, 8, 16)
QBATCH = 2048
N_PER_TABLE = 16384


def _u64(words: torch.Tensor) -> np.ndarray:
    return CK.unpack_u64(u32_np(words))


def _check_seeks(keys, remix, runset, qk, fig, r):
    q64 = _u64(qk)
    at = np.searchsorted(keys, q64, side="left")
    end = at >= len(keys)
    want = keys[np.minimum(at, len(keys) - 1)]
    for mode in ("binary", "vector"):
        pos = Q.seek(remix, runset, qk, ingroup=mode)
        kk, _, ok = Q.gather_view(remix, runset, pos, 1)
        ok = ok[:, 0].cpu().numpy()
        got = _u64(kk[:, 0])
        check(np.array_equal(ok, ~end) and np.array_equal(got[ok], want[ok]),
              f"{fig} R={r}: REMIX seek ({mode}) missed the first key >= query")
    cur = M.seek_cursors(runset, qk)
    run = torch.arange(runset.r, device=qk.device)[None, :]
    kk = runset.keys[run, cur.clamp(max=runset.nmax - 1)]
    kk = torch.where((cur < runset.lens[None, :])[..., None], kk, -1)
    first = _u64(kk).min(axis=1)
    check(np.array_equal(first[~end], want[~end]) and
          (first[end] == np.uint64(2**64 - 1)).all(),
          f"{fig} R={r}: merging seek missed the first key >= query")


def _check_scans(keys, qk2, scans, fig, r, width=64):
    at = np.searchsorted(keys, _u64(qk2), side="left")
    for what, (kk, ok) in scans.items():
        kk, ok = _u64(kk), ok.cpu().numpy()
        for i in range(len(at)):
            got = kk[i][ok[i]]
            want = keys[at[i]: at[i] + width]
            check(len(got) >= min(50, len(want))
                  and np.array_equal(got, want[: len(got)]),
                  f"{fig} R={r}: {what} Next50 of query {i} is not the "
                  f"oracle's prefix ({len(got)} keys)")


def _check_gets(hit_q, bloom, gets, fig, r) -> int:
    lo = u32_np(hit_q)[:, 1]
    base = None
    for what, (f, v) in gets.items():
        f, v = f.cpu().numpy(), u32_np(v)
        check(f.all(), f"{fig} R={r}: {what} missed {int((~f).sum())} stored keys")
        check(np.array_equal(v[:, 0], lo), f"{fig} R={r}: {what} values wrong")
        if base is not None:
            check(np.array_equal(v, base), f"{fig} R={r}: {what} values differ")
        base = v
    # the run that holds each key is the value's seq word (make_tables)
    owner = torch.from_numpy(base[:, -1].astype(np.int64)).to(hit_q.device)
    maybe = bloom_maybe_contains(bloom, hit_q)
    fn = int((~maybe[torch.arange(len(owner), device=hit_q.device), owner]).sum())
    check(fn == 0, f"{fig} R={r}: the bloom dropped {fn} stored keys")
    return fn


def run(csv: CSV, locality: str = "weak", rs=RS, d: int = 32,
        n_per_table: int = N_PER_TABLE, device="cuda", check_answers=False):
    rng = np.random.default_rng(42)
    fig = "fig11" if locality == "weak" else "fig12"

    def row(name, fn, q, derived=None):
        """Time ``fn(q)`` and emit its row in µs per query of ``q``
        (``derived`` None: the rate)."""
        t = time_batched(fn, q)
        n = len(q)
        csv.emit(name, t / n * 1e6, f"{n / t:.0f} ops/s" if derived is None else derived,
                 call=lambda: fn(q), wall_s=t)

    for r in rs:
        runs, keys = make_tables(r, n_per_table, locality=locality, device=device)
        remix, runset = build_remix(runs, d=d)
        qk = qkeys(rng, int(keys[-1]), QBATCH, device)

        row(f"{fig}a_seek_remix_full,R={r}",
            lambda q: Q.seek(remix, runset, q, ingroup="binary"), qk)
        row(f"{fig}a_seek_remix_vector,R={r}",
            lambda q: Q.seek(remix, runset, q, ingroup="vector"), qk)
        row(f"{fig}a_seek_merging,R={r}", lambda q: M.seek_cursors(runset, q), qk)

        qk2 = qk[:256]
        row(f"{fig}b_next50_remix,R={r}", lambda q: Q.scan(remix, runset, q, width=64),
            qk2, "")
        row(f"{fig}b_next50_merging,R={r}", lambda q: M.merge_scan(runset, q, width=64),
            qk2, "")

        # point queries: REMIX get (no bloom) vs bloom-prefiltered per-run get
        hit_q = as_words(
            np.stack(
                [np.zeros(QBATCH, np.uint32),
                 (rng.choice(keys, QBATCH) & 0xFFFFFFFF).astype(np.uint32)],
                axis=1,
            ),
            device,
        )
        row(f"{fig}c_get_remix,R={r}", lambda q: Q.get(remix, runset, q), hit_q, "")
        bloom = build_bloom([run.keys for run in runs], device=device)

        def bloom_get(q):
            maybe = bloom_maybe_contains(bloom, q)
            found, vals = M.merge_get(runset, q)
            return found & maybe.any(1), vals

        row(f"{fig}c_get_sstable_bloom,R={r}", bloom_get, hit_q,
            "corrected probe (non-wrapping bit positions)")
        row(f"{fig}c_get_sstable_nobloom,R={r}", lambda q: M.merge_get(runset, q), hit_q, "")
        if check_answers:
            _check_seeks(keys, remix, runset, qk, fig, r)
            sk, _, sok, _ = Q.scan(remix, runset, qk2, width=64)
            mk, _, mok = M.merge_scan(runset, qk2, width=64)
            _check_scans(keys, qk2, {"REMIX": (sk, sok), "merging": (mk, mok)},
                         fig, r)
            fn = _check_gets(hit_q, bloom, {
                "REMIX get": Q.get(remix, runset, hit_q),
                "merge_get": M.merge_get(runset, hit_q),
                "bloom get": bloom_get(hit_q),
            }, fig, r)
            print(f"# {fig} R={r}: answers held to the oracle; bloom false "
                  f"negatives {fn} of {QBATCH}", flush=True)
        del runs, remix, runset, bloom

    # derived claims (weak locality): speedup at R=8 and R=16
    csv.emit(f"{fig}_analytic_cmp_merge,R=8",
             M.seek_comparison_cost(8, n_per_table),
             "comparisons/seek merging iterator")
    csv.emit(f"{fig}_analytic_cmp_remix,R=8",
             math.log2(8 * n_per_table / d) + math.log2(d),
             "comparisons/seek REMIX (anchor bsearch + in-group)")
