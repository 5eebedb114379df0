"""Baseline: LevelDB-style merging iterator over R sorted runs.

A seek performs one binary search *per run* (R × log2 N comparisons); every
`next` re-compares the keys under all cursors to find the global minimum
(the min-heap of the paper, vectorized here as an R-way argmin — the same
comparison count up to log factors, which we report analytically).

User-level iteration semantics match LevelDB's DBIter: newest version per
key wins (max seqno), older duplicates and tombstoned keys are skipped.

The reference is one jitted program (a vmap over runs, an unrolled R-way
tournament, a scan over ``width`` steps). Eager torch fuses none of that,
so the runs are a batched dimension here: the seek is one fixed-step
search over (R, N, KW) with a per-run midpoint, and the tournament is a
masked lexicographic reduction over R. Neither's launch count depends on
R; only the ``width`` loop of :func:`merge_scan` stays a Python loop (it
is the scan's carry). Answers are the reference's, bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import keys as K
from repro_torch.core.runs import RunSet
from repro_torch.device import ordered

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def seek_cursors(runset: RunSet, queries: torch.Tensor) -> torch.Tensor:
    """Per-run lower bound for each query: (Q, R) cursors.

    Each run is searched over its padded length (the +inf padding sorts
    last), as the reference's vmapped ``lower_bound`` does."""
    r, n = runset.r, runset.nmax
    q = queries.shape[0]
    lo = torch.zeros((q, r), dtype=torch.int32, device=queries.device)
    hi = torch.full((q, r), n, dtype=torch.int32, device=queries.device)
    run = _arange(r, queries)[None, :]
    qk = queries[:, None, :]
    for _ in range(max(1, int(math.ceil(math.log2(n + 1))) + 1)):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = K.key_lt(runset.keys[run, mid.clamp(0, n - 1)], qk)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _min_run(keys_rt: torch.Tensor, seq_rt: torch.Tensor) -> torch.Tensor:
    """Index of the run holding the smallest (key, seq desc) entry.

    keys_rt: (Q, R, KW); seq_rt: (Q, R). The vectorized min-heap pop."""
    return _min_ordered([ordered(keys_rt[..., w]) for w in range(keys_rt.shape[2])],
                        ordered(seq_rt))


def _min_ordered(words: list[torch.Tensor], seq: torch.Tensor) -> torch.Tensor:
    """:func:`_min_run` on ordered words (each (Q, R)) and ordered seq:
    the smallest leading word, then among those the smallest next word,
    ..., then the largest seq, then the first run left — the reference's
    tournament with its strict ``better`` keeps the earliest index too."""
    m = words[0].amin(dim=1, keepdim=True)
    cand = words[0] == m
    for x in words[1:]:
        x = torch.where(cand, x, _I32_MAX)
        cand = cand & (x == x.amin(dim=1, keepdim=True))
    s = torch.where(cand, seq, _I32_MIN)
    cand = cand & (s == s.amax(dim=1, keepdim=True))
    return torch.argmax(cand.to(torch.uint8), dim=1)


def _pick(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``x[i, sel[i]]`` for a (Q, R, ...) tensor."""
    return x[torch.arange(x.shape[0], device=x.device), sel.long()]


def merge_scan(runset: RunSet, queries: torch.Tensor, width: int):
    """Seek + next×width with the merging iterator.

    Returns (keys (Q,W,KW), vals (Q,W,VW), valid (Q,W)). ``valid`` is False
    for duplicate older versions / tombstones / end-of-data slots (matching
    :func:`repro_torch.core.query.scan` semantics so results are comparable).

    Each step gathers the entries under the R cursors through flat row
    ids, so its launch count depends on neither R nor the run length. An
    exhausted run reads as the +inf key with seq 0; only when every run is
    exhausted is one selected, and then the emitted key is +inf, as the
    reference's.
    """
    r, n, kw = runset.r, runset.nmax, runset.kw
    cursors = seek_cursors(runset, queries)  # (Q, R)
    lens = runset.lens[None, :]
    base = (_arange(r, queries) * n)[None, :]
    keys = runset.keys.reshape(r * n, kw)
    vals = runset.vals.reshape(r * n, runset.vw)
    seq, tomb = runset.seq.reshape(r * n), runset.tomb.reshape(r * n)
    last_key = torch.zeros_like(queries)
    have_last = torch.zeros(queries.shape[:1], dtype=torch.bool, device=queries.device)
    out_k, out_v, out_ok = [], [], []
    for _ in range(width):
        row = base + cursors.clamp(max=n - 1)  # (Q, R) flat row ids
        exhausted = cursors >= lens
        kk = ordered(keys[row])  # (Q, R, KW)
        sel = _min_ordered(
            [kk[..., w].masked_fill(exhausted, _I32_MAX) for w in range(kw)],
            ordered(seq[row].masked_fill(exhausted, 0)),
        )
        at_end = exhausted.all(dim=1)
        srow = row.gather(1, sel[:, None])[:, 0]
        key = keys[srow].masked_fill(at_end[:, None], K.INF_WORD)
        dup = have_last & (key == last_key).all(dim=1)
        out_k.append(key)
        out_v.append(vals[srow])
        out_ok.append(~(at_end | dup | tomb[srow]))
        cursors = cursors.scatter_add(1, sel[:, None], (~at_end)[:, None].to(torch.int32))
        last_key, have_last = key, ~at_end
    return (
        torch.stack(out_k, dim=1),
        torch.stack(out_v, dim=1),
        torch.stack(out_ok, dim=1),
    )


def merge_get(runset: RunSet, queries: torch.Tensor):
    """Point query via per-run binary searches + newest-version pick."""
    cursors = seek_cursors(runset, queries)  # (Q, R)
    kk, vv, ss, tt = runset.gather(_arange(runset.r, queries)[None, :], cursors)
    hit = K.key_eq(kk, queries[:, None, :]) & (cursors < runset.lens[None, :])
    ss = ordered(torch.where(hit, ss, 0))
    maxseq = ss.amax(dim=1, keepdim=True)
    best = torch.argmax((hit & (ss == maxseq)).to(torch.uint8), dim=1)
    found = hit.any(dim=1)
    return found & ~_pick(tt, best), _pick(vv, best)


def seek_comparison_cost(r: int, n_per_run: int) -> float:
    """Analytic comparison count for a merging-iterator seek (paper §3.3)."""
    return r * max(1.0, math.log2(max(2, n_per_run)))
