"""Immutable sorted runs ("table files").

A :class:`Run` is one sorted run: keys strictly ascending (unique within the
run), each entry carrying a global sequence number (larger = newer), a
tombstone flag and a fixed-width value payload. A :class:`RunSet` stacks up to
R runs into padded tensors so that (run, index) pairs can be gathered in one
vectorized op — the device analogue of the paper's per-table block cursor.

Padding uses the +inf sentinel key so padded slots sort after every real key.
Key, value and sequence words are int32 bit-views of uint32 words
(:mod:`repro_torch.device`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.device import as_words, resolve


@dataclasses.dataclass(frozen=True)
class Run:
    keys: torch.Tensor  # (N, KW) int32 words, strictly ascending (unsigned)
    vals: torch.Tensor  # (N, VW) int32 words
    seq: torch.Tensor  # (N,) int32 words (larger = newer, unsigned)
    tomb: torch.Tensor  # (N,) bool tombstones

    @property
    def n(self) -> int:
        return self.keys.shape[0]

    @property
    def kw(self) -> int:
        return self.keys.shape[1]

    @property
    def vw(self) -> int:
        return self.vals.shape[1]


def make_run(
    keys_np, vals_np=None, seq=0, tomb=None, vw: int = 2, sort: bool = True,
    device="cuda",
) -> Run:
    """Build a Run from host arrays. ``keys_np``: (N,KW) uint32 or (N,) u64."""
    device = resolve(device)
    keys_np = np.asarray(keys_np)
    if keys_np.ndim == 1:
        keys_np = K.pack_u64(keys_np)
    keys_np = keys_np.astype(np.uint32)
    n = keys_np.shape[0]
    if np.isscalar(seq) or np.asarray(seq).ndim == 0:
        seq_np = np.full((n,), int(seq), np.uint32)
    else:
        seq_np = np.asarray(seq, np.uint32)
    tomb_np = (
        np.zeros((n,), bool) if tomb is None else np.asarray(tomb, bool)
    )
    if vals_np is None:
        # default payload: low word of the key, tagged, so tests can verify
        vals_np = np.zeros((n, vw), np.uint32)
        if n:
            vals_np[:, 0] = keys_np[:, -1]
            vals_np[:, -1] = seq_np
    vals_np = np.asarray(vals_np, np.uint32)
    if sort and n:
        order = K.sort_indices_np(keys_np, seq_np)
        keys_np, vals_np = keys_np[order], vals_np[order]
        seq_np, tomb_np = seq_np[order], tomb_np[order]
        # runs must have unique keys: keep newest per key
        keep = np.ones(n, bool)
        keep[1:] = np.any(keys_np[1:] != keys_np[:-1], axis=-1)
        keys_np, vals_np = keys_np[keep], vals_np[keep]
        seq_np, tomb_np = seq_np[keep], tomb_np[keep]
    return Run(
        keys=as_words(keys_np, device),
        vals=as_words(vals_np, device),
        seq=as_words(seq_np, device),
        tomb=torch.from_numpy(np.ascontiguousarray(tomb_np)).to(device),
    )


@dataclasses.dataclass(frozen=True)
class RunSet:
    """R runs stacked into padded (R, Nmax, ...) tensors for vector gathers."""

    keys: torch.Tensor  # (R, Nmax, KW) int32 words, padded with +inf sentinel
    vals: torch.Tensor  # (R, Nmax, VW) int32 words
    seq: torch.Tensor  # (R, Nmax) int32 words
    tomb: torch.Tensor  # (R, Nmax) bool
    lens: torch.Tensor  # (R,) int32 true lengths

    @property
    def r(self) -> int:
        return self.keys.shape[0]

    @property
    def nmax(self) -> int:
        return self.keys.shape[1]

    @property
    def kw(self) -> int:
        return self.keys.shape[2]

    @property
    def vw(self) -> int:
        return self.vals.shape[2]

    def total(self) -> int:
        return int(self.lens.sum())

    def gather(self, run_idx: torch.Tensor, pos: torch.Tensor):
        """Fetch (keys, vals, seq, tomb) at (run, pos); any batch shape.

        Clamps run and position into range, as the reference does: torch
        indexing out of range raises on the CPU and asserts on the card.
        """
        run_idx = run_idx.clamp(0, self.r - 1)
        pos = pos.clamp(0, self.nmax - 1)
        return (
            self.keys[run_idx, pos],
            self.vals[run_idx, pos],
            self.seq[run_idx, pos],
            self.tomb[run_idx, pos],
        )


def runset_from_arrays(keys, vals, seq, tomb, lens, device="cuda") -> RunSet:
    """A RunSet from the numpy arrays of a reference ``RunSet``'s fields."""
    device = resolve(device)
    return RunSet(
        keys=as_words(keys, device),
        vals=as_words(vals, device),
        seq=as_words(seq, device),
        tomb=torch.from_numpy(np.array(tomb, bool)).to(device),
        lens=torch.from_numpy(np.array(lens, np.int32)).to(device),
    )


def merge_ranges_np(
    los: np.ndarray, his: np.ndarray, gap: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized [lo, hi) range coalescing: sort, drop empties, fuse
    overlaps and gaps of at most ``gap`` rows. The planning step before
    a batched fetch — each merged range becomes one contiguous read, so
    a query batch touching interleaved windows never fetches a row (or
    the block containing it) twice. Returns (mlos, mhis) arrays."""
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    live = his > los
    los, his = los[live], his[live]
    if len(los) == 0:
        return los, his
    order = np.argsort(los, kind="stable")
    los, his = los[order], his[order]
    hmax = np.maximum.accumulate(his)
    head = np.empty(len(los), bool)
    head[0] = True
    head[1:] = los[1:] > hmax[:-1] + gap
    starts = np.flatnonzero(head)
    return los[starts], np.maximum.reduceat(his, starts)


def merge_ranges(
    ranges: Sequence[tuple[int, int]], gap: int = 0
) -> list[tuple[int, int]]:
    """List-of-tuples convenience wrapper around :func:`merge_ranges_np`."""
    if not ranges:
        return []
    arr = np.asarray(ranges, np.int64).reshape(-1, 2)
    mlo, mhi = merge_ranges_np(arr[:, 0], arr[:, 1], gap=gap)
    return list(zip(mlo.tolist(), mhi.tolist()))


def ranges_to_rows(los: np.ndarray, his: np.ndarray) -> np.ndarray:
    """Expand disjoint sorted [lo, hi) ranges into one flat ascending row
    array — the vectorized equivalent of concatenating per-range
    ``np.arange`` calls."""
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    lens = his - los
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    start_of = np.repeat(np.cumsum(lens) - lens, lens)
    return np.arange(total, dtype=np.int64) - start_of + np.repeat(los, lens)


@dataclasses.dataclass
class RowWindow:
    """Host rows of one run covering a coalesced set of row ranges.

    The cold-scan materialization primitive: instead of loading whole
    tables, a scan names the row ranges its window emits — a scalar scan
    one contiguous range per run, a query batch many interleaved ones —
    ``from_ranges``/``from_scattered`` fuse them (``merge_ranges``) and
    fetch each merged range once, and :meth:`gather` then answers any
    (absolute row) subset with a vectorized lookup. ``keys`` are stored
    unpacked (u64) since scan callers compare/emit u64 keys.
    """

    rows: np.ndarray  # (M,) int64 absolute rows, sorted ascending
    keys: np.ndarray  # (M,) uint64
    vals: np.ndarray  # (M, VW) uint32
    tomb: np.ndarray  # (M,) bool

    @classmethod
    def empty(cls, vw: int = 1) -> "RowWindow":
        """A window covering no rows (``gather`` must not be called)."""
        return cls(
            rows=np.zeros(0, np.int64),
            keys=np.zeros(0, np.uint64),
            vals=np.zeros((0, vw), np.uint32),
            tomb=np.zeros(0, bool),
        )

    @classmethod
    def from_ranges(cls, ranges, fetch_rows, gap: int = 0) -> "RowWindow":
        """``fetch_rows(section, lo, hi)`` pulls rows of one section."""
        merged = merge_ranges(ranges, gap=gap)
        if not merged:
            return cls.empty()
        rows, keys, vals, tomb = [], [], [], []
        for lo, hi in merged:
            rows.append(np.arange(lo, hi, dtype=np.int64))
            keys.append(K.unpack_u64(fetch_rows("keys", lo, hi)))
            vals.append(fetch_rows("vals", lo, hi))
            tomb.append(fetch_rows("tomb", lo, hi))
        return cls(
            rows=np.concatenate(rows),
            keys=np.concatenate(keys),
            vals=np.concatenate(vals),
            tomb=np.concatenate(tomb),
        )

    @classmethod
    def from_scattered(cls, ranges, fetch_scattered, gap: int = 0
                       ) -> "RowWindow":
        """Like :meth:`from_ranges` but with one scattered fetch per
        section for the whole merged range set —
        ``fetch_scattered(section, rows)`` pulls arbitrary rows with
        block-level dedupe. The batch-path constructor: three fetches
        total instead of three per merged range."""
        merged = merge_ranges(ranges, gap=gap)
        if not merged:
            return cls.empty()
        arr = np.asarray(merged, np.int64)
        rows = ranges_to_rows(arr[:, 0], arr[:, 1])
        return cls(
            rows=rows,
            keys=K.unpack_u64(fetch_scattered("keys", rows)),
            vals=fetch_scattered("vals", rows),
            tomb=fetch_scattered("tomb", rows),
        )

    def gather(self, want: np.ndarray):
        """(keys u64, vals, tomb) at absolute rows ``want`` (all of which
        must lie inside the fetched ranges)."""
        idx = np.searchsorted(self.rows, np.asarray(want, np.int64))
        return self.keys[idx], self.vals[idx], self.tomb[idx]


def stack_runs(runs: Sequence[Run]) -> RunSet:
    """Stack runs into one padded RunSet on the runs' device."""
    if not runs:
        raise ValueError("stack_runs needs at least one run")
    kw, vw = runs[0].kw, runs[0].vw
    dev = runs[0].keys.device
    nmax = max(1, max(r.n for r in runs))
    r = len(runs)
    keys = torch.full((r, nmax, kw), K.INF_WORD, dtype=torch.int32, device=dev)
    vals = torch.zeros((r, nmax, vw), dtype=torch.int32, device=dev)
    seq = torch.zeros((r, nmax), dtype=torch.int32, device=dev)
    tomb = torch.zeros((r, nmax), dtype=torch.bool, device=dev)
    lens = np.zeros((r,), np.int32)
    for i, run in enumerate(runs):
        n = run.n
        lens[i] = n
        if n:
            keys[i, :n] = run.keys
            vals[i, :n] = run.vals
            seq[i, :n] = run.seq
            tomb[i, :n] = run.tomb
    return RunSet(
        keys=keys, vals=vals, seq=seq, tomb=tomb,
        lens=torch.from_numpy(lens).to(dev),
    )
