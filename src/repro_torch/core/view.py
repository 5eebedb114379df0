"""Sorted-view construction (paper §3.1, §4.1 versioning rules).

Builds the global sorted view over a set of sorted runs on the host (view
construction happens at compaction time, off the query path):

- entries ordered by (key asc, seq desc): versions of a key newest → oldest;
- the newest version of each key gets the selector high bit (0x80);
- the view is laid out in groups of D slots; if a multi-version key sequence
  would straddle a group boundary (leaving an old version at a group head),
  placeholder selectors (127) pad the previous group so the whole sequence
  moves to the next group — this keeps every anchor key a newest version.

Requires D >= R (a key has at most one version per run, so a version cluster
always fits in one group), as in the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import keys as K

PLACEHOLDER = 127  # 0x7f
NEWEST_BIT = 0x80


@dataclasses.dataclass(frozen=True)
class ViewLayout:
    """Host-side description of the laid-out sorted view."""

    sel: np.ndarray  # (n_slots,) uint8: run id | NEWEST_BIT, or PLACEHOLDER
    entry_run: np.ndarray  # (n_slots,) int32 run of each slot (-1 = pad)
    entry_pos: np.ndarray  # (n_slots,) int32 in-run position (-1 = pad)
    n_entries: int  # real (non-placeholder) entries
    d: int  # group size

    @property
    def n_slots(self) -> int:
        return self.sel.shape[0]

    @property
    def n_groups(self) -> int:
        return self.n_slots // self.d


def _merge_order(run_keys, run_seqs):
    """Global (key asc, seq desc) order over all runs' entries.

    Returns (runid, pos, keys_sorted, newest) host arrays.
    """
    all_keys = np.concatenate(run_keys, axis=0)
    all_seq = np.concatenate(run_seqs, axis=0)
    runid = np.concatenate(
        [np.full(k.shape[0], i, np.int32) for i, k in enumerate(run_keys)]
    )
    pos = np.concatenate(
        [np.arange(k.shape[0], dtype=np.int32) for k in run_keys]
    )
    order = K.sort_indices_np(all_keys, all_seq)
    keys_sorted = all_keys[order]
    newest = np.ones(order.shape[0], bool)
    if order.shape[0] > 1:
        newest[1:] = np.any(keys_sorted[1:] != keys_sorted[:-1], axis=-1)
    return runid[order], pos[order], keys_sorted, newest


def _layout_groups(newest: np.ndarray, d: int) -> np.ndarray:
    """Slot index for each view entry, inserting placeholder padding.

    Padding rule: a version cluster (newest entry + its following old
    versions) that would straddle a group boundary is pushed to the next
    group. Returns (n_entries,) int64 slot positions.

    Fast path: all entries newest (unique keys) → identity layout.
    """
    n = newest.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    if newest.all():
        return np.arange(n, dtype=np.int64)
    starts = np.flatnonzero(newest)  # cluster starts
    sizes = np.diff(np.append(starts, n))
    if int(sizes.max()) > d:
        raise ValueError(
            f"version cluster of size {int(sizes.max())} exceeds group size {d}"
        )
    # Greedy word-wrap over clusters. Singleton spans between fat clusters
    # are bulk-placed; only fat (size>1) clusters need the boundary check.
    slot_of_cluster = np.zeros(starts.shape[0], np.int64)
    cur = 0
    fat = np.flatnonzero(sizes > 1)
    prev_cluster = 0
    for fi in fat:
        # singleton span [prev_cluster, fi): contiguous placement
        span = int(fi - prev_cluster)
        if span:
            slot_of_cluster[prev_cluster:fi] = cur + np.arange(span)
            cur += span
        rem = (-cur) % d  # free slots left in current group (0 => at head)
        if rem and int(sizes[fi]) > rem:
            cur += rem  # pad with placeholders to the next group head
        slot_of_cluster[fi] = cur
        cur += int(sizes[fi])
        prev_cluster = fi + 1
    span = starts.shape[0] - prev_cluster
    if span:
        slot_of_cluster[prev_cluster:] = cur + np.arange(span)
    # expand cluster slots to entry slots
    cluster_of_entry = np.cumsum(newest) - 1
    within = np.arange(n, dtype=np.int64) - starts[cluster_of_entry]
    return slot_of_cluster[cluster_of_entry] + within


def layout_from_order(
    runid: np.ndarray, pos: np.ndarray, newest: np.ndarray, d: int
) -> ViewLayout:
    """Lay out a precomputed (key asc, seq desc) merge order into groups.

    ``runid``/``pos``/``newest`` are parallel arrays over the merged
    entries in view order. This is the sort-free half of
    :func:`build_view`; the incremental REMIX rebuild
    (:mod:`repro_torch.io.rebuild`) calls it with an order recovered from an old
    REMIX's selector stream instead of a fresh global sort.
    """
    runid = np.asarray(runid, np.int32)
    pos = np.asarray(pos, np.int32)
    newest = np.asarray(newest, bool)
    slots = _layout_groups(newest, d)
    n_slots_used = int(slots[-1]) + 1 if slots.shape[0] else 0
    n_slots = max(d, ((n_slots_used + d - 1) // d) * d)
    sel = np.full((n_slots,), PLACEHOLDER, np.uint8)
    entry_run = np.full((n_slots,), -1, np.int32)
    entry_pos = np.full((n_slots,), -1, np.int32)
    sel[slots] = runid.astype(np.uint8) | (
        newest.astype(np.uint8) << 7
    )
    entry_run[slots] = runid
    entry_pos[slots] = pos
    return ViewLayout(
        sel=sel,
        entry_run=entry_run,
        entry_pos=entry_pos,
        n_entries=int(runid.shape[0]),
        d=d,
    )


def build_view(run_keys, run_seqs, d: int) -> ViewLayout:
    """Construct the sorted-view layout for runs given as host arrays.

    ``run_keys``: list of (Ni, KW) uint32; ``run_seqs``: list of (Ni,) uint32.
    """
    r = len(run_keys)
    if d < r:
        raise ValueError(f"group size D={d} must be >= number of runs R={r}")
    runid, pos, _, newest = _merge_order(run_keys, run_seqs)
    return layout_from_order(runid, pos, newest, d)
