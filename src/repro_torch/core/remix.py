"""The REMIX index data structure (paper §3.1) and its construction.

A :class:`Remix` persists, per group of D sorted-view slots:
  - ``anchors``     (G, KW)  smallest (newest-version) key of the group,
  - ``cursors``     (G, R)   per-run cursor offsets at the group head,
  - ``selectors``   (G*D,)   uint8 run selectors (| 0x80 newest, 127 pad).

Construction runs on the host at compaction time (numpy); the arrays then
live on the index's device as torch tensors, anchors as int32 bit-views of
their uint32 words. Query paths are in :mod:`repro_torch.core.query` and,
through the CUDA kernels, :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import keys as K
from repro_torch.core import view as V
from repro_torch.core.runs import Run, RunSet, stack_runs
from repro_torch.device import as_words, resolve, u32_np


@dataclasses.dataclass(frozen=True)
class Remix:
    anchors: torch.Tensor  # (G, KW) int32 words
    cursors: torch.Tensor  # (G, R) int32
    selectors: torch.Tensor  # (G*D,) uint8
    n_entries: int  # real entries in the view
    d: int

    @property
    def g(self) -> int:
        return self.anchors.shape[0]

    @property
    def r(self) -> int:
        return self.cursors.shape[1]

    @property
    def n_slots(self) -> int:
        return self.selectors.shape[0]

    def storage_bytes(self, anchor_key_bytes: float | None = None) -> float:
        """Serialized size per paper §3.4: anchors + S*R cursors + 1B selectors.

        ``anchor_key_bytes`` overrides the per-anchor key size (e.g. the
        average user key length of a workload); defaults to KW*4.
        """
        akb = 4 * self.anchors.shape[1] if anchor_key_bytes is None else anchor_key_bytes
        s = 4  # cursor offset size (paper: 16-bit blk + 8-bit key ≈ 4 B impl)
        return self.g * (akb + s * self.r) + self.n_slots * 1


def build_remix(runs: Sequence[Run], d: int = 32) -> tuple[Remix, RunSet]:
    """Build a REMIX over ``runs``; returns (index, stacked run set).

    The index lands on the runs' device."""
    runset = stack_runs(list(runs))
    run_keys = [u32_np(r.keys) for r in runs]
    run_seqs = [u32_np(r.seq) for r in runs]
    layout = V.build_view(run_keys, run_seqs, d)
    return (
        _remix_from_layout(layout, run_keys, len(runs), runset.keys.device),
        runset,
    )


def remix_from_order(
    runid: np.ndarray,
    pos: np.ndarray,
    newest: np.ndarray,
    run_keys: Sequence[np.ndarray],
    d: int,
    device="cuda",
) -> Remix:
    """Build a Remix from a precomputed (key asc, seq desc) merge order.

    Skips the global sort of :func:`build_remix`: callers that already
    know the merged order — e.g. the incremental rebuild that recovers it
    from an old REMIX's selector stream plus the new runs (§4.2,
    Snippet 1) — pay only the group layout cost. ``run_keys`` must list
    every run's (Ni, KW) uint32 keys in run-id order.
    """
    device = resolve(device)
    if d < len(run_keys):
        raise ValueError(
            f"group size D={d} must be >= number of runs R={len(run_keys)}"
        )
    layout = V.layout_from_order(runid, pos, newest, d)
    return _remix_from_layout(layout, [np.asarray(k) for k in run_keys],
                              len(run_keys), device)


def remix_from_arrays(anchors, cursors, selectors, n_entries, d: int,
                      device="cuda") -> Remix:
    """A Remix from the numpy arrays of a reference ``Remix``'s fields."""
    device = resolve(device)
    return Remix(
        anchors=as_words(anchors, device),
        cursors=torch.from_numpy(np.array(cursors, np.int32)).to(device),
        selectors=torch.from_numpy(np.array(selectors, np.uint8)).to(device),
        n_entries=int(n_entries),
        d=int(d),
    )


def _remix_from_layout(
    layout: V.ViewLayout, run_keys, r: int, device
) -> Remix:
    d = layout.d
    g = layout.n_groups
    kw = run_keys[0].shape[1] if run_keys else K.KW
    group_starts = np.arange(g, dtype=np.int64) * d

    # cursor offsets: #entries of run r placed in slots < group start
    cursors = np.zeros((g, r), np.int32)
    for run in range(r):
        slots_r = np.flatnonzero(layout.entry_run == run)  # ascending
        cursors[:, run] = np.searchsorted(slots_r, group_starts, side="left")

    # anchor = key at the group's first slot; a group head is never a
    # placeholder (padding only fills group tails). Trailing fully-padded
    # groups (possible when the view is tiny) get the +inf sentinel.
    anchors = np.full((g, kw), K.UINT32_MAX, np.uint32)
    head_run = layout.entry_run[group_starts]
    head_pos = layout.entry_pos[group_starts]
    for run in range(r):
        m = head_run == run
        if m.any():
            anchors[m] = np.asarray(run_keys[run], np.uint32)[head_pos[m]]

    return Remix(
        anchors=as_words(anchors, device),
        cursors=torch.from_numpy(cursors).to(device),
        selectors=torch.from_numpy(layout.sel.copy()).to(device),
        n_entries=int(layout.n_entries),
        d=d,
    )
