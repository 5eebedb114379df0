"""Incremental REMIX rebuild from CKBs + the old REMIX (Snippet 1, §4.2).

A minor compaction appends new table files to a partition and leaves the
existing ones untouched. The old REMIX's selector stream already encodes
the merge order of the old runs, so the new sorted view can be built by

  1. decoding the old selectors into the old runs' (run, pos) sequence —
     zero key comparisons between old runs;
  2. merging the new runs' keys among themselves (new data only);
  3. interleaving the two ordered streams with one binary search of the
     new keys into the old key stream (ties: new first, since LSM sequence
     numbers of a key are strictly increasing across flushes).

Keys come from the tables' Compressed Keys Blocks, so the rebuild reads
the old REMIX and the CKBs and never touches a value block — the 2x
random-write throughput optimization of the reference implementation.
The rebuild runs on the host in numpy; the new index lands on the old
one's device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.remix import Remix, remix_from_order
from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER, _merge_order


def decode_selector_order(
    selectors: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover (runid, pos, newest) of the real entries, in view order.

    A selector stores ``run | NEWEST_BIT`` (or PLACEHOLDER for padding)
    and entries of one run appear in run order, so the in-run position is
    just the running occurrence count of each run id.
    """
    sel = np.asarray(selectors, np.uint8)
    real = sel != PLACEHOLDER
    packed = sel[real]
    runid = (packed & (NEWEST_BIT - 1)).astype(np.int32)
    newest = (packed & NEWEST_BIT) != 0
    pos = np.zeros(runid.shape[0], np.int32)
    for r in np.unique(runid):
        m = runid == r
        pos[m] = np.arange(int(m.sum()), dtype=np.int32)
    return runid, pos, newest


def _rank(keys: np.ndarray) -> np.ndarray:
    """Map (N, KW) uint32 keys to a 1-D array with the same ordering."""
    keys = np.asarray(keys, np.uint32)
    kw = keys.shape[1]
    if kw == 1:
        return keys[:, 0]
    if kw == 2:
        return (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[
            :, 1
        ].astype(np.uint64)
    # arbitrary width: big-endian bytes compare lexicographically
    raw = np.ascontiguousarray(keys.astype(">u4")).view(np.uint8)
    raw = raw.reshape(keys.shape[0], kw * 4)
    return np.array([r.tobytes() for r in raw], object)


def incremental_build_remix(
    old_remix: Remix,
    old_run_keys: Sequence[np.ndarray],
    new_run_keys: Sequence[np.ndarray],
    new_run_seqs: Sequence[np.ndarray],
    d: int,
) -> Remix:
    """Build the REMIX over ``old runs + new runs`` without sorting old keys.

    ``old_run_keys``: each old run's (Ni, KW) uint32 keys (typically CKB
    decodes), in the same run order the old REMIX was built with.
    ``new_run_keys``/``new_run_seqs``: the freshly written runs. Returns a
    Remix bit-identical to ``build_remix`` over all runs from scratch.
    """
    r_old = len(old_run_keys)
    if r_old == 0 or len(new_run_keys) == 0:
        raise ValueError("incremental rebuild needs >=1 old and >=1 new run")
    o_run, o_pos, _ = decode_selector_order(old_remix.selectors.cpu().numpy())
    # old stream keys, already in (key asc, seq desc) order
    ranks = [_rank(np.asarray(k, np.uint32)) for k in old_run_keys]
    o_rank = np.empty(o_run.shape[0], ranks[0].dtype)
    for r in range(r_old):
        m = o_run == r
        if m.any():
            o_rank[m] = ranks[r][o_pos[m]]
    # new stream: merge the new runs among themselves (key asc, seq desc)
    n_run, n_pos, n_keys_sorted, _ = _merge_order(
        [np.asarray(k, np.uint32) for k in new_run_keys],
        [np.asarray(s, np.uint32) for s in new_run_seqs],
    )
    n_rank = _rank(n_keys_sorted)
    # interleave: every new entry goes before old entries of equal key
    # (its seq is strictly newer), i.e. insertion point side='left'
    ins = np.searchsorted(o_rank, n_rank, side="left")
    n_total = o_rank.shape[0] + n_rank.shape[0]
    new_final = ins + np.arange(n_rank.shape[0])
    old_final = np.delete(np.arange(n_total), new_final)
    runid = np.zeros(n_total, np.int32)
    pos = np.zeros(n_total, np.int32)
    rank = np.empty(n_total, o_rank.dtype if o_rank.shape[0] else n_rank.dtype)
    runid[old_final] = o_run
    pos[old_final] = o_pos
    rank[old_final] = o_rank
    runid[new_final] = n_run + r_old
    pos[new_final] = n_pos
    rank[new_final] = n_rank
    newest = np.ones(n_total, bool)
    if n_total > 1:
        newest[1:] = rank[1:] != rank[:-1]
    all_keys = [np.asarray(k, np.uint32) for k in old_run_keys] + [
        np.asarray(k, np.uint32) for k in new_run_keys
    ]
    return remix_from_order(runid, pos, newest, all_keys, d,
                            device=old_remix.anchors.device)
