"""Distributed RemixDB: partitions sharded over the ranks of a process
group, queries routed with ``all_to_all_single``; plus the host-side range
routing that the store, its cursor and its executor share.

Each rank owns one key-range partition shard (runs + REMIX). A query batch
is routed by key range: sort-by-owner on the source rank, an all-to-all
exchanges query slices, every rank answers its slice with the batched
REMIX get, and a second all-to-all returns results. This is the paper's
partitioned store (§4) mapped onto the cards of one host (NCCL) or onto
CPU processes (gloo). Keys are range-partitioned by the high bits, so
routing is arithmetic, not a directory lookup.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.remix import Remix
from repro_torch.core.runs import RunSet


def route_host(lows, keys) -> np.ndarray:
    """Host-side range routing: owner index per key.

    ``lows`` are the sorted inclusive lower bounds of the ranges (the
    first covers everything below it too); one vectorized searchsorted
    routes a whole batch. This is the single routing primitive shared by
    ``RemixDB`` (partition routing in ``flush``/``get_batch``/
    ``scan_batch``) and ``the serving engine`` (shard routing), so a
    sharded batch is split with the same arithmetic at every level.
    """
    lows = np.asarray(lows, np.uint64)
    keys = np.asarray(keys, np.uint64)
    return np.maximum(np.searchsorted(lows, keys, side="right") - 1, 0)


def route_one(parts_or_lows, key: int) -> int:
    """Scalar :func:`route_host`: owning range index of one key.

    Accepts a sequence of partitions/shards (anything with ``.lo``) or
    raw lower bounds — the single routing rule shared by the store's
    point reads and the cursor's seek.
    """
    lows = [int(getattr(x, "lo", x)) for x in parts_or_lows]
    return max(0, bisect.bisect_right(lows, int(key)) - 1)


def partition_spans(lows) -> list[tuple[int, int]]:
    """``[lo, hi)`` key spans for sorted inclusive lower bounds.

    The companion of :func:`route_host`: each range's exclusive upper
    bound is the next range's lower bound (the last spans to 2**64).
    Shared by the store's scans and :class:`repro_torch.db.cursor.RemixCursor`
    so partition/shard boundaries are computed by one rule everywhere.
    Python ints, not uint64: the final bound 2**64 must be representable.
    """
    lows = [int(x) for x in lows]
    return list(zip(lows, lows[1:] + [1 << 64]))


def abstract_state(cfg, n_shards: int) -> tuple[dict, dict]:
    """Shapes and dtypes of the sharded store state, as plain
    ``{field: (shape, dtype name)}`` descriptions of the stacked
    (n_shards, ...) Remix and RunSet."""
    r, n, kw, vw, d = (
        cfg.runs_per_partition,
        cfg.entries_per_run,
        cfg.kw,
        cfg.vw,
        cfg.group_d,
    )
    slots = ((r * n + d - 1) // d + 1) * d  # view slots (+ padding slack)
    g = slots // d
    remix = dict(
        anchors=((n_shards, g, kw), "uint32"),
        cursors=((n_shards, g, r), "int32"),
        selectors=((n_shards, slots), "uint8"),
        n_entries=((n_shards,), "int32"),
    )
    runset = dict(
        keys=((n_shards, r, n, kw), "uint32"),
        vals=((n_shards, r, n, vw), "uint32"),
        seq=((n_shards, r, n), "uint32"),
        tomb=((n_shards, r, n), "bool"),
        lens=((n_shards, r), "int32"),
    )
    return remix, runset


def _owner_of(keys_words: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Range partitioning by high key bits: owner = hi_word / (2^32/S),
    on the unsigned high word of the int32 bit-view."""
    hi = keys_words[..., 0].to(torch.int64) & 0xFFFFFFFF
    step = max(1, (1 << 32) // n_shards)
    return torch.clamp(hi // step, max=n_shards - 1).to(torch.int32)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 to rank i; chunk j of the result from rank j."""
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def shard_axes(mesh) -> tuple[str, ...]:
    """All mesh axes — the store shards over the full device fabric."""
    return tuple(mesh.mesh_dim_names)


def shard_group(mesh):
    """The process group over every rank of ``mesh`` (its flattened mesh:
    rank order is row-major over :func:`shard_axes`, the reference's
    shard order)."""
    return (mesh if mesh.ndim == 1 else mesh._flatten()).get_group()


def make_sharded_get(cfg, group=None):
    """The distributed point-query step over ``group``: a process group,
    a ``DeviceMesh`` (its flattened group, :func:`shard_group`), or None
    for the default process group. Returns ``(step, n_shards)``.

    ``step(remix, runset, queries)`` takes this rank's shard and its slice
    (nq, KW) of the global query batch (rank i holds rows
    ``i * nq : (i + 1) * nq``) and returns (found (nq,), vals (nq, VW)).
    Each rank sends each owner at most ``cap = max(1, 2 * nq // n_shards)``
    queries; past that, queries are dropped (found False) as the
    reference's dispatch drops them: its scatter of the overflow into the
    last slot leaves that slot's query dropped too.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, DeviceMesh):
        group = shard_group(group)
    n_shards = dist.get_world_size(group)

    def step(remix: Remix, runset: RunSet, q_l: torch.Tensor):
        nq, kw = q_l.shape
        dev = q_l.device
        owner = _owner_of(q_l, n_shards)
        cap = max(1, 2 * nq // n_shards)
        order = torch.argsort(owner, stable=True)
        so, sq = owner[order].long(), q_l[order]
        # shapes stay static (no bincount, no boolean mask), so the step
        # also runs on fake tensors in the dry run
        counts = torch.zeros(n_shards, dtype=torch.long, device=dev)
        counts.index_add_(0, so, torch.ones_like(so))
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(nq, device=dev) - starts[so]
        ok = slot < cap
        col = torch.where(ok, slot, cap)  # overflow → a spare column, cut below
        out_q = torch.zeros((n_shards, cap + 1, kw), dtype=q_l.dtype, device=dev)
        filled = torch.zeros((n_shards, cap + 1), dtype=torch.uint8, device=dev)
        out_q[so, col] = sq
        filled[so, col] = 1
        # the reference scatters every overflow query into slot cap - 1
        # after the one that fits there, so its (zero) query wins
        over = (counts > cap)[:, None]
        out_q[:, cap - 1] = torch.where(over, 0, out_q[:, cap - 1])
        filled[:, cap - 1] = torch.where(over[:, 0], 0, filled[:, cap - 1])
        out_q, filled = out_q[:, :cap], filled[:, :cap]
        q_in = _all_to_all(out_q, group)  # (n_shards, cap, KW)
        f_in = _all_to_all(filled, group)
        found, vals = Q.get(remix, runset, q_in.reshape(-1, kw))
        found = (found.reshape(n_shards, cap) & (f_in != 0)).to(torch.uint8)
        vals = vals.reshape(n_shards, cap, -1)
        f_back = _all_to_all(found, group)
        v_back = _all_to_all(vals, group)
        slot_c = torch.clamp(slot, max=cap - 1)
        f_sorted = ok & (f_back[so, slot_c] != 0)
        v_sorted = torch.where(ok[:, None], v_back[so, slot_c], 0)
        f_out = torch.empty_like(f_sorted)
        v_out = torch.empty_like(v_sorted)
        f_out[order] = f_sorted
        v_out[order] = v_sorted
        return f_out, v_out

    return step, n_shards


def build_demo_state(cfg, n_shards: int, seed: int = 0, device="cuda"
                     ) -> list[tuple[Remix, RunSet]]:
    """Concrete sharded store, one ``(remix, runset)`` per shard; shard s
    covers the high words [s * 2^32 / n_shards, (s + 1) * 2^32 / n_shards).
    The same draws as the reference's, so each shard's arrays equal the
    reference's stacked state at index s."""
    from repro_torch.core.remix import build_remix
    from repro_torch.core.runs import make_run

    rng = np.random.default_rng(seed)
    shards = []
    span = (1 << 32) // n_shards
    for s in range(n_shards):
        runs = []
        lo = s * span << 32
        for r in range(cfg.runs_per_partition):
            kk = rng.choice(
                span * (1 << 6), size=cfg.entries_per_run, replace=False
            ).astype(np.uint64)
            kk = np.uint64(lo) + (kk << np.uint64(26))  # stay in shard range
            runs.append(make_run(np.sort(kk), seq=r, vw=cfg.vw, device=device))
        shards.append(build_remix(runs, d=cfg.group_d))
    return shards
