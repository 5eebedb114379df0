"""Cluster tier: a fleet of RemixDB range shards behind one routing table.

Carried from ``repro.cluster`` with the port's imports; each shard is a
:class:`repro_torch.db.store.RemixDB` on its config's device (the card
by default), with its own device views and budget.

The manifest + immutable-Version machinery makes a shard a *portable set
of files*; this package turns that into distribution primitives:

- :func:`ship.ship_snapshot` — copy a pinned Version's tables/REMIX files
  plus the WAL horizon into a fresh store directory (zero data rewrite;
  bit-identical reads).
- :class:`replica.ShardFollower` / :class:`replica.Replica` — serve a
  pinned Version and catch up by manifest-diff (fetch only new files) +
  WAL tail replay (``WAL.read_from``), staleness exposed as a gauge.
- :class:`cluster.Cluster` — an in-process fleet with live shard
  split/merge under traffic (gated routing-table swap, zero failed ops)
  and a load-driven placement loop (:mod:`placement`).
"""
from repro_torch.cluster.cluster import Cluster
from repro_torch.cluster.placement import pick_split
from repro_torch.cluster.replica import Replica, ShardFollower
from repro_torch.cluster.ship import clip_records, fetch_files, ship_snapshot

__all__ = [
    "Cluster",
    "Replica",
    "ShardFollower",
    "clip_records",
    "fetch_files",
    "pick_split",
    "ship_snapshot",
]
