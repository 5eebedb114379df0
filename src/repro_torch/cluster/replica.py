"""Read replicas and shard followers over the version set.

A follower is born from :func:`repro_torch.cluster.ship.ship_snapshot` and then
tracks the source incrementally: each :meth:`ShardFollower.catch_up`
round asks the primary for an atomic ``(state, records, version)``
capture (:meth:`repro_torch.db.store.RemixDB.replication_snapshot`).

- Steady state (manifest version unchanged): the delta is just the WAL
  tail past the follower's sequence horizon — ``WAL.read_from`` skips
  whole blocks by their persisted ``max_seq``, so a quiet primary costs
  O(written blocks) metadata scans and zero record decodes.
- Across a primary flush/compaction (version changed): a manifest diff
  degenerates to "fetch the files we don't have" (tables are immutable),
  then :meth:`RemixDB.adopt_version` swaps in the new file set and
  rebuilds the overlay from the primary's live records — exactly the
  state the primary itself would recover to.

Followers never write their own WAL for replicated records: the primary
is the durability root, and a restarted follower re-catches-up.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.cluster.ship import (KEY_SPACE, clip_records, fetch_files,
                                ship_snapshot, subset_state)


class ShardFollower:
    """A store tracking one source shard's key span ``[lo, hi)``.

    Construction ships an initial snapshot into ``dst_dir`` and opens it;
    :meth:`catch_up` converges toward the primary. Used both as the
    catch-up phase of a live shard split (span-restricted) and as the
    base of a full-range :class:`Replica`.
    """

    def __init__(self, src, dst_dir: str, lo: int = 0, hi: int | None = None,
                 config=None, io=None, registry=None, events=None):
        from repro_torch.db.store import RemixDB

        self.src = src
        self.lo = int(lo)
        self.hi = KEY_SPACE if hi is None else int(hi)
        self.io = src.io if io is None else io
        self.events = src.events if events is None else events
        self.report = ship_snapshot(src, dst_dir, lo=self.lo, hi=self.hi,
                                    io=self.io, registry=registry,
                                    events=self.events)
        if config is None:
            config = dataclasses.replace(
                src.cfg, data_dir=dst_dir, block_cache=None, registry=None,
                fault_plan=None, background_compaction=False,
                scrub_interval_s=0.0,
            )
        else:
            config = dataclasses.replace(config, data_dir=dst_dir)
        self.db = RemixDB(config)
        # force the first catch_up through the full adopt path: the ship
        # came from a pinned snapshot, which need not match any committed
        # manifest version of the source
        self._version: int | None = None
        reg = registry if registry is not None else self.db.registry
        self._c_seqs = reg.counter("replica_catchup_seqs")
        self._c_files = reg.counter("replica_catchup_files")
        self._c_rounds = reg.counter("replica_catchup_rounds")

    # -------------- catch-up --------------
    def seq_lag(self) -> int:
        """Sequence distance behind the primary (0 = fully caught up)."""
        return max(0, int(self.src.seq) - int(self.db.seq))

    def catch_up(self) -> dict:
        """One convergence round; returns a report dict.

        ``from_seq`` is the follower's horizon minus one: ``read_from``
        yields records strictly above the floor, and ``db.seq`` is
        one past the last applied record.
        """
        state, records, version = self.src.replication_snapshot(
            from_seq=max(0, int(self.db.seq) - 1), version=self._version)
        advance = None
        if records:
            advance = max(int(r[1]) for r in records) + 1
        if self.lo > 0 or self.hi < KEY_SPACE:
            records = clip_records(records, self.lo, self.hi)
        files = nbytes = 0
        if state is None and self._version is not None:
            applied = self.db.apply_replication(records, advance_to=advance)
        else:
            if state is not None:
                sub = subset_state(state, self.lo, self.hi)
                files, nbytes = fetch_files(sub, self.src.storage,
                                            self.db.storage, io=self.io)
                self.db.adopt_version(sub, records, advance_to=advance)
                applied = len(records)
            else:
                # source has never committed a manifest: everything it
                # has lives in its WAL, and the tail from 0 covers it
                applied = self.db.apply_replication(
                    records, advance_to=advance)
        self._version = version
        self._c_rounds.inc()
        self._c_seqs.inc(applied)
        self._c_files.inc(files)
        lag = self.seq_lag()
        self.events.emit("replica_catchup",
                         dst=os.path.basename(
                             str(self.db.cfg.data_dir).rstrip("/")),
                         applied=applied, files=files, bytes=nbytes,
                         version=version, lag=lag)
        return dict(applied=applied, files=files, bytes=nbytes,
                    version=version, lag=lag)

    def catch_up_until(self, lag_target: int = 0, max_rounds: int = 32
                       ) -> dict:
        """Repeat :meth:`catch_up` until ``seq_lag() <= lag_target`` (or
        the round budget runs out — a live primary can outrun any finite
        number of rounds; the cluster layer gates writers for the final
        round). Returns the last round's report."""
        report = dict(applied=0, files=0, bytes=0, version=self._version,
                      lag=self.seq_lag())
        for _ in range(max_rounds):
            report = self.catch_up()
            if report["lag"] <= lag_target:
                break
        return report

    def close(self) -> None:
        self.db.close()


class Replica(ShardFollower):
    """A full-range read replica of one shard.

    Serves pinned-Version reads from its own store while lagging the
    primary by ``replica_seq_lag`` sequence numbers (exported as a gauge
    on the follower's registry). Reads go through the normal store read
    path, so a replica sees exactly what the primary would have served
    at the replica's horizon.
    """

    def __init__(self, src, dst_dir: str, config=None, io=None,
                 registry=None, events=None):
        super().__init__(src, dst_dir, lo=0, hi=None, config=config,
                         io=io, registry=registry, events=events)
        reg = registry if registry is not None else self.db.registry
        reg.gauge("replica_seq_lag", fn=self.seq_lag,
                  replica=os.path.basename(str(dst_dir).rstrip("/")))

    # -------------- reads --------------
    def get(self, key):
        return self.db.get(key)

    def get_batch(self, keys):
        return self.db.get_batch(keys)

    def scan(self, start, n):
        return self.db.scan(start, n)

    def snapshot(self):
        return self.db.snapshot()
