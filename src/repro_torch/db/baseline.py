"""Baseline LSM stores: leveled (LevelDB-like) and tiered (PebblesDB-like).

Same MemTable + Table machinery as RemixDB, but queries run through the
merging iterator over all overlapping sorted runs (plus optional bloom
filters for point queries) — the configurations the paper compares against
(§5.2). Write amplification is tracked identically for the fig-16 bench.

The runs live on ``BaselineConfig.device``. A batched scan over a non-empty
memtable answers every start as :meth:`_LSMBase.scan` does, from one
batched merging-iterator call at the scan's width instead of one call per
start; the answers are the same.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from repro_torch.core import keys as CK
from repro_torch.core import merge_iter as M
from repro_torch.core.bloom import bloom_maybe_contains, build_bloom  # noqa: F401
from repro_torch.core.runs import make_run, stack_runs
from repro_torch.db.memtable import MemTable
from repro_torch.db.partition import Table, chunk_table, merge_tables  # noqa: F401
from repro_torch.device import as_words, resolve, u32_np


@dataclasses.dataclass
class BaselineConfig:
    vw: int = 2
    memtable_entries: int = 1 << 18
    table_cap: int = 65536
    l0_limit: int = 4  # L0 run count triggering compaction into L1
    level_ratio: int = 10  # leveled: size ratio between adjacent levels
    tier_t: int = 4  # tiered: runs per level before merge (ScyllaDB T=4)
    use_bloom: bool = True
    device: str = "cuda"  # where the runs and blooms live


def _empty_table(vw: int) -> Table:
    return Table(
        keys=np.zeros(0, np.uint64),
        vals=np.zeros((0, vw), np.uint32),
        seq=np.zeros(0, np.uint32),
        tomb=np.zeros(0, bool),
    )


class _LSMBase:
    def __init__(self, cfg: BaselineConfig | None = None):
        self.cfg = cfg or BaselineConfig()
        self.device = resolve(self.cfg.device)
        self.mem = MemTable(vw=self.cfg.vw)
        self.seq = 1
        self.user_bytes = 0
        self.table_bytes_written = 0
        self._runset_cache = None

    def put_batch(self, keys, vals):
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.uint32).reshape(len(keys), self.cfg.vw)
        self.seq = self.mem.put_batch(keys, vals, self.seq)
        self.user_bytes += len(keys) * (8 + 4 * self.cfg.vw)
        if len(self.mem) >= self.cfg.memtable_entries:
            self.flush()

    def put(self, key, val):
        self.put_batch([key], [val])

    def _mem_to_table(self) -> Table:
        keys, vals, seq, tomb, *_ = self.mem.to_arrays()
        self.mem = MemTable(vw=self.cfg.vw)
        return Table(keys=keys, vals=vals, seq=seq, tomb=tomb)

    # ---- query plumbing shared by both baselines ----
    def _sorted_runs(self) -> list[Table]:
        raise NotImplementedError

    def runset(self):
        if self._runset_cache is None:
            tables = self._sorted_runs() or [_empty_table(self.cfg.vw)]
            runs = [
                make_run(t.keys, t.vals, seq=t.seq, tomb=t.tomb, sort=False,
                         device=self.device)
                for t in tables
            ]
            rs = stack_runs(runs)
            blooms = (
                build_bloom([r.keys for r in runs], device=self.device)
                if self.cfg.use_bloom
                else None
            )
            self._runset_cache = (rs, blooms)
        return self._runset_cache

    def n_runs(self) -> int:
        return len(self._sorted_runs())

    def _queries(self, keys_u64: np.ndarray):
        return as_words(CK.pack_u64(keys_u64), self.device)

    def get_batch(self, keys):
        keys = np.asarray(keys, np.uint64)
        found = np.zeros(len(keys), bool)
        vals = np.zeros((len(keys), self.cfg.vw), np.uint32)
        rest = []
        for i, k in enumerate(keys.tolist()):
            e = self.mem.get(k)
            if e is not None:
                found[i] = not e.tomb
                vals[i] = e.val
            else:
                rest.append(i)
        if rest:
            rest = np.array(rest)
            rs, _ = self.runset()
            f, v = M.merge_get(rs, self._queries(keys[rest]))
            found[rest] = f.cpu().numpy()
            vals[rest] = u32_np(v)
        return found, vals

    def _scan_rows(self, starts: np.ndarray, n: int) -> list:
        """Per start, :meth:`scan`'s answer: the merging iterator's live
        keys over ``n + n // 2 + 8`` slots, overlaid with the memtable's
        entries up to the last of them (or all above the start when fewer
        than ``n`` came back), the first ``n`` live keys in order."""
        rs, _ = self.runset()
        keys, vals, valid = M.merge_scan(rs, self._queries(starts),
                                         width=n + n // 2 + 8)
        keys, vals, valid = u32_np(keys), u32_np(vals), valid.cpu().numpy()
        items = self.mem.sorted_items()
        mkeys = [k for k, _ in items]
        out = []
        for i, start_key in enumerate(starts.tolist()):
            kk = CK.unpack_u64(keys[i][valid[i]])
            merged: dict[int, np.ndarray | None] = {
                int(k): v for k, v in zip(kk, vals[i][valid[i]])
            }
            a = bisect.bisect_left(mkeys, start_key)
            b = (bisect.bisect_right(mkeys, int(kk[-1])) if len(kk) >= n
                 else len(mkeys))
            for k, e in items[a:b]:
                merged[k] = None if e.tomb else e.val
            got = sorted(
                ((k, v) for k, v in merged.items() if v is not None),
                key=lambda kv: kv[0],
            )[:n]
            if not got:
                out.append((np.zeros(0, np.uint64),
                            np.zeros((0, self.cfg.vw), np.uint32)))
            else:
                out.append((np.array([k for k, _ in got], np.uint64),
                            np.stack([v for _, v in got])))
        return out

    def scan(self, start_key: int, n: int):
        return self._scan_rows(np.array([start_key], np.uint64), n)[0]

    def scan_batch(self, starts, n: int):
        """Batched scans via the merging iterator (one batched call, and
        one more at :meth:`scan`'s width when the memtable holds data)."""
        starts = np.asarray(starts, np.uint64)
        rs, _ = self.runset()
        width = n + max(8, n // 2)
        keys, vals, valid = M.merge_scan(rs, self._queries(starts), width=width)
        keys = CK.unpack_u64(u32_np(keys))
        valid = valid.cpu().numpy()
        out_k = np.zeros((len(starts), n), np.uint64)
        out_m = np.zeros((len(starts), n), bool)
        for i in range(len(starts)):
            kk = keys[i][valid[i]][:n]
            out_k[i, : len(kk)] = kk
            out_m[i, : len(kk)] = True
        if len(self.mem):
            for i, (kk, _) in enumerate(self._scan_rows(starts, n)):
                out_k[i, : len(kk)] = kk[:n]
                out_m[i] = False
                out_m[i, : len(kk)] = True
        return out_k, out_m

    def write_amplification(self) -> float:
        return self.table_bytes_written / max(1, self.user_bytes)


class LeveledStore(_LSMBase):
    """Leveled compaction: L0 overlapping runs, L1.. single sorted runs."""

    def __init__(self, cfg: BaselineConfig | None = None):
        super().__init__(cfg)
        self.l0: list[Table] = []
        self.levels: list[Table] = []  # one merged run per level, L1..

    def _level_cap(self, i: int) -> int:
        return self.cfg.table_cap * 4 * (self.cfg.level_ratio ** i)

    def flush(self):
        t = self._mem_to_table()
        if t.n == 0:
            return
        self.table_bytes_written += t.bytes()
        self.l0.append(t)
        self._runset_cache = None
        if len(self.l0) >= self.cfg.l0_limit:
            self._compact_l0()

    def _compact_l0(self):
        inputs = self.l0 + ([self.levels[0]] if self.levels else [])
        merged = merge_tables(inputs, drop_tombs=len(self.levels) <= 1)
        self.table_bytes_written += merged.bytes()
        if self.levels:
            self.levels[0] = merged
        else:
            self.levels.append(merged)
        self.l0 = []
        # cascade: push overflowing levels down (each rewrite amplifies)
        i = 0
        while i < len(self.levels) and self.levels[i].n > self._level_cap(i + 1):
            if i + 1 >= len(self.levels):
                self.levels.append(self.levels[i])
            else:
                merged = merge_tables(
                    [self.levels[i], self.levels[i + 1]],
                    drop_tombs=(i + 2 >= len(self.levels)),
                )
                self.table_bytes_written += merged.bytes()
                self.levels[i + 1] = merged
            self.levels[i] = _empty_table(self.cfg.vw)
            i += 1
        self._runset_cache = None

    def _sorted_runs(self) -> list[Table]:
        return [t for t in self.l0 if t.n] + [
            t for t in self.levels if t is not None and t.n
        ]


class TieredStore(_LSMBase):
    """Tiered compaction: up to T overlapping runs per level (§2)."""

    def __init__(self, cfg: BaselineConfig | None = None):
        super().__init__(cfg)
        self.tiers: list[list[Table]] = [[]]

    def flush(self):
        t = self._mem_to_table()
        if t.n == 0:
            return
        self.table_bytes_written += t.bytes()
        self.tiers[0].append(t)
        self._runset_cache = None
        i = 0
        while i < len(self.tiers) and len(self.tiers[i]) >= self.cfg.tier_t:
            merged = merge_tables(
                self.tiers[i], drop_tombs=(i + 1 >= len(self.tiers))
            )
            self.table_bytes_written += merged.bytes()
            if i + 1 >= len(self.tiers):
                self.tiers.append([])
            self.tiers[i + 1].append(merged)
            self.tiers[i] = []
            i += 1

    def _sorted_runs(self) -> list[Table]:
        return [t for tier in self.tiers for t in tier if t.n]
