"""Key-range partitions: table files + one REMIX per partition (paper §4).

The in-memory part of the reference's partition module. Tables are host
numpy arrays; the partition builds its REMIX + stacked RunSet on the host
and keeps them as torch tensors on its device when first queried
(:meth:`Partition.index`, the plain engine's input) or when a device view
uploads it (:meth:`Partition.device_index`). File-backed tables, the cold
read path and the compaction helpers (``merge_tables``, ``chunk_table``,
``clone_with_tables``, ``persist_index``) come with the port's I/O and
store slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.core.remix import Remix, build_remix
from repro_torch.core.runs import RunSet, make_run, stack_runs
from repro_torch.core.view import PLACEHOLDER
from repro_torch.db import clock
from repro_torch.device import as_words, resolve
from repro_torch.io.rebuild import incremental_build_remix

def _pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _pad_index(remix: Remix, runset: RunSet, d: int) -> tuple[Remix, RunSet]:
    """Pad (G, R, Nmax) to power-of-two buckets on the index's device; query
    semantics unchanged (pad groups are all-placeholder with +inf anchors,
    pad runs are empty)."""
    g2 = _pow2(remix.g, 4)
    r2 = _pow2(remix.r, 1)
    n2 = _pow2(runset.nmax, 64)
    if (g2, r2, n2) == (remix.g, remix.r, runset.nmax):
        return remix, runset
    dev = remix.anchors.device
    i32 = dict(dtype=torch.int32, device=dev)
    anchors = torch.full((g2, runset.kw), CK.INF_WORD, **i32)
    anchors[: remix.g] = remix.anchors
    cursors = torch.zeros((g2, r2), **i32)
    cursors[: remix.g, : remix.r] = remix.cursors
    selectors = torch.full((g2 * d,), PLACEHOLDER, dtype=torch.uint8, device=dev)
    selectors[: remix.n_slots] = remix.selectors
    keys = torch.full((r2, n2, runset.kw), CK.INF_WORD, **i32)
    keys[: runset.r, : runset.nmax] = runset.keys
    vals = torch.zeros((r2, n2, runset.vw), **i32)
    vals[: runset.r, : runset.nmax] = runset.vals
    seq = torch.zeros((r2, n2), **i32)
    seq[: runset.r, : runset.nmax] = runset.seq
    tomb = torch.zeros((r2, n2), dtype=torch.bool, device=dev)
    tomb[: runset.r, : runset.nmax] = runset.tomb
    lens = torch.zeros((r2,), **i32)
    lens[: runset.r] = runset.lens
    return (
        Remix(anchors=anchors, cursors=cursors, selectors=selectors,
              n_entries=remix.n_entries, d=d),
        RunSet(keys=keys, vals=vals, seq=seq, tomb=tomb, lens=lens),
    )


class Table:
    """One immutable sorted table, held in memory as numpy arrays."""

    path = None  # file-backed tables arrive with the port's I/O slice

    def __init__(
        self,
        keys: np.ndarray | None = None,  # (N,) uint64 ascending, unique
        vals: np.ndarray | None = None,  # (N, VW) uint32
        seq: np.ndarray | None = None,  # (N,) uint32
        tomb: np.ndarray | None = None,  # (N,) bool
        path: str | None = None,
        exp: np.ndarray | None = None,  # (N,) uint32 TTL expiry (0 = none)
    ):
        if path is not None:
            raise NotImplementedError(
                "file-backed tables come with the port's I/O slice "
                "(io/sstable.py); pass in-memory arrays"
            )
        if keys is None:
            raise ValueError("Table needs in-memory arrays")
        self._keys, self._vals = keys, vals
        self._seq, self._tomb = seq, tomb
        self._exp = exp
        self._ttl_any: bool | None = None

    def __repr__(self) -> str:
        return f"Table(n={len(self._keys)})"

    @property
    def keys(self) -> np.ndarray:
        return self._keys

    @property
    def vals(self) -> np.ndarray:
        return self._vals

    @property
    def seq(self) -> np.ndarray:
        return self._seq

    @property
    def tomb(self) -> np.ndarray:
        return self._tomb

    @property
    def exp(self) -> np.ndarray:
        """(N,) uint32 absolute TTL expiries; zeros when none were set."""
        if self._exp is None:
            self._exp = np.zeros(self.n, np.uint32)
        return self._exp

    def ttl_present(self) -> bool:
        """Whether any row of this table carries a TTL."""
        if self._ttl_any is None:
            self._ttl_any = self._exp is not None and bool(np.any(self._exp))
        return self._ttl_any

    # ---- liveness (tombstone OR expired TTL) ----
    def dead(self, now: float | None = None) -> np.ndarray:
        """(N,) bool: rows hidden from reads — tombstones plus rows whose
        TTL expired as of ``now`` (defaults to ``clock.now()``)."""
        if not self.ttl_present():
            return self.tomb
        if now is None:
            now = clock.now()
        e = self.exp
        return self.tomb | ((e != 0) & (e <= np.uint32(int(now))))

    def min_future_exp(self, now: float) -> int | None:
        """Smallest TTL expiry still in the future, or None: the instant
        an index built at ``now`` goes stale."""
        if not self.ttl_present():
            return None
        e = self.exp
        fut = e[(e != 0) & (e > np.uint32(int(now)))]
        return int(fut.min()) if fut.size else None

    @property
    def n(self) -> int:
        return len(self._keys)

    @property
    def vw(self) -> int:
        return self._vals.shape[1]

    def key_words(self) -> np.ndarray:
        """(N, KW) uint32 key words for index builds."""
        return CK.pack_u64(self._keys)


@dataclasses.dataclass
class ExcisedSpan:
    """One committed range tombstone: every row with key in [lo, hi) of a
    *covered* table is dead, unconditionally.

    Coverage is by table identity: a span attaches at flush covering
    exactly the tables that existed then (all of whose seqs precede the
    delete's), so no seq comparison is ever needed on the read path —
    newer writes land in tables born later, which the span does not
    cover."""

    lo: int
    hi: int  # exclusive
    seq: int
    tables: tuple

    def __post_init__(self):
        self._ids = frozenset(id(t) for t in self.tables)

    def covers_table(self, t: Table) -> bool:
        return id(t) in self._ids

    def retain(self, tables: list[Table]) -> "ExcisedSpan":
        """The span restricted to the handles surviving in ``tables``."""
        kept = tuple(t for t in tables if id(t) in self._ids)
        return ExcisedSpan(self.lo, self.hi, self.seq, kept)


def _empty_table() -> Table:
    return Table(
        keys=np.zeros(0, np.uint64),
        vals=np.zeros((0, 2), np.uint32),
        seq=np.zeros(0, np.uint32),
        tomb=np.zeros(0, bool),
    )


class Partition:
    def __init__(self, lo: int, tables: list[Table] | None = None, d: int = 32,
                 device="cuda"):
        self.lo = int(lo)  # inclusive lower bound of the key range
        self.tables: list[Table] = tables or []
        self.d = d
        self.device = resolve(device)
        self._remix: Remix | None = None
        self._runset: RunSet | None = None
        self.remix_bytes = 0  # last REMIX build size (for WA accounting)
        # committed range tombstones covering (subsets of) self.tables
        self.excised: list[ExcisedSpan] = []
        # earliest future TTL expiry baked into the built index: past this
        # instant the runset's tomb marks are stale and index() rebuilds
        # them (REMIX structure is unaffected by liveness)
        self._ttl_next: float | None = None
        # last built (unpadded) REMIX + the tables it covered: a rebuild
        # that only appended tables extends it incrementally (§4.2)
        self._built_remix: Remix | None = None
        self._built_tables: list[Table] = []
        self.last_build_kind = "none"  # none | scratch | incremental | reuse

    def __repr__(self) -> str:
        return (
            f"Partition(lo={self.lo}, tables={len(self.tables)}, "
            f"built={self.last_build_kind})"
        )

    def attach_excised(self, lo: int, hi: int, seq: int) -> None:
        """Attach a freshly flushed range tombstone covering every table
        this partition holds *right now* (their rows all predate it)."""
        if self.tables and lo < hi:
            self.excised.append(
                ExcisedSpan(int(lo), int(hi), int(seq), tuple(self.tables))
            )

    @property
    def n_entries(self) -> int:
        return sum(t.n for t in self.tables)

    def _build(self, runs, tabs: list[Table], d: int) -> tuple[Remix, RunSet]:
        """Unpadded (remix, runset), incrementally where only tables were
        appended since the last build."""
        remix = self._try_incremental(tabs, d)
        if remix is not None:
            runset = stack_runs(runs)
        else:
            remix, runset = build_remix(runs, d=d)
            self.last_build_kind = "scratch"
        self._built_remix = remix
        self._built_tables = list(tabs) if self.tables else []
        self.remix_bytes = int(remix.storage_bytes())
        return remix, runset

    def index(self) -> tuple[Remix, RunSet]:
        """Build (or reuse) the partition's REMIX + stacked runs, with
        liveness (tombstones, TTL expiry at build time, excised spans)
        baked into the runset's tombstones.

        Shapes are bucket-padded to powers of two, as in the reference.
        """
        # TTL staleness: tomb marks were baked at build time; once the
        # clock passes the earliest future expiry, rebuild the runset
        # (the REMIX itself is liveness-independent and gets reused)
        if (
            self._remix is not None
            and self._ttl_next is not None
            and clock.now() >= self._ttl_next
        ):
            self._remix = None
            self._runset = None
        if self._remix is None:
            tabs = self.tables or [_empty_table()]
            d = max(self.d, len(tabs))  # paper requires D >= R
            now = clock.now()
            runs = [
                make_run(t.keys, t.vals, seq=t.seq,
                         tomb=self._build_dead(t, now), sort=False,
                         device=self.device)
                for t in tabs
            ]
            nexts = [t.min_future_exp(now) for t in tabs]
            self._ttl_next = min(
                (x for x in nexts if x is not None), default=None
            )
            remix, runset = self._build(runs, tabs, d)
            self._remix, self._runset = _pad_index(remix, runset, d)
        return self._remix, self._runset

    def _build_dead(self, t: Table, now: float) -> np.ndarray:
        """Liveness column baked into the runset for table ``t``:
        tombstones, TTL-expired rows, and rows an excised span covers."""
        return t.dead(now) | self._span_cover(t)

    def _span_cover(self, t: Table) -> np.ndarray:
        """(N,) bool: rows of ``t`` hidden by an excised span covering it
        — structural deadness (a covered row can never revive), safe to
        bake into any uploaded view regardless of the query clock."""
        dead = np.zeros(t.n, bool)
        for sp in self.excised:
            if sp.covers_table(t):
                m = (t.keys >= np.uint64(sp.lo)) & (t.keys < np.uint64(sp.hi))
                if m.any():
                    dead = dead | m
        return dead

    # ---------------- device-resident view (kernels/device_view.py) ----
    def device_view_bytes(self, with_vals: bool = True) -> int:
        """Estimated padded device-buffer bytes of :meth:`device_index`
        (no build needed) — the upload/tier decision input of the
        :class:`~repro_torch.kernels.device_view.DeviceViewManager`."""
        tabs = self.tables
        r2 = _pow2(max(1, len(tabs)), 1)
        n2 = _pow2(max((t.n for t in tabs), default=1), 64)
        d = max(self.d, len(tabs))
        kw = 2
        vw = (tabs[0].vw if tabs else 2) if with_vals else 1
        g2 = _pow2(max(1, -(-self.n_entries // d)), 4)
        per_row = 4 * kw + 4 * vw + 4 + 1 + 4  # keys+vals+seq+tomb+exp
        return int(g2 * (4 * kw + 4 * r2 + d) + r2 * n2 * per_row + r2 * 4)

    def device_index(self):
        """Padded ``(remix, runset, exp)`` for the device-resident view.

        Unlike :meth:`index`, liveness is *not* baked at build time: the
        runset tombstones carry only real tombstones plus excised-span
        coverage (structural), and the per-row TTL expiry words ride
        along as a padded (R, Nmax) int32-word tensor so the device
        evaluates ``tomb | (exp != 0 & exp <= now)`` at query time.
        """
        tabs = self.tables or [_empty_table()]
        d = max(self.d, len(tabs))  # paper requires D >= R
        runs, exps = [], []
        for t in tabs:
            dead = np.asarray(t.tomb, bool) | self._span_cover(t)
            runs.append(
                make_run(t.keys, t.vals, seq=t.seq, tomb=dead, sort=False,
                         device=self.device)
            )
            exps.append(
                np.asarray(t.exp, np.uint32)
                if t.ttl_present()
                else np.zeros(t.n, np.uint32)
            )
        remix, runset = self._build(runs, tabs, d)
        remix_p, runset_p = _pad_index(remix, runset, d)
        exp_p = torch.zeros((runset_p.r, runset_p.nmax), dtype=torch.int32,
                            device=self.device)
        for i, e in enumerate(exps):
            if len(e):
                exp_p[i, : len(e)] = as_words(e, self.device)
        return remix_p, runset_p, exp_p

    def _try_incremental(self, tabs: list[Table], d: int) -> Remix | None:
        """Reuse/extend the last built REMIX when this rebuild only appended
        tables (minor compaction) — zero key comparisons among old runs.

        Returns None when the table set changed in any other way (major,
        split, first build) or the group size moved; those rebuild from
        scratch.
        """
        prev, base = self._built_remix, self._built_tables
        if prev is None or not base or prev.r != len(base) or prev.d != d:
            return None
        if len(tabs) < len(base) or any(
            a is not b for a, b in zip(base, tabs)
        ):
            return None
        if len(tabs) == len(base):  # nothing changed: reuse as-is
            self.last_build_kind = "reuse"
            return prev
        new = tabs[len(base):]
        remix = incremental_build_remix(
            prev,
            [t.key_words() for t in base],
            [t.key_words() for t in new],
            [np.asarray(t.seq) for t in new],
            d=d,
        )
        self.last_build_kind = "incremental"
        return remix

    def estimate_remix_bytes(self, extra_entries: int = 0) -> int:
        """Size estimate of a REMIX over current + new entries (§4.2 Abort)."""
        n = self.n_entries + extra_entries
        r = len(self.tables) + 1
        groups = max(1, n // self.d)
        return int(groups * (8 + 4 * r) + n)
