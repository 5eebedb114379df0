"""Typed operation model: the logical half of the v2 query API.

The public surface of the store is a small algebra of **operations** —
``Get`` / ``MultiGet`` / ``Scan`` / ``Put`` / ``Delete`` — carried in a
:class:`Batch` and submitted through one entry point
(``engine.submit(batch) -> future``, see :mod:`repro_torch.db.executor`). This
is the KV-Tandem-style split the ROADMAP asks for: a narrow logical API
(this module: plain dataclasses, no I/O, no JAX) compiled by a
planner–executor onto the physical LSM engine (snapshots, REMIX cursors,
the vectorized cold paths, the WAL group commit).

Every op carries an optional ``deadline_ms`` (relative to submission)
and a ``priority`` scheduling hint. Results come back as one
:class:`OpResult` per op with an explicit :class:`OpStatus` — a deadline
miss or cancellation marks *that op* and never poisons the rest of the
batch.

``Put``/``Delete`` accept either a scalar key or a key array: the
vectorized forms are first-class ops (a ``put_batch`` is one ``Put`` op
over N keys), so a single op can group-commit through the WAL and
fan out across shards.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.db import clock


def _ttl_to_exp(ttl) -> int | np.ndarray:
    """seconds-from-now (scalar or per-key array) -> absolute u32 expiry."""
    if ttl is None:
        return 0
    now = int(clock.now())
    if np.ndim(ttl) == 0:
        return now + int(ttl)
    return (np.asarray(ttl, np.int64) + now).astype(np.uint32)


class OpKind(enum.Enum):
    GET = "get"
    MULTIGET = "multiget"
    SCAN = "scan"
    PUT = "put"
    DELETE = "delete"
    DELETE_RANGE = "delete_range"
    CAS = "cas"


READ_KINDS = frozenset((OpKind.GET, OpKind.MULTIGET, OpKind.SCAN))
WRITE_KINDS = frozenset(
    (OpKind.PUT, OpKind.DELETE, OpKind.DELETE_RANGE, OpKind.CAS)
)


class OpStatus(enum.Enum):
    OK = "ok"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    CANCELLED = "cancelled"
    ERROR = "error"
    # a typed storage failure (CorruptionError / exhausted
    # TransientIOError / UnavailableSpanError): the corrupt granule
    # fails only the ops that touch it, never the whole batch
    IO_ERROR = "io_error"


class OpInterrupted(Exception):
    """Raised inside the execution engine when an in-flight op's deadline
    expires or its batch is cancelled mid-run (see ``RemixCursor``'s
    ``interrupt`` hook); converted to a per-op status by the executor."""

    def __init__(self, status: OpStatus):
        super().__init__(status.value)
        self.status = status


@dataclasses.dataclass(frozen=True)
class Op:
    """One typed operation. Build via the factory classmethods — the
    constructor is shape-agnostic and does no validation beyond them."""

    kind: OpKind
    key: int = 0  # Get / scalar Put / scalar Delete
    keys: np.ndarray | None = None  # MultiGet / vectorized Put / Delete
    start: int = 0  # Scan / DeleteRange lower bound (inclusive)
    n: int = 0  # Scan result budget
    val: np.ndarray | None = None  # Put value row(s) / Cas new value
    with_vals: bool = True  # Scan: materialize value rows too
    deadline_ms: float | None = None  # relative to submit()
    priority: int = 0  # scheduling hint (higher first among reads)
    end: int = 0  # DeleteRange upper bound (exclusive)
    expect: np.ndarray | None = None  # Cas expected value (None = absent)
    exp: int | np.ndarray = 0  # Put/Cas absolute TTL expiry (0 = none)

    # ---------------- factories ----------------
    @classmethod
    def get(cls, key: int, *, deadline_ms: float | None = None,
            priority: int = 0) -> "Op":
        return cls(OpKind.GET, key=int(key), deadline_ms=deadline_ms,
                   priority=priority)

    @classmethod
    def multiget(cls, keys, *, deadline_ms: float | None = None,
                 priority: int = 0) -> "Op":
        return cls(OpKind.MULTIGET, keys=np.asarray(keys, np.uint64),
                   deadline_ms=deadline_ms, priority=priority)

    @classmethod
    def scan(cls, start: int, n: int, *, with_vals: bool = True,
             deadline_ms: float | None = None, priority: int = 0) -> "Op":
        if n < 0:
            raise ValueError("scan budget n must be >= 0")
        return cls(OpKind.SCAN, start=int(start), n=int(n),
                   with_vals=with_vals, deadline_ms=deadline_ms,
                   priority=priority)

    @classmethod
    def put(cls, key, val, *, ttl: float | None = None,
            deadline_ms: float | None = None, priority: int = 0) -> "Op":
        """Scalar (``key`` int) or vectorized (``key`` array) upsert.

        ``ttl`` (seconds, scalar or per-key array) converts to an
        absolute expiry against :func:`repro_torch.db.clock.now` at op
        construction; after it passes, reads treat the key as absent.
        """
        exp = _ttl_to_exp(ttl)
        if np.ndim(key) == 0:
            return cls(OpKind.PUT, key=int(key),
                       val=np.asarray(val, np.uint32), exp=exp,
                       deadline_ms=deadline_ms, priority=priority)
        keys = np.asarray(key, np.uint64)
        vals = np.asarray(val, np.uint32)
        if len(keys):
            vals = vals.reshape(len(keys), -1)
        else:
            vals = vals.reshape(0, vals.shape[-1] if vals.ndim else 1)
        return cls(OpKind.PUT, keys=keys, val=vals, exp=exp,
                   deadline_ms=deadline_ms, priority=priority)

    @classmethod
    def delete(cls, key, *, deadline_ms: float | None = None,
               priority: int = 0) -> "Op":
        if np.ndim(key) == 0:
            return cls(OpKind.DELETE, key=int(key),
                       deadline_ms=deadline_ms, priority=priority)
        return cls(OpKind.DELETE, keys=np.asarray(key, np.uint64),
                   deadline_ms=deadline_ms, priority=priority)

    @classmethod
    def delete_range(cls, start: int, end: int, *,
                     deadline_ms: float | None = None,
                     priority: int = 0) -> "Op":
        """Delete every key in [start, end) as one range tombstone —
        O(1) written regardless of how many keys the span covers."""
        if end < start:
            raise ValueError("delete_range needs start <= end")
        return cls(OpKind.DELETE_RANGE, start=int(start), end=int(end),
                   deadline_ms=deadline_ms, priority=priority)

    @classmethod
    def cas(cls, key: int, expect, val, *, ttl: float | None = None,
            deadline_ms: float | None = None, priority: int = 0) -> "Op":
        """Compare-and-swap: install ``val`` (or delete, when ``val`` is
        None) iff the key's current visible value equals ``expect``
        (``expect=None`` = expect-absent). The result's ``found`` is the
        success flag and ``value`` the actual pre-op value on conflict."""
        return cls(
            OpKind.CAS, key=int(key),
            expect=None if expect is None else np.asarray(expect, np.uint32),
            val=None if val is None else np.asarray(val, np.uint32),
            exp=_ttl_to_exp(ttl), deadline_ms=deadline_ms, priority=priority,
        )

    # ---------------- introspection ----------------
    @property
    def is_read(self) -> bool:
        return self.kind in READ_KINDS

    def write_rows(self) -> int:
        """Rows a write op commits (0 for reads)."""
        if self.kind not in WRITE_KINDS:
            return 0
        if self.kind is OpKind.DELETE_RANGE:
            return 1  # one range-tombstone record, whatever it covers
        return 1 if self.keys is None else len(self.keys)

    def cost_bytes(self, vw: int) -> int:
        """Admission-control estimate of the op's in-flight footprint."""
        row = 8 + 4 * vw
        if self.kind is OpKind.GET:
            return row
        if self.kind is OpKind.MULTIGET:
            return row * len(self.keys)
        if self.kind is OpKind.SCAN:
            return row * max(1, self.n)
        return row * self.write_rows()

    def __repr__(self) -> str:
        bits = [self.kind.value]
        if self.kind is OpKind.SCAN:
            bits.append(f"start={self.start}, n={self.n}")
        elif self.kind is OpKind.DELETE_RANGE:
            bits.append(f"start={self.start}, end={self.end}")
        elif self.keys is not None:
            bits.append(f"keys={len(self.keys)}")
        else:
            bits.append(f"key={self.key}")
        if self.deadline_ms is not None:
            bits.append(f"deadline_ms={self.deadline_ms}")
        if self.priority:
            bits.append(f"priority={self.priority}")
        return f"Op({', '.join(bits)})"


class Batch:
    """An ordered list of ops submitted as one unit.

    Semantics: a batch is equivalent to issuing its ops **in order**
    through the legacy methods (property-tested) — reads grouped and
    vectorized per shard between write edges, writes group-committed.
    Builder methods chain::

        b = Batch().put(1, [1, 0]).get(1).scan(0, 8)
        res = db.submit(b).result()

    ``trace=True`` opts this batch into op-lifecycle tracing regardless
    of the executor's ``trace_sample_rate``: the executor records a span
    tree (admission → plan → per-shard groups → cache/disk/CKB leaves)
    and returns it on ``BatchResult.trace``.
    """

    def __init__(self, ops: list[Op] | None = None, *, trace: bool = False):
        self.ops: list[Op] = list(ops) if ops else []
        self.trace = bool(trace)

    def add(self, op: Op) -> "Batch":
        self.ops.append(op)
        return self

    def get(self, key: int, **kw) -> "Batch":
        return self.add(Op.get(key, **kw))

    def multiget(self, keys, **kw) -> "Batch":
        return self.add(Op.multiget(keys, **kw))

    def scan(self, start: int, n: int, **kw) -> "Batch":
        return self.add(Op.scan(start, n, **kw))

    def put(self, key, val, **kw) -> "Batch":
        return self.add(Op.put(key, val, **kw))

    def delete(self, key, **kw) -> "Batch":
        return self.add(Op.delete(key, **kw))

    def delete_range(self, start: int, end: int, **kw) -> "Batch":
        return self.add(Op.delete_range(start, end, **kw))

    def cas(self, key: int, expect, val, **kw) -> "Batch":
        return self.add(Op.cas(key, expect, val, **kw))

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)

    def cost_bytes(self, vw: int) -> int:
        return sum(op.cost_bytes(vw) for op in self.ops)

    def __repr__(self) -> str:
        kinds: dict[str, int] = {}
        for op in self.ops:
            kinds[op.kind.value] = kinds.get(op.kind.value, 0) + 1
        return f"Batch({kinds})"


@dataclasses.dataclass
class OpResult:
    """Outcome of one op. Which payload fields are set depends on kind:

    - Get: ``found`` / ``value`` (None when absent)
    - MultiGet: ``found (Q,)`` / ``vals (Q, VW)``
    - Scan: ``keys (M,)`` / ``vals (M, VW)`` (vals None with
      ``with_vals=False``), M <= n
    - Put / Delete / DeleteRange: status only
    - Cas: ``found`` = swap succeeded; on conflict ``value`` holds the
      actual current value (None when the key was absent)
    """

    status: OpStatus = OpStatus.OK
    found: np.ndarray | bool | None = None
    value: np.ndarray | None = None
    keys: np.ndarray | None = None
    vals: np.ndarray | None = None
    error: str | None = None
    # the captured exception behind an ERROR status: per-op isolation
    # inside a batch, but the legacy wrappers re-raise it unchanged
    exc: BaseException | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def ok(self) -> bool:
        return self.status is OpStatus.OK

    def raise_if_error(self) -> None:
        """Re-raise an ERROR/IO_ERROR op's original exception (wrapper
        helper).

        The captured traceback is reattached so the re-raise points at
        the frame that actually failed inside the executor, not here.
        """
        if self.status in (OpStatus.ERROR, OpStatus.IO_ERROR):
            if self.exc is not None:
                raise self.exc.with_traceback(self.exc.__traceback__)
            raise RuntimeError(self.error or "op failed")


@dataclasses.dataclass
class BatchResult:
    """Per-op results (batch order) + the batch's execution stats.

    ``trace`` carries the :class:`repro_torch.obs.tracing.Trace` span tree when
    the batch was traced (``Batch(trace=True)`` or sampled), else None.
    """

    results: list[OpResult]
    stats: dict
    trace: object | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i: int) -> OpResult:
        return self.results[i]

    def __iter__(self):
        return iter(self.results)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)
