"""Typed storage errors + a deterministic, seed-driven fault-injection shim.

Two things live here because they are two halves of one contract:

* the **error taxonomy** every ``io/`` verification site raises —
  :class:`CorruptionError` (a CRC/decode failure pinned to ``(file,
  section, block)`` coordinates), :class:`TransientIOError` (a read that
  may succeed if retried) and :class:`UnavailableSpanError` (a key span
  whose backing table was quarantined as unrecoverable) — all subclasses
  of the bare exceptions they replaced, so pre-existing ``except
  ValueError`` / ``except OSError`` call sites keep working;
* the **fault plan** that makes those paths testable without
  monkeypatching: a :class:`FaultPlan` is handed to the store via
  ``RemixDBConfig.fault_plan`` and threaded (inside an :class:`IOContext`,
  which also carries the retry budget) under ``SSTableReader``, the WAL,
  ``load_remix`` and manifest ``_atomic_write``. Every rule is matched by
  path substring and consumed deterministically — same plan + same
  workload = same failures — and unspecified offsets are drawn from the
  plan's seeded RNG, never from global randomness.

Fault kinds (mirroring the failure modes of a real disk):

=================  ==========================================================
``transient_read``  the next ``count`` reads of a matching file raise
                    :class:`TransientIOError` (``EIO``) then heal — absorbed
                    by the read path's bounded retry (``io_retries``)
``bitflip``         reads covering ``[offset, offset+nbytes)`` of a matching
                    file see XOR-corrupted bytes — caught by granule CRCs
``torn_write``      the next matching write persists only a prefix
                    (``keep`` fraction) of its payload — what a crashed
                    non-atomic write leaves behind
``fail_fsync``      the next ``count`` fsyncs of a matching file raise
                    ``OSError`` — a dying disk acknowledging nothing
=================  ==========================================================

:func:`flip_bytes` is the companion for *real* at-rest bit rot: it XORs
bytes of a file on disk in place (the scrub/repair tests corrupt real
stores with it, then prove detection + self-healing).
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time


class TransientIOError(OSError):
    """A read failure that may succeed if retried (injected ``EIO``)."""

    def __init__(self, path: str, site: str = "read"):
        super().__init__(errno.EIO, f"transient I/O error ({site})", path)
        self.path = path
        self.site = site


class CorruptionError(ValueError):
    """Bytes failed verification, pinned to ``(file, section, block)``.

    ``section`` is the logical region (``"keys"``, ``"ckb"``, ``"footer"``,
    ``"remix"``, ``"manifest"``, ``"wal"`` …) and ``block`` the checksum
    granule index when one applies (else ``None``). Subclasses
    ``ValueError`` so legacy call sites catching the bare exception keep
    working.
    """

    def __init__(self, file: str, section: str | None = None,
                 block: int | None = None, detail: str = "checksum mismatch"):
        at = section or "?"
        if block is not None:
            at += f"[{block}]"
        super().__init__(f"{file}: {at}: {detail}")
        self.file = file
        self.section = section
        self.block = block
        self.detail = detail


class UnavailableSpanError(RuntimeError):
    """A key span is degraded: its backing table(s) were quarantined.

    Raised instead of serving possibly-wrong data when a read touches a
    partition whose unrecoverable table a scrub quarantined. Carries the
    span bounds so callers (executor → ``OpStatus.IO_ERROR``) can report
    which keys are unavailable rather than crashing the batch.
    """

    def __init__(self, lo: int, hi: int | None, tables: tuple[str, ...] = ()):
        span = f"[{lo}, {'inf' if hi is None else hi})"
        super().__init__(
            f"key span {span} unavailable: quarantined table(s) "
            f"{list(tables)!r}"
        )
        self.lo = lo
        self.hi = hi
        self.tables = tuple(tables)


def flip_bytes(path: str, offset: int, nbytes: int = 1, xor: int = 0xFF) -> None:
    """XOR ``nbytes`` bytes of ``path`` in place starting at ``offset`` —
    real at-rest bit rot, for corruption tests and scrub drills."""
    with open(path, "r+b") as f:
        f.seek(offset)
        buf = bytearray(f.read(nbytes))
        for i in range(len(buf)):
            buf[i] ^= xor
        f.seek(offset)
        f.write(bytes(buf))


class _Rule:
    __slots__ = ("kind", "match", "count", "offset", "nbytes", "xor", "keep")

    def __init__(self, kind, match, count=1, offset=None, nbytes=1,
                 xor=0xFF, keep=0.5):
        self.kind = kind
        self.match = match
        self.count = count  # remaining applications (-1 = unlimited)
        self.offset = offset
        self.nbytes = nbytes
        self.xor = xor
        self.keep = keep

    def matches(self, path: str) -> bool:
        return self.count != 0 and self.match in path

    def consume(self) -> None:
        if self.count > 0:
            self.count -= 1


class FaultPlan:
    """Deterministic, seed-driven schedule of storage faults.

    Rules are added up front, matched against file paths by substring,
    and consumed in order. Thread-safe (the store reads from worker
    threads). ``stats()`` reports what actually fired so tests can assert
    the plan was exercised, not silently skipped.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []
        self.fired: dict[str, int] = {
            "transient_read": 0, "bitflip": 0, "torn_write": 0,
            "fail_fsync": 0,
        }

    # ---------------- rule construction ----------------
    def transient_read(self, match: str, count: int = 1) -> "FaultPlan":
        """The next ``count`` reads of files containing ``match`` raise
        :class:`TransientIOError`, then the site heals."""
        self._rules.append(_Rule("transient_read", match, count=count))
        return self

    def bitflip(self, match: str, offset: int | None = None,
                nbytes: int = 1, xor: int = 0xFF) -> "FaultPlan":
        """Reads of a matching file whose range covers ``offset`` see the
        bytes XORed with ``xor``. ``offset=None`` picks a seeded random
        position inside the first matching read (then stays fixed)."""
        self._rules.append(
            _Rule("bitflip", match, count=-1, offset=offset, nbytes=nbytes,
                  xor=xor)
        )
        return self

    def torn_write(self, match: str, keep: float = 0.5,
                   count: int = 1) -> "FaultPlan":
        """The next ``count`` matching writes persist only the first
        ``keep`` fraction of their payload (a torn/short write)."""
        self._rules.append(_Rule("torn_write", match, count=count, keep=keep))
        return self

    def fail_fsync(self, match: str, count: int = 1) -> "FaultPlan":
        """The next ``count`` fsyncs of a matching file raise ``OSError``."""
        self._rules.append(_Rule("fail_fsync", match, count=count))
        return self

    # ---------------- hooks (called by the io/ layer) ----------------
    def check_read(self, path: str) -> None:
        """Raise :class:`TransientIOError` if a transient rule fires."""
        with self._lock:
            for r in self._rules:
                if r.kind == "transient_read" and r.matches(path):
                    r.consume()
                    self.fired["transient_read"] += 1
                    raise TransientIOError(path)

    def has_read_mutations(self, path: str) -> bool:
        with self._lock:
            return any(
                r.kind == "bitflip" and r.matches(path) for r in self._rules
            )

    def mutate_read(self, path: str, offset: int, data) -> bytes:
        """Apply bit-flip rules overlapping ``[offset, offset+len(data))``."""
        out = None
        with self._lock:
            for r in self._rules:
                if r.kind != "bitflip" or not r.matches(path):
                    continue
                if r.offset is None:  # seeded lazy placement
                    r.offset = offset + self.rng.randrange(max(1, len(data)))
                lo = max(offset, r.offset)
                hi = min(offset + len(data), r.offset + r.nbytes)
                if lo >= hi:
                    continue
                if out is None:
                    out = bytearray(data)
                for i in range(lo - offset, hi - offset):
                    out[i] ^= r.xor
                self.fired["bitflip"] += 1
        return bytes(out) if out is not None else bytes(data)

    def mutate_write(self, path: str, data: bytes) -> bytes:
        """Apply torn-write rules: returns the (possibly truncated) bytes
        that actually reach the disk."""
        with self._lock:
            for r in self._rules:
                if r.kind == "torn_write" and r.matches(path):
                    r.consume()
                    self.fired["torn_write"] += 1
                    return data[: int(len(data) * r.keep)]
        return data

    def check_fsync(self, path: str) -> None:
        with self._lock:
            for r in self._rules:
                if r.kind == "fail_fsync" and r.matches(path):
                    r.consume()
                    self.fired["fail_fsync"] += 1
                    raise OSError(errno.EIO, "injected fsync failure", path)

    def stats(self) -> dict:
        with self._lock:
            pending = sum(1 for r in self._rules if r.count != 0)
            return dict(self.fired, rules_pending=pending)


class IOContext:
    """Fault plan + retry budget, threaded as one object under the io/ layer.

    ``run(site, fn)`` executes ``fn`` with bounded retry+backoff on
    :class:`TransientIOError` (``io_retries`` attempts after the first;
    exponential backoff from ``backoff_s``). ``on_retry``/``on_giveup``
    are counter callbacks the store wires to the ``io_retry`` /
    ``io_giveup`` instruments.
    """

    __slots__ = ("plan", "retries", "backoff_s", "on_retry", "on_giveup")

    def __init__(self, plan: FaultPlan | None = None, retries: int = 2,
                 backoff_s: float = 0.0, on_retry=None, on_giveup=None):
        self.plan = plan
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.on_retry = on_retry
        self.on_giveup = on_giveup

    # fault hooks (no-ops without a plan)
    def check_read(self, path: str) -> None:
        if self.plan is not None:
            self.plan.check_read(path)

    def mutate_read(self, path: str, offset: int, data):
        if self.plan is not None:
            return self.plan.mutate_read(path, offset, data)
        return data

    def has_read_mutations(self, path: str) -> bool:
        return self.plan is not None and self.plan.has_read_mutations(path)

    def mutate_write(self, path: str, data: bytes) -> bytes:
        if self.plan is not None:
            return self.plan.mutate_write(path, data)
        return data

    def check_fsync(self, path: str) -> None:
        if self.plan is not None:
            self.plan.check_fsync(path)

    def run(self, site: str, fn):
        """``fn()`` with bounded retry on :class:`TransientIOError`."""
        attempt = 0
        while True:
            try:
                return fn()
            except TransientIOError:
                if attempt >= self.retries:
                    if self.on_giveup is not None:
                        self.on_giveup()
                    raise
                attempt += 1
                if self.on_retry is not None:
                    self.on_retry()
                if self.backoff_s > 0.0:
                    time.sleep(self.backoff_s * (2 ** (attempt - 1)))


NULL_IO = IOContext()
