"""Bounded structured event log for background lifecycle transitions.

Flush, compaction round, WAL checkpoint/GC, file GC, partition promotion
and version publish used to happen silently (or via ``print``); each now
emits one :class:`Event` — a timestamp, a kind, and a flat dict of fields
(byte counts, durations, ids) — into a fixed-capacity ring buffer.

The ring is the in-process view (``RemixDB.events.list()``, newest last;
capacity is the ``event_log_capacity`` store knob). An optional JSONL
sink mirrors every event append-only to disk for post-mortem tooling;
sink failures are counted, never raised — observability must not take
down the store. ``seq`` is a monotonic per-log sequence number, so a
reader can detect how many events the ring dropped.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque


class Event:
    __slots__ = ("seq", "ts", "kind", "fields")

    def __init__(self, seq: int, ts: float, kind: str, fields: dict):
        self.seq = seq
        self.ts = ts
        self.kind = kind
        self.fields = fields

    def to_dict(self) -> dict:
        d = dict(seq=self.seq, ts=self.ts, kind=self.kind)
        d.update(self.fields)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Event({self.seq}, {self.kind}, {self.fields})"


class EventLog:
    """Thread-safe ring buffer of :class:`Event` + optional JSONL sink."""

    def __init__(self, capacity: int = 256, jsonl_path=None):
        if capacity <= 0:
            raise ValueError("event log capacity must be positive")
        self.capacity = int(capacity)
        self._ring: deque[Event] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._sink = None
        self.sink_errors = 0
        if jsonl_path is not None:
            self._sink = open(jsonl_path, "a", buffering=1)

    def emit(self, kind: str, **fields) -> Event:
        ev = Event(0, time.time(), kind, fields)
        with self._lock:
            self._seq += 1
            ev.seq = self._seq
            self._ring.append(ev)
            sink = self._sink
        if sink is not None:
            try:
                sink.write(json.dumps(ev.to_dict(), default=str) + "\n")
            except Exception:
                self.sink_errors += 1
        return ev

    def list(self, kind: str | None = None) -> list[Event]:
        """Events currently in the ring, oldest first."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def kinds(self) -> list[str]:
        """Distinct kinds in ring order of first appearance."""
        seen, out = set(), []
        for e in self.list():
            if e.kind not in seen:
                seen.add(e.kind)
                out.append(e.kind)
        return out

    def stats(self) -> dict:
        with self._lock:
            n, seq = len(self._ring), self._seq
        return dict(capacity=self.capacity, buffered=n, emitted=seq,
                    dropped=seq - n, sink_errors=self.sink_errors)

    def close(self) -> None:
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except Exception:
                self.sink_errors += 1


class NullEventLog:
    """No-op stand-in (``metrics=False`` disables event capture too)."""

    capacity = 0
    sink_errors = 0

    def emit(self, kind: str, **fields):
        return None

    def list(self, kind=None):
        return []

    def kinds(self):
        return []

    def stats(self) -> dict:
        return dict(capacity=0, buffered=0, emitted=0, dropped=0,
                    sink_errors=0)

    def close(self) -> None:
        pass


NULL_EVENTS = NullEventLog()
