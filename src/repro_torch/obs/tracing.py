"""Sampled op-lifecycle tracing: span trees over ``Executor.submit()``.

A :class:`Trace` is one tree of :class:`Span` s for one submitted batch:
``admission`` (backpressure wait) → ``queue`` (async pickup delay) →
``plan`` → per-stage/per-shard execution groups → leaf spans recorded at
the physical layers (``cache_fetch`` in the block cache, ``disk_read`` in
the SSTable reader, ``ckb_decode`` in the compressed-key-block reader).

Activation is a **thread-local**: the executor activates the batch's
trace around execution, and leaf sites ask :func:`current` — a single
``getattr`` on a ``threading.local`` — so the untraced hot path pays one
predictable branch, nothing else. Traces reach callers on
``BatchResult.trace`` (``Batch(trace=True)`` opt-in, or the
``trace_sample_rate`` knob sampling 1-in-N batches deterministically) and
export as Chrome ``trace_event`` JSON loadable in ``chrome://tracing`` /
Perfetto.

Coverage accounting: :meth:`Trace.leaf_coverage` is the fraction of the
root span's wall time covered by at least one instrumented child span —
Σ self-time (span duration − Σ child durations) over all non-root spans,
divided by the root duration. The acceptance bar (≥ 0.9 on a mixed
cross-shard batch) means at most 10% of a traced batch's latency is
unattributed glue.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager

_tls = threading.local()

now = time.perf_counter


class Span:
    __slots__ = ("name", "t0", "t1", "args", "children")

    def __init__(self, name: str, t0: float, args: dict | None = None):
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.args = args or {}
        self.children: list[Span] = []

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def self_time(self) -> float:
        return max(0.0, self.duration - sum(c.duration for c in self.children))

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Span({self.name}, {self.duration * 1e6:.1f}us, " \
               f"{len(self.children)} children)"


class Trace:
    """One span tree. Not thread-safe across concurrent writers — the
    executor runs one batch's stages on one thread, which is the only
    writer while the trace is activated there."""

    def __init__(self, name: str = "batch", args: dict | None = None):
        self.root = Span(name, now(), args)
        self._stack = [self.root]
        self.sampled = False  # set when chosen by trace_sample_rate

    # ---- recording ----
    @contextmanager
    def span(self, name: str, **args):
        sp = Span(name, now(), args)
        parent = self._stack[-1]
        parent.children.append(sp)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = now()
            self._stack.pop()

    def leaf(self, name: str, t0: float, t1: float, **args) -> Span:
        """Record an already-timed leaf span under the current parent."""
        sp = Span(name, t0, args)
        sp.t1 = t1
        self._stack[-1].children.append(sp)
        return sp

    def finish(self) -> "Trace":
        self.root.t1 = now()
        return self

    # ---- reading ----
    def spans(self) -> list[Span]:
        return list(self.root.walk())

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans() if s.name == name]

    def leaf_coverage(self) -> float:
        dur = self.root.duration
        if dur <= 0:
            return 1.0
        covered = sum(s.self_time() for s in self.spans() if s is not self.root)
        return min(1.0, covered / dur)

    def well_formed(self) -> bool:
        """Every span ends after it starts and nests inside its parent
        (small float slack for clock granularity)."""
        eps = 1e-9
        for s in self.spans():
            if s.t1 + eps < s.t0:
                return False
            for c in s.children:
                if c.t0 + eps < s.t0 - eps or c.t1 > s.t1 + eps:
                    return False
        return True

    # ---- export ----
    def to_chrome(self, pid: int = 1, tid: int = 1) -> dict:
        """Chrome ``trace_event`` JSON object format (``ph: "X"`` complete
        events, microsecond timestamps relative to the root start)."""
        base = self.root.t0
        events = []
        for s in self.spans():
            ev = dict(
                name=s.name, ph="X", pid=pid, tid=tid,
                ts=round((s.t0 - base) * 1e6, 3),
                dur=round(s.duration * 1e6, 3),
            )
            if s.args:
                ev["args"] = {k: _jsonable(v) for k, v in s.args.items()}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_chrome_json(self, **kw) -> str:
        return json.dumps(self.to_chrome(**kw))

    def save_chrome(self, path, **kw) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(**kw), f, indent=1)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ---------------- thread-local activation ----------------

def current() -> Trace | None:
    """The trace activated on this thread, or None (the untraced fast
    path: one thread-local getattr)."""
    return getattr(_tls, "trace", None)


@contextmanager
def activate(trace: Trace | None):
    """Make ``trace`` the thread's active trace for the duration (no-op
    when None). Leaf instrumentation in the io layer records into it."""
    if trace is None:
        yield None
        return
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


class Sampler:
    """Deterministic 1-in-N batch sampler for ``trace_sample_rate``.

    ``rate`` is the target fraction of batches traced; sampling is
    counter-based (every round(1/rate)-th batch) so runs are reproducible
    and the first batch of a fresh process is always sampled — the one a
    human is usually staring at.
    """

    def __init__(self, rate: float = 0.0):
        rate = float(rate)
        if not 0.0 <= rate <= 1.0:
            raise ValueError("trace_sample_rate must be in [0, 1]")
        self.rate = rate
        self._every = 0 if rate == 0.0 else max(1, round(1.0 / rate))
        self._n = 0
        self._lock = threading.Lock()

    def should_sample(self) -> bool:
        if self._every == 0:
            return False
        with self._lock:
            n = self._n
            self._n += 1
        return n % self._every == 0
