"""Sampled op-lifecycle tracing: span trees over ``Executor.submit()``.

A :class:`Trace` is one tree of :class:`Span` s for one submitted batch:
``admission`` (backpressure wait) → ``queue`` (async pickup delay) →
``plan`` → per-stage/per-shard execution groups → leaf spans recorded at
the physical layers (``cache_fetch`` in the block cache, ``disk_read`` in
the SSTable reader, ``ckb_decode`` in the compressed-key-block reader).
The point-read path adds its own layers below ``shardN:read``:
``exec.keys`` → ``store.overlay`` → per partition ``view.resolve``
(``view.upload`` on first touch), ``view.dispatch``, ``view.sync`` →
``exec.results``; a Python collection while the trace is active is a
``gc`` leaf under the deepest span open then.

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

CPU time: every span also reads the recording thread's CPU clock
(``time.thread_time``) where it opens and closes, so ``duration - cpu``
is the time that thread spent off the CPU inside the span (waiting on a
lock, the interpreter lock, the card or the disk). The root's CPU clock
runs from the executing thread's pickup (:meth:`Trace.picked_up`) to
:meth:`Trace.finish`; a leaf timed across threads (``queue``) has none.
Where the thread CPU clock ticks coarsely (10 ms steps on some hosts),
one short span's ``cpu`` is a sample: read sums over many spans.
Times stay on ``perf_counter`` (:data:`now`), the clock device traces are
mapped onto.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import json
import threading
import time
from contextlib import contextmanager

_tls = threading.local()

now = time.perf_counter
cpu_now = time.thread_time

_NULL = contextlib.nullcontext()


class Span:
    __slots__ = ("name", "t0", "t1", "c0", "c1", "args", "children")

    def __init__(self, name: str, t0: float, args: dict | None = None,
                 c0: float = 0.0):
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.c0 = c0  # the recording thread's CPU clock at open ...
        self.c1 = c0  # ... and at close
        self.args = args or {}
        self.children: list[Span] = []

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)

    @property
    def cpu(self) -> float:
        """Seconds the recording thread ran on a CPU inside the span."""
        return max(0.0, self.c1 - self.c0)

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
        self._cpu_thread = None  # ident of the thread the root's CPU clock runs on
        self._gc_open = None  # (t0, c0) of a collection in progress
        self._gcs: list[Span] = []  # collections, placed by time at finish

    # ---- recording ----
    @contextmanager
    def span(self, name: str, **args):
        # the span is pushed only once its start is read, and popped before
        # its end is: a collection seen under it lies inside its interval.
        # The CPU clock is read after the wall clock at the start and before
        # it at the end, so ``cpu`` never exceeds ``duration``
        sp = Span(name, now(), args, cpu_now())
        self._stack.append(sp)
        self._stack[-2].children.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.c1 = cpu_now()
            sp.t1 = now()

    def leaf(self, name: str, t0: float, t1: float | None = None,
             c0: float | None = None, **args) -> Span:
        """Record an already-timed leaf span under the current parent.
        ``t1`` left out ends it now; ``c0`` is this thread's :func:`cpu_now`
        read just after ``t0``, and a leaf given it ends now, its CPU clock
        read before its wall clock."""
        c1 = cpu_now() if c0 is not None else None
        if t1 is None:
            t1 = now()
        sp = Span(name, t0, args)
        sp.t1 = t1
        if c0 is not None:
            sp.c0, sp.c1 = c0, c1
        self._stack[-1].children.append(sp)
        return sp

    def picked_up(self) -> None:
        """The calling thread starts executing the batch: its name goes on
        the root (``thread``) and the root's CPU clock starts."""
        self.root.args["thread"] = threading.current_thread().name
        self._cpu_thread = threading.get_ident()
        self.root.c0 = self.root.c1 = cpu_now()

    def finish(self) -> "Trace":
        if self._cpu_thread == threading.get_ident():
            self.root.c1 = cpu_now()
        self.root.t1 = now()
        for sp in self._gcs:
            self._place(sp)
        self._gcs = []
        return self

    def _place(self, leaf: Span) -> None:
        """Put ``leaf`` under the deepest span whose interval holds it, the
        root included, in start order."""
        node = self.root
        while True:
            inner = next((c for c in node.children
                          if c.t0 <= leaf.t0 and leaf.t1 <= c.t1), None)
            if inner is None:
                break
            node = inner
        i = bisect.bisect_right(node.children, leaf.t0, key=lambda c: c.t0)
        node.children.insert(i, leaf)

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
            ev["args"] = {k: _jsonable(v) for k, v in s.args.items()}
            ev["args"]["cpu_us"] = round(s.cpu * 1e6, 3)
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


def span(name: str, **args):
    """A span of the thread's active trace, or a shared no-op context when
    none is active (one thread-local getattr)."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return _NULL
    return tr.span(name, **args)


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection on a thread with an active trace
    becomes a ``gc`` leaf (``generation``, ``collected``), under the root
    where no span below it is open, so the pause is never unattributed."""
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return
    if phase == "start":
        tr._gc_open = (now(), cpu_now())
        return
    if tr._gc_open is None:
        return
    (t0, c0), tr._gc_open = tr._gc_open, None
    sp = Span("gc", t0, dict(generation=info["generation"],
                             collected=info["collected"]), c0)
    sp.c1 = cpu_now()
    sp.t1 = now()
    tr._gcs.append(sp)


_gc_lock = threading.Lock()
_gc_hooked = False


def _install_gc_hook() -> None:
    global _gc_hooked
    with _gc_lock:
        if not _gc_hooked:
            gc.callbacks.append(_on_gc)
            _gc_hooked = True


@contextmanager
def activate(trace: Trace | None):
    """Make ``trace`` the thread's active trace for the duration (no-op
    when None). Leaf instrumentation in the io layer records into it."""
    if trace is None:
        yield None
        return
    if not _gc_hooked:
        _install_gc_hook()
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
