"""Planner–executor for typed op batches: the physical half of the v2 API.

``Executor.submit(batch)`` turns a :class:`repro_torch.db.ops.Batch` into a
future in three steps:

1. **Admission** — an in-flight byte budget shared by every batch of the
   engine. Submitters block (backpressure) while the budget is full; an
   op whose deadline expires while waiting is marked
   ``DEADLINE_EXCEEDED`` without poisoning the rest of the batch.
2. **Planning** — ops are split into *stages*: maximal runs of reads and
   writes in batch order (so a batch is always equivalent to the same
   ops issued sequentially through the legacy methods). Within a read
   stage, point lookups (Get + MultiGet fan-out) and scans are routed to
   their owning shard with the same ``route_host`` arithmetic the store
   uses internally, and grouped per shard for vectorized execution.
   MultiGets spanning shards fan out here and fan back in at execution.
3. **Execution** — a read stage pins **one snapshot per touched shard**
   (the store's ephemeral pinned view) for its whole duration, then
   compiles groups onto the engine's physical read primitives:
   ``_get_batch_at`` (vectorized cold/device point lookups) and
   ``_scan_group_at`` (vectorized window scans with the
   :class:`~repro_torch.db.cursor.RemixCursor` fallback). Cross-shard scans
   drain shards in key order. A write stage routes rows to their owning
   shard and group-commits each shard's rows through the WAL in one
   append (``_apply_writes``).

Deadlines are re-checked when each group starts and inside cursor loops
(the ``interrupt`` hook), so a slow scan can be cut off mid-flight;
``future.cancel()`` cancels a queued batch outright and cooperatively
interrupts a running one between groups. Pinned snapshots are released
in ``finally`` blocks — a cancelled or failed batch never leaks a
Version pin.

Async submission runs on a small worker pool (daemon threads, started
lazily); ``submit(batch, sync=True)`` executes inline on the caller
thread and returns an already-completed future — the mode the legacy
wrapper methods use, so scalar ``put``/``get`` pay no thread hop.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import threading
import time
from collections import Counter

import numpy as np

from repro_torch.db.ops import (
    Batch,
    BatchResult,
    Op,
    OpInterrupted,
    OpKind,
    OpResult,
    OpStatus,
    WRITE_KINDS,
)
from repro_torch.db.sharded import partition_spans, route_host
from repro_torch.io.faults import (
    CorruptionError,
    TransientIOError,
    UnavailableSpanError,
)
from repro_torch.obs import events as _events
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

log = logging.getLogger(__name__)

# the typed storage failures (io.faults taxonomy): these mark the
# touching op IO_ERROR and trigger per-op isolation within a vectorized
# group, instead of the generic whole-group ERROR
_IO_ERRORS = (CorruptionError, TransientIOError, UnavailableSpanError)


def _status_for(e: BaseException) -> OpStatus:
    return OpStatus.IO_ERROR if isinstance(e, _IO_ERRORS) else OpStatus.ERROR


def _span(trace, name, **args):
    """Span context when tracing, free no-op otherwise."""
    if trace is None:
        return contextlib.nullcontext()
    return trace.span(name, **args)


def scan_batch_via_ops(engine: "Executor", starts, n: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Legacy ``scan_batch`` shape — (keys (Q, n), valid (Q, n)) — via
    one keys-only Scan op per start. The single shared body behind
    ``RemixDB.scan_batch`` and ``KVServeEngine.scan_batch``."""
    starts = np.asarray(starts, np.uint64)
    ops = [Op.scan(int(s), int(n), with_vals=False)
           for s in starts.tolist()]
    res = engine.submit(Batch(ops), sync=True).result()
    q = len(starts)
    out_k = np.zeros((q, n), np.uint64)
    out_m = np.zeros((q, n), bool)
    for i, r in enumerate(res.results):
        r.raise_if_error()
        kk = r.keys[:n]
        out_k[i, : len(kk)] = kk
        out_m[i, : len(kk)] = True
    return out_k, out_m


class BatchFuture(concurrent.futures.Future):
    """Future for one submitted batch, with cooperative mid-run cancel.

    ``cancel()`` on a still-queued batch cancels it outright (the future
    raises ``CancelledError``). Once execution has started, ``cancel()``
    sets :attr:`interrupted` instead: ops not yet executed complete with
    ``OpStatus.CANCELLED`` and the future still resolves to a
    :class:`BatchResult`.
    """

    def __init__(self):
        super().__init__()
        self.interrupted = threading.Event()
        self._tickets = None  # sequencer tickets (shard -> turn number)
        self._order_waited = False

    def cancel(self) -> bool:
        if super().cancel():
            return True
        self.interrupted.set()
        return False


class AdmissionController:
    """Bounded in-flight bytes with blocking (backpressure) acquire."""

    def __init__(self, max_bytes: int,
                 registry: "_metrics.MetricsRegistry | None" = None):
        self.max_bytes = int(max_bytes)
        self.inflight = 0
        self.peak = 0
        reg = registry if registry is not None else _metrics.MetricsRegistry()
        self._c_admitted = reg.counter("admission_admitted")
        self._c_waits = reg.counter("admission_waits")
        reg.gauge("admission_inflight_bytes", fn=lambda: self.inflight)
        reg.gauge("admission_peak_bytes", fn=lambda: self.peak)
        reg.gauge("admission_max_bytes", fn=lambda: self.max_bytes)
        self._cv = threading.Condition()

    # legacy counter attributes — live views over the registry
    @property
    def admitted(self) -> int:
        return self._c_admitted.value

    @property
    def waits(self) -> int:
        """Acquires that had to block."""
        return self._c_waits.value

    def acquire(self, cost: int, deadline_at: float | None = None) -> bool:
        """Block until ``cost`` bytes fit in the budget; False when
        ``deadline_at`` (monotonic) passes first. A batch larger than
        the whole budget is admitted alone (sole occupancy) so it can
        never livelock."""
        cost = int(cost)
        with self._cv:
            waited = False
            while not (
                self.inflight + cost <= self.max_bytes or self.inflight == 0
            ):
                if not waited:
                    waited = True
                    self._c_waits.inc()
                timeout = None
                if deadline_at is not None:
                    timeout = deadline_at - time.monotonic()
                    if timeout <= 0:
                        return False
                self._cv.wait(timeout)
            self.inflight += cost
            self.peak = max(self.peak, self.inflight)
            self._c_admitted.inc()
            return True

    def release(self, cost: int) -> None:
        with self._cv:
            self.inflight -= int(cost)
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return dict(
                max_bytes=self.max_bytes,
                inflight_bytes=self.inflight,
                peak_bytes=self.peak,
                admitted=self.admitted,
                waits=self.waits,
            )


class ShardSequencer:
    """Per-shard FIFO turn tickets: cross-batch write ordering.

    Async ``submit()`` alone promises nothing about the order two racing
    batches reach a shard's WAL. The sequencer hands each admitted batch
    one ticket per shard it will write (atomically, in submission
    order); a batch waits at its first write stage until every earlier
    ticket holder for those shards has *finished*, so per-shard write
    effects always land in submission order. Read-only batches take no
    tickets and are never delayed.

    Deadlock-free by construction: tickets are issued atomically with
    enqueue, so a batch only ever waits on strictly earlier batches, and
    the FIFO worker pool starts jobs in ticket order — a running batch's
    predecessors are always already running (or finished), never stuck
    behind it in the queue.
    """

    def __init__(self, n_shards: int):
        self._cv = threading.Condition()
        self._next = [0] * n_shards  # next ticket to issue, per shard
        self._done = [0] * n_shards  # all tickets < done have finished
        self._released: list[set] = [set() for _ in range(n_shards)]

    def register(self, shards) -> dict | None:
        """Issue one ticket per shard in ``shards``; None when empty."""
        if not shards:
            return None
        with self._cv:
            out = {}
            for s in shards:
                out[s] = self._next[s]
                self._next[s] += 1
            return out

    def await_turn(self, tickets: dict, interrupted=None) -> bool:
        """Block until every ticket is first in line (all earlier write
        batches for those shards finished). Returns False when
        ``interrupted`` was set while waiting — the caller's ops are
        about to be CANCELLED, so order no longer matters."""
        for s in sorted(tickets):
            t = tickets[s]
            with self._cv:
                while self._done[s] < t:
                    if interrupted is not None and interrupted.is_set():
                        return False
                    self._cv.wait(0.05 if interrupted is not None else None)
        return True

    def release(self, tickets: dict | None) -> None:
        """Mark a batch finished; out-of-order finishes (a cancelled
        batch ahead of the line) are parked until the line reaches
        them."""
        if not tickets:
            return
        with self._cv:
            for s, t in tickets.items():
                self._released[s].add(t)
                while self._done[s] in self._released[s]:
                    self._released[s].discard(self._done[s])
                    self._done[s] += 1
            self._cv.notify_all()


class _ReadGroup:
    """Per-(stage, shard) bundle of read work, vectorized at execution."""

    __slots__ = ("shard", "gets", "mgets", "scans", "priority")

    def __init__(self, shard: int):
        self.shard = shard
        self.gets: list[int] = []  # op indices
        # (op_idx, positions into op.keys routed to this shard)
        self.mgets: list[tuple[int, np.ndarray]] = []
        # with_vals -> op indices starting in this shard; scans of
        # different n share one heterogeneous group (merged row windows)
        self.scans: dict[bool, list[int]] = {}
        self.priority = 0


class _Stage:
    __slots__ = ("kind", "ops", "groups")

    def __init__(self, kind: str):
        self.kind = kind  # "read" | "write"
        self.ops: list[int] = []  # op indices in batch order
        self.groups: dict[int, _ReadGroup] = {}  # shard -> group (reads)


class Executor:
    """Plans and executes op batches over one or more range shards.

    ``shards`` is a list of ``(inclusive lower key bound, store)`` pairs
    — a single ``RemixDB`` uses ``[(0, db)]``; ``KVServeEngine`` passes
    its whole shard table so one batch fans out across stores.
    """

    def __init__(
        self,
        shards: list[tuple[int, object]],
        *,
        max_inflight_bytes: int = 64 << 20,
        workers: int = 2,
        registry: "_metrics.MetricsRegistry | None" = None,
        events: "_events.EventLog | None" = None,
        trace_sample_rate: float = 0.0,
    ):
        if not shards:
            raise ValueError("Executor needs at least one shard")
        shards = sorted(shards, key=lambda s: int(s[0]))
        self.lows = [int(lo) for lo, _ in shards]
        self.stores = [db for _, db in shards]
        # [lo, hi) key span each shard owns; scans are clipped to it so a
        # store holding out-of-span rows (e.g. the source of a live shard
        # split, which keeps the moved range's files) never leaks them
        self._spans = partition_spans(self.lows)
        self.sequencer = ShardSequencer(len(self.stores))
        self.vw = int(self.stores[0].cfg.vw)
        reg = registry if registry is not None else _metrics.MetricsRegistry()
        self.registry = reg
        self.events = events if events is not None else _events.NULL_EVENTS
        self.admission = AdmissionController(max_inflight_bytes, registry=reg)
        self._n_workers = max(1, int(workers))
        self._queue: list = []
        self._qcv = threading.Condition()
        self._threads: list[threading.Thread] = []
        self._closed = False
        # the op/batch counters the legacy ``stats()`` dict was built
        # from now live in the registry; ``stats()`` reads them back
        self._c_batches = reg.counter("engine_batches")
        self._c_completed = reg.counter("engine_batches_completed")
        self._c_cancelled_batches = reg.counter("engine_batches_cancelled")
        self._c_deadline = reg.counter("engine_ops_deadline_exceeded")
        self._c_cancelled_ops = reg.counter("engine_ops_cancelled")
        self._c_errors = reg.counter("engine_ops_errors")
        self._c_io_errors = reg.counter("engine_ops_io_errors")
        self._c_batch_failures = reg.counter("engine_batch_failures")
        self._c_ops = {
            k.value: reg.counter("engine_ops", kind=k.value) for k in OpKind
        }
        self._h_batch = reg.histogram("engine_batch_seconds")
        self._h_wait = reg.histogram("engine_admission_wait_seconds")
        reg.gauge("engine_queue_depth", fn=lambda: len(self._queue))
        reg.gauge("engine_workers", fn=lambda: len(self._threads))
        self._c_ordered = reg.counter("engine_ordered_batches")
        self._sampler = _tracing.Sampler(trace_sample_rate)
        self._c_traced = reg.counter("engine_batches_traced")
        self.last_trace: "_tracing.Trace | None" = None

    # ---------------- submission ----------------
    def submit(self, batch: Batch | list, *, sync: bool = False
               ) -> BatchFuture:
        """Admit + enqueue ``batch``; returns a future resolving to a
        :class:`BatchResult`. With ``sync=True`` the batch executes
        inline on the calling thread (the future returned is already
        done) — identical semantics, no thread hop."""
        if isinstance(batch, (list, tuple)):
            batch = Batch(list(batch))
        if self._closed and not sync:
            # close() only retires the async worker pool; synchronous
            # submission (and with it every legacy wrapper) keeps
            # working, matching the stores' own close-then-read contract
            raise RuntimeError("executor is closed to async submissions")
        if not sync:
            # the pool starts before the batch's clocks and trace: a thread
            # start is the executor's cost, not the batch's, and takes
            # milliseconds on a loaded host
            with self._qcv:
                self._ensure_workers()
        now = time.monotonic()
        deadlines = [
            None if op.deadline_ms is None else now + op.deadline_ms / 1e3
            for op in batch.ops
        ]
        self._c_batches.inc()
        # one increment per kind, not per op: a 256-op batch took 256
        # counter locks, ~1% of its time on the host
        for kind, n in Counter(op.kind.value for op in batch.ops).items():
            self._c_ops[kind].inc(n)
        trace = None
        if getattr(batch, "trace", False) or self._sampler.should_sample():
            trace = _tracing.Trace(
                "batch", args=dict(ops=len(batch.ops), sync=bool(sync))
            )
            trace.sampled = not getattr(batch, "trace", False)
            self._c_traced.inc()
        fut = BatchFuture()
        results: list[OpResult | None] = [None] * len(batch.ops)
        t0 = time.monotonic()
        ta = _tracing.now()
        ca = _tracing.cpu_now() if trace is not None else None
        cost = self._admit(batch, deadlines, results)
        wait_s = time.monotonic() - t0
        self._h_wait.observe(wait_s)
        if trace is not None:
            trace.leaf("admission", ta, c0=ca, bytes=cost)
        t_sub = time.monotonic()
        if all(r is not None for r in results):  # every op expired waiting
            self._finish(fut, batch, results, cost, wait_s, started=False,
                         trace=trace, t_sub=t_sub)
            return fut
        if sync:
            self._register_order(fut, batch)
            self._run(fut, batch, deadlines, results, cost, wait_s,
                      trace=trace, t_sub=t_sub)
            return fut
        with self._qcv:
            # ticket issue and enqueue are atomic (same lock), so queue
            # order == ticket order and a worker never starts a batch
            # whose predecessor is still stuck behind it in the queue
            self._register_order(fut, batch)
            self._queue.append((fut, batch, deadlines, results, cost, wait_s,
                                trace, _tracing.now(), t_sub))
            self._qcv.notify()
        return fut

    def _register_order(self, fut, batch) -> None:
        """Issue per-shard write tickets (post-admission, so a batch
        waiting on its turn always holds budget and its predecessors do
        too — no admission/ordering deadlock)."""
        shards = self._write_shards(batch)
        fut._tickets = self.sequencer.register(shards)
        if fut._tickets:
            self._c_ordered.inc()

    def _write_shards(self, batch) -> list[int]:
        """Shards the batch will write, for sequencer tickets."""
        if len(self.lows) == 1:
            if any(op.kind in WRITE_KINDS for op in batch.ops):
                return [0]
            return []
        out: set[int] = set()
        for op in batch.ops:
            if op.kind not in WRITE_KINDS:
                continue
            if op.kind is OpKind.DELETE_RANGE:
                for si, (lo, hi) in enumerate(self._spans):
                    if max(op.start, lo) < min(op.end, hi):
                        out.add(si)
            elif op.keys is not None:
                sids = route_host(
                    self.lows, np.asarray(op.keys, np.uint64)
                )
                out.update(int(s) for s in np.unique(sids))
            else:
                out.add(self._route_one(op.key))
        return sorted(out)

    def _release_order(self, fut) -> None:
        tickets = getattr(fut, "_tickets", None)
        fut._tickets = None
        self.sequencer.release(tickets)

    def execute(self, batch: Batch | list) -> BatchResult:
        """Synchronous convenience: ``submit(batch, sync=True).result()``."""
        return self.submit(batch, sync=True).result()

    def _admit(self, batch, deadlines, results) -> int:
        """Admission loop: blocks for budget; ops whose deadline passes
        while waiting are individually expired and give their bytes
        back. Returns the admitted cost (of still-live ops)."""
        while True:
            live = [i for i, r in enumerate(results) if r is None]
            cost = sum(batch.ops[i].cost_bytes(self.vw) for i in live)
            if not live:
                return 0
            dls = [deadlines[i] for i in live if deadlines[i] is not None]
            earliest = min(dls) if dls else None
            if self.admission.acquire(cost, earliest):
                return cost
            # earliest deadline fired while queued: expire what's due,
            # then retry admission with the slimmer batch
            now = time.monotonic()
            for i in live:
                if deadlines[i] is not None and deadlines[i] <= now:
                    results[i] = OpResult(status=OpStatus.DEADLINE_EXCEEDED)

    # ---------------- worker pool ----------------
    def _ensure_workers(self) -> None:
        while len(self._threads) < self._n_workers:
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        while True:
            with self._qcv:
                while not self._queue and not self._closed:
                    self._qcv.wait()
                if not self._queue:
                    return  # closed + drained
                job = self._queue.pop(0)
            (fut, batch, deadlines, results, cost, wait_s,
             trace, t_enq, t_sub) = job
            if trace is not None:
                trace.leaf("queue", t_enq, _tracing.now())
            if not fut.set_running_or_notify_cancel():
                # cancelled while queued: give the bytes back, count ops
                self.admission.release(cost)
                self._release_order(fut)
                self._c_cancelled_batches.inc()
                continue
            self._run(fut, batch, deadlines, results, cost, wait_s,
                      trace=trace, t_sub=t_sub, mark_running=False)

    def _run(self, fut, batch, deadlines, results, cost, wait_s,
             trace=None, t_sub=None, mark_running=True) -> None:
        if mark_running and not fut.set_running_or_notify_cancel():
            self.admission.release(cost)
            self._release_order(fut)
            self._c_cancelled_batches.inc()
            return
        if trace is not None:
            trace.picked_up()
        try:
            with _tracing.activate(trace):
                self._execute(fut, batch, deadlines, results, trace)
        except BaseException as e:  # plan-level failure: fail leftover ops
            for i, r in enumerate(results):
                if r is None:
                    results[i] = OpResult(status=OpStatus.ERROR,
                                          error=repr(e), exc=e)
            # structured failure path: a background batch failure lands
            # in the event log + logging, not on a worker's stderr
            self._c_batch_failures.inc()
            self.events.emit("batch_error", error=repr(e),
                             ops=len(batch.ops))
            log.exception("op batch execution failed (%d ops)",
                          len(batch.ops))
        self._finish(fut, batch, results, cost, wait_s, started=True,
                     trace=trace, t_sub=t_sub)

    def _finish(self, fut, batch, results, cost, wait_s, started,
                trace=None, t_sub=None) -> None:
        self.admission.release(cost)
        self._release_order(fut)
        stats = self._batch_stats(batch, results, wait_s, started)
        self._c_completed.inc()
        self._c_deadline.inc(stats["deadline_exceeded"])
        self._c_cancelled_ops.inc(stats["cancelled"])
        self._c_errors.inc(stats["errors"])
        self._c_io_errors.inc(stats["io_errors"])
        if t_sub is not None:
            self._h_batch.observe(time.monotonic() - t_sub)
        if trace is not None:
            trace.finish()
            self.last_trace = trace
        if fut.cancelled():
            return  # raced a queue-level cancel
        fut.set_result(BatchResult(list(results), stats, trace=trace))

    def _batch_stats(self, batch, results, wait_s, started) -> dict:
        by_status: dict[str, int] = {}
        for r in results:
            by_status[r.status.value] = by_status.get(r.status.value, 0) + 1
        kinds: dict[str, int] = {}
        for op in batch.ops:
            kinds[op.kind.value] = kinds.get(op.kind.value, 0) + 1
        return dict(
            ops=len(batch.ops),
            kinds=kinds,
            status=by_status,
            executed=bool(started),
            admission_wait_s=round(wait_s, 6),
            deadline_exceeded=by_status.get("deadline_exceeded", 0),
            cancelled=by_status.get("cancelled", 0),
            errors=by_status.get("error", 0),
            io_errors=by_status.get("io_error", 0),
        )

    # ---------------- planning ----------------
    def plan(self, batch: Batch) -> list[_Stage]:
        """Split ops into read/write stages and route read work to
        shards. Public for introspection and tests; execution consumes
        exactly this structure."""
        stages: list[_Stage] = []
        for i, op in enumerate(batch.ops):
            kind = "write" if op.kind in WRITE_KINDS else "read"
            if not stages or stages[-1].kind != kind:
                stages.append(_Stage(kind))
            st = stages[-1]
            st.ops.append(i)
            if kind != "read":
                continue
            if op.kind is OpKind.GET:
                g = self._group(st, self._route_one(op.key))
                g.gets.append(i)
                g.priority = max(g.priority, op.priority)
            elif op.kind is OpKind.MULTIGET:
                if len(op.keys) == 0:
                    # empty fan-out still needs a home so the op
                    # resolves to an empty OK result
                    g = self._group(st, 0)
                    g.mgets.append((i, np.zeros(0, np.int64)))
                    continue
                if len(self.lows) == 1:
                    sids = np.zeros(len(op.keys), np.int64)
                else:
                    sids = route_host(self.lows, op.keys)
                for s in np.unique(sids):
                    g = self._group(st, int(s))
                    g.mgets.append((i, np.flatnonzero(sids == s)))
                    g.priority = max(g.priority, op.priority)
            else:  # SCAN: starts in its owning shard, may drain onward
                g = self._group(st, self._route_one(op.start))
                g.scans.setdefault(op.with_vals, []).append(i)
                g.priority = max(g.priority, op.priority)
        return stages

    def _group(self, stage: _Stage, shard: int) -> _ReadGroup:
        g = stage.groups.get(shard)
        if g is None:
            g = stage.groups[shard] = _ReadGroup(shard)
        return g

    def _route_one(self, key: int) -> int:
        if len(self.lows) == 1:
            return 0
        return int(route_host(self.lows, np.array([key], np.uint64))[0])

    # ---------------- execution ----------------
    def _execute(self, fut, batch, deadlines, results, trace=None) -> None:
        with _span(trace, "plan"):
            stages = self.plan(batch)
        for idx, stage in enumerate(stages):
            with _span(trace, f"stage{idx}:{stage.kind}",
                       ops=len(stage.ops)):
                if stage.kind == "write":
                    if fut._tickets and not fut._order_waited:
                        # first write of the batch: wait for every
                        # earlier write batch touching these shards
                        fut._order_waited = True
                        with _span(trace, "sequence"):
                            self.sequencer.await_turn(
                                fut._tickets, fut.interrupted
                            )
                    self._exec_write_stage(
                        fut, batch, deadlines, results, stage, trace
                    )
                else:
                    self._exec_read_stage(
                        fut, batch, deadlines, results, stage, trace
                    )

    def _precheck(self, fut, deadlines, results, idxs) -> list[int]:
        """Mark cancelled/expired ops among ``idxs``; return survivors."""
        now = time.monotonic()
        out = []
        for i in idxs:
            if results[i] is not None:
                continue
            if fut.interrupted.is_set():
                results[i] = OpResult(status=OpStatus.CANCELLED)
            elif deadlines[i] is not None and deadlines[i] <= now:
                results[i] = OpResult(status=OpStatus.DEADLINE_EXCEEDED)
            else:
                out.append(i)
        return out

    def _interrupt_for(self, fut, deadline_at):
        """Cooperative checker threaded into cursor loops (mid-op
        deadline/cancel), or None when the op can't be interrupted."""
        if deadline_at is None:
            def check():
                if fut.interrupted.is_set():
                    raise OpInterrupted(OpStatus.CANCELLED)
        else:
            def check():
                if fut.interrupted.is_set():
                    raise OpInterrupted(OpStatus.CANCELLED)
                if time.monotonic() > deadline_at:
                    raise OpInterrupted(OpStatus.DEADLINE_EXCEEDED)
        return check

    # ---- writes ----
    def _exec_write_stage(self, fut, batch, deadlines, results, stage,
                          trace=None):
        live = self._precheck(fut, deadlines, results, stage.ops)
        if not live:
            return
        # Put/Delete rows accumulate per shard and group-commit together;
        # a DeleteRange or Cas is a *write edge* — accumulated rows flush
        # first so per-shard effects equal the sequential legacy order
        # (a Cas must observe every earlier write in its own batch)
        per: dict[int, list[tuple]] = {}
        pending: list[int] = []

        def commit_pending():
            for shard in sorted(per):
                chunks = per[shard]
                keys = np.concatenate([c[0] for c in chunks])
                vals = np.concatenate([c[1] for c in chunks])
                tombs = np.concatenate(
                    [np.full(len(c[0]), c[2], bool) for c in chunks]
                )
                exps = np.concatenate([c[3] for c in chunks])
                # one WAL group commit + MemTable apply per shard
                with _span(trace, f"shard{shard}:commit", rows=len(keys)):
                    self.stores[shard]._apply_writes(keys, vals, tombs,
                                                     exps=exps)
            per.clear()
            for j in pending:
                results[j] = OpResult(status=OpStatus.OK)
            pending.clear()

        try:
            for i in live:
                op = batch.ops[i]
                if op.kind is OpKind.DELETE_RANGE:
                    commit_pending()
                    with _span(trace, "delete_range"):
                        self._apply_delete_range_op(op)
                    results[i] = OpResult(status=OpStatus.OK)
                    continue
                if op.kind is OpKind.CAS:
                    commit_pending()
                    shard = self._route_one(op.key)
                    with _span(trace, f"shard{shard}:cas"):
                        ok, actual = self.stores[shard]._apply_cas(
                            op.key, op.expect, op.val, exp=int(op.exp)
                        )
                    results[i] = OpResult(status=OpStatus.OK, found=ok,
                                          value=actual)
                    continue
                tomb = op.kind is OpKind.DELETE
                if op.keys is None:
                    keys = np.array([op.key], np.uint64)
                    vals = (
                        np.zeros((1, self.vw), np.uint32)
                        if tomb
                        else np.asarray(op.val, np.uint32).reshape(
                            1, self.vw
                        )
                    )
                else:
                    keys = np.asarray(op.keys, np.uint64)
                    vals = (
                        np.zeros((len(keys), self.vw), np.uint32)
                        if tomb or op.val is None
                        else np.asarray(op.val, np.uint32).reshape(
                            len(keys), self.vw
                        )
                    )
                exps = np.broadcast_to(
                    np.asarray(op.exp, np.uint32), (len(keys),)
                ).copy()
                pending.append(i)
                if len(self.lows) == 1:
                    per.setdefault(0, []).append((keys, vals, tomb, exps))
                else:
                    sids = route_host(self.lows, keys)
                    for s in np.unique(sids):
                        m = sids == s
                        per.setdefault(int(s), []).append(
                            (keys[m], vals[m], tomb, exps[m])
                        )
            commit_pending()
        except Exception as e:
            # a write stage commits as one WAL group append per shard, so
            # a typed I/O failure (e.g. fsync giving up) fails the whole
            # stage — but with the typed status so callers can tell a
            # storage fault from a logic error
            for i in live:
                if results[i] is None:
                    results[i] = OpResult(status=_status_for(e),
                                          error=repr(e), exc=e)
            return

    def _apply_delete_range_op(self, op) -> None:
        """Fan one DeleteRange out across shards, clipped to each shard's
        key span — shards outside [start, end) are untouched."""
        if len(self.lows) == 1:
            self.stores[0]._apply_delete_range(op.start, op.end)
            return
        for si, (lo, hi) in enumerate(partition_spans(self.lows)):
            l, h = max(op.start, lo), min(op.end, hi)
            if l < h:
                self.stores[si]._apply_delete_range(l, h)

    # ---- reads ----
    def _exec_read_stage(self, fut, batch, deadlines, results, stage,
                         trace=None):
        groups = sorted(
            stage.groups.values(), key=lambda g: (-g.priority, g.shard)
        )
        # one pinned snapshot per touched shard, held for the whole stage
        # (scan drains pin follow-on shards through the same table)
        with contextlib.ExitStack() as stack:
            views: dict[int, object] = {}

            def view(shard: int):
                v = views.get(shard)
                if v is None:
                    v = stack.enter_context(self.stores[shard]._view())
                    views[shard] = v
                return v

            # MultiGet fan-in buffers: op_idx -> (found, vals)
            mg: dict[int, list] = {}
            for g in groups:
                with _span(trace, f"shard{g.shard}:read",
                           gets=len(g.gets) + len(g.mgets),
                           scans=sum(len(v) for v in g.scans.values())):
                    self._exec_points(
                        fut, batch, deadlines, results, g, view, mg, trace
                    )
                    self._exec_scans(fut, batch, deadlines, results, g, view)
            for i, (found, vals) in mg.items():
                if results[i] is None:
                    results[i] = OpResult(
                        status=OpStatus.OK, found=found, vals=vals
                    )

    def _exec_points(self, fut, batch, deadlines, results, g, view, mg,
                     trace=None):
        with _span(trace, "exec.keys"):
            gets = self._precheck(fut, deadlines, results, g.gets)
            mgets = [
                (i, pos)
                for i, pos in g.mgets
                if results[i] is None
                and self._precheck(fut, deadlines, results, [i])
            ]
            keys: list[np.ndarray] = []
            for i in gets:
                keys.append(np.array([batch.ops[i].key], np.uint64))
            for i, pos in mgets:
                if i not in mg:
                    q = len(batch.ops[i].keys)
                    mg[i] = [np.zeros(q, bool),
                             np.zeros((q, self.vw), np.uint32)]
                keys.append(np.asarray(batch.ops[i].keys, np.uint64)[pos])
            qk = np.concatenate(keys) if keys else None
        if not keys:
            return
        if len(gets) == 1 and not mgets and len(keys[0]) == 1:
            # lone point lookup: the scalar read path (same results as the
            # batched one — tested — but with the bounded per-key byte
            # profile legacy ``db.get`` had)
            i = gets[0]
            try:
                val = self.stores[g.shard]._get_at(
                    view(g.shard), batch.ops[i].key
                )
            except Exception as e:
                results[i] = OpResult(status=_status_for(e), error=repr(e),
                                      exc=e)
                return
            results[i] = OpResult(
                status=OpStatus.OK, found=val is not None, value=val
            )
            return
        try:
            found, vals = self.stores[g.shard]._get_batch_at(view(g.shard), qk)
        except _IO_ERRORS:
            # containment: one corrupt granule must fail only the ops
            # whose keys touch it — re-execute the group per op so the
            # rest of the batch completes normally
            self._points_isolated(batch, results, g, view, gets, mgets, mg)
            return
        except Exception as e:
            for i in gets:
                results[i] = OpResult(status=OpStatus.ERROR, error=repr(e), exc=e)
            for i, _ in mgets:
                results[i] = OpResult(status=OpStatus.ERROR, error=repr(e), exc=e)
            return
        with _span(trace, "exec.results"):
            off = 0
            for i in gets:
                results[i] = OpResult(
                    status=OpStatus.OK,
                    found=bool(found[off]),
                    value=vals[off].copy() if found[off] else None,
                )
                off += 1
            for i, pos in mgets:
                m = len(pos)
                mg[i][0][pos] = found[off : off + m]
                mg[i][1][pos] = vals[off : off + m]
                off += m

    def _points_isolated(self, batch, results, g, view, gets, mgets, mg):
        """Per-op fallback after a typed I/O failure in the vectorized
        point group: each op re-reads alone, so only ops whose keys land
        on the corrupt granule end IO_ERROR."""
        for i in gets:
            try:
                val = self.stores[g.shard]._get_at(
                    view(g.shard), batch.ops[i].key
                )
            except Exception as e:
                results[i] = OpResult(status=_status_for(e), error=repr(e),
                                      exc=e)
                continue
            results[i] = OpResult(
                status=OpStatus.OK, found=val is not None, value=val
            )
        for i, pos in mgets:
            try:
                f, v = self.stores[g.shard]._get_batch_at(
                    view(g.shard),
                    np.asarray(batch.ops[i].keys, np.uint64)[pos],
                )
            except Exception as e:
                results[i] = OpResult(status=_status_for(e), error=repr(e),
                                      exc=e)
                continue
            mg[i][0][pos] = f
            mg[i][1][pos] = v

    def _exec_scans(self, fut, batch, deadlines, results, g, view):
        for with_vals, idxs in g.scans.items():
            live = self._precheck(fut, deadlines, results, idxs)
            if not live:
                continue
            starts = np.array(
                [batch.ops[i].start for i in live], np.uint64
            )
            ns = np.array([batch.ops[i].n for i in live], np.int64)
            checks = [
                self._interrupt_for(fut, deadlines[i]) for i in live
            ]
            try:
                rows = self.stores[g.shard]._scan_group_at(
                    view(g.shard), starts, ns,
                    with_vals=with_vals, interrupts=checks,
                )
            except _IO_ERRORS:
                # containment: re-run each scan alone so only the ones
                # crossing the corrupt granule end IO_ERROR; survivors
                # rejoin the common drain/fan-out loop below
                rows = []
                for i, chk in zip(live, checks):
                    try:
                        kk, vv = self.stores[g.shard]._scan_at(
                            view(g.shard), batch.ops[i].start,
                            batch.ops[i].n, interrupt=chk,
                        )
                        rows.append((kk, vv if with_vals else None))
                    except OpInterrupted as e2:
                        rows.append(e2)
                    except Exception as e2:
                        results[i] = OpResult(status=_status_for(e2),
                                              error=repr(e2), exc=e2)
                        rows.append(None)
            except Exception as e:
                for i in live:
                    results[i] = OpResult(status=OpStatus.ERROR,
                                          error=repr(e), exc=e)
                continue
            for i, row in zip(live, rows):
                if row is None:  # failed in the isolation fallback
                    continue
                if isinstance(row, OpInterrupted):
                    results[i] = OpResult(status=row.status)
                    continue
                kk, vv = row
                kk, vv = self._clip_to_span(g.shard, kk, vv)
                try:
                    kk, vv = self._drain_scan(
                        fut, deadlines[i], g.shard, kk, vv,
                        batch.ops[i].n, with_vals, view,
                    )
                except OpInterrupted as e:
                    results[i] = OpResult(status=e.status)
                    continue
                except Exception as e:
                    results[i] = OpResult(status=_status_for(e),
                                          error=repr(e), exc=e)
                    continue
                results[i] = OpResult(status=OpStatus.OK, keys=kk, vals=vv)

    def _clip_to_span(self, shard: int, kk, vv):
        """Drop scan rows past the shard's owned [lo, hi) span. Rows are
        ascending, so a tail mask suffices; the last shard (hi = 2^64)
        never clips."""
        hi = self._spans[shard][1]
        if hi >= (1 << 64) or len(kk) == 0 or int(kk[-1]) < hi:
            return kk, vv
        keep = int(np.searchsorted(kk, np.uint64(hi), side="left"))
        return kk[:keep], None if vv is None else vv[:keep]

    def _drain_scan(self, fut, deadline_at, shard, kk, vv, n, with_vals,
                    view):
        """Cross-shard fan-out of one scan: drain follow-on shards in key
        order until ``n`` rows (the serve engine's legacy drain rule)."""
        si = shard + 1
        check = self._interrupt_for(fut, deadline_at)
        while len(kk) < n and si < len(self.stores):
            check()
            k2, v2 = self.stores[si]._scan_at(
                view(si), self.lows[si], n - len(kk), interrupt=check
            )
            k2, v2 = self._clip_to_span(si, k2, v2)
            kk = np.concatenate([kk, k2])
            if with_vals:
                vv = np.concatenate([vv, v2])
            si += 1
        return kk, vv

    # ---------------- lifecycle / stats ----------------
    def close(self, wait: bool = True) -> None:
        """Stop accepting batches; drain the async queue (``wait``)."""
        with self._qcv:
            self._closed = True
            self._qcv.notify_all()
        if wait:
            for t in self._threads:
                t.join()

    def stats(self) -> dict:
        """Legacy stats dict — a view reading the registry counters back
        out (bit-compatible with the pre-registry ``_counts`` layout)."""
        with self._qcv:
            qd, wk = len(self._queue), len(self._threads)
        out = dict(
            batches=self._c_batches.value,
            completed=self._c_completed.value,
            cancelled_batches=self._c_cancelled_batches.value,
            ops={k.value: self._c_ops[k.value].value for k in OpKind},
            deadline_exceeded=self._c_deadline.value,
            cancelled_ops=self._c_cancelled_ops.value,
            errors=self._c_errors.value,
            io_errors=self._c_io_errors.value,
        )
        out["queue_depth"] = qd
        out["workers"] = wk
        out["admission"] = self.admission.stats()
        out["shards"] = len(self.stores)
        return out
