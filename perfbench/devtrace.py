"""What a traced run records beside the program's own spans: the device's
activity from ``torch.profiler`` (CUDA activity only, as
``repro_torch.bench.common.profile_call`` takes it), and the operands of
every call of the two CUDA kernels, recorded by a wrapper around the
entry points that ``repro_torch.kernels.ops`` calls.

The profiler's clock and the host's ``perf_counter`` differ by an offset.
A marker kernel launched on an idle card right after a ``perf_counter``
reading is the trace's first device event; the offset comes from it, to
within a launch's latency.
"""
from __future__ import annotations

import threading
import time

import numpy as np

ANCHOR_KERNELS = ("warp_search_kernel", "sample_search_kernel")
DECODE_KERNELS = ("selector_decode_kernel",)


class KernelCalls:
    """Records the operands of each anchor_search and selector_decode call
    while active; the lock keeps record and launch in one order."""

    def __init__(self):
        self.anchor: list = []  # (anchors tensor, queries tensor)
        self.decode: list = []  # (rows, d, r)
        self._lock = threading.Lock()
        self._saved = None

    def __enter__(self):
        from repro_torch.kernels import ops

        a0, s0 = ops.anchor_search, ops.selector_decode

        def anchor_search(anchors, queries):
            with self._lock:
                self.anchor.append((anchors, queries))
                return a0(anchors, queries)

        def selector_decode(selectors, cursors, rows=None):
            with self._lock:
                n = selectors.shape[0] if rows is None else rows.shape[0]
                self.decode.append((int(n), int(selectors.shape[1]), int(cursors.shape[1])))
                return s0(selectors, cursors, rows)

        self._saved = (a0, s0)
        ops.anchor_search, ops.selector_decode = anchor_search, selector_decode
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.anchor_search, ops.selector_decode = self._saved


class DeviceTrace:
    """The profiler over a window. After :meth:`stop`: ``intervals`` (N, 2)
    device activity on the host's ``perf_counter`` clock and ``names``."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.parse_s = 0.0

    def start(self):
        torch = self._torch
        torch.cuda.synchronize()
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)  # the marker: the trace's first device event
        torch.cuda.synchronize()

    def stop(self):
        """Stop the profiler and read its device events straight from the
        kineto results (building the profiler's per-event Python objects
        for a window's ~10^6 launches would take minutes)."""
        from torch.autograd import DeviceType

        self._torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.stop()
        ev = [e for e in self.prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        st = np.array([e.start_ns() for e in ev], np.float64) * 1e-9
        du = np.array([e.duration_ns() for e in ev], np.float64) * 1e-9
        names = [e.name() for e in ev]
        if len(ev):
            first = int(np.argmin(st))
            keep = np.arange(len(ev)) != first  # the marker is not the program's
            st = st[keep] + (self.t_mark - st[first])
            self.intervals = np.stack([st, st + du[keep]], axis=1)
            self.names = [n for i, n in enumerate(names) if i != first]
        else:
            self.intervals = np.zeros((0, 2))
            self.names = []
        self.totals: dict[str, float] = {}
        for (a, b), n in zip(self.intervals.tolist(), self.names):
            self.totals[n] = self.totals.get(n, 0.0) + (b - a)
        self.parse_s = time.perf_counter() - t0
        return self


def union(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Disjoint busy intervals of ``intervals`` clipped to [lo, hi]."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = np.clip(intervals, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def gaps(busy: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Idle intervals of [lo, hi] between the disjoint ``busy`` ones."""
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def host_spans(records) -> tuple:
    """Every span of the requests' program traces, plus one ``client`` span
    a request, as arrays: (t0, t1, depth, names)."""
    t0, t1, depth, names = [], [], [], []
    for r in records:
        t0.append(r.t0)
        t1.append(r.t1)
        depth.append(-1)
        names.append("client")
        tr = r.trace
        if tr is None:
            continue
        stack = [(tr.root, 0)]
        while stack:
            sp, d = stack.pop()
            t0.append(sp.t0)
            t1.append(sp.t1)
            depth.append(d)
            names.append(sp.name)
            stack.extend((c, d + 1) for c in sp.children)
    return np.array(t0), np.array(t1), np.array(depth), names


def label_gaps(idle: np.ndarray, spans, top: int = 10) -> list:
    """The ``top`` longest idle gaps, each named by the innermost host span
    open at its midpoint ("no request" where none was)."""
    t0, t1, depth, names = spans
    out = []
    longest = idle[np.argsort(idle[:, 0] - idle[:, 1], kind="stable")[:top]]
    for a, b in longest.tolist():
        m = 0.5 * (a + b)
        open_ = np.flatnonzero((t0 <= m) & (t1 >= m))
        name = names[open_[np.argmax(depth[open_])]] if len(open_) else "no request"
        out.append([name, b - a])
    return out
