"""Device-resident query views: persistent device buffers for promoted
partitions plus their batched execution.

A :class:`DeviceView` holds one promoted partition's REMIX structural
arrays (anchors, selector stream, cursor offsets) and its stacked run
sections as tensors on the card, in one of two residency tiers:

- ``full``  — keys, values, tombstones and TTL expiry words all resident:
  a batched get/scan is one kernel composition (anchor search → selector
  decode → run/row resolve → window emission → key/value gather; a get
  does all after the decode in the ``get_resolve`` kernel) with **exactly
  one device→host synchronisation**, the result fetch.
- ``index`` — everything but the value sections resident (file-backed
  partitions whose full view exceeds the budget). The device resolves
  each batch's (run, row) coordinates; the host gathers the values
  through the tables' ``BlockCache``. A scan with values runs as a
  pipeline of ``slice_width``-query slices: slice i+1's kernels are
  enqueued before the host waits for slice i's coordinates, which arrive
  in one of two pinned host buffers, so the card works on slice i+1
  while the host gathers slice i's values (one sync per slice).

Liveness is evaluated at query time on the device: uploaded tombstones
carry real tombstones plus excised-span coverage (structural, can never
revive), and per-row TTL expiry words are compared against ``now``, a
host integer — bit-for-bit the host path's ``_build_dead`` set at the same
instant, with no rebuild when the clock passes an expiry.

The :class:`DeviceViewManager` owns a device byte budget: LRU eviction on
upload pressure, and release-time eviction tied to the VersionSet pin
lifecycle (``retain`` drops views whose partition left every live
Version). Views hold a strong reference to their partition, so a view can
never alias a recycled ``id()``.

A partition that fits neither tier is counted in ``device_fallback_total``
and left to the caller, as the reference does.

One lock serialises the manager's residency changes (upload, eviction,
release): a store calls it from its submit workers and, through the
release hook, from whichever thread unpins a Version. The reference has
no lock, and two threads asking for the same partition there upload it
twice and count its bytes twice.

A store's batch of gets takes all of its partitions' views in one
``get_batch``: one query upload, three launches a view, one packed result
buffer, one copy and one wait. ``device_batches`` counts views,
``device_view_fetches`` round trips.

Host syncs are counted in the module-level ``SYNCS`` counter. Under an
active trace each partition a batch touches records ``view.resolve``
(the lock, the lookup, a ``view.upload`` on first touch); each round trip
records ``view.dispatch`` (the query upload, the kernel compositions, the
pinned buffer and copy, all enqueued; ``parts``: the views it serves) and
``view.sync`` (the blocking wait on the copy).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from itertools import accumulate

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.obs import tracing
from repro_torch.obs.events import NULL_EVENTS
from repro_torch.obs.metrics import MetricsRegistry

# device→host result fetches; module-level so benchmarks/tests can assert
# the "one sync per batch" contract
SYNCS = 0


def _start_fetch(tensors, host):
    """Enqueue copies of ``tensors`` into the pinned ``host`` buffers
    without blocking; returns the event recorded after them (None on the
    CPU, where the tensors are already host memory)."""
    if not tensors[0].is_cuda:
        return None
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensors[0].device))
    return ev


def _wait(ev) -> None:
    """The blocking wait of a fetch: on the event alone, with the sync
    debug mode off around it (``torch.cuda.set_sync_debug_mode("error")``
    around a batch then proves that nothing else waited on the card)."""
    global SYNCS
    SYNCS += 1
    with tracing.span("view.sync"):
        if ev is None:
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            ev.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def _pinned_like(tensors) -> list[torch.Tensor]:
    """Pinned host buffers shaped like ``tensors`` (the tensors themselves
    on the CPU)."""
    if not tensors[0].is_cuda:
        return list(tensors)
    return [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]


def _enqueue_fetch(*tensors) -> tuple:
    """A batch's outputs copied without blocking into pinned host memory:
    the buffers and the event after the copies, for :func:`_fetch`."""
    host = _pinned_like(tensors)
    return host, _start_fetch(tensors, host)


def _fetch(host, ev) -> list[np.ndarray]:
    """The single blocking device→host transfer of a batch: one wait on the
    copies :func:`_enqueue_fetch` enqueued; their host arrays."""
    _wait(ev)
    return [h.numpy() for h in host]


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → device without a blocking copy (pinned staging)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _pow2pad(n: int) -> int:
    b = 8
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class DeviceView:
    """One promoted partition's resident device buffers."""

    partition: object  # strong ref: pins identity until eviction
    tier: str  # "full" | "index"
    remix: object  # padded Remix (device)
    runset: object  # padded RunSet (device; dummy 1-word vals on "index")
    exp: torch.Tensor  # (R, Nmax) int32 words: TTL expiries (device)
    nbytes: int  # accounted device bytes
    vw: int  # real value width (host tables for "index")

    @property
    def tables(self):
        return self.partition.tables


def _view_nbytes(remix, runset, exp) -> int:
    arrs = (
        remix.anchors, remix.cursors, remix.selectors,
        runset.keys, runset.vals, runset.seq, runset.tomb, runset.lens,
        exp,
    )
    return int(sum(a.numel() * a.element_size() for a in arrs))


class DeviceViewManager:
    """Device residency manager for promoted partitions' views.

    ``budget_bytes`` bounds the resident set (LRU on upload pressure);
    ``retain(live_ids)`` is the VersionSet release hook — views whose
    partition is in no live Version are dropped with their pins.
    ``slice_width`` is the query count of one slice of the index tier's
    scan pipeline. A partition that fits neither tier counts
    ``device_fallback_total`` and the caller answers from the host path
    instead.
    """

    def __init__(
        self,
        budget_bytes: int,
        slice_width: int = 64,
        registry=None,
        events=None,
        device="cuda",
    ):
        self.budget_bytes = int(budget_bytes)
        self.slice_width = max(1, int(slice_width))
        self.device = resolve(device)
        self._views: "OrderedDict[int, DeviceView]" = OrderedDict()
        self._resident = 0
        self._lock = threading.RLock()
        if registry is None:
            registry = MetricsRegistry(enabled=False)
        if events is None:
            events = NULL_EVENTS
        self.events = events
        self._c_batches = registry.counter("device_batches")  # one a view
        self._c_fetches = registry.counter("device_view_fetches")  # one a round trip
        self._c_rows = registry.counter("device_rows_gathered")
        self._c_fallback = registry.counter("device_fallback_total")
        registry.gauge("hbm_resident_bytes", fn=lambda: self._resident)

    # ---- residency ----
    @property
    def resident_bytes(self) -> int:
        return self._resident

    def __len__(self) -> int:
        return len(self._views)

    def view_for(self, p) -> DeviceView | None:
        """Resident view for partition ``p`` — uploading on first use —
        or None when no tier fits the budget (caller falls back)."""
        with tracing.span("view.resolve"), self._lock:
            return self._view_for(p)

    def _view_for(self, p) -> DeviceView | None:
        v = self._views.get(id(p))
        if v is not None:
            self._views.move_to_end(id(p))
            return v
        if p.device_view_bytes(with_vals=True) <= self.budget_bytes:
            tier = "full"
        elif (
            p.device_view_bytes(with_vals=False) <= self.budget_bytes
            and p.tables
            and all(t.path is not None for t in p.tables)
        ):
            # value sections stay host-side, gathered via the BlockCache
            tier = "index"
        else:
            self._c_fallback.inc()
            return None
        with tracing.span("view.upload", tier=tier) as up:
            remix, runset, exp = p.device_index(with_vals=tier == "full")
            nbytes = _view_nbytes(remix, runset, exp)
            if up is not None:
                up.args["bytes"] = nbytes
            self._evict_to(self.budget_bytes - nbytes)
            vw = p.tables[0].vw if p.tables else runset.vw
            v = DeviceView(
                partition=p, tier=tier, remix=remix, runset=runset,
                exp=exp, nbytes=nbytes, vw=int(vw),
            )
            self._views[id(p)] = v
            self._resident += nbytes
        self.events.emit(
            "device_upload", lo=int(p.lo), tier=tier, bytes=int(nbytes),
            tables=len(p.tables),
        )
        return v

    def _evict_to(self, target: int, reason: str = "budget") -> None:
        while self._views and self._resident > max(0, target):
            _, v = self._views.popitem(last=False)  # LRU
            self._drop(v, reason)

    def _drop(self, v: DeviceView, reason: str) -> None:
        self._resident -= v.nbytes
        self.events.emit(
            "device_evict", lo=int(v.partition.lo), tier=v.tier,
            bytes=int(v.nbytes), reason=reason,
        )

    def retain(self, live_ids: set) -> None:
        """VersionSet release hook: drop views whose partition left every
        live Version (the device-side leg of the pin lifecycle)."""
        with self._lock:
            for key in [k for k in self._views if k not in live_ids]:
                self._drop(self._views.pop(key), "version_release")

    def clear(self) -> None:
        with self._lock:
            for key in list(self._views):
                self._drop(self._views.pop(key), "clear")

    # ---- batched execution ----
    def _queries(self, *keys_u64) -> torch.Tensor:
        """(Q,) u64 key arrays → one (Σ pow2-padded Q, 2) int32 upload on the
        device, each array's segment padded to a power of two with key 0."""
        pads = [_pow2pad(len(k)) for k in keys_u64]
        kq = np.zeros(sum(pads), np.uint64)
        for k, a in zip(keys_u64, accumulate(pads, initial=0)):
            kq[a: a + len(k)] = k
        return _upload(CK.pack_u64(kq).view(np.int32), self.device)

    def get_batch(self, dv, keys_u64, now) -> tuple:
        """Batched point gets on one view, or on a list of views with a list
        of u64 key arrays, one a view: three launches a view and one result
        fetch for them all. One query upload holds every view's queries;
        each view's get_resolve writes a packed (found, run, row, values)
        row a query into its slice of one int32 buffer, which one copy
        fetches. Full tier: the rows carry the values. Index tier: they
        carry (found, run, row) and the values come from the host block
        cache, a view at a time after the one wait.
        Returns (found (Q,) bool, vals (Q, VW) uint32), the views' queries
        in order."""
        views, keys = ([dv], [keys_u64]) if isinstance(dv, DeviceView) else (dv, keys_u64)
        keys = [np.asarray(k, np.uint64) for k in keys]
        if len(views) != len(keys):
            raise ValueError(f"{len(views)} views for {len(keys)} key arrays")
        one = len(views) == 1
        pads = [_pow2pad(len(k)) for k in keys]
        widths = [3 + v.runset.vals.shape[-1] for v in views]
        rows = list(accumulate(pads, initial=0))
        words = list(accumulate((p * w for p, w in zip(pads, widths)), initial=0))
        with tracing.span("view.dispatch", parts=len(views)):
            qd = self._queries(*keys)
            buf = torch.empty((pads[0], widths[0]) if one else (words[-1],),
                              dtype=torch.int32, device=self.device)
            for i, v in enumerate(views):
                ops.get_live_packed(
                    v.remix, v.runset, v.exp, qd if one else qd[rows[i]: rows[i + 1]],
                    int(now),
                    out=buf if one else buf[words[i]: words[i + 1]].view(pads[i], widths[i]),
                )
            host, ev = _enqueue_fetch(buf)
        self._c_batches.inc(len(views))
        self._c_fetches.inc()
        (res,) = _fetch(host, ev)  # THE one host sync
        res = res.reshape(-1)
        found, vals = [], []
        for i, v in enumerate(views):
            r = res[words[i]: words[i + 1]].reshape(pads[i], widths[i])[: len(keys[i])]
            f = r[:, 0] != 0
            found.append(f)
            vals.append(r[:, 3:].view(np.uint32) if v.tier == "full"
                        else self._host_vals(v, f, r[:, 1], r[:, 2]))
        self._c_rows.inc(int(sum(f.sum() for f in found)))
        if one:
            return found[0], vals[0]
        return np.concatenate(found), np.concatenate(vals)

    @staticmethod
    def _host_vals(dv: DeviceView, found, rid, row) -> np.ndarray:
        """An index-tier view's values of the found rows, from its tables
        through the block cache: one scattered fetch a touched table."""
        row = row.astype(np.int64)
        vals = np.zeros((len(found), dv.vw), np.uint32)
        for r in np.unique(rid[found]):
            m = found & (rid == r)
            vals[m] = dv.tables[r].rows_scattered("vals", row[m])
        return vals

    def scan_windows(
        self, dv: DeviceView, starts_u64, width: int, now,
        with_vals: bool = True,
    ) -> list:
        """Batched scan-window resolution: per query ``(keys (M,) u64,
        vals (M, VW) | None)`` — live entries of a ``width``-slot view
        window, same semantics as the host `gather_view` path."""
        starts_u64 = np.asarray(starts_u64, np.uint64)
        if dv.tier == "index" and with_vals:
            return self._scan_pipelined(dv, starts_u64, width, int(now))
        q = len(starts_u64)
        with tracing.span("view.dispatch"):
            kd, vd, md, _, _, _ = ops.scan_live(
                dv.remix, dv.runset, dv.exp, self._queries(starts_u64), int(now),
                width=width,
            )
            host, ev = _enqueue_fetch(*((kd, vd, md) if with_vals else (kd, md)))
        self._c_batches.inc()
        if with_vals:
            keys, vals, valid = _fetch(host, ev)
            vals = vals.view(np.uint32)
        else:
            keys, valid = _fetch(host, ev)
            vals = None
        out = []
        rows = 0
        for i in range(q):
            m = valid[i]
            kk = CK.unpack_u64(keys[i][m])
            rows += len(kk)
            out.append((kk, vals[i][m] if with_vals else None))
        self._c_rows.inc(rows)
        return out

    def _scan_pipelined(self, dv, starts_u64, width, now) -> list:
        """Index tier: the double-buffered, batch-sliced pipeline. Slice
        i+1's kernels and its copies into the other pinned buffer are
        enqueued before the host waits on slice i's copy event, so the
        card resolves slice i+1's row windows while the host gathers
        slice i's value granules through the BlockCache."""
        s = self.slice_width
        q = len(starts_u64)
        nsl = -(-q // s)
        padded = np.zeros(nsl * s, np.uint64)
        padded[:q] = starts_u64
        host = [None, None]  # the pair of pinned buffer sets, by slice parity

        def launch(si):
            with tracing.span("view.dispatch"):
                kd, _, md, rid_d, row_d, _ = ops.scan_live(
                    dv.remix, dv.runset, dv.exp,
                    self._queries(padded[si * s:(si + 1) * s]), now,
                    width=width,
                )
                out = (kd, md, rid_d, row_d)
                if host[si % 2] is None or not kd.is_cuda:
                    host[si % 2] = _pinned_like(out)
                return host[si % 2], _start_fetch(out, host[si % 2])

        out: list = []
        rows = 0
        pending = launch(0)
        for si in range(nsl):
            nxt = launch(si + 1) if si + 1 < nsl else None
            buf, ev = pending
            _wait(ev)  # this slice's one sync
            self._c_batches.inc()
            with torch.profiler.record_function("device_view.value_gather"):
                nq = min(s, q - si * s)
                keys, valid, rid, row = (b.numpy()[:nq] for b in buf)
                # slice value gather: group live rows per run, one
                # scattered (granule-deduped) fetch per touched table
                vals = np.zeros((nq, width, dv.vw), np.uint32)
                rid_f, row_f = rid[valid], row[valid].astype(np.int64)
                gath = np.zeros((len(rid_f), dv.vw), np.uint32)
                for r in np.unique(rid_f):
                    m = rid_f == r
                    gath[m] = dv.tables[r].rows_scattered("vals", row_f[m])
                vals[valid] = gath
                for i in range(nq):
                    m = valid[i]
                    kk = CK.unpack_u64(keys[i][m])
                    rows += len(kk)
                    out.append((kk, vals[i][m]))
            pending = nxt
        self._c_rows.inc(rows)
        return out
