"""Device-resident query views: persistent device buffers for promoted
partitions plus their batched execution.

A :class:`DeviceView` holds one promoted partition's REMIX structural
arrays (anchors, selector stream, cursor offsets) and its stacked run
sections as tensors on the card, in one of two residency tiers:

- ``full``  — keys, values, tombstones and TTL expiry words all resident:
  a batched get/scan is one kernel composition (anchor search → selector
  decode → run/row resolve → window emission → key/value gather) with
  **exactly one device→host synchronisation**, the result fetch.
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

Host syncs are counted in the module-level ``SYNCS`` counter.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.device import resolve
from repro_torch.kernels import ops
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


def _fetch(*tensors) -> list[np.ndarray]:
    """The single blocking device→host transfer of a batch: every output
    copied without blocking into pinned host memory, then one wait."""
    host = _pinned_like(tensors)
    _wait(_start_fetch(tensors, host))
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
        if registry is None:
            registry = MetricsRegistry(enabled=False)
        if events is None:
            events = NULL_EVENTS
        self.events = events
        self._c_batches = registry.counter("device_batches")
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
        remix, runset, exp = p.device_index(with_vals=tier == "full")
        nbytes = _view_nbytes(remix, runset, exp)
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
        for key in [k for k in self._views if k not in live_ids]:
            self._drop(self._views.pop(key), "version_release")

    def clear(self) -> None:
        for key in list(self._views):
            self._drop(self._views.pop(key), "clear")

    # ---- batched execution ----
    def _queries(self, keys_u64: np.ndarray) -> torch.Tensor:
        """(Q,) u64 keys → (pow2-padded Q, 2) int32 words on the device;
        padded queries are key 0."""
        q = len(keys_u64)
        kq = np.pad(keys_u64, (0, _pow2pad(q) - q))
        return _upload(CK.pack_u64(kq).view(np.int32), self.device)

    def get_batch(self, dv: DeviceView, keys_u64, now) -> tuple:
        """Batched point gets: one kernel composition + one result fetch.
        Full tier: the fetch carries the values. Index tier: it carries
        (found, run, row) and the values come from the host block cache.
        Returns (found (Q,) bool, vals (Q, VW) uint32)."""
        keys_u64 = np.asarray(keys_u64, np.uint64)
        q = len(keys_u64)
        fd, vd, rid_d, row_d = ops.get_live(
            dv.remix, dv.runset, dv.exp, self._queries(keys_u64), int(now)
        )
        self._c_batches.inc()
        if dv.tier == "full":
            found, vals = _fetch(fd, vd)  # THE one host sync
            found, vals = found[:q], vals[:q].view(np.uint32)
            self._c_rows.inc(int(found.sum()))
            return found, vals
        found, rid, row = _fetch(fd, rid_d, row_d)
        found, rid, row = found[:q], rid[:q], row[:q].astype(np.int64)
        vals = np.zeros((q, dv.vw), np.uint32)
        for r in np.unique(rid[found]):
            m = found & (rid == r)
            vals[m] = dv.tables[r].rows_scattered("vals", row[m])
        self._c_rows.inc(int(found.sum()))
        return found, vals

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
        kd, vd, md, _, _, _ = ops.scan_live(
            dv.remix, dv.runset, dv.exp, self._queries(starts_u64), int(now),
            width=width,
        )
        self._c_batches.inc()
        if with_vals:
            keys, vals, valid = _fetch(kd, vd, md)
            vals = vals.view(np.uint32)
        else:
            keys, valid = _fetch(kd, md)
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
            kd, _, md, rid_d, row_d, _ = ops.scan_live(
                dv.remix, dv.runset, dv.exp,
                self._queries(padded[si * s:(si + 1) * s]), now, width=width,
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
