"""The reference store served in the program's place: the benchmark's
control.

It answers a request stream as the configuration's guarantees say, from
the sorted loaded keys plus a map of later writes, one request at a time
under a lock, with one guarantee broken on purpose: each 32-bit value word
keeps only ``value_bits`` of its bits (16 by default: the nearest lower
precision of a stored row). The comparison that decides ``correct`` has to
call its answers wrong.
"""
from __future__ import annotations

import bisect
import threading
from concurrent.futures import Future

import numpy as np

READ, UPDATE, INSERT, SCAN, RMW = range(5)  # perfbench.traffic.KINDS


class ReferenceStore:
    def __init__(self, keys: np.ndarray, vals: np.ndarray, value_bits: int = 16):
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.mask = np.uint32((1 << value_bits) - 1 if value_bits < 32 else 0xFFFFFFFF)
        self.vals = vals[order] & self.mask
        self.vw = vals.shape[1]
        self.extra: dict[int, np.ndarray] = {}  # written after the load
        self.extra_keys: list[int] = []  # sorted, keys not loaded
        self.lock = threading.Lock()

    def _get(self, key: int):
        v = self.extra.get(key)
        if v is not None:
            return v
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and int(self.keys[i]) == key:
            return self.vals[i]
        return None

    def _put(self, key: int, val) -> None:
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if key not in self.extra and not (i < len(self.keys) and int(self.keys[i]) == key):
            bisect.insort(self.extra_keys, key)
        self.extra[key] = np.asarray(val, np.uint32) & self.mask

    def _scan(self, start: int, n: int):
        i = int(np.searchsorted(self.keys, np.uint64(start)))
        base = self.keys[i:i + n].tolist()
        j = bisect.bisect_left(self.extra_keys, start)
        merged = sorted(base + self.extra_keys[j:j + n])[:n]
        keys = np.array(merged, np.uint64)
        vals = np.stack([self._get(k) for k in merged]) if merged else np.zeros((0, self.vw), np.uint32)
        return keys, vals

    def apply(self, req) -> dict:
        """Answer one request: per op ``ok``, and ``found`` / ``vals`` for
        reads, ``scans`` {op: (keys, vals)}."""
        n = len(req)
        out = dict(ok=np.ones(n, bool), found=np.zeros(n, bool),
                   vals=np.zeros((n, self.vw), np.uint32), scans={})
        with self.lock:
            for i, (kind, key) in enumerate(zip(req.kinds.tolist(), req.keys.tolist())):
                if kind in (READ, RMW):
                    v = self._get(key)
                    if v is not None:
                        out["found"][i] = True
                        out["vals"][i] = v
                if kind in (UPDATE, INSERT, RMW):
                    self._put(key, req.vals[i])
                elif kind == SCAN:
                    out["scans"][i] = self._scan(key, req.scan_n)
        return out

    def submit(self, req, trace: bool = False) -> Future:
        f = Future()
        f.set_result(self.apply(req))
        return f
