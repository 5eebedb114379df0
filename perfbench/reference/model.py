"""The plain reference of the key-value semantics: a sorted map and the
history of every write of a run.

Numpy and the standard library only: nothing of the program under test.
It is fed the load and the request stream that the benchmark generated,
with each request's interval on the client's clock, and says which
answers a correct store may give.

The store promises (each configuration's ``guarantees``): a read sees
every write acknowledged before the read was sent, and never a write sent
after the read came back; a request's own earlier writes are visible to
its later operations, its later writes are not. Between those bounds a
write that overlaps the read in time may or may not show. So for a read of
key ``k`` over the interval ``[s, e]`` the answers allowed are the values
of those versions ``v`` of ``k`` that were sent before ``e`` and that no
version certainly superseded before the read: none ``w`` that ended before
``s`` and started after ``v`` ended. Absence is the version of a key
before its first write. A write whose request never came back has no end.
"""
from __future__ import annotations

import numpy as np

NEG = float("-inf")
INF = float("inf")
STEP = 1e-9  # a request's own writes, in order, just after its start


class Version:
    __slots__ = ("start", "end", "client", "req", "pos", "val")

    def __init__(self, start, end, client, req, pos, val):
        self.start, self.end = start, end
        self.client, self.req, self.pos = client, req, pos
        self.val = val  # (vw,) uint32, or None for absence


class Model:
    """The loaded keys (sorted, with their rows) and every later write.
    Times are seconds from the run's start on the client's clock."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        order = np.argsort(keys, kind="stable")
        self.keys = np.ascontiguousarray(keys[order])
        self.vals = np.ascontiguousarray(vals[order])
        self.vw = vals.shape[1]
        self.hist: dict[int, list[Version]] = {}
        self._written: np.ndarray | None = None

    # ---- feeding ----
    def write(self, key: int, val, start: float, end: float, client: int,
              req: int, pos: float) -> None:
        """A write of ``val`` to ``key`` by op ``pos`` of request ``req`` of
        ``client``, sent at ``start``, acknowledged at ``end`` (inf: never)."""
        h = self.hist.get(key)
        if h is None:
            h = self.hist[key] = [Version(NEG, NEG, -1, -1, -1, self.loaded_value(key))]
        h.append(Version(start, end, client, req, pos, np.asarray(val, np.uint32)))
        self._written = None

    def loaded_value(self, key: int):
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and int(self.keys[i]) == key:
            return self.vals[i]
        return None

    # ---- reading ----
    def written(self) -> np.ndarray:
        """Sorted keys with at least one write after the load."""
        if self._written is None:
            self._written = np.array(sorted(self.hist), np.uint64)
        return self._written

    def allowed(self, key: int, s: float = INF, e: float = INF, client: int = -2,
                req: int = -2, pos: float = INF) -> list:
        """Values (None: absent) that op ``pos`` of request ``req`` of
        ``client``, sent at ``s`` and answered by ``e``, may read for
        ``key``. The defaults are a read after every write."""
        h = self.hist.get(key)
        if h is None:
            return [self.loaded_value(key)]
        eff = []  # (start, end, already before the read, value)
        for v in h:
            if v.client == client and v.req == req:
                if v.pos > pos:
                    continue  # a later op of the same request
                t = s + (v.pos + 1) * STEP
                eff.append((t, t, True, v.val))
            else:
                eff.append((v.start, v.end, v.end < s, v.val))
        floor = max(st for st, _, before, _ in eff if before)
        return [val for st, en, before, val in eff
                if (st < e or before) and en >= floor]

    def value_ok(self, key: int, got, s=INF, e=INF, client=-2, req=-2, pos=INF) -> bool:
        """Whether reading ``got`` (None: absent) for ``key`` is allowed."""
        for v in self.allowed(key, s, e, client, req, pos):
            if v is None:
                if got is None:
                    return True
            elif got is not None and np.array_equal(v, got):
                return True
        return False

    def scan_ok(self, start: int, n: int, got_keys, got_vals, s=INF, e=INF,
                client=-2, req=-2, pos=INF) -> bool:
        """Whether a Seek(``start``)+Next(``n``) answer is allowed: at most
        ``n`` ascending keys from ``start``, each with an allowed value, no
        key left out whose absence is not allowed, and fewer than ``n`` only
        where every later key may be absent."""
        k = np.asarray(got_keys, np.uint64)
        v = np.asarray(got_vals, np.uint32).reshape(len(k), self.vw)
        if len(k) > n or (len(k) and int(k[0]) < start):
            return False
        if len(k) > 1 and not bool(np.all(k[1:] > k[:-1])):
            return False
        full = len(k) == n
        # loaded keys in the answer's span that no one wrote: present, as loaded
        lo_i = int(np.searchsorted(self.keys, np.uint64(start)))
        hi_i = (int(np.searchsorted(self.keys, k[-1], side="right")) if full and n
                else len(self.keys))
        span = np.arange(lo_i, hi_i)
        wr = self.written()
        plain = span[~np.isin(self.keys[span], wr)] if len(wr) else span
        at = np.searchsorted(k, self.keys[plain])
        if len(plain):
            if int(at[-1]) >= len(k) or not np.array_equal(k[at], self.keys[plain]):
                return False
            if not np.array_equal(v[at], self.vals[plain]):
                return False
        # the rest of the answer: written keys with an allowed value
        rest = np.ones(len(k), bool)
        rest[at] = False
        for i in np.flatnonzero(rest).tolist():
            key = int(k[i])
            if key not in self.hist or not self.value_ok(key, v[i], s, e, client, req, pos):
                return False
        # written keys in the span that the answer left out: absence allowed
        if len(wr):
            w_lo = int(np.searchsorted(wr, np.uint64(start)))
            w_hi = int(np.searchsorted(wr, k[-1], side="right")) if full and n else len(wr)
            present = set(k.tolist())
            for key in wr[w_lo:w_hi].tolist():
                if key not in present and not self.value_ok(key, None, s, e, client, req, pos):
                    return False
        return True
