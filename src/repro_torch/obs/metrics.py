"""Lock-cheap metrics registry: counters, gauges, log-bucketed histograms.

One :class:`MetricsRegistry` per component (store, serving engine, shared
block cache); every pre-existing ad-hoc counter in ``io/blockcache.py``,
``db/store.py``, ``db/wal.py``, ``db/executor.py`` … is now an instrument
registered here, and the legacy ``stats()`` dicts are thin views reading
instrument values back out (bit-compatible keys, equality-tested in
``tests/test_obs.py``).

Design points:

* **Lock-cheap.** Each counter/histogram carries its own ``threading.Lock``
  taken only for the few ns of the update — there is no registry-wide lock
  on the hot path, and uncontended CPython lock acquire is ~100 ns, far
  below the µs-scale block/batch operations being counted.
  ``engine_bench`` asserts the end-to-end cost: metrics-on throughput must
  stay ≥ 0.95x metrics-off.
* **HDR-style fixed buckets.** Histograms use geometric bucket bounds
  fixed at construction (growth 2**1/4 ≈ 1.19 for latency, 2x for sizes),
  so ``observe`` is a ``bisect`` into a precomputed list plus one slot
  increment — no allocation, no rebucketing — and p50/p95/p99 read-out is
  a cumulative walk with a geometric-midpoint estimate whose relative
  error is bounded by the growth factor.
* **Labels.** Instruments are keyed by ``(name, sorted(label items))``;
  a registry can also carry default labels (e.g. ``shard="2"``) applied
  to every instrument it creates, and snapshots can be merged with extra
  labels stamped per source — that is how ``KVServeEngine.metrics()``
  builds one per-shard-labelled view over many per-store registries.
* **Null instruments.** A registry constructed with ``enabled=False``
  hands out shared no-op instruments and snapshots to nothing, so the
  ``metrics=False`` store knob removes even the lock acquires.

Snapshot format (also the JSON artifact / obstool / Prometheus input): a
dict ``{"metrics": [sample, ...]}`` where each sample is a plain dict —
``{"name", "type", "labels", ...}`` plus ``value`` for counters/gauges or
``count/sum/min/max/p50/p95/p99/buckets`` for histograms. ``buckets`` is a
list of ``[upper_bound, cumulative_count]`` pairs (only buckets that grew,
plus the +Inf total), directly renderable as Prometheus ``_bucket`` lines.
"""
from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter. ``inc`` takes the instrument's own lock only."""

    __slots__ = ("name", "labels", "_lock", "_v")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError("counters are monotonic; inc(n >= 0)")
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def sample(self) -> dict:
        return dict(name=self.name, type="counter", labels=dict(self.labels),
                    value=self._v)


class Gauge:
    """Point-in-time value: ``set()`` explicitly, or a callback read at
    snapshot time (used for derived values like queue depth, cached
    bytes, live versions — no write-path cost at all)."""

    __slots__ = ("name", "labels", "_lock", "_v", "_fn")

    def __init__(self, name: str, labels: dict, fn=None):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0
        self._fn = fn

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return 0
        return self._v

    def sample(self) -> dict:
        return dict(name=self.name, type="gauge", labels=dict(self.labels),
                    value=self.value)


class MultiGauge:
    """Callback gauge fanning out to many label sets at snapshot time.

    The callback returns ``[(labels_dict, value), ...]`` — used for
    per-partition cold counters and per-table CKB memo sizes, where the
    label population (partitions, tables) changes as versions turn over.
    """

    __slots__ = ("name", "labels", "_fn")

    def __init__(self, name: str, labels: dict, fn):
        self.name = name
        self.labels = labels
        self._fn = fn

    def samples(self) -> list[dict]:
        try:
            rows = self._fn()
        except Exception:
            return []
        out = []
        for lbl, v in rows:
            merged = dict(self.labels)
            merged.update({str(k): str(x) for k, x in lbl.items()})
            out.append(dict(name=self.name, type="gauge", labels=merged,
                            value=v))
        return out


def latency_bounds() -> list[float]:
    """Geometric bounds 1 µs → ~537 s, growth 2**1/4 (~19%/bucket)."""
    g = 2.0 ** 0.25
    b, out = 1e-6, []
    while b < 600.0:
        out.append(b)
        b *= g
    return out


def bytes_bounds() -> list[float]:
    """Power-of-two byte-size bounds 1 B → 1 TiB."""
    return [float(1 << i) for i in range(41)]


_BOUND_KINDS = {"latency": latency_bounds, "bytes": bytes_bounds}


class Histogram:
    """Fixed log-bucketed histogram with p50/p95/p99/max readout.

    ``observe`` is bisect + increment under the instrument lock; exact
    ``sum``/``min``/``max`` are tracked alongside so max is not a bucket
    estimate. Quantiles interpolate the geometric midpoint of the bucket
    containing the target rank (relative error bounded by bucket growth).
    """

    __slots__ = ("name", "labels", "kind", "_lock", "_bounds", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, labels: dict, kind: str = "latency",
                 bounds: list[float] | None = None):
        self.name = name
        self.labels = labels
        self.kind = kind
        self._bounds = list(bounds) if bounds is not None else _BOUND_KINDS[kind]()
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._bounds) + 1)  # last = overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = 0.0

    def observe(self, v) -> None:
        v = float(v)
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from bucket counts."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = q * total
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank and c:
                    if i == 0:
                        lo, hi = self._bounds[0] / 2.0, self._bounds[0]
                    elif i == len(self._bounds):
                        lo, hi = self._bounds[-1], max(self._max, self._bounds[-1])
                    else:
                        lo, hi = self._bounds[i - 1], self._bounds[i]
                    est = math.sqrt(lo * hi) if lo > 0 else hi / 2.0
                    # clamp to observed range: beats the bucket estimate
                    # at the tails and makes p100 == max exactly
                    return min(max(est, self._min), self._max)
            return self._max

    def summary(self) -> dict:
        return dict(
            count=self._count,
            sum=self._sum,
            min=0.0 if self._count == 0 else self._min,
            max=self._max,
            p50=self.percentile(0.50),
            p95=self.percentile(0.95),
            p99=self.percentile(0.99),
        )

    def sample(self) -> dict:
        with self._lock:
            counts = list(self._counts)
        s = self.summary()
        buckets, acc = [], 0
        for i, c in enumerate(counts):
            acc += c
            if c:
                le = self._bounds[i] if i < len(self._bounds) else math.inf
                buckets.append([le, acc])
        if not buckets or math.isfinite(buckets[-1][0]):
            buckets.append([math.inf, acc])
        s.update(name=self.name, type="histogram", labels=dict(self.labels),
                 buckets=buckets)
        return s


class _NullInstrument:
    """Shared no-op stand-in handed out by a disabled registry."""

    __slots__ = ()
    name = "null"
    labels: dict = {}
    value = 0
    count = 0

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def percentile(self, q):
        return 0.0

    def summary(self):
        return dict(count=0, sum=0.0, min=0.0, max=0.0, p50=0.0, p95=0.0,
                    p99=0.0)

    def sample(self):
        return dict(name="null", type="counter", labels={}, value=0)


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Get-or-create home for named instruments.

    Creation takes the registry lock; the returned instrument is cached by
    the call site, so steady-state updates never touch the registry again.
    ``default_labels`` are stamped on every instrument created here.
    """

    def __init__(self, enabled: bool = True, labels: dict | None = None):
        self.enabled = bool(enabled)
        self.default_labels = dict(labels or {})
        self._lock = threading.Lock()
        self._instruments: dict = {}
        self._multi: list[MultiGauge] = []

    def _merge_labels(self, labels: dict) -> dict:
        merged = dict(self.default_labels)
        merged.update(labels)
        return merged

    def _get_or_create(self, cls, name: str, labels: dict, *args, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        labels = self._merge_labels(labels)
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, *args, **kw)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, fn=None, **labels) -> Gauge:
        g = self._get_or_create(Gauge, name, labels, fn)
        if fn is not None and isinstance(g, Gauge):
            g._fn = fn  # re-registering a callback refreshes it
        return g

    def multi_gauge(self, name: str, fn, **labels) -> MultiGauge:
        """Register a snapshot-time callback yielding many label sets."""
        if not self.enabled:
            return NULL_INSTRUMENT
        mg = MultiGauge(name, self._merge_labels(labels), fn)
        with self._lock:
            self._multi.append(mg)
        return mg

    def histogram(self, name: str, kind: str = "latency",
                  bounds: list[float] | None = None, **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, kind, bounds)

    def snapshot(self, extra_labels: dict | None = None) -> dict:
        """Point-in-time dump of every instrument as plain dicts."""
        with self._lock:
            insts = list(self._instruments.values())
            multi = list(self._multi)
        samples = []
        for inst in insts:
            samples.append(inst.sample())
        for mg in multi:
            samples.extend(mg.samples())
        if extra_labels:
            ex = {str(k): str(v) for k, v in extra_labels.items()}
            for s in samples:
                merged = dict(ex)
                merged.update(s["labels"])
                s["labels"] = merged
        samples.sort(key=lambda s: (s["name"], sorted(s["labels"].items())))
        return {"metrics": samples}


def merge_snapshots(*parts) -> dict:
    """Concatenate snapshots; each part is a snapshot dict or a
    ``(snapshot, extra_labels)`` pair whose labels stamp every sample —
    how per-shard registries become one labelled serving-node view."""
    samples = []
    for part in parts:
        extra = None
        if isinstance(part, tuple):
            part, extra = part
        for s in part.get("metrics", []):
            s = dict(s, labels=dict(s["labels"]))
            if extra:
                merged = {str(k): str(v) for k, v in extra.items()}
                merged.update(s["labels"])
                s["labels"] = merged
            samples.append(s)
    samples.sort(key=lambda s: (s["name"], sorted(s["labels"].items())))
    return {"metrics": samples}


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition format (0.0.4) for a snapshot."""
    by_name: dict[str, list[dict]] = {}
    for s in snapshot.get("metrics", []):
        by_name.setdefault(s["name"], []).append(s)
    lines = []
    for name in sorted(by_name):
        group = by_name[name]
        typ = group[0]["type"]
        lines.append(f"# TYPE {name} {typ}")
        for s in group:
            lbl = s["labels"]
            if typ == "histogram":
                for le, acc in s["buckets"]:
                    b = dict(lbl, le=("+Inf" if math.isinf(le) else repr(le)))
                    lines.append(f"{name}_bucket{_fmt_labels(b)} {acc}")
                lines.append(f"{name}_sum{_fmt_labels(lbl)} {s['sum']}")
                lines.append(f"{name}_count{_fmt_labels(lbl)} {s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(lbl)} {s['value']}")
    return "\n".join(lines) + "\n"


def _sample_key(s: dict) -> tuple:
    return (s["name"], _label_key(s["labels"]))


def diff_snapshots(before: dict, after: dict) -> dict:
    """Per-sample delta (after − before) for counters and histogram
    count/sum; gauges report (before, after). Samples only in one side
    are marked added/removed. Powers ``tools/obstool.py diff``."""
    b = {_sample_key(s): s for s in before.get("metrics", [])}
    a = {_sample_key(s): s for s in after.get("metrics", [])}
    rows = []
    for key in sorted(set(b) | set(a)):
        sb, sa = b.get(key), a.get(key)
        ref = sa or sb
        row = dict(name=ref["name"], labels=dict(ref["labels"]),
                   type=ref["type"])
        if sb is None:
            row["status"] = "added"
            rows.append(row)
            continue
        if sa is None:
            row["status"] = "removed"
            rows.append(row)
            continue
        if ref["type"] == "histogram":
            row["count_delta"] = sa["count"] - sb["count"]
            row["sum_delta"] = sa["sum"] - sb["sum"]
            row["p50"] = sa["p50"]
            row["p99"] = sa["p99"]
        elif ref["type"] == "counter":
            row["delta"] = sa["value"] - sb["value"]
        else:
            row["before"] = sb["value"]
            row["after"] = sa["value"]
        rows.append(row)
    return {"diff": rows}


def save_snapshot(snapshot: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(snapshot, f, indent=1, default=float)


def load_snapshot(path) -> dict:
    with open(path) as f:
        return json.load(f)
