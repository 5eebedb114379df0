"""Observability: the metrics registry, sampled span tracing and the
structured event log, carried from ``repro.obs`` as pure Python."""
from repro_torch.obs.events import NULL_EVENTS, Event, EventLog, NullEventLog
from repro_torch.obs.metrics import (
    NULL_INSTRUMENT,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MultiGauge,
    diff_snapshots,
    load_snapshot,
    merge_snapshots,
    render_prometheus,
    save_snapshot,
)
from repro_torch.obs.tracing import Sampler, Span, Trace, activate, current

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MultiGauge",
    "NULL_INSTRUMENT", "diff_snapshots", "load_snapshot", "merge_snapshots",
    "render_prometheus", "save_snapshot",
    "Event", "EventLog", "NullEventLog", "NULL_EVENTS",
    "Sampler", "Span", "Trace", "activate", "current",
]
