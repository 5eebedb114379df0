"""Observability: the metrics registry and the structured event log,
carried from ``repro.obs`` as pure Python (tracing comes later)."""
from repro_torch.obs.events import NULL_EVENTS, Event, EventLog, NullEventLog  # noqa: F401
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
