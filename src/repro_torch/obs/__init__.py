"""Observability: the metrics registry, sampled span tracing and the
structured event log, carried from ``repro.obs`` as pure Python."""
from repro_torch.obs.events import NULL_EVENTS, Event, EventLog, NullEventLog  # noqa: F401
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
from repro_torch.obs.tracing import Sampler, Span, Trace, activate, current  # noqa: F401
