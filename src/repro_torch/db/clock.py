"""Wall-clock source for per-key TTL expiry.

Every liveness decision (``exp != 0 and exp <= clock.now()``) goes
through :func:`now` so tests can drive a logical clock: monkeypatch
``repro_torch.db.clock.now`` (or use :func:`set_source`) and expiry becomes
deterministic. ``exp`` values are absolute unix seconds stored as u32;
0 means "no TTL".
"""
from __future__ import annotations

import time as _time

_source = _time.time


def now() -> float:
    """Current time in seconds (patchable)."""
    return _source()


def set_source(fn) -> None:
    """Install an alternative time source (tests: a logical clock)."""
    global _source
    _source = fn


def reset() -> None:
    global _source
    _source = _time.time
