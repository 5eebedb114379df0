"""95th percentile latency of all requests sent and answered in the window,
in ms (over every request, not per chunk)."""
import numpy as np


def read(run):
    lat = [r.t1 - r.t0 for r in run.completed()]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
