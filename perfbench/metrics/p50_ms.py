"""Median latency of the requests sent and answered in the window, in ms."""
import numpy as np


def read(run):
    lat = [r.t1 - r.t0 for r in run.completed()]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
