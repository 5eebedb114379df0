"""Executor (db/executor.py): 95th percentile of the ``queue`` spans of the
window's requests, the wait between submit and a worker's pickup, in ms."""
import numpy as np


def read(run):
    d = [s.duration for s in run.spans("queue")]
    return float(np.percentile(d, 95)) * 1e3 if d else None
