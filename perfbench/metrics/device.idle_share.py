"""Device: the share of the window in which no CUDA activity ran (1 - the
union of the profiler's device events over the window), in %."""
from perfbench.devtrace import union


def read(run):
    if run.device is None:
        return None
    busy = union(run.device.intervals, run.t_start, run.t_end)
    return 100.0 * (1.0 - float((busy[:, 1] - busy[:, 0]).sum()) / (run.t_end - run.t_start))
