"""Kernels (csrc/anchor_search.cu): the least time of every anchor_search
call of the window, from its operands (perfbench/roofline.py), as a share
of the device time the profiler gave its kernels, in %."""
from perfbench.devtrace import ANCHOR_KERNELS
from perfbench.roofline import anchor_search_bound


def read(run):
    if run.device is None or not run.kernels.anchor:
        return None
    t = run.kernel_seconds(ANCHOR_KERNELS)
    if t <= 0:
        return None
    rate = run.int_rate()
    groups = {}
    for anchors, q in run.kernels.anchor:
        groups.setdefault((id(anchors), q.shape[0]), (anchors, []))[1].append(q)
    bound = sum(anchor_search_bound(a, qs, rate) for a, qs in groups.values())
    return 100.0 * bound / t
