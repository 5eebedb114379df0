"""Kernels (csrc/selector_decode.cu): the least time of every
selector_decode call of the window, from its shapes (perfbench/roofline.py),
as a share of the device time the profiler gave its kernels, in %."""
from perfbench.devtrace import DECODE_KERNELS
from perfbench.roofline import selector_decode_bound


def read(run):
    if run.device is None or not run.kernels.decode:
        return None
    t = run.kernel_seconds(DECODE_KERNELS)
    if t <= 0:
        return None
    rate = run.int_rate()
    bound = sum(selector_decode_bound(n, d, r, rate) for n, d, r in run.kernels.decode)
    return 100.0 * bound / t
