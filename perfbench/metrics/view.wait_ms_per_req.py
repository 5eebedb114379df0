"""Device views (kernels/device_view.py): the ``view.sync`` spans, the host
blocked on each partition's result fetch, in ms a request of the window."""


def read(run):
    sp = run.spans(r"view\.sync")
    return sum(s.duration for s in sp) * 1e3 / len(run.window) if sp else None
