"""Device views (kernels/device_view.py): the ``view.dispatch`` spans, the
host enqueueing each partition's query upload, kernel composition, pinned
buffers and copies, in ms a request of the window."""


def read(run):
    sp = run.spans(r"view\.dispatch")
    return sum(s.duration for s in sp) * 1e3 / len(run.window) if sp else None
