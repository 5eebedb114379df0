"""Executor (db/executor.py ``_exec_points``): the ``exec.keys`` and
``exec.results`` spans, collecting a read group's keys from its ops and
building one result an op, in ms a request of the window."""


def read(run):
    sp = run.spans(r"exec\.(keys|results)")
    return sum(s.duration for s in sp) * 1e3 / len(run.window) if sp else None
