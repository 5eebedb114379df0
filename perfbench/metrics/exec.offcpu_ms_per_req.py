"""Executor (db/executor.py, its submit workers on one interpreter): the
time a worker was inside a ``shardN:read`` span but neither running on a
CPU nor waiting for the card: the span's wall time less its thread's CPU
time, less the same for the ``view.sync`` spans below it, in ms a request
of the window. None where spans carry no CPU time. Where the thread CPU
clock ticks every 10 ms, the sum over the window's spans is a sampled
estimate."""


def read(run):
    sp = run.spans(r"shard\d+:read")
    if not sp or not hasattr(sp[0], "cpu"):
        return None
    off = 0.0
    for s in sp:
        off += s.duration - s.cpu
        off -= sum(d.duration - d.cpu for d in s.walk() if d.name == "view.sync")
    return off * 1e3 / len(run.window)
