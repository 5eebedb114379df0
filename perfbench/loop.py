"""The closed loop: client threads that each send a request, wait for its
answer, and send the next (YCSB's ``threadcount`` clients, no target
rate). Every request is kept with its interval on the client's clock and
its answer, turned into a few arrays as it comes (the program's per-op
result objects are let go, so the Python collector does not walk hundreds
of thousands of them inside the window); the answers are judged once the
window has closed.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time

now = time.perf_counter
LATE_S = 60.0  # how long past the window's close an answer is waited for
WARMUP_MAX_S = 120.0  # the warm-up ends by then, ready or not


@dataclasses.dataclass
class Record:
    req: object  # traffic.Request
    t0: float  # sent (perf_counter seconds)
    t1: float  # answered; inf if the answer never came
    ans: dict | None  # the answer as the harness reads it (None: never came)
    trace: object = None  # the program's span tree of a traced request
    error: str | None = None


def _client(system, stream, trace, go, deadline, stop_rule, out):
    go.wait()
    while not stop_rule(len(out)):
        req = stream.next()
        t0 = now()
        try:
            fut = system.submit(req, trace)
            raw = fut.result(timeout=max(1.0, deadline() - now()))
            t1 = now()
            ans = system.normalize(req, raw)
        except concurrent.futures.TimeoutError:
            out.append(Record(req, t0, float("inf"), None, error="no answer"))
            return
        except Exception as e:  # a request that raised, or an answer that
            # cannot be read, never answered: every op of it is wrong
            out.append(Record(req, t0, float("inf"), None, error=repr(e)))
            return
        out.append(Record(req, t0, t1, ans, getattr(raw, "trace", None)))


def closed_loop(system, streams, *, seconds: float | None = None,
                requests: int = 0, ready=None, trace: bool = False):
    """Run one client thread per stream. With ``seconds``: until the window
    closes (no request is sent after that). Otherwise each client sends at
    least ``requests``, and goes on until ``ready()`` holds or
    ``WARMUP_MAX_S`` have passed. Returns (records, window start, window
    end)."""
    go = threading.Event()
    box = {}
    outs = [[] for _ in streams]
    if seconds is not None:
        rule = lambda n: now() >= box["end"]  # noqa: E731
        deadline = lambda: box["end"] + LATE_S  # noqa: E731
    else:
        def rule(n):
            return n >= requests and (ready is None or ready()
                                      or now() > box["start"] + WARMUP_MAX_S)
        deadline = lambda: box["start"] + WARMUP_MAX_S + LATE_S  # noqa: E731
    threads = [threading.Thread(target=_client, daemon=True,
                                args=(system, s, trace, go, deadline, rule, o))
               for s, o in zip(streams, outs)]
    for t in threads:
        t.start()
    box["start"] = now()
    box["end"] = box["start"] + (seconds or 0.0)
    go.set()
    for t in threads:
        t.join()
    recs = [r for o in outs for r in o]
    return recs, box["start"], box["end"]
