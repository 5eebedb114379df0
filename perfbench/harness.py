"""One run of one cell: set-up, the measured window, the comparison, the
metrics.

Set-up, in order: the card (CUDA init and the port's kernel build, served
from ``build/`` in the checkout after the first run), the load (every key
of the configuration in random order through ``put_batch``, then a
flush), and a warm-up of the cell's own mix until every partition holds
what its reads use on the device. Then the clients run the window; with
``trace`` each request carries ``Batch(trace=True)``, the profiler
records the device and a wrapper records the kernels' operands. Once the
window has closed the device's peak memory is read, every written key
and a sample of the loaded ones are read back through the program, the
program is closed, and the answers are judged (``check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import re
import shutil
import sys
import tempfile
import time

import numpy as np

from perfbench import check, devtrace, loop, traffic
from perfbench.spec import Bench


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: dict
    mix: traffic.Mix
    seconds: float
    setup_s: float
    window: list  # records of the requests sent in the window
    t_start: float
    t_end: float
    before: dict  # the program's counters as the window opened
    after: dict  # ... and once every request of the window came back
    device: object = None  # devtrace.DeviceTrace of a traced run
    kernels: object = None  # devtrace.KernelCalls of a traced run
    int_rate: object = None  # callable: the card's INT32 ops/s

    def completed(self) -> list:
        """Requests sent and answered inside the window."""
        return [r for r in self.window if r.t1 <= self.t_end]

    def ok_ops(self, records=None) -> int:
        return sum(int(r.ans["ok"].sum()) for r in (records or self.completed()) if r.ans)

    def spans(self, pattern: str) -> list:
        """Program spans of the window's requests whose name matches."""
        rx = re.compile(pattern)
        out = []
        for r in self.window:
            if r.trace is not None:
                out.extend(s for s in r.trace.spans() if rx.fullmatch(s.name))
        return out

    def kernel_seconds(self, names) -> float:
        """Device seconds of the profiler's events named like ``names``."""
        return float(sum(t for n, t in self.device.totals.items()
                         if any(k in n for k in names)))


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_begin: float | None = None,
             control: bool = False, overrides: dict | None = None) -> dict:
    """Run ``workload`` once; returns the result line as a dict. ``control``
    serves the reference store in the program's place; ``overrides`` merge
    into the configuration (small CPU runs in the tests)."""
    t_begin = time.perf_counter() if t_begin is None else t_begin
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg = _merge(bench.config(cell), overrides or {})
    mix = bench.mix(cell)
    cuda = device == "cuda"
    phases = {}
    tick = [t_begin]

    def phase(name):
        t = time.perf_counter()
        phases[name] = round(t - tick[0], 3)
        tick[0] = t

    import torch

    phase("imports")
    if cuda:
        torch.cuda.init()
        phase("cuda_init")
        if not control:
            from repro_torch.device import kernel_library

            kernel_library()
            phase("kernel_build")
    vw = int(cfg["system"]["vw"])
    keys, vals = traffic.load_set(seed, int(cfg["keys"]), vw)
    phase("data")
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        if control:
            from perfbench.system import ControlSystem

            system = ControlSystem(cfg)
        else:
            from perfbench.system import ProgramSystem

            system = ProgramSystem(cfg, tmp, device)
        system.load(keys, vals)
        phase("load_and_flush")
        tr = traffic.Traffic(mix, seed, keys, vw)
        warm = [tr.client(c, stream=3) for c in range(mix.clients)]
        records, _, _ = loop.closed_loop(
            system, warm, requests=mix.warmup_requests,
            ready=lambda: system.resident(mix))
        if cuda:
            torch.cuda.synchronize()
        gc.collect()  # set-up's garbage is not the window's to collect
        phase("warm_up")
        setup_s = time.perf_counter() - t_begin
        print(f"setup {setup_s:.3f} s: {phases}", file=sys.stderr)
        streams = [tr.client(c, stream=2) for c in range(mix.clients)]
        before = system.counters()
        dev = calls = None
        if trace and cuda:
            calls = devtrace.KernelCalls().__enter__()
            dev = devtrace.DeviceTrace()
            dev.start()
        window, t_start, t_end = loop.closed_loop(system, streams, seconds=seconds,
                                                  trace=trace)
        if dev is not None:
            dev.stop()
            calls.__exit__()
            print(f"trace: {len(dev.names)} device events read in {dev.parse_s:.3f} s; "
                  f"{len(calls.anchor)} anchor_search, {len(calls.decode)} selector_decode "
                  "calls", file=sys.stderr)
        after = system.counters()
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        records += window
        written, sample = check.readback_keys(records, keys, seed)
        rb_found, rb_vals = system.readback(np.concatenate([written, sample]))
        run = Run(cell, mix, seconds, setup_s, window, t_start, t_end, before, after,
                  dev, calls)
        if trace and cuda:
            from perfbench.roofline import int32_rate

            run.int_rate = int32_rate
        metrics = {}
        t_read = time.perf_counter()
        for m in bench.metrics(cell, trace):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        t_judge = time.perf_counter()
        system.close()
        del system
        if cuda:
            torch.cuda.empty_cache()
        numbers = check.judge(records, keys, vals, written, sample, rb_found, rb_vals,
                              epoch=t_begin)
        print(f"after the window: metrics {t_judge - t_read:.3f} s, comparison "
              f"{time.perf_counter() - t_judge:.3f} s over {len(records)} requests",
              file=sys.stderr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kinds = {k for k, p in mix.proportions.items() if p > 0}
    checks = check.compared(numbers, kinds)
    attempted = sum(len(r.req) for r in window)
    failed = sum(len(r.req) - (int(r.ans["ok"].sum()) if r.ans else 0) for r in window)
    out = dict(
        correct=all(c["value"] <= c["limit"] for c in checks.values()),
        attempted=attempted, failed=failed, metrics=metrics,
        device=dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                    count=1 if cuda else 0, memory_peak_bytes=peak),
    )
    if dev is not None:
        busy = devtrace.union(dev.intervals, t_start, t_end)
        out["device"]["busy_s"] = float((busy[:, 1] - busy[:, 0]).sum())
        out["device"]["window_s"] = float(t_end - t_start)
        ops = sorted(dev.totals.items(), key=lambda kv: -kv[1])[:10]
        idle = devtrace.gaps(busy, t_start, t_end)
        out["breakdown"] = dict(
            device_ops=[[n[:120], s] for n, s in ops],
            idle_gaps=devtrace.label_gaps(idle, devtrace.host_spans(window)),
        )
    out["checks"] = checks
    return out
