"""The port's observability layer (``repro_torch.obs``, carried from the
reference as plain Python) against ``repro.obs``: each case of
``tests/test_obs.py`` on the metrics registry, the event log and tracing
runs the same calls on both packages; the outputs (snapshots, percentile
estimates, Prometheus text, event records, Chrome trace documents,
sampler picks) must be equal, and the reference case's own assertions
then hold for the port. Wall-clock fields (span times, event times) are
the only ones left out.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.obs import events as RE  # noqa: E402
from repro.obs import metrics as RM  # noqa: E402
from repro.obs import tracing as RT  # noqa: E402
from repro_torch.obs import events as TE  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.obs import tracing as TT  # noqa: E402

PKGS = [(RM, RE, RT), (TM, TE, TT)]


def both(fn):
    """``fn(metrics, events, tracing)`` on the reference's modules and the
    port's; the two results must be equal; the port's is returned."""
    ref, port = (fn(*mods) for mods in PKGS)
    assert ref == port
    return port


def test_counter_gauge_basics():
    def run(M, E, T):
        reg = M.MetricsRegistry(labels=dict(node="a"))
        c = reg.counter("reqs", kind="get")
        c.inc()
        c.inc(4)
        assert reg.counter("reqs", kind="get") is c
        g = reg.gauge("depth")
        g.set(7)
        g.dec(2)
        reg.gauge("live", fn=lambda: 42)
        with pytest.raises(ValueError):
            c.inc(-1)
        return c.value, g.value, reg.snapshot()

    c, g, snap = both(run)
    assert (c, g) == (5, 5)
    names = {(s["name"], tuple(sorted(s["labels"].items()))) for s in snap["metrics"]}
    assert ("reqs", (("kind", "get"), ("node", "a"))) in names


def test_disabled_registry_is_null():
    def run(M, E, T):
        reg = M.MetricsRegistry(enabled=False)
        c = reg.counter("x")
        c.inc(100)
        reg.histogram("z").observe(1.0)
        return c.value, reg.gauge("y", fn=lambda: 9).value, reg.snapshot()

    assert both(run) == (0, 0, {"metrics": []})


def test_histogram_percentiles_vs_numpy():
    obs = np.random.default_rng(7).lognormal(mean=-7.0, sigma=1.2, size=20_000)

    def run(M, E, T):
        h = M.MetricsRegistry().histogram("lat")
        for v in obs:
            h.observe(float(v))
        return [h.percentile(q) for q in (0.5, 0.9, 0.95, 0.99)], h.summary()

    est, s = both(run)
    for q, e in zip((0.5, 0.9, 0.95, 0.99), est):
        ref = float(np.percentile(obs, 100 * q))
        assert abs(e - ref) / ref < 0.1, (q, e, ref)
    assert s["count"] == len(obs)
    assert s["min"] <= s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    assert np.isclose(s["sum"], obs.sum(), rtol=1e-6)


def test_histogram_extremes_clamped():
    def run(M, E, T):
        reg = M.MetricsRegistry()
        h = reg.histogram("b", kind="bytes")
        h.observe(3)
        for v in (0.0, 1e-12, 1e12):
            reg.histogram("wide").observe(v)
        return (h.percentile(0.5), h.percentile(0.99), h.summary(),
                reg.histogram("empty").percentile(0.99),
                reg.histogram("wide").summary())

    p50, p99, s, empty, _ = both(run)
    assert p50 == pytest.approx(3.0, rel=0.5)
    assert p99 <= s["max"] and empty == 0.0


def test_snapshot_merge_diff_prometheus():
    def run(M, E, T):
        r1, r2 = M.MetricsRegistry(), M.MetricsRegistry()
        r1.counter("hits").inc(3)
        r2.counter("hits").inc(5)
        merged = M.merge_snapshots(
            (r1.snapshot(), dict(shard="0")), (r2.snapshot(), dict(shard="1")))
        before = r1.snapshot()
        r1.counter("hits").inc(2)
        r1.histogram("lat").observe(0.5)
        r1.gauge("q", fn=lambda: 3)
        after = r1.snapshot()
        return merged, M.diff_snapshots(before, after), M.render_prometheus(after)

    merged, diff, text = both(run)
    assert {s["labels"]["shard"]: s["value"] for s in merged["metrics"]} == {"0": 3, "1": 5}
    by_name = {row["name"]: row for row in diff["diff"]}
    assert by_name["hits"]["delta"] == 2 and by_name["lat"]["status"] == "added"
    assert "# TYPE hits counter" in text and 'lat_bucket{le="+Inf"} 1' in text
    assert "lat_count 1" in text


def test_registry_threaded_smoke():
    import threading

    def run(M, E, T):
        reg = M.MetricsRegistry()
        c, h = reg.counter("n"), reg.histogram("lat")

        def work():
            for i in range(2000):
                c.inc()
                h.observe(1e-4 * (1 + i % 7))

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return c.value, h.summary()

    n, s = both(run)
    assert n == 16_000 and s["count"] == 16_000


def test_event_log_ring_and_sink(tmp_path):
    def run(M, E, T):
        path = tmp_path / f"{E.__name__}.jsonl"
        log = E.EventLog(capacity=4, jsonl_path=str(path))
        for i in range(6):
            log.emit("tick", i=i)
        evs = [(e.seq, e.kind, e.fields) for e in log.list()]
        st = log.stats()
        log.close()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        with pytest.raises(ValueError):
            E.EventLog(capacity=0)
        assert E.NULL_EVENTS.emit("x") is None and E.NULL_EVENTS.list() == []
        return evs, st, [{k: v for k, v in ln.items() if k not in ("t", "ts", "time")}
                         for ln in lines]

    evs, st, lines = both(run)
    assert [f["i"] for _, _, f in evs] == [2, 3, 4, 5]
    assert evs[0][0] == 3 and evs[-1][0] == 6
    assert st["emitted"] == 6 and st["dropped"] == 2 and st["buffered"] == 4
    assert len(lines) == 6 and lines[0]["kind"] == "tick" and lines[0]["i"] == 0


def test_trace_tree_and_chrome_export():
    def run(M, E, T):
        tr = T.Trace("batch")
        with tr.span("plan"):
            pass
        with tr.span("read", shard=0):
            t0 = T.now()
            tr.leaf("disk_read", t0, T.now(), bytes=512)
        tr.finish()
        assert tr.well_formed()
        doc = json.loads(tr.to_chrome_json())
        evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
               for e in doc["traceEvents"]]
        by = {e["name"]: e for e in doc["traceEvents"]}
        return [s.name for s in tr.spans()], evs, by["batch"]["ts"]

    names, evs, ts0 = both(run)
    assert names == ["batch", "plan", "read", "disk_read"]
    assert all(e["ph"] == "X" for e in evs) and {e["name"] for e in evs} == set(names)
    assert {e["name"]: e for e in evs}["disk_read"]["args"]["bytes"] == 512
    assert ts0 == 0


@pytest.mark.parametrize("rate", [0.0, 0.25, 1 / 3, 1.0])
def test_sampler_rate(rate):
    def run(M, E, T):
        s = T.Sampler(rate)
        with pytest.raises(ValueError):
            T.Sampler(1.5)
        return [s.should_sample() for _ in range(24)]

    picks = both(run)
    if rate == 0.25:
        assert picks == [True, False, False, False] * 6
    assert sum(picks) == int(24 * rate)
