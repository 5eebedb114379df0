"""The readers of the spans inside ``shardN:read`` (``view.dispatch``,
``view.sync``, ``store.overlay``, ``exec.keys`` / ``exec.results`` and
each span's CPU time) in tiny runs of every cell on the CPU, and against
a program whose traces have none of them.

``BENCHMARK.json`` does not list these readers yet: adding them changes
the set of per-layer metrics that ``test_perfbench_cells.py`` expects of
a traced run. Here they are added to a copy of the benchmark as entries
alone, the way the benchmark will take them."""
import json
import types

import pytest

from perfbench_tiny import ROOT, bench_copy, tiny

from perfbench.harness import Run
from perfbench.spec import Bench

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
LAYERS = {"view.dispatch_ms_per_req": "device views", "view.wait_ms_per_req": "device views",
          "store.overlay_ms_per_req": "store read path and cursor",
          "exec.ops_ms_per_req": "executor", "exec.offcpu_ms_per_req": "executor"}
SPLIT = list(LAYERS)


def split_bench(tmp_path):
    """A copy of the benchmark with the five readers as ``per_layer``
    entries of both cells; returns its root."""
    doc = bench_copy(tmp_path)
    doc["per_layer"] += [dict(name=n, unit="ms", better="lower", source="program_span",
                              layer=layer, moves="ops_per_s", workloads=CELLS)
                         for n, layer in LAYERS.items()]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path


def test_the_entries_name_existing_layers_and_readers(tmp_path):
    doc = json.loads((split_bench(tmp_path) / "BENCHMARK.json").read_text())
    known = {m["layer"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    new = doc["per_layer"][-len(SPLIT):]
    assert {m["layer"] for m in new} <= known
    assert all((ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file() for m in new)
    assert not set(SPLIT) & {m["name"] for m in doc["per_layer"][:-len(SPLIT)]}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_splits_the_read(cell, tmp_path):
    out = tiny(cell, trace=True, seconds=0.5, root=split_bench(tmp_path))
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert set(SPLIT) <= set(m)
    assert all(m[k]["value"] >= 0 and m[k]["unit"] == "ms" for k in SPLIT)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_no_split(cell, tmp_path):
    out = tiny(cell, root=split_bench(tmp_path))
    assert out["correct"], out["checks"]
    assert not set(SPLIT) & set(out["metrics"])


class _OldSpan:
    """A span as a program without CPU clocks records it."""

    def __init__(self, name, t0, t1, children=()):
        self.name, self.t0, self.t1, self.children = name, t0, t1, list(children)

    @property
    def duration(self):
        return self.t1 - self.t0

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def test_readers_find_nothing_in_a_program_without_the_spans():
    """Against a program whose read spans have no children and no CPU time
    (the one before these spans), each reader returns None, not a number
    or an error."""
    read = _OldSpan("shard0:read", 0.0, 0.05, [_OldSpan("cache_fetch", 0.01, 0.02)])
    root = _OldSpan("batch", 0.0, 0.06, [_OldSpan("plan", 0.0, 0.001), read])
    trace = types.SimpleNamespace(spans=lambda: list(root.walk()))
    bench = Bench(ROOT)
    cell = bench.cell(CELLS[0])
    run = Run(cell, bench.mix(cell), 1.0, 1.0, [types.SimpleNamespace(trace=trace)],
              0.0, 1.0, {}, {})
    assert [bench.reader(name)(run) for name in SPLIT] == [None] * len(SPLIT)
