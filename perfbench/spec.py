"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``file`` in ``configs``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); a metric is read by
``perfbench/metrics/<name>.py``, whose ``read(run)`` returns a number or
None (nothing to read). Adding a cell, a mix, a configuration or a metric
is adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from perfbench.traffic import Mix


class Bench:
    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def mix(self, cell: dict) -> Mix:
        return Mix.from_file(self.root / "perfbench" / "traffic" / f"{cell['traffic']}.json")

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: end-to-end ones untraced,
        per-layer ones traced; those limited to some cells only there."""
        group = self.doc["per_layer"] if trace else self.doc["end_to_end"]
        return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        path = self.root / "perfbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
