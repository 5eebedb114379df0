"""``BENCHMARK.json`` against the benchmark's contract, and the modules a
run loads."""
import json
import re
import subprocess
import sys

from perfbench_tiny import ROOT

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_keys_names_units_and_bounds():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["perfbench"] and DOC["command"][1] == "perfbench/run.py"
    assert 1 <= DOC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in DOC[k]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in DOC["end_to_end"])
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for m in DOC["per_layer"] + DOC["end_to_end"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")


def test_cells_and_configs():
    configs = {c["name"]: c for c in DOC["configs"]}
    used = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
        per = [m for m in DOC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert per, w["name"]
        for m in per:  # each per-layer metric's cell reports what it moves
            moved = next(e for e in DOC["end_to_end"] if e["name"] == m["moves"])
            assert w["name"] in moved.get("workloads", [w["name"]])
    assert used == set(configs)
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        body = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(body["reduced"])
        assert body["guarantees"] and body["source"].startswith(c["source"])


def test_no_jax_or_reference_package_is_loaded():
    """A run's process loads neither JAX nor the JAX package: top-level
    names compared whole, so the port (``repro_torch``) passes."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import perfbench.run as r\n"
        "sys.path.insert(0, %r)\n"
        "from perfbench_tiny import tiny\n"
        "out = tiny('ycsb-c.kv1k-serve3', trace=True)\n"
        "assert out['correct'], out\n"
        "print(r.forbidden_modules())\n"
    ) % (str(ROOT / "src"), str(ROOT), str(ROOT / "perfbench" / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    import perfbench.run as r

    assert r.forbidden_modules(["repro_torch.db.store", "repro.db.store", "jaxlib.xla",
                                "numpy", "jax_probe", "flax"]) == ["flax", "jaxlib", "repro"]
