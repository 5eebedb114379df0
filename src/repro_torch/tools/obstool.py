"""Inspect observability snapshots (``RemixDB.metrics()`` /
``KVServeEngine.metrics()`` JSON dumps, see docs/OBSERVABILITY.md).

    python -m repro_torch.tools.obstool show snap.json [--prom] [--filter SUBSTR]
    python -m repro_torch.tools.obstool diff before.json after.json [--filter SUBSTR]
    python -m repro_torch.tools.obstool health DATA_DIR [--scrub] [--json] [--device cpu]

``show`` pretty-prints every sample (or the Prometheus text exposition
with ``--prom``); ``diff`` prints per-sample deltas — counter increases,
histogram count/sum growth with current p50/p99, gauge before→after.
``--filter`` keeps samples whose metric name contains the substring.
``health`` opens a store read-only-style, prints its durability summary
(``RemixDB.health()``), optionally running a full synchronous scrub
first (``--scrub`` — detection *and* self-repair, see
docs/ARCHITECTURE.md "Durability, scrubbing & repair"); exits non-zero
when the store is degraded. The port of ``tools/obstool.py``; ``health``
opens the store on ``--device`` (the card by default).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.metrics import (
    _fmt_labels,
    diff_snapshots,
    load_snapshot,
    render_prometheus,
)


def _keep(snapshot: dict, substr: str | None) -> dict:
    if not substr:
        return snapshot
    return {
        "metrics": [
            s for s in snapshot.get("metrics", []) if substr in s["name"]
        ]
    }


def _show(args) -> int:
    snap = _keep(load_snapshot(args.snapshot), args.filter)
    if args.prom:
        sys.stdout.write(render_prometheus(snap))
        return 0
    for s in snap.get("metrics", []):
        head = f"{s['name']}{_fmt_labels(s['labels'])}"
        if s["type"] == "histogram":
            print(
                f"{head}  count={s['count']} sum={s['sum']:.6g} "
                f"p50={s['p50']:.6g} p95={s['p95']:.6g} "
                f"p99={s['p99']:.6g} max={s['max']:.6g}"
            )
        else:
            print(f"{head}  {s['type']}={s['value']}")
    return 0


def _diff(args) -> int:
    before = _keep(load_snapshot(args.before), args.filter)
    after = _keep(load_snapshot(args.after), args.filter)
    changed = 0
    for row in diff_snapshots(before, after)["diff"]:
        head = f"{row['name']}{_fmt_labels(row['labels'])}"
        if "status" in row:
            print(f"{head}  [{row['status']}]")
            changed += 1
        elif row["type"] == "histogram":
            if row["count_delta"] or row["sum_delta"]:
                print(
                    f"{head}  +count={row['count_delta']} "
                    f"+sum={row['sum_delta']:.6g} "
                    f"p50={row['p50']:.6g} p99={row['p99']:.6g}"
                )
                changed += 1
        elif row["type"] == "counter":
            if row["delta"]:
                print(f"{head}  +{row['delta']}")
                changed += 1
        elif row["before"] != row["after"]:
            print(f"{head}  {row['before']} -> {row['after']}")
            changed += 1
    print(f"# {changed} sample(s) changed")
    return 0


def _health(args) -> int:
    from repro_torch.db.store import RemixDB, RemixDBConfig

    db = RemixDB.open(args.data_dir, RemixDBConfig(device=args.device))
    try:
        scrub_report = db.scrub(full=True) if args.scrub else None
        h = db.health()
    finally:
        db.close()
    if args.json:
        out = dict(health=h)
        if scrub_report is not None:
            out["scrub"] = scrub_report
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(f"status: {h['status']}")
        if scrub_report is not None:
            print(
                f"scrub: clean={scrub_report['clean']} "
                f"files={scrub_report['files_checked']} "
                f"bytes={scrub_report['bytes_read']} "
                f"repaired={len(scrub_report['repaired'])} "
                f"quarantined={len(scrub_report['quarantined'])}"
            )
        print(
            f"corruption_detected: {h['corruption_detected']}  "
            f"io_retries: {h['io']['retries']}  "
            f"io_giveups: {h['io']['giveups']}"
        )
        print(
            f"repair: remix_rebuilt={h['repair']['remix_rebuilt']} "
            f"tables_quarantined={h['repair']['tables_quarantined']} "
            f"quarantine_purged={h['repair']['quarantine_purged']}"
        )
        print(f"quarantine_files: {h['quarantine_files']}")
        for p in h["partitions"]:
            flag = "DEGRADED" if p["degraded"] else "ok"
            print(f"  partition lo={p['lo']} tables={p['tables']} [{flag}]")
        for s in h["unavailable"]:
            hi = "inf" if s["hi"] is None else s["hi"]
            print(
                f"  unavailable span [{s['lo']}, {hi}] "
                f"(quarantined: {', '.join(s['tables'])})"
            )
    return 0 if h["status"] == "ok" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="obstool", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("show", help="pretty-print one snapshot")
    ps.add_argument("snapshot")
    ps.add_argument("--prom", action="store_true",
                    help="Prometheus text exposition format")
    ps.add_argument("--filter", default=None,
                    help="keep metrics whose name contains this substring")
    ps.set_defaults(fn=_show)
    pd = sub.add_parser("diff", help="delta between two snapshots")
    pd.add_argument("before")
    pd.add_argument("after")
    pd.add_argument("--filter", default=None)
    pd.set_defaults(fn=_diff)
    ph = sub.add_parser(
        "health", help="durability summary (optionally scrub first)"
    )
    ph.add_argument("data_dir")
    ph.add_argument("--scrub", action="store_true",
                    help="run a full synchronous scrub (detect + repair) "
                         "before reporting")
    ph.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ph.add_argument("--device", default="cuda",
                    help="the store's device (cuda or cpu)")
    ph.set_defaults(fn=_health)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
