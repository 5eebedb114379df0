"""Render the dry-run and roofline markdown tables from dry-run records.

    python -m repro_torch.launch.dryrun --all --out base.jsonl [--device cpu]
    python -m repro_torch.tools.mk_tables --base base.jsonl [--opt opt.jsonl] [all|dryrun|roofline]

The port of ``results/mk_tables.py``. Each record goes through
:func:`repro_torch.launch.roofline.analyze_cell` without an HLO file (the
port has none). Against the reference's tables: the column ``compile s``
is ``trace s``, the record's ``trace_s``; the roofline table keeps the
port's single-pod production mesh, ``32x8`` (the reference's ``16x16``);
and the records come from the paths given, not from fixed names.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.launch.roofline import analyze_cell

SINGLE_POD = "32x8"


def load(path: str) -> list[dict]:
    """One row per (arch, shape, mesh), the first record of each: analysed
    when its status is ``ok``, else the record as it is."""
    rows = []
    seen = set()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            key = (rec["arch"], rec["shape"], rec["mesh"])
            if key in seen:
                continue
            seen.add(key)
            rows.append(analyze_cell(rec) if rec.get("status") == "ok" else rec)
    return rows


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(rows):
    out = [
        "| arch | shape | mesh | trace s | HLO GFLOP/dev | state GiB/dev | temp GiB/dev | collective ops |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — | "
                f"SKIPPED: {r.get('reason','')[:48]} |"
            )
            continue
        counts = r.get("collectives", {}).get("counts", {})
        cstr = " ".join(f"{k.split('-')[-1]}×{v}" for k, v in sorted(counts.items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('trace_s','')} "
            f"| {r['flops_per_dev']/1e9:,.0f} | {fmt_bytes(r['arg_bytes'])} "
            f"| {fmt_bytes(r['temp_bytes'])} | {cstr} |"
        )
    return "\n".join(out)


def roofline_table(rows, other=None):
    """Single-pod roofline table; optional second sweep for before/after."""
    key = lambda r: (r["arch"], r["shape"])  # noqa: E731
    omap = {key(r): r for r in (other or []) if r.get("status") == "ok"}
    out = [
        "| arch | shape | compute s | memory s | collective s | bottleneck | useful | roofline% |"
        + (" opt roofline% | Δ |" if other else ""),
        "|---|---|---|---|---|---|---|---|" + ("---|---|" if other else ""),
    ]
    for r in rows:
        if r.get("status") != "ok" or r["mesh"] != SINGLE_POD:
            continue
        line = (
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.2f} | "
            f"{r['t_memory']:.2f} | {r['t_collective']:.2f} | "
            f"{r['bottleneck']} | {r.get('useful_ratio', 0):.2f} | "
            f"{100*r.get('roofline_frac', 0):.2f}% |"
        )
        if other:
            o = omap.get(key(r))
            if o and o["mesh"] == SINGLE_POD:
                d = 100 * (o.get("roofline_frac", 0) - r.get("roofline_frac", 0))
                line += f" {100*o.get('roofline_frac',0):.2f}% | {d:+.2f}pp |"
            else:
                line += " — | — |"
        out.append(line)
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=("all", "dryrun", "roofline"))
    ap.add_argument("--base", required=True, help="dry-run records (JSONL)")
    ap.add_argument("--opt", default=None, help="a second sweep's records, for before/after")
    args = ap.parse_args(argv)
    base = load(args.base)
    opt = None
    if args.opt:
        opt = [r for r in load(args.opt)
               if r.get("mesh") == SINGLE_POD or r.get("status") != "ok"]
    if args.which in ("all", "dryrun"):
        print("### Dry-run (both meshes)\n")
        print(dryrun_table(base))
    if args.which in ("all", "roofline"):
        print(f"\n### Roofline (single-pod {SINGLE_POD.replace('x', '×')})\n")
        print(roofline_table(base, opt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
