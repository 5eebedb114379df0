"""Benchmark harness: one module per paper table/figure.

``python -m repro_torch.bench.run [--only fig11,...] [--device cuda|cpu]``
prints name,us_per_call,derived CSV rows for every experiment (paper §5 at
the reference's sizes). The reference's other benchmarks
(``benchmarks/run.py``) are not ported.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.bench.common import CSV


def benches(device: str) -> dict:
    from repro_torch.bench import (
        fig11_queries,
        fig13_groupsize,
        fig14_16_stores,
        fig17_ycsb,
        table1_storage,
    )

    return {
        "fig11": lambda c: fig11_queries.run(c, locality="weak", device=device),
        "fig12": lambda c: fig11_queries.run(c, locality="strong", device=device),
        "fig13": lambda c: fig13_groupsize.run(c, device=device),
        "table1": lambda c: table1_storage.run(c, device=device),
        "fig14_16": lambda c: fig14_16_stores.run(c, device=device),
        "fig17": lambda c: fig17_ycsb.run(c, device=device),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma list of bench names")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    table = benches(args.device)
    names = args.only.split(",") if args.only else list(table)
    csv = CSV()
    print("name,us_per_call,derived")
    failures = 0
    for name in names:
        t0 = time.time()
        try:
            table[name](csv)
        except Exception:
            failures += 1
            traceback.print_exc()
            csv.emit(f"{name}_FAILED", -1.0, "exception")
        print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
