"""The control of a cell: the reference store served in the program's place
(each value word cut to 16 bits, ``reference/store.py``) under the cell's
own configuration and traffic, judged by the same comparison. Every seed
has to come out not correct; the smallest of its numbers is the upper
reading of each limit.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3

Prints one JSON line a seed: the seed, ``correct`` and the numbers compared.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness import run_cell

    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(ROOT, args.workload, seed, args.seconds, False, device="cpu",
                       control=True)
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=out["correct"],
                              attempted=out["attempted"], checks=out["checks"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
