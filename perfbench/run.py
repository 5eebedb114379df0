"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program (``src/repro_torch``). Needs a CUDA card: without one, or
without the program, it exits with another code than 0 and prints no
result. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which also close standard error).
"""
import time

T_BEGIN = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: the loaded modules) that are
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench.spec import Bench

    cell = Bench(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1

    from perfbench.harness import run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                   t_begin=T_BEGIN)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}; the benchmark may load neither JAX nor the "
              "JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
