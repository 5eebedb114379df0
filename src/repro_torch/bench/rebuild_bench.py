"""REMIX (re)build cost: CKB-based incremental vs from-scratch (Snippet 1).

The port of ``benchmarks/rebuild_bench.py``. The Snippet-1 experiment: a partition holds R table files on disk and a
minor compaction appends one freshly flushed table. Building the new REMIX
  - from scratch reads every old table's key-value data (keys, vals, seq,
    tomb sections) and re-sorts all keys;
  - incrementally reads only the old tables' Compressed Keys Blocks plus
    the old REMIX's selector stream, and never touches a value block.
Both must produce bit-identical REMIX structures; the incremental path is
what buys the reference implementation its 2x random-write throughput.

Both REMIX land on the run's device. ``python -m
repro_torch.bench.rebuild_bench [--device cpu]`` or
``python -m repro_torch.bench.run --only rebuild``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.bench.common import CSV, sync
from repro_torch.core.remix import build_remix
from repro_torch.core.runs import make_run
from repro_torch.db.partition import Table
from repro_torch.device import u32_np
from repro_torch.io.rebuild import incremental_build_remix
from repro_torch.io.remix_io import dump_remix, load_remix
from repro_torch.io.sstable import write_sstable

R_OLD = 8
N_PER_TABLE = 16384
D = 32


def _setup(root: str, seed: int = 0, device="cuda"):
    """R_OLD tables on disk (with CKBs) + their REMIX file + one new run
    (on ``device``)."""
    rng = np.random.default_rng(seed)
    total = (R_OLD + 1) * N_PER_TABLE
    domain = np.arange(1, total + 1, dtype=np.uint64) * 64
    owner = rng.integers(0, R_OLD + 1, total)
    paths, runs, seqbase = [], [], 1
    for i in range(R_OLD):
        kk = domain[owner == i]
        seqs = np.arange(seqbase, seqbase + len(kk), dtype=np.uint32)
        seqbase += len(kk)
        run = make_run(kk, seq=seqs, sort=True, device="cpu")
        p = os.path.join(root, f"t-{i:06d}.sst")
        write_sstable(
            p, u32_np(run.keys), u32_np(run.vals), u32_np(run.seq),
            run.tomb.numpy(),
        )
        paths.append(p)
        runs.append(run)
    old_remix, _ = build_remix(runs, d=D)
    rpath = os.path.join(root, "x-000000.rmx")
    dump_remix(old_remix, rpath)
    kk = domain[owner == R_OLD]  # the freshly flushed (in-memory) table
    new_run = make_run(
        kk, seq=np.arange(seqbase, seqbase + len(kk), dtype=np.uint32),
        sort=True, device=device,
    )
    return paths, rpath, new_run


def _fresh_handles(paths):
    """New lazy handles so per-section read accounting starts at zero."""
    return [Table.from_file(p) for p in paths]


def _section_bytes(tables, sections):
    return sum(t._rd().bytes_read[s] for t in tables for s in sections)


def run(csv: CSV, device="cuda") -> None:
    with tempfile.TemporaryDirectory(prefix="rebuild-bench-") as root:
        paths, rpath, new_run = _setup(root, device=device)
        nk = [u32_np(new_run.keys)]
        ns = [u32_np(new_run.seq)]

        # ---- from scratch: read old tables' KV data, global re-sort ----
        tabs = _fresh_handles(paths)
        t0 = time.perf_counter()
        runs = [
            make_run(t.keys, t.vals, seq=t.seq, tomb=t.tomb, sort=False,
                     device=device)
            for t in tabs
        ] + [new_run]
        scratch, _ = build_remix(runs, d=D)
        sync()
        t_scratch = time.perf_counter() - t0
        kv_scratch = _section_bytes(tabs, ("keys", "vals", "seq", "tomb"))
        val_scratch = _section_bytes(tabs, ("vals",))

        # ---- incremental: old REMIX + CKBs only ----
        tabs = _fresh_handles(paths)
        t0 = time.perf_counter()
        old_remix = load_remix(rpath, device=device)
        inc = incremental_build_remix(
            old_remix, [t.key_words() for t in tabs], nk, ns, d=D
        )
        sync()
        t_inc = time.perf_counter() - t0
        ckb_inc = _section_bytes(tabs, ("ckb",))
        val_inc = _section_bytes(tabs, ("vals",))
        kv_inc = _section_bytes(tabs, ("keys", "vals", "seq", "tomb"))

        identical = all(
            torch.equal(getattr(scratch, f), getattr(inc, f))
            for f in ("anchors", "cursors", "selectors")
        ) and int(scratch.n_entries) == int(inc.n_entries)

    n = R_OLD * N_PER_TABLE
    csv.emit("rebuild_scratch", t_scratch * 1e6,
             f"kv_bytes_read={kv_scratch};value_bytes_read={val_scratch}")
    csv.emit("rebuild_incremental", t_inc * 1e6,
             f"ckb_bytes_read={ckb_inc};value_bytes_read={val_inc};"
             f"kv_bytes_read={kv_inc}")
    csv.emit(
        "rebuild_summary", 0.0,
        f"n_old_entries={n};speedup={t_scratch / max(t_inc, 1e-9):.2f}x;"
        f"read_reduction={kv_scratch / max(ckb_inc, 1):.2f}x;"
        f"bit_identical={identical}",
    )
    if not identical:
        raise AssertionError("incremental REMIX differs from scratch build")
    if val_inc != 0:
        raise AssertionError(
            f"incremental rebuild read {val_inc} value bytes (expected 0)"
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, device=args.device)
