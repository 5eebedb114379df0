"""Integrity scrub + repair cost.

The port of ``benchmarks/scrub_bench.py``. Three numbers an operator needs before enabling the background scrubber:

- ``scrub_full``: unthrottled verification throughput — every table
  checksum granule + REMIX CRC + manifest agreement on a pinned Version
  (the ``db.scrub(full=True)`` operator call), reported as us/call with
  MB/s verified in the derived column;
- ``scrub_paced``: the same pass under a byte-budget rate limit (the
  background mode), confirming the limiter holds the configured rate;
- ``repair_remix``: the self-heal round trip — at-rest bit rot injected
  into the REMIX file, then scrub → CKB rebuild → manifest commit, with
  reads verified bit-identical afterwards.

``python -m repro_torch.bench.scrub_bench [--device cpu]`` or
``python -m repro_torch.bench.run --only scrub``.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import tempfile
import time

import numpy as np

from repro_torch.bench.common import CSV
from repro_torch.db.compaction import CompactionConfig
from repro_torch.db.store import RemixDB, RemixDBConfig
from repro_torch.io.faults import flip_bytes

N_KEYS = 40_000
PACED_BPS = 4 << 20  # background budget: 4 MiB/s


def _cfg(device):
    return RemixDBConfig(
        vw=2,
        device=device,
        memtable_entries=1 << 30,
        compaction=CompactionConfig(table_cap=1 << 14, t_max=8),
    )


def _seed(root: str, device) -> RemixDB:
    db = RemixDB.open(root, _cfg(device))
    ks = np.arange(1, N_KEYS + 1, dtype=np.uint64) * 16
    vs = np.stack([ks & 0xFFFFFFFF, ks >> 32], 1).astype(np.uint32)
    db.put_batch(ks, vs)
    db.flush()
    return db


def run(csv: CSV, device="cuda") -> None:
    with tempfile.TemporaryDirectory(prefix="scrub-bench-") as tmp:
        _run(csv, os.path.join(tmp, "db"), device)


def _run(csv: CSV, root: str, device) -> None:
    db = _seed(root, device)

    # full-throttle pass (warm one first: file handles, CKB memos)
    db.scrub(full=True)
    t0 = time.perf_counter()
    rep = db.scrub(full=True)
    dt = time.perf_counter() - t0
    assert rep["clean"]
    mbps = rep["bytes_read"] / max(dt, 1e-9) / 1e6
    csv.emit(
        "scrub_full", dt * 1e6,
        f"files={rep['files_checked']} mb_per_s={mbps:.1f}",
    )

    # paced pass: the limiter must hold ~PACED_BPS (one 4 MiB/s window)
    db.cfg = dataclasses.replace(db.cfg, scrub_bytes_per_sec=PACED_BPS)
    t0 = time.perf_counter()
    rep = db.scrub(full=False)
    dt = time.perf_counter() - t0
    eff = rep["bytes_read"] / max(dt, 1e-9)
    csv.emit(
        "scrub_paced", dt * 1e6,
        f"budget_mb_s={PACED_BPS / 1e6:.0f} "
        f"effective_mb_s={eff / 1e6:.1f}",
    )
    before = db.scan(0, N_KEYS + 1)
    db.close()

    # repair round trip: rot the REMIX, reopen, scrub heals it
    rx = sorted(glob.glob(os.path.join(root, "remix", "*.rmx")))[0]
    flip_bytes(rx, offset=128, nbytes=1)
    db = RemixDB.open(root, _cfg(device))
    t0 = time.perf_counter()
    rep = db.scrub(full=True)
    dt = time.perf_counter() - t0
    assert rep["repaired"], "repair did not trigger"
    after = db.scan(0, N_KEYS + 1)
    assert np.array_equal(before[0], after[0])
    assert np.array_equal(before[1], after[1])
    csv.emit(
        "repair_remix", dt * 1e6,
        f"findings={len(rep['findings'])} repaired={len(rep['repaired'])}",
    )
    db.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(CSV(), device=args.device)
