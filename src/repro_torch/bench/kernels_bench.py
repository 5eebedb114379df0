"""Kernel microbenchmarks + the fused device-resident query pipeline.

The port of ``benchmarks/kernels_bench.py``. Two layers:

- **micro**: the CUDA ``anchor_search`` kernel vs the plain torch
  reference (``kernels/ref.py``), the kernel-backed seek composition
  (``ops.seek``), and the REMIX build throughput (compaction-side cost
  the WA accounting charges). The reference's rows
  ``kernels_anchor_search_pallas_interp`` and ``kernels_seek_fused_interp``
  (Pallas in interpret mode) are named ``kernels_anchor_search_cuda`` and
  ``kernels_seek_fused`` here; on a CPU device the wrappers run their
  plain versions.
- **device pipeline**: a promoted single-partition store answers a
  256-key batch through the persistent device view
  (``device_path="on"``): seek → selector decode → run/position resolve
  → gather, all on the device, with **exactly one host sync per batch**
  (asserted via ``repro_torch.kernels.device_view.SYNCS``) and results
  identical to the legacy promoted path (``device_path="off"``, asserted),
  which on a CUDA store runs the plain query engine on the card. The
  reference's >= 5x device-over-host bar at batch 256 was set for a TPU
  against host numpy; here both sides run on the card, so the ratio is
  printed beside that bar and not asserted.

Also writes ``BENCH_kernels.json`` (default ``build/bench/``).

``python -m repro_torch.bench.kernels_bench [--tiny] [--json PATH]
[--device cpu]`` or ``python -m repro_torch.bench.run --only kernels``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.bench.cache_bench import build_store
from repro_torch.bench.common import (CSV, card, json_path_for, make_tables, qkeys,
                                      time_batched, write_json)
from repro_torch.core.remix import build_remix
from repro_torch.db.store import RemixDB, RemixDBConfig
from repro_torch.device import resolve
from repro_torch.kernels import device_view, ops
from repro_torch.kernels.anchor_search import anchor_search
from repro_torch.kernels.ref import anchor_search_ref

MIN_DEVICE_SPEEDUP = 5.0  # the reference's TPU-era bar at batch 256: reported
BATCH = 256
ITERS = 5
SCAN_Q, SCAN_N = 64, 16

# full-size store (default) vs smoke store (--tiny)
SIZES = dict(full=(8, 1 << 16), tiny=(4, 1 << 12))


def bench_micro(csv: CSV, device="cuda") -> None:
    rng = np.random.default_rng(3)
    runs, keys = make_tables(8, 16384, locality="weak", device=device)
    t0 = time.perf_counter()
    remix, runset = build_remix(runs, d=32)
    csv.emit("kernels_remix_build", (time.perf_counter() - t0) * 1e6,
             f"{8*16384} entries")
    qk = qkeys(rng, int(keys[-1]), 1024, device=device)
    t = time_batched(lambda q: anchor_search(remix.anchors, q), qk)
    csv.emit("kernels_anchor_search_cuda", t / 1024 * 1e6, "")
    t = time_batched(lambda q: anchor_search_ref(remix.anchors, q), qk)
    csv.emit("kernels_anchor_search_ref", t / 1024 * 1e6, "")
    t = time_batched(lambda q: ops.seek(remix, runset, q), qk)
    csv.emit("kernels_seek_fused", t / 1024 * 1e6, "")


def _probe(domain: np.ndarray, rng, q: int) -> np.ndarray:
    hits = rng.choice(domain, q - q // 8, replace=False).astype(np.uint64)
    miss = rng.choice(domain, q // 8, replace=False).astype(np.uint64) + 1
    out = np.concatenate([hits, miss])
    rng.shuffle(out)
    return out


def _time_batches(db, probe) -> float:
    db.get_batch(probe)  # warm: upload / cache fill
    t0 = time.perf_counter()
    for _ in range(ITERS):
        db.get_batch(probe)
    return (time.perf_counter() - t0) / ITERS


def bench_device_pipeline(root: str, domain: np.ndarray, csv: CSV, device="cuda",
                          observe=None) -> dict:
    """Fused promoted-get pipeline: sync-count contract, parity with the
    legacy path, and device-vs-legacy throughput at batch 256.
    ``observe(tag, stores, batches)``, where given, is called at the end
    with the device-path store (``stores["remixdb"]``) and the batches the
    driver sent it: ``(label, keys, n)``, ``n`` the scan length or None
    for a get_batch."""
    rng = np.random.default_rng(11)
    probe = _probe(domain, rng, BATCH)
    db_h = RemixDB.open(root, RemixDBConfig(cold_reads=False, device_path="off",
                                            device=device))
    db_d = RemixDB.open(root, RemixDBConfig(cold_reads=False, device_path="on",
                                            device=device))

    f_h, v_h = db_h.get_batch(probe)
    f_d, v_d = db_d.get_batch(probe)  # also uploads the device view
    assert np.array_equal(f_h, f_d), "device/host found-mask mismatch"
    assert np.array_equal(v_h[f_h], v_d[f_d]), "device/host value mismatch"
    assert len(db_d.device_views) == 1  # single-partition store, resident

    s0 = device_view.SYNCS
    for _ in range(ITERS):
        db_d.get_batch(probe)
    syncs = (device_view.SYNCS - s0) / ITERS
    assert syncs == 1.0, (
        f"fused batch-{BATCH} get paid {syncs} host syncs per batch, want 1"
    )

    host_s = _time_batches(db_h, probe)
    dev_s = _time_batches(db_d, probe)
    speedup = host_s / dev_s
    backend = resolve(device).type
    print(f"# kernels: device/legacy get speedup at batch {BATCH}: {speedup:.2f}x "
          f"(the reference's >= {MIN_DEVICE_SPEEDUP}x bar, set for a TPU against "
          f"host numpy, is reported here and not asserted)", flush=True)
    csv.emit("kernels_device_get_batch256", dev_s / BATCH * 1e6,
             f"syncs_per_batch=1;backend={backend}")
    csv.emit("kernels_host_get_batch256", host_s / BATCH * 1e6, "")
    csv.emit("kernels_device_speedup", 0.0,
             f"{speedup:.2f}x;bar_not_asserted={MIN_DEVICE_SPEEDUP}x")

    # scan windows through the same fused path
    starts = np.sort(rng.choice(domain[:-200], SCAN_Q, replace=False))
    db_h.scan_batch(starts, SCAN_N), db_d.scan_batch(starts, SCAN_N)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        db_d.scan_batch(starts, SCAN_N)
    dscan = (time.perf_counter() - t0) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        db_h.scan_batch(starts, SCAN_N)
    hscan = (time.perf_counter() - t0) / ITERS
    csv.emit("kernels_device_scan64x16", dscan / SCAN_Q * 1e6, "")
    csv.emit("kernels_host_scan64x16", hscan / SCAN_Q * 1e6, "")
    if observe is not None:
        observe("kernels", {"remixdb": db_d},
                [(f"get {BATCH}", probe, None), (f"scan{SCAN_N} {SCAN_Q}", starts, SCAN_N)])

    out = dict(
        backend=backend,
        batch=BATCH,
        syncs_per_batch=syncs,
        device_get_us_per_key=round(dev_s / BATCH * 1e6, 3),
        host_get_us_per_key=round(host_s / BATCH * 1e6, 3),
        get_speedup=round(speedup, 2),
        device_scan_us_per_query=round(dscan / SCAN_Q * 1e6, 2),
        host_scan_us_per_query=round(hscan / SCAN_Q * 1e6, 2),
        hbm_resident_bytes=int(db_d.device_views.resident_bytes),
    )
    db_h.close(), db_d.close()
    return out


def run(csv: CSV, tiny: bool = False, json_path: str | None = None, device="cuda",
        observe=None) -> dict:
    """Both layers; writes the JSON record and returns it. ``observe``: see
    :func:`bench_device_pipeline`."""
    bench_micro(csv, device=device)
    r_tables, n_per_table = SIZES["tiny" if tiny else "full"]
    with tempfile.TemporaryDirectory(prefix="kernels-bench-") as tmp:
        root = os.path.join(tmp, "db")
        domain = build_store(
            root, r_tables=r_tables, n_per_table=n_per_table
        )
        pipeline = bench_device_pipeline(root, domain, csv, device=device,
                                         observe=observe)
    record = dict(
        bench="kernels",
        unix_time=int(time.time()),
        card=card(device),
        store=dict(r_tables=r_tables, n_per_table=n_per_table),
        pipeline=pipeline,
    )
    write_json(json_path_for("kernels", json_path), record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke store (4 tables x 4096 entries)")
    ap.add_argument("--json", default=None, help="BENCH_kernels.json path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    c = CSV()
    print("name,us_per_call,derived")
    run(c, tiny=args.tiny, json_path=args.json, device=args.device)
