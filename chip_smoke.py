#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of REMIX (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. build — compile ``src/repro_torch/csrc/*.cu`` with nvcc (first use).
2. kernels — each CUDA kernel against its plain PyTorch version on the
   card, bit for bit, across sweeps of shapes and types (anchor counts G
   up to 2^20, every power of two from 1,024; one query alone and
   batches, queries at and past the +inf tail; selector tiles and group
   ids, runids >= R).
3. main path — 32 in-memory partitions at the widths of
   ``src/repro/configs/remixdb.py`` (R=8 runs of 65,536 entries, D=32,
   64-bit keys, 4-word values) with overlapping runs, tombstones, TTL
   expiries and an excised span, uploaded through ``DeviceViewManager``
   and queried through ``get_batch`` / ``scan_windows`` (and through
   ``ops.get`` / ``ops.scan`` on ``Partition.index()``); every answer is
   checked against an independent numpy oracle and against the port's
   plain engine (``core.query``) on the card, with one host sync per batch.
4. timings — each kernel at each of the main path's shapes (CUDA events
   over CUDA graphs of many launches) beside its bound, its plain version,
   a PyTorch yardstick and a launch floor (a one-element ``add_`` timed the
   same way); end-to-end µs per key / per query and profiled batches.
5. index tier — the deployment the reference store's defaults put on the
   ``index`` residency tier (``src/repro/db/store.py``: 256 MiB device
   budget, 64 MiB block cache, 64-query pipeline slices): 2 partitions of
   8 runs x 2^20 entries at the same widths, written as SSTables (with
   CKBs) and REMIX files through ``io.Storage`` into a temporary directory
   outside the checkout, reopened from the manifest over lazy file handles
   and the loaded REMIX, and queried through ``get_batch`` /
   ``scan_windows`` with the values gathered on the host through the block
   cache; answers against the numpy oracle, syncs per batch, no value byte
   read at upload, first-pass and warm timings (three of each), the host
   cost of a missed value granule split into file read and CRC32C, and a
   profiled batch that shows slice i+1's kernels starting before slice i's
   host gather ends. Then both kernels on this path's own operands (its
   anchors, queries and group ids), against their plain versions bit for
   bit, and timed at its shapes as in phase 4.
6. store — the port's ``RemixDB`` through its public API, at the widths
   of ``src/repro/configs/remixdb.py`` (VW = 4, D = 32) with every other
   ``RemixDBConfig`` field at the reference's default, in a temporary
   data directory outside the checkout under a logical clock. Load: 2^20
   put_batch keys uniform over [0, 2^40) in batches of 65,536 and a short
   unflushed last batch (20% overwrites, TTLs on 10% — half expired at
   query time —, 1% point deletes per batch through one ``Batch`` of
   ``Op.delete``, one ``delete_range``), through minor and split
   compactions. Then three
   stages, every answer checked against an independent numpy oracle:
   (1) the store as loaded, with the memtable overlay, then flushed (scans
   through ``scan_windows``), then a new unflushed tail; (2) ``close`` and
   ``RemixDB.open``: the WAL tail replayed, cold reads until every
   partition's ``promotion`` event, then device views; (3) reopened with
   ``use_kernels=True, device_path="off", cold_reads=False``: the kernels
   through the cursor (every scan over the WAL's overlay), then flushed,
   through ``ops.get`` / ``ops.scan``. Per stage: µs per key of get_batch
   (256 and 65,536 keys) and per query of scan_batch (256 × 50), three
   first/warm pairs; syncs per batch against touched partitions (every
   view-path batch with its views resident runs under the sync debug
   mode ``error``, its cursor fallbacks under ``warn``, counted apart;
   the legacy path is held to its blocking copies per partition), both
   kernels' launches, resident and allocated device bytes, a profiled
   256-key get. After stages 2 and 3, outside the counted runs, both
   kernels against their plain versions bit for bit on that stage's own
   operands (the views, or each partition's ``p.index()`` with the
   store's padded queries and the cursor's one-key seek), and timed.
7. fleet — the port's ``Cluster``: 3 range shards (lows 0, 2^40/3,
   2·2^40/3), each a ``RemixDB`` with phase 6's config on the card, one
   shared 64 MiB block cache and 2 submit workers, in a temporary
   directory. (1) 2^21 keys loaded through ``Cluster.submit`` (as phase
   6, without TTLs), flushed; (2) quiesced fleet reads against the numpy
   oracle (gets of 256 and 65,536 keys; 256 Seek+Next50 scans, some
   draining into the next shard), three first/warm pairs, syncs per
   touched partition under ``error``, a profiled 256-key get; (3) three
   submitter threads of zipfian 64-key batches (a quarter puts) for 5 s,
   a live ``split`` of shard 0 at its middle (aligned), 5 s more: failed
   ops (must be 0), batch latency before / during / first after / after
   the split, time under the gate, shipped bytes; every traffic read and
   every written key held to the acknowledged-value rule; (4) both
   kernels on the new shard's operands, bit for bit, and timed; (5)
   ``add_replica`` of shard 0, a put_batch, ``catch_up_until(0)``, the
   replica's reads equal the primary's and the oracle's; (6) ``merge`` of
   the split back; (7) close and ``Cluster(lows=None)``: cold reads until
   every partition promotes, then promoted reads. Device memory around
   every topology change, beside each store's view bytes.
8. paper — the paper's figures through the port's benchmarks
   (``src/repro_torch/bench/``) with the reference benchmarks' shapes and
   mix, every answer checked: fig11 / fig12 (weak / strong locality; R in
   {1, 2, 4, 8, 16} tables of 2^18 keys; REMIX seek in both in-group
   modes, Seek+Next50, get against the merging iterator and the
   bloom-filtered get, each against a numpy oracle, the bloom's false
   negatives counted: 0), fig13 (D in {16, 32, 64} at R = 8), table1,
   fig14-16 (RemixDB, whose reads go through both kernels, against the
   leveled and tiered stores at 4x the reference's keys, memtable and
   table cap; every store held to the oracle after each load) and fig17
   (YCSB A-F at 4x the keys, 3,000 ops each; the stores held to the
   oracle after the load and after F, the baselines' scans after F to
   their own ``scan`` per start). After each load, outside the counted
   runs, both kernels against their plain versions bit for bit on the
   RemixDB's resident views at the batches the figure sends (the check's
   4,096-key get and 64 scans, fig14's 512 seek probes and fig15's 256
   scan starts, fig17's 256-key gets and 64-start scans), timed after
   fig14's 120B load and fig17's;
   after F, the baselines' 64-start scan_batch over their memtable timed
   beside one merging scan per start (the reference's algorithm). Then
   the sharded get (``make_sharded_get`` over one NCCL rank per card at
   ``RemixServiceConfig()``'s widths, 2^19 queries, half of them keys
   stored on any shard) against the oracle under the over-capacity drop
   rule and ``core.query.get``. Each timed row prints the reference's
   CSV line and, from one profiled call, its device-busy µs and device
   launches; then the paper's claims read off the rows.

The last lines are one JSON object listing the kernels, the card's name
and power limit from nvidia-smi, and ``{"ok": true, "device": ...}``.
The script exits non-zero, printing no result, where CUDA is absent or
the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# src/repro/configs/remixdb.py (RemixServiceConfig): R, entries per run,
# group size, key words, value words
R, ENTRIES, D, KW, VW = 8, 1 << 16, 32, 2, 4
N_PARTITIONS = 32  # full-tier depth
DOMAIN = 1 << 18  # distinct keys per partition: each key in ~2 of the 8 runs
GET_SMALL, GET_LARGE = 256, 1 << 16
SCAN_Q, SCAN_WIDTH = 256, 75  # Seek+Next50: n + max(8, n // 2)
# anchor-kernel sweep; 32768 and 2^19 are the padded group counts of the
# full and the index tier's partitions, and the powers of two from 1,024
# up hold every padded G of the store's partitions (phase 6). Some G are
# not multiples of the sample stride, and the largest make it double.
ANCHOR_GS = (1, 5, 17, 513, 1024, 2048, 4096, 5000, 8192, 16384, 32768, 65536,
             100_003, 131_072, 262_144, 1 << 19, 1 << 20)
# phase 5: the reference store's defaults (src/repro/db/store.py): device
# budget (:116), block cache (:95), pipeline slice (:120); at 8 runs x 2^20
# entries the full view (~296 MB) exceeds the budget, the index view
# (~195 MB) fits it
IDX_ENTRIES, IDX_DOMAIN, IDX_PARTITIONS = 1 << 20, 1 << 22, 2
DEVICE_BUDGET, CACHE_BYTES, SLICE_WIDTH = 256 << 20, 64 << 20, 64
REPEATS = 3  # first/warm pairs per index-tier batch
NOW = 1_700_000_000  # query-time clock (uint32 seconds)
# phase 6: the port's RemixDB at the widths of src/repro/configs/remixdb.py
# (VW=4, D=32), every other RemixDBConfig field at the reference's
# default; keys uniform over [0, 2^40). 2^20 keys, not 2^21: at 2^21 the
# whole script ran past 4.5 minutes on the card
STORE_KEYS, STORE_BATCH, STORE_DOMAIN = 1 << 20, 1 << 16, 1 << 40
STORE_TAIL = 4096  # the load's last, short batch: unflushed
STORE_GET_SMALL, STORE_GET_LARGE = 256, 1 << 16
STORE_SCAN_Q, STORE_SCAN_N = 256, 50  # Seek+Next50
STORE_EDGE_ROUNDS = 12  # batches allowed for every partition to promote
T_LOAD = NOW - 1000  # the load's clock; queries run at NOW
TTL_SHORT, TTL_LONG = 500, 1 << 20  # expired / live at NOW
# blocking copies per partition on the store's legacy path
# (src/repro_torch/db/store.py, _get_batch_at / _scan_group_at): the query
# words in; found and values out, or keys, valid and values out
LEGACY_COPIES = {"get": 3, "scan": 4}
# phase 7: a fleet behind the port's Cluster. benchmarks/cluster_bench.py:
# 3 shards, 64-key batches, 3 submitters (:37-39); zipfian ranks permuted
# over the keys, a quarter of the batches puts (:63-75); 5 s of traffic
# before and after the split (:118). 2^21 keys, not phase 6's 2^20: at
# 2^20 each shard held one partition (4-5 tables of 65,536 entries, under
# t_max = 10), so the split had no boundary to align to
FLEET_SHARDS, FLEET_BATCH, FLEET_THREADS = 3, 64, 3
FLEET_KEYS = 1 << 21
FLEET_PUT_SHARE, FLEET_THETA, FLEET_PHASE_S = 0.25, 0.99, 5.0
FLEET_FIRST = 16  # post-split batches reported apart (cold reads, promotion)
FLEET_TAIL = 4096  # stage 5's put_batch into the replicated shard
# phase 8: the paper's figures (src/repro_torch/bench/), with the
# reference benchmarks' shapes and mix. fig11-13 tables of 2^18 keys, 16x
# benchmarks/fig11_queries.py's 16,384 (the host builds of the tables took
# phase 8 to 391 s at 2^20 and to 344 s at 2^19 on a slower host); fig14-17 keys, memtable and table cap x 4
# (fig14-16: 480,000 keys, memtable and table_cap 32,768 against the
# store defaults 2^18 and 65,536; fig17: 240,000 keys, OPS 3,000)
PAPER_N_PER_TABLE = 1 << 18
PAPER_TIMED = ("fig14 120B", "fig17 load")  # one store per G of phase 8's partitions
PAPER_SCALE = 4
PAPER_SEED = 1  # build_demo_state's draws for the sharded get
DEV = "cuda"
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes (H100 whitepaper)

REPLACES = {
    "anchor_search": "src/repro/kernels/anchor_search.py:46",
    "selector_decode": "src/repro/kernels/selector_decode.py:45",
}
SOURCES = {
    "anchor_search": "src/repro_torch/csrc/anchor_search.cu",
    "selector_decode": "src/repro_torch/csrc/selector_decode.cu",
}


def log(*a):
    print(*a, flush=True)


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


@contextlib.contextmanager
def sync_debug_error():
    """Raise on any CUDA synchronisation other than the batch's fetch."""
    import torch

    if DEV != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def time_graph(fn, reps: int = 50, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, timed with CUDA events over ``replays`` replays after warm-up."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (replays * reps)


def int32_rate() -> float:
    """Peak 32-bit integer ops/s of card 0: INT32 lanes x SMs x the SM's
    maximum clock as nvidia-smi reports it."""
    import torch

    p = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    mhz = float(p.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BPS * 1e3, ops / int32_rate() * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def search_probes(a64, q64) -> tuple[int, int]:
    """Distinct anchor rows, and probes in all, that the kernel's binary
    search (``csrc/anchor_search.cu``) reads for these ordered int64 keys."""
    import torch

    g = a64.shape[0]
    lo = torch.zeros_like(q64)
    n = torch.full_like(q64, g)
    seen = torch.zeros(g, dtype=torch.bool, device=a64.device)
    probes = 0
    while bool((n > 0).any()):
        act = n > 0
        half = n >> 1
        mid = lo + half
        seen[mid[act]] = True
        probes += int(act.sum())
        le = act & (a64[mid.clamp(max=g - 1)] <= q64)
        lo = torch.where(le, mid + 1, lo)
        n = torch.where(le, n - half - 1, torch.where(act, half, n))
    return int(seen.sum()), probes


# ---------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch import device as dev

    t0 = time.perf_counter()
    dev.kernel_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in dev.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("[build] " + line.strip())


# ---------------------------------------------------------------- phase 2
def _sorted_anchors(rng, g: int, kw: int) -> np.ndarray:
    """(g, kw) uint32 ascending anchors with word ties and a +inf tail."""
    tail = g // 4
    n = g - tail
    rows = rng.integers(0, 2**32, size=(n * 2 + 8, kw), dtype=np.uint64)
    rows[:, 0] %= max(1, n // 2)  # ties on the leading word
    rows = np.unique(rows.astype(np.uint32), axis=0)[:n]  # lexicographic
    out = np.full((g, kw), 0xFFFFFFFF, np.uint32)
    out[: len(rows)] = rows
    return out


def _anchor_queries(rng, anchors: np.ndarray, q: int) -> np.ndarray:
    g, kw = anchors.shape
    real = anchors[~np.all(anchors == 0xFFFFFFFF, axis=1)]
    out = rng.integers(0, 2**32, size=(q, kw), dtype=np.uint64).astype(np.uint32)
    if len(real):
        pick = real[rng.integers(0, len(real), q)]
        nudge = pick.copy()
        nudge[:, -1] += rng.integers(-1, 2, q).astype(np.uint32)  # wraps: fine
        out[: q // 3] = pick[: q // 3]
        out[q // 3: 2 * q // 3] = nudge[q // 3: 2 * q // 3]
    out[0] = 0
    out[1] = 0xFFFFFFFF
    out[1, -1] = 0xFFFFFFFE  # the largest key that is not +inf
    out[2] = 0xFFFFFFFF  # at the +inf tail
    if len(real):
        out[3] = real[-1]
        out[3, -1] += np.uint32(1)  # past the last real anchor
    return out


def phase_kernels(rng) -> dict:
    import torch

    from repro_torch.device import as_words, sm_count
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import selector_decode as SD

    cuda = torch.device(DEV)
    err = {"anchor_search": 0, "selector_decode": 0}
    n = 0
    # 1 query (the cursor's seek) and 1,000 take the warp-per-query search,
    # `many` the sampled one
    many = AS.SAMPLE_MIN_QUERIES_PER_SM * sm_count(torch.empty(0, device=cuda)) + 5
    for g in ANCHOR_GS:
        for kw in (1, 2, 3):
            a_np = _sorted_anchors(rng, g, kw)
            a = as_words(a_np, cuda)
            for nq in (1, 1000, many):
                qs = _anchor_queries(rng, a_np, max(nq, 8))
                # Q = 1: each of the eight edge queries launched alone
                for q_np in ([qs[i:i + 1] for i in range(8)] if nq == 1 else [qs]):
                    q = as_words(q_np, cuda)
                    for kern, plain in ((AS.anchor_le_count, AS.anchor_le_count_plain),
                                        (AS.anchor_search, AS.anchor_search_plain)):
                        got = kern(a, q).cpu().numpy().astype(np.int64)
                        want = plain(a, q).cpu().numpy().astype(np.int64)
                        e = int(np.abs(got - want).max())
                        err["anchor_search"] = max(err["anchor_search"], e)
                        check(e == 0, f"{kern.__name__} G={g} KW={kw} Q={nq}: max |err| {e}")
                        n += 1
    log(f"[kernels] anchor_search/anchor_le_count: {n} cases bit-identical "
        f"(G in {ANCHOR_GS}; KW 1-3; Q 1 (8 edge queries alone), 1,000 and {many}; "
        "+inf tails; queries at and past them)")
    n = 0
    for d in (8, 16, 32, 64):
        # 700 rows: a row group per warp; 40,000: four per warp
        cases = [(r, 700) for r in range(1, min(16, d) + 1)] + [(min(d, 8), 40_000)]
        for r, nrows in cases:
            for dt in (np.uint8, np.int32):
                g = 300  # groups; runids up to R+1 take no cursor and no count
                sel = rng.integers(0, r + 2, (g, d)) | (rng.integers(0, 2, (g, d)) << 7)
                sel[rng.random((g, d)) < 0.2] = 127
                sel[::11] = 127  # all-pad rows
                cur = rng.integers(0, 1 << 20, (g, r)).astype(np.int32)
                rows = np.concatenate([rng.integers(0, g, nrows - g), np.arange(g)[::-1]])
                s = torch.from_numpy(sel.astype(dt)).to(cuda)
                c = torch.from_numpy(cur).to(cuda)
                rw = torch.from_numpy(rows.astype(np.int32)).to(cuda)
                for contract, kw in (("tiles", {}), ("rows", {"rows": rw})):
                    got = SD.selector_decode(s, c, **kw)
                    want = SD.selector_decode_plain(s, c, **kw)
                    for name, x, y in zip(("runid", "absidx", "newest", "pad"), got, want):
                        e = int((x.long() - y.long()).abs().max())
                        err["selector_decode"] = max(err["selector_decode"], e)
                        check(e == 0, f"selector_decode D={d} R={r} {dt.__name__} "
                                      f"{contract} {name}: max |err| {e}")
                    n += 1
    log(f"[kernels] selector_decode: {n} cases bit-identical "
        "(D 8-64; R 1..min(16,D); uint8 and int32 selectors; tiles and group "
        "ids, repeated and unordered, 700 and 40,000 rows; all-pad rows; "
        "runids >= R)")
    return err


# ---------------------------------------------------------------- phase 3
def make_tables(rng, lo: int, entries: int | None = None, distinct: int | None = None):
    """8 overlapping runs over one partition's key range: increasing seq,
    ~5% tombstones, TTLs on ~10% of rows (half already expired)."""
    from repro_torch.db.partition import Table

    entries, distinct = entries or ENTRIES, distinct or DOMAIN
    domain = np.uint64(lo) + np.sort(
        rng.choice(1 << 36, distinct, replace=False)
    ).astype(np.uint64)
    tables = []
    for i in range(R):
        keys = np.sort(rng.choice(domain, entries, replace=False))
        seq = (np.arange(entries) + i * entries + 1).astype(np.uint32)
        vals = rng.integers(0, 2**32, (entries, VW), dtype=np.uint64).astype(np.uint32)
        tomb = rng.random(entries) < 0.05
        exp = np.zeros(entries, np.uint32)
        ttl = rng.random(entries) < 0.10
        delta = rng.integers(1, 1000, entries)
        past = rng.random(entries) < 0.5
        exp[ttl] = np.where(past, NOW - delta, NOW + delta)[ttl].astype(np.uint32)
        tables.append(Table(keys=keys, vals=vals, seq=seq, tomb=tomb, exp=exp))
    return domain, tables


def oracle(tables, spans):
    """Independent answer key: newest version per key and its liveness."""
    keys = np.concatenate([t.keys for t in tables])
    seq = np.concatenate([t.seq for t in tables]).astype(np.int64)
    vals = np.concatenate([t.vals for t in tables])
    tomb = np.concatenate([t.tomb for t in tables])
    exp = np.concatenate([t.exp for t in tables])
    covered = np.zeros(len(keys), bool)
    off = 0
    for i, t in enumerate(tables):
        for lo, hi, covers in spans:
            if i in covers:
                covered[off: off + t.n] |= (t.keys >= lo) & (t.keys < hi)
        off += t.n
    order = np.lexsort((-seq, keys))
    ks = keys[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    top = order[first]
    dead = tomb[top] | ((exp[top] != 0) & (exp[top] <= NOW)) | covered[top]
    return dict(keys=keys[top], vals=vals[top], live=~dead)


def probe(rng, domain, q):
    """Hits and 1/8 misses, as ``benchmarks/kernels_bench._probe`` draws."""
    hits = rng.choice(domain, q - q // 8, replace=False)
    miss = rng.choice(domain, q // 8, replace=False) + np.uint64(1)
    out = np.concatenate([hits, miss])
    rng.shuffle(out)
    return out


def oracle_get(orc, q):
    idx = np.searchsorted(orc["keys"], q)
    idc = np.minimum(idx, len(orc["keys"]) - 1)
    hit = (idx < len(orc["keys"])) & (orc["keys"][idc] == q)
    found = hit & orc["live"][idc]
    return found, orc["vals"][idc]


def check_scan(orc, starts, rows, with_vals, what):
    lk = orc["keys"][orc["live"]]
    lv = orc["vals"][orc["live"]]
    total = 0
    for s, (kk, vv) in zip(starts, rows):
        i = int(np.searchsorted(lk, s))
        check(len(kk) <= SCAN_WIDTH, f"{what}: window longer than width")
        check(np.array_equal(kk, lk[i: i + len(kk)]),
              f"{what}: keys are not a prefix of the live keys >= start")
        if with_vals:
            check(np.array_equal(vv, lv[i: i + len(kk)]), f"{what}: values differ")
        else:
            check(vv is None, f"{what}: values returned without with_vals")
        total += len(kk)
    check(total > 0, f"{what}: no rows returned")
    return total


def build_partitions(rng):
    from repro_torch.db.partition import Partition

    parts, domains, oracles = [], [], []
    t0 = time.perf_counter()
    for i in range(N_PARTITIONS):
        lo = i << 40
        domain, tables = make_tables(rng, lo)
        p = Partition(lo, tables[:6], d=D, device=DEV)
        a = int(rng.integers(0, DOMAIN - 4096))
        span = (int(domain[a]), int(domain[a + 4096]))
        p.attach_excised(span[0], span[1], seq=6 * ENTRIES + 1)
        p.tables.extend(tables[6:])  # born after the range delete: uncovered
        parts.append(p)
        domains.append(domain)
        oracles.append(oracle(tables, [(np.uint64(span[0]), np.uint64(span[1]),
                                        set(range(6)))]))
    log(f"[main] {N_PARTITIONS} partitions x {R} runs x {ENTRIES} entries "
        f"generated in {time.perf_counter() - t0:.1f} s")
    return parts, domains, oracles


def phase_main(rng, parts, domains, oracles):
    import torch

    from repro_torch.core import query as Q
    from repro_torch.db import clock
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import device_view as DV
    from repro_torch.kernels import ops
    from repro_torch.kernels import selector_decode as SD
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.metrics import MetricsRegistry

    clock.set_source(lambda: float(NOW))
    reg, ev = MetricsRegistry(), EventLog(capacity=1024)
    mgr = DV.DeviceViewManager(budget_bytes=1 << 30, registry=reg, events=ev,
                               device=DEV)
    los = np.array([p.lo for p in parts], np.uint64)

    AS.anchor_search.launches = 0
    AS.anchor_le_count.launches = 0
    SD.selector_decode.launches = 0
    syncs0 = DV.SYNCS
    batches = 0

    t0 = time.perf_counter()
    views = [mgr.view_for(p) for p in parts]
    check(all(v is not None for v in views), "a partition fell back")
    gs = sorted({v.remix.g for v in views})
    log(f"[main] uploaded {len(views)} views in {time.perf_counter() - t0:.1f} s: "
        f"resident {mgr.resident_bytes} bytes "
        f"({mgr.resident_bytes / len(views) / 1e6:.2f} MB per partition; the "
        f"partitions' own estimate {sum(p.device_view_bytes(True) for p in parts)}); "
        f"padded G {gs}")
    check(set(gs) <= set(ANCHOR_GS), f"main-path G {gs} not in the kernel sweep")

    def route(keys):
        owner = np.searchsorted(los, keys, side="right") - 1
        return {int(i): keys[owner == i] for i in np.unique(owner)}

    results = {}
    for qn in (GET_SMALL, GET_LARGE):
        keys = np.concatenate([probe(rng, d, qn) for d in domains])
        rng.shuffle(keys)
        found_n = 0
        for i, kq in route(keys).items():
            with sync_debug_error():
                found, vals = mgr.get_batch(views[i], kq, NOW)
            batches += 1
            f_o, v_o = oracle_get(oracles[i], kq)
            check(np.array_equal(found, f_o), f"get_batch {qn}: found differs (partition {i})")
            check(np.array_equal(vals[found], v_o[found]), f"get_batch {qn}: values differ")
            found_n += int(found.sum())
            results[("get", qn, i)] = (kq, found, vals)
        log(f"[main] get_batch x{len(parts)} at {qn} keys/partition: "
            f"{found_n}/{len(keys)} found, equal to the oracle")

    starts = {i: probe(rng, d, SCAN_Q) for i, d in enumerate(domains)}
    for with_vals in (True, False):
        rows_n = 0
        for i in range(len(parts)):
            with sync_debug_error():
                rows = mgr.scan_windows(views[i], starts[i], SCAN_WIDTH, NOW,
                                        with_vals=with_vals)
            batches += 1
            rows_n += check_scan(oracles[i], starts[i], rows, with_vals,
                                 f"scan_windows(with_vals={with_vals}) p{i}")
            results[("scan", with_vals, i)] = rows
        log(f"[main] scan_windows x{len(parts)} ({SCAN_Q} starts x width "
            f"{SCAN_WIDTH}, with_vals={with_vals}): {rows_n} rows, each a "
            "prefix of the oracle's live keys")

    # the other entry point: Partition.index() + ops.get / ops.scan, and the
    # plain engine core.query on the same index, both on the card
    for i, p in enumerate(parts):
        remix, runset = p.index()
        kq, found, vals = results[("get", GET_SMALL, i)]
        qt = torch.from_numpy(_pack(kq)).to(DEV)
        f_k, v_k = ops.get(remix, runset, qt)
        f_p, v_p = Q.get(remix, runset, qt)
        f_k, f_p = f_k.cpu().numpy(), f_p.cpu().numpy()
        check(np.array_equal(f_k, found) and np.array_equal(f_p, found),
              f"ops.get / core.query.get differ from get_batch (partition {i})")
        vk = v_k.cpu().numpy().view(np.uint32)
        vp = v_p.cpu().numpy().view(np.uint32)
        check(np.array_equal(vk[found], vals[found]) and np.array_equal(vp[found], vals[found]),
              f"ops.get / core.query.get values differ (partition {i})")
        st = torch.from_numpy(_pack(starts[i])).to(DEV)
        k_k, vv_k, m_k, _ = ops.scan(remix, runset, st, SCAN_WIDTH)
        k_p, vv_p, m_p, _ = Q.scan(remix, runset, st, SCAN_WIDTH)
        m_k, m_p = m_k.cpu().numpy(), m_p.cpu().numpy()
        k_k = k_k.cpu().numpy().view(np.uint32)
        k_p = k_p.cpu().numpy().view(np.uint32)
        vv_k = vv_k.cpu().numpy().view(np.uint32)
        vv_p = vv_p.cpu().numpy().view(np.uint32)
        rows = results[("scan", True, i)]
        for j, (kk, vv) in enumerate(rows):
            for kx, vx, mx in ((k_k, vv_k, m_k), (k_p, vv_p, m_p)):
                check(np.array_equal(_unpack(kx[j][mx[j]]), kk)
                      and np.array_equal(vx[j][mx[j]], vv),
                      f"ops.scan / core.query.scan differ from scan_windows "
                      f"(partition {i}, query {j})")
    log(f"[main] ops.get/ops.scan and core.query.get/scan on Partition.index() "
        f"equal get_batch/scan_windows on all {len(parts)} partitions")

    syncs = DV.SYNCS - syncs0
    fallback = _metric(reg, "device_fallback_total")
    launches = {"anchor_search": AS.anchor_search.launches,
                "selector_decode": SD.selector_decode.launches}
    log(f"[main] launches {launches}; syncs {syncs} for {batches} batches; "
        f"device_fallback_total {fallback}; device_batches "
        f"{_metric(reg, 'device_batches')}; device_rows_gathered "
        f"{_metric(reg, 'device_rows_gathered')}; events "
        f"{len(ev.list('device_upload'))} uploads")
    check(syncs == batches, f"{syncs} syncs for {batches} batches")
    check(fallback == 0, "device_fallback_total != 0")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    return mgr, views, starts, launches


def _pack(u64):
    from repro_torch.core.keys import pack_u64

    return pack_u64(np.asarray(u64, np.uint64)).view(np.int32)


def _unpack(words):
    from repro_torch.core.keys import unpack_u64

    return unpack_u64(words)


def _metric(reg, name):
    return sum(s["value"] for s in reg.snapshot()["metrics"] if s["name"] == name)


# ---------------------------------------------------------------- phase 4
def time_pair(fa, fb, reps: int) -> tuple[float, float]:
    """Device ms per call of ``fa`` and of ``fb``, timed in turns a, b, b, a
    within one run, each the mean of its two turns."""
    a1, b1 = time_graph(fa, reps), time_graph(fb, reps)
    b2, a2 = time_graph(fb, reps), time_graph(fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _pack64(w):
    """Ordered int64 of two uint32 words, for torch.searchsorted."""
    w = w.long() & 0xFFFFFFFF
    return (((w[:, 0] - (1 << 31)) << 32) | w[:, 1]).contiguous()


def launch_floor(card) -> float:
    """Device ms of a one-element ``add_`` in the same CUDA-graph harness."""
    import torch

    x = torch.zeros(1, device=DEV)
    floor = time_graph(lambda: x.add_(1))
    log(f"[timing] {card}: launch floor (one-element add_): {floor * 1e3:.3f} us")
    return floor


def time_anchor(anchors, q, label, reps) -> dict:
    """anchor_search on (G, KW) ``anchors`` and (Q, KW) queries ``q`` as a
    path hands them: checked against its plain version and
    ``torch.searchsorted``, then timed beside both and its bound."""
    import torch

    from repro_torch.kernels import anchor_search as AS

    g, qn = anchors.shape[0], q.shape[0]
    got = AS.anchor_search(anchors, q)
    check(torch.equal(got, AS.anchor_search_plain(anchors, q)),
          f"anchor_search differs from its plain version ({label}, G={g} Q={qn})")
    a64, q64 = _pack64(anchors), _pack64(q)
    check(torch.equal(torch.clamp(torch.searchsorted(a64, q64, right=True) - 1, min=0)
                      .to(torch.int32), got), "searchsorted yardstick disagrees")
    ms, lib = time_pair(lambda: AS.anchor_search(anchors, q),
                        lambda: torch.searchsorted(a64, q64, right=True), reps)
    plain = time_graph(lambda: AS.anchor_search_plain(anchors, q), reps=5)
    rows, probes = search_probes(a64, q64)
    b, by = bound_ms(rows * KW * 4 + qn * (KW * 4 + 4), probes * KW * 2)
    log(f"[timing] anchor_search ({label}) at G={g} Q={qn}: a binary search reads "
        f"{rows} of {g} anchor rows ({probes} probes); sample plan "
        f"(stride, rows, bytes) = {AS._plan(g, KW)}")
    return dict(shape=f"{label}: G={g} KW={KW} Q={qn}", ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=lib)


def time_decode(remix, rows, label, reps) -> tuple[dict, int]:
    """selector_decode on ``remix``'s group tables at the (N,) group ids
    ``rows`` a path hands it: checked against its plain version bit for
    bit, then timed beside it and its bound; returns the timing and the
    max |err|."""
    from repro_torch.kernels import selector_decode as SD

    sel, cur = remix.selectors.reshape(remix.g, D), remix.cursors
    got = SD.selector_decode(sel, cur, rows=rows)
    want = SD.selector_decode_plain(sel, cur, rows=rows)
    e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(e == 0, f"selector_decode differs from its plain version at the {label}")
    ms = time_graph(lambda: SD.selector_decode(sel, cur, rows=rows), reps)
    plain = time_graph(lambda: SD.selector_decode_plain(sel, cur, rows=rows), reps=5)
    n = rows.shape[0]
    # row ids, gathered selectors and cursors in; runid, absidx, newest, pad out.
    # Operations: 8 integer ops per slot (decode 3, count 2, cursor 1, flags 2).
    b, by = bound_ms(n * 4 + n * D + n * remix.r * 4 + n * D * 10, n * D * 8)
    return dict(shape=f"{label}: N={n} G={remix.g} D={D} R={remix.r}", ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None), e


def log_timings(card, name, shapes, floor):
    for k in shapes:
        log(f"[timing] {card}: {name} ({k['shape']}): kernel {k['ms'] * 1e3:.3f} us, "
            f"plain {k['plain_ms'] * 1e3:.3f} us, bound {k['bound_ms'] * 1e3:.4f} us "
            f"({k['bound_by']}), launch floor {floor * 1e3:.3f} us, library "
            + ("n/a" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.3f} us"))


def phase_timings(rng, views, domains, starts, err, card) -> list[dict]:
    """Each kernel at each of its main-path shapes, with the operands the
    path hands it, beside a launch floor timed in the same harness."""
    import torch

    from repro_torch.kernels import ops

    dv = views[0]
    remix = dv.remix
    floor = launch_floor(card)

    # anchor_search at the two get batches: (G, 2) anchors, 256 / 65,536 queries
    anchor = [time_anchor(remix.anchors,
                          torch.from_numpy(_pack(probe(rng, domains[0], qn))).to(DEV),
                          "full tier", reps)
              for qn, reps in ((GET_SMALL, 50), (GET_LARGE, 20))]

    # selector_decode at the scan window (256 starts x 4 groups) and at the
    # 65,536-key get window (65,536 x 2 groups): group ids as ops hands them
    st = torch.from_numpy(_pack(starts[0])).to(DEV)
    gq = torch.from_numpy(_pack(probe(rng, domains[0], GET_LARGE))).to(DEV)
    windows = (("full tier, scan window", ops.seek(remix, dv.runset, st), SCAN_WIDTH, 50),
               (f"full tier, {GET_LARGE:,}-key get window",
                ops.seek(remix, dv.runset, gq), 1, 20))
    decode, e = [], 0
    for label, pos, width, reps in windows:
        rows, _ = ops.window_operands(remix, pos, width)
        k, ek = time_decode(remix, rows, label, reps)
        decode.append(k)
        e = max(e, ek)

    out = []
    for name, shapes, e_k in (("anchor_search", anchor, 0), ("selector_decode", decode, e)):
        log_timings(card, name, shapes, floor)
        out.append(dict(shapes[0], name=name, shapes=shapes, launch_floor_ms=floor,
                        max_abs_err=max(err[name], e_k)))
    return out


def profile_batches(label, fn, n):
    """Device idle share of ``n`` calls of ``fn``: device busy time from a
    profiler trace over the wall time of the same ``n`` calls run without
    the profiler (which slows the host side), and the kernels that take the
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern)
    if not kern:
        log(f"[profile] {label}: the profiler saw no device time (not measured)")
        return
    by_name = {}
    for e in kern:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.end - e.time_range.start)
    log(f"[profile] {label}: {wall_us / n:.1f} us/batch wall ({traced_us / n:.1f} "
        f"under the profiler), {busy_us / n:.1f} us/batch device busy, idle share "
        f"{1 - busy_us / wall_us:.3f}, {len(kern) / n:.1f} kernels/batch")
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[profile]   {t / n:9.2f} us/batch  x{c // n:<3d} {name[:90]}")


def phase_end_to_end(rng, mgr, views, domains, starts, card):
    import torch

    for qn, reps in ((GET_SMALL, 20), (GET_LARGE, 3)):
        keys = [probe(rng, d, qn) for d in domains]
        for i, v in enumerate(views):
            mgr.get_batch(v, keys[i], NOW)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for i, v in enumerate(views):
                mgr.get_batch(v, keys[i], NOW)
        dt = time.perf_counter() - t0
        n = reps * len(views) * qn
        log(f"[e2e] {card}: get_batch at {qn} keys: {dt / n * 1e6:.4f} us/key "
            f"({dt / (reps * len(views)) * 1e3:.3f} ms/batch)")
        profile_batches(f"{card}: get_batch at {qn} keys",
                        lambda: mgr.get_batch(views[0], keys[0], NOW), 10)
    for with_vals in (True, False):
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            for i, v in enumerate(views):
                mgr.scan_windows(v, starts[i], SCAN_WIDTH, NOW, with_vals=with_vals)
        dt = time.perf_counter() - t0
        n = reps * len(views) * SCAN_Q
        log(f"[e2e] {card}: scan_windows ({SCAN_Q} x {SCAN_WIDTH}, with_vals={with_vals}): "
            f"{dt / n * 1e6:.3f} us/query ({dt / (reps * len(views)) * 1e3:.3f} ms/batch)")
        profile_batches(
            f"{card}: scan_windows with_vals={with_vals}",
            lambda: mgr.scan_windows(views[0], starts[0], SCAN_WIDTH, NOW,
                                     with_vals=with_vals), 10)


# ---------------------------------------------------------------- phase 5
def build_index_partitions(rng, root: str):
    """Write each partition's tables (with CKBs) and its persisted REMIX
    through ``io.Storage``, commit a manifest, then reopen every partition
    from the manifest: lazy ``Table.from_file`` handles sharing one block
    cache, and the REMIX loaded onto the card and adopted with
    ``preload_index``."""
    from repro_torch.core.keys import pack_u64
    from repro_torch.db.partition import Partition, Table
    from repro_torch.io import BlockCache, Storage, load_remix

    storage = Storage(root)
    entries, domains, oracles = [], [], []
    t0 = time.perf_counter()
    for i in range(IDX_PARTITIONS):
        lo = (N_PARTITIONS + i) << 40
        domain, tables = make_tables(rng, lo, IDX_ENTRIES, IDX_DOMAIN)
        names = [storage.write_table(pack_u64(t.keys), t.vals, t.seq, t.tomb, exp=t.exp)
                 for t in tables]
        w = IDX_DOMAIN // 64  # keys the range delete spans
        a = int(rng.integers(0, IDX_DOMAIN - w))
        span = [int(domain[a]), int(domain[a + w]), 6 * IDX_ENTRIES + 1]
        writer = Partition(lo, tables[:6], d=D, device=DEV)
        writer.attach_excised(*span)
        writer.tables.extend(tables[6:])
        writer.persist_index(storage)
        entries.append(dict(lo=lo, tables=names, remix=writer.remix_name, span=span))
        domains.append(domain)
        oracles.append(oracle(tables, [(np.uint64(span[0]), np.uint64(span[1]),
                                        set(range(6)))]))
        del writer, tables
    storage.commit({"partitions": entries})
    t_write = time.perf_counter() - t0

    state = Storage(root).load_state()
    cache = BlockCache(CACHE_BYTES)
    parts = []
    for pe in state["partitions"]:
        handles = [Table.from_file(storage.table_path(n)) for n in pe["tables"]]
        for t in handles:
            t.attach_cache(cache)
        p = Partition(pe["lo"], handles[:6], d=D, device=DEV)
        p.attach_excised(*pe["span"])
        p.tables.extend(handles[6:])
        p.preload_index(load_remix(storage.remix_path(pe["remix"]), device=DEV))
        parts.append(p)
    disk = sum(os.path.getsize(storage.table_path(n)) for pe in entries for n in pe["tables"])
    log(f"[index] {IDX_PARTITIONS} partitions x {R} runs x {IDX_ENTRIES} entries "
        f"generated, written ({disk} table bytes on disk) and persisted in "
        f"{t_write:.1f} s; reopened from the manifest: {parts[0]!r}")
    return parts, domains, oracles, cache


def _section_reads(p, section: str) -> int:
    return sum(t._rd().bytes_read[section] for t in p.tables)


def index_batch(mgr, v, orc, what, q):
    """One batch of the phase's traffic over view ``v``, under sync debug
    "error" and checked against the oracle; returns its wall seconds."""
    from repro_torch.kernels import device_view as DV

    kind, arg = what
    s0 = DV.SYNCS
    t0 = time.perf_counter()
    with sync_debug_error():
        if kind == "get":
            found, vals = mgr.get_batch(v, q, NOW)
        else:
            rows = mgr.scan_windows(v, q, SCAN_WIDTH, NOW, with_vals=arg)
    secs = time.perf_counter() - t0
    syncs = DV.SYNCS - s0
    if kind == "get":
        want = 1
        f_o, v_o = oracle_get(orc, q)
        check(np.array_equal(found, f_o), f"index get_batch {arg}: found differs")
        check(np.array_equal(vals[found], v_o[found]), f"index get_batch {arg}: values differ")
    else:
        want = -(-len(q) // SLICE_WIDTH) if arg else 1
        check_scan(orc, q, rows, arg, f"index scan_windows(with_vals={arg})")
    check(syncs == want, f"index {what}: {syncs} syncs, expected {want}")
    return secs


def profile_pipeline(mgr, v, starts, card):
    """Profile one pipelined scan: device busy and idle share, and whether
    slice i+1's first REMIX kernel starts on the card before slice i's
    host value gather (a ``record_function`` range) ends."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call = lambda: mgr.scan_windows(v, starts, SCAN_WIDTH, NOW, with_vals=True)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    evs = prof.events()
    kern = sorted((e for e in evs if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern)
    gathers = sorted((e.time_range.start, e.time_range.end) for e in evs
                     if e.name == "device_view.value_gather")
    # a slice's device work ends with the copies of its outputs: split the
    # device timeline at each run of device->host copies
    slices, cur = [[]], None
    for e in kern:
        fetch = "DtoH" in e.name
        if cur is True and not fetch:
            slices.append([])
        slices[-1].append(e)
        cur = fetch
    ours = [[e.time_range.start for e in sl
             if "search_kernel" in e.name or "selector_decode_kernel" in e.name]
            for sl in slices]
    nsl = -(-len(starts) // SLICE_WIDTH)
    check(len(gathers) == nsl and len(slices) == nsl and all(ours),
          f"profiled scan: {len(gathers)} gathers, {len(slices)} device slices with "
          f"{[len(o) for o in ours]} REMIX kernels, for {nsl} slices")
    lead = [gathers[i][1] - min(ours[i + 1]) for i in range(nsl - 1)]
    idle_gap = [min(ours[i + 1]) - slices[i][-1].time_range.end for i in range(nsl - 1)]
    log(f"[index] {card}: profiled scan_windows ({len(starts)} x {SCAN_WIDTH}, values, "
        f"{nsl} slices): {wall_us:.1f} us wall unprofiled, {busy_us:.1f} us device "
        f"busy, idle share {1 - busy_us / wall_us:.3f}, {len(kern)} device ops "
        f"({[len(o) for o in ours]} REMIX kernels per slice); slice i+1's first "
        f"REMIX kernel starts {', '.join(f'{x:.1f}' for x in lead)} us before slice "
        f"i's host gather ends, {', '.join(f'{x:.1f}' for x in idle_gap)} us after "
        f"slice i's copies; gathers take "
        f"{', '.join(f'{b - a:.1f}' for a, b in gathers)} us")
    check(all(x > 0 for x in lead), "slice i+1's kernels did not start before "
                                    "slice i's host gather ended")


def granule_costs(p, cache, card, per_table: int = 8):
    """Host µs per missed 64 KB value granule, split: the file read alone
    (open, seek, read), the CRC32C alone, and the whole miss
    (``read_block`` with the block cache cleared: read, CRC, cache
    insert), over ``per_table`` granules spread across each table's
    vals section."""
    from repro_torch.io.checksum import crc32c

    picks = []
    for t in p.tables:
        r = t._rd()
        blocks = r.section_row_blocks("vals", 0, r.n)
        picks += [(r, bi) for bi in blocks[:: max(1, len(blocks) // per_table)][:per_table]]
    chunks = []
    t0 = time.perf_counter()
    for r, bi in picks:
        with open(r.path, "rb") as f:
            f.seek(r._data_start + bi * r.block_bytes)
            chunks.append(f.read(r.block_bytes))
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    crcs = [crc32c(c) for c in chunks]
    t_crc = time.perf_counter() - t0
    check(all(c == int(r._crcs[bi]) for c, (r, bi) in zip(crcs, picks)), "granule CRC mismatch")
    cache.clear()
    t0 = time.perf_counter()
    for r, bi in picks:
        r.read_block(bi)
    t_miss = time.perf_counter() - t0
    cache.clear()
    n = len(picks)
    us = dict(read=t_read / n * 1e6, crc=t_crc / n * 1e6, miss=t_miss / n * 1e6)
    log(f"[index] {card}: host cost per missed 64 KB value granule ({n} granules, "
        f"files written seconds before): file read {us['read']:.1f} us, CRC32C "
        f"{us['crc']:.1f} us, whole miss (read_block: read, CRC, cache insert) "
        f"{us['miss']:.1f} us")
    return us


def profile_first_pass(mgr, v, cache, q, card):
    """cProfile one first-pass get_batch (the block cache cleared): host
    seconds in the CRC32C, in file reads, and in the functions that take
    the most time of their own."""
    import cProfile
    import pstats

    cache.clear()
    m0 = cache.stats()["misses"]
    pr = cProfile.Profile()
    pr.enable()
    mgr.get_batch(v, q, NOW)
    pr.disable()
    misses = cache.stats()["misses"] - m0
    st = pstats.Stats(pr).stats  # (file, line, func) -> (cc, nc, tt, ct, callers)
    total = sum(tt for _, _, tt, _, _ in st.values())

    def cum(func, file_end):
        return sum(ct for (f, _, fn), (_, _, _, ct, _) in st.items()
                   if fn == func and f.endswith(file_end))

    crc, load = cum("crc32c", "checksum.py"), cum("load", "sstable.py")
    log(f"[index] {card}: cProfile of a first-pass get_batch at {len(q)} keys "
        f"({misses} misses): {total * 1e3:.1f} ms of host time; crc32c "
        f"{crc * 1e3:.1f} ms ({crc / total:.3f}), granule loads (open, read, CRC) "
        f"{load * 1e3:.1f} ms ({load / total:.3f}); "
        f"{(load - crc) / max(1, misses) * 1e6:.1f} us open and read and "
        f"{crc / max(1, misses) * 1e6:.1f} us CRC per miss")
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:6]
    for (f, line, fn), (_, nc, tt, ct, _) in top:
        log(f"[index]   own {tt * 1e3:8.2f} ms  cum {ct * 1e3:8.2f} ms  x{nc:<6d} "
            f"{os.path.basename(f)}:{line}({fn})")
    cache.clear()


def phase_index_tier(rng, root, card):
    """Drive the index tier; returns the kernels' launches over the phase
    and, per partition, its view and the batches it took (the operands
    ``view_kernels`` checks the kernels on)."""
    import torch

    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import device_view as DV
    from repro_torch.kernels import selector_decode as SD
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.metrics import MetricsRegistry

    parts, domains, oracles, cache = build_index_partitions(rng, root)
    reg, ev = MetricsRegistry(), EventLog(capacity=256)
    mgr = DV.DeviceViewManager(DEVICE_BUDGET, slice_width=SLICE_WIDTH,
                               registry=reg, events=ev, device=DEV)
    AS.anchor_search.launches = 0
    SD.selector_decode.launches = 0
    driven = []
    for i, p in enumerate(parts):
        est = (p.device_view_bytes(True), p.device_view_bytes(False))
        t0 = time.perf_counter()
        v = mgr.view_for(p)
        torch.cuda.synchronize()
        up = time.perf_counter() - t0
        check(v is not None and v.tier == "index",
              f"partition {i}: tier {None if v is None else v.tier}, expected index")
        check(p.last_build_kind == "reuse", f"upload built {p.last_build_kind!r}")
        check(_section_reads(p, "vals") == 0, "the upload read value bytes")
        check(v.remix.g in ANCHOR_GS, f"index-tier G {v.remix.g} not in the kernel sweep")
        log(f"[index] partition {i}: estimates full {est[0]} / index {est[1]} bytes "
            f"against the {DEVICE_BUDGET}-byte budget; uploaded tier {v.tier}, "
            f"{v.nbytes} bytes, padded G {v.remix.g}, in {up:.2f} s (REMIX "
            f"{p.last_build_kind}; read keys {_section_reads(p, 'keys')}, seq "
            f"{_section_reads(p, 'seq')}, tomb {_section_reads(p, 'tomb')}, exp "
            f"{_section_reads(p, 'exp')}, vals 0 bytes); resident {mgr.resident_bytes}")
        if i:
            evicted = [(e.fields["lo"], e.fields["reason"]) for e in ev.list("device_evict")]
            check((parts[i - 1].lo, "budget") in evicted,
                  f"uploading partition {i} did not evict partition {i - 1}: {evicted}")
            check(mgr.resident_bytes == v.nbytes and len(mgr) == 1, "two views resident")
        starts = probe(rng, domains[i], SCAN_Q)
        gets = {n: probe(rng, domains[i], n) for n in (GET_SMALL, GET_LARGE)}
        traffic = ((("get", GET_SMALL), gets[GET_SMALL], GET_SMALL, "key"),
                   (("get", GET_LARGE), gets[GET_LARGE], GET_LARGE, "key"),
                   (("scan", True), starts, SCAN_Q, "query"),
                   (("scan", False), starts, SCAN_Q, "query"))
        for what, q, n, unit in traffic:
            # first pass: the block cache just cleared; warm: the same batch
            # again at once; each pair REPEATS times
            runs = {"first": [], "warm": []}
            counts = {"first": set(), "warm": set()}
            for _ in range(REPEATS):
                cache.clear()
                for label in ("first", "warm"):
                    c0 = cache.stats()
                    runs[label].append(index_batch(mgr, v, oracles[i], what, q) / n * 1e6)
                    c1 = cache.stats()
                    counts[label].add(tuple(c1[k] - c0[k] for k in ("hits", "misses",
                                                                   "evictions")))
            parts_ = [f"{label} {np.median(runs[label]):.3f} us/{unit} median of "
                      f"{', '.join(f'{x:.3f}' for x in runs[label])} (cache hits, misses, "
                      f"evictions {' / '.join(str(c) for c in sorted(counts[label]))})"
                      for label in ("first", "warm")]
            kind = (f"get_batch at {n} keys" if what[0] == "get" else
                    f"scan_windows {n} x {SCAN_WIDTH}, with_vals={what[1]}")
            log(f"[index] {card}: partition {i}: {kind}: " + "; ".join(parts_))
        granule_costs(p, cache, card)
        profile_first_pass(mgr, v, cache, gets[GET_SMALL], card)
        profile_pipeline(mgr, v, starts, card)
        batches = [("get, 256 keys", gets[GET_SMALL], 1),
                   (f"get, {GET_LARGE:,} keys", gets[GET_LARGE], 1),
                   (f"scan without values, {SCAN_Q} starts", starts, SCAN_WIDTH)]
        batches += [(f"scan slice {k}", starts[k * SLICE_WIDTH:(k + 1) * SLICE_WIDTH],
                     SCAN_WIDTH) for k in range(-(-SCAN_Q // SLICE_WIDTH))]
        driven.append((v, batches))
    fallback = _metric(reg, "device_fallback_total")
    launches = {"anchor_search": AS.anchor_search.launches,
                "selector_decode": SD.selector_decode.launches}
    log(f"[index] launches {launches}; device_fallback_total {fallback}; events "
        f"{[(e.kind, e.fields['lo'], e.fields.get('reason')) for e in ev.list()]}; "
        f"answers equal to the oracle; syncs 1 per get, 1 per scan without values, "
        f"{-(-SCAN_Q // SLICE_WIDTH)} per scan with values")
    check(fallback == 0, "device_fallback_total != 0")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    return launches, mgr, driven


def hold_kernels(remix, runset, q, widths, what, err) -> None:
    """Both kernels on one batch as a path hands them: the (Q, KW) query
    words ``q`` against ``remix``'s anchors, then the seek's group ids and
    the group ids of a window of each of ``widths`` from the seek's
    positions, each against its plain version bit for bit."""
    import torch

    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import ops
    from repro_torch.kernels import selector_decode as SD

    sel = remix.selectors.reshape(remix.g, D)
    g = AS.anchor_search(remix.anchors, q)
    check(torch.equal(g, AS.anchor_search_plain(remix.anchors, q)),
          f"{what}: anchor_search differs from its plain version")
    pos = ops.seek(remix, runset, q)
    for rows in [g] + [ops.window_operands(remix, pos, w)[0] for w in widths]:
        got = SD.selector_decode(sel, remix.cursors, rows=rows)
        want = SD.selector_decode_plain(sel, remix.cursors, rows=rows)
        e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        err["selector_decode"] = max(err["selector_decode"], e)
        check(e == 0, f"{what}: selector_decode differs from its plain version "
                      f"(N={rows.shape[0]})")


def hold_views(mgr, driven, tier, tag) -> dict:
    """``hold_kernels`` on every partition's view and batch in ``driven``
    (see ``view_kernels``); returns each kernel's max |err| (0)."""
    err = {"anchor_search": 0, "selector_decode": 0}
    cases = 0
    for v, batches in driven:
        for label, keys, width in batches:
            hold_kernels(v.remix, v.runset, mgr._queries(keys), [width], f"{tier} {label}", err)
            cases += 1
    log(f"[{tag}] both kernels on the {tier}'s operands of {len(driven)} partitions "
        f"(anchors G {sorted({v.remix.g for v, _ in driven})}; Q "
        f"{sorted({len(k) for _, b in driven for _, k, _ in b})}; seek and window group "
        f"ids): {cases} cases bit-identical to the plain versions")
    return err


def view_kernels(mgr, driven, card, tier="index tier", tag="index") -> tuple[dict, dict]:
    """Both kernels on a path's own operands: each partition's uploaded
    anchors and group tables (the index tier: padded G 2^19), the queries
    as ``get_batch`` / ``scan_windows`` upload them (the index tier: Q 64
    per scan slice, 256, 65,536), the group ids the seek produces and the
    window's group ids; every case against its plain version bit for bit,
    then the first partition's distinct shapes timed beside their bounds."""
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import ops

    err = hold_views(mgr, driven, tier, tag)
    v, batches = driven[0]
    remix = v.remix
    floor = launch_floor(card)
    anchor, decode = [], []
    seen_q = set()
    for label, keys, width in batches[:4]:  # the gets, the scan, one scan slice
        q = mgr._queries(keys)
        reps = 20 if len(keys) > GET_SMALL else 50
        if len(keys) not in seen_q:
            seen_q.add(len(keys))
            anchor.append(time_anchor(remix.anchors, q, f"{tier}, {label}", reps))
        g = AS.anchor_search(remix.anchors, q)
        win, _ = ops.window_operands(remix, ops.seek(remix, v.runset, q), width)
        if label.startswith("get") or label.startswith("scan slice"):
            decode.append(time_decode(remix, g, f"{tier}, {label}, seek", reps)[0])
        decode.append(time_decode(remix, win, f"{tier}, {label}, window", reps)[0])
    log_timings(card, "anchor_search", anchor, floor)
    log_timings(card, "selector_decode", decode, floor)
    return {"anchor_search": anchor, "selector_decode": decode}, err


# ---------------------------------------------------------------- phase 6
class StoreOracle:
    """Independent model of the store's live map: every write the phase
    issues, in order, resolved with numpy at query time (newest write per
    key wins, a range delete hides the writes before it, a TTL expires at
    ``exp <= now``)."""

    def __init__(self, vw: int):
        self.vw = vw
        self.keys, self.vals, self.exp, self.tomb, self.order = [], [], [], [], []
        self.ranges = []  # (lo, hi, order)
        self.n = 0

    def _add(self, keys, vals, exp, tomb):
        keys = np.asarray(keys, np.uint64)
        self.keys.append(keys)
        self.vals.append(np.asarray(vals, np.uint32).reshape(len(keys), self.vw))
        self.exp.append(np.broadcast_to(np.asarray(exp, np.uint32), len(keys)))
        self.tomb.append(np.full(len(keys), tomb))
        self.order.append(self.n + np.arange(len(keys), dtype=np.int64))
        self.n += len(keys)

    def put(self, keys, vals, exp=0):
        self._add(keys, vals, exp, False)

    def delete(self, keys):
        self._add(keys, np.zeros((len(keys), self.vw), np.uint32), 0, True)

    def delete_range(self, lo, hi):
        self.ranges.append((lo, hi, self.n))
        self.n += 1

    def resolve(self, now):
        keys = np.concatenate(self.keys)
        order = np.concatenate(self.order)
        idx = np.lexsort((-order, keys))
        ks = keys[idx]
        first = np.ones(len(ks), bool)
        first[1:] = ks[1:] != ks[:-1]
        top = idx[first]
        vals = np.concatenate(self.vals)[top]
        exp = np.concatenate(self.exp)[top]
        dead = np.concatenate(self.tomb)[top] | ((exp != 0) & (exp <= np.uint32(now)))
        for lo, hi, o in self.ranges:
            dead |= (keys[top] >= np.uint64(lo)) & (keys[top] < np.uint64(hi)) & (order[top] < o)
        self.all_keys = keys[top]
        self.live_keys, self.live_vals = keys[top][~dead], vals[~dead]
        self.dead_keys = keys[top][dead]
        self.expired = keys[top][(exp != 0) & (exp <= np.uint32(now))]
        self.overwritten = np.unique(ks[~first])
        return self

    def get(self, q):
        lk = self.live_keys
        i = np.searchsorted(lk, q)
        ic = np.minimum(i, len(lk) - 1)
        found = (i < len(lk)) & (lk[ic] == q)
        return found, self.live_vals[ic]

    def scan(self, start, n):
        i = int(np.searchsorted(self.live_keys, np.uint64(start)))
        return self.live_keys[i:i + n], self.live_vals[i:i + n]


@contextlib.contextmanager
def count_syncs():
    """Count the batch's device syncs: result fetches (``device_view.SYNCS``,
    whose event waits run with the sync debug mode off) and every other
    synchronising call, which the ``warn`` mode reports as a warning."""
    import warnings

    import torch

    from repro_torch.kernels import device_view as DV

    box = {"fetch": DV.SYNCS, "other": 0}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if DEV == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            if DEV == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    box["fetch"] = DV.SYNCS - box["fetch"]
    box["other"] = sum("synchroniz" in str(w.message) for w in caught)


def _store_probe(rng, orc, q):
    """Live hits, 1/8 misses, and deleted, expired and overwritten keys."""
    q_miss = q // 8
    q_special = q // 8
    special = np.concatenate([orc.dead_keys, orc.expired, orc.overwritten])
    parts = [rng.choice(orc.live_keys, q - q_miss - q_special),
             rng.integers(0, STORE_DOMAIN, q_miss, dtype=np.uint64),
             rng.choice(special, q_special)]
    out = np.concatenate(parts).astype(np.uint64)
    rng.shuffle(out)
    return out


def _touched(db, keys) -> list:
    """Partitions a get_batch sends keys to: those not answered by the
    memtable overlay or hidden by an unflushed range tombstone."""
    from repro_torch.db.sharded import route_host

    over = np.array(sorted(db.mem.data.keys()), np.uint64)
    rest = keys[~np.isin(keys, over)]
    rest = np.array([k for k in rest.tolist() if not db.mem.covers(k)], np.uint64)
    return [db.partitions[i] for i in np.unique(route_host([p.lo for p in db.partitions], rest))]


def _sync_rule(db, parts) -> str | None:
    """What a batch over these partitions may synchronise, known before it
    runs. ``"view"``: the device-view path with every view resident, which
    waits on the card only for its one fetch per partition (the batch runs
    under the sync debug mode ``error``). ``"legacy"``: the legacy path
    (``p.index()`` plus the query module) with every index built, whose
    copies block as the reference's ``jnp.asarray`` / ``np.asarray`` do:
    ``LEGACY_COPIES`` per partition, none a fetch. None: a first pass that
    uploads views or builds indexes, or a cold read; its syncs are counted
    and printed."""
    if db.device_views is not None:
        resident = db.device_views._views
        return "view" if all(id(p) in resident for p in parts) else None
    if DEV == "cuda" and not db.cfg.cold_reads and all(p._remix is not None for p in parts):
        return "legacy"
    return None


def _launch_counts():
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import selector_decode as SD

    return {"anchor_search": AS.anchor_search.launches,
            "selector_decode": SD.selector_decode.launches}


def run_counted(tag, stage, fn, launches, require=True):
    """``fn()`` with both kernels' launch counts set to 0 just before it and
    read just after (before any kernel check launches more), added into
    ``launches``; fails if ``require`` and a kernel never launched."""
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import selector_decode as SD

    AS.anchor_search.launches = 0
    SD.selector_decode.launches = 0
    out = fn()
    got = _launch_counts()
    log(f"[{tag}] {stage}: kernel launches {got}")
    check(not require or all(n > 0 for n in got.values()),
          f"{stage}: a kernel never launched: {got}")
    for k, n in got.items():
        launches[k] += n
    return out


def _shards(target):
    """(lows, stores) of a store (one range) or of a ``Cluster`` (its shards)."""
    serve = getattr(target, "serve", None)
    return ([0], [target]) if serve is None else (list(serve.lows), list(serve.shards))


def _routed(target, keys) -> list:
    """(store, its keys) for each shard of ``target`` that ``keys`` reach."""
    from repro_torch.db.sharded import route_host

    lows, stores = _shards(target)
    owner = route_host(lows, keys)
    return [(stores[i], keys[owner == i]) for i in np.unique(owner)]


def _one_rule(rules) -> str | None:
    """The batch's rule: its shards' rule when they agree, else None."""
    rules = set(rules)
    return rules.pop() if len(rules) == 1 else None


def _store_get(target, orc, keys, what):
    """One get_batch of a store or a fleet against the oracle, its syncs
    held to ``_sync_rule`` over every shard it reaches; returns seconds,
    syncs, touched partitions and the rule."""
    import torch

    per = [(db, _touched(db, k)) for db, k in _routed(target, keys)]
    touched = sum(len(ps) for _, ps in per)
    rule = _one_rule(_sync_rule(db, ps) for db, ps in per)
    stores = _shards(target)[1]
    b0 = sum(_metric(db.registry, "device_batches") for db in stores)
    with count_syncs() as syncs:
        ctx = sync_debug_error() if rule == "view" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            found, vals = target.get_batch(keys)
        dt = time.perf_counter() - t0
    f_o, v_o = orc.get(keys)
    check(np.array_equal(found, f_o), f"{what}: found differs from the oracle")
    check(np.array_equal(vals[found], v_o[found]), f"{what}: values differ from the oracle")
    dev_batches = sum(_metric(db.registry, "device_batches") for db in stores) - b0
    if rule == "view":
        check(syncs["fetch"] == touched == dev_batches and syncs["other"] == 0,
              f"{what}: {syncs} syncs, {dev_batches} device batches for {touched} "
              "touched partitions")
    if rule == "legacy":
        check(syncs["fetch"] == 0 and syncs["other"] == LEGACY_COPIES["get"] * touched,
              f"{what}: {syncs} syncs on the legacy path for {touched} touched partitions")
    if DEV == "cuda":
        torch.cuda.synchronize()
    return dt, syncs, touched, rule


def _store_scan_batch(target, orc, starts, n, what):
    """One scan_batch of a store or a fleet against the oracle, counting
    the cursor fallbacks and a fleet's drains into the next shard (both
    ``RemixDB._scan_at`` calls) and their syncs apart from the batch's own.
    Over empty overlays the batch takes one window call per touched
    partition, and its syncs are held to ``_sync_rule``: on the view path
    it runs under the sync debug mode ``error``, each fallback under
    ``warn``. Over a non-empty overlay every query takes the cursor."""
    import warnings

    import torch

    from repro_torch.db.sharded import route_host

    per = [(db, [db.partitions[i] for i in
                 np.unique(route_host([p.lo for p in db.partitions], s))])
           for db, s in _routed(target, starts)]
    parts = sum(len(ps) for _, ps in per)
    rule = (None if any(len(db.mem) or db.mem.ranges for db, _ in per)
            else _one_rule(_sync_rule(db, ps) for db, ps in per))
    falls = [0, 0]  # fallbacks, their syncs
    stores = _shards(target)[1]

    def counted(orig):
        def scan_at(*a, **kw):
            falls[0] += 1
            mode = torch.cuda.get_sync_debug_mode() if DEV == "cuda" else 0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if DEV == "cuda":
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    return orig(*a, **kw)
                finally:
                    if DEV == "cuda":
                        torch.cuda.set_sync_debug_mode(mode)
                    falls[1] += sum("synchroniz" in str(w.message) for w in caught)
        return scan_at

    for db in stores:
        db._scan_at = counted(db._scan_at)
    try:
        with count_syncs() as syncs:
            ctx = sync_debug_error() if rule == "view" else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                kk, mm = target.scan_batch(starts, n)
            dt = time.perf_counter() - t0
    finally:
        for db in stores:
            del db._scan_at
    for i, s in enumerate(starts.tolist()):
        ko, _ = orc.scan(s, n)
        check(np.array_equal(kk[i][mm[i]], ko), f"{what}: row {i} differs from the oracle")
    want = {"view": (parts, 0), "legacy": (0, LEGACY_COPIES["scan"] * parts)}.get(rule)
    check(want is None or (syncs["fetch"], syncs["other"]) == want,
          f"{what}: {syncs} syncs besides {falls[1]} in {falls[0]} cursor fallbacks "
          f"for {parts} touched partitions ({rule} path)")
    return dt, syncs, falls, parts, rule


def _read_pairs(target, orc, rng, stage, card, tag="store", starts_fn=None, repeats=REPEATS):
    """get_batch at 256 and 65,536 keys and scan_batch of 256 starts x 50
    on a store or a fleet, ``repeats`` first/warm pairs each (µs per key or per
    query, median with min-max). Each batch's syncs are held to
    ``_sync_rule`` (the rule is printed with them: view, legacy, or None
    where the batch uploads, builds or reads cold). ``starts_fn(rng)``
    picks the scan starts (default: live keys at random). Returns every
    batch's (pass, rule, touched partitions, ...) notes."""
    seen = set()
    for q in (STORE_GET_SMALL, STORE_GET_LARGE):
        runs = {"first": [], "warm": []}
        notes = set()
        for _ in range(repeats):
            keys = _store_probe(rng, orc, q)
            for label in ("first", "warm"):
                dt, syncs, touched, rule = _store_get(
                    target, orc, keys, f"{stage} get_batch {q} {label}")
                runs[label].append(dt / q * 1e6)
                notes.add((label, str(rule), touched, syncs["fetch"], syncs["other"]))
        log(f"[{tag}] {card}: {stage}: get_batch at {q} keys: " + "; ".join(
            f"{label} {np.median(v):.4f} us/key (min {min(v):.4f}, max {max(v):.4f})"
            for label, v in runs.items())
            + "; (pass, sync rule, touched partitions, fetch syncs, other syncs) "
            f"{sorted(notes)}")
        seen |= notes
    runs = {"first": [], "warm": []}
    notes = set()
    for _ in range(repeats):
        starts = (starts_fn(rng) if starts_fn is not None else
                  np.sort(rng.choice(orc.live_keys, STORE_SCAN_Q)).astype(np.uint64))
        for label in ("first", "warm"):
            dt, syncs, falls, touched, rule = _store_scan_batch(
                target, orc, starts, STORE_SCAN_N, f"{stage} scan_batch {label}")
            runs[label].append(dt / len(starts) * 1e6)
            notes.add((label, str(rule), touched, falls[0], falls[1], syncs["fetch"],
                       syncs["other"]))
    log(f"[{tag}] {card}: {stage}: scan_batch {STORE_SCAN_Q} x {STORE_SCAN_N}: " + "; ".join(
        f"{label} {np.median(v):.3f} us/query (min {min(v):.3f}, max {max(v):.3f})"
        for label, v in runs.items())
        + "; (pass, sync rule, touched partitions, cursor fallbacks, their syncs, "
        f"fetch syncs, other syncs) {sorted(notes)}")
    return seen | notes


def _store_reads(db, orc, rng, stage, card):
    """``_read_pairs`` on the store, then a single scan and a cursor across
    a partition boundary."""
    _read_pairs(db, orc, rng, stage, card)
    parts = db.partitions
    lows = [p.lo for p in parts]
    s = int(rng.choice(orc.live_keys))
    kk, vv = db.scan(s, STORE_SCAN_N)
    ko, vo = orc.scan(s, STORE_SCAN_N)
    check(np.array_equal(kk, ko) and np.array_equal(vv, vo), f"{stage}: scan differs")
    check(len(parts) > 1, f"{stage}: one partition; no boundary to cross")
    b = int(lows[len(lows) // 2])
    start = int(orc.live_keys[max(0, np.searchsorted(orc.live_keys, np.uint64(b)) - 100)])
    with db.cursor(start, width=64) as cur:
        kk, vv = cur.next_batch(300)
    ko, vo = orc.scan(start, 300)
    check(np.array_equal(kk, ko) and np.array_equal(vv, vo),
          f"{stage}: cursor across the boundary at {b} differs")
    check(kk[0] < b <= kk[-1], f"{stage}: the cursor did not cross {b}")
    log(f"[store] {stage}: scan({s}, {STORE_SCAN_N}) and a cursor of 300 entries "
        f"across the partition boundary at {b} equal the oracle")


def _store_memory(db, stage, base):
    """The store's device bytes: its views (``hbm_resident_bytes``) beside
    what torch allocated since the phase began (``base``: the earlier
    phases' views stay allocated), which also holds each partition's
    plain index built by compaction, the cursor and the legacy path."""
    import torch

    alloc = torch.cuda.memory_allocated() - base if DEV == "cuda" else 0
    peak = torch.cuda.max_memory_allocated() - base if DEV == "cuda" else 0
    log(f"[store] {stage}: hbm_resident_bytes {_metric(db.registry, 'hbm_resident_bytes')} "
        f"(views {0 if db.device_views is None else len(db.device_views)}); since the "
        f"phase began torch.cuda.memory_allocated {alloc}, max_memory_allocated {peak}; "
        f"partitions with a plain index on the card "
        f"{sum(p._remix is not None for p in db.partitions)}")


def _store_load(db, orc, rng) -> int:
    """``STORE_KEYS`` put_batch keys in batches of ``STORE_BATCH``, then a
    last batch of ``STORE_TAIL`` keys that stops short of a memtable flush
    (unflushed writes for the overlay and the WAL replay): 20% overwrites
    of earlier keys, TTLs on 10% (half of them expired at ``NOW``), 1%
    point deletes per batch through one Batch of Op.delete, one
    delete_range a third of the way in. Returns the keys put."""
    from repro_torch.db.ops import Batch, Op

    nb = STORE_KEYS // STORE_BATCH + 1
    pool = np.zeros(0, np.uint64)
    n_put = 0
    for b in range(nb):
        n = STORE_BATCH
        if b == nb - 1:
            n = min(STORE_TAIL, (db.cfg.memtable_entries - len(db.mem)) * 9 // 10)
        over = rng.choice(pool, n // 5) if len(pool) else pool
        keys = np.unique(np.concatenate([
            rng.integers(0, STORE_DOMAIN, n - len(over), dtype=np.uint64), over]))
        rng.shuffle(keys)
        vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
        ttl = rng.random(len(keys)) < 0.10
        ttls = np.where(rng.random(int(ttl.sum())) < 0.5, TTL_SHORT, TTL_LONG)
        dels = rng.choice(pool if len(pool) else keys, n // 100)
        db.put_batch(keys[~ttl], vals[~ttl])
        db.put_batch(keys[ttl], vals[ttl], ttl=ttls)
        orc.put(keys[~ttl], vals[~ttl])
        orc.put(keys[ttl], vals[ttl], exp=(T_LOAD + ttls).astype(np.uint32))
        res = db.submit(Batch([Op.delete(int(k)) for k in dels]), sync=True).result()
        check(res.ok, "the delete batch failed")
        orc.delete(dels)
        if b == nb // 3:
            lo = int(rng.integers(0, STORE_DOMAIN - (1 << 34)))
            db.delete_range(lo, lo + (1 << 34))
            orc.delete_range(lo, lo + (1 << 34))
        pool = np.concatenate([pool, keys])
        n_put += len(keys)
    return n_put


def _store_operands(db, orc, rng):
    """Each promoted partition's view and the batches the store hands it:
    a 256-key and a 65,536-key get_batch and a 256-start scan_batch, routed
    to partitions as the store routes them (overlay keys included: the
    kernels' inputs, not the answers, are what is checked)."""
    gets = {q: _store_probe(rng, orc, q) for q in (STORE_GET_SMALL, STORE_GET_LARGE)}
    starts = np.sort(rng.choice(orc.live_keys, STORE_SCAN_Q)).astype(np.uint64)
    width = STORE_SCAN_N + max(8, STORE_SCAN_N // 2)  # the store's scan window
    return _view_batches(db, [(f"get, {STORE_GET_SMALL} keys", gets[STORE_GET_SMALL], 1),
                              (f"get, {STORE_GET_LARGE:,} keys", gets[STORE_GET_LARGE], 1),
                              (f"scan, {STORE_SCAN_Q} starts", starts, width)])


def _view_batches(db, batches):
    """(the store's view manager, [(view, batches)]): each partition's
    resident view, largest first, with its share of ``batches`` (label,
    keys, window width), routed as the store routes them."""
    from repro_torch.db.sharded import route_host

    parts = db.partitions
    lows = [p.lo for p in parts]
    driven = []
    for i in sorted(range(len(parts)), key=lambda i: -parts[i].n_entries):
        v = db.device_views.view_for(parts[i])
        check(v is not None, "a promoted partition has no view")
        mine = []
        for label, keys, w in batches:
            sel = keys[route_host(lows, keys) == i]
            if len(sel):
                mine.append((f"{label} ({len(sel)} to this partition)", sel, w))
        driven.append((v, mine))
    return db.device_views, driven


def _legacy_operands(db, orc, rng):
    """Each partition's ``p.index()`` REMIX and the queries the legacy path
    and the cursor hand the kernels: a 256-key and a 65,536-key get_batch
    and a 256-start scan_batch, routed as the store routes them and padded
    to its power-of-two buckets (``store._pow2pad``), and the cursor's
    one-key seek with the windows it reads (a scan fallback's width
    n + max(8, n // 2), ``cursor(width=64)``, and the widening cap)."""
    from repro_torch.core import keys as CK
    from repro_torch.db import cursor as C
    from repro_torch.db.sharded import route_host
    from repro_torch.db.store import _pow2pad
    from repro_torch.device import as_words

    parts = db.partitions
    lows = [p.lo for p in parts]
    gets = {q: _store_probe(rng, orc, q) for q in (STORE_GET_SMALL, STORE_GET_LARGE)}
    starts = np.sort(rng.choice(orc.live_keys, STORE_SCAN_Q)).astype(np.uint64)
    width = STORE_SCAN_N + max(8, STORE_SCAN_N // 2)
    driven = []
    for i in sorted(range(len(parts)), key=lambda i: -parts[i].n_entries):
        p = parts[i]
        remix, runset = p.index()
        batches = []
        for label, keys, ws in ((f"get, {STORE_GET_SMALL} keys", gets[STORE_GET_SMALL], [1]),
                                (f"get, {STORE_GET_LARGE:,} keys", gets[STORE_GET_LARGE], [1]),
                                (f"scan, {STORE_SCAN_Q} starts", starts, [width])):
            mine = keys[route_host(lows, keys) == i]
            if len(mine):
                kq = np.pad(mine, (0, _pow2pad(len(mine)) - len(mine)))
                batches.append((f"{label} ({len(mine)} to this partition, padded to "
                                f"{len(kq)})", as_words(CK.pack_u64(kq), p.device), ws))
        mine = orc.live_keys[route_host(lows, orc.live_keys) == i]
        one = np.array([rng.choice(mine)], np.uint64)
        batches.append(("cursor seek, 1 key", as_words(CK.pack_u64(one), p.device),
                        [width, 64, C._MAX_WIDTH]))
        driven.append((p, remix, runset, batches))
    return driven


def legacy_kernels(driven, card) -> tuple[dict, dict]:
    """Both kernels on the legacy path's and the cursor's own operands
    (``_legacy_operands``), against their plain versions bit for bit,
    then the cursor's one-key seek, the shape the legacy stage launches
    most, timed on the largest partition beside its bounds."""
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import ops

    err = {"anchor_search": 0, "selector_decode": 0}
    cases = 0
    for _, remix, runset, batches in driven:
        for label, q, widths in batches:
            hold_kernels(remix, runset, q, widths, f"store legacy path {label}", err)
            cases += 1
    log(f"[store] both kernels on the legacy path's and the cursor's operands of "
        f"{len(driven)} partitions (p.index() G {sorted({r.g for _, r, _, _ in driven})}; "
        f"Q {sorted({q.shape[0] for *_, b in driven for _, q, _ in b})}; seek and window "
        f"group ids): {cases} cases bit-identical to the plain versions")
    _, remix, runset, batches = driven[0]
    _, q, widths = batches[-1]
    floor = launch_floor(card)
    anchor = [time_anchor(remix.anchors, q, "store, cursor seek", 50)]
    g = AS.anchor_search(remix.anchors, q)
    win, _ = ops.window_operands(remix, ops.seek(remix, runset, q), widths[0])
    decode = [time_decode(remix, g, "store, cursor seek", 50)[0],
              time_decode(remix, win, f"store, cursor window of {widths[0]}", 50)[0]]
    log_timings(card, "anchor_search", anchor, floor)
    log_timings(card, "selector_decode", decode, floor)
    return {"anchor_search": anchor, "selector_decode": decode}, err


def _store_tail(db, orc, rng):
    """Unflushed writes for the overlay and the WAL replay: 4,096 puts
    (a quarter overwrites, a tenth with TTLs) and 64 point deletes."""
    keys = np.unique(np.concatenate([
        rng.integers(0, STORE_DOMAIN, 3072, dtype=np.uint64),
        rng.choice(orc.all_keys, 1024)]))
    vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
    ttl = np.arange(len(keys)) % 10 == 0
    db.put_batch(keys[~ttl], vals[~ttl])
    db.put_batch(keys[ttl], vals[ttl], ttl=TTL_LONG)
    dels = rng.choice(orc.live_keys, 64)
    for k in dels.tolist():
        db.delete(k)
    orc.put(keys[~ttl], vals[~ttl])
    orc.put(keys[ttl], vals[ttl], exp=NOW + TTL_LONG)
    orc.delete(dels)
    orc.resolve(NOW)
    check(len(db.mem) > 0, "the tail flushed")
    log(f"[store] stage 1: tail of {len(keys)} puts and {len(dels)} deletes left in "
        f"the memtable ({len(db.mem)} entries)")


def store_config(root, **over):
    """The phase's RemixDBConfig: the widths of src/repro/configs/remixdb.py
    on ``DEV``, every field not in ``over`` at the reference's default."""
    from repro_torch.db.store import RemixDBConfig

    return RemixDBConfig(vw=VW, d=D, data_dir=root, device=DEV, **over)


def _g_guard(stage, gs):
    check(set(gs) <= set(ANCHOR_GS), f"{stage}: store G {sorted(gs)} not in the kernel sweep")


def phase_store(rng, root, card):
    """Drive the port's RemixDB through its public API (see the module
    docstring, phase 6); returns the kernels' launches over the phase, the
    timed shapes and the kernels' max |err| on the store's operands."""
    import torch

    from repro_torch.db import clock
    from repro_torch.db.store import RemixDB

    t_now = [float(T_LOAD)]
    clock.set_source(lambda: t_now[0])
    mem0 = 0
    if DEV == "cuda":
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cfg = store_config(root)
    log(f"[store] RemixDBConfig: vw {cfg.vw}, d {cfg.d}, memtable_entries "
        f"{cfg.memtable_entries}, {cfg.compaction}, device_path {cfg.device_path}, "
        f"device_budget_bytes {cfg.device_budget_bytes}, cache_bytes {cfg.cache_bytes}, "
        f"device_slice {cfg.device_slice}, cold_reads {cfg.cold_reads}, promote_fraction "
        f"{cfg.promote_fraction}, sync_policy {cfg.sync_policy}, ckb {cfg.ckb}")
    launches = {k: 0 for k in _launch_counts()}

    # ---- load
    orc = StoreOracle(VW)
    db = RemixDB(cfg)
    t0 = time.perf_counter()
    n_put = _store_load(db, orc, rng)
    load_s = time.perf_counter() - t0
    st = db.stats()
    flush = db.registry.histogram("db_flush_seconds").summary()
    du = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    kinds = st["compaction"]["kinds"]
    log(f"[store] {card}: loaded {n_put} put_batch keys ({orc.n} writes with the "
        f"deletes) in {load_s:.3f} s: {n_put / load_s:.0f} keys/s; db_flush_seconds count "
        f"{flush['count']} sum {flush['sum']:.3f} s (p50 {flush['p50']:.3f}, max "
        f"{flush['max']:.3f}); {st['partitions']} partitions, {st['tables']} tables, "
        f"{st['entries']} entries, {du} bytes on disk; memtable {st['memtable']} "
        f"entries unflushed; compaction kinds {kinds}; write amplification {st['wa']:.3f}")
    check({"minor", "split"} <= set(kinds), f"compaction kinds {kinds}: no minor or split")
    check(st["memtable"] > 0, "the last batch flushed the memtable")
    t_now[0] = float(NOW)
    orc.resolve(NOW)
    log(f"[store] oracle at now: {len(orc.live_keys)} live keys, {len(orc.dead_keys)} "
        f"dead ({len(orc.expired)} expired), {len(orc.overwritten)} overwritten")

    # ---- stage 1: the store as loaded, then flushed, then a new tail
    def stage1():
        _store_reads(db, orc, rng, "stage 1 (as loaded, memtable overlay)", card)
        t0 = time.perf_counter()
        db.flush()
        log(f"[store] stage 1: flush in {time.perf_counter() - t0:.3f} s; memtable "
            f"{len(db.mem)}; {len(db.partitions)} partitions")
        _store_reads(db, orc, rng, "stage 1 (flushed, no overlay)", card)
        _store_tail(db, orc, rng)
        views = db.device_views._views.values()
        log(f"[store] stage 1: view tiers {sorted({v.tier for v in views})} over "
            f"{len(db.device_views)} views ({sum(v.nbytes for v in views)} bytes)")
        check(all(v.tier == "full" for v in views), "a view is not on the full tier")
        keys = _store_probe(rng, orc, STORE_GET_SMALL)
        from repro_torch.db.ops import Batch, Op

        futs = [db.submit(Batch([Op.multiget(keys)])) for _ in range(4)]
        for f in futs:
            r = f.result(timeout=120).results[0]
            f_o, v_o = orc.get(keys)
            check(np.array_equal(r.found, f_o) and np.array_equal(r.vals[r.found], v_o[r.found]),
                  "an async multiget on the submit workers differs from the oracle")
        log("[store] stage 1: 4 async multigets on the submit worker threads equal the oracle")
        _store_memory(db, "stage 1", mem0)
        if DEV == "cuda":
            profile_batches(f"{card}: store get_batch at {STORE_GET_SMALL} keys",
                            lambda: db.get_batch(keys), 10)

    run_counted("store", "stage 1", stage1, launches)
    fallback = _metric(db.registry, "device_fallback_total")
    check(fallback == 0, f"device_fallback_total {fallback}")
    mem_n = len(db.mem)
    db.close()

    # ---- stage 2: reopen, cold reads, the promotion edge
    def stage2():
        t0 = time.perf_counter()
        db2 = RemixDB.open(root, cfg)
        log(f"[store] {card}: stage 2: RemixDB.open in {time.perf_counter() - t0:.3f} s: "
            f"{len(db2.partitions)} partitions, {sum(p.cold_ready() for p in db2.partitions)} "
            f"cold-ready, memtable {len(db2.mem)} entries replayed from the WAL")
        check(len(db2.mem) == mem_n, "the WAL replay lost memtable entries")
        check(all(p.cold_ready() for p in db2.partitions), "a partition is not cold-ready")
        _store_memory(db2, "stage 2 at open", mem0)
        check(_metric(db2.registry, "hbm_resident_bytes") == 0, "views resident at open")
        edge = []
        for i in range(STORE_EDGE_ROUNDS):
            keys = _store_probe(rng, orc, STORE_GET_SMALL if i < 2 else STORE_GET_LARGE)
            c0 = db2.stats()["cold"]["gets"]
            b0 = _metric(db2.registry, "device_batches")
            dt, syncs, touched, _ = _store_get(db2, orc, keys, f"stage 2 edge {i}")
            promoted = {e.fields["lo"] for e in db2.events.list("promotion")}
            edge.append((i, len(keys), round(dt / len(keys) * 1e6, 4),
                         db2.stats()["cold"]["gets"] - c0,
                         _metric(db2.registry, "device_batches") - b0,
                         len(promoted), syncs["fetch"]))
            if len(promoted) == len(db2.partitions) and edge[-1][4] > 0:
                break
        log(f"[store] {card}: stage 2 promotion edge: (batch, keys, us/key, cold gets, "
            f"device batches, partitions promoted, fetch syncs) {edge}")
        check(edge[0][3] > 0 and edge[0][4] == 0, "the first batch after open was not cold")
        check(edge[-1][5] == len(db2.partitions), "not every partition was promoted")
        check(edge[-1][4] > 0, "device_batches did not rise after promotion")
        _store_reads(db2, orc, rng, "stage 2 (reopened, promoted)", card)
        _store_memory(db2, "stage 2", mem0)
        check(_metric(db2.registry, "device_fallback_total") == 0, "device_fallback_total != 0")
        # the kernels on this path's own operands (outside the counted run)
        driven = _store_operands(db2, orc, rng)
        db2.close()
        return driven

    driven = run_counted("store", "stage 2", stage2, launches)
    _g_guard("stage 2", {v.remix.g for v, _ in driven[1]})
    shapes, err = (view_kernels(driven[0], driven[1], card, tier="store", tag="store")
                   if DEV == "cuda" else ({}, {}))

    # ---- stage 3: the legacy path with the kernels, over the WAL's
    # overlay (every scan takes the cursor), then flushed (ops.scan)
    def stage3():
        t0 = time.perf_counter()
        db3 = RemixDB.open(root, store_config(root, use_kernels=True, device_path="off",
                                              cold_reads=False))
        log(f"[store] {card}: stage 3: RemixDB.open(use_kernels=True, device_path='off', "
            f"cold_reads=False) in {time.perf_counter() - t0:.3f} s")
        check(db3.device_views is None, "stage 3 built device views")
        _store_reads(db3, orc, rng, "stage 3 (use_kernels, legacy path, overlay)", card)
        t0 = time.perf_counter()
        db3.flush()
        log(f"[store] stage 3: flush in {time.perf_counter() - t0:.3f} s; memtable "
            f"{len(db3.mem)}; {len(db3.partitions)} partitions")
        _store_reads(db3, orc, rng, "stage 3 (use_kernels, legacy path, flushed)", card)
        _store_memory(db3, "stage 3", mem0)
        check(db3.device_views is None and all(p._remix is not None for p in db3.partitions),
              "stage 3 left a partition without its legacy index")
        # the kernels on this path's own operands (outside the counted run)
        driven = _legacy_operands(db3, orc, rng)
        db3.close()
        return driven

    driven = run_counted("store", "stage 3", stage3, launches)
    _g_guard("stage 3", {remix.g for _, remix, _, _ in driven})
    if DEV == "cuda":
        legacy_shapes, legacy_err = legacy_kernels(driven, card)
        shapes = {k: shapes[k] + legacy_shapes[k] for k in shapes}
        err = {k: max(err[k], legacy_err[k]) for k in err}
    clock.reset()
    return launches, shapes, err


# ---------------------------------------------------------------- phase 7
class GateClock:
    """A ``Cluster``'s submission gate (an RLock) that records how long
    each thread held it, outermost acquire to release, so the split's
    cutover can be read apart from the submitters' short holds."""

    def __init__(self, lock):
        self.lock = lock
        self.local = threading.local()
        self.holds = []  # (thread name, t_acquired, t_released)

    def __enter__(self):
        self.lock.acquire()
        depth = getattr(self.local, "depth", 0)
        if depth == 0:
            self.local.t0 = time.perf_counter()
        self.local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        self.local.depth -= 1
        if self.local.depth == 0:
            self.holds.append((threading.current_thread().name, self.local.t0,
                               time.perf_counter()))
        self.lock.release()
        return False


class FleetTraffic:
    """``FLEET_THREADS`` submitters of ``FLEET_BATCH``-key batches through
    ``Cluster.submit`` (``benchmarks/cluster_bench.py``): keys drawn by a
    zipfian (theta 0.99) over ranks permuted over ``keys``, ``FLEET_PUT_SHARE``
    of the batches ``Op.put`` with every value word ``t + 1`` for thread
    ``t``, the rest ``Op.multiget``. Each batch's submit-to-result time is
    recorded with its keys (and a read's answers)."""

    def __init__(self, cluster, keys, seed):
        rng = np.random.default_rng(seed)
        self.cluster = cluster
        self.keys = rng.permutation(keys)
        w = 1.0 / np.arange(1, len(keys) + 1, dtype=np.float64) ** FLEET_THETA
        self.cdf = np.cumsum(w) / w.sum()
        self.seed = seed
        self.stop_ev = threading.Event()
        self.lock = threading.Lock()
        self.reads, self.writes, self.failed = [], [], []
        self.threads = [threading.Thread(target=self._loop, args=(t,), name=f"submitter-{t}")
                        for t in range(FLEET_THREADS)]

    def _loop(self, tid):
        from repro_torch.db.ops import Batch, Op

        rng = np.random.default_rng(self.seed + 1 + tid)
        while not self.stop_ev.is_set():
            ks = self.keys[np.minimum(np.searchsorted(self.cdf, rng.random(FLEET_BATCH)),
                                      len(self.keys) - 1)]
            write = rng.random() < FLEET_PUT_SHARE
            op = (Op.put(ks, np.full((len(ks), VW), tid + 1, np.uint32)) if write
                  else Op.multiget(ks))
            t0 = time.perf_counter()
            try:
                r = self.cluster.submit(Batch([op])).result(timeout=120).results[0]
                r.raise_if_error()
            except Exception as e:  # every failure is counted; the phase requires 0
                with self.lock:
                    self.failed.append(repr(e))
                continue
            t1 = time.perf_counter()
            with self.lock:
                if write:
                    self.writes.append((t0, t1, tid, ks))
                else:
                    self.reads.append((t0, t1, ks, r.found, r.vals))

    def start(self):
        for t in self.threads:
            t.start()

    def stop(self):
        self.stop_ev.set()
        for t in self.threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in self.threads), "a submitter did not stop")

    def latencies(self, t_lo, t_hi):
        """Seconds of the batches submitted in [t_lo, t_hi), in submit order."""
        rows = sorted((t0, t1 - t0) for t0, t1, *_ in self.reads + self.writes
                      if t_lo <= t0 < t_hi)
        return np.array([d for _, d in rows])


def _written(traffic):
    """Every key the traffic put: sorted keys, a bitmask of the threads
    that put each, and each key's first acknowledgement time."""
    keys = np.concatenate([w[3] for w in traffic.writes])
    tids = np.concatenate([np.full(len(w[3]), w[2]) for w in traffic.writes])
    acks = np.concatenate([np.full(len(w[3]), w[1]) for w in traffic.writes])
    uk, inv = np.unique(keys, return_inverse=True)
    mask = np.zeros(len(uk), np.int64)
    np.bitwise_or.at(mask, inv, 1 << tids)
    first = np.full(len(uk), np.inf)
    np.minimum.at(first, inv, acks)
    return uk, mask, first


def _acked(vals, mask):
    """Rows of ``vals`` that a put of a thread in ``mask`` wrote: every
    word ``t + 1``."""
    t = vals[:, 0].astype(np.int64) - 1
    return ((vals == vals[:, :1]).all(1) & (t >= 0) & (t < FLEET_THREADS)
            & ((mask >> np.clip(t, 0, 62)) & 1).astype(bool))


def _check_traffic_reads(traffic, orc):
    """The acknowledged-value rule on every read the traffic made: each key
    is live in the preload and never deleted, so it is found, and its value
    is the preload's or a put's of a thread that put it (``_acked``); once
    a put of the key was acknowledged before the read was submitted, the
    preload's value is no longer allowed. Returns the reads checked."""
    uk, mask, first = _written(traffic)
    n = 0
    for t0, _, ks, found, vals in traffic.reads:
        check(found.all(), "a traffic read lost a key")
        _, pre = orc.get(ks)
        i = np.minimum(np.searchsorted(uk, ks), len(uk) - 1)
        hit = uk[i] == ks
        m = np.where(hit, mask[i], 0)
        ok = _acked(vals, m) | ((vals == pre).all(1) & ~(hit & (first[i] < t0)))
        check(ok.all(), f"a traffic read returned a value no write put there: "
                        f"{vals[~ok][:2].tolist()} for {ks[~ok][:2].tolist()}")
        n += len(ks)
    return n


def _fleet_load(cluster, orc, rng) -> int:
    """``FLEET_KEYS`` keys through ``Cluster.submit``: ``Op.put`` batches of
    ``STORE_BATCH`` keys uniform over [0, 2^40), 20% overwrites of earlier
    keys, 1% point deletes per batch through one Batch of ``Op.delete``,
    one ``Op.delete_range`` of 2^34 a third of the way in; then a flush."""
    from repro_torch.db.ops import Batch, Op

    nb = FLEET_KEYS // STORE_BATCH
    pool = np.zeros(0, np.uint64)
    n_put = 0
    for b in range(nb):
        over = rng.choice(pool, STORE_BATCH // 5) if len(pool) else pool
        keys = np.unique(np.concatenate([
            rng.integers(0, STORE_DOMAIN, STORE_BATCH - len(over), dtype=np.uint64), over]))
        rng.shuffle(keys)
        vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
        dels = rng.choice(pool if len(pool) else keys, STORE_BATCH // 100)
        ops = [Batch([Op.put(keys, vals)]), Batch([Op.delete(int(k)) for k in dels])]
        if b == nb // 3:
            lo = int(rng.integers(0, STORE_DOMAIN - (1 << 34)))
            ops.append(Batch([Op.delete_range(lo, lo + (1 << 34))]))
        for batch in ops:
            check(cluster.submit(batch).result(timeout=600).ok, "a load batch failed")
        orc.put(keys, vals)
        orc.delete(dels)
        if b == nb // 3:
            orc.delete_range(lo, lo + (1 << 34))
        pool = np.concatenate([pool, keys])
        n_put += len(keys)
    cluster.flush()
    return n_put


def _fleet_starts(orc, lows):
    """Scan starts for the fleet: live keys at random, and for every shard
    boundary the 8 live keys just below it, whose Seek+Next50 drains into
    the next shard."""
    def pick(rng):
        edge = [orc.live_keys[max(0, np.searchsorted(orc.live_keys, np.uint64(b)) - 8):
                              np.searchsorted(orc.live_keys, np.uint64(b))]
                for b in lows[1:]]
        edge = np.concatenate(edge)
        rest = rng.choice(orc.live_keys, STORE_SCAN_Q - len(edge))
        return np.sort(np.concatenate([edge, rest])).astype(np.uint64)
    return pick


def _fleet_memory(label, base, stores):
    """Device bytes now (since the phase began) beside each tracked store's
    view bytes: ``stores`` maps a label to a weak reference of a store."""
    import torch

    alloc = 0
    if DEV == "cuda":
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - base
    held = []
    for name, ref in stores.items():
        db = ref()
        held.append(f"{name}: " + ("collected" if db is None else
                    f"referenced, views "
                    f"{0 if db.device_views is None else db.device_views.resident_bytes} B"))
    log(f"[cluster] device memory {label}: torch.cuda.memory_allocated {alloc} B since the "
        f"phase began; stores: {'; '.join(held)}")
    return alloc


def _promote(cluster, db, orc, rng, lo, hi, what):
    """65,536-key gets into one shard's span ``[lo, hi)`` through the fleet
    until every partition of ``db`` is promoted (cold reads until then);
    each batch against the oracle. Returns the edge: (batch, µs/key, cold
    gets, device batches, cold partitions after it)."""
    live = orc.live_keys[(orc.live_keys >= np.uint64(lo)) & (orc.live_keys < np.uint64(hi))]
    edge = []
    for i in range(STORE_EDGE_ROUNDS):
        cold = [p for p in db.partitions if db._cold_ok(p)]
        if not cold:
            break
        keys = rng.choice(live, STORE_GET_LARGE).astype(np.uint64)
        c0 = db.stats()["cold"]["gets"]
        b0 = _metric(db.registry, "device_batches")
        dt, _, _, _ = _store_get(cluster, orc, keys, f"{what} edge {i}")
        edge.append((i, round(dt / len(keys) * 1e6, 4), db.stats()["cold"]["gets"] - c0,
                     _metric(db.registry, "device_batches") - b0,
                     sum(db._cold_ok(p) for p in db.partitions)))
    check(not any(db._cold_ok(p) for p in db.partitions), f"{what}: a partition stayed cold")
    return edge


def phase_cluster(rng, root, card):
    """Drive a 3-shard fleet through the port's ``Cluster`` (see the module
    docstring, phase 7); returns the kernels' launches over the phase, the
    shapes timed on the new shard's operands and the kernels' max |err|."""
    import gc
    import weakref

    import torch

    from repro_torch.cluster import Cluster

    mem0 = 0
    gc.collect()  # the baseline holds nothing of earlier phases' closed stores
    if DEV == "cuda":
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
    cfg = store_config(None)
    lows0 = [i * (STORE_DOMAIN // FLEET_SHARDS) for i in range(FLEET_SHARDS)]
    cluster = Cluster(root, lows=lows0, config=cfg)
    log(f"[cluster] Cluster: lows {lows0}, cache_bytes {cluster.serve.cache.capacity_bytes}, "
        f"submit workers {cluster.serve._submit_workers}; each shard's RemixDBConfig as "
        f"phase 6's (device {cfg.device})")
    launches = {k: 0 for k in _launch_counts()}
    orc = StoreOracle(VW)
    box = {}

    # ---- stage 1: load
    def stage1():
        t0 = time.perf_counter()
        n_put = _fleet_load(cluster, orc, rng)
        dt = time.perf_counter() - t0
        orc.resolve(NOW)
        st = cluster.stats()["stores"]
        du = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        flushes = [int(db.registry.histogram("db_flush_seconds").summary()["count"])
                   for db in cluster.serve.shards]
        log(f"[cluster] {card}: stage 1: loaded {n_put} put keys ({orc.n} writes with the "
            f"deletes) through Cluster.submit in {dt:.3f} s: {n_put / dt:.0f} keys/s; flushes "
            f"per shard {flushes}; partitions per shard {[s['partitions'] for s in st]}; "
            f"entries per shard {[s['entries'] for s in st]}; memtable entries carried by the "
            f"flush {[s['memtable'] for s in st]}; {du} bytes on disk; oracle "
            f"{len(orc.live_keys)} live keys")
        check(min(s["partitions"] for s in st) >= 1, "a shard has no partition")

    run_counted("cluster", "stage 1 (load)", stage1, launches, require=False)

    # ---- stage 2: quiesced reads through the fleet
    def stage2():
        notes = _read_pairs(cluster, orc, rng, "stage 2 (loaded, flushed)", card, tag="cluster",
                            starts_fn=_fleet_starts(orc, lows0))
        # a scan over a shard whose flush carried entries in its memtable
        # takes the cursor (rule None); the gets hold the view path
        check(all(n[1] == "view" for n in notes if n[0] == "warm" and len(n) == 5),
              f"a warm fleet get left the view path: {notes}")
        check(all(n[3] > 0 for n in notes if len(n) == 7), "no scan drained into the next shard")
        keys = _store_probe(rng, orc, STORE_GET_SMALL)
        profile_batches(f"{card}: fleet get_batch at {STORE_GET_SMALL} keys",
                        lambda: cluster.get_batch(keys), 10)

    run_counted("cluster", "stage 2 (quiesced reads)", stage2, launches)

    # ---- stage 3: live split under zipfian traffic
    refs = {f"shard {lo}": weakref.ref(db) for lo, db in zip(lows0, cluster.serve.shards)}
    box["mem"] = [("before the split (3 shards)", _fleet_memory("before the split", mem0, refs))]

    def stage3():
        gate = GateClock(cluster._gate)
        cluster._gate = gate
        bounds = [int(p.lo) for p in cluster.serve.shards[0].partitions if 0 < p.lo < lows0[1]]
        traffic = FleetTraffic(cluster, orc.live_keys, seed=int(rng.integers(1 << 30)))
        traffic.start()
        t_start = time.perf_counter()
        time.sleep(FLEET_PHASE_S)
        t_split0 = time.perf_counter()
        rep = cluster.split(lows0[1] // 2)
        t_split1 = time.perf_counter()
        time.sleep(FLEET_PHASE_S)
        traffic.stop()
        t_end = time.perf_counter()
        cluster._gate = gate.lock
        check(not traffic.failed, f"{len(traffic.failed)} failed ops: {traffic.failed[:3]}")
        at = rep["at"]
        check(cluster.lows == sorted(lows0 + [at]), f"lows after the split {cluster.lows}")
        check(at in bounds, f"the split at {at} is not one of shard 0's partition "
                            f"boundaries {bounds}")
        me = threading.current_thread().name
        held = [b - a for name, a, b in gate.holds if name == me and t_split0 <= a <= t_split1]
        pre = traffic.latencies(t_start, t_split0)
        during = traffic.latencies(t_split0, t_split1)
        post = traffic.latencies(t_split1, t_end)
        first, steady = post[:FLEET_FIRST], post[FLEET_FIRST:]
        nb = len(traffic.reads) + len(traffic.writes)

        def pct(a):
            return (f"p50 {np.percentile(a, 50) * 1e3:.3f} ms, p99 "
                    f"{np.percentile(a, 99) * 1e3:.3f} ms ({len(a)} batches)") if len(a) else "none"

        log(f"[cluster] {card}: stage 3: {nb} batches, {nb * FLEET_BATCH} ops "
            f"({len(traffic.writes)} put batches) from {FLEET_THREADS} submitters over "
            f"{t_end - t_start:.3f} s; failed ops {len(traffic.failed)}")
        log(f"[cluster] {card}: stage 3: split at {at} (asked {lows0[1] // 2}; aligned to "
            f"one of shard 0's partition boundaries {bounds}) in "
            f"{t_split1 - t_split0:.3f} s; time under the gate {max(held) * 1e3:.3f} ms "
            f"(the split's holds {[round(h * 1e3, 3) for h in held]} ms); shipped "
            f"{rep['shipped']['bytes']} bytes in {rep['shipped']['files']} files, "
            f"{rep['shipped']['records']} WAL records; final catch-up {rep['final']}")
        log(f"[cluster] {card}: stage 3 batch latency: before the split {pct(pre)}; during "
            f"{pct(during)}; first {FLEET_FIRST} after {pct(first)}; after those {pct(steady)}")
        checked = _check_traffic_reads(traffic, orc)
        uk, mask, _ = _written(traffic)
        found, vals = cluster.get_batch(uk)
        check(found.all(), "a key the traffic put was lost")
        check(_acked(vals, mask).all(), "a key reads back a value no acknowledged put wrote")
        orc.put(uk, vals)
        orc.resolve(NOW)
        log(f"[cluster] stage 3: {checked} traffic reads and {len(uk)} written keys read back "
            "hold the acknowledged-value rule; the oracle takes the values read")
        box["at"] = at
        new = cluster.serve.shards[1]
        refs[f"shard {at} (split off)"] = weakref.ref(new)
        box["mem"].append(("after the split (4 shards; shard 0 trimmed)",
                           _fleet_memory("after the split", mem0, refs)))
        edge = _promote(cluster, new, orc, rng, at, lows0[1], "stage 3 new shard")
        log(f"[cluster] {card}: stage 3: the new shard after the traffic: promotion edge "
            f"(batch, us/key, cold gets, device batches, cold partitions left) {edge}; "
            f"{len(new.partitions)} partitions")
        t0 = time.perf_counter()
        cluster.flush()
        log(f"[cluster] stage 3: fleet flush after the traffic in {time.perf_counter() - t0:.3f} s")
        return _store_operands(new, orc, rng)

    driven = run_counted("cluster", "stage 3 (live split under traffic)", stage3, launches)

    # ---- stage 4: the kernels on the new shard's operands (not counted)
    _g_guard("cluster stage 4", {v.remix.g for v, _ in driven[1]})
    shapes, err = (view_kernels(driven[0], driven[1], card, tier="fleet's new shard",
                                tag="cluster") if DEV == "cuda" else ({}, {}))
    del driven

    # ---- stage 5: a replica of shard 0
    def stage5():
        at = box["at"]
        rep = cluster.add_replica(lows0[0])
        refs["replica of shard 0"] = weakref.ref(rep.db)
        keys = np.unique(rng.integers(0, at, FLEET_TAIL, dtype=np.uint64))
        vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
        cluster.put_batch(keys, vals)
        orc.put(keys, vals)
        orc.resolve(NOW)
        lag = rep.seq_lag()
        t0 = time.perf_counter()
        final = rep.catch_up_until(0)
        dt = time.perf_counter() - t0
        check(rep.seq_lag() == 0 and final["lag"] == 0, f"replica lag {rep.seq_lag()}")
        q = _store_probe(rng, orc, STORE_GET_LARGE)
        q = q[q < np.uint64(at)]
        f_r, v_r = rep.get_batch(q)
        f_p, v_p = cluster.get_batch(q)
        f_o, v_o = orc.get(q)
        check(np.array_equal(f_r, f_o) and np.array_equal(f_p, f_o)
              and np.array_equal(v_r[f_r], v_o[f_o]) and np.array_equal(v_p[f_p], v_o[f_o]),
              "the replica, the primary and the oracle disagree")
        log(f"[cluster] {card}: stage 5: replica of shard 0 shipped {rep.report['bytes']} "
            f"bytes; lag before the catch-up {lag}; catch_up_until(0) in {dt:.3f} s ({final}); "
            f"get_batch of {len(q)} keys equal on the replica, the primary and the oracle")
        box["mem"].append(("with the replica", _fleet_memory("with the replica", mem0, refs)))

    run_counted("cluster", "stage 5 (replica)", stage5, launches)

    # ---- stage 6: merge the split back
    def stage6():
        at = box["at"]
        t0 = time.perf_counter()
        rep = cluster.merge(at)
        dt = time.perf_counter() - t0
        check(cluster.lows == lows0, f"lows after the merge {cluster.lows}")
        retired = [n for n in os.listdir(root) if n.startswith("retired-")]
        log(f"[cluster] {card}: stage 6: merge at {at} in {dt:.3f} s: {rep}; retired "
            f"directories {retired}")
        box["mem"].append(("after the merge", _fleet_memory("after the merge", mem0, refs)))
        gc.collect()
        box["mem"].append(("after the merge and gc.collect()",
                           _fleet_memory("after the merge and gc.collect()", mem0, refs)))
        _read_pairs(cluster, orc, rng, "stage 6 (merged)", card, tag="cluster",
                    starts_fn=_fleet_starts(orc, lows0), repeats=1)

    run_counted("cluster", "stage 6 (merge)", stage6, launches)

    # ---- stage 7: close and reopen the fleet from its directory
    def stage7():
        nonlocal cluster
        cluster.close()
        box["mem"].append(("after close", _fleet_memory("after close", mem0, refs)))
        cluster = None
        gc.collect()
        box["mem"].append(("after close and gc.collect()",
                           _fleet_memory("after close and gc.collect()", mem0, refs)))
        t0 = time.perf_counter()
        c2 = Cluster(root, lows=None, config=cfg)
        log(f"[cluster] {card}: stage 7: Cluster(lows=None) reopened {c2.lows} in "
            f"{time.perf_counter() - t0:.3f} s; memtables {[len(db.mem) for db in c2.serve.shards]}")
        check(c2.lows == lows0, f"reopened lows {c2.lows}")
        spans = c2.spans()
        for db, (lo, hi) in zip(c2.serve.shards, spans):
            edge = _promote(c2, db, orc, rng, lo, min(hi, STORE_DOMAIN), f"stage 7 shard {lo}")
            log(f"[cluster] {card}: stage 7: shard {lo}: promotion edge (batch, us/key, cold "
                f"gets, device batches, cold partitions left) {edge}")
            check(edge and edge[0][2] > 0, f"stage 7 shard {lo}: the first batch was not cold")
        _read_pairs(c2, orc, rng, "stage 7 (reopened, promoted)", card, tag="cluster",
                    starts_fn=_fleet_starts(orc, lows0))
        c2.close()

    run_counted("cluster", "stage 7 (reopen)", stage7, launches)
    gc.collect()
    box["mem"].append(("after the phase", _fleet_memory("after the phase", mem0, refs)))
    log(f"[cluster] device memory over the phase (label, bytes since it began): {box['mem']}")
    return launches, shapes, err


# ---------------------------------------------------------------- phase 8
def _paper_claims(rows: list[str]) -> None:
    """The paper's claims, read off this run's rows: the merging
    iterator's time over REMIX's per R, and fig16's WA order."""
    val = {}  # row name (with its R= / D=) -> (us_per_call, derived)
    for line in rows:
        parts = line.split(",")
        k = 2 if "=" in parts[1] else 1
        val[",".join(parts[:k])] = (float(parts[k]), ",".join(parts[k + 1:]))
    for fig in ("fig11", "fig12"):
        for what, merge, remix in (
                ("seek", "a_seek_merging", "a_seek_remix_vector"),
                ("seek (full in-group search)", "a_seek_merging", "a_seek_remix_full"),
                ("Seek+Next50", "b_next50_merging", "b_next50_remix"),
                ("get with bloom", "c_get_sstable_bloom", "c_get_remix"),
                ("get without bloom", "c_get_sstable_nobloom", "c_get_remix")):
            ratios = [f"R={r}: {val[f'{fig}{merge},R={r}'][0] / val[f'{fig}{remix},R={r}'][0]:.2f}x"
                      for r in (1, 2, 4, 8, 16) if f"{fig}{remix},R={r}" in val]
            log(f"[paper] {fig} {what}: merging iterator / REMIX time per op, {', '.join(ratios)}")
    wa = {k.rsplit("_", 1)[1]: float(v[1].split("=")[1]) for k, v in val.items()
          if k.startswith("fig16_write_120B_")}
    log(f"[paper] fig16 write amplification: {wa}; tiered < RemixDB < leveled: "
        f"{wa.get('tiered', 0) < wa.get('remixdb', 0) < wa.get('leveled', 0)}")


def _demo_oracle(shards):
    """Every shard's stored keys, sorted, and the run each key's value comes
    from (a key in two runs of a shard: the later run)."""
    from repro_torch.core import keys as CK
    from repro_torch.device import u32_np

    keys, runs = [], []
    for _, runset in shards:
        kk = CK.unpack_u64(u32_np(runset.keys)).reshape(-1)
        lens = runset.lens.cpu().numpy()
        run = np.repeat(np.arange(runset.r), runset.nmax)
        live = (np.arange(runset.nmax)[None, :] < lens[:, None]).reshape(-1)
        keys.append(kk[live])
        runs.append(run[live])
    keys, run = np.concatenate(keys), np.concatenate(runs)
    order = np.lexsort((-run, keys))
    keys, run = keys[order], run[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], run[first]


def _sharded_dropped(q64, world) -> np.ndarray:
    """The queries of one rank's slice that ``make_sharded_get`` drops:
    past ``cap = max(1, 2 * nq // world)`` per owner shard, and the last
    one that fits where an owner overflowed."""
    nq = len(q64)
    cap = max(1, 2 * nq // world)
    owner = np.minimum((q64 >> np.uint64(32)) // np.uint64((1 << 32) // world),
                       np.uint64(world - 1))
    drop = np.zeros(nq, bool)
    for s in range(world):
        idx = np.flatnonzero(owner == s)
        if len(idx) > cap:
            drop[idx[cap - 1:]] = True
    return drop


def _sharded_rank(rank, world, init, out, cfg=None):
    """One rank of the sharded get: its shard of ``build_demo_state`` at
    ``cfg``'s widths (``RemixServiceConfig()``) and its slice of the
    query batch, half of it keys stored on any shard and half misses,
    through ``make_sharded_get`` over NCCL (gloo off the card); answers
    held to a numpy oracle of every shard's keys under the drop rule and,
    in a world of one, to ``core.query.get`` on the same shard."""
    import torch
    import torch.distributed as dist

    from repro_torch.bench.common import CSV, time_batched
    from repro_torch.configs.remixdb import RemixServiceConfig
    from repro_torch.core import keys as CK
    from repro_torch.core import query as Q
    from repro_torch.db.sharded import build_demo_state, make_sharded_get
    from repro_torch.device import as_words, u32_np

    dev = f"cuda:{rank}" if DEV == "cuda" else DEV
    if DEV == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        cfg = cfg or RemixServiceConfig()
        t0 = time.perf_counter()
        shards = build_demo_state(cfg, world, seed=PAPER_SEED, device=dev)
        remix, runset = shards[rank]
        build_s = time.perf_counter() - t0
        keys, run = _demo_oracle(shards)
        del shards
        nq = cfg.query_batch // world
        rng = np.random.default_rng(rank)
        hit = rng.choice(keys, nq // 2)
        q64 = np.concatenate([hit, hit + np.uint64(1)])  # demo keys end in 26 zero bits
        queries = as_words(CK.pack_u64(q64), dev)
        step, n = make_sharded_get(cfg)
        check(n == world, f"sharded get: {n} shards in a world of {world}")
        csv = CSV(profile=DEV == "cuda")
        t = time_batched(step, remix, runset, queries)
        csv.emit(f"sharded_get_world={world}_rank={rank}", t / nq * 1e6,
                 f"{nq} queries/rank, R={cfg.runs_per_partition} x "
                 f"{cfg.entries_per_run}, D={cfg.group_d}, build {build_s:.1f}s",
                 call=lambda: step(remix, runset, queries), wall_s=t)
        found, vals = step(remix, runset, queries)
        found, vals = found.cpu().numpy(), u32_np(vals)
        drop = _sharded_dropped(q64, world)
        want = np.zeros(nq, bool)
        want[: nq // 2] = True
        want &= ~drop
        check(np.array_equal(found, want), f"sharded get rank {rank}: "
              f"{int((found != want).sum())} of {nq} found wrong")
        at = np.searchsorted(keys, q64[want])
        lo = (q64[want] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        check(np.array_equal(vals[want, 0], lo) and
              np.array_equal(vals[want, -1], run[at].astype(np.uint32)),
              f"sharded get rank {rank}: values of stored keys wrong")
        if world == 1:
            f2, v2 = Q.get(remix, runset, queries)
            check(np.array_equal(f2.cpu().numpy(), found)
                  and np.array_equal(u32_np(v2), vals),
                  "sharded get: differs from core.query.get on the same shard")
        owner = (q64 >> np.uint64(32)) // np.uint64((1 << 32) // world)
        off = int((np.minimum(owner, world - 1) != rank).sum())
        log(f"[paper] sharded get rank {rank}/{world}: {nq} queries ({nq // 2} stored, "
            f"{nq // 2} missing; {off} owned by other ranks; {int(drop.sum())} over "
            "capacity, dropped) held to the oracle" +
            (" and to core.query.get" if world == 1 else ""))
        if out is not None:
            out.extend(csv.rows)
    finally:
        dist.destroy_process_group()


def _paper_observer(card, shapes, err):
    """The figure benchmarks' ``observe``: after each load, both kernels on
    the RemixDB's resident views at the batches the figure sends them, bit
    for bit against the plain versions (``hold_views``; timed as well
    after the loads in ``PAPER_TIMED``: ``view_kernels``), with those
    launches taken back off the counts (they are not the path's); where a baseline's scans go through its memtable overlay,
    a 64-start scan_batch timed beside one merging scan per start, the
    reference's algorithm."""
    from repro_torch.bench.common import sync
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import selector_decode as SD

    def observe(tag, stores, batches):
        before = _launch_counts()
        mgr, driven = _view_batches(stores["remixdb"], [
            (label, keys, 1 if n is None else n + max(8, n // 2))  # the store's window
            for label, keys, n in batches])
        if tag in PAPER_TIMED:
            got, e = view_kernels(mgr, driven, card, tier=f"{tag} RemixDB", tag="paper")
        else:
            got, e = {k: [] for k in shapes}, hold_views(mgr, driven, f"{tag} RemixDB", "paper")
        del mgr, driven
        AS.anchor_search.launches = before["anchor_search"]
        SD.selector_decode.launches = before["selector_decode"]
        for k in shapes:
            shapes[k] += got[k]
            err[k] = max(err[k], e[k])
        starts = [k for label, k, n in batches if label.startswith("scan50 64")]
        for name in ("leveled", "tiered"):
            s = stores[name]
            if not (starts and len(s.mem)):
                continue
            ts = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                s.scan_batch(starts[0], 50)
                sync()
                ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for x in starts[0].tolist():
                s.scan(x, 50)
            sync()
            a, b = float(np.median(ts)) * 1e3, (time.perf_counter() - t0) * 1e3
            log(f"[paper] {card}: {tag} {name}: a 64-start Seek+Next50 scan_batch over a "
                f"memtable of {len(s.mem)} entries: the port's batched overlay (median of 3) "
                f"{a:.3f} ms; one merging scan per start (the reference's algorithm, once) "
                f"{b:.3f} ms, {b / a:.2f}x")

    return observe


def phase_paper(card) -> tuple[dict, dict, dict]:
    """The paper's figures on the card through the port's benchmarks (see the
    module docstring, phase 8); returns the kernels' launches over the
    store-level figures (the REMIX-level figures call the plain engine),
    and their shapes and errors on the RemixDB's operands after each load."""
    import socket

    import torch

    from repro_torch.bench import (common, fig11_queries, fig13_groupsize, fig14_16_stores,
                                   fig17_ycsb, table1_storage)

    t_phase = time.perf_counter()
    csv = common.CSV(profile=True)
    launches = {k: 0 for k in _launch_counts()}
    shapes = {k: [] for k in launches}
    err = {k: 0 for k in launches}
    observe = _paper_observer(card, shapes, err) if DEV == "cuda" else None
    log(f"[paper] {card}: fig11-13 at {PAPER_N_PER_TABLE} keys per table, "
        f"fig14-17 at scale {PAPER_SCALE}; rows: name,us_per_call,derived")

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"[paper] {name} done in {time.perf_counter() - t0:.1f} s")
        return out

    for loc in ("weak", "strong"):
        timed(f"fig1{1 if loc == 'weak' else 2}", lambda: fig11_queries.run(
            csv, locality=loc, n_per_table=PAPER_N_PER_TABLE, device=DEV,
            check_answers=True))
    timed("fig13", lambda: fig13_groupsize.run(csv, n_per_table=PAPER_N_PER_TABLE,
                                               device=DEV))
    timed("table1", lambda: table1_storage.run(csv, device=DEV))
    timed("fig14_16", lambda: run_counted("paper", "fig14-16", lambda: fig14_16_stores.run(
        csv, scale=PAPER_SCALE, device=DEV, check_answers=True, observe=observe), launches))
    timed("fig17", lambda: run_counted("paper", "fig17", lambda: fig17_ycsb.run(
        csv, scale=PAPER_SCALE, device=DEV, check_answers=True, observe=observe), launches))
    world = torch.cuda.device_count() if DEV == "cuda" else 1
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        init = f"tcp://localhost:{sock.getsockname()[1]}"
    if world == 1:
        timed("sharded get", lambda: _sharded_rank(0, 1, init, csv.rows))
    else:
        import torch.multiprocessing as mp

        timed("sharded get", lambda: mp.spawn(_sharded_rank, args=(world, init, None),
                                              nprocs=world))
    _paper_claims(csv.rows)
    log(f"[paper] phase 8 ran {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"from the stores' reads {launches}")
    return launches, shapes, err


def smi() -> str:
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    sys.path.insert(0, str(SRC))
    rng = np.random.default_rng(args.seed)
    card = smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    try:
        phase_build()
        err = phase_kernels(rng)
        parts, domains, oracles = build_partitions(rng)
        mgr, views, starts, launches = phase_main(rng, parts, domains, oracles)
        timings = phase_timings(rng, views, domains, starts, err, card)
        phase_end_to_end(rng, mgr, views, domains, starts, card)
        with tempfile.TemporaryDirectory() as root:
            idx_launches, idx_mgr, driven = phase_index_tier(rng, root, card)
        launches = {k: n + idx_launches[k] for k, n in launches.items()}
        idx_shapes, idx_err = view_kernels(idx_mgr, driven, card)
        del idx_mgr, driven
        peak = torch.cuda.max_memory_allocated()  # phase 6 resets the peak
        with tempfile.TemporaryDirectory() as root:
            store_launches, store_shapes, store_err = phase_store(rng, root, card)
        with tempfile.TemporaryDirectory() as root:
            fleet_launches, fleet_shapes, fleet_err = phase_cluster(rng, root, card)
        paper_launches, paper_shapes, paper_err = phase_paper(card)
        launches = {k: n + store_launches[k] + fleet_launches[k] + paper_launches[k]
                    for k, n in launches.items()}
        for t in timings:
            t["shapes"] += (idx_shapes[t["name"]] + store_shapes[t["name"]]
                            + fleet_shapes[t["name"]] + paper_shapes[t["name"]])
            t["max_abs_err"] = max(t["max_abs_err"], idx_err[t["name"]], store_err[t["name"]],
                                   fleet_err[t["name"]], paper_err[t["name"]])
        log(f"[device] peak allocated {max(peak, torch.cuda.max_memory_allocated())} bytes")
        log(f"[device] launches over all phases {launches} (phase 7: {fleet_launches}, "
            f"phase 8: {paper_launches}); "
            f"script ran {time.perf_counter() - t_script:.1f} s")
    except (Fail, AssertionError) as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    # top-level times: each kernel's first shape; "shapes" holds them all
    kernels = [
        dict(name=t["name"], route="cuda", source=SOURCES[t["name"]],
             replaces=REPLACES[t["name"]], launches=launches[t["name"]],
             max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
             bound_ms=t["bound_ms"], bound_by=t["bound_by"],
             library_ms=t["library_ms"], launch_floor_ms=t["launch_floor_ms"],
             shapes=t["shapes"])
        for t in timings
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
