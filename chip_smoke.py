#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of REMIX (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. build — compile ``src/repro_torch/csrc/*.cu`` with nvcc (first use).
2. kernels — each CUDA kernel against its plain PyTorch version on the
   card, bit for bit, across sweeps of shapes and types (anchor counts G
   up to 2^20, queries at and past the +inf tail; selector tiles and group
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

The last lines are one JSON object listing the kernels, the card's name
and power limit from nvidia-smi, and ``{"ok": true, "device": ...}``.
The script exits non-zero, printing no result, where CUDA is absent or
the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# src/repro/configs/remixdb.py (RemixServiceConfig): R, entries per run,
# group size, key words, value words
R, ENTRIES, D, KW, VW = 8, 1 << 16, 32, 2, 4
N_PARTITIONS = 32
DOMAIN = 1 << 18  # distinct keys per partition: each key in ~2 of the 8 runs
GET_SMALL, GET_LARGE = 256, 1 << 16
SCAN_Q, SCAN_WIDTH = 256, 75  # Seek+Next50: n + max(8, n // 2)
# anchor-kernel sweep; 32768 is the main path's padded group count. Some G
# are not multiples of the sample stride, and the largest make it double.
ANCHOR_GS = (1, 5, 17, 513, 5000, 16384, 32768, 100_003, 262_144, 1 << 20)
NOW = 1_700_000_000  # query-time clock (uint32 seconds)
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
    # 1,000 queries take the warp-per-query search, `many` the sampled one
    many = AS.SAMPLE_MIN_QUERIES_PER_SM * sm_count(torch.empty(0, device=cuda)) + 5
    for g in ANCHOR_GS:
        for kw in (1, 2, 3):
            a_np = _sorted_anchors(rng, g, kw)
            a = as_words(a_np, cuda)
            for nq in (1000, many):
                q = as_words(_anchor_queries(rng, a_np, nq), cuda)
                for kern, plain in ((AS.anchor_le_count, AS.anchor_le_count_plain),
                                    (AS.anchor_search, AS.anchor_search_plain)):
                    got = kern(a, q).cpu().numpy().astype(np.int64)
                    want = plain(a, q).cpu().numpy().astype(np.int64)
                    e = int(np.abs(got - want).max())
                    err["anchor_search"] = max(err["anchor_search"], e)
                    check(e == 0, f"{kern.__name__} G={g} KW={kw} Q={nq}: max |err| {e}")
                    n += 1
    log(f"[kernels] anchor_search/anchor_le_count: {n} cases bit-identical "
        f"(G in {ANCHOR_GS}; KW 1-3; Q 1,000 and {many}; +inf tails; queries "
        "at and past them)")
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
def make_tables(rng, lo: int):
    """8 overlapping runs over one partition's key range: increasing seq,
    ~5% tombstones, TTLs on ~10% of rows (half already expired)."""
    from repro_torch.db.partition import Table

    domain = np.uint64(lo) + np.sort(
        rng.choice(1 << 36, DOMAIN, replace=False)
    ).astype(np.uint64)
    tables = []
    for i in range(R):
        keys = np.sort(rng.choice(domain, ENTRIES, replace=False))
        seq = (np.arange(ENTRIES) + i * ENTRIES + 1).astype(np.uint32)
        vals = rng.integers(0, 2**32, (ENTRIES, VW), dtype=np.uint64).astype(np.uint32)
        tomb = rng.random(ENTRIES) < 0.05
        exp = np.zeros(ENTRIES, np.uint32)
        ttl = rng.random(ENTRIES) < 0.10
        delta = rng.integers(1, 1000, ENTRIES)
        past = rng.random(ENTRIES) < 0.5
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


def phase_timings(rng, views, domains, starts, err, card) -> list[dict]:
    """Each kernel at each of its main-path shapes, with the operands the
    path hands it, beside a launch floor timed in the same harness."""
    import torch

    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import selector_decode as SD
    from repro_torch.kernels import ops

    dv = views[0]
    remix = dv.remix
    x = torch.zeros(1, device=DEV)
    floor = time_graph(lambda: x.add_(1))
    log(f"[timing] {card}: launch floor (one-element add_): {floor * 1e3:.3f} us")

    # anchor_search at the two get batches: (G, 2) anchors, 256 / 65,536 queries
    anchors = remix.anchors
    g = anchors.shape[0]
    a64 = _pack64(anchors)
    anchor = []
    for qn, reps in ((GET_SMALL, 50), (GET_LARGE, 20)):
        q = torch.from_numpy(_pack(probe(rng, domains[0], qn))).to(DEV)
        got = AS.anchor_search(anchors, q)
        check(torch.equal(got, AS.anchor_search_plain(anchors, q)),
              f"anchor_search differs from its plain version at Q={qn}")
        q64 = _pack64(q)
        check(torch.equal(torch.clamp(torch.searchsorted(a64, q64, right=True) - 1, min=0)
                          .to(torch.int32), got), "searchsorted yardstick disagrees")
        ms, lib = time_pair(lambda: AS.anchor_search(anchors, q),
                            lambda: torch.searchsorted(a64, q64, right=True), reps)
        plain = time_graph(lambda: AS.anchor_search_plain(anchors, q), reps=5)
        rows, probes = search_probes(a64, q64)
        b, by = bound_ms(rows * KW * 4 + qn * (KW * 4 + 4), probes * KW * 2)
        anchor.append(dict(shape=f"G={g} KW={KW} Q={qn}", ms=ms, plain_ms=plain,
                           bound_ms=b, bound_by=by, library_ms=lib))
        log(f"[timing] anchor_search at Q={qn}: a binary search reads {rows} of "
            f"{g} anchor rows ({probes} probes); sample plan "
            f"(stride, rows, bytes) = {AS._plan(g, KW)}")

    # selector_decode at the scan window (256 starts x 4 groups) and at the
    # 65,536-key get window (65,536 x 2 groups): group ids as ops hands them
    sel_table = remix.selectors.reshape(remix.g, D)
    cur = remix.cursors
    st = torch.from_numpy(_pack(starts[0])).to(DEV)
    gq = torch.from_numpy(_pack(probe(rng, domains[0], GET_LARGE))).to(DEV)
    windows = (("scan window", ops.seek(remix, dv.runset, st), SCAN_WIDTH, 50),
               (f"{GET_LARGE:,}-key get window", ops.seek(remix, dv.runset, gq), 1, 20))
    decode, e = [], 0
    for label, pos, width, reps in windows:
        rows, _ = ops.window_operands(remix, pos, width)
        got = SD.selector_decode(sel_table, cur, rows=rows)
        want = SD.selector_decode_plain(sel_table, cur, rows=rows)
        e = max(e, *(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want)))
        check(e == 0, f"selector_decode differs from its plain version at the {label}")
        ms = time_graph(lambda: SD.selector_decode(sel_table, cur, rows=rows), reps)
        plain = time_graph(lambda: SD.selector_decode_plain(sel_table, cur, rows=rows),
                           reps=5)
        n = rows.shape[0]
        # row ids, gathered selectors and cursors in; runid, absidx, newest, pad out.
        # Operations: 8 integer ops per slot (decode 3, count 2, cursor 1, flags 2).
        b, by = bound_ms(n * 4 + n * D + n * remix.r * 4 + n * D * 10, n * D * 8)
        decode.append(dict(shape=f"{label}: N={n} D={D} R={remix.r}", ms=ms,
                           plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None))

    out = []
    for name, shapes, e_k in (("anchor_search", anchor, 0), ("selector_decode", decode, e)):
        for k in shapes:
            log(f"[timing] {card}: {name} ({k['shape']}): kernel {k['ms'] * 1e3:.3f} us, "
                f"plain {k['plain_ms'] * 1e3:.3f} us, bound {k['bound_ms'] * 1e3:.4f} us "
                f"({k['bound_by']}), launch floor {floor * 1e3:.3f} us, library "
                + ("n/a" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.3f} us"))
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
        log(f"[device] peak allocated {torch.cuda.max_memory_allocated()} bytes")
    except Fail as e:
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
