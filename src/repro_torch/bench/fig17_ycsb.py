"""Fig 17: YCSB A–F on RemixDB vs the leveled/tiered baselines.

Store-level µs/op includes host dispatch overhead (RemixDB pays one batched
call per touched partition and full WAL durability; the baselines keep a
single runset and no WAL), so absolute ratios are not comparable to the
paper's SSD numbers — the compute-level validation of the paper's claims
is fig11/fig12.

Workloads per Table 2: A=50R/50U, B=95R/5U, C=100R, D=95R/5I(latest),
E=95Scan/5I, F=50R/50RMW; zipfian request distribution (D: latest).

``scale`` multiplies the key count and the memtable (the reference's sizes
at 1); the op count stays. With ``check_answers=True`` the stores are held to a
numpy oracle after the load, and again after the last workload: every
store's gets and RemixDB's scans; the baselines' scans are held to their
own ``scan`` per start (:func:`check_scan_batch`), since their merging
window can come back short of the oracle's once keys carry several
versions (the reference's semantics). In a ``CSV(profile=True)`` each row
carries one profiled batch of its workload's main operation (a 256-key
get_batch, or for E a 64-start scan_batch). ``observe(tag, stores,
batches)``, where given, is called after the load and after the last
workload with batches the workloads send (``(label, keys, n)``, ``n`` the
scan length or None for a get_batch).
"""
from __future__ import annotations

import tempfile
import time

import numpy as np

from repro_torch.bench.common import CSV, check, zipf_keys
from repro_torch.bench.fig14_16_stores import (check_draws, check_gets, check_scans,
                                               check_stores, describe)
from repro_torch.db.baseline import BaselineConfig, LeveledStore, TieredStore
from repro_torch.db.compaction import CompactionConfig
from repro_torch.db.store import RemixDB, RemixDBConfig

N_KEYS = 60_000
OPS = 3_000
MEM = 8192
VW = 8

WORKLOADS = dict(
    A=dict(read=0.5, update=0.5),
    B=dict(read=0.95, update=0.05),
    C=dict(read=1.0),
    D=dict(read=0.95, insert=0.05, dist="latest"),
    E=dict(scan=0.95, insert=0.05),
    F=dict(read=0.5, rmw=0.5),
)


def build(tmpdir, mem: int = MEM, device="cuda"):
    db = RemixDB(
        RemixDBConfig(
            vw=VW, memtable_entries=mem, wal_dir=tmpdir, device=device,
            compaction=CompactionConfig(table_cap=mem, t_max=10),
        )
    )
    bcfg = BaselineConfig(vw=VW, memtable_entries=mem, table_cap=mem,
                          device=device)
    return {"remixdb": db, "leveled": LeveledStore(bcfg), "tiered": TieredStore(bcfg)}


def check_scan_batch(s, name, starts, tag: str, n: int = 50) -> None:
    """``s.scan_batch(starts, n)`` equals ``s.scan(start, n)`` per start."""
    k, m = s.scan_batch(starts, n)
    for i, start in enumerate(starts.tolist()):
        check(np.array_equal(k[i][m[i]], s.scan(start, n)[0]),
              f"{tag} {name}: scan_batch from {start} is not its scan()")


def _sent(skeys, rng) -> list:
    """A 256-key get_batch and a 64-start scan_batch as the workloads send
    them (zipfian over ``skeys``), as ``observe`` batches."""
    tgt = skeys[zipf_keys(rng, len(skeys), 256) % len(skeys)]
    return [("get 256 (zipf)", tgt, None), ("scan50 64 (zipf)", tgt[:64], 50)]


def run(csv: CSV, scale: float = 1, device="cuda", check_answers=False, observe=None):
    n_keys, mem = int(N_KEYS * scale), int(MEM * scale)
    rng = np.random.default_rng(17)
    crng = np.random.default_rng(18)  # the checks' draws
    keys = (rng.permutation(n_keys).astype(np.uint64) + 1) * 16
    vals = np.zeros((n_keys, VW), np.uint32)
    zero = lambda k: np.zeros(len(k), np.uint32)  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        stores = build(tmp, mem, device)
        for name, s in stores.items():
            for c in range(0, n_keys, mem):
                s.put_batch(keys[c : c + mem], vals[c : c + mem])
            s.flush()
        skeys = np.sort(keys)
        print(f"# fig17 loaded: {describe(stores)}", flush=True)
        if check_answers:
            probe, starts = check_stores(stores, skeys, zero, crng, "fig17 load")
            if observe is not None:
                observe("fig17 load", stores, [("get (check)", probe, None),
                                               ("scan50 (check)", starts, 50)]
                        + _sent(skeys, crng))
        next_key = keys.max() + 16
        most_inserted = 0

        for wl, mix in WORKLOADS.items():
            zipf = zipf_keys(rng, n_keys, OPS)
            ops = rng.random(OPS)
            for name, s in stores.items():
                inserted = 0
                t0 = time.perf_counter()
                reads = []
                scans = []
                i = 0
                while i < OPS:
                    u = ops[i]
                    if mix.get("dist") == "latest":
                        target = skeys[max(0, n_keys - 1 - zipf[i])]
                    else:
                        target = skeys[zipf[i] % n_keys]
                    racc = mix.get("read", 0)
                    sacc = racc + mix.get("scan", 0)
                    uacc = sacc + mix.get("update", 0)
                    iacc = uacc + mix.get("insert", 0)
                    if u < racc:
                        reads.append(target)
                        if len(reads) == 256 or i == OPS - 1:  # batched reads
                            s.get_batch(np.array(reads, np.uint64))
                            reads = []
                    elif u < sacc:
                        scans.append(target)
                        if len(scans) == 64 or i == OPS - 1:  # batched scans
                            s.scan_batch(np.array(scans, np.uint64), 50)
                            scans = []
                    elif u < uacc:
                        s.put(int(target), np.zeros(VW, np.uint32))
                    elif u < iacc:
                        s.put(int(next_key + inserted * 16), np.zeros(VW, np.uint32))
                        inserted += 1
                    else:  # rmw
                        reads.append(target)
                        if len(reads) == 256:
                            s.get_batch(np.array(reads, np.uint64))
                            reads = []
                        s.put(int(target), np.zeros(VW, np.uint32))
                    i += 1
                if reads:
                    s.get_batch(np.array(reads, np.uint64))
                if scans:
                    s.scan_batch(np.array(scans, np.uint64), 50)
                dt = time.perf_counter() - t0
                most_inserted = max(most_inserted, inserted)
                tgt = skeys[zipf[:256] % n_keys]
                csv.emit(f"fig17_ycsb_{wl}_{name}", dt / OPS * 1e6, f"{OPS/dt:.0f} ops/s",
                         call=((lambda: s.scan_batch(tgt[:64], 50)) if "scan" in mix
                               else (lambda: s.get_batch(tgt))))
        if check_answers:
            added = next_key + np.arange(most_inserted, dtype=np.uint64) * np.uint64(16)
            live = np.union1d(skeys, added)
            probe, starts = check_draws(live, crng)
            for name, s in stores.items():
                check_gets(s, name, live, probe, zero, "fig17 end")
                if name == "remixdb":
                    check_scans(s, name, live, starts, "fig17 end")
                else:
                    check_scan_batch(s, name, starts, "fig17 end")
            if observe is not None:
                observe("fig17 end", stores, [("get (check)", probe, None),
                                              ("scan50 (check)", starts, 50)]
                        + _sent(skeys, crng))
        stores["remixdb"].close()
