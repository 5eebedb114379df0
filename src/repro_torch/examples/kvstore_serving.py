"""End-to-end RemixDB driver: load a store, run compactions, serve batched
point + range queries, report write amplification — the paper's system
(§4) end to end, with the WAL/recovery path exercised.

    python -m repro_torch.examples.kvstore_serving [--device cpu]

The port of ``examples/kvstore_serving.py``: the same keys, compactions
and queries, printed in the same lines, in a temporary directory.
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.db.compaction import CompactionConfig
from repro_torch.db.store import RemixDB, RemixDBConfig

N = 200_000


def serve(n: int, wal_dir: str, device) -> dict:
    """The example's run over a store in ``wal_dir``; returns what it
    printed as numbers (stats, compaction kinds, hit rate, recovery)."""
    rng = np.random.default_rng(0)
    db = RemixDB(
        RemixDBConfig(
            memtable_entries=16384,
            wal_dir=wal_dir,
            compaction=CompactionConfig(table_cap=16384, t_max=10),
            hot_threshold=8,
            device=device,
        )
    )
    try:
        print(f"loading {n} random keys ...")
        keys = rng.permutation(n).astype(np.uint64) * 7
        vals = np.stack([keys & 0xFFFFFFFF, keys >> 32], 1).astype(np.uint32)
        t0 = time.perf_counter()
        for c in range(0, n, 16384):
            db.put_batch(keys[c : c + 16384], vals[c : c + 16384])
        db.flush()
        dt = time.perf_counter() - t0
        st = db.stats()
        print(f"  loaded in {dt:.1f}s -> {st['partitions']} partitions, "
              f"{st['tables']} tables, WA={st['wa']:.2f}")
        kinds = {}
        for s in db.compaction_log:
            for k, v in s["kinds"].items():
                kinds[k] = kinds.get(k, 0) + v
        print(f"  compactions: {kinds}")

        # hot keys: update a few keys repeatedly; they stay in MemTable+WAL
        for _ in range(12):
            db.put(int(keys[0]), [1, 2])
        db.flush()
        hot = db.mem.get(int(keys[0])) is not None
        print(f"  hot key retained in MemTable: {hot}")

        print("serving batched point queries ...")
        probe = rng.choice(keys, 4096)
        t0 = time.perf_counter()
        found, got = db.get_batch(probe)
        print(f"  4096 gets in {(time.perf_counter()-t0)*1e3:.1f} ms, "
              f"hit rate {found.mean():.3f}")

        print("range scans ...")
        skeys = np.sort(keys)
        t0 = time.perf_counter()
        scans = []
        for s in skeys[:: n // 50][:32]:
            kk, vv = db.scan(int(s), 50)
            assert len(kk) >= 1
            scans.append(kk)
        print(f"  32 seek+next50 in {(time.perf_counter()-t0)*1e3:.1f} ms")

        print("WAL recovery check ...")
        db.put(999_999_999, [7, 7])
        db.wal.sync()
        mem = db.recover_memtable()
        present = mem.get(999_999_999) is not None
        print(f"  recovered {len(mem)} buffered entries; "
              f"999999999 present: {present}")
        return dict(stats=st, kinds=kinds, hot=hot, probe=probe, found=found,
                    vals=got, scans=scans, recovered=len(mem), present=present)
    finally:
        db.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="remixdb-demo-") as tmp:
        return serve(N, tmp, args.device)


if __name__ == "__main__":
    main()
