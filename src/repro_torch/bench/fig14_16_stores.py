"""Fig 14–16: store-level benchmarks.

fig14: range query (seek+scan) throughput for RemixDB vs leveled vs tiered
       with different value sizes and access patterns.
fig15: range-scan throughput vs scan length (zipfian).
fig16: random-write throughput + write amplification.

``scale`` multiplies the key count, the memtable and the table cap together
(the reference's sizes at 1), so every load flushes as often as the
reference's and each store queries as many runs. With ``check_answers=True`` the
three stores are held to a numpy oracle after each load: a 4,096-key
get_batch (half of the keys stored) and 64 Seek+Next50 scans.

``observe(tag, stores, batches)``, where given, is called after each load
(and its check) with the key batches the figure then sends the stores:
``(label, keys, n)``, ``n`` the scan length or None for a get_batch.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np

from repro_torch.bench.common import CSV, check, zipf_keys
from repro_torch.db.baseline import BaselineConfig, LeveledStore, TieredStore
from repro_torch.db.compaction import CompactionConfig
from repro_torch.db.store import RemixDB, RemixDBConfig

N_KEYS = 120_000
MEM = 8192
CAP = 8192


def _build_stores(tmpdir: str, vw: int, mem: int, cap: int, device):
    db = RemixDB(
        RemixDBConfig(
            vw=vw, memtable_entries=mem, wal_dir=tmpdir, device=device,
            compaction=CompactionConfig(table_cap=cap, t_max=10),
        )
    )
    bcfg = BaselineConfig(vw=vw, memtable_entries=mem, table_cap=cap,
                          device=device)
    return {"remixdb": db, "leveled": LeveledStore(bcfg), "tiered": TieredStore(bcfg)}


def _load(stores, keys, vw, mem, csv=None, label=""):
    vals = np.zeros((len(keys), vw), np.uint32)
    vals[:, 0] = (keys & 0xFFFFFFFF).astype(np.uint32)
    for name, s in stores.items():
        t0 = time.perf_counter()
        for c in range(0, len(keys), mem):
            s.put_batch(keys[c : c + mem], vals[c : c + mem])
        s.flush()
        dt = time.perf_counter() - t0
        if csv is not None:
            csv.emit(f"fig16_write_{label}_{name}", dt / len(keys) * 1e6,
                     f"WA={s.write_amplification():.2f}" if name != "remixdb"
                     else f"WA={s.table_bytes_written / max(1, s.user_bytes):.2f}")
    return stores


def _seek_throughput(stores, probes, scan_n, csv, tag):
    probes = np.asarray(probes, np.uint64)
    for name, s in stores.items():
        s.scan_batch(probes, scan_n)  # warmup at measurement shape
        t0 = time.perf_counter()
        s.scan_batch(probes, scan_n)
        dt = time.perf_counter() - t0
        csv.emit(f"{tag}_{name}", dt / len(probes) * 1e6, f"scan{scan_n}",
                 call=lambda: s.scan_batch(probes, scan_n), wall_s=dt)


def check_draws(skeys, rng, n_get: int = 4096, n_scan: int = 64):
    """A check's probes over ``skeys`` (sorted stored keys, multiples of 8,
    so ``key + 1`` is never stored): ``n_get`` get keys, half of them
    stored, and ``n_scan`` scan starts, half of them on a stored key."""
    probe = np.concatenate([rng.choice(skeys, n_get // 2),
                            rng.choice(skeys, n_get - n_get // 2) + np.uint64(1)])
    starts = rng.choice(skeys, n_scan) + rng.integers(0, 2, n_scan).astype(np.uint64)
    return probe, starts


def check_gets(s, name, skeys, probe, val0, tag: str) -> None:
    """``s.get_batch(probe)`` against the oracle: ``val0(keys)`` is each
    stored key's first value word (the other words are 0)."""
    want = np.isin(probe, skeys)
    f, v = s.get_batch(probe)
    check(np.array_equal(f, want), f"{tag} {name}: get_batch found "
          f"{int((f != want).sum())} keys wrong")
    check(np.array_equal(v[f, 0], val0(probe[f])) and not v[f, 1:].any(),
          f"{tag} {name}: get_batch values wrong")


def check_scans(s, name, skeys, starts, tag: str, scan_n: int = 50) -> None:
    """``s.scan_batch(starts, scan_n)`` against the oracle: each start's
    first ``scan_n`` stored keys."""
    at = np.searchsorted(skeys, starts, side="left")
    k, m = s.scan_batch(starts, scan_n)
    for i in range(len(starts)):
        check(np.array_equal(k[i][m[i]], skeys[at[i]: at[i] + scan_n]),
              f"{tag} {name}: scan from {int(starts[i])} is not the oracle's")


def check_stores(stores, skeys, val0, rng, tag: str):
    """Every store's gets and scans against the oracle (:func:`check_draws`,
    :func:`check_gets`, :func:`check_scans`); returns the probes."""
    probe, starts = check_draws(skeys, rng)
    for name, s in stores.items():
        check_gets(s, name, skeys, probe, val0, tag)
        check_scans(s, name, skeys, starts, tag)
    return probe, starts


def _checked(checked) -> list:
    """A check's probes as ``observe`` batches (none without a check)."""
    if checked is None:
        return []
    probe, starts = checked
    return [("get (check)", probe, None), ("scan50 (check)", starts, 50)]


def describe(stores) -> str:
    db = stores["remixdb"]
    return (f"leveled runs {stores['leveled'].n_runs()}, tiered runs "
            f"{stores['tiered'].n_runs()}, remixdb partitions {len(db.partitions)}")


def run(csv: CSV, scale: float = 1, device="cuda", check_answers=False, observe=None):
    n_keys, mem, cap = (int(x * scale) for x in (N_KEYS, MEM, CAP))
    rng = np.random.default_rng(11)
    crng = np.random.default_rng(12)  # the checks' draws: rng's stay the reference's
    low = lambda k: (k & 0xFFFFFFFF).astype(np.uint32)  # noqa: E731
    # ---- fig14: value sizes × access patterns (seek-only ≈ scan 1) ----
    for vw, vname in ((2, "40B"), (8, "120B"), (25, "400B")):
        keys = rng.permutation(n_keys).astype(np.uint64) * 8
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            stores = _build_stores(tmp, vw, mem, cap, device)
            _load(stores, keys, vw, mem)
            skeys = np.sort(keys)
            print(f"# fig14 {vname}: {describe(stores)}; loaded in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            checked = (check_stores(stores, skeys, low, crng, f"fig14 {vname}")
                       if check_answers else None)
            probes_seq = skeys[1000:1512]
            probes_uni = rng.choice(skeys, 512)
            probes_zipf = skeys[zipf_keys(rng, len(skeys), 512)]
            if observe is not None:
                sent = [("seek seq", probes_seq, 1), ("seek zipf", probes_zipf, 1),
                        ("seek uni", probes_uni, 1)]
                if vw == 8:
                    sent += [(f"scan{n}", probes_zipf[:256], n) for n in (10, 50, 200)]
                observe(f"fig14 {vname}", stores, _checked(checked) + sent)
            _seek_throughput(stores, probes_seq, 1, csv, f"fig14_seek_{vname}_seq")
            _seek_throughput(stores, probes_zipf, 1, csv, f"fig14_seek_{vname}_zipf")
            _seek_throughput(stores, probes_uni, 1, csv, f"fig14_seek_{vname}_uni")
            if vw == 8:
                # ---- fig15: scan lengths on the 120B store ----
                for scan_n in (10, 50, 200):
                    _seek_throughput(
                        stores, probes_zipf[:256], scan_n, csv, f"fig15_scan{scan_n}"
                    )
            stores["remixdb"].close()
        print(f"# fig14 {vname}: done in {time.perf_counter() - t0:.1f} s", flush=True)
    # ---- fig16: random write + WA (fresh stores, dedicated run) ----
    keys = rng.permutation(n_keys).astype(np.uint64) * 8
    with tempfile.TemporaryDirectory() as tmp:
        stores = _build_stores(tmp, 8, mem, cap, device)
        _load(stores, keys, 8, mem, csv=csv, label="120B")
        print(f"# fig16 120B: {describe(stores)}", flush=True)
        if check_answers:
            checked = check_stores(stores, np.sort(keys), low, crng, "fig16 120B")
            if observe is not None:
                observe("fig16 120B", stores, _checked(checked))
        db = stores["remixdb"]
        csv.emit(
            "fig16_remixdb_wa_tables_plus_wal",
            db.write_amplification(),
            f"partitions={len(db.partitions)}",
        )
        db.close()
