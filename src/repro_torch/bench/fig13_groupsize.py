"""Fig 13: REMIX range-query performance vs group size D (8 tables)."""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import CSV, make_tables, qkeys, time_batched
from repro_torch.core import query as Q
from repro_torch.core.remix import build_remix

QBATCH = 2048
N_PER_TABLE = 16384


def run(csv: CSV, n_per_table: int = N_PER_TABLE, device="cuda"):
    rng = np.random.default_rng(7)
    runs, keys = make_tables(8, n_per_table, locality="weak", device=device)
    for d in (16, 32, 64):
        remix, runset = build_remix(runs, d=d)
        qk = qkeys(rng, int(keys[-1]), QBATCH, device)
        for mode, label in (("binary", "full"), ("vector", "partial_vec")):
            seek = lambda q: Q.seek(remix, runset, q, ingroup=mode)  # noqa: E731
            t = time_batched(seek, qk)
            csv.emit(f"fig13_seek_{label},D={d}", t / QBATCH * 1e6, "",
                     call=lambda: seek(qk), wall_s=t)
        scan = lambda q: Q.scan(remix, runset, q, width=64)  # noqa: E731
        t = time_batched(scan, qk[:256])
        csv.emit(f"fig13_next50,D={d}", t / 256 * 1e6, "",
                 call=lambda: scan(qk[:256]), wall_s=t)
        csv.emit(
            f"fig13_index_bytes_per_key,D={d}",
            remix.storage_bytes() / max(1, int(remix.n_entries)),
            "bytes/key",
        )
