"""Baseline SSTable metadata: sparse block index + bloom filter (§2, §5.1).

Models LevelDB/RocksDB's per-table format: one index entry per 4 KB data
block and a 10-bits/key bloom filter. Used by the baseline stores and by the
Table-1 storage-cost benchmark.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import keys as CK
from repro_torch.core.bloom import BloomSet, build_bloom


@dataclasses.dataclass
class SSTableMeta:
    block_first_key: np.ndarray  # (B,) uint64 first key per 4 KB block
    bloom: BloomSet | None
    n: int

    @staticmethod
    def build(
        keys: np.ndarray,
        kv_bytes: int,
        block_bytes: int = 4096,
        bloom_bits: int = 10,
        with_bloom: bool = True,
        device="cuda",
    ) -> "SSTableMeta":
        per_block = max(1, block_bytes // max(1, kv_bytes))
        firsts = keys[::per_block]
        bloom = (
            build_bloom([CK.pack_u64(keys)], bits_per_key=bloom_bits,
                        device=device)
            if with_bloom and len(keys)
            else None
        )
        return SSTableMeta(block_first_key=firsts, bloom=bloom, n=len(keys))

    def index_bytes(self, key_bytes: int = 8, handle_bytes: int = 4) -> int:
        return len(self.block_first_key) * (key_bytes + handle_bytes)

    def bloom_bytes(self, bits_per_key: int = 10) -> int:
        return (self.n * bits_per_key + 7) // 8
