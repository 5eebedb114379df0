"""The paper's own system config: a sharded RemixDB service.

Partitions are sharded over the ranks of a process group; query batches
are routed with ``all_to_all_single`` (:mod:`repro_torch.db.sharded`).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RemixServiceConfig:
    name: str = "remixdb"
    runs_per_partition: int = 8  # R (paper §5.1 uses 1..16)
    entries_per_run: int = 1 << 16  # keys per run per partition shard
    group_d: int = 32  # REMIX group size D
    kw: int = 2  # key words (64-bit keys)
    vw: int = 4  # value words
    query_batch: int = 1 << 19  # global point-query batch per step
    scan_width: int = 64  # seek+next50 rounded up to lane multiple


CONFIG = RemixServiceConfig()
