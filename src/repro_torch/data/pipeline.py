"""Deterministic synthetic data pipeline, shardable and skippable (the
reference's ``repro.data.pipeline``).

Batch ``i`` of shard ``s`` is a pure function of ``(seed, i, s)``: its
tokens are drawn from a CPU ``torch.Generator`` seeded with
:func:`batch_seed` (SplitMix64 over the three numbers), then moved to the
device, so the card's batch equals the CPU's and a restart or skip-ahead
replays nothing. The mix is the reference's: 80% of ids uniform over
``[0, max(2, vocab // 64))``, 20% uniform over the vocabulary; ``labels``
are the tokens shifted left by one with the last position 0. The
reference draws from JAX's threefry, which torch does not reproduce, so
the tokens themselves differ from the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def batch_seed(seed: int, step: int, shard: int) -> int:
    """The generator seed of one batch: SplitMix64 folded over seed, step
    and shard index (each taken mod 2^64)."""
    x = 0
    for v in (seed, step, shard):
        x = _splitmix64(x ^ (v & _M64))
    return x


@dataclasses.dataclass
class DataPipeline:
    vocab: int
    batch: int  # global batch
    seq: int
    seed: int = 0
    shard_index: int = 0  # this host's data shard
    shard_count: int = 1
    device: str = "cuda"

    def local_batch(self) -> int:
        assert self.batch % self.shard_count == 0
        return self.batch // self.shard_count

    def get_batch(self, step: int) -> dict:
        """Batch for ``step`` (host-local shard): dict(tokens, labels),
        int32, on ``device``."""
        device = resolve(self.device)
        b = self.local_batch()
        gen = torch.Generator().manual_seed(batch_seed(self.seed, step, self.shard_index))
        common = torch.randint(0, max(2, self.vocab // 64), (b, self.seq), generator=gen)
        rare = torch.randint(0, self.vocab, (b, self.seq), generator=gen)
        pick = torch.rand((b, self.seq), generator=gen) < 0.8
        tokens = torch.where(pick, common, rare).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = 0
        return dict(tokens=tokens.to(device), labels=labels.to(device))

    def state(self, step: int) -> dict:
        return dict(seed=self.seed, step=step, shard=self.shard_index)
