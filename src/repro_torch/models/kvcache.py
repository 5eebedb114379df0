"""REMIX-indexed KV-page table: the paper's index applied to LM serving.

Decoded/prefilled KV pages are registered in immutable *generations*: each
generation is one sorted run keyed by a 64-bit prefix hash, valued by a page
slot in the pool. Generations accumulate like L0 tables in an LSM; a REMIX
over them gives one-binary-search lookup of the longest cached prefix
(paper §3 applied to serving metadata). Stale entries are superseded by
newer runs via REMIX's versioning (newest-bit) — no rewrite of old
generations.

The table is built on the port's REMIX core (``core.runs.make_run``,
``core.remix.build_remix``, ``core.query.get``) on the table's device; the
page pool (float16, as in the reference) lives on the same device, and
pages are copied there without leaving it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import keys as CK
from repro_torch.core import query as Q
from repro_torch.core.remix import build_remix
from repro_torch.core.runs import make_run
from repro_torch.device import as_words, resolve, u32_np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_M64 = (1 << 64) - 1


def chain_hash(h: int, tokens: np.ndarray) -> int:
    """FNV-1a over token ids — the page key (stable across runs)."""
    h = int(h)
    for t in np.asarray(tokens).tolist():
        h = ((h ^ int(t)) * FNV_PRIME) & _M64
    return h


def prefix_hash(tokens: np.ndarray) -> int:
    return chain_hash(FNV_OFFSET, tokens)


class RemixPageTable:
    """LSM-of-generations page table with a REMIX global view."""

    def __init__(self, d: int = 32, max_runs: int = 8, device="cuda"):
        self.device = resolve(device)
        self.d = d
        self.max_runs = max_runs
        self.runs: list = []
        self.gen = 0
        self._pending_keys: list[int] = []
        self._pending_vals: list[tuple[int, int]] = []
        self._index = None
        self.lookups = 0

    def add(self, key: np.uint64, slot: int, length: int):
        self._pending_keys.append(int(key))
        self._pending_vals.append((slot, length))

    def flush_generation(self):
        """Seal pending entries into a new immutable run + rebuild REMIX."""
        if not self._pending_keys:
            return
        keys = np.array(self._pending_keys, np.uint64)
        vals = np.array(self._pending_vals, np.uint32)
        self.gen += 1
        self.runs.append(make_run(keys, vals, seq=self.gen, device=self.device))
        self._pending_keys, self._pending_vals = [], []
        if len(self.runs) > self.max_runs:  # tiered merge of generations
            from repro_torch.db.partition import Table, merge_tables

            tabs = [
                Table(
                    keys=CK.unpack_u64(u32_np(r.keys)),
                    vals=u32_np(r.vals),
                    seq=u32_np(r.seq),
                    tomb=r.tomb.cpu().numpy(),
                )
                for r in self.runs
            ]
            merged = merge_tables(tabs)
            self.runs = [
                make_run(merged.keys, merged.vals, seq=merged.seq, sort=False,
                         device=self.device)
            ]
        self._index = None

    def index(self):
        if self._index is None:
            if not self.runs:
                return None
            self._index = build_remix(self.runs, d=max(self.d, len(self.runs)))
        return self._index

    def lookup_batch(self, hashes: np.ndarray):
        """Batched point lookups → (found (Q,), slot (Q,), length (Q,))."""
        idx = self.index()
        self.lookups += len(hashes)
        if idx is None:
            z = np.zeros(len(hashes), np.int64)
            return np.zeros(len(hashes), bool), z, z
        remix, runset = idx
        qk = as_words(CK.pack_u64(np.asarray(hashes, np.uint64)), self.device)
        found, vals = Q.get(remix, runset, qk)
        vals = u32_np(vals)
        return (found.cpu().numpy(), vals[:, 0].astype(np.int64),
                vals[:, 1].astype(np.int64))


class PrefixCache:
    """Prefix KV reuse: longest cached prefix via REMIX chained-hash lookup.

    The pool holds full-layer KV pages of ``page_size`` tokens; ``match``
    probes hashes of growing prefixes (one *batched* REMIX lookup),
    ``register`` inserts new pages into the pending generation.
    """

    def __init__(self, cfg, n_pages: int, page_size: int = 16, d: int = 32,
                 device="cuda"):
        self.device = resolve(device)
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.pool_k = torch.zeros(
            (n_pages, cfg.n_layers, page_size, cfg.n_kv_heads, cfg.hd),
            dtype=torch.float16, device=self.device,
        )
        self.pool_v = torch.zeros_like(self.pool_k)
        self.next_slot = 0
        self.table = RemixPageTable(d=d, device=self.device)
        self.hits = 0
        self.misses = 0

    def _alloc(self) -> int:
        slot = self.next_slot % self.n_pages  # ring eviction
        self.next_slot += 1
        return slot

    def register(self, tokens: np.ndarray, k_cache: torch.Tensor, v_cache: torch.Tensor):
        """Register all complete pages of a finished sequence.

        k_cache/v_cache: (L, S, KVH, hd) single-sequence caches, on the
        pool's device.
        """
        ps = self.page_size
        h = FNV_OFFSET
        for pg in range(len(tokens) // ps):
            h = chain_hash(h, tokens[pg * ps : (pg + 1) * ps])
            slot = self._alloc()
            self.pool_k[slot] = k_cache[:, pg * ps : (pg + 1) * ps]
            self.pool_v[slot] = v_cache[:, pg * ps : (pg + 1) * ps]
            self.table.add(h, slot, (pg + 1) * ps)
        self.table.flush_generation()

    def match(self, tokens: np.ndarray):
        """Longest cached prefix → (n_tokens_cached, [slots...])."""
        ps = self.page_size
        n_pages = len(tokens) // ps
        if n_pages == 0:
            return 0, []
        hashes = []
        h = FNV_OFFSET
        for pg in range(n_pages):
            h = chain_hash(h, tokens[pg * ps : (pg + 1) * ps])
            hashes.append(h)
        found, slots, _ = self.table.lookup_batch(np.array(hashes, np.uint64))
        out = []
        for pg in range(n_pages):
            if not found[pg]:
                break
            out.append(int(slots[pg]))
        if out:
            self.hits += 1
        else:
            self.misses += 1
        return len(out) * ps, out

    def gather(self, slots: list[int]):
        """Assemble (L, n_tokens, KVH, hd) float16 caches from pooled pages."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)

        def pages(pool):
            x = pool[idx].transpose(0, 1)  # (L, n_pages, page, KVH, hd)
            return x.reshape(x.shape[0], -1, *x.shape[3:])

        return pages(self.pool_k), pages(self.pool_v)
