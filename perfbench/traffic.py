"""The one traffic generator: YCSB core-workload requests from a mix file.

A mix file (``perfbench/traffic/<mix>.json``) holds only parameters:

- ``clients``: closed-loop client threads (YCSB ``threadcount``);
- ``batch_ops``: operations a client sends as one request;
- ``proportions``: shares of ``read``, ``update``, ``insert``, ``scan`` and
  ``rmw`` (read-modify-write), summing to 1;
- ``request_distribution``: ``zipfian`` (scrambled, YCSB's default),
  ``uniform`` or ``latest`` (YCSB-D: the newest keys are the hottest);
- ``zipf_theta`` (YCSB: 0.99), ``scan_length`` (Seek+NextN);
- ``warmup_requests``: requests each client sends in set-up at least.

Keys are 64-bit integers whose three low bits say who made them: 0 for the
loaded keys, ``1 + client`` for a client's inserts, so no two writers ever
make the same fresh key. Everything is drawn from ``--seed``: the same seed
gives the same load, the same request stream per client, and the same
values.

The zipfian sampler is the inverse CDF on a harmonic grid over ranks, as in
``repro_torch.bench.common.zipf_keys``; ranks map to keys through a seeded
permutation (YCSB's scrambled zipfian), so the hot keys are spread over the
key space rather than adjacent.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

KINDS = ("read", "update", "insert", "scan", "rmw")
READ, UPDATE, INSERT, SCAN, RMW = range(5)
DISTRIBUTIONS = ("zipfian", "uniform", "latest")
TAG_BITS = 3  # low key bits that name the writer
MAX_CLIENTS = (1 << TAG_BITS) - 1


def seed_seq(seed: int, *words: int) -> np.random.SeedSequence:
    """A seed sequence for one stream of one run; any whole ``seed``."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *words])


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    batch_ops: int
    proportions: dict
    request_distribution: str = "zipfian"
    zipf_theta: float = 0.99
    scan_length: int = 50
    warmup_requests: int = 8

    def __post_init__(self):
        if not 1 <= self.clients <= MAX_CLIENTS:
            raise ValueError(f"clients must be 1..{MAX_CLIENTS}")
        if self.batch_ops < 1 or self.scan_length < 1:
            raise ValueError("batch_ops and scan_length must be >= 1")
        bad = set(self.proportions) - set(KINDS)
        if bad:
            raise ValueError(f"unknown operation kinds {sorted(bad)}")
        if abs(sum(self.proportions.values()) - 1.0) > 1e-9:
            raise ValueError("proportions must sum to 1")
        if self.request_distribution not in DISTRIBUTIONS:
            raise ValueError(f"request_distribution must be one of {DISTRIBUTIONS}")

    @classmethod
    def from_file(cls, path) -> "Mix":
        d = json.loads(Path(path).read_text())
        d.setdefault("name", Path(path).stem)
        return cls(**d)

    def cumulative(self) -> np.ndarray:
        return np.cumsum([self.proportions.get(k, 0.0) for k in KINDS])


def load_set(seed: int, n: int, vw: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` distinct uniform 64-bit keys in random (load) order, low bits 0,
    and their ``(n, vw)`` uint32 value rows."""
    rng = np.random.default_rng(seed_seq(seed, 0))
    keys = np.zeros(0, np.uint64)
    while len(keys) < n:
        draw = rng.integers(1, 1 << (64 - TAG_BITS), n + n // 64 + 16,
                            dtype=np.uint64) << np.uint64(TAG_BITS)
        keys = np.unique(np.concatenate([keys, draw]))
    keys = rng.permutation(keys[:n])
    vals = rng.integers(0, 1 << 32, (n, vw), dtype=np.uint32)
    return keys, vals


def zipf_cdf(n: int, theta: float) -> np.ndarray:
    """CDF over ranks 1..n of the zipfian with exponent ``theta``."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return cdf


@dataclasses.dataclass
class Request:
    """One request: ``kinds`` (n,) codes, ``keys`` (n,) the key each op
    reads, writes or starts its scan at, ``vals`` (n, vw) the rows written
    (zero for reads), ``scan_n`` the scan length."""

    client: int
    index: int
    kinds: np.ndarray
    keys: np.ndarray
    vals: np.ndarray
    scan_n: int

    def __len__(self) -> int:
        return len(self.kinds)


class Traffic:
    """The request streams of one run: one per client, all from ``seed``."""

    def __init__(self, mix: Mix, seed: int, loaded_keys: np.ndarray, vw: int):
        self.mix = mix
        self.seed = int(seed)
        self.vw = vw
        self.loaded = loaded_keys  # in load order
        n = len(loaded_keys)
        rng = np.random.default_rng(seed_seq(seed, 1))
        # rank -> key: a seeded permutation (YCSB's scrambled zipfian)
        self.by_rank = loaded_keys[rng.permutation(n)]
        self.cdf = zipf_cdf(n, mix.zipf_theta) if mix.request_distribution != "uniform" else None

    def client(self, c: int, stream: int = 2) -> "ClientStream":
        """Client ``c``'s requests; ``stream`` separates the warm-up's
        requests (another stream) from the window's."""
        return ClientStream(self, c, stream)


class ClientStream:
    def __init__(self, t: Traffic, c: int, stream: int):
        self.t = t
        self.c = c
        self.rng = np.random.default_rng(seed_seq(t.seed, stream, c))
        self.tag = np.uint64(1 + c)
        self.inserted: list[np.ndarray] = []  # this client's fresh keys, in order
        self.seen: set[int] = set()
        self.index = stream << 32  # request ids unique over a client's streams

    def _fresh(self, k: int) -> np.ndarray:
        out = np.zeros(k, np.uint64)
        got = 0
        while got < k:
            draw = (self.rng.integers(1, 1 << (64 - TAG_BITS), k - got, dtype=np.uint64)
                    << np.uint64(TAG_BITS)) | self.tag
            for x in draw.tolist():
                if x not in self.seen:
                    self.seen.add(x)
                    out[got] = x
                    got += 1
        return out

    def _targets(self, k: int) -> np.ndarray:
        """``k`` existing keys by the request distribution."""
        t = self.t
        n = len(t.loaded)
        mix = t.mix
        if mix.request_distribution == "uniform":
            return t.by_rank[self.rng.integers(0, n, k)]
        rank = np.searchsorted(t.cdf, self.rng.random(k))
        if mix.request_distribution == "zipfian":
            return t.by_rank[np.minimum(rank, n - 1)]
        # latest: rank 0 is this client's newest insert, then older ones,
        # then the loaded keys from the last loaded backwards
        own = np.concatenate(self.inserted) if self.inserted else np.zeros(0, np.uint64)
        seq_len = n + len(own)
        rank = np.minimum(rank, seq_len - 1)
        out = np.empty(k, np.uint64)
        mine = rank < len(own)
        out[mine] = own[len(own) - 1 - rank[mine]]
        out[~mine] = t.loaded[n - 1 - (rank[~mine] - len(own))]
        return out

    def next(self) -> Request:
        mix = self.t.mix
        b = mix.batch_ops
        kinds = np.searchsorted(mix.cumulative(), self.rng.random(b), side="right")
        kinds = np.minimum(kinds, len(KINDS) - 1).astype(np.uint8)
        keys = self._targets(b)
        ins = kinds == INSERT
        if ins.any():
            fresh = self._fresh(int(ins.sum()))
            keys[ins] = fresh
            self.inserted.append(fresh)
        vals = np.zeros((b, self.t.vw), np.uint32)
        wr = (kinds == INSERT) | (kinds == UPDATE) | (kinds == RMW)
        if wr.any():
            vals[wr] = self.rng.integers(0, 1 << 32, (int(wr.sum()), self.t.vw),
                                         dtype=np.uint32)
        req = Request(self.c, self.index, kinds, keys, vals, mix.scan_length)
        self.index += 1
        return req
