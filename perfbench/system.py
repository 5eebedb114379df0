"""The system under test, built from a configuration file: the port's
``RemixDB``, or its ``KVServeEngine`` over range shards.

A configuration's ``system`` block is handed to the program as written:
``remixdb`` fields go to ``RemixDBConfig`` (``table_cap`` to its
``CompactionConfig``), ``shards`` > 1 builds a ``KVServeEngine`` whose
shards split the loaded keys at equal counts and share one block cache of
``cache_bytes``. Every request goes through the program's one entry point,
``submit(Batch)``; the benchmark reads back what it wrote through the same.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from perfbench.traffic import READ, RMW, SCAN

LOAD_CHUNK = 1 << 16  # keys per put_batch while loading
READBACK_CHUNK = 1 << 16  # keys per MultiGet while reading back


class ProgramSystem:
    def __init__(self, cfg: dict, data_dir: str, device: str = "cuda"):
        from repro_torch.db.compaction import CompactionConfig
        from repro_torch.db.ops import Batch, Op
        from repro_torch.db.store import RemixDB, RemixDBConfig

        self._Batch, self._Op = Batch, Op
        s = dict(cfg["system"])
        shards = int(s.pop("shards", 1))
        table_cap = s.pop("table_cap", None)
        fields = {f.name for f in dataclasses.fields(RemixDBConfig)}
        bad = set(s) - fields
        if bad:
            raise ValueError(f"unknown RemixDBConfig fields {sorted(bad)}")
        if table_cap is not None:
            s["compaction"] = CompactionConfig(table_cap=int(table_cap))
        s["device"] = device
        self.vw = int(s["vw"])
        self.shards = shards
        self.data_dir = data_dir
        self.rcfg = RemixDBConfig(**s)
        self.engine = None
        self.stores = []
        if shards == 1:
            self.stores = [RemixDB(dataclasses.replace(
                self.rcfg, data_dir=os.path.join(data_dir, "db")))]
            self.target = self.stores[0]

    # ---- set-up ----
    def load(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Put every key in load order through ``put_batch``, then flush.
        A sharded system splits the keys at equal counts first."""
        if self.shards > 1:
            from repro_torch.serve.engine import KVServeEngine

            srt = np.sort(keys)
            lows = [0] + [int(srt[len(srt) * i // self.shards]) for i in range(1, self.shards)]
            dirs = [os.path.join(self.data_dir, f"shard{i}") for i in range(self.shards)]
            cfg = dataclasses.replace(self.rcfg, block_cache=None)
            self.engine = KVServeEngine(
                list(zip(lows, dirs)), cache_bytes=self.rcfg.cache_bytes, config=cfg,
                max_inflight_bytes=self.rcfg.max_inflight_bytes,
                submit_workers=self.rcfg.submit_workers, metrics=self.rcfg.metrics)
            self.stores = list(self.engine.shards)
            self.target = self.engine
        for c in range(0, len(keys), LOAD_CHUNK):
            self.target.put_batch(keys[c:c + LOAD_CHUNK], vals[c:c + LOAD_CHUNK])
        self.target.flush()

    def resident(self, mix) -> bool:
        """Whether every partition holds what the mix's reads use on the
        device: a view for point reads, an index for cursor scans."""
        p = mix.proportions
        for db in self.stores:
            parts = db.partitions
            if (p.get("read", 0) or p.get("rmw", 0)) and db.device_views is not None \
                    and len(db.device_views) < len(parts):
                return False
            if p.get("scan", 0) and any(getattr(q, "_remix", 1) is None for q in parts):
                return False
        return True

    def counters(self) -> dict:
        """The program's own counters that per-layer metrics read."""
        from repro_torch.kernels import device_view

        return dict(view_syncs=device_view.SYNCS)

    # ---- the timed path ----
    def submit(self, req, trace: bool = False):
        Op = self._Op
        ops = []
        n = req.scan_n
        for kind, key, val in zip(req.kinds.tolist(), req.keys.tolist(), req.vals):
            if kind == READ:
                ops.append(Op.get(key))
            elif kind == SCAN:
                ops.append(Op.scan(key, n))
            elif kind == RMW:
                ops.append(Op.get(key))
                ops.append(Op.put(key, val))
            else:
                ops.append(Op.put(key, val))
        return self.target.submit(self._Batch(ops, trace=trace))

    def normalize(self, req, res) -> dict:
        """The program's ``BatchResult`` as the harness reads answers: per
        request op ``ok``, ``found`` / ``vals`` of reads, ``scans``. A result
        list that does not hold one result per op sent raises: the answer
        cannot be read, and the client records it as never answered."""
        n = len(req)
        sent = n + int((req.kinds == RMW).sum())
        if len(res.results) != sent:
            raise ValueError(f"{len(res.results)} results for {sent} ops")
        out = dict(ok=np.zeros(n, bool), found=np.zeros(n, bool),
                   vals=np.zeros((n, self.vw), np.uint32), scans={})
        j = 0
        for i, kind in enumerate(req.kinds.tolist()):
            r = res.results[j]
            ok = r is not None and r.ok
            if kind in (READ, RMW) and ok:
                out["found"][i] = bool(r.found)
                if r.found:
                    out["vals"][i] = r.value
            elif kind == SCAN and ok:
                out["scans"][i] = (r.keys, r.vals)
            if kind == RMW:
                j += 1
                w = res.results[j]
                ok = ok and w is not None and w.ok
            out["ok"][i] = ok
            j += 1
        return out

    def readback(self, keys: np.ndarray):
        """(found, vals) of ``keys``, read through the program once the
        window has closed; keys of a MultiGet that failed read as absent."""
        found = np.zeros(len(keys), bool)
        vals = np.zeros((len(keys), self.vw), np.uint32)
        for c in range(0, len(keys), READBACK_CHUNK):
            op = self._Op.multiget(keys[c:c + READBACK_CHUNK])
            res = self.target.submit(self._Batch([op]), sync=True).result().results
            if len(res) != 1 or not res[0].ok:
                continue
            r = res[0]
            found[c:c + READBACK_CHUNK] = r.found
            vals[c:c + READBACK_CHUNK] = r.vals
        return found, vals

    def close(self) -> None:
        if self.engine is not None:
            self.engine.close()
        for db in self.stores:
            db.close()
        self.stores = []


class ControlSystem:
    """The reference store in the program's place (see reference/store.py)."""

    def __init__(self, cfg: dict, value_bits: int = 16):
        self.vw = int(cfg["system"]["vw"])
        self.value_bits = value_bits
        self.ref = None

    def load(self, keys, vals):
        from perfbench.reference.store import ReferenceStore

        self.ref = ReferenceStore(keys, vals, self.value_bits)

    def resident(self, mix) -> bool:
        return True

    def counters(self) -> dict:
        return {}

    def submit(self, req, trace: bool = False):
        return self.ref.submit(req)

    def normalize(self, req, res) -> dict:
        return res

    def readback(self, keys):
        found = np.zeros(len(keys), bool)
        vals = np.zeros((len(keys), self.vw), np.uint32)
        for i, k in enumerate(keys.tolist()):
            v = self.ref._get(k)
            if v is not None:
                found[i], vals[i] = True, v
        return found, vals

    def close(self) -> None:
        self.ref = None
