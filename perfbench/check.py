"""The comparison that decides ``correct``.

Every answer the program gave in a run (set-up's warm-up and the window)
is judged against the reference model (``reference/model.py``) once the
window has closed, fed the same load and the same request stream, with
each request's interval on the client's clock. After the window every key
written in the run, and a sample of the loaded keys drawn from the seed,
are read back through the program and judged as reads that follow every
write. An operation whose answer never came, or came with another
status than OK, is a wrong answer of its kind. The numbers compared, each
with its limit (exact comparisons: limit 0):

- ``wrong_reads``: point reads whose answer the reference does not allow;
- ``wrong_scans``: scans whose answer the reference does not allow;
- ``lost_writes``: writes never acknowledged, and written keys that do
  not read back as written;
- ``wrong_loaded``: sampled loaded keys that do not read back as loaded.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.model import Model
from perfbench.traffic import INSERT, READ, RMW, SCAN, UPDATE, seed_seq

LIMITS = dict(wrong_reads=0, wrong_scans=0, lost_writes=0, wrong_loaded=0)
KIND_NUMBER = {READ: "wrong_reads", RMW: "wrong_reads", SCAN: "wrong_scans",
               INSERT: "lost_writes", UPDATE: "lost_writes"}
LOADED_SAMPLE = 1 << 14


def written_keys(records) -> np.ndarray:
    ks = [r.req.keys[np.isin(r.req.kinds, (INSERT, UPDATE, RMW))] for r in records]
    return np.unique(np.concatenate(ks)) if ks else np.zeros(0, np.uint64)


def readback_keys(records, loaded: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The keys read back after the window: every written key, and a
    sample of the loaded keys drawn from the seed."""
    rng = np.random.default_rng(seed_seq(seed, 4))
    sample = loaded[rng.choice(len(loaded), min(LOADED_SAMPLE, len(loaded)), replace=False)]
    return written_keys(records), sample


def judge(records, loaded_keys, loaded_vals, written, sample,
          rb_found, rb_vals, epoch: float) -> dict:
    """The numbers compared: each a count of wrong or missing answers."""
    model = Model(loaded_keys, loaded_vals)
    for r in records:
        ans = r.ans
        wr = np.flatnonzero(np.isin(r.req.kinds, (INSERT, UPDATE, RMW)))
        for i in wr.tolist():
            end = r.t1 - epoch if ans is not None and ans["ok"][i] else float("inf")
            pos = i + 0.5 if r.req.kinds[i] == RMW else i
            model.write(int(r.req.keys[i]), r.req.vals[i], r.t0 - epoch, end,
                        r.req.client, r.req.index, pos)
    out = dict.fromkeys(LIMITS, 0)
    hist = model.hist
    for r in records:
        ans = r.ans
        ok = ans["ok"] if ans is not None else np.zeros(len(r.req), bool)
        for kind in r.req.kinds[~ok].tolist():
            out[KIND_NUMBER[kind]] += 1
        if ans is None:
            continue
        s, e = r.t0 - epoch, r.t1 - epoch
        who = (r.req.client, r.req.index)
        reads = np.flatnonzero(np.isin(r.req.kinds, (READ, RMW)) & ans["ok"])
        if len(reads):
            keys = r.req.keys[reads]
            plain = np.array([k not in hist for k in keys.tolist()], bool)
            if plain.any():  # keys nobody wrote: found, as loaded
                i = np.searchsorted(model.keys, keys[plain])
                ic = np.minimum(i, len(model.keys) - 1)
                hit = (i < len(model.keys)) & (model.keys[ic] == keys[plain])
                f = ans["found"][reads[plain]]
                same = np.all(ans["vals"][reads[plain]] == model.vals[ic], axis=1)
                out["wrong_reads"] += int((f != hit).sum() + (f & hit & ~same).sum())
            for j in reads[~plain].tolist():
                got = ans["vals"][j] if ans["found"][j] else None
                if not model.value_ok(int(r.req.keys[j]), got, s, e, *who, j):
                    out["wrong_reads"] += 1
        for j, (kk, vv) in ans["scans"].items():
            if ans["ok"][j] and not model.scan_ok(int(r.req.keys[j]), r.req.scan_n, kk, vv,
                                                  s, e, *who, j):
                out["wrong_scans"] += 1
    n_w = len(written)
    for j, k in enumerate(written.tolist()):
        got = rb_vals[j] if rb_found[j] else None
        if not model.value_ok(k, got):
            out["lost_writes"] += 1
    lf, lv = rb_found[n_w:], rb_vals[n_w:]
    for j, k in enumerate(sample.tolist()):
        got = lv[j] if lf[j] else None
        if not model.value_ok(k, got):
            out["wrong_loaded"] += 1
    return out


def compared(numbers: dict, kinds_present: set) -> dict:
    """The numbers a cell compares, each with its limit: reads, scans and
    writes only where its traffic has them."""
    keep = ["wrong_loaded"]
    if kinds_present & {"read", "rmw"}:
        keep.append("wrong_reads")
    if "scan" in kinds_present:
        keep.append("wrong_scans")
    if kinds_present & {"insert", "update", "rmw"}:
        keep.append("lost_writes")
    return {k: dict(value=int(numbers[k]), limit=LIMITS[k]) for k in keep}
