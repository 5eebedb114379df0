"""Property-based twins (hypothesis, at the example counts of the active
profile of ``tests/conftest.py``: ``ci`` unless asked) of
``tests/test_remix_property.py`` on the port: each drawn run set goes to
both packages, and the port is held to the brute-force truth and to the
reference, bit for bit.

  I1  get(k) == LSM semantics, for REMIX and the merging iterator
  I2/I3  REMIX scan and merging-iterator scan return the truth's prefix
  I4/I5  group heads, placeholder tails and cursor offsets
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import keys as RK  # noqa: E402
from repro.core import merge_iter as RM  # noqa: E402
from repro.core import query as RQ  # noqa: E402
from repro.core.remix import build_remix as r_build  # noqa: E402
from repro.core.runs import make_run as r_make  # noqa: E402
from repro_torch.core import keys as TK  # noqa: E402
from repro_torch.core import merge_iter as TM  # noqa: E402
from repro_torch.core import query as TQ  # noqa: E402
from repro_torch.core.remix import build_remix as t_build  # noqa: E402
from repro_torch.core.runs import make_run as t_make  # noqa: E402
from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER  # noqa: E402
from repro_torch.device import as_words  # noqa: E402

CPU = "cpu"


@st.composite
def runset_strategy(draw):
    r = draw(st.integers(1, 6))
    keyspace = draw(st.integers(8, 120))
    ref, port = [], []
    truth = {}  # key -> (seq, tomb)
    for i in range(r):
        n = draw(st.integers(0, min(40, keyspace)))
        kk = draw(st.lists(st.integers(0, keyspace), min_size=n, max_size=n, unique=True))
        kk = np.sort(np.array(kk, np.uint64)) if kk else np.zeros(0, np.uint64)
        tomb = np.array(
            draw(st.lists(st.booleans(), min_size=len(kk), max_size=len(kk))), bool,
        ) if len(kk) else np.zeros(0, bool)
        ref.append(r_make(kk, seq=i + 1, tomb=tomb))
        port.append(t_make(kk, seq=i + 1, tomb=tomb, device=CPU))
        for j, key in enumerate(kk):
            prev = truth.get(int(key))
            if prev is None or prev[0] < i + 1:
                truth[int(key)] = (i + 1, bool(tomb[j]))
    d = draw(st.sampled_from([8, 16, 32]))
    if d < r:
        d = 8
    return ref, port, truth, d, keyspace


def both(ref_arr, port_t):
    a, b = np.asarray(ref_arr), port_t.numpy()
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    np.testing.assert_array_equal(a, b)
    return b


@settings(deadline=None)
@given(runset_strategy(), st.integers(0, 200))
def test_get_matches_truth(data, qseed):
    ref, port, truth, d, keyspace = data
    if all(r.n == 0 for r in port):
        return
    rremix, rrs = r_build(ref, d=d)
    tremix, trs = t_build(port, d=d)
    queries = np.random.default_rng(qseed).integers(0, keyspace + 2, size=16).astype(np.uint64)
    qk = TK.pack_u64(queries)
    found, vals = TQ.get(tremix, trs, as_words(qk, CPU))
    mfound, mvals = TM.merge_get(trs, as_words(qk, CPU))
    rf, rv = RQ.get(rremix, rrs, jnp.asarray(qk))
    rmf, rmv = RM.merge_get(rrs, jnp.asarray(qk))
    both(rf, found), both(rv, vals), both(rmf, mfound), both(rmv, mvals)
    for i, q in enumerate(queries):
        entry = truth.get(int(q))
        expect = entry is not None and not entry[1]
        assert bool(found[i]) == expect and bool(mfound[i]) == expect, (q, entry)
        if expect:
            assert int(vals[i, -1]) == entry[0] == int(mvals[i, -1])


@settings(deadline=None)
@given(runset_strategy())
def test_scan_agrees_with_merge_iter(data):
    ref, port, truth, d, keyspace = data
    if all(r.n == 0 for r in port):
        return
    rremix, rrs = r_build(ref, d=d)
    tremix, trs = t_build(port, d=d)
    live = sorted(k for k, (s, t) in truth.items() if not t)
    queries = np.array([0, keyspace // 2, keyspace], np.uint64)
    qk = TK.pack_u64(queries)
    w = 12
    keys, _, valid, _ = TQ.scan(tremix, trs, as_words(qk, CPU), width=w)
    mkeys, _, mvalid = TM.merge_scan(trs, as_words(qk, CPU), w)
    rk, _, rvalid, _ = RQ.scan(rremix, rrs, jnp.asarray(qk), width=w)
    rmk, _, rmvalid = RM.merge_scan(rrs, jnp.asarray(qk), width=w)
    both(rvalid, valid), both(rmvalid, mvalid), both(rmk, mkeys)
    np.testing.assert_array_equal(np.asarray(rk)[np.asarray(rvalid)],
                                  keys[valid].numpy().view(np.uint32))
    for i, q in enumerate(queries):
        got = list(TK.unpack_u64(keys[i][valid[i]].numpy()))
        mgot = list(TK.unpack_u64(mkeys[i][mvalid[i]].numpy()))
        start = int(np.searchsorted(np.array(live, np.uint64), q, side="left"))
        expect = live[start:]
        assert got == expect[: len(got)], (q, got, expect[:w])
        assert mgot == expect[: len(mgot)], (q, mgot, expect[:w])


@settings(deadline=None)
@given(runset_strategy())
def test_structural_invariants(data):
    ref, port, truth, d, _ = data
    if all(r.n == 0 for r in port):
        return
    rremix, _ = r_build(ref, d=d)
    remix, _ = t_build(port, d=d)
    sels = both(rremix.selectors, remix.selectors)
    cursors = both(rremix.cursors, remix.cursors)
    both(rremix.anchors, remix.anchors)
    r = len(port)
    pad = sels == PLACEHOLDER
    runid = sels & 0x7F
    assert (runid[~pad] < r).all()
    heads = sels.reshape(-1, d)[:, 0]
    total_used = int(np.max(np.flatnonzero(~pad))) + 1 if (~pad).any() else 0
    for g, h in enumerate(heads):
        if g * d < total_used:
            assert h != PLACEHOLDER
            assert h & NEWEST_BIT
    for row in (sels == PLACEHOLDER).reshape(-1, d):
        if row.any():
            assert row[int(np.argmax(row)):].all()
    flat_run = np.where(pad, -1, runid)
    for g in range(remix.g):
        for run in range(r):
            assert cursors[g, run] == int(np.sum(flat_run[: g * d] == run))
