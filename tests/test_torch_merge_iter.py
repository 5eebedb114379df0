"""The port's merging iterator (``repro_torch.core.merge_iter``) against the
JAX package's (``repro.core.merge_iter``) on the same numpy inputs.

Every result is an integer (cursors, key and value words, masks), so every
comparison is exact: tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import keys as RK  # noqa: E402
from repro.core import merge_iter as RM  # noqa: E402
from repro.core import runs as RRu  # noqa: E402
from repro_torch.core import keys as TK  # noqa: E402
from repro_torch.core import merge_iter as TM  # noqa: E402
from repro_torch.core import query as TQ  # noqa: E402
from repro_torch.core import runs as TRu  # noqa: E402
from repro_torch.core.remix import build_remix  # noqa: E402
from repro_torch.device import as_words  # noqa: E402

CPU = "cpu"
MULT = np.uint64(0x9E3779B97F4A7C15)  # odd: a bijection on 64-bit keys


def eq(ref, port, msg=""):
    a = np.asarray(ref)
    b = port.numpy()
    if a.dtype == np.uint32 and b.dtype == np.int32:
        b = b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def twin_runs(rng, r, domain=600, empty=()):
    """R runs drawn from one small domain (duplicate versions across runs),
    spread over all 64 bits (words past 2**31), with tombstones and seqs
    past 2**31; runs in ``empty`` hold nothing."""
    ref, port = [], []
    for i in range(r):
        n = 0 if i in empty else int(rng.integers(1, 200))
        with np.errstate(over="ignore"):
            kk = np.sort(rng.choice(domain, n, replace=False).astype(np.uint64) * MULT)
        tomb = rng.random(n) < 0.15
        seq = int(rng.integers(0, 2**32))
        ref.append(RRu.make_run(kk, seq=seq, tomb=tomb))
        port.append(TRu.make_run(kk, seq=seq, tomb=tomb, device=CPU))
    return RRu.stack_runs(ref), TRu.stack_runs(port)


def twin_queries(rng, q, domain=600):
    with np.errstate(over="ignore"):
        keys = rng.integers(0, domain + 50, q).astype(np.uint64) * MULT
    keys[:4] = [0, 1, 2**64 - 2, 2**63]  # before, between and past all runs
    qk = RK.pack_u64(keys)
    return jnp.asarray(qk), as_words(qk, CPU)


@pytest.mark.parametrize("r,empty", [(1, ()), (3, (1,)), (8, (0, 5))])
def test_seek_cursors_equal(r, empty):
    rng = np.random.default_rng(r)
    rs, ts = twin_runs(rng, r, empty=empty)
    qr, qt = twin_queries(rng, 97)
    eq(RM.seek_cursors(rs, qr), TM.seek_cursors(ts, qt))


@pytest.mark.parametrize("width", [8, 50])
@pytest.mark.parametrize("r,empty", [(1, ()), (3, (1,)), (8, (0, 5))])
def test_merge_scan_equal(r, empty, width):
    """Keys, values and the valid mask over ``width`` steps, through
    duplicate versions, tombstones and runs exhausted mid-scan."""
    rng = np.random.default_rng(10 + r)
    rs, ts = twin_runs(rng, r, domain=300, empty=empty)
    qr, qt = twin_queries(rng, 41, domain=300)
    for a, b, what in zip(RM.merge_scan(rs, qr, width=width),
                          TM.merge_scan(ts, qt, width), ("keys", "vals", "valid")):
        eq(a, b, what)


@pytest.mark.parametrize("r,empty", [(1, ()), (3, (1,)), (8, (0, 5))])
def test_merge_get_equal(r, empty):
    rng = np.random.default_rng(20 + r)
    rs, ts = twin_runs(rng, r, empty=empty)
    qr, qt = twin_queries(rng, 256)
    fr, vr = RM.merge_get(rs, qr)
    ft, vt = TM.merge_get(ts, qt)
    eq(fr, ft, "found")
    eq(vr, vt, "vals")
    assert 0 < int(np.asarray(fr).sum()) < 256


def test_min_run_keeps_the_earliest_of_equal_entries():
    """Ties on key and seq go to the first run, as the reference's strict
    tournament leaves them; a larger seq wins a key tie."""
    k = np.array([[[0, 5], [0, 5], [0, 5], [0, 4]],
                  [[0, 5], [0, 5], [1, 0], [0, 5]]], np.uint32)
    s = np.array([[7, 9, 9, 0], [3, 3, 3, 2**31 + 1]], np.uint32)
    want = np.asarray(RM._min_run(jnp.asarray(k), jnp.asarray(s)))
    got = TM._min_run(as_words(k, CPU), as_words(s, CPU))
    np.testing.assert_array_equal(want, got.numpy())
    assert list(want) == [3, 3]


@pytest.mark.parametrize("r,n", [(1, 1), (8, 16384), (16, 1 << 20)])
def test_seek_comparison_cost_equal(r, n):
    assert TM.seek_comparison_cost(r, n) == RM.seek_comparison_cost(r, n)


def test_scan_matches_bruteforce_and_merge_iter():
    """The merge half of ``test_remix_core.py:72`` on the port: every
    returned key is the next unique key, and REMIX and the merging
    iterator return about as many."""
    rng = np.random.default_rng(1)
    runs = [
        TRu.make_run(np.sort(rng.choice(5_000, size=400, replace=False)).astype(np.uint64),
                     seq=i, device=CPU)
        for i in range(8)
    ]
    remix, runset = build_remix(runs, d=32)
    uniq = np.unique(np.concatenate([TK.unpack_u64(r.keys.numpy()) for r in runs]))
    queries = rng.integers(0, 5_100, size=64).astype(np.uint64)
    qk = as_words(TK.pack_u64(queries), CPU)
    keys, _, valid, _ = TQ.scan(remix, runset, qk, width=50)
    mkeys, _, mvalid = TM.merge_scan(runset, qk, 50)
    for i, q in enumerate(queries):
        start = np.searchsorted(uniq, q, side="left")
        got = TK.unpack_u64(keys[i][valid[i]].numpy())
        mgot = TK.unpack_u64(mkeys[i][mvalid[i]].numpy())
        assert len(got) >= 25
        assert list(got) == list(uniq[start: start + len(got)])
        assert list(mgot) == list(uniq[start: start + len(mgot)])
        assert abs(len(mgot) - len(got)) <= 8


def test_versions_and_tombstones():
    """The merge half of ``test_remix_core.py:101``: the newest version
    wins and a tombstone hides its key."""
    r0 = TRu.make_run(np.array([5, 10, 20], np.uint64), seq=1, device=CPU)
    r1 = TRu.make_run(np.array([10, 30], np.uint64), seq=2, device=CPU)
    r2 = TRu.make_run(np.array([20, 40], np.uint64), seq=3,
                      tomb=np.array([True, False]), device=CPU)
    runset = TRu.stack_runs([r0, r1, r2])
    qk = as_words(TK.pack_u64(np.array([5, 10, 20, 30, 40, 41], np.uint64)), CPU)
    found, vals = TM.merge_get(runset, qk)
    assert list(found.numpy()) == [True, True, False, True, True, False]
    assert int(vals[1, -1]) == 2
    keys, _, valid = TM.merge_scan(runset, qk[:1], 8)
    assert list(TK.unpack_u64(keys[0][valid[0]].numpy())) == [5, 10, 30, 40]


@pytest.mark.parametrize("r", [1, 2, 8])
def test_min_run_equal_on_random_ties(r):
    """Keys and seqs from tiny domains (ties everywhere, +inf keys, seq 0
    and seqs past 2**31) pick the reference's run."""
    rng = np.random.default_rng(r)
    k = rng.integers(0, 3, (500, r, 2)).astype(np.uint32)
    k[rng.random((500, r)) < 0.3] = 0xFFFFFFFF
    s = rng.choice(np.array([0, 1, 2**31, 2**32 - 1], np.uint32), (500, r))
    want = np.asarray(RM._min_run(jnp.asarray(k), jnp.asarray(s)))
    np.testing.assert_array_equal(want, TM._min_run(as_words(k, CPU), as_words(s, CPU)).numpy())
