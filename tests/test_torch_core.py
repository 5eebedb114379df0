"""The port's REMIX core (``repro_torch.core``) against the JAX package's
(``repro.core``) on the same numpy inputs.

Every result here is an integer (positions, masks, key and value words),
so every comparison is exact: tolerance 0.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import keys as RK  # noqa: E402
from repro.core import query as RQ  # noqa: E402
from repro.core import remix as RR  # noqa: E402
from repro.core import runs as RRu  # noqa: E402
from repro.core import view as RV  # noqa: E402
from repro_torch.core import keys as TK  # noqa: E402
from repro_torch.core import query as TQ  # noqa: E402
from repro_torch.core import remix as TR  # noqa: E402
from repro_torch.core import runs as TRu  # noqa: E402
from repro_torch.core import view as TV  # noqa: E402
from repro_torch.device import as_words  # noqa: E402

CPU = "cpu"
# (d, r) with d >= r, as the REMIX requires
DR = [(d, r) for d, r in itertools.product((8, 32, 64), (1, 4, 16)) if d >= r]
MULT = np.uint64(0x9E3779B97F4A7C15)  # odd: a bijection on 64-bit keys


def eq(ref, port, msg=""):
    """Exact equality (tolerance 0) of a reference and a port array; the
    port's int32 words compare as the reference's uint32."""
    a = np.asarray(ref)
    b = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    if a.dtype == np.uint32 and b.dtype == np.int32:
        b = b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def spread(c):
    """Distinct small ints -> distinct keys spread over all 64 bits, so
    key words cross 2**31 and unsigned ordering is exercised."""
    with np.errstate(over="ignore"):
        return np.asarray(c, np.uint64) * MULT


def rand_keys(rng, n, kw, inf_rows=0):
    """(n, kw) uint32 rows sorted lexicographically, unique, with an
    all-ones +inf tail of ``inf_rows``."""
    rows = rng.integers(0, 2**32, size=(n * 2, kw), dtype=np.uint64)
    rows[:, 0] %= 1 << 31 if kw == 1 else 7  # ties on the leading word
    rows[: n // 3, 0] |= 1 << 31  # words with the sign bit set
    rows = np.unique(rows.astype(np.uint32), axis=0)[: n - inf_rows]
    inf = np.full((inf_rows, kw), 0xFFFFFFFF, np.uint32)
    return np.concatenate([rows, inf])


def runs_np(rng, r, n, space):
    out = []
    for i in range(r):
        k = np.sort(spread(rng.choice(space, size=n, replace=False)))
        vals = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)
        seq = (np.arange(n) + i * n + 1).astype(np.uint32)
        tomb = rng.random(n) < 0.1
        out.append((k, vals, seq, tomb))
    return out


_INDEX = {}


def index(d, r):
    """The same runs indexed by both packages (built once per (d, r))."""
    if (d, r) not in _INDEX:
        rng = np.random.default_rng(d * 100 + r)
        space = 3 * 120
        data = runs_np(rng, r, 120, space)
        ref = RR.build_remix([RRu.make_run(k, v, seq=s, tomb=t) for k, v, s, t in data], d=d)
        port = TR.build_remix(
            [TRu.make_run(k, v, seq=s, tomb=t, device=CPU) for k, v, s, t in data], d=d
        )
        q = np.concatenate([spread(rng.choice(space, 48)),
                            rng.integers(0, 2**64, 16, dtype=np.uint64)])
        qk = RK.pack_u64(q)
        _INDEX[d, r] = ref, port, jnp.asarray(qk), as_words(qk, CPU)
    return _INDEX[d, r]


def test_pack_unpack_roundtrip():
    x = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**63, 2**64 - 1], np.uint64)
    eq(RK.pack_u64(x), TK.pack_u64(x))
    eq(x, TK.unpack_u64(TK.pack_u64(x)))
    eq(x, TK.unpack_u64(TK.pack_u64(x).view(np.int32)))  # bit-view input


@pytest.mark.parametrize("kw", [1, 2, 3])
def test_key_compare_parity(kw):
    rng = np.random.default_rng(kw)
    a = rand_keys(rng, 64, kw, inf_rows=4)
    b = np.concatenate([a[rng.permutation(64)][:32], rand_keys(rng, 32, kw)])
    ja, jb = jnp.asarray(a)[:, None], jnp.asarray(b)[None]
    ta, tb = as_words(a, CPU)[:, None], as_words(b, CPU)[None]
    eq(RK.key_lt(ja, jb), TK.key_lt(ta, tb).numpy())
    eq(RK.key_eq(ja, jb), TK.key_eq(ta, tb).numpy())
    eq(RK.key_le(ja, jb), TK.key_le(ta, tb).numpy())
    eq(RK.max_key(kw), TK.max_key(kw, device="cpu"))


@pytest.mark.parametrize("kw", [1, 2, 3])
def test_bounds_parity(kw):
    rng = np.random.default_rng(10 + kw)
    keys = rand_keys(rng, 200, kw, inf_rows=8)
    q = np.concatenate([keys[:-8][rng.integers(0, 192, 40)], rand_keys(rng, 40, kw),
                        np.zeros((1, kw), np.uint32)])
    for ref, port in ((RK.lower_bound, TK.lower_bound), (RK.upper_bound, TK.upper_bound)):
        eq(ref(jnp.asarray(keys), jnp.asarray(q)),
           port(as_words(keys, CPU), as_words(q, CPU)).numpy())
    empty = as_words(np.zeros((0, kw), np.uint32), CPU)
    assert TK.upper_bound(empty, as_words(q, CPU)).tolist() == [0] * len(q)


def test_sort_indices_np_parity():
    rng = np.random.default_rng(3)
    keys = rand_keys(rng, 50, 2)[rng.integers(0, 50, 120)]
    seq = rng.integers(0, 2**32, 120, dtype=np.uint64).astype(np.uint32)
    eq(RK.sort_indices_np(keys, seq), TK.sort_indices_np(keys, seq))


@pytest.mark.parametrize("d,r", DR)
def test_build_view_parity(d, r):
    rng = np.random.default_rng(d + r)
    data = runs_np(rng, r, 90, 200)
    ks = [RK.pack_u64(k) for k, _, _, _ in data]
    ss = [s for _, _, s, _ in data]
    a, b = RV.build_view(ks, ss, d), TV.build_view(ks, ss, d)
    for f in ("sel", "entry_run", "entry_pos"):
        eq(getattr(a, f), getattr(b, f), f)
    assert (a.n_entries, a.d, TV.PLACEHOLDER, TV.NEWEST_BIT) == \
        (b.n_entries, b.d, RV.PLACEHOLDER, RV.NEWEST_BIT)


@pytest.mark.parametrize("d,r", DR)
def test_build_remix_parity(d, r):
    (rm, rs), (tm, ts), _, _ = index(d, r)
    eq(rm.anchors, tm.anchors)
    eq(rm.cursors, tm.cursors.numpy())
    eq(rm.selectors, tm.selectors.numpy())
    assert int(rm.n_entries) == tm.n_entries and rm.d == tm.d
    assert rm.storage_bytes() == tm.storage_bytes()
    assert rm.storage_bytes(anchor_key_bytes=16) == tm.storage_bytes(anchor_key_bytes=16)
    for f in ("keys", "vals", "seq"):
        eq(getattr(rs, f), getattr(ts, f), f)
    eq(rs.tomb, ts.tomb.numpy())
    eq(rs.lens, ts.lens.numpy())
    assert rs.total() == ts.total()


def test_remix_from_order_parity():
    rng = np.random.default_rng(5)
    data = runs_np(rng, 3, 50, 100)
    ks = [RK.pack_u64(k) for k, _, _, _ in data]
    runid, pos, _, newest = RV._merge_order(ks, [s for _, _, s, _ in data])
    a = RR.remix_from_order(runid, pos, newest, ks, d=8)
    b = TR.remix_from_order(runid, pos, newest, ks, d=8, device=CPU)
    eq(a.anchors, b.anchors)
    eq(a.cursors, b.cursors.numpy())
    eq(a.selectors, b.selectors.numpy())
    with pytest.raises(ValueError):
        TR.remix_from_order(runid, pos, newest, ks, d=2, device=CPU)


def test_from_arrays_feeds_one_index_to_both():
    (rm, rs), _, jq, tq = index(32, 4)
    tm = TR.remix_from_arrays(np.asarray(rm.anchors), np.asarray(rm.cursors),
                              np.asarray(rm.selectors), np.asarray(rm.n_entries),
                              rm.d, device=CPU)
    ts = TRu.runset_from_arrays(*(np.asarray(x) for x in
                                  (rs.keys, rs.vals, rs.seq, rs.tomb, rs.lens)),
                                device=CPU)
    eq(RQ.seek(rm, rs, jq), TQ.seek(tm, ts, tq).numpy())


def test_runset_gather_clamps():
    (_, rs), (_, ts), _, _ = index(8, 4)
    run = np.array([-3, 0, 1, 3, 4, 99, 2], np.int32)
    pos = np.array([0, -1, 5, 119, 120, 7, 10**6], np.int32)
    got = ts.gather(torch.from_numpy(run), torch.from_numpy(pos))
    want = rs.gather(jnp.asarray(run), jnp.asarray(pos))
    for w, g in zip(want, got):
        eq(w, g)


@pytest.mark.parametrize("ingroup", ["vector", "binary"])
@pytest.mark.parametrize("d,r", DR)
def test_seek_parity(d, r, ingroup):
    (rm, rs), (tm, ts), jq, tq = index(d, r)
    eq(RQ.seek(rm, rs, jq, ingroup=ingroup), TQ.seek(tm, ts, tq, ingroup=ingroup).numpy())


@pytest.mark.parametrize("d,r", DR)
def test_get_parity(d, r):
    (rm, rs), (tm, ts), jq, tq = index(d, r)
    fr, vr = RQ.get(rm, rs, jq)
    ft, vt = TQ.get(tm, ts, tq)
    eq(fr, ft.numpy())
    eq(vr, vt)
    assert 0 < int(ft.sum()) < len(ft)


@pytest.mark.parametrize("d,r", DR)
def test_scan_parity(d, r):
    (rm, rs), (tm, ts), jq, tq = index(d, r)
    for with_vals in (True, False):
        kr, vr, mr, pr = RQ.scan(rm, rs, jq, 21, with_vals=with_vals)
        kt, vt, mt, pt = TQ.scan(tm, ts, tq, 21, with_vals=with_vals)
        eq(kr, kt)
        eq(mr, mt.numpy())
        eq(pr, pt.numpy())
        if with_vals:
            eq(vr, vt)
        else:
            assert vr is None and vt is None


@pytest.mark.parametrize("d,r", DR)
def test_gather_view_parity(d, r):
    (rm, rs), (tm, ts), _, _ = index(d, r)
    n = rm.n_slots
    pos = np.array([0, 1, d - 1, d, n // 2, n - 3, n - 1, n], np.int32)
    kr, vr, mr = RQ.gather_view(rm, rs, jnp.asarray(pos), 2 * d + 3)
    kt, vt, mt = TQ.gather_view(tm, ts, torch.from_numpy(pos), 2 * d + 3)
    eq(kr, kt)
    eq(vr, vt)
    eq(mr, mt.numpy())


def test_decode_groups_parity():
    (rm, rs), (tm, ts), _, _ = index(32, 16)
    g = np.array([[0, 1], [rm.g - 1, rm.g + 5]], np.int32)  # clamped past the end
    a = RQ.decode_groups(rm, rs, jnp.asarray(g))
    b = TQ.decode_groups(tm, ts, torch.from_numpy(g))
    for f in ("runid", "absidx", "keys", "vals", "seq", "newest", "pad", "tomb"):
        eq(a[f], b[f], f)


def test_unknown_ingroup_mode_raises():
    _, (tm, ts), _, tq = index(8, 1)
    with pytest.raises(ValueError):
        TQ.seek(tm, ts, tq, ingroup="linear")


def test_host_range_helpers_parity():
    rng = np.random.default_rng(9)
    los = rng.integers(0, 100, 30)
    his = los + rng.integers(-2, 9, 30)
    for gap in (0, 3):
        for a, b in zip(RRu.merge_ranges_np(los, his, gap), TRu.merge_ranges_np(los, his, gap)):
            eq(a, b)
        pairs = list(zip(los.tolist(), his.tolist()))
        assert RRu.merge_ranges(pairs, gap) == TRu.merge_ranges(pairs, gap)
    mlo, mhi = TRu.merge_ranges_np(los, his)
    eq(RRu.ranges_to_rows(mlo, mhi), TRu.ranges_to_rows(mlo, mhi))
