"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions and the ``ops`` compositions against the Pallas
kernels run in interpret mode and against the ``ref.py`` oracles, bit for
bit (integer results: tolerance 0). The CUDA kernels themselves run only
on a card: ``tests/test_torch_cuda.py`` (marker ``cuda``) and
``chip_smoke.py`` hold them against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import keys as RK  # noqa: E402
from repro.core import remix as RR  # noqa: E402
from repro.core import runs as RRu  # noqa: E402
from repro.kernels.anchor_search import anchor_le_count as ref_le_count  # noqa: E402
from repro.kernels.anchor_search import anchor_search as ref_anchor_search  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import ref as RF  # noqa: E402
from repro.kernels.selector_decode import selector_decode as ref_selector_decode  # noqa: E402
from repro_torch import device as TD  # noqa: E402
from repro_torch.core import remix as TR  # noqa: E402
from repro_torch.core import runs as TRu  # noqa: E402
from repro_torch.device import as_words  # noqa: E402
from repro_torch.kernels import anchor_search as TA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TF  # noqa: E402
from repro_torch.kernels import selector_decode as TS  # noqa: E402

CPU = "cpu"
MULT = np.uint64(0x9E3779B97F4A7C15)


def eq(ref, port, msg=""):
    """Exact equality (tolerance 0); the port's int32 words compare as the
    reference's uint32."""
    a = np.asarray(ref)
    b = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    if a.dtype == np.uint32 and b.dtype == np.int32:
        b = b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def anchors_and_queries(rng, g, kw):
    """Sorted (g, kw) anchors with leading-word ties, sign-bit words and a
    +inf tail; queries with exact hits, near misses and extremes."""
    tail = g // 5
    rows = rng.integers(0, 2**32, size=(2 * g + 8, kw), dtype=np.uint64)
    rows[:, 0] %= max(1, g // 3)
    rows[: g // 2, 0] |= 1 << 31
    rows = np.unique(rows.astype(np.uint32), axis=0)[: g - tail]
    a = np.full((g, kw), 0xFFFFFFFF, np.uint32)
    a[: len(rows)] = rows
    q = rng.integers(0, 2**32, size=(90, kw), dtype=np.uint64).astype(np.uint32)
    q[:30] = rows[rng.integers(0, len(rows), 30)]
    q[30:60] = rows[rng.integers(0, len(rows), 30)]
    q[30:60, -1] += np.uint32(1)
    q[60] = 0
    return a, q


@pytest.mark.parametrize("kw", [1, 2, 3])
@pytest.mark.parametrize("g", [1, 5, 513, 1000])
def test_anchor_search_plain_matches_pallas(g, kw):
    rng = np.random.default_rng(g * 10 + kw)
    a, q = anchors_and_queries(rng, g, kw)
    ja, jq = jnp.asarray(a), jnp.asarray(q)
    ta, tq = as_words(a, CPU), as_words(q, CPU)
    want = ref_anchor_search(ja, jq, interpret=True)  # two levels when G > 512
    eq(want, RF.anchor_search_ref(ja, jq))
    eq(want, TA.anchor_search(ta, tq))
    eq(want, TF.anchor_search_ref(ta, tq))
    count = TA.anchor_le_count(ta, tq)
    eq(RK.upper_bound(ja, jq), count)
    pallas_count = np.asarray(ref_le_count(ja, jq, interpret=True))
    if g <= 512:
        eq(pallas_count, count)
    else:
        # The Pallas kernel tiles anchors by 512 rows; on a ragged last tile
        # its standalone count may run high (anchor_search never reaches it:
        # it counts G > 512 in two levels). Hold the port's count against
        # the Pallas kernel on G padded with +inf rows to whole tiles.
        assert (pallas_count >= count.numpy()).all()
        gp = -(-g // 512) * 512
        ap = np.vstack([a, np.full((gp - g, kw), 0xFFFFFFFF, np.uint32)])
        eq(ref_le_count(jnp.asarray(ap), jq, interpret=True), count)


@pytest.mark.parametrize("kw", [1, 2, 3])
@pytest.mark.parametrize("g", [1, 5, 15, 16, 17, 513, 32_768, 100_003, 1 << 20])
def test_anchor_plan(g, kw):
    """The kernel's shared-memory sample: every stride-th of G rows."""
    stride, rows, smem = TA._plan(g, kw)
    line = TA.LINE_BYTES // (4 * kw)
    assert smem == rows * kw * 4 <= TA.SAMPLE_BYTES_MAX <= 227 * 1024
    assert (rows - 1) * stride < g <= rows * stride  # covers G, no row past it
    doublings = stride // line
    assert stride == line * doublings and doublings & (doublings - 1) == 0
    if stride > line:  # the stride doubled only because the sample had to
        assert -(-g // (stride // 2)) * kw * 4 > TA.SAMPLE_BYTES_MAX
    if (g, kw) == (32_768, 2):  # the main path: one 128-byte line per block
        assert (stride, rows, smem) == (16, 2048, 16 * 1024)


def random_selectors(rng, q, d, r):
    sel = rng.integers(0, r, size=(q, d)) | (rng.integers(0, 2, size=(q, d)) << 7)
    sel[rng.random((q, d)) < 0.2] = 127
    sel[:, d - rng.integers(0, d // 4 + 1):] = 127  # placeholder tails
    cur = rng.integers(0, 1 << 20, size=(q, r)).astype(np.int32)
    return sel, cur


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("d,r", [(8, 1), (8, 8), (16, 3), (32, 8), (64, 16)])
def test_selector_decode_plain_matches_pallas(d, r, dtype):
    rng = np.random.default_rng(d * 100 + r)
    sel, cur = random_selectors(rng, 130, d, r)
    sel = sel.astype(dtype)
    want = ref_selector_decode(jnp.asarray(sel), jnp.asarray(cur), r=r, interpret=True)
    ts, tc = torch.from_numpy(sel), torch.from_numpy(cur)
    got = TS.selector_decode(ts, tc)
    oracle = TF.selector_decode_ref(ts, tc)
    for name, w, g, o in zip(("runid", "absidx", "newest", "pad"), want, got, oracle):
        eq(w, g, name)
        eq(w, o, name)


def selector_table(rng, g, d, r):
    """(g, d) selectors with runids >= R (no cursor, no count), runid 127
    with the newest bit (255), all-pad rows and placeholder tails; (g, r)
    cursors."""
    sel = rng.integers(0, r + 3, size=(g, d)) | (rng.integers(0, 2, size=(g, d)) << 7)
    sel[rng.random((g, d)) < 0.05] = 255
    sel[rng.random((g, d)) < 0.2] = 127
    sel[:, d - rng.integers(0, d // 4 + 1):] = 127
    sel[::7] = 127
    cur = rng.integers(0, 1 << 20, size=(g, r)).astype(np.int32)
    return sel, cur


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("d,r", [(8, 3), (16, 8), (32, 8), (64, 16)])
def test_selector_decode_rows_match_pallas(d, r, dtype):
    """With ``rows`` the decode reads the (G, D) / (G, R) group tables
    through the group ids: equal to the Pallas kernel on the gathered tiles,
    for repeated and unordered ids, all-pad rows and runids >= R."""
    rng = np.random.default_rng(d * 7 + r)
    g = 40
    sel, cur = selector_table(rng, g, d, r)
    sel = sel.astype(dtype)
    rows = np.concatenate([rng.integers(0, g, 50), [g - 1, 0, 0, 7, 7, g - 1],
                           np.arange(g)[::-1]]).astype(np.int32)
    assert ((sel[rows] != 127) & ((sel[rows] & 0x7F) >= r)).any()
    assert (sel[rows] == 127).all(axis=1).any()
    want = ref_selector_decode(jnp.asarray(sel[rows]), jnp.asarray(cur[rows]), r=r,
                               interpret=True)
    got = TS.selector_decode(torch.from_numpy(sel), torch.from_numpy(cur),
                             rows=torch.from_numpy(rows))
    for name, w, x in zip(("runid", "absidx", "newest", "pad"), want, got):
        eq(w, x, name)


def _indexes(rng, d, r=6, n=300, space=900):
    data = []
    for i in range(r):
        with np.errstate(over="ignore"):
            k = np.sort(np.asarray(rng.choice(space, n, replace=False), np.uint64) * MULT)
        vals = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)
        data.append((k, vals, (np.arange(n) + i * n + 1).astype(np.uint32),
                     rng.random(n) < 0.1))
    ref = RR.build_remix([RRu.make_run(k, v, seq=s, tomb=t) for k, v, s, t in data], d=d)
    port = TR.build_remix([TRu.make_run(k, v, seq=s, tomb=t, device=CPU)
                           for k, v, s, t in data], d=d)
    with np.errstate(over="ignore"):
        q = np.concatenate([np.asarray(rng.choice(space, 60), np.uint64) * MULT,
                            rng.integers(0, 2**64, 4, dtype=np.uint64)])
    qk = RK.pack_u64(q)
    return ref, port, jnp.asarray(qk), as_words(qk, CPU)


def _exp(rng, rs, now):
    """TTL expiry words: none, past, exactly now and future, over the runset."""
    e = rng.choice(np.array([0, 0, now - 5, now, now + 5, 2**32 - 1], np.uint32),
                   size=rs.tomb.shape)
    return jnp.asarray(e), as_words(e, CPU)


@pytest.mark.parametrize("d", [16, 32])
def test_ops_match_reference_ops(d):
    rng = np.random.default_rng(d)
    (rm, rs), (tm, ts), jq, tq = _indexes(rng, d)
    eq(RO.seek(rm, rs, jq, interpret=True), TO.seek(tm, ts, tq))
    fr, vr = RO.get(rm, rs, jq, interpret=True)
    ft, vt = TO.get(tm, ts, tq)
    eq(fr, ft)
    eq(vr, vt)
    for a, b in zip(RO.scan(rm, rs, jq, 40, interpret=True), TO.scan(tm, ts, tq, 40)):
        eq(a, b)


@pytest.mark.parametrize("now", [3_000_000_000, 1_000])
def test_live_ops_match_reference_ops(now):
    rng = np.random.default_rng(now % 97)
    (rm, rs), (tm, ts), jq, tq = _indexes(rng, 32)
    je, te = _exp(rng, rs, now)
    nw = jnp.uint32(now)
    for a, b in zip(RO.get_live(rm, rs, je, jq, nw, interpret=True),
                    TO.get_live(tm, ts, te, tq, now)):
        eq(a, b)
    for a, b in zip(RO.scan_live(rm, rs, je, jq, nw, 40, interpret=True),
                    TO.scan_live(tm, ts, te, tq, now, 40)):
        eq(a, b)


def test_gather_view_ops_match_reference_ops():
    rng = np.random.default_rng(4)
    (rm, rs), (tm, ts), _, _ = _indexes(rng, 16)
    n = rm.n_slots
    pos = np.array([0, 15, 16, n // 2, n - 1, n], np.int32)
    for a, b in zip(RO.gather_view(rm, rs, jnp.asarray(pos), 33, interpret=True),
                    TO.gather_view(tm, ts, torch.from_numpy(pos), 33)):
        eq(a, b)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """CPU tensors never build, load or launch a kernel, and the launch
    counters stay at 0."""

    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(TD, "kernel_library", no_library)
    monkeypatch.setattr(TA, "kernel_library", no_library)
    monkeypatch.setattr(TS, "kernel_library", no_library)
    counts = (TA.anchor_search.launches, TA.anchor_le_count.launches,
              TS.selector_decode.launches)
    rng = np.random.default_rng(1)
    a, q = anchors_and_queries(rng, 40, 2)
    TA.anchor_search(as_words(a, CPU), as_words(q, CPU))
    TA.anchor_le_count(as_words(a, CPU), as_words(q, CPU))
    sel, cur = random_selectors(rng, 10, 8, 2)
    TS.selector_decode(torch.from_numpy(sel.astype(np.uint8)), torch.from_numpy(cur))
    TS.selector_decode(torch.from_numpy(sel.astype(np.uint8)), torch.from_numpy(cur),
                       rows=torch.tensor([3, 0, 3], dtype=torch.int32))
    (_, _), (tm, ts), _, tq = _indexes(rng, 8, r=2, n=40, space=100)
    TO.scan_live(tm, ts, torch.zeros_like(ts.seq), tq, 5, 9)
    assert counts == (0, 0, 0)
    assert (TA.anchor_search.launches, TA.anchor_le_count.launches,
            TS.selector_decode.launches) == counts
