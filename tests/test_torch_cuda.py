"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one (marker ``cuda``).
They import no JAX, so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer results: tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import as_words, sm_count  # noqa: E402
from repro_torch.kernels import anchor_search as TA  # noqa: E402
from repro_torch.kernels import selector_decode as TS  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def sorted_anchors(rng, g, kw, nq=300):
    """Sorted (g, kw) uint32 anchors with ties, sign-bit words, +inf tail;
    ``nq`` queries."""
    rows = rng.integers(0, 2**32, size=(2 * g + 8, kw), dtype=np.uint64)
    rows[:, 0] %= max(1, g // 3)
    rows[: g // 2, 0] |= 1 << 31
    rows = np.unique(rows.astype(np.uint32), axis=0)[: g - g // 5]
    a = np.full((g, kw), 0xFFFFFFFF, np.uint32)
    a[: len(rows)] = rows
    q = rng.integers(0, 2**32, size=(nq, kw), dtype=np.uint64).astype(np.uint32)
    q[:100] = rows[rng.integers(0, len(rows), 100)]
    q[100] = 0
    q[101] = 0xFFFFFFFF  # at the +inf tail
    q[102] = rows[-1]
    q[102, -1] += np.uint32(1)  # past the last real anchor
    q[103] = 0xFFFFFFFF
    q[103, -1] = 0xFFFFFFFE  # the largest key below +inf
    return a, q


# G not a multiple of the sample stride, and G beyond the main path's
# 32,768, where the stride doubles past one line
@pytest.mark.parametrize("g", [1, 5, 17, 513, 5000, 100_003, 262_144, 1 << 20])
def test_anchor_kernels_match_plain(card, g):
    """Both of the kernel's searches: a warp per query (300 queries) and
    the shared-memory sample (enough queries for every SM to sample)."""
    rng = np.random.default_rng(g)
    many = TA.SAMPLE_MIN_QUERIES_PER_SM * sm_count(torch.empty(0, device=card)) + 5
    for kw in (1, 2, 3):
        for nq in (300, many):
            a, q = sorted_anchors(rng, g, kw, nq)
            ta, tq = as_words(a, card), as_words(q, card)
            n0 = TA.anchor_search.launches
            got = TA.anchor_search(ta, tq)
            assert TA.anchor_search.launches == n0 + 1
            assert torch.equal(got, TA.anchor_search_plain(ta, tq))
            assert torch.equal(TA.anchor_le_count(ta, tq), TA.anchor_le_count_plain(ta, tq))


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_selector_decode_matches_plain(card, d):
    rng = np.random.default_rng(d)
    for r in sorted({1, min(d, 16), d // 4 or 1}):
        for dtype in (np.uint8, np.int32):
            sel = rng.integers(0, r + 2, (300, d)) | (rng.integers(0, 2, (300, d)) << 7)
            sel[rng.random((300, d)) < 0.2] = 127
            cur = rng.integers(0, 1 << 20, (300, r)).astype(np.int32)
            ts = torch.from_numpy(sel.astype(dtype)).to(card)
            tc = torch.from_numpy(cur).to(card)
            n0 = TS.selector_decode.launches
            got = TS.selector_decode(ts, tc)
            assert TS.selector_decode.launches == n0 + 1
            for x, y in zip(got, TS.selector_decode_plain(ts, tc)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_selector_decode_rows_match_plain(card, d):
    """Group ids into (G, D) / (G, R) tables: repeated and unordered ids,
    all-pad rows, runids >= R (no cursor, no count) and runid 127; 1,200
    rows (a row group per warp) and 40,000 (more than the card holds at
    once: four per warp)."""
    rng = np.random.default_rng(100 + d)
    g = 500
    for r, n in [(r, 1200) for r in sorted({1, min(d, 16), d // 4 or 1})] + [(min(d, 8), 40_000)]:
        for dtype in (np.uint8, np.int32):
            sel = rng.integers(0, r + 3, (g, d)) | (rng.integers(0, 2, (g, d)) << 7)
            sel[rng.random((g, d)) < 0.05] = 255
            sel[rng.random((g, d)) < 0.2] = 127
            sel[::9] = 127
            cur = rng.integers(0, 1 << 20, (g, r)).astype(np.int32)
            rows = np.concatenate([rng.integers(0, g, n - g), np.arange(g)[::-1]])
            ts = torch.from_numpy(sel.astype(dtype)).to(card)
            tc = torch.from_numpy(cur).to(card)
            tr = torch.from_numpy(rows.astype(np.int32)).to(card)
            n0 = TS.selector_decode.launches
            got = TS.selector_decode(ts, tc, rows=tr)
            assert TS.selector_decode.launches == n0 + 1
            for x, y in zip(got, TS.selector_decode_plain(ts, tc, rows=tr)):
                assert torch.equal(x, y)


def test_device_view_on_card_matches_cpu(card):
    """The same partition answered on the card (kernels) and on the CPU
    (plain versions), with one sync per batch on the card."""
    from repro_torch.db.partition import Partition, Table
    from repro_torch.kernels import device_view as DV

    rng = np.random.default_rng(3)
    domain = np.arange(1, 5000, dtype=np.uint64) * np.uint64(977)
    tables = []
    for i in range(4):
        keys = np.sort(rng.choice(domain, 1500, replace=False))
        exp = np.where(rng.random(1500) < 0.2, rng.choice([90, 110], 1500), 0)
        tables.append(dict(
            keys=keys, seq=(np.arange(1500) + i * 1500 + 1).astype(np.uint32),
            vals=rng.integers(0, 2**32, (1500, 4), dtype=np.uint64).astype(np.uint32),
            tomb=rng.random(1500) < 0.05, exp=exp.astype(np.uint32)))
    q = domain[rng.integers(0, len(domain), 256)]
    answers = []
    for dev in ("cpu", card):
        p = Partition(0, [Table(**t) for t in tables], d=32, device=dev)
        p.attach_excised(int(domain[100]), int(domain[300]), seq=10**6)
        mgr = DV.DeviceViewManager(1 << 30, device=dev)
        v = mgr.view_for(p)
        s0 = DV.SYNCS
        answers.append((mgr.get_batch(v, q, 100),
                        mgr.scan_windows(v, q[:64], 75, 100)))
        assert DV.SYNCS - s0 == 2
    (fa, va), rows_a = answers[0]
    (fb, vb), rows_b = answers[1]
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(va, vb)
    for (ka, xa), (kb, xb) in zip(rows_a, rows_b):
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(xa, xb)
