"""The port's I/O tier (``repro_torch.io``) against the JAX package's
(``repro.io``): the same seeded numpy inputs through both, on the CPU.

Every file either package writes — SSTables, CKBs, REMIX files, manifests
— must be byte-identical to the other's, and each package must read the
other's files back to equal arrays. Checksums, block-cache LRU order and
counters, and seeded fault plans must agree exactly (tolerance 0: all of
it is integer and byte data).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.io as RIO  # noqa: E402
import repro_torch.io as TIO  # noqa: E402
from repro.core.keys import pack_u64  # noqa: E402
from repro.db.partition import Table as RTable  # noqa: E402
from repro.io import checksum as RC  # noqa: E402
from repro_torch.db.partition import Table as TTable  # noqa: E402
from repro_torch.io import checksum as TC  # noqa: E402
from repro_torch.io import sstable as TSS  # noqa: E402

SECTIONS = ("keys", "vals", "seq", "tomb", "exp", "rtombs", "ckb")


def table_arrays(seed, n=3000, vw=3, ttl=True):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 40, n, replace=False)).astype(np.uint64)
    exp = np.zeros(n, np.uint32)
    if ttl:
        m = rng.random(n) < 0.2
        exp[m] = rng.integers(1, 2000, int(m.sum()))
    return dict(
        keys=pack_u64(keys),
        vals=rng.integers(0, 2**32, (n, vw), dtype=np.uint64).astype(np.uint32),
        seq=(np.arange(n) + 1).astype(np.uint32),
        tomb=rng.random(n) < 0.1,
        exp=exp,
    )


# ---- CRC32C ----

RFC3720 = [
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
]


@pytest.mark.parametrize("data,want", RFC3720)
def test_crc32c_rfc3720_vectors(data, want):
    assert TC.crc32c(data) == TC.crc32c_py(data) == want


# lengths around the vector path's threshold and a 64 KB granule
LENGTHS = [0, 1, 7, 8, 15, 16, 17, 1023, 1024, 1025, 1039, 1040, 1041,
           65535, 65536, 65537]


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32c_both_paths_match_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    want = RC.crc32c(data)
    assert want == RC.crc32c_py(data)
    assert TC.crc32c(data) == want
    assert TC.crc32c_py(data) == want
    cut = n // 3  # a continued CRC equals the whole one
    assert TC.crc32c(data[cut:], TC.crc32c(data[:cut])) == want


# ---- CKB ----

@pytest.mark.parametrize("n,interval", [(0, 16), (1, 16), (17, 16), (1000, 16),
                                        (1000, 1), (1000, 5)])
def test_encode_ckb_bytes_match(n, interval):
    keys = table_arrays(n, max(n, 1))["keys"][:n]
    assert TIO.encode_ckb(keys, interval) == RIO.encode_ckb(keys, interval)
    if n:
        np.testing.assert_array_equal(
            TIO.decode_ckb(TIO.encode_ckb(keys, interval)), keys)


def test_encode_ckb_shares_prefixes_like_reference():
    """Runs of keys with long shared prefixes, and three-word keys."""
    base = np.arange(500, dtype=np.uint32)
    for keys in (np.stack([base // 100, base // 10, base], 1),
                 np.stack([np.zeros(500, np.uint32), base * 65537], 1)):
        assert TIO.encode_ckb(keys) == RIO.encode_ckb(keys)


def test_ckb_reader_matches_reference():
    keys = table_arrays(3, 2000)["keys"]
    buf = RIO.encode_ckb(keys)
    r, t = RIO.CKBReader.from_bytes(buf), TIO.CKBReader.from_bytes(buf)
    rng = np.random.default_rng(4)
    for row in (0, 1, 15, 16, 17, 1999, *rng.integers(0, 2000, 20)):
        np.testing.assert_array_equal(r.key_at(int(row)), t.key_at(int(row)))
    u64 = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1]
    qs = np.concatenate([u64[rng.integers(0, 2000, 60)],
                         u64[rng.integers(0, 2000, 60)] + np.uint64(1),
                         np.array([0, u64[-1] + 1], np.uint64)])
    for q in qs[::7]:
        lo = int(rng.integers(0, 1990))
        hi = lo + int(rng.integers(1, 40))
        kq = pack_u64(q)
        assert r.seek(kq, lo, hi) == t.seek(kq, lo, hi)
        assert r.seek(kq) == t.seek(kq)
    los = rng.integers(0, 1900, len(qs))
    his = los + rng.integers(1, 100, len(qs))
    nr, nt = r.narrow_batch(qs, los, his), t.narrow_batch(qs, los, his)
    for a, b in zip(nr, nt):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r.seek_batch(qs, *nr), t.seek_batch(qs, *nt)):
        np.testing.assert_array_equal(a, b)


# ---- SSTables ----

def _write_both(tmp_path, arrs, with_ckb, ttl, rtombs):
    kw = dict(exp=arrs["exp"] if ttl else None,
              rtombs=[(5, 900, 7), (1 << 30, 1 << 31, 8)] if rtombs else None,
              with_ckb=with_ckb)
    a, b = str(tmp_path / "ref.sst"), str(tmp_path / "port.sst")
    args = (arrs["keys"], arrs["vals"], arrs["seq"], arrs["tomb"])
    na = RIO.write_sstable(a, *args, **kw)
    nb = TIO.write_sstable(b, *args, **kw)
    assert na == nb == os.path.getsize(b)
    return a, b


def _sections(rd):
    out = [rd.read_keys(), rd.read_vals(), rd.read_seq(), rd.read_tomb(),
           rd.read_exp(), np.asarray(rd.read_rtombs(), np.uint64).reshape(-1, 3)]
    ckb = rd.read_ckb_keys()
    return out + ([] if ckb is None else [ckb])


@pytest.mark.parametrize("with_ckb", [True, False])
@pytest.mark.parametrize("ttl", [True, False])
@pytest.mark.parametrize("rtombs", [True, False])
def test_sstable_bytes_match_and_cross_read(tmp_path, with_ckb, ttl, rtombs):
    arrs = table_arrays(5, 2500, ttl=ttl)
    a, b = _write_both(tmp_path, arrs, with_ckb, ttl, rtombs)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (a, b):  # each package reads the other's file
        for mode in ("copy", "mmap"):
            rr = RIO.SSTableReader(path, mode=mode)
            tr = TIO.SSTableReader(path, mode=mode)
            assert (rr.n, rr.kw, rr.vw, rr.flags, rr.n_blocks) == \
                   (tr.n, tr.kw, tr.vw, tr.flags, tr.n_blocks)
            for x, y in zip(_sections(rr), _sections(tr), strict=True):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            assert rr.bytes_read == tr.bytes_read
            assert rr.check_blocks() == tr.check_blocks() == []
            tr.verify()


def test_sstable_partial_reads_match(tmp_path):
    arrs = table_arrays(6, 4000)
    a, _ = _write_both(tmp_path, arrs, True, True, False)
    rr, tr = RIO.SSTableReader(a), TIO.SSTableReader(a)
    rng = np.random.default_rng(7)
    rows = np.concatenate([rng.integers(0, 4000, 300), [0, 3999, 3999]])
    for name in ("keys", "vals", "seq", "tomb", "exp"):
        np.testing.assert_array_equal(rr.section_rows_scattered(name, rows),
                                      tr.section_rows_scattered(name, rows))
        np.testing.assert_array_equal(rr.section_rows(name, 100, 2345),
                                      tr.section_rows(name, 100, 2345))
        assert list(rr.section_row_blocks(name, 7, 3000)) == \
               list(tr.section_row_blocks(name, 7, 3000))
    assert rr.bytes_read == tr.bytes_read
    assert rr.disk_bytes_read == tr.disk_bytes_read


def test_flipped_vals_byte_raises_only_when_its_granule_is_read(tmp_path):
    arrs = table_arrays(8, 20_000, vw=4)  # vals span several 64 KB granules
    a, b = _write_both(tmp_path, arrs, True, True, False)
    for path in (a, b):
        rd = TIO.SSTableReader(path)
        g = rd.section_block0("vals") + 2  # a granule inside the vals section
        TIO.flip_bytes(path, TSS._HEADER.size + g * rd.block_bytes + 100)
    for path in (a, b):
        for pkg, T in ((RIO, RTable), (TIO, TTable)):
            rd = pkg.SSTableReader(path)
            g = rd.section_block0("vals") + 2
            rows_per = rd.block_bytes // 16
            first = (g * rd.block_bytes - rd._section_range("vals")[0]
                     + TSS._HEADER.size) // 16 + 1
            # untouched granules (keys, and vals far from the flip) read fine
            rd.read_keys()
            rd.section_rows("vals", 0, 10)
            with pytest.raises(pkg.CorruptionError) as e:
                rd.section_rows("vals", first, first + rows_per // 2)
            assert e.value.section == "vals" and e.value.block == g
            assert rd.check_blocks() == [g]
            t = T.from_file(path)
            t.keys  # noqa: B018 - reads only the keys section
            with pytest.raises(pkg.CorruptionError):
                t.vals  # noqa: B018


# ---- REMIX files ----

def _remix_pair(seed):
    from repro.core.remix import build_remix as rbuild
    from repro.core.runs import make_run as rmake
    from repro_torch.core.remix import build_remix as tbuild
    from repro_torch.core.runs import make_run as tmake

    rng = np.random.default_rng(seed)
    domain = np.arange(1, 3000, dtype=np.uint64) * np.uint64(13)
    data = [(np.sort(rng.choice(domain, 700, replace=False)),
             (np.arange(700) + 700 * i + 1).astype(np.uint32)) for i in range(3)]
    rr, _ = rbuild([rmake(k, seq=s, sort=False) for k, s in data], d=16)
    tr, _ = tbuild([tmake(k, seq=s, sort=False, device="cpu") for k, s in data], d=16)
    return rr, tr


def test_remix_files_match_and_cross_load(tmp_path):
    rr, tr = _remix_pair(9)
    a, b = str(tmp_path / "ref.rmx"), str(tmp_path / "port.rmx")
    assert RIO.dump_remix(rr, a) == TIO.dump_remix(tr, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (a, b):
        ref = RIO.load_remix(path)
        port = TIO.load_remix(path, device="cpu")
        np.testing.assert_array_equal(np.asarray(ref.anchors),
                                      port.anchors.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(ref.cursors), port.cursors.numpy())
        np.testing.assert_array_equal(np.asarray(ref.selectors), port.selectors.numpy())
        assert (int(ref.n_entries), ref.d) == (port.n_entries, port.d)
        assert port.storage_bytes() == ref.storage_bytes()
    from repro.io.remix_io import check_remix as rcheck
    from repro_torch.io.remix_io import check_remix as tcheck

    assert rcheck(a) == tcheck(b) == os.path.getsize(a)
    TIO.flip_bytes(b, os.path.getsize(b) - 10)
    with pytest.raises(TIO.CorruptionError):
        TIO.load_remix(b, device="cpu")
    with pytest.raises(TIO.CorruptionError):
        tcheck(b)


# ---- manifest / storage ----

def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_storage_commit_and_load_match(tmp_path):
    rr, tr = _remix_pair(10)
    arrs = table_arrays(11, 500)
    args = (arrs["keys"], arrs["vals"], arrs["seq"], arrs["tomb"])
    states = []
    for pkg, remix, root in ((RIO, rr, tmp_path / "ref"), (TIO, tr, tmp_path / "port")):
        st = pkg.Storage(str(root))
        t1 = st.write_table(*args, exp=arrs["exp"], rtombs=[(1, 2, 3)])
        t2 = st.write_table(*args)
        x = st.write_remix(remix)
        st.commit({"partitions": [{"lo": 0, "tables": [t1], "remix": x}]})
        st.commit({"partitions": [{"lo": 0, "tables": [t1, t2], "remix": x}], "seq": 9})
        orphan = st.write_table(*args)  # written, never committed
        states.append((st.load_state(), st.manifest.verify(), orphan, st.bytes_written))
        from repro_torch.io.manifest import live_files

        assert st.gc_orphans(live_files(states[-1][0])) == [orphan]
    assert states[0] == states[1]
    assert _tree(tmp_path / "ref") == _tree(tmp_path / "port")
    assert TIO.Storage(str(tmp_path / "ref")).load_state() == states[0][0]
    assert RIO.Storage(str(tmp_path / "port")).load_state() == states[1][0]


# ---- block cache ----

def test_block_cache_lru_and_counters_match():
    rng = np.random.default_rng(12)
    caches = (RIO.BlockCache(10_000), TIO.BlockCache(10_000))
    for step in range(400):
        key = ("f", int(rng.integers(0, 12)))
        op = rng.integers(0, 4)
        size = int(rng.integers(100, 3000))
        res = []
        for c in caches:
            if op == 0:
                res.append(c.get(key))
            elif op == 1:
                c.put(key, bytes(size))
            elif op == 2:
                c.prefetch(key, lambda: bytes(size))
            else:
                res.append(c.get_or_load(key, lambda: bytes(size)))
            res.append(c.contains(("f", 3)))
        assert res[: len(res) // 2] == res[len(res) // 2:]
        assert caches[0].stats() == caches[1].stats()
        assert list(caches[0]._blocks) == list(caches[1]._blocks)
    assert caches[1].stats()["evictions"] > 0 and caches[1].stats()["hits"] > 0
    for c in caches:
        c.clear()
    assert caches[0].stats() == caches[1].stats()


# ---- fault injection ----

def test_fault_plans_with_one_seed_agree(tmp_path):
    arrs = table_arrays(13, 6000)
    a, _ = _write_both(tmp_path, arrs, True, True, False)
    outcomes = []
    for pkg in (RIO, TIO):
        plan = (pkg.FaultPlan(seed=5).transient_read("ref.sst", count=3)
                .bitflip("ref.sst")  # seeded placement: lands in the header
                .bitflip("ref.sst", offset=200_000, nbytes=3))
        retries = []
        ctx = pkg.IOContext(plan, retries=1, on_retry=lambda: retries.append(1))
        got = []
        for i in range(3):
            try:
                rd = pkg.SSTableReader(a, io=ctx)
                got.append(("open", i))
                rd.verify()
                got.append(("verified", i))
            except pkg.TransientIOError as e:
                got.append(("transient", e.site))
            except pkg.CorruptionError as e:
                got.append(("corrupt", e.section, e.block))
        outcomes.append((got, plan.stats(), len(retries),
                         [r.offset for r in plan._rules]))
    assert outcomes[0] == outcomes[1]
    assert any(g[0] == "corrupt" for g in outcomes[1][0])
    assert outcomes[1][1]["transient_read"] == 3


@pytest.mark.parametrize("keep", [0.0, 0.5, 0.9])
def test_torn_writes_and_fsync_faults_agree(tmp_path, keep):
    arrs = table_arrays(14, 300)
    args = (arrs["keys"], arrs["vals"], arrs["seq"], arrs["tomb"])
    sizes = []
    for name, pkg in (("r.sst", RIO), ("t.sst", TIO)):
        plan = pkg.FaultPlan(seed=1).torn_write(name, keep=keep).fail_fsync(name)
        path = str(tmp_path / name)
        with pytest.raises(OSError):
            pkg.write_sstable(path, *args, io=pkg.IOContext(plan))
        pkg.write_sstable(path, *args, io=pkg.IOContext(plan))  # fsync heals
        sizes.append((os.path.getsize(path), plan.stats()))
    assert sizes[0] == sizes[1]


# ---- file-backed tables ----

def test_file_backed_table_matches_reference(tmp_path):
    arrs = table_arrays(15, 5000)
    path, _ = _write_both(tmp_path, arrs, True, True, False)
    cache_r, cache_t = RIO.BlockCache(1 << 18), TIO.BlockCache(1 << 18)
    r, t = RTable.from_file(path), TTable.from_file(path)
    assert repr(t) == repr(r) and not t.resident
    r.attach_cache(cache_r)
    t.attach_cache(cache_t)
    assert (r.n, r.vw, r.ttl_present()) == (t.n, t.vw, t.ttl_present())
    assert t._rd().bytes_read == dict.fromkeys(SECTIONS, 0)  # header only
    rng = np.random.default_rng(16)
    rows = rng.integers(0, 5000, 400)
    for name in ("keys", "vals", "seq", "tomb", "exp"):
        np.testing.assert_array_equal(r.rows_scattered(name, rows),
                                      t.rows_scattered(name, rows))
        np.testing.assert_array_equal(r.rows(name, 17, 3100), t.rows(name, 17, 3100))
    np.testing.assert_array_equal(r.keys_u64_rows(rows), t.keys_u64_rows(rows))
    np.testing.assert_array_equal(r.dead_rows(10, 900, now=1000),
                                  t.dead_rows(10, 900, now=1000))
    np.testing.assert_array_equal(r.dead_rows_scattered(rows, now=1000),
                                  t.dead_rows_scattered(rows, now=1000))
    for row in (0, 1, 4999, 1234):
        np.testing.assert_array_equal(r.key_at(row), t.key_at(row))
    u64 = r.keys_u64_rows(np.arange(5000))
    np.testing.assert_array_equal(u64, t.keys_u64_rows(np.arange(5000)))
    qs = np.concatenate([u64[rows[:50]], u64[rows[50:100]] + np.uint64(1)])
    los = np.maximum(rows[:100] - 40, 0)
    his = np.minimum(rows[:100] + 40, 5000)
    for kw in ({}, {"return_keys": True}):
        for a, b in zip(np.atleast_2d(r.seek_rows_batch(qs, los, his, **kw)),
                        np.atleast_2d(t.seek_rows_batch(qs, los, his, **kw))):
            np.testing.assert_array_equal(a, b)
    for q, lo, hi in zip(qs[:10], los[:10], his[:10]):
        assert r.seek_row(pack_u64(q), lo, hi) == t.seek_row(pack_u64(q), lo, hi)
    assert list(r.row_block_ids("vals", 3, 4000)) == list(t.row_block_ids("vals", 3, 4000))
    assert cache_r.stats() == cache_t.stats()
    assert r._rd().bytes_read == t._rd().bytes_read
    assert t._rd().bytes_read["vals"] > 0 and not t.resident
    for name in ("keys", "vals", "seq", "tomb", "exp"):
        np.testing.assert_array_equal(getattr(r, name), getattr(t, name))
    np.testing.assert_array_equal(r.key_words(), t.key_words())
    np.testing.assert_array_equal(r.dead(1000), t.dead(1000))
    assert r.min_future_exp(1000) == t.min_future_exp(1000)
    assert r.bytes() == t.bytes() and t.resident and repr(t) == repr(r)


def test_port_io_imports_without_jax():
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch.io, repro_torch.db.partition\n"
            "print(sorted(m for m in sys.modules if m.startswith('repro.')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.path.join(root, "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("entry", ["load_remix", "max_key"])
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, entry):
    """``load_remix`` and ``max_key`` run on the card unless asked for the
    CPU, and raise where there is none."""
    from repro_torch.core.keys import max_key

    path = str(tmp_path / "x.rmx")
    TIO.dump_remix(_remix_pair(17)[1], path)
    call = {"load_remix": lambda **kw: TIO.load_remix(path, **kw),
            "max_key": lambda **kw: max_key(2, **kw)}[entry]
    assert call(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
