"""The reference against the store, and the reference's rules for
concurrent writes."""
import numpy as np

from perfbench_tiny import ROOT, TINY  # noqa: F401

from perfbench import traffic
from perfbench.reference.model import INF, Model
from perfbench.reference.store import ReferenceStore
from perfbench.spec import Bench
from perfbench.system import ProgramSystem


def _program(tmp_path, config="remixdb-kv120"):
    bench = Bench(ROOT)
    cfg = bench.config(dict(config=config))
    cfg["system"].update(TINY["system"])
    return ProgramSystem(cfg, str(tmp_path), "cpu"), int(cfg["system"]["vw"])


def test_reference_store_answers_like_the_program(tmp_path):
    """One client, requests in order: the program and the reference store
    (at full precision) give the same answers, reads, scans and writes."""
    prog, vw = _program(tmp_path)
    keys, vals = traffic.load_set(11, 3000, vw)
    prog.load(keys, vals)
    ref = ReferenceStore(keys, vals, value_bits=32)
    mix = traffic.Mix("m", 1, 32, {"read": 0.4, "update": 0.2, "insert": 0.2,
                                   "scan": 0.1, "rmw": 0.1})
    s = traffic.Traffic(mix, 11, keys, vw).client(0)
    try:
        for _ in range(40):
            req = s.next()
            got = prog.normalize(req, prog.submit(req).result())
            want = ref.apply(req)
            assert got["ok"].all()
            assert np.array_equal(got["found"], want["found"])
            assert np.array_equal(got["vals"], want["vals"])
            assert got["scans"].keys() == want["scans"].keys()
            for i, (k, v) in want["scans"].items():
                assert np.array_equal(got["scans"][i][0], k)
                assert np.array_equal(got["scans"][i][1], v)
        probe = np.concatenate([keys[:100], np.array(sorted(ref.extra), np.uint64)])
        f, v = prog.readback(probe)
        for i, k in enumerate(probe.tolist()):
            r = ref._get(k)
            assert f[i] == (r is not None)
            if r is not None:
                assert np.array_equal(v[i], r)
    finally:
        prog.close()


def test_model_brackets_concurrent_writes():
    keys = np.array([8, 16, 24], np.uint64)
    vals = np.arange(3, dtype=np.uint32).reshape(3, 1)
    m = Model(keys, vals)
    a, b = np.array([7], np.uint32), np.array([9], np.uint32)
    m.write(16, a, 1.0, 2.0, 0, 0, 0)  # client 0 updates 16 during [1, 2]
    m.write(40, b, 3.0, 4.0, 1, 5, 2)  # client 1 inserts 40 during [3, 4]
    # before the update was sent: the loaded value only
    assert m.value_ok(16, vals[1], 0.0, 0.5) and not m.value_ok(16, a, 0.0, 0.5)
    # overlapping it: either
    assert m.value_ok(16, vals[1], 1.5, 2.5) and m.value_ok(16, a, 1.5, 2.5)
    # after its acknowledgement: the new value only
    assert m.value_ok(16, a, 2.5, 3.0) and not m.value_ok(16, vals[1], 2.5, 3.0)
    # an insert is absent before it was sent, present after it came back
    assert m.value_ok(40, None, 0.0, 2.9) and not m.value_ok(40, b, 0.0, 2.9)
    assert not m.value_ok(40, None, 4.5, 5.0) and m.value_ok(40, b, INF, INF)
    # the writing request's own later op sees it, its earlier op does not
    assert m.value_ok(40, b, 3.0, 4.0, 1, 5, 3) and not m.value_ok(40, None, 3.0, 4.0, 1, 5, 3)
    assert m.value_ok(40, None, 3.0, 4.0, 1, 5, 1) and not m.value_ok(40, b, 3.0, 4.0, 1, 5, 1)
    # scans: a skipped loaded key, a skipped acknowledged insert, a short answer
    k = np.array([8, 16, 24, 40], np.uint64)
    v = np.array([[0], [7], [2], [9]], np.uint32)
    assert m.scan_ok(0, 4, k, v, 5.0, 6.0)
    assert not m.scan_ok(0, 4, k[[0, 2, 3]], v[[0, 2, 3]], 5.0, 6.0)
    assert not m.scan_ok(0, 4, k[:3], v[:3], 5.0, 6.0)
    assert m.scan_ok(0, 4, k[:3], v[:3], 0.0, 2.9)
    assert not m.scan_ok(0, 4, k, v, 0.0, 2.9)  # 40 before it was sent
    assert m.scan_ok(17, 2, k[2:], v[2:], 5.0, 6.0)
    assert not m.scan_ok(17, 2, k[[3, 2]], v[[3, 2]], 5.0, 6.0)  # order
