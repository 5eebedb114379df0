"""The traffic generator: mixes as declared, the same seed the same
requests, and the scrambled zipfian spread over the key space."""
import json

import numpy as np
import pytest

from perfbench_tiny import ROOT, SCAN_MIX

from perfbench import traffic

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))
# mixes of cells a later PR may add as files, run by the tests here
TEST_MIXES = {"scan-insert": SCAN_MIX,
              "load": dict(clients=4, batch_ops=256, proportions=dict(insert=1.0),
                           request_distribution="uniform")}


def _stream(mix, seed=7, n_keys=4096, client=0):
    keys, _ = traffic.load_set(seed, n_keys, 4)
    return traffic.Traffic(mix, seed, keys, 4).client(client), keys


@pytest.mark.parametrize("name", MIXES + sorted(TEST_MIXES))
def test_mix_proportions_as_declared(name):
    if name in TEST_MIXES:
        mix = traffic.Mix(name, **TEST_MIXES[name])
    else:
        mix = traffic.Mix.from_file(ROOT / "perfbench" / "traffic" / f"{name}.json")
    s, _ = _stream(mix)
    kinds = np.concatenate([s.next().kinds for _ in range(max(1, 40_000 // mix.batch_ops))])
    n = len(kinds)
    for code, kind in enumerate(traffic.KINDS):
        p = mix.proportions.get(kind, 0.0)
        got = float((kinds == code).mean())
        # five standard deviations of a binomial share
        assert abs(got - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12, (kind, got, p)


def test_same_seed_same_requests_and_fresh_inserts():
    mix = traffic.Mix("m", 4, 64, {"read": 0.5, "insert": 0.3, "scan": 0.2})
    a, keys = _stream(mix, seed=2**40 + 3)
    b, _ = _stream(mix, seed=2**40 + 3)
    c, _ = _stream(mix, seed=2**40 + 4)
    ra = [a.next() for _ in range(20)]
    rb = [b.next() for _ in range(20)]
    rc = [c.next() for _ in range(20)]
    for x, y in zip(ra, rb):
        assert np.array_equal(x.keys, y.keys) and np.array_equal(x.vals, y.vals)
    assert not all(np.array_equal(x.keys, z.keys) for x, z in zip(ra, rc))
    ins = np.concatenate([r.keys[r.kinds == traffic.INSERT] for r in ra])
    assert len(np.unique(ins)) == len(ins)
    assert not np.isin(ins, keys).any()
    assert np.all(ins & np.uint64(7) == 1)  # client 0's tag
    reads = np.concatenate([r.keys[r.kinds != traffic.INSERT] for r in ra])
    assert np.isin(reads, keys).all()


def test_zipfian_is_skewed_and_scrambled():
    mix = traffic.Mix("m", 1, 4096, {"read": 1.0})
    s, keys = _stream(mix, n_keys=1 << 14)
    got = np.concatenate([s.next().keys for _ in range(8)])
    _, counts = np.unique(got, return_counts=True)
    assert counts.max() > 50 * np.median(counts)  # hot keys
    hot = np.sort(np.unique(got)[np.argsort(-counts)[:16]])
    # the hottest keys are spread, not neighbours in key order
    rank = np.searchsorted(np.sort(keys), hot)
    assert np.diff(rank).min() > 1


def test_mix_files_are_parameters_only():
    for name in MIXES:
        d = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
        traffic.Mix(name=name, **d)  # every key is a generator parameter
