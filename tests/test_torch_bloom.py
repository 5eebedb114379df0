"""The port's bloom filters (``repro_torch.core.bloom``) and SSTable
metadata (``repro_torch.db.sstable``) against the JAX package's.

The bit arrays are equal bit for bit. The probes differ on purpose: the
reference's ``bloom_maybe_contains`` sums the bit position in uint32,
which wraps at 2**32, while its build sums in uint64; whenever ``nbits``
is not a power of two the two disagree and the reference's probe misses
keys its build inserted. The port probes with the build's non-wrapping
arithmetic and has no false negative. ``test_reference_probe_wraps``
keeps that divergence on record.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bloom as RB  # noqa: E402
from repro.db.sstable import SSTableMeta as RMeta  # noqa: E402
from repro_torch.core import bloom as TB  # noqa: E402
from repro_torch.db.sstable import SSTableMeta as TMeta  # noqa: E402
from repro_torch.device import as_words  # noqa: E402

CPU = "cpu"


def keysets(rng, sizes):
    return [np.unique(rng.integers(0, 2**64, n, dtype=np.uint64)).view(np.uint32)
            .reshape(-1, 2)[:, ::-1].copy() if n else np.zeros((0, 2), np.uint32)
            for n in sizes]


def test_mix_equal():
    rng = np.random.default_rng(0)
    for kw in (1, 2, 3):
        k = rng.integers(0, 2**32, (513, kw), dtype=np.uint64).astype(np.uint32)
        for a, b in zip(RB._mix(jnp.asarray(k)), TB._mix(as_words(k, CPU))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy().view(np.uint32))


@pytest.mark.parametrize("sizes,bits_per_key,nbits", [
    ((5000, 1234, 0), 10, 50_016),  # not a power of two
    ((4096, 17), 16, 65_536),  # a power of two
])
def test_build_bloom_bits_equal(sizes, bits_per_key, nbits):
    rng = np.random.default_rng(1)
    keys = keysets(rng, sizes)
    ref = RB.build_bloom(keys, bits_per_key=bits_per_key)
    port = TB.build_bloom(keys, bits_per_key=bits_per_key, device=CPU)
    assert ref.nbits == port.nbits == nbits and port.k == ref.k
    np.testing.assert_array_equal(np.asarray(ref.bits), port.bits.numpy().view(np.uint32))


@pytest.mark.parametrize("n,nbits", [(5000, 50_016), (4096, 65_536), (3, 64)])
def test_port_probe_has_no_false_negative(n, nbits):
    rng = np.random.default_rng(2)
    keys = keysets(rng, [n])
    bf = TB.build_bloom(keys, bits_per_key=max(1, nbits // n), device=CPU)
    assert bf.nbits == nbits
    maybe = TB.bloom_maybe_contains(bf, as_words(keys[0], CPU))
    assert maybe.shape == (len(keys[0]), 1)
    assert int((~maybe).sum()) == 0
    misses = keysets(np.random.default_rng(3), [4000])[0]
    rate = float(TB.bloom_maybe_contains(bf, as_words(misses, CPU)).float().mean())
    assert rate < 0.05 if nbits > 64 else rate <= 1.0


def test_reference_probe_wraps():
    """The divergence: at 5,000 keys and nbits = 50,016 the reference's
    probe misses keys its own build inserted; the port's misses none."""
    rng = np.random.default_rng(0)
    keys = keysets(rng, [5000])
    ref = RB.build_bloom(keys)
    assert ref.nbits == 50_016
    ref_fn = int((~np.asarray(RB.bloom_maybe_contains(ref, jnp.asarray(keys[0])))).sum())
    port = TB.build_bloom(keys, device=CPU)
    port_fn = int((~TB.bloom_maybe_contains(port, as_words(keys[0], CPU))).sum())
    assert ref_fn > 0 and port_fn == 0, (ref_fn, port_fn)


def test_probe_agrees_with_the_reference_at_a_power_of_two():
    """At a power-of-two nbits the uint32 sum wraps to the same position
    mod nbits, so the two probes answer alike, hits and misses."""
    rng = np.random.default_rng(4)
    keys = keysets(rng, [4096, 100])
    ref = RB.build_bloom(keys, bits_per_key=16)
    port = TB.build_bloom(keys, bits_per_key=16, device=CPU)
    assert ref.nbits == 65_536
    q = np.concatenate([keys[0][:500], keys[1], keysets(rng, [500])[0]])
    a = np.asarray(RB.bloom_maybe_contains(ref, jnp.asarray(q)))
    b = TB.bloom_maybe_contains(port, as_words(q, CPU)).numpy()
    np.testing.assert_array_equal(a, b)
    assert a[:500, 0].all() and a[500:600, 1].all()


@pytest.mark.parametrize("n,kv_bytes,with_bloom", [(10_000, 24, True), (777, 4096 + 1, True),
                                                     (0, 40, True), (300, 100, False)])
def test_sstable_meta_equal(n, kv_bytes, with_bloom):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.choice(2**40, n, replace=False).astype(np.uint64))
    a = RMeta.build(keys, kv_bytes, with_bloom=with_bloom)
    b = TMeta.build(keys, kv_bytes, with_bloom=with_bloom, device=CPU)
    np.testing.assert_array_equal(a.block_first_key, b.block_first_key)
    assert b.n == a.n
    assert b.index_bytes() == a.index_bytes() and b.bloom_bytes() == a.bloom_bytes()
    assert b.index_bytes(16, 8) == a.index_bytes(16, 8)
    if a.bloom is None:
        assert b.bloom is None
    else:
        assert b.bloom.nbits == a.bloom.nbits
        np.testing.assert_array_equal(np.asarray(a.bloom.bits),
                                      b.bloom.bits.numpy().view(np.uint32))
