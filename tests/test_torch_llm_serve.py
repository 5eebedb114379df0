"""LLM serving: the REMIX page table, the prefix cache and ``ServeEngine``,
port against the JAX package.

The page table's answers are integers: equal bit for bit. Engines emit
token ids: equal token for token, on a ``dtype="float32"`` reduced
qwen2.5-3b fed the reference's params (greedy argmax over logits that
agree to ~1e-6; the cached pages round-trip bfloat16 → float16 →
bfloat16 the same way on both sides).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.models import kvcache as RK  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import kvcache as K  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from torch_lm import twin_configs, twin_params  # noqa: E402


def _fill(tables, rng, gens, per_gen=40, oracle=None):
    for _ in range(gens):
        for _ in range(per_gen):
            h = np.uint64(rng.integers(0, 2**63))
            slot, ln = int(rng.integers(0, 1000)), int(rng.integers(1, 100))
            for t in tables:
                t.add(h, slot, ln)
            if oracle is not None:
                oracle[int(h)] = (slot, ln)
        for t in tables:
            t.flush_generation()


@pytest.mark.parametrize("gens", [5, 12])
def test_remix_page_table_lookup(gens):
    """The reference's case (5 generations) and one past ``max_runs`` (12),
    whose tiered merges go through ``db.partition.merge_tables``."""
    ref, port = RK.RemixPageTable(d=8), K.RemixPageTable(d=8, device="cpu")
    oracle = {}
    rng = np.random.default_rng(5)
    _fill([ref, port], rng, 5, oracle=oracle)
    if gens > 5:  # overwrite some keys in later generations: newest wins
        keys = list(oracle)
        for g in range(gens - 5):
            for h in keys[g::7][:10]:
                slot = 2000 + g
                for t in (ref, port):
                    t.add(np.uint64(h), slot, 7)
                oracle[h] = (slot, 7)
            for t in (ref, port):
                t.flush_generation()
        assert len(port.runs) == len(ref.runs) < gens
    probes = list(oracle.keys())[::3] + [1, 2, 3]
    answers = [t.lookup_batch(np.array(probes, np.uint64)) for t in (ref, port)]
    for a, b in zip(*answers):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    found, slots, lens = answers[1]
    for i, h in enumerate(probes):
        if h in oracle:
            assert found[i] and (slots[i], lens[i]) == oracle[h]
        else:
            assert not found[i]
    assert port.lookups == ref.lookups == len(probes)


def test_chain_hash_and_empty_table():
    tok = np.random.default_rng(0).integers(0, 151936, 50).astype(np.int32)
    assert K.prefix_hash(tok) == RK.prefix_hash(tok)
    assert K.chain_hash(7, tok[:9]) == RK.chain_hash(7, tok[:9])
    for a, b in zip(K.RemixPageTable(device="cpu").lookup_batch(np.arange(3, dtype=np.uint64)),
                    RK.RemixPageTable().lookup_batch(np.arange(3, dtype=np.uint64))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_page_casts_match_the_reference():
    """bfloat16 → float16 (register) and float16 → float32 → bfloat16
    (reuse): the port's casts give the reference's bits, at normal,
    subnormal, overflowing and tiny values."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=4000), rng.normal(size=2000) * 1e-5,
                        [7e4, -1e5, 3e-8, 6e-8, 1e-9, 0.0, -0.0, 65504.0, 65520.0]]).astype(np.float32)
    bf = x.astype(ml_dtypes.bfloat16)
    ref16 = np.asarray(bf, np.float16)
    port16 = torch.as_tensor(x).bfloat16().to(torch.float16).numpy()
    assert np.array_equal(ref16.view(np.uint16), port16.view(np.uint16))
    back_ref = ref16.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)
    back_port = torch.as_tensor(port16).float().bfloat16().float().numpy()
    assert np.array_equal(back_ref.view(np.uint32), back_port.view(np.uint32))


def _prompts(vocab, rng, shared=24, tail=8, n=3):
    base = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([base, rng.integers(0, vocab, tail).astype(np.int32)])
            for _ in range(n)]


def _engines(n_pages=64, page_size=8, max_seq=96):
    """Reference and port engines, each with and without its prefix cache,
    on a float32 reduced qwen2.5-3b with the reference's params."""
    rcfg, tcfg = twin_configs("qwen2.5-3b", n_layers=2, d_model=128, d_ff=256,
                              vocab=64, dtype="float32")
    pv, tp = twin_params(rcfg, seed=2)
    rcache = RK.PrefixCache(rcfg, n_pages=n_pages, page_size=page_size)
    tcache = K.PrefixCache(tcfg, n_pages=n_pages, page_size=page_size, device="cpu")
    return dict(
        ref=RServeEngine(rcfg, pv, max_seq=max_seq),
        ref_cached=RServeEngine(rcfg, pv, max_seq=max_seq, prefix_cache=rcache),
        port=ServeEngine(tcfg, tp, max_seq=max_seq, device="cpu"),
        port_cached=ServeEngine(tcfg, tp, max_seq=max_seq, prefix_cache=tcache, device="cpu"),
    )


def test_serve_engine_matches_jax_token_for_token():
    engines = _engines()
    prompts = _prompts(64, np.random.default_rng(6))
    outs = {name: [e.generate(p, max_new=8) for p in prompts] for name, e in engines.items()}
    for name in ("ref_cached", "port", "port_cached"):
        for a, b in zip(outs["ref"], outs[name]):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    rc, pc = engines["ref_cached"].prefix, engines["port_cached"].prefix
    for name in ("port", "port_cached"):
        assert dataclasses.astuple(engines[name].stats) == dataclasses.astuple(
            engines["ref" + name[4:]].stats), name
    assert engines["port_cached"].stats.cached_tokens > 0
    assert (pc.hits, pc.misses, pc.next_slot, pc.table.lookups) == (
        rc.hits, rc.misses, rc.next_slot, rc.table.lookups)
    # the pools: the same pages in the same slots (float16 of the bfloat16
    # caches: an entry whose float32 inputs round to neighbouring bfloat16
    # values is one bfloat16 ulp apart, 2^-7 relative, and later positions
    # that attend to it shift by ~1e-4 absolute; |k|, |v| ~ 1)
    for a, b in ((pc.pool_k, rc.pool_k), (pc.pool_v, rc.pool_v)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7, atol=1e-3)


def test_serve_engine_prefix_cache_determinism():
    """The reference's case on the port alone, in bfloat16."""
    cfg = reduced(get_config("qwen2.5-3b"), n_layers=2, d_model=128, d_ff=256, vocab=64)
    pv = split_params(M.init_params(cfg, 2, device="cpu"))[0]
    prompts = _prompts(cfg.vocab, np.random.default_rng(6))
    plain = ServeEngine(cfg, pv, max_seq=96, device="cpu")
    outs_plain = [plain.generate(p, max_new=8) for p in prompts]
    cache = K.PrefixCache(cfg, n_pages=64, page_size=8, device="cpu")
    cached = ServeEngine(cfg, pv, max_seq=96, prefix_cache=cache, device="cpu")
    outs_cached = [cached.generate(p, max_new=8) for p in prompts]
    for a, b in zip(outs_plain, outs_cached):
        np.testing.assert_array_equal(a, b)
    assert cached.stats.cached_tokens > 0  # later prompts reused the prefix
    assert cache.hits >= 1


def test_fully_cached_prompt_is_served():
    """Reference defect (ROADMAP queue 3): a prompt whose every page is
    cached runs no prefill step, so ``generate`` indexes ``logits=None``
    and raises. The port prefills the last page again; its tokens equal
    the uncached engine's."""
    engines = _engines()
    prompt = _prompts(64, np.random.default_rng(7), shared=16, tail=8, n=1)[0]  # 3 pages
    first = engines["ref"].generate(prompt, max_new=4)
    engines["ref_cached"].generate(prompt, max_new=4)
    with pytest.raises(TypeError, match="not subscriptable"):
        engines["ref_cached"].generate(prompt, max_new=4)
    port = engines["port_cached"]
    assert np.array_equal(port.generate(prompt, max_new=4), first)
    assert np.array_equal(port.generate(prompt, max_new=4), first)
    # the second request reuses all but the last page
    assert port.stats.cached_tokens == len(prompt) - 8
    assert port.stats.prefill_tokens == len(prompt) + 8


def test_ring_wrap_leaves_stale_pages():
    """Reference defect (ROADMAP queue 3): ``PrefixCache._alloc`` reuses a
    slot without retiring the older generation's key for it, so after the
    ring wraps a prefix still matches its old slots, which now hold
    another sequence's pages. Both packages give the same stale answer."""
    rcfg, tcfg = twin_configs("qwen2.5-3b", n_layers=1, d_model=64, d_ff=128,
                              vocab=64, dtype="float32")
    ps, n_pages = 4, 2
    caches = dict(ref=RK.PrefixCache(rcfg, n_pages=n_pages, page_size=ps),
                  port=K.PrefixCache(tcfg, n_pages=n_pages, page_size=ps, device="cpu"))
    rng = np.random.default_rng(9)
    seq_a, seq_b = (rng.integers(0, 64, 2 * ps).astype(np.int32) for _ in range(2))
    shape = (tcfg.n_layers, 2 * ps, tcfg.n_kv_heads, tcfg.hd)
    kv_a, kv_b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    for name, c in caches.items():
        conv = (lambda a: a) if name == "ref" else torch.as_tensor
        c.register(seq_a, conv(kv_a), conv(kv_a))  # slots 0, 1
        c.register(seq_b, conv(kv_b), conv(kv_b))  # the ring wraps: slots 0, 1 again
    answers = {name: c.match(seq_a) for name, c in caches.items()}
    assert answers["port"] == answers["ref"] == (2 * ps, [0, 1])  # A still "matches"
    for name, c in caches.items():
        k, _ = c.gather(answers[name][1])
        k = np.asarray(k.numpy() if name == "port" else k, np.float32)
        assert np.array_equal(k, kv_b.astype(np.float16).astype(np.float32)), name
        assert not np.allclose(k, kv_a.astype(np.float16).astype(np.float32)), name
