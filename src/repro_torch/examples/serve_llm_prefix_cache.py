"""Serve a small LM with batched requests + the REMIX-indexed prefix cache.

Shows the paper's idea on the serving path: immutable KV-page generations
indexed by a REMIX give one-binary-search longest-prefix lookup; outputs are
identical with the cache on or off, only recomputation is removed.

    python -m repro_torch.examples.serve_llm_prefix_cache [--device cpu]

The port of ``examples/serve_llm_prefix_cache.py``, at its reduced
qwen2.5-3b widths, with params drawn from a seeded ``torch.Generator``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.models.kvcache import PrefixCache
from repro_torch.models.layers import split_params
from repro_torch.serve.engine import ServeEngine

ARCH = "qwen2.5-3b"
WIDTHS = dict(n_layers=4, d_model=256, d_ff=512, vocab=2048)
N_REQUESTS, SHARED, TAIL, MAX_NEW, MAX_SEQ = 6, 48, 12, 12, 128
N_PAGES, PAGE = 256, 16


def make_requests(vocab: int) -> list[np.ndarray]:
    """A shared system prompt + a distinct tail per request."""
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(0, vocab, SHARED).astype(np.int32)
    return [
        np.concatenate([system_prompt, rng.integers(0, vocab, TAIL).astype(np.int32)])
        for _ in range(N_REQUESTS)
    ]


def serve(cfg, pv, requests, device) -> dict:
    """Every request through an engine without and one with the prefix
    cache; raises if their outputs differ. Returns both outputs and the
    engines' counters."""
    print("== without prefix cache ==")
    eng = ServeEngine(cfg, pv, max_seq=MAX_SEQ, device=device)
    t0 = time.perf_counter()
    outs_plain = [eng.generate(r, max_new=MAX_NEW) for r in requests]
    t_plain = time.perf_counter() - t0
    print(f"  {len(requests)} requests in {t_plain:.2f}s "
          f"(prefill {eng.stats.prefill_tokens} tok)")

    print("== with REMIX prefix cache ==")
    cache = PrefixCache(cfg, n_pages=N_PAGES, page_size=PAGE, device=device)
    eng2 = ServeEngine(cfg, pv, max_seq=MAX_SEQ, prefix_cache=cache, device=device)
    t0 = time.perf_counter()
    outs_cached = [eng2.generate(r, max_new=MAX_NEW) for r in requests]
    t_cached = time.perf_counter() - t0
    print(f"  {len(requests)} requests in {t_cached:.2f}s "
          f"(prefill {eng2.stats.prefill_tokens} tok, "
          f"reused {eng2.stats.cached_tokens} tok, "
          f"page-table lookups {cache.table.lookups})")

    for a, b in zip(outs_plain, outs_cached):
        if not np.array_equal(a, b):
            raise AssertionError("prefix cache changed outputs!")
    print("outputs identical with and without the cache ✓")
    print(f"prefill tokens saved: "
          f"{eng.stats.prefill_tokens - eng2.stats.prefill_tokens}")
    return dict(plain=outs_plain, cached=outs_cached, stats=eng.stats,
                cached_stats=eng2.stats, lookups=cache.table.lookups,
                seconds=(t_plain, t_cached))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = resolve(ap.parse_args(argv).device)
    cfg = reduced(get_config(ARCH), **WIDTHS)
    gen = torch.Generator(device=device).manual_seed(0)
    pv, _ = split_params(M.init_params(cfg, gen, device=device))
    return serve(cfg, pv, make_requests(cfg.vocab), device)


if __name__ == "__main__":
    main()
