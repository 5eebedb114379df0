"""Quickstart: build a REMIX over three sorted runs (the paper's Fig. 3)
and run seek / range-scan / point queries — batched, in torch.

    python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``; its three "expect" lines are
asserted here.
"""
import argparse

import numpy as np

from repro_torch.core import keys as K
from repro_torch.core import query as Q
from repro_torch.core.remix import build_remix
from repro_torch.core.runs import make_run
from repro_torch.device import as_words, resolve, u32_np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = resolve(ap.parse_args(argv).device)

    # the three sorted runs of Figure 3
    r0 = make_run(np.array([2, 11, 23, 71, 91], np.uint64), seq=0, device=device)
    r1 = make_run(np.array([6, 7, 17, 29, 73], np.uint64), seq=1, device=device)
    r2 = make_run(np.array([4, 31, 43, 52, 67], np.uint64), seq=2, device=device)

    remix, runset = build_remix([r0, r1, r2], d=4)
    print("anchor keys:", K.unpack_u64(u32_np(remix.anchors)))
    print("run selectors:", (remix.selectors.cpu().numpy() & 0x7F)[:15])
    print("cursor offsets:\n", remix.cursors.cpu().numpy())

    # seek 17 (the paper's worked example): lands on key 17 in run R1
    queries = as_words(K.pack_u64(np.array([17, 30, 100], np.uint64)), device)
    pos = Q.seek(remix, runset, queries)
    print("\nseek positions for [17, 30, 100]:", pos.cpu().numpy())

    # range scan: 6 keys from 17 — comparison-free next operations
    keys, vals, valid, _ = Q.scan(remix, runset, queries[:1], width=8)
    got = K.unpack_u64(u32_np(keys)[0][valid.cpu().numpy()[0]])
    print("scan(17, 6):", got[:6], "(expect 17 23 29 31 43 52)")
    if got[:6].tolist() != [17, 23, 29, 31, 43, 52]:
        raise AssertionError(f"scan(17, 6) returned {got[:6]}")

    # point queries without bloom filters
    found, vals = Q.get(remix, runset, queries)
    found = found.cpu().numpy()
    print("get [17, 30, 100]:", found, "(expect True False False)")
    if found.tolist() != [True, False, False]:
        raise AssertionError(f"get [17, 30, 100] found {found}")


if __name__ == "__main__":
    main()
