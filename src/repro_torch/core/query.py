"""Batched REMIX query engine — plain PyTorch implementation.

All operations are vectorized over a query batch (Q,). The "iterator" of the
paper becomes an integer *view position*: because the sorted view is
persisted, any position can be decoded to (run, in-run index) with the
group's cursor offsets + selector occurrence counts, so `next` is position+1
— comparison-free, exactly the paper's claim, and gather-friendly on a GPU.

Two in-group search modes (paper §3.2 / Fig 11 "full" vs "partial"):
  - ``vector``: decode all D slots, compare in parallel;
  - ``binary``: sequential log2(D) probes, each decoding one slot via
    occurrence counting (the paper's CPU-oriented full binary search).

Queries are (Q, KW) int32 word tensors on the index's device; nothing here
reads a value back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as K
from repro_torch.core.remix import Remix
from repro_torch.core.runs import RunSet
from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def decode_groups(remix: Remix, runset: RunSet, g: torch.Tensor):
    """Decode whole groups. ``g``: any int shape (clamped to valid range).

    Returns dict of per-slot tensors with shape g.shape + (D,):
      runid, absidx, newest, pad, keys (.. + (KW,)), vals, seq, tomb.
    """
    d, r = remix.d, remix.r
    g = g.clamp(0, remix.g - 1)
    sels = remix.selectors.reshape(remix.g, d)[g].to(torch.int32)  # (..,D)
    pad = sels == PLACEHOLDER
    newest = (sels & NEWEST_BIT) != 0
    runid = torch.where(pad, 0, sels & 0x7F)
    onehot = (runid[..., None] == _arange(r, g)) & ~pad[..., None]
    onehot = onehot.to(torch.int32)  # (.., D, R)
    occ = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
    occ = (occ * onehot).sum(dim=-1, dtype=torch.int32)  # own-run occurrence
    base = torch.gather(remix.cursors[g], -1, runid.long())  # (.., D)
    absidx = base + occ
    keys, vals, seq, tomb = runset.gather(runid, absidx)
    keys = torch.where(pad[..., None], K.INF_WORD, keys)
    return dict(
        runid=runid, absidx=absidx, newest=newest & ~pad, pad=pad,
        keys=keys, vals=vals, seq=seq, tomb=tomb & ~pad,
    )


def first_ge_slot(ge: torch.Tensor, pad: torch.Tensor, d: int) -> torch.Tensor:
    """In-group lower bound from a (Q, D) ``key >= query`` mask.

    The first slot with ``ge`` (``argmax`` takes the first maximum; a bool
    mask is cast to uint8 since torch's ``argmax`` refuses bool), D when
    no slot qualifies, and D when it lands on a placeholder: the true
    lower bound is then the next group's head."""
    s = torch.argmax(ge.to(torch.uint8), dim=1).to(torch.int32)
    s = torch.where(ge.any(dim=1), s, d)
    is_pad = torch.gather(pad, 1, s.clamp(0, d - 1).long()[:, None])[:, 0]
    return torch.where((s < d) & is_pad, d, s)


def _ingroup_vector(remix, runset, g, queries):
    """First slot in group g with key >= query, all-D parallel compare."""
    dec = decode_groups(remix, runset, g)  # (Q, D, ..)
    ge = ~K.key_lt(dec["keys"], queries[:, None, :])  # (Q, D)
    return first_ge_slot(ge, dec["pad"], remix.d)


def _decode_one_slot(
    remix: Remix, runset: RunSet, g: torch.Tensor, j: torch.Tensor, full=False
):
    """Decode slot j of group g via §3.2 occurrence counting. g,j: (Q,)."""
    d = remix.d
    g = g.clamp(0, remix.g - 1)
    sels = remix.selectors.reshape(remix.g, d)[g].to(torch.int32)  # (Q,D)
    pad = sels == PLACEHOLDER
    sel_j = torch.gather(sels, 1, j.long()[:, None])[:, 0]
    pad_j = sel_j == PLACEHOLDER
    run_j = torch.where(pad_j, 0, sel_j & 0x7F)
    before = _arange(d, g)[None, :] < j[:, None]
    occ = (
        ((sels & 0x7F) == run_j[:, None]) & ~pad & before
    ).sum(dim=1, dtype=torch.int32)
    base = torch.gather(remix.cursors[g], 1, run_j.long()[:, None])[:, 0]
    keys, vals, seq, tomb = runset.gather(run_j, base + occ)
    keys = torch.where(pad_j[:, None], K.INF_WORD, keys)
    if full:
        newest = ((sel_j & NEWEST_BIT) != 0) & ~pad_j
        return keys, vals, newest, tomb & ~pad_j, pad_j
    return keys, pad_j


def _ingroup_binary(remix, runset, g, queries):
    """Paper-faithful in-group binary search (log2 D sequential probes)."""
    d = remix.d
    q = queries.shape[0]
    lo = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    hi = torch.full((q,), d, dtype=torch.int32, device=queries.device)
    for _ in range(max(1, d.bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid, _ = _decode_one_slot(remix, runset, g, mid.clamp(0, d - 1))
        go_right = K.key_lt(kmid, queries)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    # placeholder landing → next group
    _, pad_j = _decode_one_slot(remix, runset, g, lo.clamp(0, d - 1))
    return torch.where((lo < d) & pad_j, d, lo)


def seek(remix: Remix, runset: RunSet, queries: torch.Tensor,
         ingroup: str = "vector") -> torch.Tensor:
    """Lower-bound view positions for ``queries`` (Q, KW) → (Q,) int32.

    One binary search on the anchors + one in-group search — the paper's
    seek. Returned positions may be ``n_slots`` (end) or point at the head
    of the next group when a group's keys are all smaller.
    """
    g = K.upper_bound(remix.anchors, queries) - 1
    g = g.clamp(0, remix.g - 1)
    if ingroup == "vector":
        s = _ingroup_vector(remix, runset, g, queries)
    elif ingroup == "binary":
        s = _ingroup_binary(remix, runset, g, queries)
    else:
        raise ValueError(f"unknown ingroup mode {ingroup!r}")
    return torch.clamp(g * remix.d + s, max=remix.n_slots)


def scan(
    remix: Remix,
    runset: RunSet,
    queries: torch.Tensor,
    width: int,
    ingroup: str = "vector",
    with_vals: bool = True,
):
    """Seek + retrieve ``width`` consecutive view slots per query.

    Returns (keys (Q,W,KW), vals (Q,W,VW), valid (Q,W), pos (Q,)). ``valid``
    masks placeholders, old versions, tombstones and end-of-view; the next
    operation itself performs **no key comparisons** — it is a pure decode
    of the persisted selectors (paper §3.3). ``with_vals=False`` returns
    None for vals.
    """
    pos = seek(remix, runset, queries, ingroup=ingroup)
    keys, vals, valid = gather_view(remix, runset, pos, width)
    return keys, (vals if with_vals else None), valid, pos


def window(x: torch.Tensor, off: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row slice ``x[i, off[i] : off[i] + width]`` of a (Q, S, ...) tensor.

    The counterpart of a vmapped ``dynamic_slice_in_dim``, written as a
    gather. Callers guarantee ``off + width <= S`` (``off <= D`` and the
    decoded span is ``ng * D >= width + D``), so nothing is clamped."""
    q = x.shape[0]
    cols = off.long()[:, None] + torch.arange(width, device=x.device)[None, :]
    rows = torch.arange(q, device=x.device)[:, None]
    return x[rows, cols]


def gather_view(remix: Remix, runset: RunSet, pos: torch.Tensor, width: int):
    """Decode ``width`` view slots starting at each ``pos`` (comparison-free).

    The cursor window primitive: ``pos`` may come from :func:`seek` *or*
    from a previous window's ``pos + width``. Slots past ``n_slots`` (or in
    padded groups) simply decode as invalid."""
    d = remix.d
    q = pos.shape[0]
    ng = (width + d - 1) // d + 1
    g0 = torch.clamp(pos // d, 0, remix.g - 1)
    gs = g0[:, None] + _arange(ng, pos)[None, :]  # (Q, NG)
    dec = decode_groups(remix, runset, gs)  # (Q, NG, D, ..)

    def flat(x):
        return x.reshape((q, ng * d) + x.shape[3:])

    off = pos - g0 * d  # 0 <= off <= D (off==D when pos is next-group head)
    keys = window(flat(dec["keys"]), off, width)
    vals = window(flat(dec["vals"]), off, width)
    newest = window(flat(dec["newest"]), off, width)
    pad = window(flat(dec["pad"]), off, width)
    tomb = window(flat(dec["tomb"]), off, width)
    gslot = pos[:, None] + _arange(width, pos)[None, :]
    in_view = gslot < torch.clamp((g0 + ng) * d, max=remix.n_slots)[:, None]
    valid = newest & ~pad & ~tomb & in_view
    return keys, vals, valid


def get(remix: Remix, runset: RunSet, queries: torch.Tensor,
        ingroup: str = "vector"):
    """Point query: seek + single-slot decode (no bloom filters, paper §4).

    Returns (found (Q,), vals (Q,VW)).
    """
    pos = seek(remix, runset, queries, ingroup=ingroup)
    d = remix.d
    g, j = pos // d, pos % d
    keys, vals, newest, tomb, pad_j = _decode_one_slot(
        remix, runset, g, j, full=True
    )
    found = (
        (pos < remix.n_slots) & newest & ~tomb & K.key_eq(keys, queries)
    )
    return found, vals
