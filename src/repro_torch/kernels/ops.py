"""Full REMIX operations composed from the kernels.

The kernels cover the anchor search and the selector occurrence decode;
the decode reads the group tables through group ids itself. A get on a
device view (``get_live_packed``) ends in a third kernel, ``get_resolve``,
which does everything after the seek's decode; elsewhere plain torch
indexing does the run gathers after the decode, as the JAX package left
them to XLA. Nothing here reads a value back to the host, so a batch on
the card runs with no synchronisation until its caller fetches the
result.
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as K
from repro_torch.core.query import first_ge_slot, window
from repro_torch.core.remix import Remix
from repro_torch.core.runs import RunSet
from repro_torch.device import ordered, ordered_scalar
from repro_torch.kernels.anchor_search import anchor_search
from repro_torch.kernels.get_resolve import get_resolve
from repro_torch.kernels.selector_decode import selector_decode


def seek(remix: Remix, runset: RunSet, queries: torch.Tensor) -> torch.Tensor:
    """Kernel-backed lower-bound seek; same contract as core.query.seek."""
    d = remix.d
    g = anchor_search(remix.anchors, queries)  # (Q,)
    runid, absidx, newest, pad = selector_decode(
        remix.selectors.reshape(remix.g, d), remix.cursors, rows=g
    )  # (Q, D)
    keys, _, _, _ = runset.gather(runid, absidx)
    keys = torch.where(pad[..., None], K.INF_WORD, keys)
    ge = ~K.key_lt(keys, queries[:, None, :])  # (Q, D)
    s = first_ge_slot(ge, pad, d)
    return torch.clamp(g * d + s, max=remix.n_slots)


def window_operands(remix: Remix, pos: torch.Tensor, width: int):
    """The ``ng`` groups covering each ``width`` window, as selector_decode
    takes them: (Q*ng,) int32 group ids, and each window's first group."""
    d = remix.d
    ng = (width + d - 1) // d + 1
    g0 = torch.clamp(pos // d, 0, remix.g - 1)
    gs = g0[:, None] + torch.arange(ng, dtype=torch.int32, device=pos.device)[None, :]
    return gs.clamp(0, remix.g - 1).reshape(-1), g0


def _decode_window(remix: Remix, runset: RunSet, pos: torch.Tensor, width: int):
    """Selector-decode the ``ng`` groups covering each ``width`` window and
    gather their rows; returns flat (Q, ng*D, ...) slot tensors + offsets."""
    d = remix.d
    q = pos.shape[0]
    ng = (width + d - 1) // d + 1
    rows, g0 = window_operands(remix, pos, width)
    runid, absidx, newest, pad = selector_decode(
        remix.selectors.reshape(remix.g, d), remix.cursors, rows=rows
    )
    keys, vals, _, tomb = runset.gather(runid, absidx)
    keys = torch.where(pad[..., None], K.INF_WORD, keys)

    def flat(x):
        return x.reshape((q, ng * d) + x.shape[2:])

    slots = dict(runid=runid, absidx=absidx, newest=newest, pad=pad,
                 keys=keys, vals=vals, tomb=tomb)
    return {k: flat(v) for k, v in slots.items()}, pos - g0 * d


def _in_view(remix: Remix, pos: torch.Tensor, width: int) -> torch.Tensor:
    gslot = pos[:, None] + torch.arange(width, dtype=torch.int32, device=pos.device)[None, :]
    return gslot < remix.n_slots


def gather_view(remix: Remix, runset: RunSet, pos: torch.Tensor, width: int):
    """Kernel-backed comparison-free range retrieval from view positions."""
    dec, off = _decode_window(remix, runset, pos, width)
    keys, vals = window(dec["keys"], off, width), window(dec["vals"], off, width)
    newest = window(dec["newest"], off, width)
    pad = window(dec["pad"], off, width)
    tomb = window(dec["tomb"], off, width)
    valid = newest & ~pad & ~tomb & _in_view(remix, pos, width)
    return keys, vals, valid


def scan(remix, runset, queries, width: int):
    pos = seek(remix, runset, queries)
    return (*gather_view(remix, runset, pos, width), pos)


def get(remix, runset, queries):
    pos = seek(remix, runset, queries)
    keys, vals, valid = gather_view(remix, runset, pos, 1)
    found = valid[:, 0] & K.key_eq(keys[:, 0], queries)
    return found, vals[:, 0]


# ---- device-resident live variants (kernels/device_view.py) ----
#
# Same pipeline, but liveness is *not* baked into the runset tombstones:
# per-row TTL expiry words ride along as an (R, Nmax) int32-word tensor and
# the window applies `tomb | (exp != 0 & exp <= now)` with `now` a host
# integer compared on the device — so a persistent device view never goes
# stale when the clock passes an expiry. The resolved (run, row)
# coordinates are returned alongside, as in the reference.


def gather_view_live(
    remix: Remix,
    runset: RunSet,
    exp: torch.Tensor,  # (R, Nmax) int32 words: TTL expiries (0 = none)
    pos: torch.Tensor,
    now: int,  # query-time clock, uint32 seconds
    width: int,
):
    """`gather_view` with query-time liveness + (run, row) emission."""
    dec, off = _decode_window(remix, runset, pos, width)
    runid, absidx = dec["runid"], dec["absidx"]
    # the expiry gather clamps exactly like RunSet.gather so pad slots stay benign
    ex = exp[runid.clamp(0, exp.shape[0] - 1), absidx.clamp(0, exp.shape[1] - 1)]
    dead = dec["tomb"] | ((ex != 0) & (ordered(ex) <= ordered_scalar(now)))
    keys, vals = window(dec["keys"], off, width), window(dec["vals"], off, width)
    newest = window(dec["newest"], off, width)
    pad = window(dec["pad"], off, width)
    dead = window(dead, off, width)
    runid, absidx = window(runid, off, width), window(absidx, off, width)
    valid = newest & ~pad & ~dead & _in_view(remix, pos, width)
    return keys, vals, valid, runid, absidx


def scan_live(remix, runset, exp, queries, now: int, width: int):
    pos = seek(remix, runset, queries)
    return (*gather_view_live(remix, runset, exp, pos, now, width), pos)


def get_live_packed(remix, runset, exp, queries, now: int, out=None) -> torch.Tensor:
    """``get_live`` as one (Q, 3 + VW) int32 tensor: found, run, row, then
    the value words; three launches (anchor_search, selector_decode,
    get_resolve), so that a caller fetches a batch with one copy. ``out``
    is get_resolve's: the caller's slice of a buffer that holds several
    views' rows, so that one copy fetches them all."""
    sel = remix.selectors.reshape(remix.g, remix.d)
    g = anchor_search(remix.anchors, queries)
    runid, absidx, newest, pad = selector_decode(sel, remix.cursors, rows=g)
    return get_resolve(queries, g, runid, absidx, newest, pad, runset.keys,
                       runset.vals, runset.tomb, exp, sel, remix.cursors, now, out=out)


def get_live(remix, runset, exp, queries, now: int):
    out = get_live_packed(remix, runset, exp, queries, now)
    return out[:, 0] != 0, out[:, 3:], out[:, 1], out[:, 2]
