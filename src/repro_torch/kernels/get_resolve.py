"""Hopper kernel: the end of a batched device-view get, after the seek's
selector decode.

Replaces no TPU kernel. The JAX package composed a get from its two Pallas
kernels and left the rest to XLA (``src/repro/kernels/ops.py``: ``seek``'s
in-group lower bound, ``gather_view_live`` at width 1, ``get_live``'s key
compare), which fuses it. Run eagerly, that rest was ~150 PyTorch ops a
partition, a second ``selector_decode`` of each query's two window groups
among them, each a launch for a few hundred bytes; the host's enqueue cost
bounded a get. ``csrc/get_resolve.cu`` does it in one launch from the
decode's output and writes one packed int32 row a query (found, run, row,
then the VW value words), which the host fetches with one copy. Each query
is W lanes (D rounded up to a power of two, at most 32): the lower bound is
one ballot over the query's slots, the answer's slot follows without a
second decode (slot s of the decoded row, or slot 0 of the next group),
and the lanes copy its value words together.

The wrapper launches the kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it takes the plain version
beside it.
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as K
from repro_torch.core.query import first_ge_slot
from repro_torch.device import (
    check_launch, kernel_library, ordered, ordered_scalar, stream_ptr,
)
from repro_torch.kernels.selector_decode import selector_decode_plain


# queries, g, runid, absidx, newest, pad, keys, vals, tomb, exp, selectors, cursors
_DTYPES = (torch.int32, torch.int32, torch.int32, torch.int32, torch.bool, torch.bool,
           torch.int32, torch.int32, torch.bool, torch.int32, torch.uint8, torch.int32)


def _at(t: torch.Tensor, run: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``t[run, row]`` with both clamped into range, as ``RunSet.gather``."""
    return t[run.clamp(0, t.shape[0] - 1), row.clamp(0, t.shape[1] - 1)]


def get_resolve_plain(queries, g, runid, absidx, newest, pad, keys, vals, tomb,
                      exp, selectors, cursors, now: int) -> torch.Tensor:
    """The kernel's function in plain torch: the seek's lower bound in the
    decoded group, the slot at the resulting view position, its liveness at
    ``now`` and its key compare; returns (Q, 3 + VW) int32."""
    groups, d = selectors.shape
    n_slots = groups * d
    k = torch.where(pad[..., None], K.INF_WORD, _at(keys, runid, absidx))
    s = first_ge_slot(~K.key_lt(k, queries[:, None, :]), pad, d)
    pos = torch.clamp(g * d + s, max=n_slots)
    # past the group's last slot, the view's next slot is the next group's
    # head (the last group's own head at the end, as the window clamps)
    nxt = s == d
    head = selector_decode_plain(selectors, cursors,
                                 rows=torch.clamp(g + 1, max=groups - 1))
    col = s.clamp(max=d - 1).long()[:, None]
    run, row, nw, pd = (torch.where(nxt, h[:, 0], torch.gather(x, 1, col)[:, 0])
                        for x, h in zip((runid, absidx, newest, pad), head))
    ex = _at(exp, run, row)
    dead = _at(tomb, run, row) | ((ex != 0) & (ordered(ex) <= ordered_scalar(now)))
    valid = nw & ~pd & ~dead & (pos < n_slots)
    found = valid & K.key_eq(_at(keys, run, row), queries)
    return torch.cat([torch.stack([found.to(torch.int32), run, row], dim=1),
                      _at(vals, run, row)], dim=1)


def _check_out(out, q: int, width: int, dev) -> None:
    if (out.shape != (q, width) or out.dtype != torch.int32 or not out.is_contiguous()
            or out.device != dev):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device}, contiguous "
                         f"{out.is_contiguous()}: want ({q}, {width}) int32, contiguous, "
                         "on the queries' device")


def get_resolve(queries, g, runid, absidx, newest, pad, keys, vals, tomb, exp,
                selectors, cursors, now: int, out=None) -> torch.Tensor:
    """Resolve a batch of gets from the seek's decode → (Q, 3 + VW) int32:
    found (0/1), run, row (as the decode gives them, unclamped), then the
    slot's value words (for every query, found or not).

    ``queries`` (Q, KW) int32 words; ``g`` (Q,) int32 groups from
    ``anchor_search``; ``runid``, ``absidx``, ``newest``, ``pad`` (Q, D)
    from ``selector_decode(selectors, cursors, rows=g)``; ``keys`` (R, N,
    KW), ``vals`` (R, N, VW), ``tomb`` (R, N) bool and ``exp`` (R, N) int32
    words of a view; ``selectors`` (G, D) uint8, ``cursors`` (G, RC) int32;
    ``now`` the uint32 query-time clock. ``out``, where given, is the
    contiguous (Q, 3 + VW) int32 tensor the rows are written into (a slice
    of a larger buffer that one copy fetches); it is returned."""
    if out is not None:
        _check_out(out, queries.shape[0], 3 + vals.shape[-1], queries.device)
    if not queries.is_cuda:
        res = get_resolve_plain(queries, g, runid, absidx, newest, pad, keys, vals,
                                tomb, exp, selectors, cursors, now)
        return res if out is None else out.copy_(res)
    ts = (queries, g, runid, absidx, newest, pad, keys, vals, tomb, exp, selectors, cursors)
    dev = queries.device
    if any(t.device != dev or t.dtype != w or not t.is_contiguous() for t, w in zip(ts, _DTYPES)):
        raise ValueError(f"operands {[(t.dtype, str(t.device), t.is_contiguous()) for t in ts]}: "
                         f"want {list(_DTYPES)}, contiguous, on the queries' card")
    q, kw = queries.shape
    groups, d = selectors.shape
    r, nmax = tomb.shape
    vw = vals.shape[-1]
    if (g.shape != (q,) or any(x.shape != (q, d) for x in (runid, absidx, newest, pad))
            or keys.shape != (r, nmax, kw) or vals.shape != (r, nmax, vw)
            or exp.shape != (r, nmax) or cursors.dim() != 2 or cursors.shape[0] != groups):
        raise ValueError(
            f"shapes queries {tuple(queries.shape)} g {tuple(g.shape)} decode "
            f"{tuple(runid.shape)} keys {tuple(keys.shape)} vals {tuple(vals.shape)} "
            f"tomb {tuple(tomb.shape)} exp {tuple(exp.shape)} selectors "
            f"{tuple(selectors.shape)} cursors {tuple(cursors.shape)}: want (Q,KW) (Q,) "
            "(Q,D) (R,N,KW) (R,N,VW) (R,N) (R,N) (G,D) (G,RC)")
    if min(r, nmax, groups) == 0 or groups * d >= 2**31 or q * max(d, 3 + vw) >= 2**31:
        raise ValueError(f"G={groups} D={d} R={r} N={nmax} Q={q}: empty, or past the "
                         "kernel's int32 indexing")
    if not 0 <= now < 2**32:
        raise ValueError(f"now={now}: want a uint32 clock")
    if out is None:
        out = torch.empty((q, 3 + vw), dtype=torch.int32, device=dev)
    if q == 0:
        return out
    err = kernel_library().remix_get_resolve(
        *(t.data_ptr() for t in ts), out.data_ptr(),
        q, d, kw, vw, r, nmax, cursors.shape[1], groups, int(now), stream_ptr(queries),
    )
    check_launch(err, "get_resolve")
    get_resolve.launches += 1
    return out


get_resolve.launches = 0
