"""Hopper kernel: in-group run-selector decode (paper §3.2).

Replaces the Pallas TPU kernel ``src/repro/kernels/selector_decode.py``:
``selector_decode`` (body ``_decode_kernel``). For rows of selectors and
the cursor offsets at their group heads it returns each slot's run, its
absolute in-run index (the cursor plus the slot's exclusive occurrence
count of its own run), and the newest and placeholder flags.

The TPU kernel unrolled a one-hot over R with a prefix sum along the lanes,
and its callers copied each query's groups into (Q, D) and (Q, R) tiles
first, because a ``BlockSpec`` cannot gather rows. On the H100 the decode
is bound by bytes (a row id, D selector bytes and R cursor words in, ten
bytes per slot out), so ``csrc/selector_decode.cu`` gives each row to a
warp: the same-run count is one ``__match_any_sync`` and a ``__popc`` per
slot, the row's cursor words are loaded once and shuffled to the slots
that need them, and with ``rows`` the kernel reads the group tables
through the row ids itself, so no gather runs before it. Where the rows
outnumber the warps the card holds at once, each warp decodes four row
groups with all their loads in flight together.

The wrapper launches the kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it takes the plain version
beside it.
"""
from __future__ import annotations

import torch

from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER
from repro_torch.device import check_launch, kernel_library, sm_count, stream_ptr


def selector_decode_plain(selectors: torch.Tensor, cursors: torch.Tensor,
                          rows: torch.Tensor | None = None):
    """The kernel's function in plain torch: gather the rows, then a
    one-hot over R + prefix count.

    A runid >= R gets no cursor and no count, as in the TPU kernel."""
    if rows is not None:
        idx = rows.long()
        selectors, cursors = selectors[idx], cursors[idx]
    r = cursors.shape[1]
    sel = selectors.to(torch.int32)  # (Q, D)
    pad = sel == PLACEHOLDER
    newest = (sel & NEWEST_BIT) != 0
    runid = torch.where(pad, 0, sel & 0x7F)
    hit = (runid[..., None] == torch.arange(r, device=sel.device)) & ~pad[..., None]
    hit = hit.to(torch.int32)  # (Q, D, R)
    occ = ((torch.cumsum(hit, dim=1, dtype=torch.int32) - hit) * hit).sum(
        dim=-1, dtype=torch.int32
    )
    base = torch.gather(cursors.to(torch.int32), 1, runid.clamp(max=r - 1).long())
    base = torch.where(runid < r, base, 0)
    return runid, base + occ, newest, pad


def selector_decode(selectors: torch.Tensor, cursors: torch.Tensor,
                    rows: torch.Tensor | None = None):
    """Decode selector rows → (runid (N,D) int32, absidx (N,D) int32,
    newest (N,D) bool, pad (N,D) bool). Selectors are uint8 or int32.

    Without ``rows``, row i of the (N, D) selectors and (N, R) cursors is
    output row i (the Pallas kernel's tile contract). With ``rows``, an
    (N,) int32 tensor of group ids in [0, G), output row i decodes
    ``selectors[rows[i]]`` and ``cursors[rows[i]]`` of the (G, D) and
    (G, R) group tables."""
    if not selectors.is_cuda:
        return selector_decode_plain(selectors, cursors, rows)
    if not cursors.is_cuda or cursors.device != selectors.device:
        raise ValueError("selectors and cursors must lie on the same card")
    if selectors.dtype not in (torch.uint8, torch.int32) or cursors.dtype != torch.int32:
        raise TypeError(
            f"selectors {selectors.dtype} / cursors {cursors.dtype}: "
            "want uint8 or int32 / int32"
        )
    if selectors.dim() != 2 or cursors.dim() != 2 or selectors.shape[0] != cursors.shape[0]:
        raise ValueError(
            f"shapes {tuple(selectors.shape)} / {tuple(cursors.shape)}: want (G,D) / (G,R)"
        )
    if rows is not None:
        if rows.device != selectors.device or rows.dtype != torch.int32 or rows.dim() != 1:
            raise ValueError(f"rows {rows.dtype} {tuple(rows.shape)} on {rows.device}: "
                             "want (N,) int32 on the selectors' card")
        rows = rows.contiguous()
    n = selectors.shape[0] if rows is None else rows.shape[0]
    d = selectors.shape[1]
    r = cursors.shape[1]
    if max(n, selectors.shape[0]) * d >= 2**31:
        raise ValueError(f"{n}x{d} slots exceed the kernel's int32 indexing")
    dev = selectors.device
    runid = torch.empty((n, d), dtype=torch.int32, device=dev)
    absidx = torch.empty((n, d), dtype=torch.int32, device=dev)
    newest = torch.empty((n, d), dtype=torch.bool, device=dev)
    pad = torch.empty((n, d), dtype=torch.bool, device=dev)
    if n * d == 0:
        return runid, absidx, newest, pad
    selectors, cursors = selectors.contiguous(), cursors.contiguous()
    err = kernel_library().remix_selector_decode(
        selectors.data_ptr(), cursors.data_ptr(),
        None if rows is None else rows.data_ptr(), runid.data_ptr(),
        absidx.data_ptr(), newest.data_ptr(), pad.data_ptr(),
        n, d, r, int(selectors.dtype == torch.uint8), sm_count(selectors),
        stream_ptr(selectors),
    )
    check_launch(err, "selector_decode")
    selector_decode.launches += 1
    return runid, absidx, newest, pad


selector_decode.launches = 0
