"""Hopper kernel: in-group run-selector decode (paper §3.2).

Replaces the Pallas TPU kernel ``src/repro/kernels/selector_decode.py``:
``selector_decode`` (body ``_decode_kernel``). For a (Q, D) tile of
selectors and the (Q, R) cursor offsets at the group heads it returns each
slot's run, its absolute in-run index (the cursor plus the slot's exclusive
occurrence count of its own run), and the newest and placeholder flags.

The TPU kernel unrolled a one-hot over R with a prefix sum along the lanes.
On the H100 the decode is bound by bytes (one selector byte and one cursor
word in, ten bytes out per slot), so ``csrc/selector_decode.cu`` runs one
thread per (row, slot) that counts the earlier same-run slots of its row
(at most 63 byte compares, served by L1), reads uint8 selectors directly
with no widening pass, and writes neighbouring slots from neighbouring
threads so the stores coalesce.

The wrapper launches the kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it takes the plain version
beside it.
"""
from __future__ import annotations

import torch

from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER
from repro_torch.device import check_launch, kernel_library, stream_ptr


def selector_decode_plain(selectors: torch.Tensor, cursors: torch.Tensor):
    """The kernel's function in plain torch: one-hot over R + prefix count.

    A runid >= R gets no cursor and no count, as in the TPU kernel."""
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


def selector_decode(selectors: torch.Tensor, cursors: torch.Tensor):
    """Decode selector tiles → (runid (Q,D) int32, absidx (Q,D) int32,
    newest (Q,D) bool, pad (Q,D) bool). Selectors are uint8 or int32."""
    if not selectors.is_cuda:
        return selector_decode_plain(selectors, cursors)
    if not cursors.is_cuda or cursors.device != selectors.device:
        raise ValueError("selectors and cursors must lie on the same card")
    if selectors.dtype not in (torch.uint8, torch.int32) or cursors.dtype != torch.int32:
        raise TypeError(
            f"selectors {selectors.dtype} / cursors {cursors.dtype}: "
            "want uint8 or int32 / int32"
        )
    if selectors.dim() != 2 or cursors.dim() != 2 or selectors.shape[0] != cursors.shape[0]:
        raise ValueError(
            f"shapes {tuple(selectors.shape)} / {tuple(cursors.shape)}: want (Q,D) / (Q,R)"
        )
    q, d = selectors.shape
    r = cursors.shape[1]
    if q * d >= 2**31:
        raise ValueError(f"{q}x{d} slots exceed the kernel's int32 indexing")
    dev = selectors.device
    runid = torch.empty((q, d), dtype=torch.int32, device=dev)
    absidx = torch.empty((q, d), dtype=torch.int32, device=dev)
    newest = torch.empty((q, d), dtype=torch.bool, device=dev)
    pad = torch.empty((q, d), dtype=torch.bool, device=dev)
    if q * d == 0:
        return runid, absidx, newest, pad
    selectors, cursors = selectors.contiguous(), cursors.contiguous()
    err = kernel_library().remix_selector_decode(
        selectors.data_ptr(), cursors.data_ptr(), runid.data_ptr(),
        absidx.data_ptr(), newest.data_ptr(), pad.data_ptr(),
        q, d, r, int(selectors.dtype == torch.uint8), stream_ptr(selectors),
    )
    check_launch(err, "selector_decode")
    selector_decode.launches += 1
    return runid, absidx, newest, pad


selector_decode.launches = 0
