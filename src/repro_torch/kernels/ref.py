"""Plain-torch oracles for the kernels' contracts."""
from __future__ import annotations

import torch

from repro_torch.core import keys as K
from repro_torch.core.view import NEWEST_BIT, PLACEHOLDER


def selector_decode_ref(selectors: torch.Tensor, cursors: torch.Tensor):
    """Oracle for kernels.selector_decode: (Q,D)+(Q,R) → runid/absidx/newest/pad."""
    r = cursors.shape[1]
    sel = selectors.to(torch.int32)
    pad = sel == PLACEHOLDER
    newest = ((sel & NEWEST_BIT) != 0) & ~pad
    runid = torch.where(pad, 0, sel & 0x7F)
    onehot = (runid[..., None] == torch.arange(r, device=sel.device)) & ~pad[..., None]
    onehot = onehot.to(torch.int32)
    occ = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
    occ = (occ * onehot).sum(dim=-1, dtype=torch.int32)
    base = torch.gather(cursors.to(torch.int32), -1, runid.long())
    return runid, base + occ, newest, pad


def anchor_search_ref(anchors: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Oracle for kernels.anchor_search: target group = upper_bound - 1, >= 0."""
    return torch.clamp(K.upper_bound(anchors, queries) - 1, min=0)
