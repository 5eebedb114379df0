"""Hopper kernel: batched anchor search (paper §3.1 step 1).

Replaces the Pallas TPU kernel ``src/repro/kernels/anchor_search.py``:
``anchor_le_count`` (body ``_le_count_kernel``) and ``anchor_search``,
which composed it in two levels. The TPU kernel streamed every anchor tile
past every query tile (compare-and-count, O(G) per query, branch-free for
the vector unit). On the H100 the search is bound by bytes and by the
latency of dependent loads, so ``csrc/anchor_search.cu`` runs one thread per
query doing a binary search over the (G, KW) anchor words: about log2(G)
dependent reads per query, all L2 hits once a partition's anchors (tens to
hundreds of KB) sit in the 50 MB L2. One kernel serves both functions:
``anchor_le_count`` is ``upper_bound`` (the count of anchors <= query, for
sorted anchors — the Pallas kernel's contract), ``anchor_search`` is
``max(upper_bound - 1, 0)``.

Each wrapper launches the kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it takes the plain version
beside it.
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as K
from repro_torch.device import check_launch, kernel_library, stream_ptr


def anchor_le_count_plain(anchors: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 number of anchors <= query: a vectorized binary search."""
    return K.upper_bound(anchors, queries)


def anchor_search_plain(anchors: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 target group ``max(upper_bound - 1, 0)``."""
    return torch.clamp(K.upper_bound(anchors, queries) - 1, min=0)


def _launch(anchors: torch.Tensor, queries: torch.Tensor, minus_one: bool):
    if not queries.is_cuda or queries.device != anchors.device:
        raise ValueError("anchors and queries must lie on the same card")
    if anchors.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError("anchor words must be int32 bit-views")
    if anchors.dim() != 2 or queries.dim() != 2 or anchors.shape[1] != queries.shape[1]:
        raise ValueError(f"shapes {tuple(anchors.shape)} / {tuple(queries.shape)}: want (G,KW) / (Q,KW)")
    g, kw = anchors.shape
    q = queries.shape[0]
    if not 1 <= kw <= 3:
        raise ValueError(f"KW={kw}: the kernel takes 1 to 3 key words")
    out = torch.empty((q,), dtype=torch.int32, device=queries.device)
    if q == 0:
        return out
    anchors, queries = anchors.contiguous(), queries.contiguous()
    err = kernel_library().remix_anchor_search(
        anchors.data_ptr(), queries.data_ptr(), out.data_ptr(),
        g, q, kw, int(minus_one), stream_ptr(queries),
    )
    check_launch(err, "anchor_search")
    return out


def anchor_le_count(anchors: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Return (Q,) int32: number of anchors <= query (target group + 1)."""
    if not anchors.is_cuda:
        return anchor_le_count_plain(anchors, queries)
    out = _launch(anchors, queries, minus_one=False)
    anchor_le_count.launches += 1
    return out


def anchor_search(anchors: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 target group ids: ``max(upper_bound(anchors, q) - 1, 0)``."""
    if not anchors.is_cuda:
        return anchor_search_plain(anchors, queries)
    out = _launch(anchors, queries, minus_one=True)
    anchor_search.launches += 1
    return out


anchor_le_count.launches = 0
anchor_search.launches = 0
