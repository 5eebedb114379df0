"""Hopper kernel: batched anchor search (paper §3.1 step 1).

Replaces the Pallas TPU kernel ``src/repro/kernels/anchor_search.py``:
``anchor_le_count`` (body ``_le_count_kernel``) and ``anchor_search``,
which composed it in two levels. The TPU kernel streamed every anchor tile
past every query tile (compare-and-count, O(G) per query, branch-free for
the vector unit). On the H100 a search needs only a few KB of L2-resident
anchor rows, and what bounds it is the latency of dependent loads: one
thread's binary search waits on about log2(G) of them. So
``csrc/anchor_search.cu`` cuts the dependent steps in one of two ways,
by the number of queries per SM: for a few, a warp per query runs a
32-ary search in device memory (log32(G) steps); for many, each block
stages a sample of the anchors, every ``stride``-th row (:func:`_plan`),
into shared memory, and a thread per query binary-searches the sample
there and then its ``stride``-row block, one 128-byte line where the
sample fits. The sample is built from ``anchors`` at every launch;
nothing is kept beside the index. One kernel serves both functions:
``anchor_le_count`` is ``upper_bound`` (the count of anchors <= query,
for sorted anchors — the Pallas kernel's contract), ``anchor_search`` is
``max(upper_bound - 1, 0)``.

Each wrapper launches the kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it takes the plain version
beside it.
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as K
from repro_torch.device import check_launch, kernel_library, sm_count, stream_ptr

LINE_BYTES = 128  # one L2 line: the block a query finishes in
# csrc/anchor_search.cu holds the same two values
SAMPLE_BYTES_MAX = 48 * 1024  # a block's sample
SAMPLE_MIN_QUERIES_PER_SM = 128  # from here on the kernel samples; below, a warp per query


def _plan(g: int, kw: int) -> tuple[int, int, int]:
    """(stride, sample_rows, smem_bytes) of the kernel's sample of G anchor
    rows of KW words: every ``stride``-th row, ``sample_rows`` in all.

    The stride starts at the rows of one line, so that a query finishes
    inside one line, and doubles until the sample fits
    ``SAMPLE_BYTES_MAX`` of shared memory."""
    stride = LINE_BYTES // (4 * kw)
    while -(-g // stride) * kw * 4 > SAMPLE_BYTES_MAX:
        stride *= 2
    rows = -(-g // stride)
    return stride, rows, rows * kw * 4


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
    if g >= 2**30:
        raise ValueError(f"G={g}: the kernel indexes anchor rows with int32")
    out = torch.empty((q,), dtype=torch.int32, device=queries.device)
    if q == 0:
        return out
    anchors, queries = anchors.contiguous(), queries.contiguous()
    stride, _, _ = _plan(g, kw)
    err = kernel_library().remix_anchor_search(
        anchors.data_ptr(), queries.data_ptr(), out.data_ptr(),
        g, q, kw, stride, sm_count(queries), int(minus_one), stream_ptr(queries),
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
