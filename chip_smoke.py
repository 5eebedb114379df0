#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of REMIX (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. build — compile ``src/repro_torch/csrc/*.cu`` with nvcc (first use).
2. kernels — each CUDA kernel against its plain PyTorch version on the
   card, bit for bit, across sweeps of shapes and types (anchor counts G
   up to 2^20, every power of two from 1,024; one query alone and
   batches, queries at and past the +inf tail; selector tiles and group
   ids, runids >= R).
3. main path — 32 in-memory partitions at the widths of
   ``src/repro/configs/remixdb.py`` (R=8 runs of 65,536 entries, D=32,
   64-bit keys, 4-word values) with overlapping runs, tombstones, TTL
   expiries and an excised span, uploaded through ``DeviceViewManager``
   and queried through ``get_batch`` / ``scan_windows`` (and through
   ``ops.get`` / ``ops.scan`` on ``Partition.index()``); every answer is
   checked against an independent numpy oracle and against the port's
   plain engine (``core.query``) on the card, with one host sync per batch.
4. timings — each kernel at each of the main path's shapes (CUDA events
   over CUDA graphs of many launches) beside its bound, its plain version,
   a PyTorch yardstick and a launch floor (a one-element ``add_`` timed the
   same way); end-to-end µs per key / per query and profiled batches.
   Then ``get_resolve`` (the end of a device-view get after the seek's
   decode) on views shaped like the benchmark's YCSB C records (VW 30 in
   4 tables, VW 250 in 2, of 2^16 keys each) at 64, 256 and 16,384
   queries: bit for bit against its plain version and the eager
   composition it replaced, then timed beside that composition (device
   time as above, and host µs a call to completion) and its bytes bound.
   Then a store batch's round trip: a 256-key get over 6 views shaped like
   the benchmark's kv120 store (2^20 keys in 6 partitions of 3 disjoint
   tables, VW 30), all views in one ``get_batch`` against one call a view,
   from 1 and from 4 threads at once: wall and thread CPU µs a batch, and
   syncs a batch; the answers of both against a numpy oracle.
5. index tier — the deployment the reference store's defaults put on the
   ``index`` residency tier (``src/repro/db/store.py``: 256 MiB device
   budget, 64 MiB block cache, 64-query pipeline slices): 2 partitions of
   8 runs x 2^20 entries at the same widths, written as SSTables (with
   CKBs) and REMIX files through ``io.Storage`` into a temporary directory
   outside the checkout, reopened from the manifest over lazy file handles
   and the loaded REMIX, and queried through ``get_batch`` /
   ``scan_windows`` with the values gathered on the host through the block
   cache; answers against the numpy oracle, syncs per batch, no value byte
   read at upload, first-pass and warm timings (three of each), the host
   cost of a missed value granule split into file read and CRC32C, and a
   profiled batch that shows slice i+1's kernels starting before slice i's
   host gather ends. Then both kernels on this path's own operands (its
   anchors, queries and group ids), against their plain versions bit for
   bit, and timed at its shapes as in phase 4.
6. store — the port's ``RemixDB`` through its public API, at the widths
   of ``src/repro/configs/remixdb.py`` (VW = 4, D = 32) with every other
   ``RemixDBConfig`` field at the reference's default, in a temporary
   data directory outside the checkout under a logical clock. Load: 2^20
   put_batch keys uniform over [0, 2^40) in batches of 65,536 and a short
   unflushed last batch (20% overwrites, TTLs on 10% — half expired at
   query time —, 1% point deletes per batch through one ``Batch`` of
   ``Op.delete``, one ``delete_range``), through minor and split
   compactions. Then three
   stages, every answer checked against an independent numpy oracle:
   (1) the store as loaded, with the memtable overlay, then flushed (scans
   through ``scan_windows``), then a new unflushed tail; (2) ``close`` and
   ``RemixDB.open``: the WAL tail replayed, cold reads until every
   partition's ``promotion`` event, then device views; (3) reopened with
   ``use_kernels=True, device_path="off", cold_reads=False``: the kernels
   through the cursor (every scan over the WAL's overlay), then flushed,
   through ``ops.get`` / ``ops.scan``. Per stage: µs per key of get_batch
   (256 and 65,536 keys) and per query of scan_batch (256 × 50), three
   first/warm pairs; syncs per batch (one fetch a view-path batch,
   whatever partitions it touches; every
   view-path batch with its views resident runs under the sync debug
   mode ``error``, its cursor fallbacks under ``warn``, counted apart;
   the legacy path is held to its blocking copies per partition), both
   kernels' launches, resident and allocated device bytes, a profiled
   256-key get. After stages 2 and 3, outside the counted runs, both
   kernels against their plain versions bit for bit on that stage's own
   operands (the views, or each partition's ``p.index()`` with the
   store's padded queries and the cursor's one-key seek), and timed.
7. fleet — the port's ``Cluster``: 3 range shards (lows 0, 2^40/3,
   2·2^40/3), each a ``RemixDB`` with phase 6's config on the card, one
   shared 64 MiB block cache and 2 submit workers, in a temporary
   directory. (1) 2^21 keys loaded through ``Cluster.submit`` (as phase
   6, without TTLs), flushed; (2) quiesced fleet reads against the numpy
   oracle (gets of 256 and 65,536 keys; 256 Seek+Next50 scans, some
   draining into the next shard), three first/warm pairs, one fetch a
   shard reached under ``error``, a profiled 256-key get; (3) three
   submitter threads of zipfian 64-key batches (a quarter puts) for 5 s,
   a live ``split`` of shard 0 at its middle (aligned), 5 s more: failed
   ops (must be 0), batch latency before / during / first after / after
   the split, time under the gate, shipped bytes; every traffic read and
   every written key held to the acknowledged-value rule; (4) both
   kernels on the new shard's operands, bit for bit, and timed; (5)
   ``add_replica`` of shard 0, a put_batch, ``catch_up_until(0)``, the
   replica's reads equal the primary's and the oracle's; (6) ``merge`` of
   the split back, none of the files it copied into the absorbing shard
   in that shard's ``quarantine/``; (7) close and ``Cluster(lows=None)``: cold reads until
   every partition promotes, then promoted reads. Device memory around
   every topology change, beside each store's view bytes.
8. paper — the paper's figures through the port's benchmarks
   (``src/repro_torch/bench/``) with the reference benchmarks' shapes and
   mix, every answer checked: fig11 / fig12 (weak / strong locality; R in
   {1, 2, 4, 8, 16} tables of 2^18 keys; REMIX seek in both in-group
   modes, Seek+Next50, get against the merging iterator and the
   bloom-filtered get, each against a numpy oracle, the bloom's false
   negatives counted: 0), fig13 (D in {16, 32, 64} at R = 8), table1,
   fig14-16 (RemixDB, whose reads go through both kernels, against the
   leveled and tiered stores at the reference's keys, memtable and
   table cap; every store held to the oracle after each load) and fig17
   (YCSB A-F at the reference's keys, 3,000 ops each; the stores held to the
   oracle after the load and after F, the baselines' scans after F to
   their own ``scan`` per start). After each load, outside the counted
   runs, both kernels against their plain versions bit for bit on the
   RemixDB's resident views at the batches the figure sends (the check's
   4,096-key get and 64 scans, fig14's 512 seek probes and fig15's 256
   scan starts, fig17's 256-key gets and 64-start scans), timed after
   fig14's 120B load and fig17's;
   after F, the baselines' 64-start scan_batch over their memtable timed
   beside one merging scan per start (the reference's algorithm). Then
   the sharded get (``make_sharded_get`` over one NCCL rank per card at
   ``RemixServiceConfig()``'s widths, 2^19 queries, half of them keys
   stored on any shard) against the oracle under the over-capacity drop
   rule and ``core.query.get``. Each timed row prints the reference's
   CSV line and, from one profiled call, its device-busy µs and device
   launches; then the paper's claims read off the rows.
9. LLM serving — qwen2.5-3b at its published widths (36 layers, d_model
   2048, 16 heads, 2 KV heads, head_dim 128, d_ff 11008, vocab 151,936;
   float32 params from a seeded generator on the card, bfloat16
   activations) through the port's ``ServeEngine``: the traffic of
   ``examples/serve_llm_prefix_cache.py`` once without and once with the
   REMIX-indexed ``PrefixCache`` (the same tokens, tokens reused, cache
   hits); time to first token and ms per decoded token, page-table
   lookups, one profiled decode step (device busy, idle share, launches)
   beside its bytes bound, peak device bytes. Checks: teacher-forced
   ``decode_step`` logits against ``forward`` at full width in float32
   (argmax equal at every position); one arch of each family at 2 layers,
   a forward and two decode steps on the card against the CPU; the page
   table's ``lookup_batch`` on the card against a dict over 5 generations
   with a tiered merge. No kernel of ``csrc/`` is on this path (the
   counts are printed).
10. LM training — (a) phase 9 freed, the bytes still allocated logged;
   (b) ``loss_fn`` and every grad leaf on the card against the CPU:
   qwen2.5-3b's widths at 2 layers in float32 and in bfloat16, then one
   arch of each family at ``reduced`` in float32; (c) the port's launcher,
   ``repro_torch.launch.train.main``, at qwen2.5-3b's published widths
   (``--no-reduced``: float32 params, grads and AdamW moments, 49.4 GB;
   the reference launcher's batch 8 x 128 tokens) for 4 steps and its
   final save (37.0 GB) into a temporary directory under ``TMPDIR``
   (device, disk and host RAM checked first); that checkpoint restored
   onto the card beside the trained state and held to it bit for bit,
   then a fifth step resumed from it as ``--resume`` runs one, and one
   more profiled: per-step ms, tokens/s, loss and grad norm (finite,
   norm > 0, every leaf moved), peak device bytes, the save's and the
   restore's bytes and seconds. The launcher's own ``--resume`` (a second
   save) runs at ``--reduced``: a second full-width save would write
   74 GB in one run. (d) The reference test's learning bar on the card
   (reduced qwen2.5-3b, 40 steps, the loss down by more than 0.3) and
   exact resume, bit for bit under deterministic algorithms. No kernel of
   ``csrc/`` is on this path (the counts are printed).
11. launch — the port's ``launch/`` (device meshes, the fake-mesh dry run,
   the H100 roofline): (a) the dry run's per-device counting
   (``launch.dryrun.count_step``) on phase 10's own step — qwen2.5-3b at
   its published widths, 8 x 128 tokens, AdamW — on fake card tensors on
   a 1 x 1 mesh: FLOPs, eager bytes, the peak of live allocations and the
   roofline terms beside phase 10's measured busy and wall ms and peak
   bytes, and the counted FLOPs beside the hand count (6 N D; 8 N D with
   the recompute); (b) ``python -m repro_torch.launch.dryrun`` for the
   cells of ``DRYRUN_CELLS`` at full width on the fake ``(32, 8)`` mesh of
   256 ranks (one process each, started together), each record and its
   roofline row printed; (c) the launcher at ``--reduced`` on the card's
   mesh (``make_debug_mesh``: 1 x 1 here): trained and saved, its
   checkpoint restored through ``restore(shardings=...)`` onto that mesh
   and held to the trained state bit for bit, then ``--resume``. Both
   kernels' launch counts over (a) and (c) are printed (no kernel of
   ``csrc/`` is on this path).
12. drivers — the system's own drivers through the port
   (``src/repro_torch/bench/``, ``examples/``, ``tools/``): the eight
   system benchmarks at the reference's full sizes (cache: 8 tables x
   2^17 entries; kernels and batch: 8 x 2^16; cursor: 6 x 2^14; engine: 2
   shards of 8 x 2^15; rebuild: 8 + 1 tables of 16,384; scrub: 40,000
   keys; cluster: 3 shards x 49,152 keys, 5 s of zipfian traffic on each
   side of a live split), every bar each of them asserts held, each row
   printed beside the card (the kernels benchmark's device/legacy ratio
   is printed beside the reference's TPU-era 5x bar, which is not held);
   both kernels held bit for bit on the kernels benchmark's resident view
   at its 256-key probe and 64 x 16 scans, and timed there; the four
   examples (quickstart's expectations asserted; kvstore_serving at
   200,000 keys; the serving example's outputs equal with and without the
   prefix cache; train_lm for 150 of its 300 steps, with the step-100
   checkpoint, then resumed from the last for 20 more); obstool's ``show``,
   ``--prom`` and ``diff`` on the engine benchmark's snapshot and across a
   store's reads, ``health`` on that store (exit 0) and ``health --scrub``
   on a copy with a flipped table byte (non-zero). Both kernels' launches are counted per
   driver; kernels and batch must launch both.
13. docs — the doc tools through the port (``src/repro_torch/tools/``):
   ``check_docs --device cuda`` runs the 14 python blocks of ``docs/*.md``
   on the card (every one must pass; both kernels must launch, through
   the stores' device views); then ``mk_tables`` renders the dry-run and
   roofline tables from phase 11's records (one row per record, each
   roofline row's bottleneck the one ``analyze_cell`` gives). Its wall
   time and the script's total are printed.

Each stage of phases 3 and 5-13 counts the kernels' launches from zero;
``get_resolve``'s must equal the views on the card of the stage's
``get_batch`` calls (one launch a view; a store batch passes all of its
partitions' views in one call). The launches the JSON lists
are those stages' sums, without phase 4's timing and checking calls.

The last lines are one JSON object listing the kernels, the card's name
and power limit from nvidia-smi, and ``{"ok": true, "device": ...}``.
The script exits non-zero, printing no result, where CUDA is absent or
the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# src/repro/configs/remixdb.py (RemixServiceConfig): R, entries per run,
# group size, key words, value words
R, ENTRIES, D, KW, VW = 8, 1 << 16, 32, 2, 4
N_PARTITIONS = 32  # full-tier depth
DOMAIN = 1 << 18  # distinct keys per partition: each key in ~2 of the 8 runs
GET_SMALL, GET_LARGE = 256, 1 << 16
SCAN_Q, SCAN_WIDTH = 256, 75  # Seek+Next50: n + max(8, n // 2)
# anchor-kernel sweep; 32768 and 2^19 are the padded group counts of the
# full and the index tier's partitions, and the powers of two from 1,024
# up hold every padded G of the store's partitions (phase 6). Some G are
# not multiples of the sample stride, and the largest make it double.
ANCHOR_GS = (1, 5, 17, 513, 1024, 2048, 4096, 5000, 8192, 16384, 32768, 65536,
             100_003, 131_072, 262_144, 1 << 19, 1 << 20)
# phase 5: the reference store's defaults (src/repro/db/store.py): device
# budget (:116), block cache (:95), pipeline slice (:120); at 8 runs x 2^20
# entries the full view (~296 MB) exceeds the budget, the index view
# (~195 MB) fits it
IDX_ENTRIES, IDX_DOMAIN, IDX_PARTITIONS = 1 << 20, 1 << 22, 2
DEVICE_BUDGET, CACHE_BYTES, SLICE_WIDTH = 256 << 20, 64 << 20, 64
REPEATS = 3  # first/warm pairs per index-tier batch
NOW = 1_700_000_000  # query-time clock (uint32 seconds)
# phase 6: the port's RemixDB at the widths of src/repro/configs/remixdb.py
# (VW=4, D=32), every other RemixDBConfig field at the reference's
# default; keys uniform over [0, 2^40). 2^20 keys, not 2^21: at 2^21 the
# whole script ran past 4.5 minutes on the card
STORE_KEYS, STORE_BATCH, STORE_DOMAIN = 1 << 20, 1 << 16, 1 << 40
STORE_TAIL = 4096  # the load's last, short batch: unflushed
STORE_GET_SMALL, STORE_GET_LARGE = 256, 1 << 16
STORE_SCAN_Q, STORE_SCAN_N = 256, 50  # Seek+Next50
STORE_EDGE_ROUNDS = 12  # batches allowed for every partition to promote
T_LOAD = NOW - 1000  # the load's clock; queries run at NOW
TTL_SHORT, TTL_LONG = 500, 1 << 20  # expired / live at NOW
# blocking copies per partition on the store's legacy path
# (src/repro_torch/db/store.py, _get_batch_at / _scan_group_at): the query
# words in; found and values out, or keys, valid and values out
LEGACY_COPIES = {"get": 3, "scan": 4}
# phase 7: a fleet behind the port's Cluster. benchmarks/cluster_bench.py:
# 3 shards, 64-key batches, 3 submitters (:37-39); zipfian ranks permuted
# over the keys, a quarter of the batches puts (:63-75); 5 s of traffic
# before and after the split (:118). 2^21 keys, not phase 6's 2^20: at
# 2^20 each shard held one partition (4-5 tables of 65,536 entries, under
# t_max = 10), so the split had no boundary to align to
FLEET_SHARDS, FLEET_BATCH, FLEET_THREADS = 3, 64, 3
FLEET_KEYS = 1 << 21
FLEET_PUT_SHARE, FLEET_THETA, FLEET_PHASE_S = 0.25, 0.99, 5.0
FLEET_FIRST = 16  # post-split batches reported apart (cold reads, promotion)
FLEET_TAIL = 4096  # stage 5's put_batch into the replicated shard
# phase 8: the paper's figures (src/repro_torch/bench/), with the
# reference benchmarks' shapes and mix. fig11-13 tables of 2^18 keys, 16x
# benchmarks/fig11_queries.py's 16,384 (the host builds of the tables took
# phase 8 to 391 s at 2^20 and to 344 s at 2^19 on a slower host); fig14-17
# at the reference's keys, memtable and table cap (fig14-16: 120,000 keys,
# memtable and table_cap 8,192; fig17: 60,000 keys, OPS 3,000). At x 4 the
# whole script, phase 10 included, ran 744 s on an H100 and 986 s on a
# slower host (phase 8 320 s of it), against the 1,200 s it may take; at
# x 2 it ran 665 s, and 849 s with phases 11-12 (fig14-17: 116.5 s)
PAPER_N_PER_TABLE = 1 << 18
PAPER_TIMED = ("fig14 120B", "fig17 load")  # one store per G of phase 8's partitions
PAPER_SCALE = 1
PAPER_SEED = 1  # build_demo_state's draws for the sharded get
# phase 9: LLM serving at qwen2.5-3b's published widths
# (src/repro/configs/qwen2_5_3b.py) with random weights from a seed;
# traffic as examples/serve_llm_prefix_cache.py: 6 requests of a shared
# 48-token system prompt + 12 distinct tokens, 12 new tokens each,
# max_seq 128, PrefixCache(n_pages=256, page_size=16) (24 pages
# registered: the ring never wraps)
LLM_ARCH = "qwen2.5-3b"
LLM_REQUESTS, LLM_SHARED, LLM_TAIL, LLM_MAX_NEW, LLM_MAX_SEQ = 6, 48, 12, 12, 128
LLM_PAGES, LLM_PAGE = 256, 16
LLM_CHECK_TOKENS = 16  # decode against forward, float32
LLM_FAMILIES = ("qwen2.5-3b", "minicpm3-4b", "qwen3-moe-235b-a22b", "mamba2-130m",
                "zamba2-2.7b", "seamless-m4t-medium", "gemma2-27b")
# decode_step against forward at full width, float32 caches: the two sum
# each product in another order (a 1-row and a 16-row GEMM), ~1e-6
# relative a layer over 36 layers; |logits| ~ 5. TF32 products (2^-11
# relative) or bfloat16 ones would exceed it
LLM_DECODE_ATOL = 2e-4
# each family on the card against the CPU, float32 (2 layers): the
# card's float32 GEMMs sum in another order than the CPU's; |logits| ~ 1.5
LLM_FAMILY_ATOL = 1e-4
# phase 10: LM training at qwen2.5-3b's published widths through the port's
# launcher, at the reference launcher's own batch and sequence defaults
# (src/repro/launch/train.py: --batch 8 --seq 128); float32 params, grads
# and AdamW moments (49.4 GB), random weights from the launcher's seed
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 128
# the full-width run saves once (37.0 GB) under TMPDIR, tempfile's default
TRAIN_DEVICE_MARGIN = 8 << 30  # activations, logits, the optimizer's slices
TRAIN_RESTORE_MARGIN = 2 << 30  # the restored state beside the trained one
TRAIN_DISK_MARGIN = 2 << 30
TRAIN_HOST_MARGIN = 4 << 30
TRAIN_LEARN_STEPS = 40  # the reference's test_loss_decreases
# card against CPU (loss_fn and every grad leaf): qwen2.5-3b's widths at 2
# layers and one arch of each family at reduced, batch 1 x 32. float32:
# both sum their GEMMs in their own order (no TF32), ~1e-6 relative a
# product. bfloat16: both round after each op, but a one-ulp difference
# (2^-8) in a GEMM's output travels through the layers and back
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH = (1, 32)
TRAIN_F32_LOSS_ATOL, TRAIN_F32_GRAD_RTOL = 1e-4, 1e-4
TRAIN_BF16_LOSS_ATOL, TRAIN_BF16_GRAD_RTOL = 2e-2, 0.1
DEV = "cuda"
# phase 11: the production-mesh dry-run cells (the reference test's two
# and the store's service cell); each runs in its own process
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k"), ("mamba2-130m", "decode_32k"),
                ("remixdb", "service"))
DRYRUN_TIMEOUT = 300
# phase 12: the system's own drivers through the port, every benchmark at
# its reference size (not --tiny). kernels and batch send the device path
# batches of their own, so both kernels must launch there
DRIVER_BENCHES = ("cache", "kernels", "batch", "cursor", "engine", "rebuild", "scrub",
                  "cluster")
DRIVER_REQUIRE = ("kernels", "batch")
# examples/train_lm.py for 150 steps, not its 300 (checkpoints at 100 and
# the end; 300 + 20 steps took 69 s and the whole script 954.1 s on a slow
# host), then a second call that resumes from the last checkpoint and
# trains 20 steps more
TRAIN_LM_STEPS, TRAIN_LM_MORE = 150, 20
OBS_KEYS = 20_000  # the store obstool's health reads (flushed, one table rotted)
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
BF16_FLOPS = 989e12  # H100 SXM dense bfloat16 tensor-core peak, FLOP/s
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes (H100 whitepaper)

REPLACES = {
    "anchor_search": "src/repro/kernels/anchor_search.py:46",
    "selector_decode": "src/repro/kernels/selector_decode.py:45",
    "get_resolve": "none: the ops XLA fused after the decode in src/repro/kernels/ops.py:173",
}
SOURCES = {
    "anchor_search": "src/repro_torch/csrc/anchor_search.cu",
    "selector_decode": "src/repro_torch/csrc/selector_decode.cu",
    "get_resolve": "src/repro_torch/csrc/get_resolve.cu",
}
# get_resolve's views: (VW, tables of ENTRIES keys) as YCSB C's 120-B and
# 1-KB records; the query counts get_batch pads to
RESOLVE_VIEWS = ((30, 4), (250, 2))
RESOLVE_QS = (64, 256, 16_384)


def log(*a):
    print(*a, flush=True)


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


@contextlib.contextmanager
def sync_debug_error():
    """Raise on any CUDA synchronisation other than the batch's fetch."""
    import torch

    if DEV != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def time_graph(fn, reps: int = 50, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, timed with CUDA events over ``replays`` replays after warm-up."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (replays * reps)


def int32_rate() -> float:
    """Peak 32-bit integer ops/s of card 0: INT32 lanes x SMs x the SM's
    maximum clock as nvidia-smi reports it."""
    import torch

    p = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    mhz = float(p.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BPS * 1e3, ops / int32_rate() * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def search_probes(a64, q64) -> tuple[int, int]:
    """Distinct anchor rows, and probes in all, that the kernel's binary
    search (``csrc/anchor_search.cu``) reads for these ordered int64 keys."""
    import torch

    g = a64.shape[0]
    lo = torch.zeros_like(q64)
    n = torch.full_like(q64, g)
    seen = torch.zeros(g, dtype=torch.bool, device=a64.device)
    probes = 0
    while bool((n > 0).any()):
        act = n > 0
        half = n >> 1
        mid = lo + half
        seen[mid[act]] = True
        probes += int(act.sum())
        le = act & (a64[mid.clamp(max=g - 1)] <= q64)
        lo = torch.where(le, mid + 1, lo)
        n = torch.where(le, n - half - 1, torch.where(act, half, n))
    return int(seen.sum()), probes


# ---------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch import device as dev

    t0 = time.perf_counter()
    dev.kernel_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in dev.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("[build] " + line.strip())


# ---------------------------------------------------------------- phase 2
def _sorted_anchors(rng, g: int, kw: int) -> np.ndarray:
    """(g, kw) uint32 ascending anchors with word ties and a +inf tail."""
    tail = g // 4
    n = g - tail
    rows = rng.integers(0, 2**32, size=(n * 2 + 8, kw), dtype=np.uint64)
    rows[:, 0] %= max(1, n // 2)  # ties on the leading word
    rows = np.unique(rows.astype(np.uint32), axis=0)[:n]  # lexicographic
    out = np.full((g, kw), 0xFFFFFFFF, np.uint32)
    out[: len(rows)] = rows
    return out


def _anchor_queries(rng, anchors: np.ndarray, q: int) -> np.ndarray:
    g, kw = anchors.shape
    real = anchors[~np.all(anchors == 0xFFFFFFFF, axis=1)]
    out = rng.integers(0, 2**32, size=(q, kw), dtype=np.uint64).astype(np.uint32)
    if len(real):
        pick = real[rng.integers(0, len(real), q)]
        nudge = pick.copy()
        nudge[:, -1] += rng.integers(-1, 2, q).astype(np.uint32)  # wraps: fine
        out[: q // 3] = pick[: q // 3]
        out[q // 3: 2 * q // 3] = nudge[q // 3: 2 * q // 3]
    out[0] = 0
    out[1] = 0xFFFFFFFF
    out[1, -1] = 0xFFFFFFFE  # the largest key that is not +inf
    out[2] = 0xFFFFFFFF  # at the +inf tail
    if len(real):
        out[3] = real[-1]
        out[3, -1] += np.uint32(1)  # past the last real anchor
    return out


def phase_kernels(rng) -> dict:
    import torch

    from repro_torch.device import as_words, sm_count
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import selector_decode as SD

    cuda = torch.device(DEV)
    err = {"anchor_search": 0, "selector_decode": 0}
    n = 0
    # 1 query (the cursor's seek) and 1,000 take the warp-per-query search,
    # `many` the sampled one
    many = AS.SAMPLE_MIN_QUERIES_PER_SM * sm_count(torch.empty(0, device=cuda)) + 5
    for g in ANCHOR_GS:
        for kw in (1, 2, 3):
            a_np = _sorted_anchors(rng, g, kw)
            a = as_words(a_np, cuda)
            for nq in (1, 1000, many):
                qs = _anchor_queries(rng, a_np, max(nq, 8))
                # Q = 1: each of the eight edge queries launched alone
                for q_np in ([qs[i:i + 1] for i in range(8)] if nq == 1 else [qs]):
                    q = as_words(q_np, cuda)
                    for kern, plain in ((AS.anchor_le_count, AS.anchor_le_count_plain),
                                        (AS.anchor_search, AS.anchor_search_plain)):
                        got = kern(a, q).cpu().numpy().astype(np.int64)
                        want = plain(a, q).cpu().numpy().astype(np.int64)
                        e = int(np.abs(got - want).max())
                        err["anchor_search"] = max(err["anchor_search"], e)
                        check(e == 0, f"{kern.__name__} G={g} KW={kw} Q={nq}: max |err| {e}")
                        n += 1
    log(f"[kernels] anchor_search/anchor_le_count: {n} cases bit-identical "
        f"(G in {ANCHOR_GS}; KW 1-3; Q 1 (8 edge queries alone), 1,000 and {many}; "
        "+inf tails; queries at and past them)")
    n = 0
    for d in (8, 16, 32, 64):
        # 700 rows: a row group per warp; 40,000: four per warp
        cases = [(r, 700) for r in range(1, min(16, d) + 1)] + [(min(d, 8), 40_000)]
        for r, nrows in cases:
            for dt in (np.uint8, np.int32):
                g = 300  # groups; runids up to R+1 take no cursor and no count
                sel = rng.integers(0, r + 2, (g, d)) | (rng.integers(0, 2, (g, d)) << 7)
                sel[rng.random((g, d)) < 0.2] = 127
                sel[::11] = 127  # all-pad rows
                cur = rng.integers(0, 1 << 20, (g, r)).astype(np.int32)
                rows = np.concatenate([rng.integers(0, g, nrows - g), np.arange(g)[::-1]])
                s = torch.from_numpy(sel.astype(dt)).to(cuda)
                c = torch.from_numpy(cur).to(cuda)
                rw = torch.from_numpy(rows.astype(np.int32)).to(cuda)
                for contract, kw in (("tiles", {}), ("rows", {"rows": rw})):
                    got = SD.selector_decode(s, c, **kw)
                    want = SD.selector_decode_plain(s, c, **kw)
                    for name, x, y in zip(("runid", "absidx", "newest", "pad"), got, want):
                        e = int((x.long() - y.long()).abs().max())
                        err["selector_decode"] = max(err["selector_decode"], e)
                        check(e == 0, f"selector_decode D={d} R={r} {dt.__name__} "
                                      f"{contract} {name}: max |err| {e}")
                    n += 1
    log(f"[kernels] selector_decode: {n} cases bit-identical "
        "(D 8-64; R 1..min(16,D); uint8 and int32 selectors; tiles and group "
        "ids, repeated and unordered, 700 and 40,000 rows; all-pad rows; "
        "runids >= R)")
    return err


# ---------------------------------------------------------------- phase 3
def make_tables(rng, lo: int, entries: int | None = None, distinct: int | None = None):
    """8 overlapping runs over one partition's key range: increasing seq,
    ~5% tombstones, TTLs on ~10% of rows (half already expired)."""
    from repro_torch.db.partition import Table

    entries, distinct = entries or ENTRIES, distinct or DOMAIN
    domain = np.uint64(lo) + np.sort(
        rng.choice(1 << 36, distinct, replace=False)
    ).astype(np.uint64)
    tables = []
    for i in range(R):
        keys = np.sort(rng.choice(domain, entries, replace=False))
        seq = (np.arange(entries) + i * entries + 1).astype(np.uint32)
        vals = rng.integers(0, 2**32, (entries, VW), dtype=np.uint64).astype(np.uint32)
        tomb = rng.random(entries) < 0.05
        exp = np.zeros(entries, np.uint32)
        ttl = rng.random(entries) < 0.10
        delta = rng.integers(1, 1000, entries)
        past = rng.random(entries) < 0.5
        exp[ttl] = np.where(past, NOW - delta, NOW + delta)[ttl].astype(np.uint32)
        tables.append(Table(keys=keys, vals=vals, seq=seq, tomb=tomb, exp=exp))
    return domain, tables


def oracle(tables, spans):
    """Independent answer key: newest version per key and its liveness."""
    keys = np.concatenate([t.keys for t in tables])
    seq = np.concatenate([t.seq for t in tables]).astype(np.int64)
    vals = np.concatenate([t.vals for t in tables])
    tomb = np.concatenate([t.tomb for t in tables])
    exp = np.concatenate([t.exp for t in tables])
    covered = np.zeros(len(keys), bool)
    off = 0
    for i, t in enumerate(tables):
        for lo, hi, covers in spans:
            if i in covers:
                covered[off: off + t.n] |= (t.keys >= lo) & (t.keys < hi)
        off += t.n
    order = np.lexsort((-seq, keys))
    ks = keys[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    top = order[first]
    dead = tomb[top] | ((exp[top] != 0) & (exp[top] <= NOW)) | covered[top]
    return dict(keys=keys[top], vals=vals[top], live=~dead)


def probe(rng, domain, q):
    """Hits and 1/8 misses, as ``benchmarks/kernels_bench._probe`` draws."""
    hits = rng.choice(domain, q - q // 8, replace=False)
    miss = rng.choice(domain, q // 8, replace=False) + np.uint64(1)
    out = np.concatenate([hits, miss])
    rng.shuffle(out)
    return out


def oracle_get(orc, q):
    idx = np.searchsorted(orc["keys"], q)
    idc = np.minimum(idx, len(orc["keys"]) - 1)
    hit = (idx < len(orc["keys"])) & (orc["keys"][idc] == q)
    found = hit & orc["live"][idc]
    return found, orc["vals"][idc]


def check_scan(orc, starts, rows, with_vals, what):
    lk = orc["keys"][orc["live"]]
    lv = orc["vals"][orc["live"]]
    total = 0
    for s, (kk, vv) in zip(starts, rows):
        i = int(np.searchsorted(lk, s))
        check(len(kk) <= SCAN_WIDTH, f"{what}: window longer than width")
        check(np.array_equal(kk, lk[i: i + len(kk)]),
              f"{what}: keys are not a prefix of the live keys >= start")
        if with_vals:
            check(np.array_equal(vv, lv[i: i + len(kk)]), f"{what}: values differ")
        else:
            check(vv is None, f"{what}: values returned without with_vals")
        total += len(kk)
    check(total > 0, f"{what}: no rows returned")
    return total


def build_partitions(rng):
    from repro_torch.db.partition import Partition

    parts, domains, oracles = [], [], []
    t0 = time.perf_counter()
    for i in range(N_PARTITIONS):
        lo = i << 40
        domain, tables = make_tables(rng, lo)
        p = Partition(lo, tables[:6], d=D, device=DEV)
        a = int(rng.integers(0, DOMAIN - 4096))
        span = (int(domain[a]), int(domain[a + 4096]))
        p.attach_excised(span[0], span[1], seq=6 * ENTRIES + 1)
        p.tables.extend(tables[6:])  # born after the range delete: uncovered
        parts.append(p)
        domains.append(domain)
        oracles.append(oracle(tables, [(np.uint64(span[0]), np.uint64(span[1]),
                                        set(range(6)))]))
    log(f"[main] {N_PARTITIONS} partitions x {R} runs x {ENTRIES} entries "
        f"generated in {time.perf_counter() - t0:.1f} s")
    return parts, domains, oracles


def phase_main(rng, parts, domains, oracles):
    import torch

    from repro_torch.core import query as Q
    from repro_torch.db import clock
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import device_view as DV
    from repro_torch.kernels import get_resolve as GR
    from repro_torch.kernels import ops
    from repro_torch.kernels import selector_decode as SD
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.metrics import MetricsRegistry

    clock.set_source(lambda: float(NOW))
    reg, ev = MetricsRegistry(), EventLog(capacity=1024)
    mgr = DV.DeviceViewManager(budget_bytes=1 << 30, registry=reg, events=ev,
                               device=DEV)
    los = np.array([p.lo for p in parts], np.uint64)

    AS.anchor_search.launches = 0
    AS.anchor_le_count.launches = 0
    SD.selector_decode.launches = 0
    GR.get_resolve.launches = 0
    syncs0 = DV.SYNCS
    batches = gets = 0

    t0 = time.perf_counter()
    views = [mgr.view_for(p) for p in parts]
    check(all(v is not None for v in views), "a partition fell back")
    gs = sorted({v.remix.g for v in views})
    log(f"[main] uploaded {len(views)} views in {time.perf_counter() - t0:.1f} s: "
        f"resident {mgr.resident_bytes} bytes "
        f"({mgr.resident_bytes / len(views) / 1e6:.2f} MB per partition; the "
        f"partitions' own estimate {sum(p.device_view_bytes(True) for p in parts)}); "
        f"padded G {gs}")
    check(set(gs) <= set(ANCHOR_GS), f"main-path G {gs} not in the kernel sweep")

    def route(keys):
        owner = np.searchsorted(los, keys, side="right") - 1
        return {int(i): keys[owner == i] for i in np.unique(owner)}

    results = {}
    for qn in (GET_SMALL, GET_LARGE):
        keys = np.concatenate([probe(rng, d, qn) for d in domains])
        rng.shuffle(keys)
        found_n = 0
        for i, kq in route(keys).items():
            with sync_debug_error():
                found, vals = mgr.get_batch(views[i], kq, NOW)
            batches += 1
            gets += 1
            f_o, v_o = oracle_get(oracles[i], kq)
            check(np.array_equal(found, f_o), f"get_batch {qn}: found differs (partition {i})")
            check(np.array_equal(vals[found], v_o[found]), f"get_batch {qn}: values differ")
            found_n += int(found.sum())
            results[("get", qn, i)] = (kq, found, vals)
        log(f"[main] get_batch x{len(parts)} at {qn} keys/partition: "
            f"{found_n}/{len(keys)} found, equal to the oracle")

    starts = {i: probe(rng, d, SCAN_Q) for i, d in enumerate(domains)}
    for with_vals in (True, False):
        rows_n = 0
        for i in range(len(parts)):
            with sync_debug_error():
                rows = mgr.scan_windows(views[i], starts[i], SCAN_WIDTH, NOW,
                                        with_vals=with_vals)
            batches += 1
            rows_n += check_scan(oracles[i], starts[i], rows, with_vals,
                                 f"scan_windows(with_vals={with_vals}) p{i}")
            results[("scan", with_vals, i)] = rows
        log(f"[main] scan_windows x{len(parts)} ({SCAN_Q} starts x width "
            f"{SCAN_WIDTH}, with_vals={with_vals}): {rows_n} rows, each a "
            "prefix of the oracle's live keys")

    # the other entry point: Partition.index() + ops.get / ops.scan, and the
    # plain engine core.query on the same index, both on the card
    for i, p in enumerate(parts):
        remix, runset = p.index()
        kq, found, vals = results[("get", GET_SMALL, i)]
        qt = torch.from_numpy(_pack(kq)).to(DEV)
        f_k, v_k = ops.get(remix, runset, qt)
        f_p, v_p = Q.get(remix, runset, qt)
        f_k, f_p = f_k.cpu().numpy(), f_p.cpu().numpy()
        check(np.array_equal(f_k, found) and np.array_equal(f_p, found),
              f"ops.get / core.query.get differ from get_batch (partition {i})")
        vk = v_k.cpu().numpy().view(np.uint32)
        vp = v_p.cpu().numpy().view(np.uint32)
        check(np.array_equal(vk[found], vals[found]) and np.array_equal(vp[found], vals[found]),
              f"ops.get / core.query.get values differ (partition {i})")
        st = torch.from_numpy(_pack(starts[i])).to(DEV)
        k_k, vv_k, m_k, _ = ops.scan(remix, runset, st, SCAN_WIDTH)
        k_p, vv_p, m_p, _ = Q.scan(remix, runset, st, SCAN_WIDTH)
        m_k, m_p = m_k.cpu().numpy(), m_p.cpu().numpy()
        k_k = k_k.cpu().numpy().view(np.uint32)
        k_p = k_p.cpu().numpy().view(np.uint32)
        vv_k = vv_k.cpu().numpy().view(np.uint32)
        vv_p = vv_p.cpu().numpy().view(np.uint32)
        rows = results[("scan", True, i)]
        for j, (kk, vv) in enumerate(rows):
            for kx, vx, mx in ((k_k, vv_k, m_k), (k_p, vv_p, m_p)):
                check(np.array_equal(_unpack(kx[j][mx[j]]), kk)
                      and np.array_equal(vx[j][mx[j]], vv),
                      f"ops.scan / core.query.scan differ from scan_windows "
                      f"(partition {i}, query {j})")
    log(f"[main] ops.get/ops.scan and core.query.get/scan on Partition.index() "
        f"equal get_batch/scan_windows on all {len(parts)} partitions")

    syncs = DV.SYNCS - syncs0
    fallback = _metric(reg, "device_fallback_total")
    launches = {"anchor_search": AS.anchor_search.launches,
                "selector_decode": SD.selector_decode.launches,
                "get_resolve": GR.get_resolve.launches}
    log(f"[main] launches {launches}; get batches {gets}; syncs {syncs} for {batches} batches; "
        f"device_fallback_total {fallback}; device_batches "
        f"{_metric(reg, 'device_batches')}; device_rows_gathered "
        f"{_metric(reg, 'device_rows_gathered')}; events "
        f"{len(ev.list('device_upload'))} uploads")
    check(syncs == batches, f"{syncs} syncs for {batches} batches")
    check(fallback == 0, "device_fallback_total != 0")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check(launches["get_resolve"] == gets,
          f"get_resolve launched {launches['get_resolve']} times for {gets} get batches")
    return mgr, views, starts, launches


def _pack(u64):
    from repro_torch.core.keys import pack_u64

    return pack_u64(np.asarray(u64, np.uint64)).view(np.int32)


def _unpack(words):
    from repro_torch.core.keys import unpack_u64

    return unpack_u64(words)


def _metric(reg, name):
    return sum(s["value"] for s in reg.snapshot()["metrics"] if s["name"] == name)


# ---------------------------------------------------------------- phase 4
def time_pair(fa, fb, reps: int) -> tuple[float, float]:
    """Device ms per call of ``fa`` and of ``fb``, timed in turns a, b, b, a
    within one run, each the mean of its two turns."""
    a1, b1 = time_graph(fa, reps), time_graph(fb, reps)
    b2, a2 = time_graph(fb, reps), time_graph(fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _pack64(w):
    """Ordered int64 of two uint32 words, for torch.searchsorted."""
    w = w.long() & 0xFFFFFFFF
    return (((w[:, 0] - (1 << 31)) << 32) | w[:, 1]).contiguous()


def launch_floor(card) -> float:
    """Device ms of a one-element ``add_`` in the same CUDA-graph harness."""
    import torch

    x = torch.zeros(1, device=DEV)
    floor = time_graph(lambda: x.add_(1))
    log(f"[timing] {card}: launch floor (one-element add_): {floor * 1e3:.3f} us")
    return floor


def time_anchor(anchors, q, label, reps) -> dict:
    """anchor_search on (G, KW) ``anchors`` and (Q, KW) queries ``q`` as a
    path hands them: checked against its plain version and
    ``torch.searchsorted``, then timed beside both and its bound."""
    import torch

    from repro_torch.kernels import anchor_search as AS

    g, qn = anchors.shape[0], q.shape[0]
    got = AS.anchor_search(anchors, q)
    check(torch.equal(got, AS.anchor_search_plain(anchors, q)),
          f"anchor_search differs from its plain version ({label}, G={g} Q={qn})")
    a64, q64 = _pack64(anchors), _pack64(q)
    check(torch.equal(torch.clamp(torch.searchsorted(a64, q64, right=True) - 1, min=0)
                      .to(torch.int32), got), "searchsorted yardstick disagrees")
    ms, lib = time_pair(lambda: AS.anchor_search(anchors, q),
                        lambda: torch.searchsorted(a64, q64, right=True), reps)
    plain = time_graph(lambda: AS.anchor_search_plain(anchors, q), reps=5)
    rows, probes = search_probes(a64, q64)
    b, by = bound_ms(rows * KW * 4 + qn * (KW * 4 + 4), probes * KW * 2)
    log(f"[timing] anchor_search ({label}) at G={g} Q={qn}: a binary search reads "
        f"{rows} of {g} anchor rows ({probes} probes); sample plan "
        f"(stride, rows, bytes) = {AS._plan(g, KW)}")
    return dict(shape=f"{label}: G={g} KW={KW} Q={qn}", ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=lib)


def time_decode(remix, rows, label, reps) -> tuple[dict, int]:
    """selector_decode on ``remix``'s group tables at the (N,) group ids
    ``rows`` a path hands it: checked against its plain version bit for
    bit, then timed beside it and its bound; returns the timing and the
    max |err|."""
    from repro_torch.kernels import selector_decode as SD

    sel, cur = remix.selectors.reshape(remix.g, D), remix.cursors
    got = SD.selector_decode(sel, cur, rows=rows)
    want = SD.selector_decode_plain(sel, cur, rows=rows)
    e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(e == 0, f"selector_decode differs from its plain version at the {label}")
    ms = time_graph(lambda: SD.selector_decode(sel, cur, rows=rows), reps)
    plain = time_graph(lambda: SD.selector_decode_plain(sel, cur, rows=rows), reps=5)
    n = rows.shape[0]
    # row ids, gathered selectors and cursors in; runid, absidx, newest, pad out.
    # Operations: 8 integer ops per slot (decode 3, count 2, cursor 1, flags 2).
    b, by = bound_ms(n * 4 + n * D + n * remix.r * 4 + n * D * 10, n * D * 8)
    return dict(shape=f"{label}: N={n} G={remix.g} D={D} R={remix.r}", ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None), e


def log_timings(card, name, shapes, floor):
    for k in shapes:
        log(f"[timing] {card}: {name} ({k['shape']}): kernel {k['ms'] * 1e3:.3f} us, "
            f"plain {k['plain_ms'] * 1e3:.3f} us, bound {k['bound_ms'] * 1e3:.4f} us "
            f"({k['bound_by']}), launch floor {floor * 1e3:.3f} us, library "
            + ("n/a" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.3f} us"))


def phase_timings(rng, views, domains, starts, err, card) -> list[dict]:
    """Each kernel at each of its main-path shapes, with the operands the
    path hands it, beside a launch floor timed in the same harness."""
    import torch

    from repro_torch.kernels import ops

    dv = views[0]
    remix = dv.remix
    floor = launch_floor(card)

    # anchor_search at the two get batches: (G, 2) anchors, 256 / 65,536 queries
    anchor = [time_anchor(remix.anchors,
                          torch.from_numpy(_pack(probe(rng, domains[0], qn))).to(DEV),
                          "full tier", reps)
              for qn, reps in ((GET_SMALL, 50), (GET_LARGE, 20))]

    # selector_decode at the scan window (256 starts x 4 groups) and at the
    # 65,536-key get window (65,536 x 2 groups): group ids as ops hands them
    st = torch.from_numpy(_pack(starts[0])).to(DEV)
    gq = torch.from_numpy(_pack(probe(rng, domains[0], GET_LARGE))).to(DEV)
    windows = (("full tier, scan window", ops.seek(remix, dv.runset, st), SCAN_WIDTH, 50),
               (f"full tier, {GET_LARGE:,}-key get window",
                ops.seek(remix, dv.runset, gq), 1, 20))
    decode, e = [], 0
    for label, pos, width, reps in windows:
        rows, _ = ops.window_operands(remix, pos, width)
        k, ek = time_decode(remix, rows, label, reps)
        decode.append(k)
        e = max(e, ek)

    out = []
    for name, shapes, e_k in (("anchor_search", anchor, 0), ("selector_decode", decode, e)):
        log_timings(card, name, shapes, floor)
        out.append(dict(shapes[0], name=name, shapes=shapes, launch_floor_ms=floor,
                        max_abs_err=max(err[name], e_k)))
    return out


def profile_batches(label, fn, n):
    """Device idle share of ``n`` calls of ``fn``: device busy time from a
    profiler trace over the wall time of the same ``n`` calls run without
    the profiler (which slows the host side), and the kernels that take the
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern)
    if not kern:
        log(f"[profile] {label}: the profiler saw no device time (not measured)")
        return None
    by_name = {}
    for e in kern:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.end - e.time_range.start)
    log(f"[profile] {label}: {wall_us / n:.1f} us/batch wall ({traced_us / n:.1f} "
        f"under the profiler), {busy_us / n:.1f} us/batch device busy, idle share "
        f"{1 - busy_us / wall_us:.3f}, {len(kern) / n:.1f} kernels/batch")
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[profile]   {t / n:9.2f} us/batch  x{c // n:<3d} {name[:90]}")
    return dict(wall_us=wall_us / n, busy_us=busy_us / n, launches=len(kern) / n)


def phase_end_to_end(rng, mgr, views, domains, starts, card):
    import torch

    for qn, reps in ((GET_SMALL, 20), (GET_LARGE, 3)):
        keys = [probe(rng, d, qn) for d in domains]
        for i, v in enumerate(views):
            mgr.get_batch(v, keys[i], NOW)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for i, v in enumerate(views):
                mgr.get_batch(v, keys[i], NOW)
        dt = time.perf_counter() - t0
        n = reps * len(views) * qn
        log(f"[e2e] {card}: get_batch at {qn} keys: {dt / n * 1e6:.4f} us/key "
            f"({dt / (reps * len(views)) * 1e3:.3f} ms/batch)")
        profile_batches(f"{card}: get_batch at {qn} keys",
                        lambda: mgr.get_batch(views[0], keys[0], NOW), 10)
    for with_vals in (True, False):
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            for i, v in enumerate(views):
                mgr.scan_windows(v, starts[i], SCAN_WIDTH, NOW, with_vals=with_vals)
        dt = time.perf_counter() - t0
        n = reps * len(views) * SCAN_Q
        log(f"[e2e] {card}: scan_windows ({SCAN_Q} x {SCAN_WIDTH}, with_vals={with_vals}): "
            f"{dt / n * 1e6:.3f} us/query ({dt / (reps * len(views)) * 1e3:.3f} ms/batch)")
        profile_batches(
            f"{card}: scan_windows with_vals={with_vals}",
            lambda: mgr.scan_windows(views[0], starts[0], SCAN_WIDTH, NOW,
                                     with_vals=with_vals), 10)


def host_us(fn, n: int = 50) -> float:
    """Host µs a call of ``fn`` from its enqueue to the card's end: what a
    batch's caller waits, launch overheads included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def get_composition(remix, runset, exp, q, now, g, dec):
    """What get_resolve replaced: ``ops.get_live``'s eager torch after the
    seek's decode (the lower bound in the group, a one-slot window through
    a second selector_decode, the liveness and key compare); (found, vals,
    run, row)."""
    import torch

    from repro_torch.core import keys as CK
    from repro_torch.core.query import first_ge_slot
    from repro_torch.kernels import ops

    runid, absidx, _, pad = dec
    keys, _, _, _ = runset.gather(runid, absidx)
    keys = torch.where(pad[..., None], CK.INF_WORD, keys)
    s = first_ge_slot(~CK.key_lt(keys, q[:, None, :]), pad, remix.d)
    pos = torch.clamp(g * remix.d + s, max=remix.n_slots)
    keys, vals, valid, rid, row = ops.gather_view_live(remix, runset, exp, pos, now, 1)
    found = valid[:, 0] & CK.key_eq(keys[:, 0], q)
    return found, vals[:, 0], rid[:, 0], row[:, 0]


def phase_get_resolve(rng, card) -> dict:
    """get_resolve on views shaped like the benchmark's records
    (``RESOLVE_VIEWS``) at ``RESOLVE_QS`` queries as get_batch uploads
    them: bit for bit against its plain version and the composition it
    replaced, then timed beside that composition and its bytes bound."""
    import torch

    from repro_torch.db.partition import Partition, Table
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import get_resolve as GR
    from repro_torch.kernels import selector_decode as SD
    from repro_torch.kernels.device_view import DeviceViewManager

    floor = launch_floor(card)
    mgr = DeviceViewManager(1 << 30, device=DEV)
    shapes = []
    for vw, runs in RESOLVE_VIEWS:
        domain = np.sort(rng.choice(1 << 36, ENTRIES * runs * 3 // 4, replace=False)).astype(np.uint64)
        tables = []
        for i in range(runs):
            ttl = rng.random(ENTRIES) < 0.10
            tables.append(Table(
                keys=np.sort(rng.choice(domain, ENTRIES, replace=False)),
                seq=(np.arange(ENTRIES) + i * ENTRIES + 1).astype(np.uint32),
                vals=rng.integers(0, 2**32, (ENTRIES, vw), dtype=np.uint64).astype(np.uint32),
                tomb=rng.random(ENTRIES) < 0.05,
                exp=np.where(ttl, NOW + rng.integers(-999, 1000, ENTRIES), 0).astype(np.uint32)))
        remix, runset, exp = Partition(0, tables, d=D, device=DEV).device_index()
        sel = remix.selectors.reshape(remix.g, remix.d)
        for qn in RESOLVE_QS:
            q = mgr._queries(probe(rng, domain, qn))
            g = AS.anchor_search(remix.anchors, q)
            dec = SD.selector_decode(sel, remix.cursors, rows=g)
            args = (q, g, *dec, runset.keys, runset.vals, runset.tomb, exp, sel,
                    remix.cursors, NOW)
            label = f"VW={vw}, G={remix.g}, R={remix.r}, Q={qn}"
            got = GR.get_resolve(*args)
            check(torch.equal(got, GR.get_resolve_plain(*args)),
                  f"get_resolve differs from its plain version ({label})")
            f, v, rid, row = get_composition(remix, runset, exp, q, NOW, g, dec)
            check(torch.equal(got[:, 0] != 0, f) and torch.equal(got[:, 1], rid)
                  and torch.equal(got[:, 2], row) and torch.equal(got[:, 3:], v),
                  f"get_resolve differs from the composition it replaced ({label})")
            kern = lambda: GR.get_resolve(*args)  # noqa: E731
            comp = lambda: get_composition(remix, runset, exp, q, NOW, g, dec)  # noqa: E731
            ms, comp_ms = time_pair(kern, comp, 20 if qn > GET_SMALL else 50)
            us, comp_us = host_us(kern), host_us(comp)
            # queries and group ids, the decoded rows (10 bytes a slot), the
            # D slot keys, the answer's tomb, expiry, key and values; the
            # packed output. Operations: a KW-word compare and 4 more a slot.
            b, by = bound_ms(
                qn * (KW * 4 + 4) + qn * D * (10 + KW * 4) + qn * (5 + (KW + vw) * 4)
                + qn * (3 + vw) * 4, qn * D * (2 * KW + 4))
            log(f"[resolve] {card}: get_resolve ({label}): found {int(got[:, 0].sum())}; "
                f"host {us:.1f} us a call to completion, the composition {comp_us:.1f} us")
            shapes.append(dict(shape=f"views like YCSB C: {label}", ms=ms, plain_ms=comp_ms,
                               bound_ms=b, bound_by=by, library_ms=None,
                               host_us=us, plain_host_us=comp_us))
    log_timings(card, "get_resolve (plain: the composition it replaced)", shapes, floor)
    return dict(shapes[0], name="get_resolve", shapes=shapes, launch_floor_ms=floor,
                max_abs_err=0)


# a store batch's round trip (phase 4): kv120's 2^20 keys in 6 partitions of
# 3 tables (table_cap 65,536 of keys loaded in random order: disjoint),
# VW 30; a 256-key batch; each thread's calls
GROUP_PARTS, GROUP_TABLES, GROUP_KEYS, GROUP_VW = 6, 3, 1 << 20, 30
GROUP_BATCH, GROUP_CALLS, GROUP_THREADS = 256, 300, (1, 4)


def phase_grouped(rng, card) -> list[dict]:
    """A 256-key get over a kv120-shaped store's 6 views: in one
    ``get_batch`` (one upload, one fetch) against one call a view (six of
    each), from 1 and 4 threads at once, each thread ``GROUP_CALLS`` batches
    of its own keys after a warm-up; wall µs a batch (median, p10-p90),
    thread CPU µs a batch (the mean: the thread clock may tick at 10 ms) and
    syncs a batch. Every answer against a numpy oracle."""
    from repro_torch.db.partition import Partition, Table
    from repro_torch.kernels import device_view as DV

    pool = np.unique(rng.integers(0, 2**64 - 1, GROUP_KEYS + 4096, dtype=np.uint64))
    keys = np.sort(rng.choice(pool, GROUP_KEYS, replace=False))
    vals = rng.integers(0, 2**32, (GROUP_KEYS, GROUP_VW), dtype=np.uint64).astype(np.uint32)
    bounds = np.linspace(0, GROUP_KEYS, GROUP_PARTS + 1).astype(np.int64)
    los = keys[bounds[:-1]].copy()
    los[0] = 0
    mgr = DV.DeviceViewManager(1 << 30, device=DEV)
    views = []
    for lo, a, b in zip(los.tolist(), bounds[:-1], bounds[1:]):
        owner = rng.integers(0, GROUP_TABLES, b - a)  # disjoint tables, as a random load
        tables = []
        for t in range(GROUP_TABLES):
            idx = a + np.flatnonzero(owner == t)
            tables.append(Table(keys=keys[idx], vals=vals[idx], seq=(idx + 1).astype(np.uint32),
                                tomb=np.zeros(len(idx), bool),
                                exp=np.zeros(len(idx), np.uint32)))
        v = mgr.view_for(Partition(lo, tables, d=D, device=DEV))
        check(v is not None and v.tier == "full", "a kv120-shaped view is not on the full tier")
        views.append(v)

    def batch(r):
        """A batch's keys a view: 7/8 loaded keys, 1/8 drawn from the key space."""
        q = np.concatenate([keys[r.integers(0, GROUP_KEYS, GROUP_BATCH - GROUP_BATCH // 8)],
                            r.integers(0, 2**64 - 1, GROUP_BATCH // 8, dtype=np.uint64)])
        pidx = np.searchsorted(los, q, side="right") - 1
        return [q[pidx == i] for i in range(GROUP_PARTS)]

    def grouped(segs):
        return mgr.get_batch(views, segs, NOW)

    def per_view(segs):
        each = [mgr.get_batch(v, k, NOW) for v, k in zip(views, segs)]
        return np.concatenate([e[0] for e in each]), np.concatenate([e[1] for e in each])

    def held(segs, found, got, what):
        q = np.concatenate(segs)
        i = np.searchsorted(keys, q).clip(max=GROUP_KEYS - 1)
        hit = keys[i] == q
        check(np.array_equal(found, hit), f"{what}: found differs from the oracle")
        check(np.array_equal(got[hit], vals[i[hit]]), f"{what}: values differ from the oracle")

    segs = batch(np.random.default_rng(0))
    f, x = grouped(segs)
    fp, xp = per_view(segs)
    check(np.array_equal(f, fp) and np.array_equal(x, xp),
          "the grouped get differs from one call a view")
    held(segs, f, x, "grouped get")
    rows = []
    for threads in GROUP_THREADS:
        for mode, fn in (("grouped", grouped), ("per view", per_view)):
            go = threading.Barrier(threads)
            out = [None] * threads

            def worker(t, fn=fn, go=go, out=out):
                work = [batch(np.random.default_rng(1000 + t * 7919 + i))
                        for i in range(GROUP_CALLS + 10)]
                for segs in work[:10]:  # warm-up
                    fn(segs)
                wall, cpu, res = [], [], []
                go.wait()
                for segs in work[10:]:
                    t0, c0 = time.perf_counter(), time.thread_time()
                    res.append(fn(segs))
                    cpu.append(time.thread_time() - c0)
                    wall.append(time.perf_counter() - t0)
                out[t] = (wall, cpu, list(zip(work[10:], res)))

            s0 = DV.SYNCS
            ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=600)
            check(all(o is not None for o in out), f"{mode}, {threads} threads: a worker failed")
            syncs = (DV.SYNCS - s0) / (threads * (GROUP_CALLS + 10))
            for o in out:
                for segs, res in o[2]:
                    held(segs, *res, f"{mode}, {threads} threads")
            wall = np.concatenate([o[0] for o in out]) * 1e6
            cpu = np.concatenate([o[1] for o in out]) * 1e6
            row = dict(mode=mode, threads=threads, syncs=syncs,
                       wall_us=[float(np.percentile(wall, p)) for p in (50, 10, 90)],
                       cpu_us=float(cpu.mean()))
            rows.append(row)
            log(f"[group] {card}: {GROUP_BATCH}-key get over {GROUP_PARTS} views, {mode}, "
                f"{threads} thread(s) x {GROUP_CALLS}: wall {row['wall_us'][0]:.1f} us a batch "
                f"[p10 {row['wall_us'][1]:.1f}, p90 {row['wall_us'][2]:.1f}], thread CPU "
                f"{row['cpu_us']:.1f} us (mean), syncs a batch {syncs:.2f}")
            check(syncs == (1 if mode == "grouped" else GROUP_PARTS),
                  f"{mode}: {syncs} syncs a batch")
    log(f"[group] {card}: " + json.dumps({"grouped_get": rows}))
    return rows


# ---------------------------------------------------------------- phase 5
def build_index_partitions(rng, root: str):
    """Write each partition's tables (with CKBs) and its persisted REMIX
    through ``io.Storage``, commit a manifest, then reopen every partition
    from the manifest: lazy ``Table.from_file`` handles sharing one block
    cache, and the REMIX loaded onto the card and adopted with
    ``preload_index``."""
    from repro_torch.core.keys import pack_u64
    from repro_torch.db.partition import Partition, Table
    from repro_torch.io import BlockCache, Storage, load_remix

    storage = Storage(root)
    entries, domains, oracles = [], [], []
    t0 = time.perf_counter()
    for i in range(IDX_PARTITIONS):
        lo = (N_PARTITIONS + i) << 40
        domain, tables = make_tables(rng, lo, IDX_ENTRIES, IDX_DOMAIN)
        names = [storage.write_table(pack_u64(t.keys), t.vals, t.seq, t.tomb, exp=t.exp)
                 for t in tables]
        w = IDX_DOMAIN // 64  # keys the range delete spans
        a = int(rng.integers(0, IDX_DOMAIN - w))
        span = [int(domain[a]), int(domain[a + w]), 6 * IDX_ENTRIES + 1]
        writer = Partition(lo, tables[:6], d=D, device=DEV)
        writer.attach_excised(*span)
        writer.tables.extend(tables[6:])
        writer.persist_index(storage)
        entries.append(dict(lo=lo, tables=names, remix=writer.remix_name, span=span))
        domains.append(domain)
        oracles.append(oracle(tables, [(np.uint64(span[0]), np.uint64(span[1]),
                                        set(range(6)))]))
        del writer, tables
    storage.commit({"partitions": entries})
    t_write = time.perf_counter() - t0

    state = Storage(root).load_state()
    cache = BlockCache(CACHE_BYTES)
    parts = []
    for pe in state["partitions"]:
        handles = [Table.from_file(storage.table_path(n)) for n in pe["tables"]]
        for t in handles:
            t.attach_cache(cache)
        p = Partition(pe["lo"], handles[:6], d=D, device=DEV)
        p.attach_excised(*pe["span"])
        p.tables.extend(handles[6:])
        p.preload_index(load_remix(storage.remix_path(pe["remix"]), device=DEV))
        parts.append(p)
    disk = sum(os.path.getsize(storage.table_path(n)) for pe in entries for n in pe["tables"])
    log(f"[index] {IDX_PARTITIONS} partitions x {R} runs x {IDX_ENTRIES} entries "
        f"generated, written ({disk} table bytes on disk) and persisted in "
        f"{t_write:.1f} s; reopened from the manifest: {parts[0]!r}")
    return parts, domains, oracles, cache


def _section_reads(p, section: str) -> int:
    return sum(t._rd().bytes_read[section] for t in p.tables)


def index_batch(mgr, v, orc, what, q):
    """One batch of the phase's traffic over view ``v``, under sync debug
    "error" and checked against the oracle; returns its wall seconds."""
    from repro_torch.kernels import device_view as DV

    kind, arg = what
    s0 = DV.SYNCS
    t0 = time.perf_counter()
    with sync_debug_error():
        if kind == "get":
            found, vals = mgr.get_batch(v, q, NOW)
        else:
            rows = mgr.scan_windows(v, q, SCAN_WIDTH, NOW, with_vals=arg)
    secs = time.perf_counter() - t0
    syncs = DV.SYNCS - s0
    if kind == "get":
        want = 1
        f_o, v_o = oracle_get(orc, q)
        check(np.array_equal(found, f_o), f"index get_batch {arg}: found differs")
        check(np.array_equal(vals[found], v_o[found]), f"index get_batch {arg}: values differ")
    else:
        want = -(-len(q) // SLICE_WIDTH) if arg else 1
        check_scan(orc, q, rows, arg, f"index scan_windows(with_vals={arg})")
    check(syncs == want, f"index {what}: {syncs} syncs, expected {want}")
    return secs


def profile_pipeline(mgr, v, starts, card):
    """Profile one pipelined scan: device busy and idle share, and whether
    slice i+1's first REMIX kernel starts on the card before slice i's
    host value gather (a ``record_function`` range) ends."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call = lambda: mgr.scan_windows(v, starts, SCAN_WIDTH, NOW, with_vals=True)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    evs = prof.events()
    kern = sorted((e for e in evs if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern)
    gathers = sorted((e.time_range.start, e.time_range.end) for e in evs
                     if e.name == "device_view.value_gather")
    # a slice's device work ends with the copies of its outputs: split the
    # device timeline at each run of device->host copies
    slices, cur = [[]], None
    for e in kern:
        fetch = "DtoH" in e.name
        if cur is True and not fetch:
            slices.append([])
        slices[-1].append(e)
        cur = fetch
    ours = [[e.time_range.start for e in sl
             if "search_kernel" in e.name or "selector_decode_kernel" in e.name]
            for sl in slices]
    nsl = -(-len(starts) // SLICE_WIDTH)
    check(len(gathers) == nsl and len(slices) == nsl and all(ours),
          f"profiled scan: {len(gathers)} gathers, {len(slices)} device slices with "
          f"{[len(o) for o in ours]} REMIX kernels, for {nsl} slices")
    lead = [gathers[i][1] - min(ours[i + 1]) for i in range(nsl - 1)]
    idle_gap = [min(ours[i + 1]) - slices[i][-1].time_range.end for i in range(nsl - 1)]
    log(f"[index] {card}: profiled scan_windows ({len(starts)} x {SCAN_WIDTH}, values, "
        f"{nsl} slices): {wall_us:.1f} us wall unprofiled, {busy_us:.1f} us device "
        f"busy, idle share {1 - busy_us / wall_us:.3f}, {len(kern)} device ops "
        f"({[len(o) for o in ours]} REMIX kernels per slice); slice i+1's first "
        f"REMIX kernel starts {', '.join(f'{x:.1f}' for x in lead)} us before slice "
        f"i's host gather ends, {', '.join(f'{x:.1f}' for x in idle_gap)} us after "
        f"slice i's copies; gathers take "
        f"{', '.join(f'{b - a:.1f}' for a, b in gathers)} us")
    check(all(x > 0 for x in lead), "slice i+1's kernels did not start before "
                                    "slice i's host gather ended")


def granule_costs(p, cache, card, per_table: int = 8):
    """Host µs per missed 64 KB value granule, split: the file read alone
    (open, seek, read), the CRC32C alone, and the whole miss
    (``read_block`` with the block cache cleared: read, CRC, cache
    insert), over ``per_table`` granules spread across each table's
    vals section."""
    from repro_torch.io.checksum import crc32c

    picks = []
    for t in p.tables:
        r = t._rd()
        blocks = r.section_row_blocks("vals", 0, r.n)
        picks += [(r, bi) for bi in blocks[:: max(1, len(blocks) // per_table)][:per_table]]
    chunks = []
    t0 = time.perf_counter()
    for r, bi in picks:
        with open(r.path, "rb") as f:
            f.seek(r._data_start + bi * r.block_bytes)
            chunks.append(f.read(r.block_bytes))
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    crcs = [crc32c(c) for c in chunks]
    t_crc = time.perf_counter() - t0
    check(all(c == int(r._crcs[bi]) for c, (r, bi) in zip(crcs, picks)), "granule CRC mismatch")
    cache.clear()
    t0 = time.perf_counter()
    for r, bi in picks:
        r.read_block(bi)
    t_miss = time.perf_counter() - t0
    cache.clear()
    n = len(picks)
    us = dict(read=t_read / n * 1e6, crc=t_crc / n * 1e6, miss=t_miss / n * 1e6)
    log(f"[index] {card}: host cost per missed 64 KB value granule ({n} granules, "
        f"files written seconds before): file read {us['read']:.1f} us, CRC32C "
        f"{us['crc']:.1f} us, whole miss (read_block: read, CRC, cache insert) "
        f"{us['miss']:.1f} us")
    return us


def profile_first_pass(mgr, v, cache, q, card):
    """cProfile one first-pass get_batch (the block cache cleared): host
    seconds in the CRC32C, in file reads, and in the functions that take
    the most time of their own."""
    import cProfile
    import pstats

    cache.clear()
    m0 = cache.stats()["misses"]
    pr = cProfile.Profile()
    pr.enable()
    mgr.get_batch(v, q, NOW)
    pr.disable()
    misses = cache.stats()["misses"] - m0
    st = pstats.Stats(pr).stats  # (file, line, func) -> (cc, nc, tt, ct, callers)
    total = sum(tt for _, _, tt, _, _ in st.values())

    def cum(func, file_end):
        return sum(ct for (f, _, fn), (_, _, _, ct, _) in st.items()
                   if fn == func and f.endswith(file_end))

    crc, load = cum("crc32c", "checksum.py"), cum("load", "sstable.py")
    log(f"[index] {card}: cProfile of a first-pass get_batch at {len(q)} keys "
        f"({misses} misses): {total * 1e3:.1f} ms of host time; crc32c "
        f"{crc * 1e3:.1f} ms ({crc / total:.3f}), granule loads (open, read, CRC) "
        f"{load * 1e3:.1f} ms ({load / total:.3f}); "
        f"{(load - crc) / max(1, misses) * 1e6:.1f} us open and read and "
        f"{crc / max(1, misses) * 1e6:.1f} us CRC per miss")
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:6]
    for (f, line, fn), (_, nc, tt, ct, _) in top:
        log(f"[index]   own {tt * 1e3:8.2f} ms  cum {ct * 1e3:8.2f} ms  x{nc:<6d} "
            f"{os.path.basename(f)}:{line}({fn})")
    cache.clear()


def phase_index_tier(rng, root, card):
    """Drive the index tier; returns the kernels' launches over the phase
    and, per partition, its view and the batches it took (the operands
    ``view_kernels`` checks the kernels on)."""
    import torch

    from repro_torch.kernels import device_view as DV
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.metrics import MetricsRegistry

    parts, domains, oracles, cache = build_index_partitions(rng, root)
    reg, ev = MetricsRegistry(), EventLog(capacity=256)
    mgr = DV.DeviceViewManager(DEVICE_BUDGET, slice_width=SLICE_WIDTH,
                               registry=reg, events=ev, device=DEV)
    _set_launch_counts({k: 0 for k in _launch_counts()})
    VIEW_GETS[0] = 0
    driven = []
    for i, p in enumerate(parts):
        est = (p.device_view_bytes(True), p.device_view_bytes(False))
        t0 = time.perf_counter()
        v = mgr.view_for(p)
        torch.cuda.synchronize()
        up = time.perf_counter() - t0
        check(v is not None and v.tier == "index",
              f"partition {i}: tier {None if v is None else v.tier}, expected index")
        check(p.last_build_kind == "reuse", f"upload built {p.last_build_kind!r}")
        check(_section_reads(p, "vals") == 0, "the upload read value bytes")
        check(v.remix.g in ANCHOR_GS, f"index-tier G {v.remix.g} not in the kernel sweep")
        log(f"[index] partition {i}: estimates full {est[0]} / index {est[1]} bytes "
            f"against the {DEVICE_BUDGET}-byte budget; uploaded tier {v.tier}, "
            f"{v.nbytes} bytes, padded G {v.remix.g}, in {up:.2f} s (REMIX "
            f"{p.last_build_kind}; read keys {_section_reads(p, 'keys')}, seq "
            f"{_section_reads(p, 'seq')}, tomb {_section_reads(p, 'tomb')}, exp "
            f"{_section_reads(p, 'exp')}, vals 0 bytes); resident {mgr.resident_bytes}")
        if i:
            evicted = [(e.fields["lo"], e.fields["reason"]) for e in ev.list("device_evict")]
            check((parts[i - 1].lo, "budget") in evicted,
                  f"uploading partition {i} did not evict partition {i - 1}: {evicted}")
            check(mgr.resident_bytes == v.nbytes and len(mgr) == 1, "two views resident")
        starts = probe(rng, domains[i], SCAN_Q)
        gets = {n: probe(rng, domains[i], n) for n in (GET_SMALL, GET_LARGE)}
        traffic = ((("get", GET_SMALL), gets[GET_SMALL], GET_SMALL, "key"),
                   (("get", GET_LARGE), gets[GET_LARGE], GET_LARGE, "key"),
                   (("scan", True), starts, SCAN_Q, "query"),
                   (("scan", False), starts, SCAN_Q, "query"))
        for what, q, n, unit in traffic:
            # first pass: the block cache just cleared; warm: the same batch
            # again at once; each pair REPEATS times
            runs = {"first": [], "warm": []}
            counts = {"first": set(), "warm": set()}
            for _ in range(REPEATS):
                cache.clear()
                for label in ("first", "warm"):
                    c0 = cache.stats()
                    runs[label].append(index_batch(mgr, v, oracles[i], what, q) / n * 1e6)
                    c1 = cache.stats()
                    counts[label].add(tuple(c1[k] - c0[k] for k in ("hits", "misses",
                                                                   "evictions")))
            parts_ = [f"{label} {np.median(runs[label]):.3f} us/{unit} median of "
                      f"{', '.join(f'{x:.3f}' for x in runs[label])} (cache hits, misses, "
                      f"evictions {' / '.join(str(c) for c in sorted(counts[label]))})"
                      for label in ("first", "warm")]
            kind = (f"get_batch at {n} keys" if what[0] == "get" else
                    f"scan_windows {n} x {SCAN_WIDTH}, with_vals={what[1]}")
            log(f"[index] {card}: partition {i}: {kind}: " + "; ".join(parts_))
        granule_costs(p, cache, card)
        profile_first_pass(mgr, v, cache, gets[GET_SMALL], card)
        profile_pipeline(mgr, v, starts, card)
        batches = [("get, 256 keys", gets[GET_SMALL], 1),
                   (f"get, {GET_LARGE:,} keys", gets[GET_LARGE], 1),
                   (f"scan without values, {SCAN_Q} starts", starts, SCAN_WIDTH)]
        batches += [(f"scan slice {k}", starts[k * SLICE_WIDTH:(k + 1) * SLICE_WIDTH],
                     SCAN_WIDTH) for k in range(-(-SCAN_Q // SLICE_WIDTH))]
        driven.append((v, batches))
    fallback = _metric(reg, "device_fallback_total")
    launches, gets = _launch_counts(), VIEW_GETS[0]
    log(f"[index] launches {launches}; get batches {gets}; device_fallback_total {fallback}; events "
        f"{[(e.kind, e.fields['lo'], e.fields.get('reason')) for e in ev.list()]}; "
        f"answers equal to the oracle; syncs 1 per get, 1 per scan without values, "
        f"{-(-SCAN_Q // SLICE_WIDTH)} per scan with values")
    check(fallback == 0, "device_fallback_total != 0")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check(launches["get_resolve"] == gets,
          f"get_resolve launched {launches['get_resolve']} times for {gets} get batches")
    return launches, mgr, driven


def hold_kernels(remix, runset, q, widths, what, err) -> None:
    """Both kernels on one batch as a path hands them: the (Q, KW) query
    words ``q`` against ``remix``'s anchors, then the seek's group ids and
    the group ids of a window of each of ``widths`` from the seek's
    positions, each against its plain version bit for bit."""
    import torch

    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import ops
    from repro_torch.kernels import selector_decode as SD

    sel = remix.selectors.reshape(remix.g, D)
    g = AS.anchor_search(remix.anchors, q)
    check(torch.equal(g, AS.anchor_search_plain(remix.anchors, q)),
          f"{what}: anchor_search differs from its plain version")
    pos = ops.seek(remix, runset, q)
    for rows in [g] + [ops.window_operands(remix, pos, w)[0] for w in widths]:
        got = SD.selector_decode(sel, remix.cursors, rows=rows)
        want = SD.selector_decode_plain(sel, remix.cursors, rows=rows)
        e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        err["selector_decode"] = max(err["selector_decode"], e)
        check(e == 0, f"{what}: selector_decode differs from its plain version "
                      f"(N={rows.shape[0]})")


def hold_views(mgr, driven, tier, tag) -> dict:
    """``hold_kernels`` on every partition's view and batch in ``driven``
    (see ``view_kernels``); returns each kernel's max |err| (0)."""
    err = {"anchor_search": 0, "selector_decode": 0}
    cases = 0
    for v, batches in driven:
        for label, keys, width in batches:
            hold_kernels(v.remix, v.runset, mgr._queries(keys), [width], f"{tier} {label}", err)
            cases += 1
    log(f"[{tag}] both kernels on the {tier}'s operands of {len(driven)} partitions "
        f"(anchors G {sorted({v.remix.g for v, _ in driven})}; Q "
        f"{sorted({len(k) for _, b in driven for _, k, _ in b})}; seek and window group "
        f"ids): {cases} cases bit-identical to the plain versions")
    return err


def view_kernels(mgr, driven, card, tier="index tier", tag="index") -> tuple[dict, dict]:
    """Both kernels on a path's own operands: each partition's uploaded
    anchors and group tables (the index tier: padded G 2^19), the queries
    as ``get_batch`` / ``scan_windows`` upload them (the index tier: Q 64
    per scan slice, 256, 65,536), the group ids the seek produces and the
    window's group ids; every case against its plain version bit for bit,
    then the first partition's distinct shapes timed beside their bounds."""
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import ops

    err = hold_views(mgr, driven, tier, tag)
    v, batches = driven[0]
    remix = v.remix
    floor = launch_floor(card)
    anchor, decode = [], []
    seen_q = set()
    for label, keys, width in batches[:4]:  # the gets, the scan, one scan slice
        q = mgr._queries(keys)
        reps = 20 if len(keys) > GET_SMALL else 50
        if len(keys) not in seen_q:
            seen_q.add(len(keys))
            anchor.append(time_anchor(remix.anchors, q, f"{tier}, {label}", reps))
        g = AS.anchor_search(remix.anchors, q)
        win, _ = ops.window_operands(remix, ops.seek(remix, v.runset, q), width)
        if label.startswith("get") or label.startswith("scan slice"):
            decode.append(time_decode(remix, g, f"{tier}, {label}, seek", reps)[0])
        decode.append(time_decode(remix, win, f"{tier}, {label}, window", reps)[0])
    log_timings(card, "anchor_search", anchor, floor)
    log_timings(card, "selector_decode", decode, floor)
    return {"anchor_search": anchor, "selector_decode": decode}, err


# ---------------------------------------------------------------- phase 6
class StoreOracle:
    """Independent model of the store's live map: every write the phase
    issues, in order, resolved with numpy at query time (newest write per
    key wins, a range delete hides the writes before it, a TTL expires at
    ``exp <= now``)."""

    def __init__(self, vw: int):
        self.vw = vw
        self.keys, self.vals, self.exp, self.tomb, self.order = [], [], [], [], []
        self.ranges = []  # (lo, hi, order)
        self.n = 0

    def _add(self, keys, vals, exp, tomb):
        keys = np.asarray(keys, np.uint64)
        self.keys.append(keys)
        self.vals.append(np.asarray(vals, np.uint32).reshape(len(keys), self.vw))
        self.exp.append(np.broadcast_to(np.asarray(exp, np.uint32), len(keys)))
        self.tomb.append(np.full(len(keys), tomb))
        self.order.append(self.n + np.arange(len(keys), dtype=np.int64))
        self.n += len(keys)

    def put(self, keys, vals, exp=0):
        self._add(keys, vals, exp, False)

    def delete(self, keys):
        self._add(keys, np.zeros((len(keys), self.vw), np.uint32), 0, True)

    def delete_range(self, lo, hi):
        self.ranges.append((lo, hi, self.n))
        self.n += 1

    def resolve(self, now):
        keys = np.concatenate(self.keys)
        order = np.concatenate(self.order)
        idx = np.lexsort((-order, keys))
        ks = keys[idx]
        first = np.ones(len(ks), bool)
        first[1:] = ks[1:] != ks[:-1]
        top = idx[first]
        vals = np.concatenate(self.vals)[top]
        exp = np.concatenate(self.exp)[top]
        dead = np.concatenate(self.tomb)[top] | ((exp != 0) & (exp <= np.uint32(now)))
        for lo, hi, o in self.ranges:
            dead |= (keys[top] >= np.uint64(lo)) & (keys[top] < np.uint64(hi)) & (order[top] < o)
        self.all_keys = keys[top]
        self.live_keys, self.live_vals = keys[top][~dead], vals[~dead]
        self.dead_keys = keys[top][dead]
        self.expired = keys[top][(exp != 0) & (exp <= np.uint32(now))]
        self.overwritten = np.unique(ks[~first])
        return self

    def get(self, q):
        lk = self.live_keys
        i = np.searchsorted(lk, q)
        ic = np.minimum(i, len(lk) - 1)
        found = (i < len(lk)) & (lk[ic] == q)
        return found, self.live_vals[ic]

    def scan(self, start, n):
        i = int(np.searchsorted(self.live_keys, np.uint64(start)))
        return self.live_keys[i:i + n], self.live_vals[i:i + n]


@contextlib.contextmanager
def count_syncs():
    """Count the batch's device syncs: result fetches (``device_view.SYNCS``,
    whose event waits run with the sync debug mode off) and every other
    synchronising call, which the ``warn`` mode reports as a warning."""
    import warnings

    import torch

    from repro_torch.kernels import device_view as DV

    box = {"fetch": DV.SYNCS, "other": 0}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if DEV == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            if DEV == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    box["fetch"] = DV.SYNCS - box["fetch"]
    box["other"] = sum("synchroniz" in str(w.message) for w in caught)


def _store_probe(rng, orc, q):
    """Live hits, 1/8 misses, and deleted, expired and overwritten keys."""
    q_miss = q // 8
    q_special = q // 8
    special = np.concatenate([orc.dead_keys, orc.expired, orc.overwritten])
    parts = [rng.choice(orc.live_keys, q - q_miss - q_special),
             rng.integers(0, STORE_DOMAIN, q_miss, dtype=np.uint64),
             rng.choice(special, q_special)]
    out = np.concatenate(parts).astype(np.uint64)
    rng.shuffle(out)
    return out


def _touched(db, keys) -> list:
    """Partitions a get_batch sends keys to: those not answered by the
    memtable overlay or hidden by an unflushed range tombstone."""
    from repro_torch.db.sharded import route_host

    over = np.array(sorted(db.mem.data.keys()), np.uint64)
    rest = keys[~np.isin(keys, over)]
    rest = np.array([k for k in rest.tolist() if not db.mem.covers(k)], np.uint64)
    return [db.partitions[i] for i in np.unique(route_host([p.lo for p in db.partitions], rest))]


def _sync_rule(db, parts) -> str | None:
    """What a batch over these partitions may synchronise, known before it
    runs. ``"view"``: the device-view path with every view resident, which
    waits on the card only for its one fetch per partition (the batch runs
    under the sync debug mode ``error``). ``"legacy"``: the legacy path
    (``p.index()`` plus the query module) with every index built, whose
    copies block as the reference's ``jnp.asarray`` / ``np.asarray`` do:
    ``LEGACY_COPIES`` per partition, none a fetch. None: a first pass that
    uploads views or builds indexes, or a cold read; its syncs are counted
    and printed."""
    if db.device_views is not None:
        resident = db.device_views._views
        return "view" if all(id(p) in resident for p in parts) else None
    if DEV == "cuda" and not db.cfg.cold_reads and all(p._remix is not None for p in parts):
        return "legacy"
    return None


def _kernel_fns():
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import get_resolve as GR
    from repro_torch.kernels import selector_decode as SD

    return {"anchor_search": AS.anchor_search, "selector_decode": SD.selector_decode,
            "get_resolve": GR.get_resolve}


def _launch_counts():
    return {k: f.launches for k, f in _kernel_fns().items()}


def _set_launch_counts(counts):
    for k, f in _kernel_fns().items():
        f.launches = counts[k]


# views of device-view get batches on the card since the last reset: each
# view of a batch ends in one get_resolve launch (``count_view_gets``)
VIEW_GETS = [0]
_VIEW_GETS_LOCK = threading.Lock()


def count_view_gets():
    """Count the views on the card of each ``DeviceViewManager.get_batch``
    (one view, or a store batch's list of them) into ``VIEW_GETS``, from
    whichever thread the store calls it."""
    from repro_torch.kernels import device_view as DV

    inner = DV.DeviceViewManager.get_batch

    def get_batch(self, dv, keys_u64, now):
        views = [dv] if isinstance(dv, DV.DeviceView) else dv
        n = sum(v.remix.anchors.is_cuda for v in views)
        with _VIEW_GETS_LOCK:
            VIEW_GETS[0] += n
        return inner(self, dv, keys_u64, now)

    DV.DeviceViewManager.get_batch = get_batch


def run_counted(tag, stage, fn, launches, require=True):
    """``fn()`` with the kernels' launch counts and ``VIEW_GETS`` set to 0
    just before it and read just after (before any kernel check launches
    more), added into ``launches``; fails if get_resolve's launches are
    not the views of the stage's device-view get batches, or if
    ``require`` and the seek's two kernels never launched."""
    _set_launch_counts({k: 0 for k in _launch_counts()})
    VIEW_GETS[0] = 0
    out = fn()
    got, gets = _launch_counts(), VIEW_GETS[0]
    log(f"[{tag}] {stage}: kernel launches {got}; views of device-view get batches {gets}")
    check(not require or all(got[k] > 0 for k in ("anchor_search", "selector_decode")),
          f"{stage}: a kernel never launched: {got}")
    check(got["get_resolve"] == gets,
          f"{stage}: get_resolve launched {got['get_resolve']} times for {gets} views of get "
          "batches")
    for k, n in got.items():
        launches[k] += n
    return out


def _shards(target):
    """(lows, stores) of a store (one range) or of a ``Cluster`` (its shards)."""
    serve = getattr(target, "serve", None)
    return ([0], [target]) if serve is None else (list(serve.lows), list(serve.shards))


def _routed(target, keys) -> list:
    """(store, its keys) for each shard of ``target`` that ``keys`` reach."""
    from repro_torch.db.sharded import route_host

    lows, stores = _shards(target)
    owner = route_host(lows, keys)
    return [(stores[i], keys[owner == i]) for i in np.unique(owner)]


def _one_rule(rules) -> str | None:
    """The batch's rule: its shards' rule when they agree, else None."""
    rules = set(rules)
    return rules.pop() if len(rules) == 1 else None


def _store_get(target, orc, keys, what):
    """One get_batch of a store or a fleet against the oracle, its syncs
    held to ``_sync_rule`` over every shard it reaches (on the view path
    one fetch a store reached, whatever its touched partitions); returns
    seconds, syncs, touched partitions and the rule."""
    import torch

    per = [(db, _touched(db, k)) for db, k in _routed(target, keys)]
    touched = sum(len(ps) for _, ps in per)
    rule = _one_rule(_sync_rule(db, ps) for db, ps in per)
    stores = _shards(target)[1]
    b0 = sum(_metric(db.registry, "device_batches") for db in stores)
    with count_syncs() as syncs:
        ctx = sync_debug_error() if rule == "view" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            found, vals = target.get_batch(keys)
        dt = time.perf_counter() - t0
    f_o, v_o = orc.get(keys)
    check(np.array_equal(found, f_o), f"{what}: found differs from the oracle")
    check(np.array_equal(vals[found], v_o[found]), f"{what}: values differ from the oracle")
    dev_batches = sum(_metric(db.registry, "device_batches") for db in stores) - b0
    if rule == "view":  # one round trip a store reached, a device batch a partition
        reached = sum(1 for _, ps in per if ps)
        check(syncs["fetch"] == reached and dev_batches == touched and syncs["other"] == 0,
              f"{what}: {syncs} syncs, {dev_batches} device batches for {touched} "
              f"touched partitions in {reached} stores")
    if rule == "legacy":
        check(syncs["fetch"] == 0 and syncs["other"] == LEGACY_COPIES["get"] * touched,
              f"{what}: {syncs} syncs on the legacy path for {touched} touched partitions")
    if DEV == "cuda":
        torch.cuda.synchronize()
    return dt, syncs, touched, rule


def _store_scan_batch(target, orc, starts, n, what):
    """One scan_batch of a store or a fleet against the oracle, counting
    the cursor fallbacks and a fleet's drains into the next shard (both
    ``RemixDB._scan_at`` calls) and their syncs apart from the batch's own.
    Over empty overlays the batch takes one window call per touched
    partition, and its syncs are held to ``_sync_rule``: on the view path
    it runs under the sync debug mode ``error``, each fallback under
    ``warn``. Over a non-empty overlay every query takes the cursor."""
    import warnings

    import torch

    from repro_torch.db.sharded import route_host

    per = [(db, [db.partitions[i] for i in
                 np.unique(route_host([p.lo for p in db.partitions], s))])
           for db, s in _routed(target, starts)]
    parts = sum(len(ps) for _, ps in per)
    rule = (None if any(len(db.mem) or db.mem.ranges for db, _ in per)
            else _one_rule(_sync_rule(db, ps) for db, ps in per))
    falls = [0, 0]  # fallbacks, their syncs
    stores = _shards(target)[1]

    def counted(orig):
        def scan_at(*a, **kw):
            falls[0] += 1
            mode = torch.cuda.get_sync_debug_mode() if DEV == "cuda" else 0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if DEV == "cuda":
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    return orig(*a, **kw)
                finally:
                    if DEV == "cuda":
                        torch.cuda.set_sync_debug_mode(mode)
                    falls[1] += sum("synchroniz" in str(w.message) for w in caught)
        return scan_at

    for db in stores:
        db._scan_at = counted(db._scan_at)
    try:
        with count_syncs() as syncs:
            ctx = sync_debug_error() if rule == "view" else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                kk, mm = target.scan_batch(starts, n)
            dt = time.perf_counter() - t0
    finally:
        for db in stores:
            del db._scan_at
    for i, s in enumerate(starts.tolist()):
        ko, _ = orc.scan(s, n)
        check(np.array_equal(kk[i][mm[i]], ko), f"{what}: row {i} differs from the oracle")
    want = {"view": (parts, 0), "legacy": (0, LEGACY_COPIES["scan"] * parts)}.get(rule)
    check(want is None or (syncs["fetch"], syncs["other"]) == want,
          f"{what}: {syncs} syncs besides {falls[1]} in {falls[0]} cursor fallbacks "
          f"for {parts} touched partitions ({rule} path)")
    return dt, syncs, falls, parts, rule


def _read_pairs(target, orc, rng, stage, card, tag="store", starts_fn=None, repeats=REPEATS):
    """get_batch at 256 and 65,536 keys and scan_batch of 256 starts x 50
    on a store or a fleet, ``repeats`` first/warm pairs each (µs per key or per
    query, median with min-max). Each batch's syncs are held to
    ``_sync_rule`` (the rule is printed with them: view, legacy, or None
    where the batch uploads, builds or reads cold). ``starts_fn(rng)``
    picks the scan starts (default: live keys at random). Returns every
    batch's (pass, rule, touched partitions, ...) notes."""
    seen = set()
    for q in (STORE_GET_SMALL, STORE_GET_LARGE):
        runs = {"first": [], "warm": []}
        notes = set()
        for _ in range(repeats):
            keys = _store_probe(rng, orc, q)
            for label in ("first", "warm"):
                dt, syncs, touched, rule = _store_get(
                    target, orc, keys, f"{stage} get_batch {q} {label}")
                runs[label].append(dt / q * 1e6)
                notes.add((label, str(rule), touched, syncs["fetch"], syncs["other"]))
        log(f"[{tag}] {card}: {stage}: get_batch at {q} keys: " + "; ".join(
            f"{label} {np.median(v):.4f} us/key (min {min(v):.4f}, max {max(v):.4f})"
            for label, v in runs.items())
            + "; (pass, sync rule, touched partitions, fetch syncs, other syncs) "
            f"{sorted(notes)}")
        seen |= notes
    runs = {"first": [], "warm": []}
    notes = set()
    for _ in range(repeats):
        starts = (starts_fn(rng) if starts_fn is not None else
                  np.sort(rng.choice(orc.live_keys, STORE_SCAN_Q)).astype(np.uint64))
        for label in ("first", "warm"):
            dt, syncs, falls, touched, rule = _store_scan_batch(
                target, orc, starts, STORE_SCAN_N, f"{stage} scan_batch {label}")
            runs[label].append(dt / len(starts) * 1e6)
            notes.add((label, str(rule), touched, falls[0], falls[1], syncs["fetch"],
                       syncs["other"]))
    log(f"[{tag}] {card}: {stage}: scan_batch {STORE_SCAN_Q} x {STORE_SCAN_N}: " + "; ".join(
        f"{label} {np.median(v):.3f} us/query (min {min(v):.3f}, max {max(v):.3f})"
        for label, v in runs.items())
        + "; (pass, sync rule, touched partitions, cursor fallbacks, their syncs, "
        f"fetch syncs, other syncs) {sorted(notes)}")
    return seen | notes


def _store_reads(db, orc, rng, stage, card):
    """``_read_pairs`` on the store, then a single scan and a cursor across
    a partition boundary."""
    _read_pairs(db, orc, rng, stage, card)
    parts = db.partitions
    lows = [p.lo for p in parts]
    s = int(rng.choice(orc.live_keys))
    kk, vv = db.scan(s, STORE_SCAN_N)
    ko, vo = orc.scan(s, STORE_SCAN_N)
    check(np.array_equal(kk, ko) and np.array_equal(vv, vo), f"{stage}: scan differs")
    check(len(parts) > 1, f"{stage}: one partition; no boundary to cross")
    b = int(lows[len(lows) // 2])
    start = int(orc.live_keys[max(0, np.searchsorted(orc.live_keys, np.uint64(b)) - 100)])
    with db.cursor(start, width=64) as cur:
        kk, vv = cur.next_batch(300)
    ko, vo = orc.scan(start, 300)
    check(np.array_equal(kk, ko) and np.array_equal(vv, vo),
          f"{stage}: cursor across the boundary at {b} differs")
    check(kk[0] < b <= kk[-1], f"{stage}: the cursor did not cross {b}")
    log(f"[store] {stage}: scan({s}, {STORE_SCAN_N}) and a cursor of 300 entries "
        f"across the partition boundary at {b} equal the oracle")


def _store_memory(db, stage, base):
    """The store's device bytes: its views (``hbm_resident_bytes``) beside
    what torch allocated since the phase began (``base``: the earlier
    phases' views stay allocated), which also holds each partition's
    plain index built by compaction, the cursor and the legacy path."""
    import torch

    alloc = torch.cuda.memory_allocated() - base if DEV == "cuda" else 0
    peak = torch.cuda.max_memory_allocated() - base if DEV == "cuda" else 0
    log(f"[store] {stage}: hbm_resident_bytes {_metric(db.registry, 'hbm_resident_bytes')} "
        f"(views {0 if db.device_views is None else len(db.device_views)}); since the "
        f"phase began torch.cuda.memory_allocated {alloc}, max_memory_allocated {peak}; "
        f"partitions with a plain index on the card "
        f"{sum(p._remix is not None for p in db.partitions)}")


def _store_load(db, orc, rng) -> int:
    """``STORE_KEYS`` put_batch keys in batches of ``STORE_BATCH``, then a
    last batch of ``STORE_TAIL`` keys that stops short of a memtable flush
    (unflushed writes for the overlay and the WAL replay): 20% overwrites
    of earlier keys, TTLs on 10% (half of them expired at ``NOW``), 1%
    point deletes per batch through one Batch of Op.delete, one
    delete_range a third of the way in. Returns the keys put."""
    from repro_torch.db.ops import Batch, Op

    nb = STORE_KEYS // STORE_BATCH + 1
    pool = np.zeros(0, np.uint64)
    n_put = 0
    for b in range(nb):
        n = STORE_BATCH
        if b == nb - 1:
            n = min(STORE_TAIL, (db.cfg.memtable_entries - len(db.mem)) * 9 // 10)
        over = rng.choice(pool, n // 5) if len(pool) else pool
        keys = np.unique(np.concatenate([
            rng.integers(0, STORE_DOMAIN, n - len(over), dtype=np.uint64), over]))
        rng.shuffle(keys)
        vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
        ttl = rng.random(len(keys)) < 0.10
        ttls = np.where(rng.random(int(ttl.sum())) < 0.5, TTL_SHORT, TTL_LONG)
        dels = rng.choice(pool if len(pool) else keys, n // 100)
        db.put_batch(keys[~ttl], vals[~ttl])
        db.put_batch(keys[ttl], vals[ttl], ttl=ttls)
        orc.put(keys[~ttl], vals[~ttl])
        orc.put(keys[ttl], vals[ttl], exp=(T_LOAD + ttls).astype(np.uint32))
        res = db.submit(Batch([Op.delete(int(k)) for k in dels]), sync=True).result()
        check(res.ok, "the delete batch failed")
        orc.delete(dels)
        if b == nb // 3:
            lo = int(rng.integers(0, STORE_DOMAIN - (1 << 34)))
            db.delete_range(lo, lo + (1 << 34))
            orc.delete_range(lo, lo + (1 << 34))
        pool = np.concatenate([pool, keys])
        n_put += len(keys)
    return n_put


def _store_operands(db, orc, rng):
    """Each promoted partition's view and the batches the store hands it:
    a 256-key and a 65,536-key get_batch and a 256-start scan_batch, routed
    to partitions as the store routes them (overlay keys included: the
    kernels' inputs, not the answers, are what is checked)."""
    gets = {q: _store_probe(rng, orc, q) for q in (STORE_GET_SMALL, STORE_GET_LARGE)}
    starts = np.sort(rng.choice(orc.live_keys, STORE_SCAN_Q)).astype(np.uint64)
    width = STORE_SCAN_N + max(8, STORE_SCAN_N // 2)  # the store's scan window
    return _view_batches(db, [(f"get, {STORE_GET_SMALL} keys", gets[STORE_GET_SMALL], 1),
                              (f"get, {STORE_GET_LARGE:,} keys", gets[STORE_GET_LARGE], 1),
                              (f"scan, {STORE_SCAN_Q} starts", starts, width)])


def _view_batches(db, batches):
    """(the store's view manager, [(view, batches)]): each partition's
    resident view, largest first, with its share of ``batches`` (label,
    keys, window width), routed as the store routes them."""
    from repro_torch.db.sharded import route_host

    parts = db.partitions
    lows = [p.lo for p in parts]
    driven = []
    for i in sorted(range(len(parts)), key=lambda i: -parts[i].n_entries):
        v = db.device_views.view_for(parts[i])
        check(v is not None, "a promoted partition has no view")
        mine = []
        for label, keys, w in batches:
            sel = keys[route_host(lows, keys) == i]
            if len(sel):
                mine.append((f"{label} ({len(sel)} to this partition)", sel, w))
        driven.append((v, mine))
    return db.device_views, driven


def _legacy_operands(db, orc, rng):
    """Each partition's ``p.index()`` REMIX and the queries the legacy path
    and the cursor hand the kernels: a 256-key and a 65,536-key get_batch
    and a 256-start scan_batch, routed as the store routes them and padded
    to its power-of-two buckets (``store._pow2pad``), and the cursor's
    one-key seek with the windows it reads (a scan fallback's width
    n + max(8, n // 2), ``cursor(width=64)``, and the widening cap)."""
    from repro_torch.core import keys as CK
    from repro_torch.db import cursor as C
    from repro_torch.db.sharded import route_host
    from repro_torch.db.store import _pow2pad
    from repro_torch.device import as_words

    parts = db.partitions
    lows = [p.lo for p in parts]
    gets = {q: _store_probe(rng, orc, q) for q in (STORE_GET_SMALL, STORE_GET_LARGE)}
    starts = np.sort(rng.choice(orc.live_keys, STORE_SCAN_Q)).astype(np.uint64)
    width = STORE_SCAN_N + max(8, STORE_SCAN_N // 2)
    driven = []
    for i in sorted(range(len(parts)), key=lambda i: -parts[i].n_entries):
        p = parts[i]
        remix, runset = p.index()
        batches = []
        for label, keys, ws in ((f"get, {STORE_GET_SMALL} keys", gets[STORE_GET_SMALL], [1]),
                                (f"get, {STORE_GET_LARGE:,} keys", gets[STORE_GET_LARGE], [1]),
                                (f"scan, {STORE_SCAN_Q} starts", starts, [width])):
            mine = keys[route_host(lows, keys) == i]
            if len(mine):
                kq = np.pad(mine, (0, _pow2pad(len(mine)) - len(mine)))
                batches.append((f"{label} ({len(mine)} to this partition, padded to "
                                f"{len(kq)})", as_words(CK.pack_u64(kq), p.device), ws))
        mine = orc.live_keys[route_host(lows, orc.live_keys) == i]
        one = np.array([rng.choice(mine)], np.uint64)
        batches.append(("cursor seek, 1 key", as_words(CK.pack_u64(one), p.device),
                        [width, 64, C._MAX_WIDTH]))
        driven.append((p, remix, runset, batches))
    return driven


def legacy_kernels(driven, card) -> tuple[dict, dict]:
    """Both kernels on the legacy path's and the cursor's own operands
    (``_legacy_operands``), against their plain versions bit for bit,
    then the cursor's one-key seek, the shape the legacy stage launches
    most, timed on the largest partition beside its bounds."""
    from repro_torch.kernels import anchor_search as AS
    from repro_torch.kernels import ops

    err = {"anchor_search": 0, "selector_decode": 0}
    cases = 0
    for _, remix, runset, batches in driven:
        for label, q, widths in batches:
            hold_kernels(remix, runset, q, widths, f"store legacy path {label}", err)
            cases += 1
    log(f"[store] both kernels on the legacy path's and the cursor's operands of "
        f"{len(driven)} partitions (p.index() G {sorted({r.g for _, r, _, _ in driven})}; "
        f"Q {sorted({q.shape[0] for *_, b in driven for _, q, _ in b})}; seek and window "
        f"group ids): {cases} cases bit-identical to the plain versions")
    _, remix, runset, batches = driven[0]
    _, q, widths = batches[-1]
    floor = launch_floor(card)
    anchor = [time_anchor(remix.anchors, q, "store, cursor seek", 50)]
    g = AS.anchor_search(remix.anchors, q)
    win, _ = ops.window_operands(remix, ops.seek(remix, runset, q), widths[0])
    decode = [time_decode(remix, g, "store, cursor seek", 50)[0],
              time_decode(remix, win, f"store, cursor window of {widths[0]}", 50)[0]]
    log_timings(card, "anchor_search", anchor, floor)
    log_timings(card, "selector_decode", decode, floor)
    return {"anchor_search": anchor, "selector_decode": decode}, err


def _store_tail(db, orc, rng):
    """Unflushed writes for the overlay and the WAL replay: 4,096 puts
    (a quarter overwrites, a tenth with TTLs) and 64 point deletes."""
    keys = np.unique(np.concatenate([
        rng.integers(0, STORE_DOMAIN, 3072, dtype=np.uint64),
        rng.choice(orc.all_keys, 1024)]))
    vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
    ttl = np.arange(len(keys)) % 10 == 0
    db.put_batch(keys[~ttl], vals[~ttl])
    db.put_batch(keys[ttl], vals[ttl], ttl=TTL_LONG)
    dels = rng.choice(orc.live_keys, 64)
    for k in dels.tolist():
        db.delete(k)
    orc.put(keys[~ttl], vals[~ttl])
    orc.put(keys[ttl], vals[ttl], exp=NOW + TTL_LONG)
    orc.delete(dels)
    orc.resolve(NOW)
    check(len(db.mem) > 0, "the tail flushed")
    log(f"[store] stage 1: tail of {len(keys)} puts and {len(dels)} deletes left in "
        f"the memtable ({len(db.mem)} entries)")


def store_config(root, **over):
    """The phase's RemixDBConfig: the widths of src/repro/configs/remixdb.py
    on ``DEV``, every field not in ``over`` at the reference's default."""
    from repro_torch.db.store import RemixDBConfig

    return RemixDBConfig(vw=VW, d=D, data_dir=root, device=DEV, **over)


def _g_guard(stage, gs):
    check(set(gs) <= set(ANCHOR_GS), f"{stage}: store G {sorted(gs)} not in the kernel sweep")


def phase_store(rng, root, card):
    """Drive the port's RemixDB through its public API (see the module
    docstring, phase 6); returns the kernels' launches over the phase, the
    timed shapes and the kernels' max |err| on the store's operands."""
    import torch

    from repro_torch.db import clock
    from repro_torch.db.store import RemixDB

    t_now = [float(T_LOAD)]
    clock.set_source(lambda: t_now[0])
    mem0 = 0
    if DEV == "cuda":
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cfg = store_config(root)
    log(f"[store] RemixDBConfig: vw {cfg.vw}, d {cfg.d}, memtable_entries "
        f"{cfg.memtable_entries}, {cfg.compaction}, device_path {cfg.device_path}, "
        f"device_budget_bytes {cfg.device_budget_bytes}, cache_bytes {cfg.cache_bytes}, "
        f"device_slice {cfg.device_slice}, cold_reads {cfg.cold_reads}, promote_fraction "
        f"{cfg.promote_fraction}, sync_policy {cfg.sync_policy}, ckb {cfg.ckb}")
    launches = {k: 0 for k in _launch_counts()}

    # ---- load
    orc = StoreOracle(VW)
    db = RemixDB(cfg)
    t0 = time.perf_counter()
    n_put = _store_load(db, orc, rng)
    load_s = time.perf_counter() - t0
    st = db.stats()
    flush = db.registry.histogram("db_flush_seconds").summary()
    du = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    kinds = st["compaction"]["kinds"]
    log(f"[store] {card}: loaded {n_put} put_batch keys ({orc.n} writes with the "
        f"deletes) in {load_s:.3f} s: {n_put / load_s:.0f} keys/s; db_flush_seconds count "
        f"{flush['count']} sum {flush['sum']:.3f} s (p50 {flush['p50']:.3f}, max "
        f"{flush['max']:.3f}); {st['partitions']} partitions, {st['tables']} tables, "
        f"{st['entries']} entries, {du} bytes on disk; memtable {st['memtable']} "
        f"entries unflushed; compaction kinds {kinds}; write amplification {st['wa']:.3f}")
    check({"minor", "split"} <= set(kinds), f"compaction kinds {kinds}: no minor or split")
    check(st["memtable"] > 0, "the last batch flushed the memtable")
    t_now[0] = float(NOW)
    orc.resolve(NOW)
    log(f"[store] oracle at now: {len(orc.live_keys)} live keys, {len(orc.dead_keys)} "
        f"dead ({len(orc.expired)} expired), {len(orc.overwritten)} overwritten")

    # ---- stage 1: the store as loaded, then flushed, then a new tail
    def stage1():
        _store_reads(db, orc, rng, "stage 1 (as loaded, memtable overlay)", card)
        t0 = time.perf_counter()
        db.flush()
        log(f"[store] stage 1: flush in {time.perf_counter() - t0:.3f} s; memtable "
            f"{len(db.mem)}; {len(db.partitions)} partitions")
        _store_reads(db, orc, rng, "stage 1 (flushed, no overlay)", card)
        _store_tail(db, orc, rng)
        views = db.device_views._views.values()
        log(f"[store] stage 1: view tiers {sorted({v.tier for v in views})} over "
            f"{len(db.device_views)} views ({sum(v.nbytes for v in views)} bytes)")
        check(all(v.tier == "full" for v in views), "a view is not on the full tier")
        keys = _store_probe(rng, orc, STORE_GET_SMALL)
        from repro_torch.db.ops import Batch, Op

        futs = [db.submit(Batch([Op.multiget(keys)])) for _ in range(4)]
        for f in futs:
            r = f.result(timeout=120).results[0]
            f_o, v_o = orc.get(keys)
            check(np.array_equal(r.found, f_o) and np.array_equal(r.vals[r.found], v_o[r.found]),
                  "an async multiget on the submit workers differs from the oracle")
        log("[store] stage 1: 4 async multigets on the submit worker threads equal the oracle")
        _store_memory(db, "stage 1", mem0)
        if DEV == "cuda":
            profile_batches(f"{card}: store get_batch at {STORE_GET_SMALL} keys",
                            lambda: db.get_batch(keys), 10)

    run_counted("store", "stage 1", stage1, launches)
    fallback = _metric(db.registry, "device_fallback_total")
    check(fallback == 0, f"device_fallback_total {fallback}")
    mem_n = len(db.mem)
    db.close()

    # ---- stage 2: reopen, cold reads, the promotion edge
    def stage2():
        t0 = time.perf_counter()
        db2 = RemixDB.open(root, cfg)
        log(f"[store] {card}: stage 2: RemixDB.open in {time.perf_counter() - t0:.3f} s: "
            f"{len(db2.partitions)} partitions, {sum(p.cold_ready() for p in db2.partitions)} "
            f"cold-ready, memtable {len(db2.mem)} entries replayed from the WAL")
        check(len(db2.mem) == mem_n, "the WAL replay lost memtable entries")
        check(all(p.cold_ready() for p in db2.partitions), "a partition is not cold-ready")
        _store_memory(db2, "stage 2 at open", mem0)
        check(_metric(db2.registry, "hbm_resident_bytes") == 0, "views resident at open")
        edge = []
        for i in range(STORE_EDGE_ROUNDS):
            keys = _store_probe(rng, orc, STORE_GET_SMALL if i < 2 else STORE_GET_LARGE)
            c0 = db2.stats()["cold"]["gets"]
            b0 = _metric(db2.registry, "device_batches")
            dt, syncs, touched, _ = _store_get(db2, orc, keys, f"stage 2 edge {i}")
            promoted = {e.fields["lo"] for e in db2.events.list("promotion")}
            edge.append((i, len(keys), round(dt / len(keys) * 1e6, 4),
                         db2.stats()["cold"]["gets"] - c0,
                         _metric(db2.registry, "device_batches") - b0,
                         len(promoted), syncs["fetch"]))
            if len(promoted) == len(db2.partitions) and edge[-1][4] > 0:
                break
        log(f"[store] {card}: stage 2 promotion edge: (batch, keys, us/key, cold gets, "
            f"device batches, partitions promoted, fetch syncs) {edge}")
        check(edge[0][3] > 0 and edge[0][4] == 0, "the first batch after open was not cold")
        check(edge[-1][5] == len(db2.partitions), "not every partition was promoted")
        check(edge[-1][4] > 0, "device_batches did not rise after promotion")
        _store_reads(db2, orc, rng, "stage 2 (reopened, promoted)", card)
        _store_memory(db2, "stage 2", mem0)
        check(_metric(db2.registry, "device_fallback_total") == 0, "device_fallback_total != 0")
        # the kernels on this path's own operands (outside the counted run)
        driven = _store_operands(db2, orc, rng)
        db2.close()
        return driven

    driven = run_counted("store", "stage 2", stage2, launches)
    _g_guard("stage 2", {v.remix.g for v, _ in driven[1]})
    shapes, err = (view_kernels(driven[0], driven[1], card, tier="store", tag="store")
                   if DEV == "cuda" else ({}, {}))

    # ---- stage 3: the legacy path with the kernels, over the WAL's
    # overlay (every scan takes the cursor), then flushed (ops.scan)
    def stage3():
        t0 = time.perf_counter()
        db3 = RemixDB.open(root, store_config(root, use_kernels=True, device_path="off",
                                              cold_reads=False))
        log(f"[store] {card}: stage 3: RemixDB.open(use_kernels=True, device_path='off', "
            f"cold_reads=False) in {time.perf_counter() - t0:.3f} s")
        check(db3.device_views is None, "stage 3 built device views")
        _store_reads(db3, orc, rng, "stage 3 (use_kernels, legacy path, overlay)", card)
        t0 = time.perf_counter()
        db3.flush()
        log(f"[store] stage 3: flush in {time.perf_counter() - t0:.3f} s; memtable "
            f"{len(db3.mem)}; {len(db3.partitions)} partitions")
        _store_reads(db3, orc, rng, "stage 3 (use_kernels, legacy path, flushed)", card)
        _store_memory(db3, "stage 3", mem0)
        check(db3.device_views is None and all(p._remix is not None for p in db3.partitions),
              "stage 3 left a partition without its legacy index")
        # the kernels on this path's own operands (outside the counted run)
        driven = _legacy_operands(db3, orc, rng)
        db3.close()
        return driven

    driven = run_counted("store", "stage 3", stage3, launches)
    _g_guard("stage 3", {remix.g for _, remix, _, _ in driven})
    if DEV == "cuda":
        legacy_shapes, legacy_err = legacy_kernels(driven, card)
        shapes = {k: shapes[k] + legacy_shapes[k] for k in shapes}
        err = {k: max(err[k], legacy_err[k]) for k in err}
    clock.reset()
    return launches, shapes, err


# ---------------------------------------------------------------- phase 7
class GateClock:
    """A ``Cluster``'s submission gate (an RLock) that records how long
    each thread held it, outermost acquire to release, so the split's
    cutover can be read apart from the submitters' short holds."""

    def __init__(self, lock):
        self.lock = lock
        self.local = threading.local()
        self.holds = []  # (thread name, t_acquired, t_released)

    def __enter__(self):
        self.lock.acquire()
        depth = getattr(self.local, "depth", 0)
        if depth == 0:
            self.local.t0 = time.perf_counter()
        self.local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        self.local.depth -= 1
        if self.local.depth == 0:
            self.holds.append((threading.current_thread().name, self.local.t0,
                               time.perf_counter()))
        self.lock.release()
        return False


class FleetTraffic:
    """``FLEET_THREADS`` submitters of ``FLEET_BATCH``-key batches through
    ``Cluster.submit`` (``benchmarks/cluster_bench.py``): keys drawn by a
    zipfian (theta 0.99) over ranks permuted over ``keys``, ``FLEET_PUT_SHARE``
    of the batches ``Op.put`` with every value word ``t + 1`` for thread
    ``t``, the rest ``Op.multiget``. Each batch's submit-to-result time is
    recorded with its keys (and a read's answers)."""

    def __init__(self, cluster, keys, seed):
        rng = np.random.default_rng(seed)
        self.cluster = cluster
        self.keys = rng.permutation(keys)
        w = 1.0 / np.arange(1, len(keys) + 1, dtype=np.float64) ** FLEET_THETA
        self.cdf = np.cumsum(w) / w.sum()
        self.seed = seed
        self.stop_ev = threading.Event()
        self.lock = threading.Lock()
        self.reads, self.writes, self.failed = [], [], []
        self.threads = [threading.Thread(target=self._loop, args=(t,), name=f"submitter-{t}")
                        for t in range(FLEET_THREADS)]

    def _loop(self, tid):
        from repro_torch.db.ops import Batch, Op

        rng = np.random.default_rng(self.seed + 1 + tid)
        while not self.stop_ev.is_set():
            ks = self.keys[np.minimum(np.searchsorted(self.cdf, rng.random(FLEET_BATCH)),
                                      len(self.keys) - 1)]
            write = rng.random() < FLEET_PUT_SHARE
            op = (Op.put(ks, np.full((len(ks), VW), tid + 1, np.uint32)) if write
                  else Op.multiget(ks))
            t0 = time.perf_counter()
            try:
                r = self.cluster.submit(Batch([op])).result(timeout=120).results[0]
                r.raise_if_error()
            except Exception as e:  # every failure is counted; the phase requires 0
                with self.lock:
                    self.failed.append(repr(e))
                continue
            t1 = time.perf_counter()
            with self.lock:
                if write:
                    self.writes.append((t0, t1, tid, ks))
                else:
                    self.reads.append((t0, t1, ks, r.found, r.vals))

    def start(self):
        for t in self.threads:
            t.start()

    def stop(self):
        self.stop_ev.set()
        for t in self.threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in self.threads), "a submitter did not stop")

    def latencies(self, t_lo, t_hi):
        """Seconds of the batches submitted in [t_lo, t_hi), in submit order."""
        rows = sorted((t0, t1 - t0) for t0, t1, *_ in self.reads + self.writes
                      if t_lo <= t0 < t_hi)
        return np.array([d for _, d in rows])


def _written(traffic):
    """Every key the traffic put: sorted keys, a bitmask of the threads
    that put each, and each key's first acknowledgement time."""
    keys = np.concatenate([w[3] for w in traffic.writes])
    tids = np.concatenate([np.full(len(w[3]), w[2]) for w in traffic.writes])
    acks = np.concatenate([np.full(len(w[3]), w[1]) for w in traffic.writes])
    uk, inv = np.unique(keys, return_inverse=True)
    mask = np.zeros(len(uk), np.int64)
    np.bitwise_or.at(mask, inv, 1 << tids)
    first = np.full(len(uk), np.inf)
    np.minimum.at(first, inv, acks)
    return uk, mask, first


def _acked(vals, mask):
    """Rows of ``vals`` that a put of a thread in ``mask`` wrote: every
    word ``t + 1``."""
    t = vals[:, 0].astype(np.int64) - 1
    return ((vals == vals[:, :1]).all(1) & (t >= 0) & (t < FLEET_THREADS)
            & ((mask >> np.clip(t, 0, 62)) & 1).astype(bool))


def _check_traffic_reads(traffic, orc):
    """The acknowledged-value rule on every read the traffic made: each key
    is live in the preload and never deleted, so it is found, and its value
    is the preload's or a put's of a thread that put it (``_acked``); once
    a put of the key was acknowledged before the read was submitted, the
    preload's value is no longer allowed. Returns the reads checked."""
    uk, mask, first = _written(traffic)
    n = 0
    for t0, _, ks, found, vals in traffic.reads:
        check(found.all(), "a traffic read lost a key")
        _, pre = orc.get(ks)
        i = np.minimum(np.searchsorted(uk, ks), len(uk) - 1)
        hit = uk[i] == ks
        m = np.where(hit, mask[i], 0)
        ok = _acked(vals, m) | ((vals == pre).all(1) & ~(hit & (first[i] < t0)))
        check(ok.all(), f"a traffic read returned a value no write put there: "
                        f"{vals[~ok][:2].tolist()} for {ks[~ok][:2].tolist()}")
        n += len(ks)
    return n


def _fleet_load(cluster, orc, rng) -> int:
    """``FLEET_KEYS`` keys through ``Cluster.submit``: ``Op.put`` batches of
    ``STORE_BATCH`` keys uniform over [0, 2^40), 20% overwrites of earlier
    keys, 1% point deletes per batch through one Batch of ``Op.delete``,
    one ``Op.delete_range`` of 2^34 a third of the way in; then a flush."""
    from repro_torch.db.ops import Batch, Op

    nb = FLEET_KEYS // STORE_BATCH
    pool = np.zeros(0, np.uint64)
    n_put = 0
    for b in range(nb):
        over = rng.choice(pool, STORE_BATCH // 5) if len(pool) else pool
        keys = np.unique(np.concatenate([
            rng.integers(0, STORE_DOMAIN, STORE_BATCH - len(over), dtype=np.uint64), over]))
        rng.shuffle(keys)
        vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
        dels = rng.choice(pool if len(pool) else keys, STORE_BATCH // 100)
        ops = [Batch([Op.put(keys, vals)]), Batch([Op.delete(int(k)) for k in dels])]
        if b == nb // 3:
            lo = int(rng.integers(0, STORE_DOMAIN - (1 << 34)))
            ops.append(Batch([Op.delete_range(lo, lo + (1 << 34))]))
        for batch in ops:
            check(cluster.submit(batch).result(timeout=600).ok, "a load batch failed")
        orc.put(keys, vals)
        orc.delete(dels)
        if b == nb // 3:
            orc.delete_range(lo, lo + (1 << 34))
        pool = np.concatenate([pool, keys])
        n_put += len(keys)
    cluster.flush()
    return n_put


def _fleet_starts(orc, lows):
    """Scan starts for the fleet: live keys at random, and for every shard
    boundary the 8 live keys just below it, whose Seek+Next50 drains into
    the next shard."""
    def pick(rng):
        edge = [orc.live_keys[max(0, np.searchsorted(orc.live_keys, np.uint64(b)) - 8):
                              np.searchsorted(orc.live_keys, np.uint64(b))]
                for b in lows[1:]]
        edge = np.concatenate(edge)
        rest = rng.choice(orc.live_keys, STORE_SCAN_Q - len(edge))
        return np.sort(np.concatenate([edge, rest])).astype(np.uint64)
    return pick


def _fleet_memory(label, base, stores):
    """Device bytes now (since the phase began) beside each tracked store's
    view bytes: ``stores`` maps a label to a weak reference of a store."""
    import torch

    alloc = 0
    if DEV == "cuda":
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - base
    held = []
    for name, ref in stores.items():
        db = ref()
        held.append(f"{name}: " + ("collected" if db is None else
                    f"referenced, views "
                    f"{0 if db.device_views is None else db.device_views.resident_bytes} B"))
    log(f"[cluster] device memory {label}: torch.cuda.memory_allocated {alloc} B since the "
        f"phase began; stores: {'; '.join(held)}")
    return alloc


def _promote(cluster, db, orc, rng, lo, hi, what):
    """65,536-key gets into one shard's span ``[lo, hi)`` through the fleet
    until every partition of ``db`` is promoted (cold reads until then);
    each batch against the oracle. Returns the edge: (batch, µs/key, cold
    gets, device batches, cold partitions after it)."""
    live = orc.live_keys[(orc.live_keys >= np.uint64(lo)) & (orc.live_keys < np.uint64(hi))]
    edge = []
    for i in range(STORE_EDGE_ROUNDS):
        cold = [p for p in db.partitions if db._cold_ok(p)]
        if not cold:
            break
        keys = rng.choice(live, STORE_GET_LARGE).astype(np.uint64)
        c0 = db.stats()["cold"]["gets"]
        b0 = _metric(db.registry, "device_batches")
        dt, _, _, _ = _store_get(cluster, orc, keys, f"{what} edge {i}")
        edge.append((i, round(dt / len(keys) * 1e6, 4), db.stats()["cold"]["gets"] - c0,
                     _metric(db.registry, "device_batches") - b0,
                     sum(db._cold_ok(p) for p in db.partitions)))
    check(not any(db._cold_ok(p) for p in db.partitions), f"{what}: a partition stayed cold")
    return edge


def phase_cluster(rng, root, card):
    """Drive a 3-shard fleet through the port's ``Cluster`` (see the module
    docstring, phase 7); returns the kernels' launches over the phase, the
    shapes timed on the new shard's operands and the kernels' max |err|."""
    import gc
    import weakref

    import torch

    from repro_torch.cluster import Cluster

    mem0 = 0
    gc.collect()  # the baseline holds nothing of earlier phases' closed stores
    if DEV == "cuda":
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
    cfg = store_config(None)
    lows0 = [i * (STORE_DOMAIN // FLEET_SHARDS) for i in range(FLEET_SHARDS)]
    cluster = Cluster(root, lows=lows0, config=cfg)
    log(f"[cluster] Cluster: lows {lows0}, cache_bytes {cluster.serve.cache.capacity_bytes}, "
        f"submit workers {cluster.serve._submit_workers}; each shard's RemixDBConfig as "
        f"phase 6's (device {cfg.device})")
    launches = {k: 0 for k in _launch_counts()}
    orc = StoreOracle(VW)
    box = {}

    # ---- stage 1: load
    def stage1():
        t0 = time.perf_counter()
        n_put = _fleet_load(cluster, orc, rng)
        dt = time.perf_counter() - t0
        orc.resolve(NOW)
        st = cluster.stats()["stores"]
        du = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        flushes = [int(db.registry.histogram("db_flush_seconds").summary()["count"])
                   for db in cluster.serve.shards]
        log(f"[cluster] {card}: stage 1: loaded {n_put} put keys ({orc.n} writes with the "
            f"deletes) through Cluster.submit in {dt:.3f} s: {n_put / dt:.0f} keys/s; flushes "
            f"per shard {flushes}; partitions per shard {[s['partitions'] for s in st]}; "
            f"entries per shard {[s['entries'] for s in st]}; memtable entries carried by the "
            f"flush {[s['memtable'] for s in st]}; {du} bytes on disk; oracle "
            f"{len(orc.live_keys)} live keys")
        check(min(s["partitions"] for s in st) >= 1, "a shard has no partition")

    run_counted("cluster", "stage 1 (load)", stage1, launches, require=False)

    # ---- stage 2: quiesced reads through the fleet
    def stage2():
        notes = _read_pairs(cluster, orc, rng, "stage 2 (loaded, flushed)", card, tag="cluster",
                            starts_fn=_fleet_starts(orc, lows0))
        # a scan over a shard whose flush carried entries in its memtable
        # takes the cursor (rule None); the gets hold the view path
        check(all(n[1] == "view" for n in notes if n[0] == "warm" and len(n) == 5),
              f"a warm fleet get left the view path: {notes}")
        check(all(n[3] > 0 for n in notes if len(n) == 7), "no scan drained into the next shard")
        keys = _store_probe(rng, orc, STORE_GET_SMALL)
        profile_batches(f"{card}: fleet get_batch at {STORE_GET_SMALL} keys",
                        lambda: cluster.get_batch(keys), 10)

    run_counted("cluster", "stage 2 (quiesced reads)", stage2, launches)

    # ---- stage 3: live split under zipfian traffic
    refs = {f"shard {lo}": weakref.ref(db) for lo, db in zip(lows0, cluster.serve.shards)}
    box["mem"] = [("before the split (3 shards)", _fleet_memory("before the split", mem0, refs))]

    def stage3():
        gate = GateClock(cluster._gate)
        cluster._gate = gate
        bounds = [int(p.lo) for p in cluster.serve.shards[0].partitions if 0 < p.lo < lows0[1]]
        traffic = FleetTraffic(cluster, orc.live_keys, seed=int(rng.integers(1 << 30)))
        traffic.start()
        t_start = time.perf_counter()
        time.sleep(FLEET_PHASE_S)
        t_split0 = time.perf_counter()
        rep = cluster.split(lows0[1] // 2)
        t_split1 = time.perf_counter()
        time.sleep(FLEET_PHASE_S)
        traffic.stop()
        t_end = time.perf_counter()
        cluster._gate = gate.lock
        check(not traffic.failed, f"{len(traffic.failed)} failed ops: {traffic.failed[:3]}")
        at = rep["at"]
        check(cluster.lows == sorted(lows0 + [at]), f"lows after the split {cluster.lows}")
        check(at in bounds, f"the split at {at} is not one of shard 0's partition "
                            f"boundaries {bounds}")
        me = threading.current_thread().name
        held = [b - a for name, a, b in gate.holds if name == me and t_split0 <= a <= t_split1]
        pre = traffic.latencies(t_start, t_split0)
        during = traffic.latencies(t_split0, t_split1)
        post = traffic.latencies(t_split1, t_end)
        first, steady = post[:FLEET_FIRST], post[FLEET_FIRST:]
        nb = len(traffic.reads) + len(traffic.writes)

        def pct(a):
            return (f"p50 {np.percentile(a, 50) * 1e3:.3f} ms, p99 "
                    f"{np.percentile(a, 99) * 1e3:.3f} ms ({len(a)} batches)") if len(a) else "none"

        log(f"[cluster] {card}: stage 3: {nb} batches, {nb * FLEET_BATCH} ops "
            f"({len(traffic.writes)} put batches) from {FLEET_THREADS} submitters over "
            f"{t_end - t_start:.3f} s; failed ops {len(traffic.failed)}")
        log(f"[cluster] {card}: stage 3: split at {at} (asked {lows0[1] // 2}; aligned to "
            f"one of shard 0's partition boundaries {bounds}) in "
            f"{t_split1 - t_split0:.3f} s; time under the gate {max(held) * 1e3:.3f} ms "
            f"(the split's holds {[round(h * 1e3, 3) for h in held]} ms); shipped "
            f"{rep['shipped']['bytes']} bytes in {rep['shipped']['files']} files, "
            f"{rep['shipped']['records']} WAL records; final catch-up {rep['final']}")
        log(f"[cluster] {card}: stage 3 batch latency: before the split {pct(pre)}; during "
            f"{pct(during)}; first {FLEET_FIRST} after {pct(first)}; after those {pct(steady)}")
        checked = _check_traffic_reads(traffic, orc)
        uk, mask, _ = _written(traffic)
        found, vals = cluster.get_batch(uk)
        check(found.all(), "a key the traffic put was lost")
        check(_acked(vals, mask).all(), "a key reads back a value no acknowledged put wrote")
        orc.put(uk, vals)
        orc.resolve(NOW)
        log(f"[cluster] stage 3: {checked} traffic reads and {len(uk)} written keys read back "
            "hold the acknowledged-value rule; the oracle takes the values read")
        box["at"] = at
        new = cluster.serve.shards[1]
        refs[f"shard {at} (split off)"] = weakref.ref(new)
        box["mem"].append(("after the split (4 shards; shard 0 trimmed)",
                           _fleet_memory("after the split", mem0, refs)))
        edge = _promote(cluster, new, orc, rng, at, lows0[1], "stage 3 new shard")
        log(f"[cluster] {card}: stage 3: the new shard after the traffic: promotion edge "
            f"(batch, us/key, cold gets, device batches, cold partitions left) {edge}; "
            f"{len(new.partitions)} partitions")
        t0 = time.perf_counter()
        cluster.flush()
        log(f"[cluster] stage 3: fleet flush after the traffic in {time.perf_counter() - t0:.3f} s")
        return _store_operands(new, orc, rng)

    driven = run_counted("cluster", "stage 3 (live split under traffic)", stage3, launches)

    # ---- stage 4: the kernels on the new shard's operands (not counted)
    _g_guard("cluster stage 4", {v.remix.g for v, _ in driven[1]})
    shapes, err = (view_kernels(driven[0], driven[1], card, tier="fleet's new shard",
                                tag="cluster") if DEV == "cuda" else ({}, {}))
    del driven

    # ---- stage 5: a replica of shard 0
    def stage5():
        at = box["at"]
        rep = cluster.add_replica(lows0[0])
        refs["replica of shard 0"] = weakref.ref(rep.db)
        keys = np.unique(rng.integers(0, at, FLEET_TAIL, dtype=np.uint64))
        vals = rng.integers(0, 2**32, (len(keys), VW), dtype=np.uint64).astype(np.uint32)
        cluster.put_batch(keys, vals)
        orc.put(keys, vals)
        orc.resolve(NOW)
        lag = rep.seq_lag()
        t0 = time.perf_counter()
        final = rep.catch_up_until(0)
        dt = time.perf_counter() - t0
        check(rep.seq_lag() == 0 and final["lag"] == 0, f"replica lag {rep.seq_lag()}")
        q = _store_probe(rng, orc, STORE_GET_LARGE)
        q = q[q < np.uint64(at)]
        f_r, v_r = rep.get_batch(q)
        f_p, v_p = cluster.get_batch(q)
        f_o, v_o = orc.get(q)
        check(np.array_equal(f_r, f_o) and np.array_equal(f_p, f_o)
              and np.array_equal(v_r[f_r], v_o[f_o]) and np.array_equal(v_p[f_p], v_o[f_o]),
              "the replica, the primary and the oracle disagree")
        log(f"[cluster] {card}: stage 5: replica of shard 0 shipped {rep.report['bytes']} "
            f"bytes; lag before the catch-up {lag}; catch_up_until(0) in {dt:.3f} s ({final}); "
            f"get_batch of {len(q)} keys equal on the replica, the primary and the oracle")
        box["mem"].append(("with the replica", _fleet_memory("with the replica", mem0, refs)))

    run_counted("cluster", "stage 5 (replica)", stage5, launches)

    # ---- stage 6: merge the split back
    def stage6():
        import repro_torch.cluster.cluster as CC

        at = box["at"]
        absorbing = cluster.serve.shards[cluster.lows.index(at) - 1].cfg.data_dir
        real, merged = CC.fetch_files, set()

        def fetch(*a, **kw):  # records the names the merge copies in
            out = real(*a, **kw)
            merged.update(kw["rename"].values())
            return out

        CC.fetch_files = fetch
        try:
            t0 = time.perf_counter()
            rep = cluster.merge(at)
            dt = time.perf_counter() - t0
        finally:
            CC.fetch_files = real
        check(cluster.lows == lows0, f"lows after the merge {cluster.lows}")
        qdir = os.path.join(absorbing, "quarantine")
        held = sorted(merged & set(os.listdir(qdir))) if os.path.isdir(qdir) else []
        check(merged and not held, f"the merge copied {len(merged)} files; in the absorbing "
              f"shard's quarantine/: {held}")
        retired = [n for n in os.listdir(root) if n.startswith("retired-")]
        log(f"[cluster] {card}: stage 6: merge at {at} in {dt:.3f} s: {rep}; retired "
            f"directories {retired}; none of the {len(merged)} merged names in the absorbing "
            f"shard's quarantine/")
        box["mem"].append(("after the merge", _fleet_memory("after the merge", mem0, refs)))
        gc.collect()
        box["mem"].append(("after the merge and gc.collect()",
                           _fleet_memory("after the merge and gc.collect()", mem0, refs)))
        _read_pairs(cluster, orc, rng, "stage 6 (merged)", card, tag="cluster",
                    starts_fn=_fleet_starts(orc, lows0), repeats=1)

    run_counted("cluster", "stage 6 (merge)", stage6, launches)

    # ---- stage 7: close and reopen the fleet from its directory
    def stage7():
        nonlocal cluster
        cluster.close()
        box["mem"].append(("after close", _fleet_memory("after close", mem0, refs)))
        cluster = None
        gc.collect()
        box["mem"].append(("after close and gc.collect()",
                           _fleet_memory("after close and gc.collect()", mem0, refs)))
        t0 = time.perf_counter()
        c2 = Cluster(root, lows=None, config=cfg)
        log(f"[cluster] {card}: stage 7: Cluster(lows=None) reopened {c2.lows} in "
            f"{time.perf_counter() - t0:.3f} s; memtables {[len(db.mem) for db in c2.serve.shards]}")
        check(c2.lows == lows0, f"reopened lows {c2.lows}")
        spans = c2.spans()
        for db, (lo, hi) in zip(c2.serve.shards, spans):
            edge = _promote(c2, db, orc, rng, lo, min(hi, STORE_DOMAIN), f"stage 7 shard {lo}")
            log(f"[cluster] {card}: stage 7: shard {lo}: promotion edge (batch, us/key, cold "
                f"gets, device batches, cold partitions left) {edge}")
            check(edge and edge[0][2] > 0, f"stage 7 shard {lo}: the first batch was not cold")
        _read_pairs(c2, orc, rng, "stage 7 (reopened, promoted)", card, tag="cluster",
                    starts_fn=_fleet_starts(orc, lows0))
        c2.close()

    run_counted("cluster", "stage 7 (reopen)", stage7, launches)
    gc.collect()
    box["mem"].append(("after the phase", _fleet_memory("after the phase", mem0, refs)))
    log(f"[cluster] device memory over the phase (label, bytes since it began): {box['mem']}")
    return launches, shapes, err


# ---------------------------------------------------------------- phase 8
def _paper_claims(rows: list[str]) -> None:
    """The paper's claims, read off this run's rows: the merging
    iterator's time over REMIX's per R, and fig16's WA order."""
    val = {}  # row name (with its R= / D=) -> (us_per_call, derived)
    for line in rows:
        parts = line.split(",")
        k = 2 if "=" in parts[1] else 1
        val[",".join(parts[:k])] = (float(parts[k]), ",".join(parts[k + 1:]))
    for fig in ("fig11", "fig12"):
        for what, merge, remix in (
                ("seek", "a_seek_merging", "a_seek_remix_vector"),
                ("seek (full in-group search)", "a_seek_merging", "a_seek_remix_full"),
                ("Seek+Next50", "b_next50_merging", "b_next50_remix"),
                ("get with bloom", "c_get_sstable_bloom", "c_get_remix"),
                ("get without bloom", "c_get_sstable_nobloom", "c_get_remix")):
            ratios = [f"R={r}: {val[f'{fig}{merge},R={r}'][0] / val[f'{fig}{remix},R={r}'][0]:.2f}x"
                      for r in (1, 2, 4, 8, 16) if f"{fig}{remix},R={r}" in val]
            log(f"[paper] {fig} {what}: merging iterator / REMIX time per op, {', '.join(ratios)}")
    wa = {k.rsplit("_", 1)[1]: float(v[1].split("=")[1]) for k, v in val.items()
          if k.startswith("fig16_write_120B_")}
    log(f"[paper] fig16 write amplification: {wa}; tiered < RemixDB < leveled: "
        f"{wa.get('tiered', 0) < wa.get('remixdb', 0) < wa.get('leveled', 0)}")


def _demo_oracle(shards):
    """Every shard's stored keys, sorted, and the run each key's value comes
    from (a key in two runs of a shard: the later run)."""
    from repro_torch.core import keys as CK
    from repro_torch.device import u32_np

    keys, runs = [], []
    for _, runset in shards:
        kk = CK.unpack_u64(u32_np(runset.keys)).reshape(-1)
        lens = runset.lens.cpu().numpy()
        run = np.repeat(np.arange(runset.r), runset.nmax)
        live = (np.arange(runset.nmax)[None, :] < lens[:, None]).reshape(-1)
        keys.append(kk[live])
        runs.append(run[live])
    keys, run = np.concatenate(keys), np.concatenate(runs)
    order = np.lexsort((-run, keys))
    keys, run = keys[order], run[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], run[first]


def _sharded_dropped(q64, world) -> np.ndarray:
    """The queries of one rank's slice that ``make_sharded_get`` drops:
    past ``cap = max(1, 2 * nq // world)`` per owner shard, and the last
    one that fits where an owner overflowed."""
    nq = len(q64)
    cap = max(1, 2 * nq // world)
    owner = np.minimum((q64 >> np.uint64(32)) // np.uint64((1 << 32) // world),
                       np.uint64(world - 1))
    drop = np.zeros(nq, bool)
    for s in range(world):
        idx = np.flatnonzero(owner == s)
        if len(idx) > cap:
            drop[idx[cap - 1:]] = True
    return drop


def _sharded_rank(rank, world, init, out, cfg=None):
    """One rank of the sharded get: its shard of ``build_demo_state`` at
    ``cfg``'s widths (``RemixServiceConfig()``) and its slice of the
    query batch, half of it keys stored on any shard and half misses,
    through ``make_sharded_get`` over NCCL (gloo off the card); answers
    held to a numpy oracle of every shard's keys under the drop rule and,
    in a world of one, to ``core.query.get`` on the same shard."""
    import torch
    import torch.distributed as dist

    from repro_torch.bench.common import CSV, time_batched
    from repro_torch.configs.remixdb import RemixServiceConfig
    from repro_torch.core import keys as CK
    from repro_torch.core import query as Q
    from repro_torch.db.sharded import build_demo_state, make_sharded_get
    from repro_torch.device import as_words, u32_np

    dev = f"cuda:{rank}" if DEV == "cuda" else DEV
    if DEV == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        cfg = cfg or RemixServiceConfig()
        t0 = time.perf_counter()
        shards = build_demo_state(cfg, world, seed=PAPER_SEED, device=dev)
        remix, runset = shards[rank]
        build_s = time.perf_counter() - t0
        keys, run = _demo_oracle(shards)
        del shards
        nq = cfg.query_batch // world
        rng = np.random.default_rng(rank)
        hit = rng.choice(keys, nq // 2)
        q64 = np.concatenate([hit, hit + np.uint64(1)])  # demo keys end in 26 zero bits
        queries = as_words(CK.pack_u64(q64), dev)
        step, n = make_sharded_get(cfg)
        check(n == world, f"sharded get: {n} shards in a world of {world}")
        csv = CSV(profile=DEV == "cuda")
        t = time_batched(step, remix, runset, queries)
        csv.emit(f"sharded_get_world={world}_rank={rank}", t / nq * 1e6,
                 f"{nq} queries/rank, R={cfg.runs_per_partition} x "
                 f"{cfg.entries_per_run}, D={cfg.group_d}, build {build_s:.1f}s",
                 call=lambda: step(remix, runset, queries), wall_s=t)
        found, vals = step(remix, runset, queries)
        found, vals = found.cpu().numpy(), u32_np(vals)
        drop = _sharded_dropped(q64, world)
        want = np.zeros(nq, bool)
        want[: nq // 2] = True
        want &= ~drop
        check(np.array_equal(found, want), f"sharded get rank {rank}: "
              f"{int((found != want).sum())} of {nq} found wrong")
        at = np.searchsorted(keys, q64[want])
        lo = (q64[want] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        check(np.array_equal(vals[want, 0], lo) and
              np.array_equal(vals[want, -1], run[at].astype(np.uint32)),
              f"sharded get rank {rank}: values of stored keys wrong")
        if world == 1:
            f2, v2 = Q.get(remix, runset, queries)
            check(np.array_equal(f2.cpu().numpy(), found)
                  and np.array_equal(u32_np(v2), vals),
                  "sharded get: differs from core.query.get on the same shard")
        owner = (q64 >> np.uint64(32)) // np.uint64((1 << 32) // world)
        off = int((np.minimum(owner, world - 1) != rank).sum())
        log(f"[paper] sharded get rank {rank}/{world}: {nq} queries ({nq // 2} stored, "
            f"{nq // 2} missing; {off} owned by other ranks; {int(drop.sum())} over "
            "capacity, dropped) held to the oracle" +
            (" and to core.query.get" if world == 1 else ""))
        if out is not None:
            out.extend(csv.rows)
    finally:
        dist.destroy_process_group()


def _paper_observer(card, shapes, err, timed=PAPER_TIMED, log_tag="paper"):
    """The figure benchmarks' ``observe`` (and ``kernels_bench``'s): after
    each load, both kernels on the RemixDB's resident views at the batches
    the benchmark sends them, bit for bit against the plain versions
    (``hold_views``; timed as well after the loads in ``timed``:
    ``view_kernels``), with those launches taken back off the counts (they
    are not the path's); where a baseline's scans go through its memtable overlay,
    a 64-start scan_batch timed beside one merging scan per start, the
    reference's algorithm."""
    from repro_torch.bench.common import sync

    def observe(tag, stores, batches):
        before = _launch_counts()
        mgr, driven = _view_batches(stores["remixdb"], [
            (label, keys, 1 if n is None else n + max(8, n // 2))  # the store's window
            for label, keys, n in batches])
        if tag in timed:
            got, e = view_kernels(mgr, driven, card, tier=f"{tag} RemixDB", tag=log_tag)
        else:
            got, e = {k: [] for k in shapes}, hold_views(mgr, driven, f"{tag} RemixDB", log_tag)
        del mgr, driven
        _set_launch_counts(before)
        for k in shapes:
            shapes[k] += got[k]
            err[k] = max(err[k], e[k])
        starts = [k for label, k, n in batches if label.startswith("scan50 64")]
        for name in ("leveled", "tiered"):
            s = stores.get(name)
            if s is None or not (starts and len(s.mem)):
                continue
            ts = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                s.scan_batch(starts[0], 50)
                sync()
                ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for x in starts[0].tolist():
                s.scan(x, 50)
            sync()
            a, b = float(np.median(ts)) * 1e3, (time.perf_counter() - t0) * 1e3
            log(f"[paper] {card}: {tag} {name}: a 64-start Seek+Next50 scan_batch over a "
                f"memtable of {len(s.mem)} entries: the port's batched overlay (median of 3) "
                f"{a:.3f} ms; one merging scan per start (the reference's algorithm, once) "
                f"{b:.3f} ms, {b / a:.2f}x")

    return observe


def phase_paper(card) -> tuple[dict, dict, dict]:
    """The paper's figures on the card through the port's benchmarks (see the
    module docstring, phase 8); returns the kernels' launches over the
    store-level figures (the REMIX-level figures call the plain engine),
    and their shapes and errors on the RemixDB's operands after each load."""
    import socket

    import torch

    from repro_torch.bench import (common, fig11_queries, fig13_groupsize, fig14_16_stores,
                                   fig17_ycsb, table1_storage)

    t_phase = time.perf_counter()
    csv = common.CSV(profile=True)
    launches = {k: 0 for k in _launch_counts()}
    shapes = {"anchor_search": [], "selector_decode": []}  # held on the views' operands
    err = {k: 0 for k in shapes}
    observe = _paper_observer(card, shapes, err) if DEV == "cuda" else None
    log(f"[paper] {card}: fig11-13 at {PAPER_N_PER_TABLE} keys per table, "
        f"fig14-17 at scale {PAPER_SCALE}; rows: name,us_per_call,derived")

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"[paper] {name} done in {time.perf_counter() - t0:.1f} s")
        return out

    for loc in ("weak", "strong"):
        timed(f"fig1{1 if loc == 'weak' else 2}", lambda: fig11_queries.run(
            csv, locality=loc, n_per_table=PAPER_N_PER_TABLE, device=DEV,
            check_answers=True))
    timed("fig13", lambda: fig13_groupsize.run(csv, n_per_table=PAPER_N_PER_TABLE,
                                               device=DEV))
    timed("table1", lambda: table1_storage.run(csv, device=DEV))
    timed("fig14_16", lambda: run_counted("paper", "fig14-16", lambda: fig14_16_stores.run(
        csv, scale=PAPER_SCALE, device=DEV, check_answers=True, observe=observe), launches))
    timed("fig17", lambda: run_counted("paper", "fig17", lambda: fig17_ycsb.run(
        csv, scale=PAPER_SCALE, device=DEV, check_answers=True, observe=observe), launches))
    world = torch.cuda.device_count() if DEV == "cuda" else 1
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        init = f"tcp://localhost:{sock.getsockname()[1]}"
    if world == 1:
        timed("sharded get", lambda: _sharded_rank(0, 1, init, csv.rows))
    else:
        import torch.multiprocessing as mp

        timed("sharded get", lambda: mp.spawn(_sharded_rank, args=(world, init, None),
                                              nprocs=world))
    _paper_claims(csv.rows)
    log(f"[paper] phase 8 ran {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"from the stores' reads {launches}")
    return launches, shapes, err


# ---------------------------------------------------------------- phase 9
def _llm_requests(rng, vocab):
    shared = rng.integers(0, vocab, LLM_SHARED).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, LLM_TAIL).astype(np.int32)])
            for _ in range(LLM_REQUESTS)]


def _serve_timed(eng, requests):
    """Each request through ``eng.generate``: its tokens, time to first
    token and ms per decoded token. The first token is read on the host
    (one sync) before the first decode call at ``pos == len(prompt)``; each
    later token is read before the next decode call."""
    import torch

    marks = []
    decode = eng._decode

    def mark(cache, tok, pos):
        marks.append((pos, time.perf_counter()))
        return decode(cache, tok, pos)

    eng._decode = mark
    outs, ttft, per_tok = [], [], []
    try:
        for prompt in requests:
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(eng.generate(prompt, max_new=LLM_MAX_NEW))
            t1 = time.perf_counter()
            t_first = next(t for pos, t in marks if pos == len(prompt))
            ttft.append((t_first - t0) * 1e3)
            per_tok.append((t1 - t_first) * 1e3 / LLM_MAX_NEW)
    finally:
        del eng._decode
    return outs, ttft, per_tok


def _spread(xs) -> str:
    return f"{np.median(xs):.3f} [{min(xs):.3f}-{max(xs):.3f}]"


def _llm_decode_against_forward(cfg, params, rng, card):
    """Teacher-forced ``decode_step`` logits against ``forward`` at full
    width in float32 (float32 caches); argmax equal at every position."""
    import dataclasses

    import torch

    from repro_torch.models import model as LM

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LLM_CHECK_TOKENS)), device=DEV)
    full = LM.forward(cfg32, params, dict(tokens=tokens))[0]
    cache = LM.init_cache(cfg32, 1, LLM_CHECK_TOKENS, dtype=torch.float32, device=DEV)
    steps = []
    for t in range(LLM_CHECK_TOKENS):
        logits, cache = LM.decode_step(cfg32, params, cache, tokens[:, t], t)
        steps.append(logits[0])
    dec = torch.stack(steps)
    err = float((dec - full).abs().max())
    agree = int((dec.argmax(-1) == full.argmax(-1)).sum())
    log(f"[llm] {card}: decode_step against forward, {LLM_CHECK_TOKENS} tokens at full "
        f"width in float32: max abs err {err:.3e} (|logits| max {float(full.abs().max()):.3f}, "
        f"tolerance {LLM_DECODE_ATOL}), argmax equal at {agree}/{LLM_CHECK_TOKENS} positions")
    check(bool(torch.isfinite(dec).all()) and err <= LLM_DECODE_ATOL,
          f"decode against forward: max abs err {err} > {LLM_DECODE_ATOL}")
    check(agree == LLM_CHECK_TOKENS, f"decode against forward: argmax differs ({agree})")


def _llm_families(card):
    """One arch of each family at 2 layers, float32: a forward and two
    decode steps on the card against the same calls on the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as LM
    from repro_torch.models.layers import split_params, tree_map

    for arch in LLM_FAMILIES:
        cfg = dataclasses.replace(reduced(get_config(arch), n_layers=2), dtype="float32")
        params = split_params(LM.init_params(cfg, 0, device="cpu"))[0]
        r = np.random.default_rng(0)
        tokens = torch.as_tensor(r.integers(0, cfg.vocab, (2, 16)))
        batch = dict(tokens=tokens)
        if cfg.family == "encdec":
            batch["frontend"] = torch.as_tensor(r.normal(size=(2, 16, cfg.d_model)),
                                                dtype=torch.float32)
        out = {}
        for dev in ("cpu", DEV):
            p = tree_map(lambda t: t.to(dev), params)
            got = [LM.forward(cfg, p, {k: v.to(dev) for k, v in batch.items()})]
            cache = LM.init_cache(cfg, 2, 8, dtype=torch.float32, device=dev)
            for pos in range(2):
                lg, cache = LM.decode_step(cfg, p, cache, tokens[:, pos].to(dev), pos)
                got.append(lg)
            out[dev] = [t.cpu() for t in got]
        err = max(float((a - b).abs().max()) for a, b in zip(out["cpu"], out[DEV]))
        log(f"[llm] {card}: {arch} ({cfg.family}, 2 layers, float32) forward + 2 decode "
            f"steps, card against CPU: max abs err {err:.3e} (tolerance {LLM_FAMILY_ATOL})")
        check(all(bool(torch.isfinite(t).all()) for t in out[DEV]) and err <= LLM_FAMILY_ATOL,
              f"{arch} on the card: max abs err {err} > {LLM_FAMILY_ATOL}")


def _llm_page_table(rng, card):
    """``lookup_batch`` on the card against a dict over 5 generations, with
    a tiered merge (``max_runs=4``)."""
    from repro_torch.models.kvcache import RemixPageTable

    table = RemixPageTable(d=8, max_runs=4, device=DEV)
    oracle = {}
    for _ in range(5):
        for _ in range(400):
            h = int(rng.integers(0, 2**63))
            slot, ln = int(rng.integers(0, 1000)), int(rng.integers(1, 100))
            table.add(np.uint64(h), slot, ln)
            oracle[h] = (slot, ln)
        table.flush_generation()
    check(len(table.runs) < 5, "page table: the tiered merge did not run")
    probes = list(oracle)[::3] + [int(x) for x in rng.integers(0, 2**63, 64)]
    found, slots, lens = table.lookup_batch(np.array(probes, np.uint64))
    for i, h in enumerate(probes):
        want = oracle.get(h)
        check(bool(found[i]) == (want is not None)
              and (want is None or (int(slots[i]), int(lens[i])) == want),
              f"page table: probe {i} answered {found[i], slots[i], lens[i]}, oracle {want}")
    log(f"[llm] {card}: page table on the card, {len(probes)} lookups over 5 "
        f"generations ({len(table.runs)} runs after the merge) equal the dict")


def phase_llm(rng, card):
    """LLM serving at qwen2.5-3b's published widths (module docstring,
    phase 9)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as LM
    from repro_torch.models.kvcache import PrefixCache
    from repro_torch.models.layers import split_params, tree_leaves
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(LLM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab, cfg.qkv_bias, cfg.rope_theta, cfg.dtype, cfg.param_dtype)
          == (36, 2048, 16, 2, 128, 11008, 151936, True, 1e6, "bfloat16", "float32"),
          f"{LLM_ARCH}: not the published widths: {cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 31)))
    params = split_params(LM.init_params(cfg, gen, device=DEV))[0]
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    w_params = sum(t.numel() for t in leaves if t.ndim >= 2)
    log(f"[llm] {card}: {LLM_ARCH} at its published widths, {n_params:,} params "
        f"({sum(t.numel() * t.element_size() for t in leaves):,} bytes, "
        f"{'/'.join(sorted({str(t.dtype)[6:] for t in leaves}))}), "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")

    launches0 = _launch_counts()
    requests = _llm_requests(rng, cfg.vocab)
    plain = ServeEngine(cfg, params, max_seq=LLM_MAX_SEQ, device=DEV)
    plain.generate(requests[0][:LLM_PAGE], max_new=2)  # first-call set-up, not timed
    plain.stats = type(plain.stats)()
    outs_plain, ttft_p, tok_p = _serve_timed(plain, requests)
    cache = PrefixCache(cfg, n_pages=LLM_PAGES, page_size=LLM_PAGE, device=DEV)
    cached = ServeEngine(cfg, params, max_seq=LLM_MAX_SEQ, prefix_cache=cache, device=DEV)
    outs_cached, ttft_c, tok_c = _serve_timed(cached, requests)
    for i, (a, b) in enumerate(zip(outs_plain, outs_cached)):
        check(np.array_equal(a, b), f"request {i}: the prefix cache changed the tokens: {a} {b}")
    st_p, st_c = plain.stats, cached.stats
    check(st_c.cached_tokens > 0 and cache.hits >= 1,
          f"the prefix cache reused nothing: {st_c}, hits {cache.hits}")
    check(cache.next_slot <= LLM_PAGES, "the page ring wrapped")
    launched = {k: n - launches0[k] for k, n in _launch_counts().items()}
    log(f"[llm] {card}: {LLM_REQUESTS} requests x ({LLM_SHARED} shared + {LLM_TAIL}) "
        f"tokens, {LLM_MAX_NEW} new each: tokens identical with and without the cache; "
        f"first request {outs_plain[0].tolist()}")
    log(f"[llm] {card}: without cache: time to first token {_spread(ttft_p)} ms, "
        f"{_spread(tok_p)} ms per decoded token, prefill tokens computed "
        f"{st_p.prefill_tokens}")
    log(f"[llm] {card}: with cache: time to first token {_spread(ttft_c)} ms "
        f"(requests 2-{LLM_REQUESTS}: {_spread(ttft_c[1:])}), {_spread(tok_c)} ms per "
        f"decoded token, prefill tokens computed {st_c.prefill_tokens}, reused "
        f"{st_c.cached_tokens}, hits {cache.hits}, misses {cache.misses}, pages "
        f"{cache.next_slot} of {LLM_PAGES}; kernel launches of csrc/ on this path "
        f"{launched}")

    hashes = np.array([int(x) for x in rng.integers(0, 2**63, LLM_SHARED // LLM_PAGE)],
                      np.uint64)
    lk = []
    for _ in range(25):
        t0 = time.perf_counter()
        cache.table.lookup_batch(hashes)
        lk.append((time.perf_counter() - t0) * 1e6)
    log(f"[llm] {card}: page-table lookup_batch of {len(hashes)} hashes over "
        f"{len(cache.table.runs)} runs: {_spread(lk[5:])} us (host clock, ends in a copy "
        f"to the host)")

    kv = LM.init_cache(cfg, 1, LLM_MAX_SEQ, device=DEV)
    tok = torch.zeros(1, dtype=torch.long, device=DEV)
    step = lambda: LM.decode_step(cfg, params, kv, tok, LLM_SHARED)  # noqa: E731
    prof = profile_batches(f"{card}: {LLM_ARCH} decode_step", step, 5)
    weight_bytes = 4 * w_params
    bound_f32 = (weight_bytes + 2 * w_params) / HBM_BPS * 1e3
    bound_bf16 = 2 * w_params / HBM_BPS * 1e3
    if prof is not None:
        log(f"[llm] {card}: one decode step: {prof['wall_us'] / 1e3:.3f} ms wall, "
            f"{prof['busy_us'] / 1e3:.3f} ms device busy, idle share "
            f"{1 - prof['busy_us'] / prof['wall_us']:.3f}, {prof['launches']:.0f} device "
            f"launches; bytes bound {bound_f32:.3f} ms (float32 weights read "
            f"{weight_bytes:,} B + their bfloat16 casts written {2 * w_params:,} B at "
            f"{HBM_BPS / 1e12} TB/s), {bound_bf16:.3f} ms with bfloat16 weights")
    peak = torch.cuda.max_memory_allocated()
    log(f"[llm] {card}: peak device bytes {peak:,} ({peak - base:,} above the phase's "
        f"start)")

    _llm_decode_against_forward(cfg, params, rng, card)
    del params, plain, cached, cache, kv
    torch.cuda.empty_cache()
    _llm_families(card)
    _llm_page_table(rng, card)
    log(f"[llm] phase 9 ran {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------- phase 10
def _tree_nbytes(tree) -> int:
    from repro_torch.train.optimizer import flat_leaves

    return sum(t.numel() * t.element_size() for t in flat_leaves(tree))


def _train_grads(cfg, params, batch, dev):
    """(loss, grads in leaf order) of ``loss_fn`` on ``dev``, the params
    and the batch moved there."""
    import torch

    from repro_torch.models import model as LM
    from repro_torch.models.layers import tree_map
    from repro_torch.train.optimizer import flat_leaves

    p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
    loss = LM.loss_fn(cfg, p, {k: v.to(dev) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat_leaves(p))
    return loss.item(), [g.float().cpu() for g in grads]


def _train_card_against_cpu(cfg, label, card, loss_atol, grad_rtol, seed=0):
    """``loss_fn`` and every grad leaf on the card against the CPU, the same
    params (drawn on the CPU) and batch; fails past the tolerances."""
    import torch

    from repro_torch.models import model as LM
    from repro_torch.models.layers import split_params

    params = split_params(LM.init_params(cfg, seed, device="cpu"))[0]
    r = np.random.default_rng(seed)
    b, s = TRAIN_CHECK_BATCH
    batch = {k: torch.as_tensor(r.integers(0, cfg.vocab, (b, s)), dtype=torch.int32)
             for k in ("tokens", "labels")}
    if cfg.frontend == "vlm":
        batch["frontend"] = torch.as_tensor(r.normal(size=(b, cfg.frontend_len, cfg.d_model)),
                                            dtype=torch.float32)
    if cfg.family == "encdec":
        batch["frontend"] = torch.as_tensor(r.normal(size=(b, s, cfg.d_model)),
                                            dtype=torch.float32)
    lc, gc = _train_grads(cfg, params, batch, "cpu")
    lg, gg = _train_grads(cfg, params, batch, DEV)
    rel = max(float((a - g).norm() / a.norm().clamp(min=1e-30)) for a, g in zip(gc, gg))
    finite = all(bool(torch.isfinite(g).all()) for g in gg)
    log(f"[train] {card}: {label}: loss card {lg:.6f} CPU {lc:.6f} (|diff| {abs(lg - lc):.3e}, "
        f"tolerance {loss_atol}); {len(gg)} grad leaves, largest relative error "
        f"{rel:.3e} (tolerance {grad_rtol}), finite {finite}")
    check(finite and abs(lg - lc) <= loss_atol and rel <= grad_rtol,
          f"{label}: card against CPU: loss {lg} / {lc}, grad rel err {rel}")


class _StepProbe:
    """Wraps the launcher's ``make_train_step``: each step synchronised and
    timed on the host clock, its loss and grad norm read after it, and a
    few param slices kept from before the first step."""

    def __init__(self):
        self.ms, self.loss, self.gnorm, self.before = [], [], [], None

    def __call__(self, make):
        import torch

        from repro_torch.train.optimizer import flat_leaves

        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def timed(params, opt, batch):
                if self.before is None:
                    self.before = [t.detach().flatten()[:4096].clone()
                                   for t in flat_leaves(params)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, opt, batch)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.loss.append(out[2]["loss"].item())
                self.gnorm.append(out[2]["grad_norm"].item())
                return out

            return timed

        return wrapped


class _CkptProbe:
    """Times ``checkpoint.save`` / ``restore`` and sizes what they move."""

    def __init__(self, C):
        self.C, self.saves, self.restores = C, [], []
        self._save, self._restore = C.save, C.restore

    def __enter__(self):
        import torch

        def save(ckpt_dir, step, params, opt_state, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._save(ckpt_dir, step, params, opt_state, **kw)
            dt = time.perf_counter() - t0
            d = Path(ckpt_dir) / f"step_{step}"
            self.saves.append((step, sum(f.stat().st_size for f in d.iterdir()), dt))

        def restore(*a, **kw):
            t0 = time.perf_counter()
            out = self._restore(*a, **kw)
            torch.cuda.synchronize()
            self.restores.append((_tree_nbytes(dict(p=out[0], o=out[1])),
                                  time.perf_counter() - t0))
            return out

        self.C.save, self.C.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.C.save, self.C.restore = self._save, self._restore


def _train_full_width(card, root, launches):
    """``launch.train.main`` at qwen2.5-3b's published widths: TRAIN_STEPS
    steps and the launcher's final save; that checkpoint restored onto the
    card beside the trained state and held to it bit for bit; one step
    resumed from it as ``--resume --steps TRAIN_STEPS + 1`` runs it (the
    launcher's restore, data step and optimizer config), then one more
    profiled. Per-step ms, tokens/s, loss, grad norm, peak bytes, the
    checkpoint's bytes and seconds."""
    import gc
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as TL
    from repro_torch.train import checkpoint as C
    from repro_torch.train.optimizer import OptConfig, flat_leaves
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(TRAIN_ARCH)
    n = cfg.n_params()
    state = 4 * n * 4  # float32 params, grads, mu, nu
    ckpt = 3 * n * 4  # params, mu, nu
    gc.collect()
    torch.cuda.empty_cache()
    free_dev, total_dev = torch.cuda.mem_get_info()
    disk = shutil.disk_usage(root).free
    with open("/proc/meminfo") as f:
        ram = next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable"))
    with open("/proc/self/io") as f:
        written = next(int(line.split()[1]) for line in f if line.startswith("write_bytes"))
    log(f"[train] {card}: {TRAIN_ARCH} at its published widths, {n:,} params: params + grads "
        f"+ AdamW moments {state:,} B; device free {free_dev:,} of {total_dev:,} B "
        f"(allocated {torch.cuda.memory_allocated():,}); a checkpoint {ckpt:,} B, free "
        f"{disk:,} B under {root}; {written:,} B written to storage by this script so far; "
        f"host RAM available {ram:,} B")
    check(free_dev >= state + TRAIN_DEVICE_MARGIN,
          f"the card cannot hold training: {free_dev:,} B free < {state:,} B of state + "
          f"{TRAIN_DEVICE_MARGIN:,} B margin")
    check(disk >= ckpt + TRAIN_DISK_MARGIN,
          f"{root} cannot hold a full-width checkpoint: {disk:,} B free < "
          f"{ckpt:,} + {TRAIN_DISK_MARGIN:,} B")
    largest = 4 * max(cfg.vocab * cfg.d_model, cfg.n_layers * cfg.d_model * cfg.d_ff)
    check(ram >= 2 * largest + TRAIN_HOST_MARGIN,
          f"host RAM {ram:,} B available < 2 x {largest:,} B (the largest leaf, on the host "
          f"once as it is written and once as it is read) + {TRAIN_HOST_MARGIN:,} B")

    d = str(Path(root) / "ckpt")
    argv = ["--arch", TRAIN_ARCH, "--no-reduced", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt", d, "--ckpt-every", "1000", "--device", DEV]
    probe = _StepProbe()
    real_make = TL.make_train_step
    TL.make_train_step = probe(real_make)
    try:
        torch.cuda.reset_peak_memory_stats()
        with _CkptProbe(C) as cp:
            t0 = time.perf_counter()
            pv, opt = run_counted("train", f"{TRAIN_ARCH} launch.train.main, {TRAIN_STEPS} steps",
                                  lambda: TL.main(argv + ["--steps", str(TRAIN_STEPS)]),
                                  launches, require=False)
            t_main = time.perf_counter() - t0
    finally:
        TL.make_train_step = real_make
    peak = torch.cuda.max_memory_allocated()
    after = [t.detach().flatten()[:4096] for t in flat_leaves(pv)]
    changed = sum(not torch.equal(a, b) for a, b in zip(probe.before, after))
    ms, loss, gnorm = list(probe.ms), list(probe.loss), list(probe.gnorm)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = ms[1:]
    log(f"[train] {card}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{t_main:.1f} s (init, steps, final save): step ms {', '.join(f'{x:.1f}' for x in ms)} "
        f"(step 0 apart: {_spread(steady)} ms, {tokens / (np.median(steady) / 1e3):,.0f} "
        f"tokens/s); loss {', '.join(f'{x:.4f}' for x in loss)}; grad norm "
        f"{', '.join(f'{x:.4f}' for x in gnorm)}; {changed} of {len(after)} leaves changed "
        f"(first 4,096 elements); peak device bytes {peak:,}")
    check(all(np.isfinite(loss)) and all(np.isfinite(gnorm)) and min(gnorm) > 0,
          f"full width: loss {loss}, grad norm {gnorm}")
    check(changed == len(after), f"full width: only {changed} of {len(after)} leaves moved")
    check(len(cp.saves) == 1 and cp.saves[0][0] == TRAIN_STEPS and cp.saves[0][1] >= ckpt,
          f"full width: saves {cp.saves}")
    del after
    gc.collect()
    torch.cuda.empty_cache()
    free_dev = torch.cuda.mem_get_info()[0]
    check(free_dev >= ckpt + TRAIN_RESTORE_MARGIN,
          f"the card cannot hold the restored state beside the trained one: {free_dev:,} B "
          f"free < {ckpt:,} + {TRAIN_RESTORE_MARGIN:,} B")
    with _CkptProbe(C) as cp2:
        rp, ro, extra = C.restore(d, device=DEV)
    a, b = flat_leaves(dict(p=pv, o=opt)), flat_leaves(dict(p=rp, o=ro))
    same = sum(torch.equal(x, y) for x, y in zip(a, b))
    log(f"[train] {card}: checkpoint of step {TRAIN_STEPS} restored onto the card: {same} of "
        f"{len(a)} leaves bit-identical to the trained state; data step {extra['data']['step']}")
    check(same == len(a) and len(a) == len(b) and extra["data"]["step"] == TRAIN_STEPS,
          f"full width: the restore differs from the trained state ({same}/{len(a)}, "
          f"data step {extra['data']['step']})")
    del pv, opt, a, b
    shutil.rmtree(d)
    gc.collect()
    torch.cuda.empty_cache()

    data = DataPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, device=DEV)
    probe.before = None
    probe.ms.clear(), probe.loss.clear(), probe.gnorm.clear()
    resumed = probe(make_train_step)(cfg, OptConfig(total_steps=TRAIN_STEPS + 1))
    rp, ro, _ = resumed(rp, ro, data.get_batch(extra["data"]["step"]))
    log(f"[train] {card}: step {TRAIN_STEPS} resumed from the checkpoint: {probe.ms[0]:.1f} ms, "
        f"loss {probe.loss[0]:.4f}, grad norm {probe.gnorm[0]:.4f}; opt step {int(ro['step'])}")
    check(int(ro["step"]) == TRAIN_STEPS + 1 and np.isfinite(probe.loss[0])
          and probe.gnorm[0] > 0, f"resumed step: opt step {int(ro['step'])}, {probe.loss}")

    batch = data.get_batch(TRAIN_STEPS + 1)
    step = make_train_step(cfg, OptConfig(total_steps=TRAIN_STEPS + 1))
    prof = profile_batches(f"{card}: {TRAIN_ARCH} train step (profiled on the resumed "
                           f"state, outside the run)", lambda: step(rp, ro, batch), 1)
    # the step's least work: 6 FLOP a param a token (forward 2, backward
    # 4; the recompute is the port's choice), float32 params and both
    # moments read once and written once
    flops, nbytes = 6 * n * tokens, 24 * n
    if prof is not None:
        log(f"[train] {card}: one train step: {prof['wall_us'] / 1e3:.1f} ms wall, "
            f"{prof['busy_us'] / 1e3:.1f} ms device busy, idle share "
            f"{1 - prof['busy_us'] / prof['wall_us']:.3f}, {prof['launches']:.0f} device "
            f"launches; bound {max(flops / BF16_FLOPS, nbytes / HBM_BPS) * 1e3:.2f} ms "
            f"({flops:.3e} FLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s bfloat16: "
            f"{flops / BF16_FLOPS * 1e3:.2f} ms; {nbytes:,} B at {HBM_BPS / 1e12} TB/s: "
            f"{nbytes / HBM_BPS * 1e3:.2f} ms)")
    for step_, nb, dt in cp.saves:
        log(f"[train] {card}: save of step {step_}: {nb:,} B in {dt:.2f} s "
            f"({nb / dt / 1e9:.2f} GB/s)")
    for nb, dt in cp2.restores:
        log(f"[train] {card}: restore: {nb:,} B onto the card in {dt:.2f} s "
            f"({nb / dt / 1e9:.2f} GB/s)")
    del rp, ro, batch, step, resumed
    return dict(step_ms=float(np.median(steady)), peak=peak, prof=prof)


def _train_launcher_resume(card, root, launches):
    """The launcher's own ``--resume`` on the card at ``--reduced`` (its
    default): TRAIN_STEPS steps and a save, then ``--resume --steps
    TRAIN_STEPS + 1``, which restores that checkpoint, runs one step and
    saves again."""
    from repro_torch.launch import train as TL
    from repro_torch.train import checkpoint as C

    d = str(Path(root) / "launcher")
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt", d, "--device", DEV]
    probe = _StepProbe()
    real_make = TL.make_train_step
    TL.make_train_step = probe(real_make)
    try:
        run_counted("train", f"reduced {TRAIN_ARCH} launch.train.main, {TRAIN_STEPS} steps",
                    lambda: TL.main(argv + ["--steps", str(TRAIN_STEPS)]), launches,
                    require=False)
        probe.ms.clear(), probe.loss.clear(), probe.gnorm.clear()
        _, opt = run_counted("train", f"reduced {TRAIN_ARCH} launch.train.main --resume",
                             lambda: TL.main(argv + ["--steps", str(TRAIN_STEPS + 1),
                                                     "--resume"]),
                             launches, require=False)
    finally:
        TL.make_train_step = real_make
    log(f"[train] {card}: reduced {TRAIN_ARCH}, launch.train.main --resume --steps "
        f"{TRAIN_STEPS + 1}: {len(probe.ms)} step ran, loss {probe.loss}, opt step "
        f"{int(opt['step'])}, latest checkpoint step {C.latest_step(d)}")
    check(len(probe.ms) == 1 and int(opt["step"]) == TRAIN_STEPS + 1
          and C.latest_step(d) == TRAIN_STEPS + 1 and np.isfinite(probe.loss[0]),
          f"launcher resume: {probe.ms} steps, opt step {int(opt['step'])}")


def _train_learns(card, root):
    """The reference test's bar on the card (its ``tiny_setup``: reduced
    qwen2.5-3b at 2 layers, d_model 128, vocab 128, lr 1e-2, batch 8 x 32):
    40 steps lower the mean loss of the last five by more than 0.3 below
    the first five; then exact resume (5 steps, save, restore, 5 more
    against 10 straight) bit for bit under deterministic algorithms."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import model as LM
    from repro_torch.models.layers import split_params
    from repro_torch.train import checkpoint as C
    from repro_torch.train.optimizer import OptConfig, flat_leaves, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = reduced(get_config(TRAIN_ARCH), n_layers=2, d_model=128, d_ff=256, vocab=128)
    opt_cfg = OptConfig(lr=1e-2, warmup=5, total_steps=60)
    data = DataPipeline(vocab=cfg.vocab, batch=8, seq=32, seed=1, device=DEV)
    step = make_train_step(cfg, opt_cfg)

    def fresh():
        pv = split_params(LM.init_params(cfg, 0, device=DEV))[0]
        return pv, init_opt_state(opt_cfg, pv)

    pv, opt = fresh()
    losses = []
    for i in range(TRAIN_LEARN_STEPS):
        pv, opt, m = step(pv, opt, data.get_batch(i))
        losses.append(m["loss"].item())
    drop = np.mean(losses[:5]) - np.mean(losses[-5:])
    log(f"[train] {card}: reduced {TRAIN_ARCH}, {TRAIN_LEARN_STEPS} steps on the card: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first five minus the last five "
        f"{drop:.4f} (bar 0.3)")
    check(np.isfinite(losses).all() and drop > 0.3, f"the loss did not drop: {losses[::8]}")

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        p1, o1 = fresh()
        for i in range(10):
            p1, o1, _ = step(p1, o1, data.get_batch(i))
        p2, o2 = fresh()
        for i in range(5):
            p2, o2, _ = step(p2, o2, data.get_batch(i))
        C.save(str(Path(root) / "learn"), 5, p2, o2, extra=dict(data=data.state(5)))
        del p2, o2
        rp, ro, extra = C.restore(str(Path(root) / "learn"), device=DEV)
        for i in range(extra["data"]["step"], 10):
            rp, ro, _ = step(rp, ro, data.get_batch(i))
        a, b = flat_leaves(dict(p=p1, o=o1)), flat_leaves(dict(p=rp, o=ro))
        same = sum(torch.equal(x, y) for x, y in zip(a, b))
        err = max(float((x.detach().float() - y.detach().float()).abs().max())
                  for x, y in zip(a, b))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] {card}: exact resume on the card under deterministic algorithms: {same} of "
        f"{len(a)} leaves bit-identical (max abs diff {err:.3e})")
    check(same == len(a), f"resume on the card is not bit-exact: {same}/{len(a)}, {err}")


def phase_train(rng, card):
    """LM training (module docstring, phase 10). Returns both kernels'
    launch counts over the launcher's runs, and the full-width step's
    measurements (median ms, peak bytes, the profiled step) for phase 11."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config, reduced

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] {card}: phase 10 starts with {torch.cuda.memory_allocated():,} B allocated")
    full = get_config(TRAIN_ARCH)
    two = dataclasses.replace(full, n_layers=TRAIN_CHECK_LAYERS)
    _train_card_against_cpu(dataclasses.replace(two, dtype="float32"),
                            f"{TRAIN_ARCH} at {TRAIN_CHECK_LAYERS} layers, float32", card,
                            TRAIN_F32_LOSS_ATOL, TRAIN_F32_GRAD_RTOL)
    _train_card_against_cpu(two, f"{TRAIN_ARCH} at {TRAIN_CHECK_LAYERS} layers, bfloat16", card,
                            TRAIN_BF16_LOSS_ATOL, TRAIN_BF16_GRAD_RTOL)
    for arch in LLM_FAMILIES:
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        _train_card_against_cpu(cfg, f"{arch} ({cfg.family}, reduced, float32)", card,
                                TRAIN_F32_LOSS_ATOL, TRAIN_F32_GRAD_RTOL)
    launches = {k: 0 for k in _launch_counts()}
    with tempfile.TemporaryDirectory() as root:
        measured = _train_full_width(card, root, launches)
        _train_launcher_resume(card, root, launches)
        _train_learns(card, root)
    log(f"[train] {card}: kernel launches of csrc/ on this path {launches}")
    log(f"[train] phase 10 ran {time.perf_counter() - t_phase:.1f} s")
    return launches, measured


def _dryrun_cells():
    """Start one dry-run process per cell of ``DRYRUN_CELLS`` (fake card
    tensors on the fake (32, 8) mesh)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return [(arch, shape, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--device", DEV], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for arch, shape in DRYRUN_CELLS]


def _dryrun_records(card, procs):
    """Each cell's record, its roofline row logged; fails on a failed cell."""
    from repro_torch.launch import roofline as RF

    recs = []
    for arch, shape, t0, p in procs:
        try:
            out, err = p.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            check(False, f"dry run {arch} {shape} did not end in {DRYRUN_TIMEOUT} s")
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"dry run {arch} {shape} failed (rc {p.returncode}):\n"
              f"{out[-2000:]}{err[-3000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        check(rec["status"] == "ok" and rec["chips"] == 256 and rec["collectives"]["total"] > 0,
              f"dry run {arch} {shape}: {rec}")
        row = RF.analyze_cell(rec)
        log(f"[launch] dry run {arch} {shape} on the fake {rec['mesh']} mesh, process wall "
            f"{wall:.1f} s: {json.dumps(rec)}")
        log(f"[launch] roofline ({card}'s constants): {RF.table_row(row)}")
        recs.append(rec)
    return recs


def _count_train_step(card, measured):
    """The dry run's counting on phase 10's step, on fake card tensors on a
    1 x 1 mesh, beside what phase 10 measured and the hand count."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as RF
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh, mesh_name
    from repro_torch.launch.shapes import sds
    from repro_torch.models.sharding import ShardingRules, set_rules
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(TRAIN_ARCH)
    started = ensure_process_group(DEV)
    try:
        mesh = make_debug_mesh(device=DEV)
        rules = ShardingRules(mesh=mesh)
        set_rules(rules)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        spec = dict(kind="train", batch=dict(
            tokens=sds((TRAIN_BATCH, TRAIN_SEQ), torch.int32),
            labels=sds((TRAIN_BATCH, TRAIN_SEQ), torch.int32)))
        rec = dict(arch=TRAIN_ARCH, shape=f"train_{TRAIN_BATCH}x{TRAIN_SEQ}",
                   mesh=mesh_name(mesh), chips=mesh.size(), tokens=tokens)
        t0 = time.perf_counter()
        rec = count_step(rec, cfg, spec, rules, DEV,
                         opt_cfg=OptConfig(total_steps=TRAIN_STEPS))
        t_count = time.perf_counter() - t0
    finally:
        set_rules(ShardingRules(mesh=None))
        if started:
            dist.destroy_process_group()
    row = RF.analyze_cell(rec)
    n = cfg.n_params()
    hand, hand_remat = 6 * n * tokens, 8 * n * tokens
    log(f"[launch] {card}: the dry run's counting on phase 10's step ({TRAIN_ARCH} at its "
        f"published widths, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW, fake card tensors on "
        f"the {rec['mesh']} mesh, counted in {t_count:.1f} s): {json.dumps(rec)}")
    log(f"[launch] {card}: counted {rec['flops']:.4e} FLOP against the hand count 6 N D = "
        f"{hand:.4e} ({rec['flops'] / hand - 1:+.1%}) and 8 N D with the recompute = "
        f"{hand_remat:.4e} ({rec['flops'] / hand_remat - 1:+.1%}); eager bytes "
        f"{rec['bytes_accessed']:.4e}; peak live allocations {rec['temp_bytes']:,} B beside "
        f"{rec['arg_bytes']:,} B of args")
    prof = measured.get("prof") or {}
    busy = prof.get("busy_us", float("nan")) / 1e3
    wall = prof.get("wall_us", float("nan")) / 1e3
    log(f"[launch] {card}: roofline of that step: compute {row['t_compute'] * 1e3:.2f} ms, "
        f"memory {row['t_memory'] * 1e3:.2f} ms (eager bytes), collective "
        f"{row['t_collective'] * 1e3:.2f} ms, bottleneck {row['bottleneck']}, useful ratio "
        f"{row['useful_ratio']:.3f}, roofline_frac {row['roofline_frac']:.4f}; phase 10 "
        f"measured the step at {measured['step_ms']:.1f} ms (median, host clock), "
        f"{busy:.1f} ms device busy and {wall:.1f} ms wall (profiled step), peak device bytes "
        f"{measured['peak']:,} (the state {rec['arg_bytes']:,} B + the counted peak "
        f"{rec['temp_bytes']:,} B = {rec['arg_bytes'] + rec['temp_bytes']:,} B); measured "
        f"busy over the roofline's bound {busy / (max(row['t_compute'], row['t_memory']) * 1e3):.2f}")
    check(rec["status"] == "ok" and rec["flops"] > hand and rec["collectives"]["total"] == 0,
          f"phase 10's step counted: {rec}")
    return rec, row


def _launch_mesh_resume(card, root, launches):
    """The launcher at ``--reduced`` on the card's mesh, saved; that
    checkpoint restored through ``restore(shardings=...)`` onto the mesh
    and held to the trained state bit for bit; then ``--resume``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.train import checkpoint as C
    from repro_torch.train.optimizer import flat_leaves

    d = str(Path(root) / "mesh")
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt", d, "--device", DEV]
    pv, opt = run_counted("launch", f"reduced {TRAIN_ARCH} launch.train.main, {TRAIN_STEPS} "
                          f"steps on make_debug_mesh()",
                          lambda: TL.main(argv + ["--steps", str(TRAIN_STEPS)]), launches,
                          require=False)
    started = ensure_process_group(DEV)
    try:
        mesh = make_debug_mesh(device=DEV)
        rules = ShardingRules(mesh=mesh)
        shapes, pax = TL.param_axes(reduced(get_config(TRAIN_ARCH)))
        pshard = TL.tree_map2(lambda s, ax: (mesh, rules.placements(ax, s)), shapes, pax)
        oshard = dict(mu=pshard, nu=pshard, step=(mesh, rules.placements((), ())))
        rp, ro, extra = C.restore(d, shardings=(pshard, oshard), device=DEV)
        shape = tuple(mesh.shape)
    finally:
        if started:
            dist.destroy_process_group()
    a, b = flat_leaves(dict(p=pv, o=opt)), flat_leaves(dict(p=rp, o=ro))
    same = sum(type(y) is torch.Tensor and y.device == x.device and torch.equal(x, y)
               for x, y in zip(a, b))
    log(f"[launch] {card}: reduced {TRAIN_ARCH} checkpoint of step {TRAIN_STEPS} restored "
        f"through restore(shardings=...) onto the card's {shape} mesh: {same} of {len(a)} "
        f"leaves bit-identical to the trained state, on {b[0].device}; data step "
        f"{extra['data']['step']}")
    check(same == len(a) == len(b) and extra["data"]["step"] == TRAIN_STEPS,
          f"mesh restore differs: {same}/{len(a)}")
    _, opt2 = run_counted("launch", f"reduced {TRAIN_ARCH} launch.train.main --resume",
                          lambda: TL.main(argv + ["--steps", str(TRAIN_STEPS + 1), "--resume"]),
                          launches, require=False)
    check(int(opt2["step"]) == TRAIN_STEPS + 1, f"mesh resume: opt step {int(opt2['step'])}")


def phase_launch(card, measured):
    """Device meshes, the dry run and the roofline (module docstring, phase
    11). Returns both kernels' launch counts over (a) and (c), and the dry
    run's records."""
    t_phase = time.perf_counter()
    procs = _dryrun_cells()  # (b) runs beside (a) and (c)
    launches = {k: 0 for k in _launch_counts()}
    try:
        run_counted("launch", "the dry run's counting on phase 10's step",
                    lambda: _count_train_step(card, measured), launches, require=False)
        with tempfile.TemporaryDirectory() as root:
            _launch_mesh_resume(card, root, launches)
        records = _dryrun_records(card, procs)
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    log(f"[launch] {card}: kernel launches of csrc/ on this path {launches}")
    log(f"[launch] phase 11 ran {time.perf_counter() - t_phase:.1f} s")
    return launches, records


# ---------------------------------------------------------------- phase 12
def _driver_benches(out: str, observe) -> dict:
    """Each benchmark's ``run`` at its reference size on ``DEV``, its JSON
    record (where it writes one) under ``out``."""
    from repro_torch.bench import (batch_bench, cache_bench, cluster_bench, cursor_bench,
                                   engine_bench, kernels_bench, rebuild_bench, scrub_bench)

    def at(name):
        return os.path.join(out, f"BENCH_{name}.json")

    return dict(
        cache=lambda c: cache_bench.run(c, device=DEV),
        kernels=lambda c: kernels_bench.run(c, json_path=at("kernels"), device=DEV,
                                            observe=observe),
        batch=lambda c: batch_bench.run(c, json_path=at("queries"), device=DEV),
        cursor=lambda c: cursor_bench.run(c, json_path=at("cursor"), device=DEV),
        engine=lambda c: engine_bench.run(c, json_path=at("engine"), device=DEV),
        rebuild=lambda c: rebuild_bench.run(c, device=DEV),
        scrub=lambda c: scrub_bench.run(c, device=DEV),
        cluster=lambda c: cluster_bench.run(c, json_path=at("cluster"), device=DEV),
    )


def _driver_records(records: dict, card: str) -> None:
    """The numbers behind each JSON record's bars (each benchmark asserts
    its own), beside the card."""
    k, b = records["kernels"]["pipeline"], records["batch"]
    e, cl = records["engine"], records["cluster"]
    log(f"[drivers] {card}: kernels: device {k['device_get_us_per_key']} / legacy "
        f"{k['host_get_us_per_key']} us per key at batch {k['batch']}, device/legacy "
        f"{k['get_speedup']}x (the reference's >= 5x TPU-era bar: reported, not asserted); "
        f"scans {k['device_scan_us_per_query']} / {k['host_scan_us_per_query']} us per "
        f"query; {k['hbm_resident_bytes']} resident bytes")
    log(f"[drivers] {card}: batch: multi-get {b['multiget_speedup_at_256']}x the scalar loop "
        f"(bar >= 5x), CKB decoder saves {b['ckb_decode_savings']}; device vs legacy "
        f"{b['device_vs_host']}")
    log(f"[drivers] {card}: cursor: long-scan {records['cursor']['scans']['long']['speedup']:.3f}x "
        f"(bar >= 2x), short {records['cursor']['scans']['short']['speedup']:.3f}x")
    log(f"[drivers] {card}: engine: mixed {e['mixed_speedup_at_256']}x (bar >= 5x), pure get "
        f"{e['pure_get_ratio']} / scan {e['pure_scan_ratio']} (bar >= 0.5), metrics on/off "
        f"{e['metrics_overhead_ratio']} (bar >= 0.95), snapshot pin full/empty "
        f"{e['snapshot_pin_ratio_full_vs_empty']} (bar <= 10); async {e['async_ops_per_s']} "
        f"ops/s; trace {e['trace']}")
    log(f"[drivers] {card}: cluster: {cl['ops']} ops, {cl['failed_ops']} failed; p99 "
        f"{cl['p99_pre_split_ms']} ms before / {cl['p99_post_split_ms']} ms after the split "
        f"({cl['post_over_pre_p99']}x, bar <= 2x); gate {cl['split']['gate_ms']} ms, shipped "
        f"{cl['split']['shipped_bytes']} bytes; replica lag {cl['replica']['lag_before_catchup']}"
        f" -> 0 in {cl['replica']['catchup_ms']} ms")


def _run_obstool(argv) -> tuple[int, str]:
    """``python -m repro_torch.tools.obstool`` on ``argv``, in process:
    (exit code, what it printed)."""
    import io

    from repro_torch.tools import obstool

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obstool.main(argv)
    return rc, buf.getvalue()


def _driver_obstool(root: str, card: str) -> None:
    """obstool's ``show`` (plain and ``--prom``) and ``diff`` on the engine
    benchmark's snapshot, ``diff`` across a store's reads, ``health`` on
    that store (exit 0), ``health --scrub`` on a copy with a flipped table
    byte (non-zero)."""
    import shutil

    from repro_torch.db.store import RemixDB, RemixDBConfig
    from repro_torch.io.faults import flip_bytes
    from repro_torch.obs.metrics import save_snapshot

    snap = os.path.join(root, "OBS_snapshot.json")
    with open(snap) as f:
        n = len(json.load(f)["metrics"])
    rc, text = _run_obstool(["show", snap])
    check(rc == 0 and len(text.splitlines()) == n, f"obstool show: rc {rc}, "
          f"{len(text.splitlines())} lines for {n} samples")
    rc, prom = _run_obstool(["show", snap, "--prom"])
    check(rc == 0 and "# TYPE engine_ops counter" in prom, "obstool show --prom")
    rc, same = _run_obstool(["diff", snap, snap])
    check(rc == 0 and same.strip() == "# 0 sample(s) changed", f"obstool diff: {same!r}")
    db_dir = os.path.join(root, "obs-db")
    db = RemixDB.open(db_dir, RemixDBConfig(device=DEV))
    try:
        ks = np.arange(1, OBS_KEYS + 1, dtype=np.uint64) * 8
        db.put_batch(ks, np.stack([ks.astype(np.uint32), np.ones(OBS_KEYS, np.uint32)], 1))
        db.flush()
        save_snapshot(db.metrics(), os.path.join(root, "before.json"))
        found, _ = db.get_batch(ks[::7])
        check(bool(found.all()), "obstool store: a written key not found")
        save_snapshot(db.metrics(), os.path.join(root, "after.json"))
    finally:
        db.close()
    rc, diff = _run_obstool(["diff", os.path.join(root, "before.json"),
                             os.path.join(root, "after.json")])
    changed = int(diff.strip().splitlines()[-1].split()[1])
    check(rc == 0 and changed > 0, f"obstool diff across reads: {diff[-200:]!r}")
    rc_ok, health = _run_obstool(["health", db_dir, "--device", DEV])
    check(rc_ok == 0 and "status: ok" in health, f"obstool health: rc {rc_ok}: {health!r}")
    rot = os.path.join(root, "obs-db-rot")
    shutil.copytree(db_dir, rot)
    table = os.path.join(rot, "tables", sorted(os.listdir(os.path.join(rot, "tables")))[0])
    flip_bytes(table, offset=os.path.getsize(table) // 4, nbytes=1)
    rc_rot, report = _run_obstool(["health", rot, "--scrub", "--device", DEV])
    check(rc_rot != 0, f"obstool health --scrub on a rotted table exited 0: {report!r}")
    log(f"[drivers] {card}: obstool: show {n} samples, --prom {len(prom.splitlines())} lines, "
        f"diff of a snapshot with itself 0 changed, across {OBS_KEYS // 7 + 1} reads "
        f"{changed} changed; health exit {rc_ok} (clean), --scrub on a flipped table byte "
        f"exit {rc_rot}: {' | '.join(report.strip().splitlines()[:3])}")


def _driver_examples(root: str, card: str, launches: dict) -> None:
    """The four examples through their ``main`` on ``DEV``: quickstart (its
    expectations asserted), kvstore_serving, the serving example (outputs
    equal with and without the prefix cache, asserted), train_lm for
    ``TRAIN_LM_STEPS`` and then resumed from its last checkpoint."""
    import math

    from repro_torch.examples import kvstore_serving, quickstart, serve_llm_prefix_cache
    from repro_torch.examples import train_lm

    def timed(name, fn):
        t0 = time.perf_counter()
        out = run_counted("drivers", name, fn, launches, require=False)
        log(f"[time] drivers: {name} ran {time.perf_counter() - t0:.1f} s")
        return out

    argv = ["--device", DEV]
    timed("quickstart", lambda: quickstart.main(argv))
    kv = timed("kvstore_serving", lambda: kvstore_serving.main(argv))
    check(bool(kv["found"].all()) and kv["present"] and kv["hot"],
          "kvstore_serving: a written key not found, or the WAL lost one")
    log(f"[drivers] {card}: kvstore_serving: {kv['stats']['partitions']} partitions, "
        f"{kv['stats']['tables']} tables, WA {kv['stats']['wa']:.4f}, compactions "
        f"{kv['kinds']}, hit rate {kv['found'].mean():.3f}, {kv['recovered']} recovered")
    sv = timed("serve_llm_prefix_cache", lambda: serve_llm_prefix_cache.main(argv))
    log(f"[drivers] {card}: serve_llm_prefix_cache: {sv['seconds'][0]:.3f} s without, "
        f"{sv['seconds'][1]:.3f} s with the cache; prefill {sv['stats'].prefill_tokens} -> "
        f"{sv['cached_stats'].prefill_tokens} tokens, {sv['cached_stats'].cached_tokens} reused")
    ckpt = os.path.join(root, "train-lm")
    first = timed("train_lm", lambda: train_lm.main(
        argv + ["--steps", str(TRAIN_LM_STEPS), "--ckpt", ckpt]))
    steps = sorted(int(d[5:]) for d in os.listdir(ckpt) if d.startswith("step_"))
    check(100 in steps, f"train_lm: no step-100 checkpoint ({steps})")
    more = TRAIN_LM_STEPS + TRAIN_LM_MORE
    second = timed("train_lm resumed", lambda: train_lm.main(
        argv + ["--steps", str(more), "--ckpt", ckpt]))
    losses = {**first["losses"], **second["losses"]}
    check(first["start"] == 0 and second["start"] == TRAIN_LM_STEPS,
          f"train_lm resumed at step {second['start']}, not {TRAIN_LM_STEPS}")
    check(all(math.isfinite(v) for v in losses.values()), f"train_lm: a loss is not finite: {losses}")
    check(losses[TRAIN_LM_STEPS - 1] < losses[0], "train_lm: the loss did not fall")
    kept = sorted(int(d[5:]) for d in os.listdir(ckpt) if d.startswith("step_"))
    log(f"[drivers] {card}: train_lm: loss {losses[0]:.4f} at step 0, "
        f"{losses[TRAIN_LM_STEPS - 1]:.4f} at {TRAIN_LM_STEPS - 1}, {losses[more - 1]:.4f} at "
        f"{more - 1} after the resume; checkpoints {steps} after the first run, {kept} "
        f"after the resumed one")


def phase_drivers(card) -> tuple[dict, dict, dict]:
    """The system's own drivers on the card through the port (see the module
    docstring, phase 12); returns the kernels' launches over them, and their
    shapes and errors on ``kernels_bench``'s store."""
    from repro_torch.bench import common

    class CardCSV(common.CSV):
        """Rows logged beside the card's name and power limit."""

        def emit(self, name, us_per_call, derived="", call=None, wall_s=None):
            line = f"{name},{us_per_call:.3f},{derived}"
            self.rows.append(line)
            log(f"[drivers] {card}: {line}")

    t_phase = time.perf_counter()
    launches = {k: 0 for k in _launch_counts()}
    shapes = {"anchor_search": [], "selector_decode": []}  # held on the views' operands
    err = {k: 0 for k in shapes}
    observe = (_paper_observer(card, shapes, err, timed=("kernels",), log_tag="drivers")
               if DEV == "cuda" else None)
    records = {}
    with tempfile.TemporaryDirectory() as out:
        benches = _driver_benches(out, observe)
        for name in DRIVER_BENCHES:
            t0 = time.perf_counter()
            records[name] = run_counted("drivers", name, lambda: benches[name](CardCSV()),
                                        launches, require=name in DRIVER_REQUIRE)
            log(f"[time] drivers: {name} ran {time.perf_counter() - t0:.1f} s")
        check(len(shapes["anchor_search"]) > 0 or DEV != "cuda",
              "kernels_bench: the kernels were not held on its store")
        _driver_records(records, card)
        _driver_obstool(out, card)
        _driver_examples(out, card, launches)
    log(f"[drivers] phase 12 ran {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"{launches}")
    return launches, shapes, err


# ---------------------------------------------------------------- phase 13
def phase_docs(card, records) -> dict:
    """The doc tools on the card (module docstring, phase 13); returns both
    kernels' launches over the doc snippets."""
    import io

    from repro_torch.launch.roofline import analyze_cell
    from repro_torch.tools import check_docs, mk_tables

    t_phase = time.perf_counter()
    launches = {k: 0 for k in _launch_counts()}

    def docs():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = check_docs.main(["--device", DEV])
        return rc, buf.getvalue()

    rc, text = run_counted("docs", "check_docs", docs, launches, require=DEV == "cuda")
    for line in text.splitlines():
        log(f"[docs] {line}")
    total = len(check_docs.collect(check_docs.DOCS))
    check(rc == 0 and total == 14 and text.splitlines()[-1] == f"{total}/{total} doc snippets passed",
          f"check_docs --device {DEV}: rc {rc}, {text.splitlines()[-1:]}")
    log(f"[docs] {card}: check_docs --device {DEV}: {text.splitlines()[-1]}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dryrun.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(rec) + "\n" for rec in records)
        rows = mk_tables.load(path)
    dry = mk_tables.dryrun_table(rows)
    roof = mk_tables.roofline_table(rows)
    log(f"[docs] {card}: mk_tables on phase 11's {len(records)} dry-run records:")
    for line in (dry + "\n\n" + roof).splitlines():
        log(f"[docs] {line}")
    dry_rows, roof_rows = dry.splitlines()[2:], roof.splitlines()[2:]
    check(len(dry_rows) == len(records) and "| trace s |" in dry.splitlines()[0],
          f"mk_tables: {len(dry_rows)} dry-run rows for {len(records)} records")
    single = [rec for rec in records if rec["mesh"] == mk_tables.SINGLE_POD]
    check(len(roof_rows) == len(single) == len(records),
          f"mk_tables: {len(roof_rows)} roofline rows for {len(single)} single-pod records")
    for rec, line in zip(single, roof_rows):
        want = analyze_cell(rec)["bottleneck"]
        check(line.startswith(f"| {rec['arch']} | {rec['shape']} |")
              and line.split(" | ")[5] == want,
              f"mk_tables: roofline row {line!r}, analyze_cell's bottleneck {want}")
    log(f"[docs] phase 13 ran {time.perf_counter() - t_phase:.1f} s; kernel launches {launches}")
    return launches


def smi() -> str:
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    sys.path.insert(0, str(SRC))
    rng = np.random.default_rng(args.seed)
    card = smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    def mark(name):
        log(f"[time] {name} ended at {time.perf_counter() - t_script:.1f} s")

    count_view_gets()
    try:
        phase_build()
        err = phase_kernels(rng)
        mark("phases 1-2")
        parts, domains, oracles = build_partitions(rng)
        mgr, views, starts, launches = phase_main(rng, parts, domains, oracles)
        timings = phase_timings(rng, views, domains, starts, err, card)
        phase_end_to_end(rng, mgr, views, domains, starts, card)
        resolve = phase_get_resolve(rng, card)
        phase_grouped(rng, card)
        mark("phases 3-4")
        with tempfile.TemporaryDirectory() as root:
            idx_launches, idx_mgr, driven = phase_index_tier(rng, root, card)
        launches = {k: n + idx_launches[k] for k, n in launches.items()}
        idx_shapes, idx_err = view_kernels(idx_mgr, driven, card)
        del idx_mgr, driven
        mark("phase 5")
        peak = torch.cuda.max_memory_allocated()  # phase 6 resets the peak
        with tempfile.TemporaryDirectory() as root:
            store_launches, store_shapes, store_err = phase_store(rng, root, card)
        mark("phase 6")
        with tempfile.TemporaryDirectory() as root:
            fleet_launches, fleet_shapes, fleet_err = phase_cluster(rng, root, card)
        mark("phase 7")
        paper_launches, paper_shapes, paper_err = phase_paper(card)
        mark("phase 8")
        peak = max(peak, torch.cuda.max_memory_allocated())  # phases 9, 10 reset the peak
        phase_llm(rng, card)
        mark("phase 9")
        del mgr, views, starts, parts, domains, oracles
        train_launches, measured = phase_train(rng, card)
        mark("phase 10")
        launch_launches, dryrun_records = phase_launch(card, measured)
        mark("phase 11")
        driver_launches, driver_shapes, driver_err = phase_drivers(card)
        mark("phase 12")
        docs_launches = phase_docs(card, dryrun_records)
        mark("phase 13")
        launches = {k: n + store_launches[k] + fleet_launches[k] + paper_launches[k]
                    + train_launches[k] + launch_launches[k] + driver_launches[k]
                    + docs_launches[k] for k, n in launches.items()}
        for t in timings:
            t["shapes"] += (idx_shapes[t["name"]] + store_shapes[t["name"]]
                            + fleet_shapes[t["name"]] + paper_shapes[t["name"]]
                            + driver_shapes[t["name"]])
            t["max_abs_err"] = max(t["max_abs_err"], idx_err[t["name"]], store_err[t["name"]],
                                   fleet_err[t["name"]], paper_err[t["name"]],
                                   driver_err[t["name"]])
        log(f"[device] peak allocated {max(peak, torch.cuda.max_memory_allocated())} bytes")
        log(f"[device] launches over all phases {launches} (phase 7: {fleet_launches}, "
            f"phase 8: {paper_launches}, phase 12: {driver_launches}, "
            f"phase 13: {docs_launches}); "
            f"script ran {time.perf_counter() - t_script:.1f} s")
    except (Fail, AssertionError) as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    # top-level times: each kernel's first shape; "shapes" holds them all
    kernels = [
        dict(name=t["name"], route="cuda", source=SOURCES[t["name"]],
             replaces=REPLACES[t["name"]], launches=launches[t["name"]],
             max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
             bound_ms=t["bound_ms"], bound_by=t["bound_by"],
             library_ms=t["library_ms"], launch_floor_ms=t["launch_floor_ms"],
             shapes=t["shapes"])
        for t in timings
    ]
    kernels.append(dict(
        {k: resolve[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "launch_floor_ms", "shapes")},
        route="cuda", source=SOURCES["get_resolve"], replaces=REPLACES["get_resolve"],
        launches=launches["get_resolve"]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
