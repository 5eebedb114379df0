"""Process groups for the mesh tests.

``fake_world``: ``torch.distributed``'s ``fake`` backend answers every
collective without moving data, so one process can stand for one rank of
a world of any size (placements, shapes, what a step issues).

``start_ranks`` / ``start_py``: real runs in fresh interpreters — one
process per gloo rank with a ``file://`` rendezvous, and the reference on
fake XLA host devices in its own process — as ``test_torch_sharded.py``
and ``test_dryrun_sharded.py`` run them. Arrays cross through ``.npz``.
"""
import contextlib
import os
import subprocess
import sys

import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """Rank ``rank`` of a fake process group of ``n`` ranks, ended on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def start_py(code: str, *args) -> subprocess.Popen:
    """``python -c code args...`` from the repo root, output captured."""
    return subprocess.Popen(
        [sys.executable, "-c", code, *map(str, args)], env=ENV, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def start_ranks(code: str, world: int, store: str, *args) -> list:
    """``world`` gloo ranks of ``code``, each called with ``rank world
    store args...``; the script joins the group through ``file://store``."""
    return [start_py(code, r, world, store, *args) for r in range(world)]


def wait_all(procs, timeout: float) -> str:
    """Wait for every process; raise with their output if one failed."""
    outs, bad = [], False
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
        bad |= p.returncode != 0
    text = "\n".join(o[-3000:] for o in outs)
    if bad:
        raise AssertionError(text)
    return text


# the opening of a rank script: join the gloo group, one torch thread
RANK_PROLOGUE = """
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
argv = sys.argv[4:]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
"""
