"""The sharded store (``repro_torch.db.sharded``) against the JAX package's.

The demo state is built from the same numpy draws, so every shard's arrays
equal the reference's stacked state bit for bit. The distributed get runs
on 8 gloo ranks, one process each, and must return the reference's
``found`` and ``vals`` bit for bit, with the reference on 8 fake XLA
devices in its own process (as ``tests/test_dryrun_sharded.py`` runs it);
the arrays cross through ``.npz`` files. Half the probes miss, and the
misses crowd two owners, so each rank's dispatch overflows its capacity
and drops queries: the same ones in both packages.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.remixdb import RemixServiceConfig as RCfg  # noqa: E402
from repro.core import keys as CK  # noqa: E402
from repro.db import sharded as RS  # noqa: E402
from repro_torch.configs.remixdb import RemixServiceConfig as TCfg  # noqa: E402
from repro_torch.db import sharded as TS  # noqa: E402
from repro_torch.device import as_words  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
SMALL = dict(entries_per_run=512, runs_per_partition=3, query_batch=1024)
N = 8


def test_config_equal():
    import dataclasses

    assert dataclasses.asdict(TCfg()) == dataclasses.asdict(RCfg())


@pytest.mark.parametrize("n_shards", [1, 8, 512])
def test_abstract_state_equal(n_shards):
    rremix, rrunset = RS.abstract_state(RCfg(), n_shards)
    tremix, trunset = TS.abstract_state(TCfg(), n_shards)
    for ref, port in ((rremix, tremix), (rrunset, trunset)):
        for name, (shape, dtype) in port.items():
            sds = getattr(ref, name)
            assert (tuple(sds.shape), str(sds.dtype)) == (shape, dtype), name


def _owner_keys(seed):
    k = np.random.default_rng(seed).integers(0, 2**32, (1000, 2), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[:4, 0] = [0, 2**31 - 1, 2**31, 2**32 - 1]  # unsigned high words
    return k


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_owner_of_equal(n_shards):
    k = _owner_keys(n_shards)
    want = np.asarray(RS._owner_of(jnp.asarray(k), n_shards))
    got = TS._owner_of(as_words(k, "cpu"), n_shards).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[3] == n_shards - 1


def test_owner_of_one_shard():
    """A divergence kept on record: the reference's step, 2**32 // 1, does
    not fit its uint32, so its sharded get cannot run on one device; the
    port's step is an int64 and a world of one owns every key (the card
    run uses it)."""
    k = _owner_keys(1)
    with pytest.raises(OverflowError):
        RS._owner_of(jnp.asarray(k), 1)
    assert not TS._owner_of(as_words(k, "cpu"), 1).numpy().any()


def test_build_demo_state_equal():
    rremix, rrunset = RS.build_demo_state(RCfg(**SMALL), N, seed=1)
    shards = TS.build_demo_state(TCfg(**SMALL), N, seed=1, device="cpu")
    assert len(shards) == N
    for s, (remix, runset) in enumerate(shards):
        for f in ("anchors", "cursors", "selectors"):
            a, b = np.asarray(getattr(rremix, f)[s]), getattr(remix, f).numpy()
            np.testing.assert_array_equal(a, b.view(a.dtype), err_msg=f)
        assert remix.n_entries == int(rremix.n_entries[s]) and remix.d == rremix.d
        for f in ("keys", "vals", "seq", "tomb", "lens"):
            a, b = np.asarray(getattr(rrunset, f)[s]), getattr(runset, f).numpy()
            np.testing.assert_array_equal(a, b.view(a.dtype), err_msg=f)


REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.configs.remixdb import RemixServiceConfig
from repro.db.sharded import build_demo_state, make_sharded_get
cfg = RemixServiceConfig(**{small!r})
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
remix, runset = build_demo_state(cfg, 8, seed=1)
step, _ = make_sharded_get(cfg, mesh)
queries = jnp.asarray(np.load(sys.argv[1])["queries"])
with jax.set_mesh(mesh):
    found, vals = jax.jit(step)(remix, runset, queries)
np.savez(sys.argv[2], found=np.asarray(found), vals=np.asarray(vals))
"""

PORT = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.remixdb import RemixServiceConfig
from repro_torch.db.sharded import build_demo_state, make_sharded_get
from repro_torch.device import as_words
rank, world, store, qpath, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
cfg = RemixServiceConfig(**{small!r})
remix, runset = build_demo_state(cfg, world, seed=1, device="cpu")[rank]
step, n = make_sharded_get(cfg)
assert n == world
q = np.load(qpath)["queries"]
nq = len(q) // world
found, vals = step(remix, runset, as_words(q[rank * nq:(rank + 1) * nq], "cpu"))
np.savez(out, found=found.numpy(), vals=vals.numpy().view(np.uint32))
dist.destroy_process_group()
"""


def _queries():
    """512 stored keys, then 512 random misses (as the reference test)."""
    _, runset = RS.build_demo_state(RCfg(**SMALL), N, seed=1)
    keys, lens = np.asarray(runset.keys), np.asarray(runset.lens)
    stored = np.concatenate([keys[s, r, : lens[s, r]] for s in range(N) for r in range(3)])
    rng = np.random.default_rng(0)
    exist = stored[rng.choice(len(stored), 512, replace=False)]
    miss = CK.pack_u64(rng.integers(1, 2**62, 512).astype(np.uint64) | 1)
    return np.concatenate([exist, miss]).astype(np.uint32), stored


def _dropped(q: np.ndarray) -> np.ndarray:
    """The queries the reference's dispatch drops: past each rank's
    capacity per owner, and the last one that fits where it overflowed."""
    nq = len(q) // N
    cap = max(1, 2 * nq // N)
    owner = np.minimum(q[:, 0] // ((1 << 32) // N), N - 1)
    drop = np.zeros(len(q), bool)
    for r in range(N):
        sl = slice(r * nq, (r + 1) * nq)
        o = owner[sl]
        for s in range(N):
            idx = np.flatnonzero(o == s) + r * nq
            if len(idx) > cap:
                drop[idx[cap - 1:]] = True
    return drop


def test_sharded_get_on_8_gloo_ranks_equals_the_reference(tmp_path):
    q, stored = _queries()
    qpath = str(tmp_path / "q.npz")
    np.savez(qpath, queries=q)
    ref_out = str(tmp_path / "ref.npz")
    code = textwrap.dedent(REF).format(small=SMALL)
    ref = subprocess.Popen([sys.executable, "-c", code, qpath, ref_out], env=ENV,
                           cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    code = textwrap.dedent(PORT).format(small=SMALL)
    store = str(tmp_path / "rendezvous")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(N), store, qpath,
         str(tmp_path / f"port{r}.npz")], env=ENV, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N)]
    logs = [p.communicate(timeout=300)[0] for p in ranks + [ref]]
    assert all(p.returncode == 0 for p in ranks + [ref]), "\n".join(logs)[-4000:]
    want = np.load(ref_out)
    got = [np.load(tmp_path / f"port{r}.npz") for r in range(N)]
    found = np.concatenate([g["found"] for g in got])
    vals = np.concatenate([g["vals"] for g in got])
    np.testing.assert_array_equal(want["found"], found)
    np.testing.assert_array_equal(want["vals"], vals)
    # the drop rule: every stored key answered unless its owner overflowed
    drop = _dropped(q)
    assert drop.any() and not drop[:512].any()
    assert found[:512].all() and not found[drop].any()
    assert int(found[512:].sum()) < 5
